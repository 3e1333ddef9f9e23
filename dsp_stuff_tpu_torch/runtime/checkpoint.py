"""Checkpoint / resume.

The reference persists graph topology + per-node settings only (eframe
storage key "graph_state", runtime.rs:540-543; manual Save/Load JSON,
runtime.rs:463-494); DSP state is not saved.  Beyond that,
``save_checkpoint`` / ``load_checkpoint`` capture the live DSP state and
(optionally) fitted params, so long renders and streaming sessions resume
mid-audio.

The file layout is the JAX package's (dsp_stuff_tpu/runtime/checkpoint.py),
so a checkpoint either package writes loads in the other: ``path`` is an
.npz of the leaves keyed ``state`` / ``params`` followed by the dict path
in ``jax.tree_util.keystr`` form (``state['3']['z']``), plus ``__meta__``
(JSON bytes), and ``path + '.graph.json'`` holds the graph.  A node
without state (None) has no leaves.  Lockstep counters (reverb ``pos``,
chorus ``t0``, the FIR's ``n_seen``) are saved as 0-d int32 and load as
Python ints; float leaves load as f32 tensors on the device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dsp_stuff_tpu_torch.compiler.compile import compile_graph
from dsp_stuff_tpu_torch.convert import _leaf_to_torch
from dsp_stuff_tpu_torch.graph import Graph, dumps_graph, loads_graph


def keystr(keys) -> str:
    """The ``jax.tree_util.keystr`` of a path of dict keys:
    ``['3']['z']``."""
    return "".join(f"[{k!r}]" for k in keys)


def _flatten(tree, prefix: str, path=()) -> dict:
    """{prefix + keystr(path): NumPy leaf} of a tree of dicts, in the
    sorted-key order of JAX's flattening."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix, path + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        leaf = tree.detach().cpu().numpy()
    elif isinstance(tree, (bool, int, np.integer)):
        leaf = np.int32(tree)
    else:
        leaf = np.asarray(tree)
    return {prefix + keystr(path): leaf}


def _restore(tree, prefix: str, data, device, path=()):
    """(tree with each leaf found in ``data`` replaced, count replaced)."""
    if tree is None:
        return None, 0
    if isinstance(tree, dict):
        out, found = {}, 0
        for k, v in tree.items():
            out[k], n = _restore(v, prefix, data, device, path + (k,))
            found += n
        return out, found
    key = prefix + keystr(path)
    if key not in data:
        return tree, 0
    return _leaf_to_torch(data[key], device), 1


def save_checkpoint(path: str, graph: Graph, state=None, params=None,
                    meta: dict | None = None) -> None:
    """Write ``path`` (.npz) + ``path + '.graph.json'``."""
    arrays = {}
    if state is not None:
        arrays.update(_flatten(state, "state"))
    if params is not None:
        arrays.update(_flatten(params, "params"))
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    with open(path + ".graph.json", "w") as f:
        f.write(dumps_graph(graph))


def load_checkpoint(path: str, device="cuda"):
    """Returns (graph, state, params, meta), state and params on ``device``
    (the card by default; "cpu" for the CPU; raises RuntimeError without
    a CUDA device).  They are rebuilt by initializing from the graph and
    overwriting the leaves found by key, so they come back in the layout
    the compiler expects; either is None when the file holds none of its
    leaves."""
    with open(path + ".graph.json") as f:
        graph = loads_graph(f.read())
    cg = compile_graph(graph, device=device)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode()) \
            if "__meta__" in data else {}
        state, n_state = _restore(cg.init_state(), "state", data, cg.device)
        params, n_params = _restore(cg.init_params(), "params", data,
                                    cg.device)
    return graph, (state if n_state else None), \
        (params if n_params else None), meta
