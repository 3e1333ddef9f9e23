"""Offline render session: the one-call front door.

Replaces the reference's live device loop (devices.rs + per-node tokio
tasks) with batch rendering: compile once, feed array sources, collect
rendered outputs.  ``render_file`` (WAV I/O) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.compiler.compile import compile_graph
from dsp_stuff_tpu_torch.graph import Graph

BLOCK_SIZE = 128


def _pad_to_block(x: torch.Tensor, block_size: int):
    T = x.shape[-1]
    pad = (-T) % block_size
    return (F.pad(x, (0, pad)) if pad else x), T


def render(graph: Graph, inputs=None, T: int | None = None,
           block_size: int = BLOCK_SIZE, state=None, batch_shape=(),
           device="cuda"):
    """Render a graph offline on ``device`` (the card by default; pass
    device="cpu" for the CPU; raises RuntimeError without a CUDA device).

    inputs -- None, an [n_inputs, T] array or tensor, or {input_node_id: [T]}
    Returns (outputs [..., n_out, T] tensor, aux, state); trims any block
    padding."""
    cg = compile_graph(graph, block_size, device=device)

    def as_tensor(v):
        return v if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v, np.float32), device=cg.device)

    orig_T = None
    if isinstance(inputs, dict):
        padded = {}
        for k, v in inputs.items():
            padded[k], orig_T = _pad_to_block(as_tensor(v), block_size)
        inputs = padded
    elif inputs is not None:
        inputs, orig_T = _pad_to_block(as_tensor(inputs), block_size)
    if T is not None:
        orig_T = T
        T = T + ((-T) % block_size)
    outs, aux, state = cg.render(inputs, T=T, state=state,
                                 batch_shape=batch_shape)
    if orig_T is not None:
        outs = outs[..., :orig_T]
    return outs, aux, state
