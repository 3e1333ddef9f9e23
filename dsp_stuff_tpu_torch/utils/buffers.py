"""The static buffers a captured CUDA graph reads and writes, and the
key it is cached under.

Two loops of the port are captured on the card and replayed: a stream's
block step (runtime/block_graph.BlockStep) and a feedback cycle's
per-node scan over a render's blocks (compiler/cycle_loop.py).  Both hold
their state in fixed buffers (:func:`state_buffer`: a tensor, or a
Python int as a lockstep counter on the device, ops/lockstep.py), copy a
step's new state into them (:func:`buffer_pairs`, :func:`copy_into`),
bind the params as data (:class:`Binding`: a float slider a root of
utils/sliders, a tensor a device buffer) and key a capture on the
params' structure and the precision policy (:func:`capture_key`), the
content of what cannot be data counted by :func:`freeze_params`.
What a graph reads beside these buffers is held by utils/capture.
The cycle's differentiated loop also binds the buffers of its backward
(:class:`GradBuffers`).
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import lockstep
from dsp_stuff_tpu_torch.utils import precision
from dsp_stuff_tpu_torch.utils.sliders import Scope


def freeze_params(p):
    """Hashable snapshot of a params tree (dicts, scalars, arrays,
    tensors) by CONTENT (the JAX package's ``_freeze_params``,
    dsp_stuff_tpu/runtime/stream.py:31): the part of a capture's key that
    the step cannot take as data (a static slider)."""
    if p is None:
        return None
    if isinstance(p, dict):
        return tuple(sorted((str(k), freeze_params(v)) for k, v in p.items()))
    if isinstance(p, (list, tuple)):
        return tuple(freeze_params(v) for v in p)
    if isinstance(p, torch.Tensor):
        a = p.detach().cpu().numpy()
        return (str(p.device), a.shape, a.dtype.str, a.tobytes())
    if isinstance(p, np.ndarray) or (hasattr(p, "shape") and hasattr(
            p, "dtype") and not np.isscalar(p)):
        a = np.asarray(p)
        return (a.shape, a.dtype.str, a.tobytes())
    return p


def capture_key(params, data=None):
    """What a captured step depends on besides its buffers: the params'
    structure and the precision policy.  The structure is each leaf's
    path and kind: a float, or a tensor with its shape, dtype and device;
    a leaf the step cannot take as data (``data(node, name)`` false: a
    static slider, a name no node has) counts by its content.  The values
    of the others are data, copied in before a replay."""
    def leaf(nid, name, v):
        if data is not None and not data(nid, name):
            return "content", freeze_params(v)
        if isinstance(v, torch.Tensor):
            return "tensor", tuple(v.shape), str(v.dtype), str(v.device)
        return ("float",)
    if params is None:
        tree = None
    else:
        tree = tuple(sorted(
            (str(nid), tuple(sorted((str(k), leaf(nid, k, v))
                                    for k, v in entry.items()))
             if isinstance(entry, dict) else ("content", freeze_params(entry)))
            for nid, entry in params.items()))
    return tree, precision.get_policy().name


class Binding:
    """The params of one capture as its step reads them: each float of a
    data slider a root of ``scope``, each tensor a buffer on ``device``,
    every other leaf as given.  ``key`` is the capture's key: the
    structure's and a count of the bindings made."""

    def __init__(self, params, data, device, key):
        self.key = key
        self.scope = Scope()
        self.tensors: list = []         # (path, buffer)
        self.params = None if params is None else {}
        for nid, entry in (params or {}).items():
            if not isinstance(entry, dict):
                self.params[nid] = entry
                continue
            out = self.params[nid] = {}
            for name, v in entry.items():
                path = (nid, name)
                if not data(nid, name):
                    out[name] = v
                elif isinstance(v, torch.Tensor):
                    if v.device != device:
                        raise ValueError(
                            f"params[{nid!r}][{name!r}] is on {v.device}; "
                            f"the session is on {device}")
                    out[name] = v.detach().clone()
                    self.tensors.append((path, out[name]))
                else:
                    out[name] = self.scope.root(path, float(v))

    def move(self, params) -> bool:
        """Copy ``params``' values (the same structure) into the buffers;
        False when a form of the floats moved (see utils/sliders)."""
        floats = {path: float(params[path[0]][path[1]])
                  for path in self.scope.roots}
        if not self.scope.move(floats):
            return False
        for (nid, name), b in self.tensors:
            b.copy_(params[nid][name].detach())
        return True


def state_buffer(v, device):
    """A state leaf as its buffer: a tensor copied to ``device``, a Python
    or NumPy integer a lockstep counter on the device, None kept."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().to(device).clone()
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return lockstep.on_device(v, device)
    return torch.as_tensor(np.asarray(v), device=device).clone()


def buffer_pairs(bufs: dict, tree: dict, what: str):
    """(buffer, value) of every leaf of ``tree`` against the buffer tree
    ``bufs``; raises when the trees differ in their keys."""
    if set(tree) != set(bufs):
        raise ValueError(f"{what}: keys {sorted(tree)} do not match the "
                         f"session's state {sorted(bufs)}")
    out = []
    for k, b in bufs.items():
        v = tree[k]
        if isinstance(b, dict):
            if not isinstance(v, dict) or set(v) != set(b):
                raise ValueError(f"{what}[{k!r}] does not match the "
                                 f"session's state entry")
            out += [(b[kk], v[kk], f"{what}[{k!r}][{kk!r}]") for kk in b]
        else:
            out.append((b, v, f"{what}[{k!r}]"))
    return out


def copy_into(pairs) -> None:
    """Each value into its buffer.  A value that shares memory with a
    buffer other than its own (a view the step returned) is cloned first,
    so no copy reads a buffer already overwritten."""
    storages = {b.untyped_storage().data_ptr(): b for b, _, _ in pairs
                if isinstance(b, torch.Tensor)}
    staged = []
    for b, v, what in pairs:
        if b is None:
            continue
        if isinstance(v, torch.Tensor):
            owner = storages.get(v.untyped_storage().data_ptr())
            if owner is not None and owner is not b:
                v = v.clone()
        elif v is None:
            raise ValueError(f"{what} is None, the session holds a tensor")
        staged.append((b, v, what))
    for b, v, what in staged:
        if isinstance(v, torch.Tensor):
            if v.shape != b.shape and not lockstep.is_counter(b):
                raise ValueError(f"{what} has shape {tuple(v.shape)}; the "
                                 f"session's buffer is {tuple(b.shape)}")
            b.copy_(v)
        else:
            b.fill_(int(v) if lockstep.is_counter(b) else float(v))


class GradBuffers:
    """The buffers a differentiated loop's captured backward binds
    (compiler/cycle_loop.py), made once and kept with the loop for its
    graphs.  ``states`` is every (path, buffer) of the state and carried
    blocks, ``carries`` the floating ones, ``outs`` the emitted
    sequences' buffers, ``feeds`` the feeds' by key, ``overrides`` the
    override tensors' buffers:

    * ``ck[path]``, ``ck_counter``: ``slots`` checkpoints of each state
      buffer and of ``counter``; ``slot``, a device counter, the next
      one; ``seg``, the first block of the segment being reversed;
    * ``record[path]``: ``records`` records of each, a segment's inputs;
    * ``dcarry``: a cotangent of each carry; ``demit``: one of each
      emitted sequence at full length; ``dfeeds``: each feed's gradient
      at full length, made for the feeds that need one
      (:meth:`feed_buffer`);
    * ``dover``: each override's gradient summed over the blocks in
      float64; ``used``: whether a block read it.

    Each takes its buffer's dtype (float64 under parity, as the forward's
    buffers do), but the overrides' sums."""

    def __init__(self, states: list, carries: list, outs: list,
                 feeds: dict, overrides: list, counter: torch.Tensor, *,
                 slots: int, records: int):
        dev = counter.device
        self.ck = {p: _stacked(b, slots) for p, b in states}
        self.ck_counter = _stacked(counter, slots)
        self.slot = lockstep.on_device(0, dev)
        self.seg = lockstep.on_device(0, dev)
        self.record = {p: _stacked(b, records) for p, b in states}
        self.dcarry = [torch.zeros_like(b) for _, b in carries]
        self.demit = [torch.zeros_like(o) for o in outs]
        self._feeds = feeds
        self.dfeeds: dict = {}
        self.dover = [torch.zeros(v.shape, dtype=torch.float64, device=dev)
                      for v in overrides]
        self.used = [False] * len(self.dover)

    def feed_buffer(self, k) -> torch.Tensor:
        """The gradient buffer of feed ``k``, made at its first use."""
        if k not in self.dfeeds:
            self.dfeeds[k] = torch.zeros_like(self._feeds[k])
        return self.dfeeds[k]


def _stacked(b: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zeroed slots of ``b``'s shape and dtype."""
    return torch.zeros((n, *b.shape), dtype=b.dtype, device=b.device)
