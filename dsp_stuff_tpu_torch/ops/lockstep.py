"""Lockstep counters: a reverb's write position ``pos``, a chorus's sample
clock ``t0`` and a FIR's sample count ``n_seen``.

Every stream of a batched render advances them together, so each is one
integer, not a tensor over the batch.  A render holds it as a Python int.
A stream session's block step holds it as a 0-d int64 tensor on the
device (runtime/block_graph.py), so that no host value changes from one
replay of its CUDA graph to the next and no op reads it on the host.

The ops take either form through this module and do the same arithmetic
on both: a counter is added to, compared with and used as an index only
through tensor ops or Python operators that a 0-d tensor also has, so the
two forms give the same values.
"""

from __future__ import annotations

import torch


def counter(c):
    """``c`` as the ops take it: a tensor stays a tensor, anything else (a
    NumPy integer from a checkpoint, say) becomes a Python int."""
    return c if isinstance(c, torch.Tensor) else int(c)


def is_counter(buf) -> bool:
    """True for a counter's device form, a 0-d int64 tensor."""
    return (isinstance(buf, torch.Tensor) and buf.dtype == torch.int64
            and buf.dim() == 0)


def on_device(c, device) -> torch.Tensor:
    """The counter ``c`` as a 0-d int64 tensor on ``device``."""
    return torch.tensor(int(c), dtype=torch.int64, device=device)


def advance(c, n: int, limit: int | None = None):
    """The counter ``c`` moved on by ``n``, saturating at ``limit``; a
    tensor stays a tensor, an int an int."""
    c = counter(c) + n
    if limit is None:
        return c
    return torch.clamp(c, max=limit) if isinstance(c, torch.Tensor) \
        else min(c, limit)


def oldest_first(ring: torch.Tensor, pos) -> torch.Tensor:
    """A reverb's circular buffer with its oldest sample first: the ring
    rolled back by the write position ``pos``."""
    D = ring.shape[-1]
    return ring[..., (counter(pos) + torch.arange(D, device=ring.device)) % D]
