"""Float64 sums in the fixed orders the reverse kernels add in.

The plain adjoints (``ops/gen.oscillator_adjoint``,
``compiler/pointwise.interpret_adjoint`` with ``sums64``) and the
wrappers that sum a gradient back to a narrower operand take their sums
from here, so that the order each kernel fixes is written once:

- :func:`block_sums64`: a warp's sum of one block (each lane's samples
  in order, then the xor tree), as ``csrc/pointwise_ops.cuh pw_bsum`` and
  the reverse oscillator kernel's wave pass add;
- :func:`sum_to64`: autograd's sum of a broadcast back to an operand's
  shape, in float64 and rounded once.
"""

from __future__ import annotations

import torch

#: the lanes of a warp, one block's samples spread over them
WARP = 32


def tree64(v: torch.Tensor) -> torch.Tensor:
    """The warp's xor tree over the last axis (32 lanes) of float64 ``v``:
    lane i adds lane i + o for o = 16, 8, 4, 2, 1; lane 0's sum."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def block_sums64(g: torch.Tensor, block: int) -> torch.Tensor:
    """[..., T] -> [..., T / block] float64: each block's sum, lane l
    adding its block // 32 samples l * (block // 32) + j in order from
    +0.0, then the lanes' sums by :func:`tree64`."""
    v = g.reshape(*g.shape[:-1], -1, WARP, block // WARP).to(torch.float64)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float64, device=g.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return tree64(acc)


def sum_to64(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed to ``shape`` (autograd's sum of a broadcast) in
    float64, rounded once to ``t``'s dtype; ``t`` itself where it has
    that shape."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    lead = (1,) * (t.dim() - len(shape)) + shape
    return t.to(torch.float64).sum_to_size(lead).to(t.dtype).reshape(shape)
