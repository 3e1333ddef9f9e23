"""Fused chain segments: linear cascades + elementwise shapers + feedback
combs composed as ONE op, with a hand-written CUDA kernel on the GPU.

A chain segment stitches the stages of a maximal sole-consumer run of
nodes into one pass: on a CUDA tensor, ops/chain_kernel.py runs every
stage on each 128-sample block while it stays in registers, so the whole
segment costs one signal read and one write.

Stage descriptors (static tuples; the compiler builds them in
``_plan_mega_fusion`` / ``_mega_stages``):

    ("cascade", sections)     -- ops/cascade section tuple; state: the
                                 composite delayed state [..., N]
    ("scale", h)              -- the link fan-in scale between nodes
    ("ew", kind, params)      -- stateless elementwise shaper; kind is
                                 "overdrive" | "chebyshev" |
                                 "distort:<Mode>" (ops/shaping.py)
    ("comb", decay, D)        -- feedback comb y[n] = x[n] + d*y[n-D]
                                 (reverb.rs:87-105); state: history
                                 [..., D] (newest last)
    ("tap", ti)               -- emit the current flow as output
                                 sequence ti (an intermediate node output
                                 with extra consumers, node.rs:321-325)

The JAX package's ``("mtap", ...)`` stage (the chorus) is not ported yet
and raises.

``chain_segment(x, stages, state_in)`` returns
``(y, cascade_infos, comb_hists, taps)``:

    cascade_infos -- per cascade stage (s_tm1, s_tm2, x_tm1, x_tm2),
                     everything ops/cascade.cascade_state_out needs;
    comb_hists    -- per comb stage the new [..., D] history;
    taps          -- tuple of [..., T] emitted sequences, tap order.

Dispatch is by device alone: a CUDA tensor goes to the kernel (which
raises on what it cannot take), a CPU tensor to ``segment_fallback``,
the stage-by-stage composition that is also the kernel's reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import chain_kernel, shaping
from dsp_stuff_tpu_torch.ops.cascade import cascade_tail_states, linear_cascade
from dsp_stuff_tpu_torch.ops.delay_line import feedback_comb


def _ew_fn(kind: str):
    if kind == "overdrive":
        return shaping.overdrive
    if kind == "chebyshev":
        return shaping.chebyshev_asym
    if kind.startswith("distort:"):
        mode = kind.split(":", 1)[1]
        if mode == "Fuzz":
            return lambda v, level: shaping.fuzz(v, level, 128)
        return shaping.DISTORT_MODES[mode]
    raise ValueError(f"unknown elementwise stage kind {kind!r}")


def apply_ew(kind: str, v, params):
    """One elementwise stage on ``v``."""
    return _ew_fn(kind)(v, *(float(np.float32(p)) for p in params))


def _mtap_not_ported():
    return NotImplementedError(
        "chain_segment: the 'mtap' stage (chorus) is not ported yet")


def segment_fallback(x, stages: tuple, state_in: tuple):
    """Stage-by-stage composition via the per-op lowerings: the plain
    PyTorch version of the chain kernel.  Its matrix products run in full
    float32 (TF32 is off, utils/precision.py)."""
    v = torch.as_tensor(x, dtype=torch.float32)
    si = 0
    cinfos = []
    hists = []
    n_t = sum(1 for st in stages if st[0] == "tap")
    taps = [None] * n_t
    for st in stages:
        if st[0] == "cascade":
            s0 = state_in[si]
            si += 1
            x_tm1, x_tm2 = v[..., -1], v[..., -2]
            v, s_tm1, s_tm2 = linear_cascade(v, st[1], s0)
            cinfos.append((s_tm1, s_tm2, x_tm1, x_tm2))
        elif st[0] == "scale":
            v = v * float(np.float32(st[1]))
        elif st[0] == "ew":
            v = apply_ew(st[1], v, st[2])
        elif st[0] == "comb":
            hist = state_in[si]
            si += 1
            v, nh = feedback_comb(v, st[1], st[2], hist)
            hists.append(nh)
        elif st[0] == "tap":
            taps[st[1]] = v
        elif st[0] == "mtap":
            raise _mtap_not_ported()
        else:
            raise ValueError(f"unknown stage {st[0]!r}")
    return v, tuple(cinfos), tuple(hists), tuple(taps)


def rebuild_states(stages: tuple, T: int, casc_raw, ring_raw):
    """(cascade_infos, comb_hists) from the chain kernel's raw outputs.

    casc_raw -- per cascade (carry entering the last block [B, >= N], that
                block's stage input [B, 128]);
    ring_raw -- per comb the ring [B, NR, 128], NR = ceil(D/128), slot s
                holding block b == s (mod NR) of the stage output.
    T must be a multiple of 128."""
    cinfos = []
    hists = []
    ci = hi = 0
    K = T // 128
    for st in stages:
        if st[0] == "cascade":
            carry_last, x_last = casc_raw[ci]
            ci += 1
            s1, s2 = cascade_tail_states(st[1], x_last, carry_last)
            cinfos.append((s1, s2, x_last[..., -1], x_last[..., -2]))
        elif st[0] == "comb":
            ring = ring_raw[hi]
            hi += 1
            D = st[2]
            NR = -(-D // 128)
            # the last NR blocks, oldest first: block K - NR sits in slot
            # (K - NR) mod NR
            s_old = (K - NR) % NR
            lin = torch.roll(ring, -s_old, dims=-2).reshape(
                *ring.shape[:-2], NR * 128)
            hists.append(lin[..., -D:])
        elif st[0] == "mtap":
            raise _mtap_not_ported()
    return tuple(cinfos), tuple(hists)


def chain_segment(x, stages, state_in):
    """Fused evaluation of a stage chain over ``x`` [..., T] (see the
    module docstring for the stage grammar and returns)."""
    stages = tuple(stages)
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "cpu":
        return segment_fallback(x, stages, tuple(state_in))
    if x.device.type != "cuda":
        raise ValueError(f"chain_segment: no kernel for device {x.device}")
    return _kernel_segment(x, stages, state_in)


def _kernel_segment(x, stages: tuple, state_in):
    """The kernel path: leading dimensions flatten into kernel rows (states
    broadcast to them), and come back on every output."""
    batch = tuple(x.shape[:-1])
    T = x.shape[-1]
    B = int(np.prod(batch, dtype=np.int64))
    flat = []
    for s in state_in:
        s = torch.as_tensor(s, dtype=torch.float32, device=x.device)
        flat.append(s.expand(*batch, s.shape[-1]).reshape(B, s.shape[-1]))
    y, casc_raw, ring_raw, taps = chain_kernel.chain_kernel_call(
        x.reshape(B, T).contiguous(), stages, tuple(flat))
    cinfos, hists = rebuild_states(stages, T, casc_raw, ring_raw)

    def unflat(t):
        return t.reshape(batch + tuple(t.shape[1:]))

    return (unflat(y),
            tuple(tuple(unflat(t) for t in info) for info in cinfos),
            tuple(unflat(h) for h in hists),
            tuple(unflat(t) for t in taps))
