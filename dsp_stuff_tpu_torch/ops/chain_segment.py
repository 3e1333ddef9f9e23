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
    ("mtap", mix, L, NH, EV, RS)
                              -- the chorus: a sine-modulated fractional
                                 tap on the stage input (ops/modfx.py);
                                 state: FOUR entries, the input history
                                 [..., L], then the trajectory operands
                                 q [T//128] int32, r [T] int32 and
                                 frac [T] f32 from modfx.mtap_shared,
                                 shared by all streams (never broadcast)

``chain_segment(x, stages, state_in)`` returns
``(y, cascade_infos, comb_hists, taps)``:

    cascade_infos -- per cascade stage (s_tm1, s_tm2, x_tm1, x_tm2),
                     everything ops/cascade.cascade_state_out needs;
    comb_hists    -- per comb stage the new [..., D] history and per mtap
                     stage the new [..., L] input history, in stage order;
    taps          -- tuple of [..., T] emitted sequences, tap order.

Dispatch is by device alone: a CUDA tensor goes to the kernel (which
raises on what it cannot take), a CPU tensor to ``segment_fallback``,
the stage-by-stage composition that is also the kernel's reference.  On
the card an input or state that requires grad goes through
``ChainSegment``, whose backward is the vjp of that composition, as the
JAX package's custom_vjp is.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import chain_kernel, shaping
from dsp_stuff_tpu_torch.ops.cascade import cascade_tail_states, linear_cascade
from dsp_stuff_tpu_torch.ops.delay_line import feedback_comb
from dsp_stuff_tpu_torch.ops.modfx import mtap_apply
from dsp_stuff_tpu_torch.ops.scan import needs_grad


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
        elif st[0] == "mtap":
            hist, q, r, fr = state_in[si:si + 4]
            si += 4
            v, nh = mtap_apply(v, hist, q, r, fr, st[1])
            hists.append(nh)
        elif st[0] == "tap":
            taps[st[1]] = v
        else:
            raise ValueError(f"unknown stage {st[0]!r}")
    return v, tuple(cinfos), tuple(hists), tuple(taps)


def rebuild_states(stages: tuple, T: int, casc_raw, ring_raw):
    """(cascade_infos, comb_hists) from the chain kernel's raw outputs.

    casc_raw -- per cascade (carry entering the last block [B, >= N], that
                block's stage input [B, 128]);
    ring_raw -- per comb and mtap, in stage order, the ring [B, NR, 128],
                slot s holding block b == s (mod NR): for a comb
                NR = ceil(D/128) blocks of the stage output, for an mtap
                NR = NH + 1 blocks of the stage input.
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
        elif st[0] in ("comb", "mtap"):
            # comb: the last D outputs; mtap: the last L inputs
            hists.append(ring_history(ring_raw[hi], K, st[2]))
            hi += 1
    return tuple(cinfos), tuple(hists)


def ring_history(ring, K: int, n: int):
    """The last ``n`` samples, oldest first, of a kernel ring [..., NR,
    128] after K blocks: slot s holds block b == s (mod NR), so the
    oldest of the last NR blocks, K - NR, sits in slot (K - NR) mod NR."""
    NR = ring.shape[-2]
    lin = torch.roll(ring, -((K - NR) % NR), dims=-2).reshape(
        *ring.shape[:-2], NR * 128)
    return lin[..., -n:]


def chain_segment(x, stages, state_in):
    """Fused evaluation of a stage chain over ``x`` [..., T] (see the
    module docstring for the stage grammar and returns).  On the card an
    input that requires grad goes through ``ChainSegment``: the kernel
    forward, the plain composition's vjp backward."""
    stages = tuple(stages)
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "cpu":
        return segment_fallback(x, stages, tuple(state_in))
    if x.device.type != "cuda":
        raise ValueError(f"chain_segment: no kernel for device {x.device}")
    return run_segment(_kernel_segment, x, stages, tuple(state_in))


def run_segment(forward, x, stages: tuple, state_in: tuple):
    """``forward(x, stages, state_in)``, through ``ChainSegment`` when
    autograd must see it (the card's dispatch; a test passes the plain
    version as ``forward``)."""
    if not needs_grad((x, *state_in)):
        return forward(x, stages, state_in)
    state_in = tuple(torch.as_tensor(s, device=x.device) for s in state_in)
    return unflatten_outputs(ChainSegment.apply(forward, stages, x,
                                                *state_in), stages)


def flatten_outputs(outs) -> tuple:
    """A segment's (y, cascade_infos, comb_hists, taps) as one flat tuple:
    y, each cascade's four entries, each history, each tap.  The one
    flattening ChainSegment's forward and backward share."""
    y, cinfos, hists, taps = outs
    return (y, *(t for info in cinfos for t in info), *hists, *taps)


def unflatten_outputs(flat, stages: tuple):
    """flatten_outputs' inverse for ``stages``."""
    n_c = sum(1 for st in stages if st[0] == "cascade")
    n_h = sum(1 for st in stages if st[0] in ("comb", "mtap"))
    cinfos = tuple(tuple(flat[1 + 4 * i:5 + 4 * i]) for i in range(n_c))
    hists = tuple(flat[1 + 4 * n_c:1 + 4 * n_c + n_h])
    return flat[0], cinfos, hists, tuple(flat[1 + 4 * n_c + n_h:])


def fresh(flat, inputs) -> tuple:
    """``flat`` with every tensor that shares storage with one of
    ``inputs`` cloned: a Function's outputs must not alias its inputs
    (a stand-in forward may return x itself, or a view of it, as a tap or
    a cascade's last input)."""
    ptrs = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, torch.Tensor)}
    return tuple(t.clone() if t.untyped_storage().data_ptr() in ptrs else t
                 for t in flat)


def grads_of(outs, cts, inputs) -> list:
    """vjp of ``outs`` with cotangents ``cts`` (None: no cotangent) with
    respect to ``inputs`` (None: no gradient wanted); an input that gets
    no gradient gets zeros."""
    pairs = [(o, c) for o, c in zip(outs, cts)
             if c is not None and o.requires_grad]
    want = [t for t in inputs if t is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   want, [c for _, c in pairs],
                                   allow_unused=True) if pairs and want
               else [None] * len(want))
    out = []
    for t in inputs:
        if t is None:
            out.append(None)
            continue
        g = next(got)
        out.append(torch.zeros_like(t) if g is None else g)
    return out


class ChainSegment(torch.autograd.Function):
    """A chain segment on the card under autograd: the counterpart of the
    JAX package's custom_vjp (``_segment_vjp``).

    ``apply(forward, stages, x, *state_in)`` runs ``forward(x, stages,
    state_in)`` (the kernel path ``_kernel_segment``; a test passes
    ``segment_fallback`` under no_grad in its place) once and saves
    ``(x, state_in)``.  The backward re-runs ``segment_fallback`` on them
    under autograd and pulls the cotangents of every output, y, the
    cascade infos, the histories and the taps, back to x and every state
    entry but the mtap trajectory operands (q, r, frac), which are shared
    by all streams and get none.

    The backward linearizes the f32 composition, not the kernel: the
    kernel's cascades are 3xTF32 products, about -125 dBFS from the plain
    f32 ones, far below any gradient bound.  It holds the composition's
    intermediates, as the JAX package's vjp does."""

    @staticmethod
    def forward(ctx, forward, stages, x, *state_in):
        ctx.set_materialize_grads(False)
        ctx.stages = stages
        ctx.save_for_backward(x, *state_in)
        with torch.no_grad():
            flat = flatten_outputs(forward(x, stages, state_in))
        return fresh(flat, (x, *state_in))

    @staticmethod
    def backward(ctx, *cts):
        x, *state_in = ctx.saved_tensors
        stages = ctx.stages
        shared = _shared_slots(stages)
        need = ctx.needs_input_grad[2:]

        def leaf(t, i):
            if i - 1 in shared or not need[i]:
                return t.detach()
            return t.detach().requires_grad_(True)

        ins = [leaf(t, i) for i, t in enumerate((x, *state_in))]
        with torch.enable_grad():
            outs = flatten_outputs(segment_fallback(ins[0], stages,
                                                    tuple(ins[1:])))
            grads = grads_of(outs, cts, [t if t.requires_grad else None
                                         for t in ins])
        return (None, None, *grads)


def _shared_slots(stages: tuple) -> frozenset:
    """State-entry indices of the mtap trajectory operands (q, r, frac):
    shared by all streams, they pass to the kernel as they are and get no
    gradient."""
    shared = set()
    si = 0
    for st in stages:
        if st[0] in ("cascade", "comb"):
            si += 1
        elif st[0] == "mtap":
            shared.update((si + 1, si + 2, si + 3))
            si += 4
    return frozenset(shared)


def _kernel_segment(x, stages: tuple, state_in):
    """The kernel path: leading dimensions flatten into kernel rows
    (per-stream states broadcast to them), and come back on every
    output."""
    batch = tuple(x.shape[:-1])
    T = x.shape[-1]
    B = int(np.prod(batch, dtype=np.int64))
    shared = _shared_slots(stages)
    flat = []
    for i, s in enumerate(state_in):
        if i in shared:
            flat.append(s)
            continue
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
