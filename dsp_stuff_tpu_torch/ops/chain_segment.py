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
``ChainSegment``: the kernel forward (its record build when the list has
a shaper, ``segment_fallback(record=True)``'s counterpart), the reverse
chain kernel backward (ops/chain_reverse_kernel.py), whose plain version
is ``segment_adjoint``.  The JAX package's custom_vjp takes the vjp of its
segment_fallback there; ``segment_vjp`` is that route in the port, kept
as the reference the reverse kernel is held to.
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


def segment_fallback(x, stages: tuple, state_in: tuple, record=False):
    """Stage-by-stage composition via the per-op lowerings: the plain
    PyTorch version of the chain kernel.  Its matrix products run in full
    float32 (TF32 is off, utils/precision.py).  ``record`` returns
    ``(outputs, recs)``: recs holds the input of each ``ew`` stage, in
    stage order, the values the reverse cannot get back from the
    cotangents (the chain kernel's record build writes the same)."""
    v = torch.as_tensor(x, dtype=torch.float32)
    si = 0
    cinfos = []
    hists = []
    recs = []
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
            recs.append(v)
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
    outs = v, tuple(cinfos), tuple(hists), tuple(taps)
    return (outs, tuple(recs)) if record else outs


# -- the adjoint -------------------------------------------------------------
#
# The vjp of segment_fallback as an explicit reverse walk: the stages in
# reverse, each stage's time recursion backward.  With ybar the adjoint of
# a stage's output:
#   cascade  (y_j = X_j Ltg + c_j Ecb, c_{j+1} = X_j W + c_j ACt over the
#            128-sample blocks j): cbar_j = ybar_j Ecb^T + cbar_{j+1} ACt^T
#            from the last block, the info cotangents seeding the last
#            block (cycle_segment.cinfo_seeds); Xbar_j = ybar_j Ltg^T +
#            cbar_{j+1} W^T; the state's gradient is cbar_0;
#   comb     vbar[n] = ybar[n] (+ the new history's cotangent in the last
#            D samples) + d vbar[n + D]; the history's gradient d vbar[j];
#   mtap     the dry part ybar (1 - mix), and ybar mix (1 - frac) and
#            ybar mix frac scattered onto the two taps read;
#   ew       the vjp of the shaper itself at its recorded input;
#   scale, tap: a product, the tap's cotangent added in.


def _adjoint_batch(shapes) -> tuple:
    """The batch of a segment's outputs from its operands' shapes (x's,
    then the state entries'; an mtap's trajectory operands are shared and
    take no part)."""
    return tuple(torch.broadcast_shapes(*(s[:-1] for s in shapes)))


def _per_stream(stages: tuple, shapes):
    return [s for i, s in enumerate(shapes[1:])
            if i not in _shared_slots(stages)]


def segment_adjoint(cts, shapes, stages: tuple, recs, state_in):
    """The vjp of ``segment_fallback``: the plain PyTorch version of the
    reverse chain kernel (the rules above).  ``cts`` are the cotangents
    of ``flatten_outputs``'s entries (None: none), ``shapes`` the shapes
    of x and of every state entry, ``recs`` the ``ew`` stages' inputs
    (``segment_fallback(record=True)``), ``state_in`` the state entries,
    of which only the mtap trajectory operands are read.  Returns the
    gradients of x and of every state entry at the outputs' batch shape
    (x [*batch, T], a cascade state [*batch, N], a history [*batch, D] or
    [*batch, L]), None for the trajectory operands."""
    from dsp_stuff_tpu_torch.ops.cascade import _cascade_constants
    from dsp_stuff_tpu_torch.ops.cycle_segment import cinfo_seeds
    from dsp_stuff_tpu_torch.ops.scan import const_on
    batch = _adjoint_batch((shapes[0], *_per_stream(stages, shapes)))
    T = shapes[0][-1]
    C = 128
    if T % C:
        raise ValueError(f"segment_adjoint: T={T} must be a multiple of {C}")
    K = T // C
    dev = next(t.device for t in (*cts, *recs) if t is not None)
    f32 = torch.float32
    ct_y, ct_infos, ct_hists, ct_taps = unflatten_outputs(cts, stages)

    def full(t, n):
        if t is None:
            return torch.zeros(*batch, n, dtype=f32, device=dev)
        return t.to(f32).expand(*batch, n)

    g = full(ct_y, T).clone()
    n_st = len(shapes) - 1
    g_states = [None] * n_st
    si, ci, hi, k = n_st, len(ct_infos), len(ct_hists), len(recs)
    for st in reversed(stages):
        kind = st[0]
        if kind == "tap":
            if ct_taps[st[1]] is not None:
                g = g + full(ct_taps[st[1]], T)
        elif kind == "scale":
            g = g * float(np.float32(st[1]))
        elif kind == "ew":
            k -= 1
            rec = recs[k].to(f32).expand(*batch, T)
            g = torch.func.vjp(lambda v: apply_ew(st[1], v, st[2]), rec)[1](
                g)[0]
        elif kind == "cascade":
            si -= 1
            ci -= 1
            Ltg, W, E, P, N, _B, _l1, _ = _cascade_constants(st[1], C, ())
            AC = const_on(P[C].astype(np.float32), dev)
            Y = g.reshape(*batch, K, C)
            V = Y @ const_on(np.ascontiguousarray(E), dev)       # [..., K, N]
            seed = cinfo_seeds(st[1], ct_infos[ci], batch, dev)
            cb = torch.zeros(*batch, N, dtype=f32, device=dev)
            Cn = torch.zeros(*batch, K, N, dtype=f32, device=dev)
            for j in reversed(range(K)):           # the carry, block by block
                Cn[..., j, :] = cb
                cb = V[..., j, :] + cb @ AC
                if j == K - 1 and seed is not None:
                    cb = cb + seed[1]
            X = (Y @ const_on(np.ascontiguousarray(Ltg.T), dev)
                 + Cn @ const_on(np.ascontiguousarray(W.T), dev))
            if seed is not None:
                X[..., K - 1, :] = X[..., K - 1, :] + seed[0]
            g = X.reshape(*batch, T)
            g_states[si] = cb
        elif kind == "comb":
            si -= 1
            hi -= 1
            decay, D = float(np.float32(st[1])), int(st[2])
            cth = ct_hists[hi]
            f = g.clone()
            if cth is not None:
                cth = full(cth, D)
                f[..., max(T - D, 0):] = (f[..., max(T - D, 0):]
                                          + cth[..., max(D - T, 0):])
            vbar = f
            for hi_ in range(T - D, 0, -D):        # chunks of D from the end
                lo = max(hi_ - D, 0)
                vbar[..., lo:hi_] = (f[..., lo:hi_]
                                     + vbar[..., lo + D:hi_ + D] * decay)
            gh = torch.zeros(*batch, D, dtype=f32, device=dev)
            m = min(D, T)
            gh[..., :m] = vbar[..., :m] * decay
            if cth is not None and D > T:
                gh[..., T:] = cth[..., :D - T]
            g = vbar
            g_states[si] = gh
        elif kind == "mtap":
            si -= 4
            hi -= 1
            _, mix, L, NH = st[:4]
            L, NH = int(L), int(NH)
            q, r, fr = state_in[si + 1:si + 4]
            mix = float(np.float32(mix))
            idx = (torch.repeat_interleave(q.to(torch.int64), C)
                   + r.to(torch.int64)
                   + torch.arange(T, dtype=torch.int64, device=dev))
            gw = g * mix
            gxx = torch.zeros(*batch, NH * C + T, dtype=f32, device=dev)
            gxx.index_add_(-1, idx, gw * (1.0 - fr))
            gxx.index_add_(-1, idx + 1, gw * fr)
            gxx[..., NH * C:] += g * float(np.float32(1.0) - np.float32(mix))
            if ct_hists[hi] is not None:
                gxx[..., -L:] += full(ct_hists[hi], L)
            g = gxx[..., NH * C:]
            g_states[si] = gxx[..., NH * C - L:NH * C]
        else:
            raise ValueError(f"unknown stage {kind!r}")
    return g, tuple(g_states)


def segment_vjp(x, stages: tuple, state_in: tuple, cts, need):
    """The vjp of ``segment_fallback`` at (x, state_in) by autograd: the
    JAX package's custom_vjp backward (``_segment_vjp``'s bwd) in the port.
    Re-runs the composition under autograd and pulls ``cts`` back to x
    and every state entry that ``need`` marks (the mtap trajectory
    operands get none); the reference the reverse chain kernel is held
    to, and ``ChainSegment``'s backward where no other is given."""
    shared = _shared_slots(stages)

    def leaf(t, i):
        if i - 1 in shared or not need[i]:
            return t.detach()
        return t.detach().requires_grad_(True)

    ins = [leaf(t, i) for i, t in enumerate((x, *state_in))]
    with torch.enable_grad():
        outs = flatten_outputs(segment_fallback(ins[0], stages,
                                                tuple(ins[1:])))
        return grads_of(outs, cts, [t if t.requires_grad else None
                                    for t in ins])


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
    forward, the reverse chain kernel backward."""
    stages = tuple(stages)
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "cpu":
        return segment_fallback(x, stages, tuple(state_in))
    if x.device.type != "cuda":
        raise ValueError(f"chain_segment: no kernel for device {x.device}")
    return run_segment(_kernel_segment, x, stages, tuple(state_in),
                       _kernel_segment_adjoint)


def run_segment(forward, x, stages: tuple, state_in: tuple, backward=None):
    """``forward(x, stages, state_in)``, through ``ChainSegment`` when
    autograd must see it (the card's dispatch; a test passes the plain
    versions, ``segment_fallback`` and ``segment_adjoint``).  With a
    ``backward`` (``segment_adjoint``'s signature) the forward runs with
    ``record=True`` where the list has a shaper; without one the backward
    is ``segment_vjp``."""
    if not needs_grad((x, *state_in)):
        return forward(x, stages, state_in)
    state_in = tuple(torch.as_tensor(s, device=x.device) for s in state_in)
    return unflatten_outputs(ChainSegment.apply(forward, backward, stages, x,
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

    ``apply(forward, backward, stages, x, *state_in)`` runs ``forward(x,
    stages, state_in)`` once (the kernel path ``_kernel_segment``, its
    record build when the list has a shaper: ``record=True`` returns the
    shapers' inputs too; a test passes ``segment_fallback``).  The
    backward runs ``backward(cts, shapes, stages, recs, state_in)`` (the
    reverse kernel's path ``_kernel_segment_adjoint``; a test passes
    ``segment_adjoint``), which reads only the recorded inputs and the
    mtap trajectory operands, and sums each gradient to its operand's
    shape; the trajectory operands (q, r, frac), shared by all streams,
    get none.  With no ``backward`` it saves (x, state_in) and takes
    ``segment_vjp``, the vjp of the plain composition."""

    @staticmethod
    def forward(ctx, forward, backward, stages, x, *state_in):
        ctx.set_materialize_grads(False)
        ctx.stages, ctx.backward_fn = stages, backward
        ctx.shapes = tuple(t.shape for t in (x, *state_in))
        recs = ()
        with torch.no_grad():
            if backward is not None and chain_kernel.has_shaper(stages):
                outs, recs = forward(x, stages, state_in, record=True)
            else:
                outs = forward(x, stages, state_in)
        if backward is None:
            ctx.save_for_backward(x, *state_in)
        else:
            shared = _shared_slots(stages)
            ctx.n_recs = len(recs)
            ctx.save_for_backward(*recs, *(state_in[i] for i in
                                           sorted(shared)))
        return fresh(flatten_outputs(outs), (x, *state_in))

    @staticmethod
    def backward(ctx, *cts):
        stages = ctx.stages
        need = ctx.needs_input_grad[3:]
        if ctx.backward_fn is None:
            x, *state_in = ctx.saved_tensors
            return (None, None, None,
                    *segment_vjp(x, stages, tuple(state_in), cts, need))
        if not any(need) or all(c is None for c in cts):
            return (None,) * (3 + len(ctx.shapes))
        saved = ctx.saved_tensors
        recs = saved[:ctx.n_recs]
        state_in = [None] * (len(ctx.shapes) - 1)
        for i, t in zip(sorted(_shared_slots(stages)), saved[ctx.n_recs:]):
            state_in[i] = t
        gx, g_states = ctx.backward_fn(cts, ctx.shapes, stages, recs,
                                       tuple(state_in))
        return (None, None, None, *(
            g.sum_to_size(shp) if n and g is not None else None
            for g, shp, n in zip((gx, *g_states), ctx.shapes, need)))


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


def _kernel_segment(x, stages: tuple, state_in, record=False):
    """The kernel path: leading dimensions flatten into kernel rows
    (per-stream states broadcast to them), and come back on every
    output.  ``record`` launches the kernel's record build and returns
    ``(outputs, recs)`` as ``segment_fallback`` does."""
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
    args = (x.reshape(B, T).contiguous(), stages, tuple(flat))
    out = (chain_kernel.chain_kernel_call(*args, record=True) if record
           else chain_kernel.chain_kernel_call(*args))
    y, casc_raw, ring_raw, taps = out[0] if record else out
    cinfos, hists = rebuild_states(stages, T, casc_raw, ring_raw)

    def unflat(t):
        return t.reshape(batch + tuple(t.shape[1:]))

    outs = (unflat(y),
            tuple(tuple(unflat(t) for t in info) for info in cinfos),
            tuple(unflat(h) for h in hists),
            tuple(unflat(t) for t in taps))
    return (outs, tuple(unflat(r) for r in out[1])) if record else outs


def _kernel_segment_adjoint(cts, shapes, stages: tuple, recs, state_in):
    """The reverse kernel's path, ``segment_adjoint``'s signature: the
    cotangents and recorded inputs flatten into kernel rows (the cascade
    infos' pulled back through ``cinfo_seeds`` first, small products in
    eager torch), the gradients come back at the batch shape."""
    from dsp_stuff_tpu_torch.ops import chain_reverse_kernel
    from dsp_stuff_tpu_torch.ops.cycle_segment import cinfo_seeds
    batch = _adjoint_batch((shapes[0], *_per_stream(stages, shapes)))
    B = int(np.prod(batch, dtype=np.int64))
    T = shapes[0][-1]
    dev = next(t.device for t in (*cts, *recs) if t is not None)
    ct_y, ct_infos, ct_hists, ct_taps = unflatten_outputs(cts, stages)

    def rows(t, n):
        if t is None:
            return None
        return t.to(torch.float32).expand(*batch, n).reshape(B, n) \
            .contiguous()

    seeds, hist_lens = [], []
    ci = 0
    for st in stages:
        if st[0] == "cascade":
            sd = cinfo_seeds(st[1], ct_infos[ci], batch, dev)
            ci += 1
            seeds.append((None, None) if sd is None else
                         (rows(sd[0], 128), rows(sd[1], sd[1].shape[-1])))
        elif st[0] in ("comb", "mtap"):
            hist_lens.append(int(st[2]))
    shared = _shared_slots(stages)
    gx, g_st = chain_reverse_kernel.chain_reverse_call(
        rows(ct_y, T), tuple(rows(t, T) for t in ct_taps), tuple(seeds),
        tuple(rows(t, n) for t, n in zip(ct_hists, hist_lens)),
        tuple(rows(r, T) for r in recs), stages,
        tuple(state_in[i] for i in sorted(shared)), B, T, dev)
    g_iter = iter(g_st)
    g_states = []
    for i, shp in enumerate(shapes[1:]):
        if i in shared:
            g_states.append(None)
            continue
        g = next(g_iter)
        g_states.append(g[:, :shp[-1]].reshape(*batch, shp[-1]))
    return gx.reshape(*batch, T), tuple(g_states)
