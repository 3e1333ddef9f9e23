"""Fused feedback cycles: a whole SCC body as ONE op, with a hand-written
CUDA kernel on the GPU.

The compiler lowers a feedback SCC whose members are all supported
(add/mix/gain/low_pass/high_pass/biquad/reverb + the shapers at base
rate) to a static BLOCK PROGRAM over 128-sample blocks (compile.py
``_cycle_program``).  This module runs it: on a CPU tensor ``interpret``,
a Python loop over the T/128 blocks and the plain PyTorch version of the
cycle kernel; on a CUDA tensor the cycle kernel (ops/cycle_kernel.py),
which keeps every carried quantity (registers, cascade carries, comb
rings) on the card for the whole render.  Under autograd on the card
``CycleSegment`` runs the kernel forward (its record build when the
program has a shaper) and the reverse cycle kernel backward
(ops/cycle_reverse_kernel.py), whose plain version is
``interpret_adjoint``.

Program grammar (static tuples):

    ("join", terms, scale)          flow := (sum of term values) * scale
    ("lin2", tA, sA, tB, sB, cA, cB)
                                    flow := (sum tB)*sB*cB + (sum tA)*sA*cA
                                    (add: cA=cB=1; mix: cA=1-r, cB=r --
                                    mix.rs:33-47, add.rs:24-34)
    ("cascade", sections, ci)       ops/cascade composed linear run
    ("comb", decay, D, bi)          y[n] = x[n] + d*y[n-D] (reverb.rs:87-105),
                                    D >= 128
    ("ew", kind, params)            stateless shaper (ops/shaping.py)
    ("scale", s)                    flow := flow * s
    ("setreg", ri)                  register ri := flow
    ("tap", ti)                     emit flow as output sequence ti

    term := ("ext", ei) | ("reg", ri)

A back edge reads its register BEFORE its writer's ``setreg`` runs in the
block, so it sees the previous block's value: the reference's emergent
one-block feedback latency (runtime.rs:718-728).  Fan-in scales multiply
by the f32 reciprocal of (n + 1e-4) (the fast policy's documented 1-ulp
class; the program only runs under ``fast``).

``cycle_segment(exts, regs0, states, program, n_taps)`` takes the
external feeds [..., T], the registers [..., 128] and, per stateful
instruction in program order, the cascade composite state [..., N] or
the comb history [..., D]; it returns ``(taps, regs_f, cinfos, hists)``:

    taps   -- tuple of [..., T] emitted sequences, tap-index order;
    regs_f -- tuple of [..., 128] final registers (the next render's
              one-block-delay carry);
    cinfos -- per cascade (s_tm1, s_tm2, x_tm1, x_tm2) for
              ops/cascade.cascade_state_out;
    hists  -- per comb the new [..., D] history (oldest first).
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import cycle_kernel
from dsp_stuff_tpu_torch.ops.cascade import (_cascade_constants,
                                             _tail_state_constants,
                                             cascade_tail_states)
from dsp_stuff_tpu_torch.ops.chain_segment import (apply_ew, fresh,
                                                   ring_history)
from dsp_stuff_tpu_torch.ops.scan import _const, const_on, needs_grad

C = 128
_F32 = torch.float32


def _program_counts(program: tuple):
    """(n_cascades, n_combs, n_regs, n_taps, n_exts) of a program."""
    n_c = sum(1 for ins in program if ins[0] == "cascade")
    n_b = sum(1 for ins in program if ins[0] == "comb")
    n_r = 1 + max((ins[1] for ins in program if ins[0] == "setreg"),
                  default=-1)
    n_t = 1 + max((ins[1] for ins in program if ins[0] == "tap"),
                  default=-1)
    n_e = 1 + max((t[1] for ins in program if ins[0] in ("join", "lin2")
                   for t in (ins[1] + (ins[3] if ins[0] == "lin2" else ()))
                   if t[0] == "ext"), default=-1)
    return n_c, n_b, n_r, n_t, n_e


def _casc_step(sections: tuple, blk, carry):
    """One 128-block cascade step: (y, new_carry), the blocked math of
    ops/cascade.linear_cascade restricted to one chunk."""
    Ltg, W, E, P, _N, _B, _l1, _ = _cascade_constants(sections, C, ())
    AC = P[C].astype(np.float32)
    y = blk @ _const(Ltg, blk) + carry @ _const(np.ascontiguousarray(E.T),
                                                blk)
    newc = blk @ _const(W, blk) + carry @ _const(np.ascontiguousarray(AC.T),
                                                 blk)
    return y, newc


def _batch_of(exts, regs0, states):
    shapes = [t.shape[:-1] for t in (*exts, *regs0, *states)]
    return torch.broadcast_shapes(*shapes)


def interpret(exts: tuple, regs0: tuple, states: tuple, program: tuple,
              n_taps: int, record: bool = False):
    """The block program as a Python loop over T/128 blocks: the plain
    PyTorch version of the cycle kernel.  With ``record`` it returns
    ``(outputs, recs)``: recs holds each ``ew`` instruction's input over
    the render, [..., T] in program order, what the kernel's record build
    writes (the residuals of ``interpret_adjoint``)."""
    exts = tuple(torch.as_tensor(e, dtype=_F32) for e in exts)
    dev = exts[0].device
    T = exts[0].shape[-1]
    if T % C:
        raise ValueError(f"cycle_segment: T={T} must be a multiple of {C}")
    nb = T // C
    batch = _batch_of(exts, regs0, states)
    n_t = _program_counts(program)[3]

    casc_secs = [ins[1] for ins in program if ins[0] == "cascade"]
    si = 0
    ccs, hists = [], []
    for ins in program:
        if ins[0] == "cascade":
            s0 = torch.as_tensor(states[si], dtype=_F32, device=dev)
            si += 1
            # pad to the embedded carry dim (callers may pass the raw
            # composite dim)
            N = _cascade_constants(ins[1], C, ())[4]
            s0 = torch.nn.functional.pad(s0, (0, N - s0.shape[-1]))
            ccs.append(s0.expand(*batch, N))
        elif ins[0] == "comb":
            if ins[2] < C:
                raise ValueError(f"cycle_segment: comb delay {ins[2]} < {C}")
            h = torch.as_tensor(states[si], dtype=_F32, device=dev)
            si += 1
            hists.append(h.expand(*batch, h.shape[-1]))
    regs = [torch.as_tensor(r, dtype=_F32, device=dev).expand(*batch, C)
            for r in regs0]
    # per cascade: (carry entering the block, block input) of the last block
    snaps = [None] * len(ccs)
    tap_blks = [[] for _ in range(n_t)]
    rec_blks = [[] for ins in program if ins[0] == "ew"]

    for b in range(nb):
        blk_ext = [e[..., b * C:(b + 1) * C] for e in exts]

        def term_val(t):
            return blk_ext[t[1]] if t[0] == "ext" else regs[t[1]]

        def join(terms, scale):
            acc = term_val(terms[0])
            for t in terms[1:]:
                acc = acc + term_val(t)
            return acc * float(np.float32(scale)) if scale != 1.0 else acc

        flow = None
        k = 0
        for ins in program:
            op = ins[0]
            if op == "join":
                flow = join(ins[1], ins[2])
            elif op == "lin2":
                _, tA, sA, tB, sB, cA, cB = ins
                a = join(tA, sA)
                bb = join(tB, sB)
                flow = bb * float(np.float32(cB)) + a * float(np.float32(cA))
            elif op == "cascade":
                ci = ins[2]
                snaps[ci] = (ccs[ci], flow)
                flow, ccs[ci] = _casc_step(ins[1], flow, ccs[ci])
            elif op == "comb":
                _, decay, _D, bi = ins
                flow = flow + hists[bi][..., :C] * float(np.float32(decay))
                hists[bi] = torch.cat([hists[bi][..., C:], flow], dim=-1)
            elif op == "ew":
                if record:
                    rec_blks[k].append(flow)
                k += 1
                flow = apply_ew(ins[1], flow, ins[2])
            elif op == "scale":
                flow = flow * float(np.float32(ins[1]))
            elif op == "setreg":
                regs[ins[1]] = flow
            elif op == "tap":
                tap_blks[ins[1]].append(flow)
            else:
                raise ValueError(f"unknown cycle instruction {op!r}")

    def seq(blks):
        return torch.cat(torch.broadcast_tensors(*blks), dim=-1)

    taps = tuple(seq(blks) for blks in tap_blks)
    cinfos = tuple(
        (*cascade_tail_states(secs, x_last, c_in),
         x_last[..., -1], x_last[..., -2])
        for secs, (c_in, x_last) in zip(casc_secs, snaps))
    outs = taps, tuple(regs), cinfos, tuple(hists)
    if not record:
        return outs
    return outs, tuple(seq(blks).expand(*batch, T) for blks in rec_blks)


# -- the adjoint --------------------------------------------------------------
#
# interpret_adjoint is the vjp of ``interpret`` written out as a reverse
# loop over the blocks, each block's instructions in reverse order, with
# the adjoint rules the reverse kernel (csrc/cycle_reverse_kernel.cu,
# generated per program by ops/cycle_reverse_kernel.py) follows in the
# same order of operations:
#
#   setreg r   f += g_r; g_r = 0
#   tap t      f += ct_t[block]
#   scale s    f *= s
#   ew         f = ew_adjoint(kind, f, the recorded input, params)
#   comb       v = f (+ the final history's cotangent, last D samples)
#              + d * vbar[n + D]; vbar[n] = v; f = v
#   cascade    gX = f Ltg^T + gc' W^T, gc = f E + gc' AC (the carry's
#              adjoint gc' leaving the block, gc entering it); f = gX
#   join       s = f * scale; each term's register or feed += s; f = 0
#   lin2       sa = f * cA * sA, sb = f * cB * sB into the terms; f = 0
#
# Registers carry their adjoints across blocks (the final registers'
# cotangents seed them), a cascade its carry's, a comb a ring of future
# adjoints.  Everything but the shapers is linear, so the only forward
# values it reads are the shapers' inputs (``interpret(record=True)``).


def _clip_mask(v):
    """1 where clamp(v, -1, 1) passes its input's gradient (bounds
    included, as torch.clamp's backward), else 0."""
    return ((v >= -1.0) & (v <= 1.0)).to(_F32)


def _tanh20_grad(g, v):
    """g through _tanh(v) = tanh(clamp(v, -20, 20)), from the input."""
    t = torch.tanh(torch.clamp(v, -20.0, 20.0))
    return g * (1.0 - t * t) * ((v >= -20.0) & (v <= 20.0)).to(_F32)


def _tie_grad(g, a, m):
    """The gradient ``g`` [..., nb, 1] of m = amax(|x|) over each block back
    to x through a = |x| [..., nb, 128]: split evenly among the ties, as
    torch.amax's backward (and JAX's reduce_max) does."""
    hit = (a == m).to(_F32)
    return (g / hit.sum(-1, keepdim=True)) * hit


def _fuzz_adjoint(g, x, level):
    """vjp of ops/shaping.fuzz at ``x`` for a scalar level: the three block
    maxima's gradients split among their ties."""
    lead = x.shape[:-1]
    nb = x.shape[-1] // C
    x = x.reshape(*lead, nb, C)
    g = g.reshape(*lead, nb, C)
    sx = torch.sign(x)
    ax = torch.abs(x)
    mx = torch.amax(ax, dim=-1, keepdim=True)
    u = x * level
    cu = torch.clamp(u, -1.0, 1.0)
    q = cu / mx
    e = torch.exp(-torch.abs(q))
    z = -(1.0 - e)
    az = torch.abs(z)
    mz = torch.amax(az, dim=-1, keepdim=True)
    w = z * mx
    cw = torch.clamp(w, -1.0, 1.0)
    y = cw / mz
    ay = torch.abs(y)
    my = torch.amax(ay, dim=-1, keepdim=True)
    p = y * mx
    gp = g / my
    gmy = (-(g * p) / (my * my)).sum(-1, keepdim=True)
    gy = gp * mx + _tie_grad(gmy, ay, my) * torch.sign(y)
    gcw = gy / mz
    gmz = (-(gy * cw) / (mz * mz)).sum(-1, keepdim=True)
    gw = gcw * _clip_mask(w)
    gz = gw * mx + _tie_grad(gmz, az, mz) * torch.sign(z)
    gq = -(gz * e * torch.sign(q))
    gcu = gq / mx
    gmx = (gp * y + gw * z - gq * cu / (mx * mx)).sum(-1, keepdim=True)
    gx = gcu * _clip_mask(u) * level + _tie_grad(gmx, ax, mx) * sx
    return gx.reshape(*lead, nb * C)


def ew_adjoint(kind: str, g, x, params):
    """The vjp of the shaper ``apply_ew(kind, x, params)`` at its input
    ``x`` for the cotangent ``g``, as PyTorch autograd (and JAX) takes it
    through ops/shaping.py: a bypassed shaper (level < 0.001) passes g,
    torch.where's branches take their own, clamp passes its gradient at
    its bounds, tanh's and atan's derivatives come from x."""
    from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
    p = [float(np.float32(v)) for v in params]
    if kind == "overdrive":
        boost, drive, level = p
        if level < BYPASS_EPS:
            return g
        b = float(np.float32(np.pi / 4.0)) * (x * boost)
        gm = g * level
        gb = (gm * drive * float(np.float32(2.0 / np.pi))) / (1.0 + b * b)
        return gm * float(np.float32(1.0 - np.float32(drive))) + \
            gb * float(np.float32(np.pi / 4.0)) * boost
    if kind == "chebyshev":
        lp, ln = p
        pos = x >= 0.0
        lv = torch.where(pos, torch.full_like(x, lp), torch.full_like(x, ln))
        den = torch.where(pos, torch.full_like(x, _tanh20(lp)),
                          torch.full_like(x, _tanh20(ln)))     # safe levels
        gs = _tanh20_grad(g / den, x * lv) * lv
        return torch.where(lv < BYPASS_EPS, g, gs)
    mode = kind.split(":", 1)[1]
    level = p[0]
    if mode == "Fuzz":
        return _fuzz_adjoint(g, x, level)
    if level < BYPASS_EPS:
        return g
    v = x * level
    if mode == "HardClip":
        gv = (g / level) * _clip_mask(v)
    elif mode == "SoftClip":
        inner = (v >= -1.0) & (v <= 1.0)
        gv = torch.where(inner, (g / level) * (1.0 - v * v),
                         torch.zeros_like(v))
    elif mode == "Tanh":
        gv = _tanh20_grad(g, v)
    elif mode == "RecipSoftClip":
        s = torch.sign(x)
        r = 1.0 / (torch.abs(x) * level + 1.0)
        return g * s * (r * r) * level * s
    elif mode == "Sin":
        gv = g * torch.cos(v)
    elif mode == "Atan":
        gv = g / (1.0 + v * v)
    elif mode == "Square":
        gv = 2.0 * (g * torch.sign(v)) * v
    elif mode == "Chebyshev4":
        gv = 2.0 * (16.0 * g * (v * v) - 8.0 * g) * v
    else:
        raise ValueError(f"ew_adjoint: unknown shaper {kind!r}")
    return gv * level


def _tanh20(v: float) -> float:
    """chebyshev's denominator: ops/shaping._tanh of a level (1 in the
    bypass region, ``_safe_level``), in float32."""
    from dsp_stuff_tpu_torch.ops.shaping import BYPASS_EPS
    v = 1.0 if v < BYPASS_EPS else v
    return float(torch.tanh(torch.tensor(min(max(v, -20.0), 20.0),
                                         dtype=_F32)))


def cinfo_seeds(sections: tuple, cts, batch: tuple, dev):
    """The cotangents of one cascade's info (s_tm1, s_tm2, x_tm1, x_tm2),
    entries None where there is none, pulled back through
    ``cascade_tail_states`` and the last block's two inputs: (gradient of
    the last block's input [*batch, 128], of the carry entering it
    [*batch, N]), None when every cotangent is None.  The two states'
    cotangents go through one product each for the input and the carry,
    side by side ([s_tm1 | s_tm2] against the stacked constants)."""
    if all(c is None for c in cts):
        return None
    (P1, T1), (P2, T2), N = _tail_state_constants(tuple(sections), C)
    live = [i for i in (0, 1) if cts[i] is not None]
    if live:
        ct = (cts[live[0]] if len(live) == 1
              else torch.cat([cts[0], cts[1]], dim=-1))
        gx = ct @ const_on(np.concatenate([(T1, T2)[i].T for i in live]),
                           dev)
        gc = ct @ const_on(np.concatenate([(P1, P2)[i] for i in live]), dev)
        if tuple(gx.shape[:-1]) != tuple(batch):     # a broadcast cotangent
            gx = gx.expand(*batch, C).clone()
            gc = gc.expand(*batch, N).clone()
    else:
        gx = torch.zeros(*batch, C, dtype=_F32, device=dev)
        gc = torch.zeros(*batch, N, dtype=_F32, device=dev)
    for i, ct in ((-1, cts[2]), (-2, cts[3])):
        if ct is not None:
            gx[..., i] = gx[..., i] + ct
    return gx, gc


def adjoint_batch(shapes) -> tuple:
    """The batch shape of a program's operands from their ``shapes``
    ((ext shapes), (register shapes), (state shapes))."""
    return tuple(torch.broadcast_shapes(*(s[:-1] for grp in shapes
                                          for s in grp)))


def interpret_adjoint(cts, shapes, program: tuple, n_taps: int, recs):
    """The vjp of ``interpret`` as an explicit reverse loop over the
    blocks: the plain PyTorch version of the reverse cycle kernel (the
    rules above).  ``cts`` are the cotangents of ``flatten_outputs``'s
    entries (None: none), ``shapes`` the operands' shapes ((feeds),
    (registers), (states)), ``recs`` the shapers' recorded inputs.
    Returns (feed gradients, register gradients, state gradients) at the
    operands' batch shape: the feeds [*batch, T], the registers [*batch,
    128], a cascade state [*batch, its width], a comb history [*batch,
    D]."""
    ext_s, reg_s, st_s = shapes
    batch = adjoint_batch(shapes)
    T = ext_s[0][-1]
    if T % C:
        raise ValueError(f"cycle_segment: T={T} must be a multiple of {C}")
    nb = T // C
    dev = next(t.device for t in (*cts, *recs) if t is not None)
    ct_taps, ct_regs, ct_infos, ct_hists = unflatten_outputs(
        cts, program, n_taps)

    def zeros(n):
        return torch.zeros(*batch, n, dtype=_F32, device=dev)

    def full(t, n):
        return zeros(n) if t is None else t.to(_F32).expand(*batch, n)

    g_regs = [full(ct, C) for ct in ct_regs]
    g_ext = [zeros(T) for _ in ext_s]
    casc, combs = [], []
    for ins in program:
        if ins[0] == "cascade":
            Ltg, W, E, P, N, _B, _l1, _ = _cascade_constants(ins[1], C, ())
            AC = P[C].astype(np.float32)
            casc.append(dict(
                LtgT=const_on(np.ascontiguousarray(Ltg.T), dev),
                WT=const_on(np.ascontiguousarray(W.T), dev),
                E=const_on(np.ascontiguousarray(E), dev),
                AC=const_on(AC, dev), gc=zeros(N),
                seed=cinfo_seeds(ins[1], ct_infos[len(casc)], batch, dev)))
        elif ins[0] == "comb":
            _, decay, D, _bi = ins
            D = int(D)
            RL = -(-D // C) * C
            cth = ct_hists[len(combs)]
            direct = None
            if cth is not None:
                cth = full(cth, D)
                direct = zeros(T)
                direct[..., max(T - D, 0):] = cth[..., max(D - T, 0):]
            combs.append(dict(d=float(np.float32(decay)), D=D, cth=cth,
                              direct=direct, vbar=zeros(T + RL)))

    for b in reversed(range(nb)):
        sl = slice(b * C, (b + 1) * C)
        last = b == nb - 1
        f = zeros(C)
        k = sum(1 for ins in program if ins[0] == "ew")
        for ins in reversed(program):
            op = ins[0]
            if op == "setreg":
                f = f + g_regs[ins[1]]
                g_regs[ins[1]] = zeros(C)
            elif op == "tap":
                if ct_taps[ins[1]] is not None:
                    f = f + ct_taps[ins[1]][..., sl]
            elif op == "scale":
                f = f * float(np.float32(ins[1]))
            elif op == "ew":
                k -= 1
                f = ew_adjoint(ins[1], f, recs[k][..., sl], ins[2])
            elif op == "comb":
                cb = combs[ins[3]]
                if cb["direct"] is not None:
                    f = f + cb["direct"][..., sl]
                D = cb["D"]
                f = f + cb["vbar"][..., b * C + D:(b + 1) * C + D] * cb["d"]
                cb["vbar"][..., sl] = f
            elif op == "cascade":
                cs = casc[ins[2]]
                gx = f @ cs["LtgT"] + cs["gc"] @ cs["WT"]
                gc = f @ cs["E"] + cs["gc"] @ cs["AC"]
                if last and cs["seed"] is not None:
                    gx = gx + cs["seed"][0]
                    gc = gc + cs["seed"][1]
                cs["gc"] = gc
                f = gx
            elif op in ("join", "lin2"):
                if op == "join":
                    groups = ((ins[1], ins[2], 1.0),)
                else:
                    _, tA, sA, tB, sB, cA, cB = ins
                    groups = ((tA, sA, cA), (tB, sB, cB))
                for terms, scale, coef in groups:
                    s = f * float(np.float32(coef)) if op == "lin2" else f
                    if scale != 1.0:
                        s = s * float(np.float32(scale))
                    for kind, j in terms:
                        if kind == "reg":
                            g_regs[j] = g_regs[j] + s
                        else:
                            g_ext[j][..., sl] = g_ext[j][..., sl] + s
                f = zeros(C)
            else:
                raise ValueError(f"unknown cycle instruction {op!r}")

    g_states = []
    ci = bi = 0
    for ins, shp in zip((i for i in program if i[0] in ("cascade", "comb")),
                        st_s):
        if ins[0] == "cascade":
            g_states.append(casc[ci]["gc"][..., :shp[-1]])
            ci += 1
        else:
            cb = combs[bi]
            bi += 1
            D, m = cb["D"], min(cb["D"], T)
            gh = zeros(D)
            gh[..., :m] = cb["vbar"][..., :m] * cb["d"]
            if cb["cth"] is not None and T < D:
                gh[..., T:] = gh[..., T:] + cb["cth"][..., :D - T]
            g_states.append(gh)
    return tuple(g_ext), tuple(g_regs), tuple(g_states)


def rebuild(program: tuple, T: int, casc_raw, ring_raw):
    """(cinfos, hists) from the cycle kernel's raw outputs.

    casc_raw -- per cascade (carry entering the last block [B, >= N], that
                block's input [B, 128]);
    ring_raw -- per comb the ring [B, NR, 128], NR = ceil(D/128), slot s
                holding block b == s (mod NR) of the comb's output."""
    casc_secs = [ins[1] for ins in program if ins[0] == "cascade"]
    cinfos = []
    for secs, (carry_last, x_last) in zip(casc_secs, casc_raw):
        s1, s2 = cascade_tail_states(secs, x_last, carry_last)
        cinfos.append((s1, s2, x_last[..., -1], x_last[..., -2]))
    combs = [ins for ins in program if ins[0] == "comb"]
    hists = tuple(ring_history(ring, T // C, ins[2])
                  for ins, ring in zip(combs, ring_raw))
    return tuple(cinfos), hists


def _kernel_cycle(exts, regs0, states, program, n_taps, record=False):
    """The kernel path: leading dimensions flatten into kernel rows
    (registers and states broadcast to them) and come back on every
    output.  ``record`` runs the kernel's record build and returns
    ``(outputs, recs)`` as ``interpret`` does."""
    dev = exts[0].device
    batch = tuple(_batch_of(exts, regs0, states))
    T = exts[0].shape[-1]
    B = int(np.prod(batch, dtype=np.int64))

    def rows(t):
        t = torch.as_tensor(t, dtype=_F32, device=dev)
        return t.expand(*batch, t.shape[-1]).reshape(B, t.shape[-1]) \
            .contiguous()

    args = (tuple(rows(e) for e in exts), tuple(rows(r) for r in regs0),
            tuple(rows(s) for s in states), program, n_taps)
    out = (cycle_kernel.cycle_kernel_call(*args, record=True) if record
           else cycle_kernel.cycle_kernel_call(*args))
    taps, regs_f, casc_raw, ring_raw = out[0] if record else out
    cinfos, hists = rebuild(program, T, casc_raw, ring_raw)

    def unflat(t):
        return t.reshape(batch + tuple(t.shape[1:]))

    outs = (tuple(unflat(t) for t in taps),
            tuple(unflat(r) for r in regs_f),
            tuple(tuple(unflat(t) for t in info) for info in cinfos),
            tuple(unflat(h) for h in hists))
    return (outs, tuple(unflat(r) for r in out[1])) if record else outs


def _kernel_cycle_adjoint(cts, shapes, program, n_taps, recs):
    """The reverse kernel's path, ``interpret_adjoint``'s signature: the
    cotangents flatten into kernel rows (the cascade infos' pulled back
    through ``cinfo_seeds`` first, in eager torch), the gradients come
    back at the batch shape."""
    from dsp_stuff_tpu_torch.ops import cycle_reverse_kernel
    batch = adjoint_batch(shapes)
    B = int(np.prod(batch, dtype=np.int64))
    T = shapes[0][0][-1]
    dev = next(t.device for t in (*cts, *recs) if t is not None)
    ct_taps, ct_regs, ct_infos, ct_hists = unflatten_outputs(
        cts, program, n_taps)

    def rows(t, n):
        if t is None:
            return None
        return t.to(_F32).expand(*batch, n).reshape(B, n).contiguous()

    secs = [ins[1] for ins in program if ins[0] == "cascade"]
    Ds = [int(ins[2]) for ins in program if ins[0] == "comb"]
    seeds = []
    for sec, info in zip(secs, ct_infos):
        sd = cinfo_seeds(sec, info, batch, dev)
        seeds.append((None, None) if sd is None else
                     (rows(sd[0], C), rows(sd[1], sd[1].shape[-1])))
    g_e, g_r, g_s = cycle_reverse_kernel.cycle_reverse_call(
        tuple(rows(t, T) for t in ct_taps), tuple(rows(t, C) for t in ct_regs),
        tuple(seeds), tuple(rows(t, D) for t, D in zip(ct_hists, Ds)),
        tuple(rows(r, T) for r in recs), program, len(shapes[0]), B, T, dev)

    def unflat(t, n):
        return t[:, :n].reshape(*batch, n)

    return (tuple(unflat(g, T) for g in g_e), tuple(unflat(g, C) for g in g_r),
            tuple(unflat(g, shp[-1]) for g, shp in zip(g_s, shapes[2])))


def flatten_outputs(outs) -> tuple:
    """A program's (taps, regs_f, cinfos, hists) as one flat tuple: the
    taps, the registers, each cascade's four entries, the histories.  The
    one flattening CycleSegment's forward and backward share."""
    taps, regs_f, cinfos, hists = outs
    return (*taps, *regs_f, *(t for info in cinfos for t in info), *hists)


def unflatten_outputs(flat, program: tuple, n_taps: int):
    """flatten_outputs' inverse for ``program``."""
    n_c, n_b, n_r, _, _ = _program_counts(program)
    i = n_taps + n_r
    cinfos = tuple(tuple(flat[i + 4 * c:i + 4 * c + 4]) for c in range(n_c))
    return (tuple(flat[:n_taps]), tuple(flat[n_taps:i]), cinfos,
            tuple(flat[i + 4 * n_c:i + 4 * n_c + n_b]))


class CycleSegment(torch.autograd.Function):
    """A feedback cycle's block program on the card under autograd: the
    counterpart of the JAX package's custom_vjp (``_cycle_vjp``).

    ``apply(forward, backward, program, n_taps, n_e, n_r, *exts, *regs0,
    *states)`` runs ``forward(exts, regs0, states, program, n_taps)``
    once (the kernel path ``_kernel_cycle``, its record build when the
    program has a shaper: ``record=True`` returns the shapers' inputs
    too; a test passes ``interpret`` in its place) and keeps the operands'
    shapes and the recorded inputs.  The backward runs ``backward(cts,
    shapes, program, n_taps, recs)`` (the reverse kernel's path
    ``_kernel_cycle_adjoint``; a test passes ``interpret_adjoint``), the
    vjp of the block program, and sums each gradient to its operand's
    shape (an operand broadcast over the batch gets the sum over it)."""

    @staticmethod
    def forward(ctx, forward, backward, program, n_taps, n_e, n_r,
                *operands):
        ctx.set_materialize_grads(False)
        exts, regs0 = operands[:n_e], operands[n_e:n_e + n_r]
        states = operands[n_e + n_r:]
        record = cycle_kernel.has_shaper(program)
        with torch.no_grad():
            if record:
                outs, recs = forward(exts, regs0, states, program, n_taps,
                                     record=True)
            else:
                outs, recs = forward(exts, regs0, states, program,
                                     n_taps), ()
        ctx.save_for_backward(*recs)
        ctx.backward_fn, ctx.program, ctx.n_taps = backward, program, n_taps
        ctx.shapes = tuple(tuple(t.shape for t in grp)
                           for grp in (exts, regs0, states))
        return fresh(flatten_outputs(outs), operands)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[6:]
        flat_shapes = [s for grp in ctx.shapes for s in grp]
        if not any(need) or all(c is None for c in cts):
            return (None,) * (6 + len(flat_shapes))
        grads = ctx.backward_fn(cts, ctx.shapes, ctx.program, ctx.n_taps,
                                ctx.saved_tensors)
        flat = [g for grp in grads for g in grp]
        return (None,) * 6 + tuple(
            g.sum_to_size(shp) if n else None
            for g, shp, n in zip(flat, flat_shapes, need))


def cycle_segment(exts, regs0, states, program, n_taps: int):
    """Fused evaluation of a feedback-cycle block program (see the module
    docstring).  Dispatch is by the feeds' device alone: CPU tensors take
    ``interpret``, CUDA tensors the cycle kernel, which raises on what it
    cannot take; on the card an operand that requires grad goes through
    ``CycleSegment`` (the kernel forward, the reverse kernel backward)."""
    program = tuple(program)
    exts = tuple(torch.as_tensor(e, dtype=_F32) for e in exts)
    if not exts:
        raise ValueError("cycle_segment: the program needs an external feed")
    dev = exts[0].device
    if dev.type == "cpu":
        return interpret(exts, tuple(regs0), tuple(states), program, n_taps)
    if dev.type != "cuda":
        raise ValueError(f"cycle_segment: no kernel for device {dev}")
    return run_cycle(_kernel_cycle, _kernel_cycle_adjoint, exts,
                     tuple(regs0), tuple(states), program, n_taps)


def run_cycle(forward, backward, exts: tuple, regs0: tuple, states: tuple,
              program: tuple, n_taps: int):
    """``forward(exts, regs0, states, program, n_taps)``, through
    ``CycleSegment`` with ``backward`` when autograd must see it (the
    card's dispatch; a test passes the plain versions, ``interpret`` and
    ``interpret_adjoint``)."""
    if not needs_grad((*exts, *regs0, *states)):
        return forward(exts, regs0, states, program, n_taps)
    dev = exts[0].device
    regs0, states = (tuple(torch.as_tensor(t, dtype=_F32, device=dev)
                           for t in ts) for ts in (regs0, states))
    return unflatten_outputs(CycleSegment.apply(
        forward, backward, program, n_taps, len(exts), len(regs0), *exts,
        *regs0, *states), program, n_taps)
