"""Fused feedback cycles: a whole SCC body as ONE op, with a hand-written
CUDA kernel on the GPU.

The compiler lowers a feedback SCC whose members are all supported
(add/mix/gain/low_pass/high_pass/biquad/reverb + the shapers at base
rate) to a static BLOCK PROGRAM over 128-sample blocks (compile.py
``_cycle_program``).  This module runs it: on a CPU tensor ``interpret``,
a Python loop over the T/128 blocks and the plain PyTorch version of the
cycle kernel; on a CUDA tensor the cycle kernel (ops/cycle_kernel.py),
which keeps every carried quantity (registers, cascade carries, comb
rings) on the card for the whole render.

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
                                             cascade_tail_states)
from dsp_stuff_tpu_torch.ops.chain_segment import (apply_ew, fresh,
                                                   grads_of, ring_history)
from dsp_stuff_tpu_torch.ops.scan import _const, needs_grad

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
              n_taps: int):
    """The block program as a Python loop over T/128 blocks: the plain
    PyTorch version of the cycle kernel."""
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
                flow = apply_ew(ins[1], flow, ins[2])
            elif op == "scale":
                flow = flow * float(np.float32(ins[1]))
            elif op == "setreg":
                regs[ins[1]] = flow
            elif op == "tap":
                tap_blks[ins[1]].append(flow)
            else:
                raise ValueError(f"unknown cycle instruction {op!r}")

    taps = tuple(torch.cat(torch.broadcast_tensors(*blks), dim=-1)
                 for blks in tap_blks)
    cinfos = tuple(
        (*cascade_tail_states(secs, x_last, c_in),
         x_last[..., -1], x_last[..., -2])
        for secs, (c_in, x_last) in zip(casc_secs, snaps))
    return taps, tuple(regs), cinfos, tuple(hists)


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


def _kernel_cycle(exts, regs0, states, program, n_taps):
    """The kernel path: leading dimensions flatten into kernel rows
    (registers and states broadcast to them) and come back on every
    output."""
    dev = exts[0].device
    batch = tuple(_batch_of(exts, regs0, states))
    T = exts[0].shape[-1]
    B = int(np.prod(batch, dtype=np.int64))

    def rows(t):
        t = torch.as_tensor(t, dtype=_F32, device=dev)
        return t.expand(*batch, t.shape[-1]).reshape(B, t.shape[-1]) \
            .contiguous()

    taps, regs_f, casc_raw, ring_raw = cycle_kernel.cycle_kernel_call(
        tuple(rows(e) for e in exts), tuple(rows(r) for r in regs0),
        tuple(rows(s) for s in states), program, n_taps)
    cinfos, hists = rebuild(program, T, casc_raw, ring_raw)

    def unflat(t):
        return t.reshape(batch + tuple(t.shape[1:]))

    return (tuple(unflat(t) for t in taps),
            tuple(unflat(r) for r in regs_f),
            tuple(tuple(unflat(t) for t in info) for info in cinfos),
            tuple(unflat(h) for h in hists))


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

    ``apply(forward, program, n_taps, n_e, n_r, *exts, *regs0, *states)``
    runs ``forward(exts, regs0, states, program, n_taps)`` (the kernel
    path ``_kernel_cycle``; a test passes ``interpret`` under no_grad in
    its place) once and saves its operands.  The backward re-runs
    ``interpret`` on them under autograd and pulls the cotangents of the
    taps, the final registers, the cascade infos and the histories back to
    every feed, register and state.  It linearizes the plain f32 program,
    which the kernel matches to rounding; it holds the loop's
    intermediates, as the JAX package's vjp does."""

    @staticmethod
    def forward(ctx, forward, program, n_taps, n_e, n_r, *operands):
        ctx.set_materialize_grads(False)
        ctx.program, ctx.n_taps, ctx.n_e, ctx.n_r = program, n_taps, n_e, n_r
        ctx.save_for_backward(*operands)
        exts, regs0 = operands[:n_e], operands[n_e:n_e + n_r]
        with torch.no_grad():
            flat = flatten_outputs(forward(exts, regs0, operands[n_e + n_r:],
                                           program, n_taps))
        return fresh(flat, operands)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[5:]
        ins = [t.detach().requires_grad_(bool(n))
               for t, n in zip(ctx.saved_tensors, need)]
        n_e, n_r = ctx.n_e, ctx.n_r
        with torch.enable_grad():
            outs = flatten_outputs(interpret(
                tuple(ins[:n_e]), tuple(ins[n_e:n_e + n_r]),
                tuple(ins[n_e + n_r:]), ctx.program, ctx.n_taps))
            grads = grads_of(outs, cts, [t if t.requires_grad else None
                                         for t in ins])
        return (None, None, None, None, None, *grads)


def cycle_segment(exts, regs0, states, program, n_taps: int):
    """Fused evaluation of a feedback-cycle block program (see the module
    docstring).  Dispatch is by the feeds' device alone: CPU tensors take
    ``interpret``, CUDA tensors the cycle kernel, which raises on what it
    cannot take; on the card an operand that requires grad goes through
    ``CycleSegment`` (the kernel forward, ``interpret``'s vjp backward)."""
    program = tuple(program)
    exts = tuple(torch.as_tensor(e, dtype=_F32) for e in exts)
    if not exts:
        raise ValueError("cycle_segment: the program needs an external feed")
    dev = exts[0].device
    if dev.type == "cpu":
        return interpret(exts, tuple(regs0), tuple(states), program, n_taps)
    if dev.type != "cuda":
        raise ValueError(f"cycle_segment: no kernel for device {dev}")
    return run_cycle(_kernel_cycle, exts, tuple(regs0), tuple(states),
                     program, n_taps)


def run_cycle(forward, exts: tuple, regs0: tuple, states: tuple,
              program: tuple, n_taps: int):
    """``forward(exts, regs0, states, program, n_taps)``, through
    ``CycleSegment`` when autograd must see it (the card's dispatch; a test
    passes the plain version as ``forward``)."""
    if not needs_grad((*exts, *regs0, *states)):
        return forward(exts, regs0, states, program, n_taps)
    dev = exts[0].device
    regs0, states = (tuple(torch.as_tensor(t, dtype=_F32, device=dev)
                           for t in ts) for ts in (regs0, states))
    return unflatten_outputs(CycleSegment.apply(
        forward, program, n_taps, len(exts), len(regs0), *exts, *regs0,
        *states), program, n_taps)
