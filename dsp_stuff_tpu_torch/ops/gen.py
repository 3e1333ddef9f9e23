"""Signal generator oscillators (signal_gen.rs semantics).

The reference integrates a per-sample phase step ``f[i]/48000`` into a
running ``total`` within each 128-sample block, on top of a persistent
``clock`` phase that wraps mod 1.0 across blocks (signal_gen.rs:57-103):

    sine:     sin((clock + total_i) * tau) * amp_i     (signal_gen.rs:57-71)
    triangle: (2*((clock + total_i) % 1) - 1) * amp_i  (signal_gen.rs:73-87)
    square:   (total_i > 0.5 ? 1 : -1) * amp_i         (signal_gen.rs:89-103)
    constant: amp_i                                     (signal_gen.rs:106-108)

The square wave compares only the *intra-block* total (ignoring ``clock``),
a reference bug that makes square output wrong below ~187.5 Hz at block
128 (SURVEY.md 2.4 #4); it is kept, with the per-block
``clock = (clock + total) % 1`` wrap in f32.

On the card :func:`oscillator` runs the oscillator kernel
(ops/oscillator_kernel.py, csrc/oscillator_kernel.cu: the counterpart of
what XLA compiles for the JAX package's ``_block_totals`` and
``oscillator``); :func:`oscillator_plain` is its plain version, and what
the CPU runs.  Under autograd its backward is the reverse oscillator
kernel (ops/oscillator_reverse_kernel.py,
csrc/oscillator_reverse_kernel.cu: the counterpart of the vjp XLA
compiles for ``jax.grad``), whose plain version is
:func:`oscillator_adjoint`.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import oscillator_kernel
from dsp_stuff_tpu_torch.ops.chain_segment import fresh
from dsp_stuff_tpu_torch.ops.scan import needs_grad
from dsp_stuff_tpu_torch.utils.precision import (get_policy, on_device,
                                                  policy, scalar_on)
from dsp_stuff_tpu_torch.utils.sums64 import block_sums64, sum_to64, tree64

TAU = float(np.float32(2.0 * np.pi))
_F32 = torch.float32


def _block_totals(freq, T: int, block_size: int, sample_rate: int, clock0,
                  device):
    """Per-sample in-block running total and per-block carry-in clock.

    freq: scalar or [..., T].  Returns (totals [..., T], clock [..., T],
    final_clock), where totals resets at each block boundary and clock is
    the persistent phase at each sample's block start (wrapped mod 1 each
    block, f32, seeded with clock0).

    The in-block running sum is a true sequential f32 sum (the reference's
    ``total += step``), with all blocks vectorized: ``block_size``
    sequential adds regardless of T.  A 1-ulp phase difference at a mod-1
    wrap flips the triangle output by full scale, so a reassociated sum
    would not do."""
    if T % block_size:
        raise ValueError(f"T={T} must be a multiple of {block_size}")
    nb = T // block_size
    freq = on_device(freq, device)
    step = freq / scalar_on(float(sample_rate), freq.device)
    c0 = on_device(clock0, device)
    batch = torch.broadcast_shapes(step.shape[:-1], c0.shape)
    step = step.expand(*batch, T)
    c0 = c0.expand(batch)
    sb = step.reshape(*batch, nb, block_size)
    tots = []
    acc = torch.zeros((*batch, nb), dtype=_F32, device=device)
    for i in range(block_size):
        acc = acc + sb[..., i]
        tots.append(acc)
    totals = torch.stack(tots, dim=-1)                        # [..., nb, B]
    block_sum = totals[..., -1]                                # [..., nb]

    if get_policy().name == "fast":
        # c[k] = (c0 + sum(bs[:k])) % 1: an f64 cumulative sum is exact to
        # ~2^-40 over hours of audio, so one vectorized pass replaces the
        # T/128-step chain of f32 wraps
        csum = torch.cumsum(block_sum.to(torch.float64), dim=-1)
        shifted = torch.cat([torch.zeros((*batch, 1), dtype=torch.float64,
                                         device=device), csum], dim=-1)
        cl = torch.remainder(c0[..., None].to(torch.float64) + shifted, 1.0)
        clocks = cl[..., :-1].to(_F32)
        final_clock = cl[..., -1].to(_F32)
    else:
        c = c0
        cs = []
        for k in range(nb):
            cs.append(c)
            c = torch.remainder(c + block_sum[..., k], 1.0)
        clocks = torch.stack(cs, dim=-1)
        final_clock = c
    return (totals.reshape(*batch, T),
            clocks.repeat_interleave(block_size, dim=-1), final_clock)


def _device_of(device, *vs):
    if device is None:
        for v in vs:
            if isinstance(v, torch.Tensor):
                return v.device
    return device


def oscillator_plain(mode: str, amplitude, frequency, T: int, clock0=0.0,
                     block_size: int = 128, sample_rate: int = 48_000,
                     device=None):
    """Render T samples in PyTorch ops: the oscillator kernel's plain
    version.  amplitude/frequency scalar or [..., T] (modulated).  Returns
    (y [..., T] f32, final_clock)."""
    device = _device_of(device, amplitude, frequency, clock0)
    amp = on_device(amplitude, device)
    if mode == "Constant":
        # do_const copies the (possibly modulated) amplitude buffer verbatim
        # (signal_gen.rs:106-108)
        return (amp * torch.ones((T,), dtype=_F32, device=device),
                on_device(clock0, device))
    totals, clocks, final_clock = _block_totals(frequency, T, block_size,
                                                sample_rate, clock0, device)
    phase = clocks + totals
    if mode == "Sine":
        arg = phase * TAU
        if get_policy().name == "fast":
            y = torch.sin(arg) * amp
        else:
            # the oracle's <=1-ulp convention: f64 sin of the f32 argument,
            # range-reduced, rounded once (a chorus-rate modulation target
            # amplifies a native f32 sin's ulp past the -90 dBFS budget)
            a64 = arg.to(torch.float64)
            a64 = a64 - (2.0 * np.pi) * torch.round(a64 / (2.0 * np.pi))
            y = torch.sin(a64).to(_F32) * amp
    elif mode == "Triangle":
        y = (2.0 * torch.remainder(phase, 1.0) - 1.0) * amp
    elif mode == "Square":
        # reference bug kept: compares the intra-block total only
        y = torch.where(totals > 0.5, 1.0, -1.0).to(_F32) * amp
    else:
        raise ValueError(mode)
    return y, final_clock


# -- the adjoint --------------------------------------------------------------
# The reverse kernel's float64 sums, each from +0.0, in one fixed order
# that the plain adjoint takes too: a 128-sample block as its lanes' sums
# (lane L: samples 4L .. 4L + 3 in order) added by the warp's xor tree
# (lane i takes lane i + o for o = 16, 8, 4, 2, 1); a sum of items over
# one CTA of SUM_THREADS threads as thread t's items t, t + SUM_THREADS,
# ... in order (each item's values in order), then each warp's xor tree,
# then the warps in order.

#: the threads of the reverse kernel's summing CTA (its pass B)
SUM_THREADS = 1024
_F64 = torch.float64


def _cta_sum64(items):
    """The one CTA's sum of ``items`` [n, m] f64 (n items of m values, each
    in order): thread t's items t, t + SUM_THREADS, ..., then the warps'
    trees, then the warps in order; a 0-d f64 tensor."""
    n, m = items.shape
    pad = -n % SUM_THREADS
    if pad:
        items = torch.cat([items, items.new_zeros((pad, m))])
    items = items.reshape(-1, SUM_THREADS, m)
    tp = items.new_zeros(SUM_THREADS)
    for r in range(items.shape[0]):
        for i in range(m):
            tp = tp + items[r, :, i]
    warps = tree64(tp.reshape(SUM_THREADS // 32, 32))
    s = warps.new_zeros(())
    for w in range(warps.shape[0]):
        s = s + warps[w]
    return s


def _rows_sum64(p):
    """[rows, ...] f32 summed over the rows in order from +0.0, rounded
    once."""
    s = torch.zeros(p.shape[1:], dtype=_F64, device=p.device)
    for r in range(p.shape[0]):
        s = s + p[r].to(_F64)
    return s.to(_F32)


def oscillator_adjoint(mode: str, amplitude, frequency, T: int, clock0,
                       ct_y, ct_clock, need=(True, True, True),
                       block_size: int = 128, sample_rate: int = 48_000,
                       device=None):
    """The reverse oscillator kernel's plain version: (g_amp, g_freq,
    g_clock0), the vjp of :func:`oscillator_plain` with the cotangents
    ``ct_y`` (of the wave, or None) and ``ct_clock`` (of the final clock,
    or None), in PyTorch ops by autograd's formulas, under the current
    policy.  A gradient is shaped as its operand; None where ``need``
    says no or where no cotangent reaches the operand (Square's wave
    and Constant reach no frequency, Square's wave no clock), as
    autograd leaves it.

    With phase = clock + total: the amplitude's gradient is ct * wave;
    the phase's ((ct amp) cos(arg)) TAU (fast), f32(f64(ct amp)
    cos(a64) + 0) TAU (parity, exact: the round's zero gradient added),
    2 (ct amp) (Triangle); each block's clock gradient the sum of the
    phase's over the block; the clock carry walked backwards (fast: a
    reverse cumulative f64 sum of the clocks' gradients, the final
    clock's cotangent first; parity, exact: g = g_clock[k] + g in f32),
    its value after block k the gradient of block k's sum bs[k]; a step's
    gradient the f32 chain from the block's end, g_step[127] = g_phase +
    g_bs, g_step[i] = g_phase[i] + g_step[i + 1]; the frequency's
    g_step / sample_rate (a slider's: the sum, then one divide); clock0's
    the carry's total.  Every sum that autograd takes in f32 over
    samples, blocks or rows is float64 here, in the reverse kernel's
    fixed order where the operands' shapes are its own (block_sums64,
    _cta_sum64, _rows_sum64), rounded once.  Nothing on the card's path
    calls it."""
    device = _device_of(device, amplitude, frequency, clock0)
    amp, freq, c0 = (on_device(v, device) for v in (amplitude, frequency,
                                                   clock0))
    need_a, need_f, need_c = (bool(n) for n in need)
    if T % block_size:
        raise ValueError(f"T={T} must be a multiple of {block_size}")
    nb = T // block_size
    if mode == "Constant":
        w = torch.ones((T,), dtype=_F32, device=device)
        batch, phase_of = (), None
    else:
        totals, clocks, _ = _block_totals(frequency, T, block_size,
                                          sample_rate, clock0, device)
        batch = tuple(totals.shape[:-1])
        phase = clocks + totals
        if mode == "Sine":
            arg = phase * TAU
            if get_policy().name == "fast":
                w = torch.sin(arg)
                phase_of = lambda gw: (gw * torch.cos(arg)) * TAU  # noqa
            else:
                a64 = arg.to(_F64)
                a64 = a64 - (2.0 * np.pi) * torch.round(a64 / (2.0 * np.pi))
                w = torch.sin(a64).to(_F32)
                phase_of = lambda gw: (  # noqa: E731
                    (gw.to(_F64) * torch.cos(a64)) + 0.0).to(_F32) * TAU
        elif mode == "Triangle":
            w = 2.0 * torch.remainder(phase, 1.0) - 1.0
            phase_of = lambda gw: gw * 2.0  # noqa: E731
        elif mode == "Square":
            w = torch.where(totals > 0.5, 1.0, -1.0).to(_F32)
            phase_of = None
        else:
            raise ValueError(mode)
    g_amp = g_phase = None
    if ct_y is not None:
        if need_a:
            prod = ct_y * w
            if amp.numel() == 1:
                # a slider: each (clock row, block)'s partial, then the CTA
                part = block_sums64(prod.reshape(-1, T), block_size)
                g_amp = _cta_sum64(part.reshape(-1, 1)).to(_F32).reshape(
                    amp.shape)
            else:
                g_amp = sum_to64(prod, amp.shape)
        if phase_of is not None and (need_f or need_c):
            prod = ct_y * amp
            if tuple(prod.shape) == tuple(w.shape):
                g_w = prod
            elif w.dim() == 1:
                # one clock row under a batched amplitude: its rows in order
                g_w = _rows_sum64(prod.reshape(-1, T))
            else:
                g_w = sum_to64(prod, w.shape)
            g_phase = phase_of(g_w)
    if mode == "Constant":
        g_c0 = ct_clock if need_c and ct_clock is not None else None
        return g_amp, None, g_c0
    if g_phase is None and ct_clock is None:
        return g_amp, None, None
    # each block's clock gradient, and the carry walked backwards
    zeros = torch.zeros((*batch, nb), dtype=_F32, device=device)
    g_clk = (zeros if g_phase is None
             else block_sums64(g_phase, block_size).to(_F32))
    ctc = (torch.zeros(batch, dtype=_F32, device=device) if ct_clock is None
           else ct_clock.reshape(batch))
    if get_policy().name == "fast":
        g_cl = torch.cat([g_clk.to(_F64), ctc.to(_F64)[..., None]], dim=-1)
        rev = torch.flip(torch.cumsum(torch.flip(g_cl, (-1,)), dim=-1),
                         (-1,))
        g_bs = rev[..., 1:].to(_F32)
        g_c0b = rev[..., 0].to(_F32)
    else:
        g, outs = ctc, [None] * nb
        for k in range(nb - 1, -1, -1):
            outs[k] = g
            g = g_clk[..., k] + g
        g_bs = torch.stack(outs, dim=-1)
        g_c0b = g
    g_freq = g_c0 = None
    if need_f:
        gp = (zeros[..., None].expand(*batch, nb, block_size)
              if g_phase is None else g_phase.reshape(*batch, nb,
                                                      block_size))
        acc, steps = g_bs, [None] * block_size
        for i in range(block_size - 1, -1, -1):
            acc = gp[..., i] + acc
            steps[i] = acc
        g_step = torch.stack(steps, dim=-1)              # [..., nb, 128]
        sr = scalar_on(float(sample_rate), device)
        if freq.numel() == 1:
            tot = _cta_sum64(g_step.flip(-1).reshape(-1, block_size)
                             .to(_F64))
            g_freq = (tot.to(_F32) / sr).reshape(freq.shape)
        else:
            g_step = g_step.reshape(*batch, T)
            g_freq = (g_step / sr if tuple(freq.shape) == tuple(g_step.shape)
                      else sum_to64(g_step, freq.shape) / sr)
    if need_c:
        if tuple(c0.shape) == batch:
            g_c0 = g_c0b
        elif c0.numel() == 1:
            g_c0 = _rows_sum64(g_c0b.reshape(-1)).reshape(c0.shape)
        else:
            g_c0 = sum_to64(g_c0b, c0.shape)
    return g_amp, g_freq, g_c0


class Oscillator(torch.autograd.Function):
    """The signal generator on the card under autograd: ``apply(forward,
    backward, mode, T, policy name, sample_rate, amp, freq, clock0)`` runs
    ``forward(mode, amp, freq, T, clock0)`` once (the kernel; a test
    passes a model of it), which returns (wave, final clock) and may add
    a third item it keeps for the backward (the kernel's block clocks),
    and saves the operands; the backward runs ``backward(mode, amp,
    freq, T, clock0, ct_y, ct_clock, need, kept, sample_rate)`` under the
    forward's policy (the reverse kernel on the card,
    ops/oscillator_reverse_kernel.oscillator_reverse_cuda; a test passes
    :func:`oscillator_adjoint`).  Where ``backward`` is None it is
    autograd through :func:`oscillator_plain`, recomputed from the
    operands: the route the reverse kernel replaced, kept as its
    reference."""

    @staticmethod
    def forward(ctx, forward, backward, mode, T, pol, sample_rate, amp,
                freq, clock0):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.T, ctx.pol, ctx.sr = mode, T, pol, sample_rate
        ctx.backward_fn = backward
        ctx.save_for_backward(amp, freq, clock0)
        with torch.no_grad():
            outs = forward(mode, amp, freq, T, clock0)
        ctx.kept = outs[2] if len(outs) > 2 else None
        return fresh(tuple(outs[:2]), (amp, freq, clock0))

    @staticmethod
    def backward(ctx, ct_y, ct_clock):
        need = ctx.needs_input_grad[6:]
        if ctx.backward_fn is not None:
            with policy(ctx.pol):
                grads = ctx.backward_fn(ctx.mode, *ctx.saved_tensors[:2],
                                        ctx.T, ctx.saved_tensors[2], ct_y,
                                        ct_clock, need, ctx.kept, ctx.sr)
            return (None,) * 6 + tuple(g if n else None
                                       for g, n in zip(grads, need))
        ops = [t.detach().requires_grad_(True) if n else t.detach()
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), policy(ctx.pol):
            outs = oscillator_plain(ctx.mode, *ops[:2], ctx.T, ops[2],
                                    sample_rate=ctx.sr,
                                    device=ops[0].device)
            pairs = [(o, c) for o, c in zip(outs, (ct_y, ct_clock))
                     if c is not None and o.requires_grad]
            want = [t for t, n in zip(ops, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [c for _, c in pairs],
                allow_unused=True) if pairs and want else [None] * len(want))
        # an operand the outputs do not depend on gets None, as autograd
        # through the plain version leaves it
        return (None,) * 6 + tuple(next(got) if n else None for n in need)


def adjoint_backward(mode, amp, freq, T, clock0, ct_y, ct_clock, need,
                     kept, sample_rate):
    """:func:`oscillator_adjoint` as :class:`Oscillator`'s backward (the
    CPU tests' stand-in for the reverse kernel)."""
    return oscillator_adjoint(mode, amp, freq, T, clock0, ct_y, ct_clock,
                              need, sample_rate=sample_rate,
                              device=amp.device)


def run(forward, mode: str, amp, freq, T: int, clock0, sample_rate=48_000,
        backward=None):
    """``forward(mode, amp, freq, T, clock0)`` (its first two items),
    through :class:`Oscillator` when autograd must see it (the card's
    dispatch; a test passes a model of the kernel) with ``backward`` as
    its backward (autograd through :func:`oscillator_plain` where
    None)."""
    if not needs_grad((amp, freq, clock0)):
        return tuple(forward(mode, amp, freq, T, clock0)[:2])
    return Oscillator.apply(forward, backward, mode, T, get_policy().name,
                            sample_rate, amp, freq, clock0)


def oscillator(mode: str, amplitude, frequency, T: int, clock0=0.0,
               block_size: int = 128, sample_rate: int = 48_000,
               device=None):
    """Render T samples: the oscillator kernel for a CUDA device (its
    backward the reverse oscillator kernel), the plain
    :func:`oscillator_plain` on the CPU.  amplitude/frequency scalar or
    [..., T] (modulated); ``device`` defaults to the first tensor's.
    Returns (y [..., T] f32, final_clock)."""
    device = _device_of(device, amplitude, frequency, clock0)
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cpu":
        return oscillator_plain(mode, amplitude, frequency, T, clock0,
                                block_size, sample_rate, dev)
    if dev.type != "cuda":
        raise ValueError(f"oscillator: no kernel for device {dev}")
    if block_size != oscillator_kernel.BLOCK:
        raise ValueError(f"oscillator kernel: block_size {block_size}, the "
                         f"kernel's is {oscillator_kernel.BLOCK}")
    from dsp_stuff_tpu_torch.ops import oscillator_reverse_kernel
    amp, freq, c0 = (on_device(v, dev) for v in (amplitude, frequency,
                                                 clock0))
    exact = get_policy().name != "fast"
    return run(lambda m, a, f, n, c: oscillator_kernel.oscillator_cuda(
        m, a, f, n, c, exact, float(sample_rate)), mode,
        amp, freq, T, c0, sample_rate,
        oscillator_reverse_kernel.oscillator_reverse_cuda)
