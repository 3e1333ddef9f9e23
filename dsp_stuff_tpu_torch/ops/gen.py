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
the CPU runs.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import oscillator_kernel
from dsp_stuff_tpu_torch.ops.chain_segment import fresh
from dsp_stuff_tpu_torch.ops.scan import needs_grad
from dsp_stuff_tpu_torch.utils.precision import (get_policy, on_device,
                                                  policy, scalar_on)

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


class Oscillator(torch.autograd.Function):
    """The signal generator on the card under autograd: ``apply(forward,
    mode, T, policy name, sample_rate, amp, freq, clock0)`` runs
    ``forward(mode, amp, freq, T, clock0)`` once (the kernel; a test
    passes a model of it) and saves the operands; the backward is
    autograd through :func:`oscillator_plain`, recomputed from them under
    the forward's policy.  That is the route until the kernel's reverse
    lands, as ``pointwise_kernel.group_vjp`` was the groups' before
    theirs, not a fallback."""

    @staticmethod
    def forward(ctx, forward, mode, T, pol, sample_rate, amp, freq, clock0):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.T, ctx.pol, ctx.sr = mode, T, pol, sample_rate
        ctx.save_for_backward(amp, freq, clock0)
        with torch.no_grad():
            y, clock = forward(mode, amp, freq, T, clock0)
        return fresh((y, clock), (amp, freq, clock0))

    @staticmethod
    def backward(ctx, ct_y, ct_clock):
        need = ctx.needs_input_grad[5:]
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
        return (None,) * 5 + tuple(next(got) if n else None for n in need)


def run(forward, mode: str, amp, freq, T: int, clock0, sample_rate=48_000):
    """``forward(mode, amp, freq, T, clock0)``, through :class:`Oscillator`
    when autograd must see it (the card's dispatch; a test passes a model
    of the kernel)."""
    if not needs_grad((amp, freq, clock0)):
        return forward(mode, amp, freq, T, clock0)
    return Oscillator.apply(forward, mode, T, get_policy().name,
                            sample_rate, amp, freq, clock0)


def oscillator(mode: str, amplitude, frequency, T: int, clock0=0.0,
               block_size: int = 128, sample_rate: int = 48_000,
               device=None):
    """Render T samples: the oscillator kernel for a CUDA device (its
    backward autograd through the plain version), the plain
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
    amp, freq, c0 = (on_device(v, dev) for v in (amplitude, frequency,
                                                 clock0))
    exact = get_policy().name != "fast"
    return run(lambda m, a, f, n, c: oscillator_kernel.oscillator_cuda(
        m, a, f, n, c, exact, float(sample_rate)), mode, amp, freq, T, c0,
        sample_rate)
