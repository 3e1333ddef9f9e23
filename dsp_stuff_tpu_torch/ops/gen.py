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
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.precision import (get_policy, on_device,
                                                  scalar_on)

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


def oscillator(mode: str, amplitude, frequency, T: int, clock0=0.0,
               block_size: int = 128, sample_rate: int = 48_000,
               device=None):
    """Render T samples.  amplitude/frequency scalar or [..., T]
    (modulated).  Returns (y [..., T] f32, final_clock)."""
    if device is None:
        for v in (amplitude, frequency, clock0):
            if isinstance(v, torch.Tensor):
                device = v.device
                break
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
