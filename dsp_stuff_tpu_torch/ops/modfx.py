"""Modulated fractional-delay effects (the chorus / flanger / vibrato core).

An extension beyond the reference's nodes (BASELINE.json config #2 calls
for "ring-buffer delay lines with modulated fractional taps"):

    d[t]   = base + depth * sin(2*pi*rate*t/sr)            (samples)
    pos[t] = t - d[t]
    y[t]   = lerp(x[floor(pos)], x[floor(pos)+1], frac)    (linear interp)

with the history prefix carried as state so segments chain.  The LFO is
closed-form in absolute time, so the tap trajectory of a whole render is
computed at once and applied as one gather.

The fused form (the chain segment's ``mtap`` stage) takes the trajectory
as three shared operands from :func:`mtap_shared`: a per-block window
start q, a per-sample residual r and the interpolation weight frac.  The
indices and weights are those of :func:`_tap_trajectory`, so the fused
and the per-node chorus tap the same samples.  The JAX package's barrel
lowering (``_barrel_plan``/``_barrel_taps``) was a workaround for
per-element gathers on the TPU and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops.lockstep import advance, counter
from dsp_stuff_tpu_torch.utils.precision import on_device, scalar_on


TAU = 2.0 * np.pi
C = 128                  # samples per block of the mtap decomposition
_MTAP_S = 8              # the JAX package's window alignment (EV gate)
_MTAP_MAX_E = 16         # residual range cap (fast and deep LFOs refuse)
_F32 = torch.float32
_F64 = torch.float64


def max_delay_samples(base_s: float, depth_s: float,
                      sample_rate: int = 48_000) -> int:
    """Static history length of a chorus line (structural param)."""
    return int(np.ceil((base_s + depth_s) * sample_rate)) + 2


def _tap_trajectory(rate_hz, depth_s, base_s, L: int, T: int, t0,
                    sample_rate: int = 48_000, device=None):
    """(i, frac) of the fractional tap into ``xx = [hist(L), x(T)]``
    coordinates: i int64 (clipped to [0, L+T-2]), frac f32.  ``rate_hz``
    is a scalar or a per-sample [..., T] tensor (modulated); ``t0`` the
    absolute sample index of the render's first sample, a lockstep
    counter shared by every stream (ops/lockstep.py).

    The LFO phase is in f64 cycles, reduced mod 1 before the f32 sin, so
    it stays exact for arbitrarily long streams.  The sin of the f32
    argument is taken in f64 and rounded once under every policy: the
    JAX package does so under ``parity`` only (a native f32 sin's ulp,
    scaled by depth*sr and the signal slope, costs about -92 dBFS per
    chorus), but here it costs nothing next to the render, matches the
    oracle's convention and gives the same trajectory on every device
    (CPU and CUDA f32 sins differ in the last bit).  The tap position is
    f64, so offline and segmented renders tap bit-identically."""
    if isinstance(rate_hz, torch.Tensor):
        device = rate_hz.device
        rate = rate_hz.to(_F64)
    else:
        # a Python float is not rounded to f32: the rate is f64 here (a
        # stream's slider, a Data, holds the same double)
        rate = on_device(rate_hz, device, _F64)
    t_abs = counter(t0) + torch.arange(T, dtype=_F64, device=device)
    cycles = rate * t_abs / scalar_on(float(sample_rate), device, _F64)
    phase = (cycles - torch.floor(cycles)).to(_F32)
    arg = float(np.float32(TAU)) * phase
    s = torch.sin(arg.to(_F64)).to(_F32)
    base = float(np.float32(np.float32(base_s) * np.float32(sample_rate)))
    depth = float(np.float32(np.float32(depth_s) * np.float32(sample_rate)))
    d = base + depth * s
    pos = (L + torch.arange(T, dtype=_F64, device=device)) - d.to(_F64)
    pos = torch.clamp(pos, 0.0, float(L + T - 2))
    fl = torch.floor(pos)
    return fl.to(torch.int64), (pos - fl).to(_F32)


def _mix(x, wet, mix):
    """y = x*(1-mix) + wet*mix with (1-mix) rounded in f32."""
    mix = on_device(mix, x.device)
    return x * (1.0 - mix) + wet * mix


def modulated_delay(x, rate_hz, depth_s, base_s, mix, hist, t0,
                    sample_rate: int = 48_000):
    """Sine-modulated fractional delay along the last axis.

    x     -- [..., T] dry signal
    hist  -- [..., L] previous inputs (newest last; L = max_delay_samples)
    t0    -- absolute sample index of x[..., 0] (a lockstep counter,
             ops/lockstep.py)
    Returns (y [..., T], new_hist, new_t0)."""
    x = torch.as_tensor(x, dtype=_F32)
    T = x.shape[-1]
    hist = torch.as_tensor(hist, dtype=_F32, device=x.device)
    L = hist.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], hist.shape[:-1])
    xx = torch.cat([hist.expand(*batch, L), x.expand(*batch, T)], dim=-1)
    i, frac = _tap_trajectory(rate_hz, depth_s, base_s, L, T, t0,
                              sample_rate, x.device)
    if i.dim() == 1:
        # shared trajectory (scalar LFO params): one index per sample
        a, b = xx[..., i], xx[..., i + 1]
    else:
        # per-stream trajectories (a modulated rate)
        full = torch.broadcast_shapes(batch, i.shape[:-1])
        xx = xx.expand(*full, L + T)
        ib = i.expand(*full, T)
        a = torch.gather(xx, -1, ib)
        b = torch.gather(xx, -1, ib + 1)
    wet = a * (1.0 - frac) + b * frac
    return _mix(x, wet, mix), xx[..., -L:], advance(t0, T)


def mtap_static(rate_hz: float, depth_s: float, base_s: float, L: int,
                sample_rate: int = 48_000):
    """Static mtap geometry for concrete LFO params, or None when the
    stage does not lower: (NH, EV, RS) with NH = history blocks (the
    ring has NH+1 slots), EV the per-block trajectory variation bound and
    RS the TPU kernel's window width.  The gates are the JAX package's
    (the planners must agree): the minimum delay keeps the window inside
    written ring blocks (dmin >= RS - 128 + 2) and EV stays small."""
    rate = abs(float(rate_hz))
    depth = float(depth_s) * sample_rate
    base = float(base_s) * sample_rate
    dmin = base - depth
    EV = int(np.ceil(depth * 2.0 * np.pi * rate * C / sample_rate)) + 2
    if EV > _MTAP_S + _MTAP_MAX_E:
        return None
    RS = C + (-(-(EV + 1) // _MTAP_S)) * _MTAP_S
    if dmin < RS - C + 2.0:
        return None
    NH = -(-L // C)
    return NH, EV, RS


def mtap_shared(rate_hz, depth_s, base_s, L: int, T: int, t0,
                sample_rate: int = 48_000, device=None):
    """Shared (stream-independent) trajectory operands of one render:
    (q [T//128] int32, r [T] int32, frac [T] f32) on ``device``.

    u[t] = i[t] - L + NH*128 - t is the tap's offset into the
    (NH+1)-block window that ends with the current block; q_b is the
    minimum of u over block b and r = u - q_b[t // 128], so the tap of
    sample t reads window index q_b + r[t] + t of [zeros, hist, x]."""
    if T % C:
        raise ValueError(f"mtap_shared: T={T} must be a multiple of {C}")
    i, frac = _tap_trajectory(rate_hz, depth_s, base_s, L, T, t0,
                              sample_rate, device)
    NH = -(-L // C)
    u = i - L + NH * C - torch.arange(T, dtype=torch.int64, device=i.device)
    u2 = u.reshape(T // C, C)
    q = u2.min(dim=1).values
    r = (u2 - q[:, None]).reshape(T)
    return q.to(torch.int32), r.to(torch.int32), frac


def mtap_apply(x, hist, q, r, frac, mix):
    """The mtap stage by gather: the plain PyTorch version of the chain
    kernel's mtap stage.  Returns (y, new_hist)."""
    x = torch.as_tensor(x, dtype=_F32)
    T = x.shape[-1]
    hist = torch.as_tensor(hist, dtype=_F32, device=x.device)
    L = hist.shape[-1]
    NH = -(-L // C)
    batch = torch.broadcast_shapes(x.shape[:-1], hist.shape[:-1])
    xxp = torch.cat([torch.zeros((*batch, NH * C - L), dtype=_F32,
                                 device=x.device),
                     hist.expand(*batch, L), x.expand(*batch, T)], dim=-1)
    idx = (torch.repeat_interleave(q.to(torch.int64), C) + r.to(torch.int64)
           + torch.arange(T, dtype=torch.int64, device=x.device))
    wet = xxp[..., idx] * (1.0 - frac) + xxp[..., idx + 1] * frac
    return _mix(x, wet, mix), xxp[..., -L:]
