"""Elementwise waveshapers.

Each function reproduces one of the reference's per-sample shaper loops as
an elementwise torch op over ``[..., T]`` f32 tensors.  ``level`` (and
friends) may be scalars or per-sample tensors (audio-rate modulation via
``as_input`` sliders).

Semantics sources (reference dsp-stuff/src/nodes/):
    distort.rs   -- 9 shaper modes (distort.rs:18-28, dispatch 184-194)
    overdrive.rs -- atan overdrive (overdrive.rs:31-43)
    chebyshev.rs -- asymmetric tanh shaper (chebyshev.rs:28-42)

Every mode bypasses (returns the input sample) when ``level < 0.001``
(e.g. distort.rs:60-66); with modulated level this is a per-sample choice.
Eager torch rounds once per op, so each expression keeps the reference's
operation order without the JAX package's FMA fences.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.precision import (get_policy, on_device,
                                                  scalar_on)

_F32 = torch.float32
BYPASS_EPS = float(np.float32(0.001))


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or tensor parameter as an f32 tensor on ``like``'s device."""
    return on_device(v, like.device)


def _trans(fn, v):
    """Transcendental with policy-dependent internals: native f32 under
    ``fast``; evaluated in f64 and rounded once under ``parity`` (within
    ~1 ulp of the reference's libm)."""
    if get_policy().name == "fast":
        return fn(v)
    return fn(v.to(torch.float64)).to(_F32)


def _bypass(level, shaped, x):
    return torch.where(level < BYPASS_EPS, x, shaped)


def _safe_level(level):
    """Denominator-safe level: 1 in the bypass region, whose shaped value
    the bypass discards anyway."""
    return torch.where(level < BYPASS_EPS, torch.ones_like(level), level)


def _tanh(v):
    """tanh with the argument clamped to |v| <= 20 (tanh rounds to f32 1.0
    past ~9.6, so the clamp is invisible in the result).  NaN propagates
    through the clamp."""
    return _trans(torch.tanh, torch.clamp(v, -20.0, 20.0))


def clip(x):
    """clip to [-1, 1] (distort.rs:53-61)."""
    return torch.clamp(x, -1.0, 1.0)


def hard_clip(x, level):
    """clip(x*level)/level (distort.rs:63-69)."""
    level = _t(level, x)
    return _bypass(level, clip(x * level) / _safe_level(level), x)


def soft_clip(x, level):
    """Cubic soft clip: v - v^3/3 inside [-1,1], +/-2/3 outside
    (distort.rs:71-86).  (v*v)*v matches Rust powi(3); NaN takes the -2/3
    arm like the reference's if/else chain (distort.rs:77-83)."""
    level = _t(level, x)
    v = x * level
    inner = v - (v * v) * v / scalar_on(3.0, v.device)
    two3 = scalar_on(float(np.float32(2.0 / 3.0)), x.device)
    shaped = torch.where(v > 1.0, two3,
                         torch.where((v >= -1.0) & (v <= 1.0), inner, -two3))
    return _bypass(level, clip(shaped) / _safe_level(level), x)


def tanh_clip(x, level):
    """(x*level).tanh() (distort.rs:104-110)."""
    level = _t(level, x)
    return _bypass(level, _tanh(x * level), x)


def recip_soft_clip(x, level):
    """sign(x) * (1 - 1/(|x|*level + 1)) (distort.rs:96-102)."""
    level = _t(level, x)
    shaped = torch.sign(x) * (1.0 - 1.0 / (torch.abs(x) * level + 1.0))
    return _bypass(level, shaped, x)


def sin_shape(x, level):
    """(x*level).sin() (distort.rs:112-118)."""
    level = _t(level, x)
    return _bypass(level, _trans(torch.sin, x * level), x)


def atan_shape(x, level):
    """(x*level).atan() (distort.rs:120-126)."""
    level = _t(level, x)
    return _bypass(level, _trans(torch.atan, x * level), x)


def square_shape(x, level):
    """(x*level)^2 * sign(x*level) (distort.rs:128-134)."""
    level = _t(level, x)
    v = x * level
    return _bypass(level, v * v * torch.sign(v), x)


def chebyshev4(x, level):
    """8v^4 - 8v^2 + 1 with v = x*level (distort.rs:136-144).  Emits DC +1
    at silence -- reference quirk, kept."""
    level = _t(level, x)
    v = x * level
    v2 = v * v
    v4 = v2 * v2          # Rust powi(4) squares: (v*v)*(v*v)
    return _bypass(level, 8.0 * v4 - 8.0 * v2 + 1.0, x)


def fuzz(x, level, block_size: int = 128):
    """Block-max-normalized double-exp shaper (distort.rs:146-172).

    The reference normalizes by the max |x| of each 128-sample block, so
    the output depends on block boundaries, and an all-zero block gives
    NaN (quirk kept; SURVEY.md section 2.4 #5).  T must be a multiple of
    ``block_size``.  With mx = max|x| over the block:

        q = clip(x*level) / mx
        z = -(1 - exp(-|q|))
        y = clip(z*mx) / max|z|
        out = y * mx / max|y|
    """
    level = _t(level, x)
    T = x.shape[-1]
    if T % block_size:
        raise ValueError(f"fuzz needs T % {block_size} == 0, got T={T}")
    nb = T // block_size
    xb = x.reshape(*x.shape[:-1], nb, block_size)
    lb = level.expand(x.shape).reshape(*x.shape[:-1], nb, block_size)

    mx = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    q = clip(xb * lb) / mx
    z = -(1.0 - _trans(torch.exp, -torch.abs(q)))
    mz = torch.amax(torch.abs(z), dim=-1, keepdim=True)
    y = clip(z * mx) / mz
    my = torch.amax(torch.abs(y), dim=-1, keepdim=True)
    out = y * mx / my
    return out.reshape(x.shape)


def overdrive(x, boost, drive, level):
    """drive*(2/pi)*atan(pi/4*boost*x) + (1-drive)*x, then *level
    (overdrive.rs:31-43); bypass on level < 0.001."""
    boost = _t(boost, x)
    drive = _t(drive, x)
    level = _t(level, x)
    a = x * boost
    b = float(np.float32(np.pi / 4.0)) * a
    d = float(np.float32(2.0 / np.pi)) * _trans(torch.atan, b)
    mix = drive * d + (1.0 - drive) * x
    return torch.where(level < BYPASS_EPS, x, mix * level)


def chebyshev_asym(x, level_pos, level_neg):
    """tanh(x*l)/tanh(l) with separate l for x>=0 / x<0 (chebyshev.rs:28-42);
    per-branch bypass when that branch's level < 0.001.  The level is
    selected before the signal-sized tanh: one transcendental pass."""
    lp = _t(level_pos, x)
    ln = _t(level_neg, x)
    pos_side = x >= 0.0
    l = torch.where(pos_side, lp, ln)
    den = torch.where(pos_side, _tanh(_safe_level(lp)), _tanh(_safe_level(ln)))
    return torch.where(l < BYPASS_EPS, x, _tanh(x * l) / den)


DISTORT_MODES = {
    "HardClip": hard_clip,
    "SoftClip": soft_clip,
    "Tanh": tanh_clip,
    "RecipSoftClip": recip_soft_clip,
    "Fuzz": fuzz,
    "Sin": sin_shape,
    "Atan": atan_shape,
    "Square": square_shape,
    "Chebyshev4": chebyshev4,
}
