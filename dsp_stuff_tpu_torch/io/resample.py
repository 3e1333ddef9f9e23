"""The 16-tap windowed-sinc resampler, in NumPy.

Mirrors native/dsp_host.cpp:dsp_resample_sinc16 exactly (f64 taps and
accumulation, f32 output), as the JAX package's io/resample.py does.
"""

from __future__ import annotations

import numpy as np

HALF = 8


def sinc16_taps(frac, ratio: float):
    """Hann-windowed sinc tap matrix [len(frac), 16] (f64) for fractional
    offsets ``frac`` in [0, 1)."""
    frac = np.asarray(frac, np.float64)
    m = np.arange(-HALF + 1, HALF + 1, dtype=np.float64)
    xg = m[None, :] - frac[:, None]
    fc = min(ratio, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(np.abs(xg) < 1e-12, 1.0,
                        np.sin(np.pi * fc * xg) / (np.pi * fc * xg))
    w = np.where(np.abs(xg) <= HALF,
                 0.5 * (1.0 + np.cos(np.pi * xg / HALF)), 0.0)
    return fc * sinc * w


def resample_sinc16(x, ratio: float) -> np.ndarray:
    """x [T] f32 resampled by ``ratio`` (output rate / input rate) to
    floor(T * ratio) samples."""
    x = np.asarray(x, np.float32)
    T = x.size
    n_out = int(np.floor(T * ratio))
    k = np.arange(n_out, dtype=np.float64)
    t = k / ratio
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    m = np.arange(-HALF + 1, HALF + 1, dtype=np.float64)
    taps = sinc16_taps(frac, ratio)
    idx = i0[:, None] + m[None, :].astype(np.int64)
    valid = (idx >= 0) & (idx < T)
    gathered = np.where(valid, x[np.clip(idx, 0, T - 1)].astype(np.float64),
                        0.0)
    return (gathered * taps).sum(axis=1).astype(np.float32)
