"""16-tap windowed-sinc resampler as a tensor op, on any device.

The reference's output path resamples 48 kHz -> device rate with a sinc-16
interpolator on the host audio thread (devices.rs:550-556).  Here each
output sample is the dot product of 16 taps with a gathered input window,
so the whole resample is one gather and one [n_out, 16] contraction, with
no loop over time: the JAX package's ops/resample.py.

The taps are the Hann-windowed sinc of io/resample.py (f64, rounded to
f32 here, as the JAX op does); the host paths (io/resample.py, the host
library) accumulate in f64, so this op agrees with them to a few f32 ulps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.io.resample import HALF, sinc16_taps
from dsp_stuff_tpu_torch.utils.capture import device_cache


@functools.lru_cache(maxsize=16)
def _tap_matrix(T: int, n_out: int, ratio: float):
    """(indices [n_out, 16] int64 clipped to [0, T), their validity,
    taps [n_out, 16] f32)."""
    t = np.arange(n_out, dtype=np.float64) / ratio
    i0 = np.floor(t).astype(np.int64)
    taps = sinc16_taps(t - i0, ratio).astype(np.float32)
    idx = i0[:, None] + np.arange(-HALF + 1, HALF + 1, dtype=np.int64)[None]
    return np.clip(idx, 0, T - 1), (idx >= 0) & (idx < T), taps


@device_cache(maxsize=16)
def _tap_tensors(T: int, n_out: int, ratio: float, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _tap_matrix(T, n_out, ratio))


def resample_sinc16(x, ratio: float) -> torch.Tensor:
    """Resample the last axis by out/in ``ratio``.

    x -- [..., T] f32 tensor (or array: a CPU tensor is made of it).
    Returns [..., floor(T*ratio)] f32 on x's device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    T = x.shape[-1]
    n_out = int(np.floor(T * ratio))
    if n_out == 0 or T == 0:
        return x.new_zeros((*x.shape[:-1], n_out))
    idx, valid, taps = _tap_tensors(T, n_out, float(ratio), x.device)
    gathered = torch.where(valid, x[..., idx], 0.0)    # [..., n_out, 16]
    return (gathered * taps).sum(dim=-1)
