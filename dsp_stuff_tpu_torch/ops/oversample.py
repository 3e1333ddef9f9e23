"""Polyphase oversampling wrappers for waveshapers (BASELINE config #3).

Nonlinear shapers generate harmonics above Nyquist that alias back down;
running them at R-times rate with band-limiting FIRs on both sides
suppresses that.  The reference has no oversampling (its Distort node
aliases); this is the JAX package's extension, kept as it is:

    up:   y[R*t + p] = sum_k h[R*k + p] * x[t - k]      (polyphase)
    down: z[t]       = sum_k h[k] * y[R*t - k]          (strided FIR)

h is a Hann-windowed sinc low-pass at pi/R, length TAPS*R+1, gain R on the
upsampling side (to preserve amplitude through zero-stuffing).

Both converters are banded block-Toeplitz matrix products: 128 base-rate
samples per block, the overlapping input window against a static tap
matrix (window = block + 8 base-rate samples of halo each side, the
kernel's group delay):

    up:   Y[..., M, 128R] = Xw[..., M, 144]  @ Mu[144, 128R]
    down: Z[..., M, 128]  = Yw[..., M, 144R] @ Md[144R, 128]

The JAX package computes these with ``jnp.einsum`` at HIGHEST precision;
here they are ``torch.matmul`` in full float32 (TF32 is off,
utils/precision.py).  The tap matrices are built once in NumPy and go to
each device once.  The converters keep no state: every call pads its
window with zeros, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops.pointwise_kernel import shaper_call
from dsp_stuff_tpu_torch.utils.capture import device_cache

TAPS_PER_PHASE = 16

_BLK = 128      # base-rate samples per matmul block
_HALO = 8       # base-rate halo each side = (N-1)/2 / R group delay


@functools.lru_cache(maxsize=None)
def _lowpass_kernel(R: int, taps_per_phase: int = TAPS_PER_PHASE):
    """Hann-windowed sinc low-pass at cutoff pi/R, f32.

    Odd length (R*taps_per_phase + 1) so the group delay (N-1)/2 is an
    integer sample at the oversampled rate."""
    N = R * taps_per_phase + 1
    n = np.arange(N, dtype=np.float64) - (N - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.where(np.abs(n) < 1e-12, 1.0 / R,
                     np.sin(np.pi * n / R) / (np.pi * n))
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N) / (N - 1))
    h = h * w
    h /= h.sum() * 1.0          # unity DC gain at the base rate
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _up_matrix(R: int):
    """Mu[144, 128R]: Mu[j, R*tau+p] = R*h[R*(tau+16-j)+p] for
    0 <= tau+16-j <= 16 (zero outside the kernel's 17 base-rate taps)."""
    h = np.zeros((TAPS_PER_PHASE + 1) * R + R, np.float64)
    h[:TAPS_PER_PHASE * R + 1] = _lowpass_kernel(R).astype(np.float64) * R
    W = _BLK + 2 * _HALO
    Mu = np.zeros((W, _BLK * R), np.float64)
    for u in range(_BLK * R):
        tau, p = divmod(u, R)
        for i in range(TAPS_PER_PHASE + 1):
            idx = R * i + p
            if idx <= TAPS_PER_PHASE * R:
                Mu[tau + 2 * _HALO - i, u] = h[idx]
    return Mu.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _down_matrix(R: int):
    """Md[144R, 128]: Md[j, tau] = h[R*tau + 16R - j] for
    0 <= R*tau+16R-j <= 16R."""
    h = _lowpass_kernel(R).astype(np.float64)
    N = h.shape[0]                      # 16R + 1
    W = (_BLK + 2 * _HALO) * R
    Md = np.zeros((W, _BLK), np.float64)
    for tau in range(_BLK):
        for j in range(R * tau, R * tau + N):       # idx = R*tau+16R-j in h
            Md[j, tau] = h[R * tau + 2 * _HALO * R - j]
    return Md.astype(np.float32)


@device_cache(maxsize=None)
def _matrix_on(kind: str, R: int, device: torch.device) -> torch.Tensor:
    """The tap matrix ``kind`` ("up" or "down") of rate R on ``device``,
    copied there once."""
    m = _up_matrix(R) if kind == "up" else _down_matrix(R)
    return torch.as_tensor(m, device=device)


def _windows(x: torch.Tensor, blk: int, halo: int):
    """Overlapping block windows along the last axis: W[..., m, j] =
    xpad[..., blk*m + j], j < blk + 2*halo, with xpad = halo zeros | x |
    (halo + block-padding) zeros.  Two contiguous reshapes and a concat,
    no gather."""
    T = x.shape[-1]
    M = -(-T // blk)
    xp = F.pad(x, (halo, M * blk - T + halo + blk))
    Tp = M * blk
    lead = x.shape[:-1]
    W1 = xp[..., :Tp].reshape(*lead, M, blk)
    W2 = xp[..., blk:blk + Tp].reshape(*lead, M, blk)[..., :2 * halo]
    return torch.cat([W1, W2], dim=-1), M


def upsample(x: torch.Tensor, R: int) -> torch.Tensor:
    """[..., T] -> [..., R*T]: zero-stuff + low-pass (gain-compensated), as
    one blocked matrix product."""
    x = torch.as_tensor(x, dtype=torch.float32)
    T = x.shape[-1]
    Xw, M = _windows(x, _BLK, _HALO)                       # [..., M, 144]
    Y = torch.matmul(Xw, _matrix_on("up", R, x.device))
    return Y.reshape(*x.shape[:-1], M * _BLK * R)[..., :R * T]


def downsample(x: torch.Tensor, R: int) -> torch.Tensor:
    """[..., R*T] -> [..., T]: low-pass + decimate, as one blocked matrix
    product."""
    x = torch.as_tensor(x, dtype=torch.float32)
    Tu = x.shape[-1]
    T = -(-Tu // R)
    Yw, M = _windows(x, _BLK * R, _HALO * R)               # [..., M, 144R]
    Z = torch.matmul(Yw, _matrix_on("down", R, x.device))
    return Z.reshape(*x.shape[:-1], M * _BLK)[..., :T]


def oversampled(fn, x: torch.Tensor, R: int, *args):
    """Run the elementwise shaper ``fn(x, *args)`` at R-times rate.

    R == 1 is a passthrough.  Scalars in args broadcast; per-sample
    modulation tensors (last dimension x's length) are upsampled beside
    the signal.  At R > 1 the shaper pass over the upsampled signal is a
    one-node pointwise group (ops/pointwise_kernel.shaper_call: one
    kernel launch on the card, the eager ops' plain version on the
    CPU)."""
    if R == 1:
        return fn(x, *args)
    xu = upsample(x, R)
    up_args = tuple(
        upsample(a, R) if (isinstance(a, torch.Tensor) and a.dim() > 0
                           and a.shape[-1] == x.shape[-1]) else a
        for a in args)
    return downsample(shaper_call(fn, xu, *up_args), R)
