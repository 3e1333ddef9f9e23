"""Spectrogram computation (batch analog of the Spectrogram node).

The reference node reads ``fft_size`` fresh samples per tick (no overlap)
and runs them through audioviz 0.6.0's spectrum ``Processor`` configured at
spectrogram.rs:236-250 (48 kHz, frequency bounds, Mixture volume
normalisation, Exponential position distribution, Cubic interpolation);
the last ``buffer_size`` columns are kept for drawing.

The pipeline is the JAX package's (dsp_stuff_tpu/ops/fftspec.py, which
documents its two approximated audioviz curves): hann window -> |rfft| /
fft_size -> bins inside the bounds -> sqrt-of-frequency volume boost ->
Catmull-Rom resampling of the exponentially positioned bins onto a
uniform display grid.  The static constants (kept bins, interpolation
matrix, grid frequencies) are NumPy, built once per shape; the per-frame
work is ``torch.fft.rfft`` and one matrix product in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.capture import device_cache
from dsp_stuff_tpu_torch.utils.precision import scalar_on


def _kept_bins(fft_size: int, lower_hz: float, upper_hz: float,
               sample_rate: int):
    """Frequencies of the rfft bins inside [lower, upper]."""
    freqs = np.fft.rfftfreq(fft_size, 1.0 / sample_rate)
    keep = np.nonzero((freqs >= lower_hz) & (freqs <= upper_hz))[0]
    return freqs, keep


def exponential_positions(n: int) -> np.ndarray:
    """Display positions of n bins under the Exponential distribution:
    p_i = sqrt(i/(n-1))."""
    if n == 1:
        return np.zeros(1, np.float64)
    i = np.arange(n, dtype=np.float64)
    return np.sqrt(i / (n - 1))


@functools.lru_cache(maxsize=64)
def _catmull_rom_matrix(n: int, k_out: int) -> np.ndarray:
    """[k_out, n] weights resampling values at exponential_positions(n)
    onto k_out uniform positions by Catmull-Rom cubic interpolation."""
    pos = exponential_positions(n)
    if n < 4 or k_out < 1:
        # degenerate: nearest neighbour
        W = np.zeros((max(k_out, 1), n), np.float32)
        u = np.linspace(0.0, 1.0, max(k_out, 1))
        j = np.searchsorted(pos, u).clip(0, n - 1)
        W[np.arange(max(k_out, 1)), j] = 1.0
        return W
    u = np.linspace(0.0, 1.0, k_out)
    j = (np.searchsorted(pos, u, side="right") - 1).clip(0, n - 2)
    t = (u - pos[j]) / (pos[j + 1] - pos[j])
    W = np.zeros((k_out, n), np.float64)
    t2, t3 = t * t, t * t * t
    rows = np.arange(k_out)
    # clamp the outer control points at the edges (standard CR boundary)
    np.add.at(W, (rows, (j - 1).clip(0, n - 1)), 0.5 * (-t3 + 2 * t2 - t))
    np.add.at(W, (rows, j), 0.5 * (3 * t3 - 5 * t2 + 2))
    np.add.at(W, (rows, (j + 1).clip(0, n - 1)), 0.5 * (-3 * t3 + 4 * t2 + t))
    np.add.at(W, (rows, (j + 2).clip(0, n - 1)), 0.5 * (t3 - t2))
    return W.astype(np.float32)


def grid_frequencies(fft_size: int, lower_hz: float, upper_hz: float,
                     sample_rate: int = 48_000,
                     resolution: int | None = None) -> np.ndarray:
    """Frequency of each display-grid column (the exponential position map
    inverted by interpolating bin frequency over position)."""
    freqs, keep = _kept_bins(fft_size, lower_hz, upper_hz, sample_rate)
    n = keep.size
    K = int(resolution) if resolution else n
    pos = exponential_positions(n)
    grid_f = np.interp(np.linspace(0.0, 1.0, K), pos, freqs[keep])
    return np.asarray(grid_f, np.float32)


def spectrogram(x, fft_size: int = 512, lower_hz: float = 20.0,
                upper_hz: float = 20_000.0, sample_rate: int = 48_000,
                resolution: int | None = None):
    """x [..., T] -> (freqs [K] NumPy, columns [..., n_frames, K])."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n_frames = x.shape[-1] // fft_size
    freqs, keep = _kept_bins(fft_size, lower_hz, upper_hz, sample_rate)
    n = keep.size
    K = int(resolution) if resolution else n
    grid = grid_frequencies(fft_size, lower_hz, upper_hz, sample_rate, K)
    if n_frames == 0:          # shorter than one frame: no columns
        return grid, x.new_zeros((*x.shape[:-1], 0, K))
    xb = x[..., : n_frames * fft_size].reshape(*x.shape[:-1], n_frames,
                                               fft_size)
    win, keep_d, W = _spectrogram_consts(fft_size, float(lower_hz),
                                         float(upper_hz), sample_rate, K,
                                         x.device)
    spec = torch.abs(torch.fft.rfft(xb * win, dim=-1)) / fft_size
    spec = tilt(spec[..., keep_d], freqs[keep], sample_rate)
    return grid, spec @ W.T


@device_cache(maxsize=16)
def _spectrogram_consts(fft_size: int, lower_hz: float, upper_hz: float,
                        sample_rate: int, K: int, device):
    """(window, kept bin indices, resampling matrix) on ``device``, copied
    there once (a streamed block reuses them)."""
    _, keep = _kept_bins(fft_size, lower_hz, upper_hz, sample_rate)
    return (torch.as_tensor(np.hanning(fft_size).astype(np.float32),
                            device=device),
            torch.as_tensor(keep, device=device),
            torch.as_tensor(_catmull_rom_matrix(keep.size, K),
                            device=device))


@device_cache(maxsize=16)
def _boost_on(raw: bytes, device) -> torch.Tensor:
    """sqrt(max(f, 1)) of the kept bins' frequencies (float64 bytes) as
    f32 on ``device``, taken on the host and copied there once."""
    f = np.frombuffer(raw, np.float64)
    return torch.as_tensor(np.sqrt(np.maximum(f, 1.0).astype(np.float32)),
                           device=device)


def tilt(spec, kept_freqs, sample_rate: int = 48_000):
    """The display tilt of the kept bins' magnitudes [..., n]:
    spec * sqrt(max(f, 1)) / sqrt(sr / 2).  The square roots are taken on
    the host (NumPy's f32 sqrt is correctly rounded; the card's and the
    CPU's torch.sqrt are not the same function), the divide is a true f32
    divide on the card too (precision.scalar_on)."""
    boost = _boost_on(np.asarray(kept_freqs, np.float64).tobytes(),
                      spec.device)
    return spec * boost / scalar_on(
        float(np.sqrt(np.float32(sample_rate / 2.0))), spec.device)
