"""Feedback comb / echo delay line.

The reference Reverb node (reverb.rs:76-111) is a feedback echo:

    out[n] = in[n] + delayed[n] * decay      # reverb.rs:87-92
    delay-line <- out[n]                     # reverb.rs:99-105

with the delay line a ring pre-filled with D zeros, i.e.

    y[n] = x[n] + decay * y[n - D],  y[n<0] = history,
    D = max(int(seconds * 48000), 128)       # reverb.rs:57

y[n] depends only on y[n - D], so the sequence splits into chunks of
exactly D samples with  chunk_k = x_k + decay * chunk_{k-1}: T/D
sequential steps of D-wide elementwise work, each with the reference's
per-sample op order (t = delayed*decay; y = x + t).  That runs for a
concrete decay under every policy, and for a tensor decay (the fitting
path) under ``parity``, and for a stream's slider (utils/sliders.Data,
its f32 value in a device buffer) under every policy.  A tensor decay
under ``fast`` takes the JAX package's route for a traced decay: the
chunk recurrence as Toeplitz products over the chunk axis
(``_comb_chunks_blocked``), a few launches instead of two per chunk,
forward and backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops.scan import _f32, _toeplitz
from dsp_stuff_tpu_torch.utils.precision import get_policy
from dsp_stuff_tpu_torch.utils.sliders import lift, num


def delay_samples(seconds: float, sample_rate: int = 48_000) -> int:
    """max(int(seconds*48000), 128) -- reverb.rs:57.  The 128 floor is the
    reference's fixed BUF_SIZE, not the compile block size."""
    return max(int(seconds * sample_rate), 128)


def feedback_comb(x, decay, delay: int, history=None):
    """y[n] = x[n] + decay * y[n-D] along the last axis.

    history -- [..., D] previous outputs (newest last), zeros if None.
    decay   -- a Python float, a stream's slider (Data), or a 0-d tensor
               that may require grad (the fitting path; it stays on the
               device and autograd runs through the chunk recurrence).
    Returns (y, new_history)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    D = int(delay)
    T = x.shape[-1]
    batch = x.shape[:-1]
    if history is None:
        history = torch.zeros((*batch, D), dtype=torch.float32,
                              device=x.device)
    history = torch.as_tensor(history, dtype=torch.float32,
                              device=x.device).expand(*batch, D)
    traced = isinstance(decay, torch.Tensor)
    if traced:
        decay = decay.to(torch.float32)
    else:
        decay = num(lift(_f32, decay), x)

    if T <= D:
        # every delayed sample is already in the history
        y = x + history[..., :T] * decay
        return y, torch.cat([history[..., T:], y], dim=-1)

    nchunks = -(-T // D)
    pad = nchunks * D - T
    xp = F.pad(x, (0, pad)) if pad else x
    xcb = xp.reshape(*batch, nchunks, D)
    if traced and get_policy().name == "fast":
        yb = _comb_chunks_blocked(xcb, decay, history)
        prev = yb[..., -1, :]
        y = yb.reshape(*batch, nchunks * D)[..., :T]
    else:
        prev = history
        chunks = []
        # unbind, not a slice per chunk: under autograd each slice's
        # backward would zero-fill and add a whole-signal gradient
        for xk in xcb.unbind(-2):
            prev = xk + prev * decay
            chunks.append(prev)
        y = torch.cat(chunks, dim=-1)[..., :T]
    if pad == 0:
        return y, prev
    # last D true outputs (the old history covers T < D)
    return y, torch.cat([history, y], dim=-1)[..., -D:]


def _decay_powers(decay, n: int):
    """(pows [n+1], Lt [n, n]) of a 0-d tensor decay: pows[k] = decay^k
    by cumulative product, Lt[i, j] = decay^(i-j) for i >= j, else 0."""
    pows = torch.cat([torch.ones((1,), dtype=decay.dtype,
                                 device=decay.device),
                      torch.cumprod(decay.expand(n), dim=0)])
    return pows, _toeplitz(pows, n).transpose(0, 1)


def _comb_chunks_blocked(xcb, decay, history, G_max: int = 256):
    """y_k = decay y_{k-1} + x_k over the chunk axis of xcb [..., K, D],
    y_{-1} = history [..., D], for a 0-d tensor decay (the JAX package's
    ops/delay_line.py:_comb_chunks_blocked).  K <= G_max: one [K, K]
    Toeplitz product plus the history's decay^(k+1) term.  Longer: super-
    chunks of G <= G_max (a multiple of 8) each solved by one product, the
    super-chunk carries by a short sequential chain.  Returns yb
    [..., K, D]."""
    K, D = xcb.shape[-2:]
    batch = xcb.shape[:-2]
    if K <= G_max:
        pows, Lt = _decay_powers(decay, K)
        return Lt @ xcb + pows[1:, None] * history[..., None, :]
    KG = -(-K // G_max)
    G = -(-(-(-K // KG)) // 8) * 8                        # ceil, 8-aligned
    Xg = F.pad(xcb, (0, 0, 0, KG * G - K)).reshape(*batch, KG, G, D)
    pows, Lt = _decay_powers(decay, G)
    # each super-chunk's zero-state end, then the carries into each
    ends = torch.einsum("j,...jd->...d", pows[:G].flip(0), Xg)  # [.., KG, D]
    carry = history
    carries = []
    for m in range(KG):
        carries.append(carry)
        carry = pows[G] * carry + ends[..., m, :]
    carry_in = torch.stack(carries, dim=-2)                 # [..., KG, D]
    yg = Lt @ Xg + carry_in[..., :, None, :] * pows[1:, None]
    return yg.reshape(*batch, KG * G, D)[..., :K, :]
