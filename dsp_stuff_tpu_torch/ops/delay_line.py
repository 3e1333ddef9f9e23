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
per-sample op order (t = delayed*decay; y = x + t), under every policy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def delay_samples(seconds: float, sample_rate: int = 48_000) -> int:
    """max(int(seconds*48000), 128) -- reverb.rs:57.  The 128 floor is the
    reference's fixed BUF_SIZE, not the compile block size."""
    return max(int(seconds * sample_rate), 128)


def feedback_comb(x, decay, delay: int, history=None):
    """y[n] = x[n] + decay * y[n-D] along the last axis.

    history -- [..., D] previous outputs (newest last), zeros if None.
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
    decay = float(np.float32(decay))

    if T <= D:
        # every delayed sample is already in the history
        y = x + history[..., :T] * decay
        return y, torch.cat([history[..., T:], y], dim=-1)

    nchunks = -(-T // D)
    pad = nchunks * D - T
    xp = F.pad(x, (0, pad)) if pad else x
    prev = history
    chunks = []
    for k in range(nchunks):
        prev = xp[..., k * D:(k + 1) * D] + prev * decay
        chunks.append(prev)
    y = torch.cat(chunks, dim=-1)[..., :T]
    if pad == 0:
        return y, prev
    # last D true outputs (the old history covers T < D)
    return y, torch.cat([history, y], dim=-1)[..., -D:]
