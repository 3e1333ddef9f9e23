"""Peak envelope follower (dasp_envelope semantics).

The reference Envelope node (envelope.rs:43-51) wraps
``dasp_envelope::Detector<f32, Peak<FullWave>>`` with attack/release frame
counts set every block.  Per sample:

    d     = |x|                                   (full-wave rectify)
    gain  = attack_gain  if env < d  else release_gain
    env'  = d + gain * (env - d)

with ``gain_from_frames(n) = exp(-1/n)`` and ``0.0`` when n == 0.

The branch on ``env < d`` makes the recurrence non-associative, but it is a
contraction in the carry: |f(e1) - f(e2)| <= max(atk, rel) * |e1 - e2|.
The ``fast`` policy exploits that with a two-pass chunk-parallel
evaluation (`_chunked_batched`) for long signals; otherwise the recurrence
runs sample by sample (`_seq_scan`).

Dispatch is by device: a CPU tensor takes those plain PyTorch versions, a
CUDA tensor the envelope kernel (ops/envelope_kernel.py), which computes
the same recurrence with the same roundings, chunked or in one sequential
chunk; there is no fallback.  The analytic backward of the JAX package
(``_env_core_bwd``) belongs to the training path and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.ops import envelope_kernel
from dsp_stuff_tpu_torch.utils.precision import get_policy

_F32 = torch.float32

# Chunk length of the chunk-parallel path.  Convergence of the guessed
# chunk starts is g^CHUNK with g = exp(-1/frames); at the slider maximum
# (1000 frames) that is exp(-32.8) ~= 6e-15, far below f32 rounding.
_CHUNK = 32768

# The chunked path's contraction bound needs frames <~ _CHUNK / 21; larger
# (or negative, or NaN) frame counts take the sequential recurrence.
_MAX_CHUNKED_FRAMES = 1500.0


def gain_from_frames(frames) -> float:
    """exp(-1/frames) in NumPy f32 on the host; 0 when frames == 0
    (dasp_envelope calc_gain).  The recurrence amplifies a 1-ulp gain
    difference over thousands of samples, so the gain is one host
    constant, identical on every device, never a device exp."""
    f = np.float32(frames)
    if f == 0.0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0) / f)))


def _frames_in_range(frames) -> bool:
    return 0.0 <= float(frames) <= _MAX_CHUNKED_FRAMES


def _seq_scan(x, atk: float, rel: float, env0):
    """The recurrence sample by sample along the last axis (any leading
    batch dimensions): the plain version of the sequential kernel.
    Returns (env [..., T], final [...])."""
    d = torch.abs(x)
    env = torch.as_tensor(env0, dtype=_F32, device=x.device).expand(
        x.shape[:-1]).clone()
    out = torch.empty_like(d)
    a = torch.tensor(atk, dtype=_F32, device=x.device)
    r = torch.tensor(rel, dtype=_F32, device=x.device)
    for t in range(d.shape[-1]):
        dt = d[..., t]
        env = dt + torch.where(env < dt, a, r) * (env - dt)
        out[..., t] = env
    return out, env


def _chunked_batched(x, atk: float, rel: float, env0, chunk: int):
    """Two-pass chunk-parallel envelope for [B, T] input: the plain
    version of the chunked kernel.

    Pass 1 runs every chunk from a guessed (zero) start, giving each
    chunk's final envelope; pass 2 reruns each chunk from its
    predecessor's pass-1 final.  The recurrence contracts the carry by
    max(atk, rel) < 1 per sample, so every pass-2 start is within
    g^chunk of the true envelope.  Returns (env [B, T], final [B])."""
    B, T = x.shape
    P = -(-T // chunk)
    xp = torch.nn.functional.pad(x, (0, P * chunk - T))
    d = torch.abs(xp).reshape(B, P, chunk)
    a = torch.tensor(atk, dtype=_F32, device=x.device)
    r = torch.tensor(rel, dtype=_F32, device=x.device)
    e0 = torch.as_tensor(env0, dtype=_F32, device=x.device).expand(B)

    def run(starts, out):
        env = starts
        for t in range(chunk):
            dt = d[..., t]
            env = dt + torch.where(env < dt, a, r) * (env - dt)
            if out is not None:
                out[..., t] = env
        return env

    starts = torch.zeros((B, P), dtype=_F32, device=x.device)
    starts[:, 0] = e0
    finals = run(starts, None)
    starts2 = torch.cat([e0[:, None], finals[:, :-1]], dim=1)
    ys = torch.empty_like(d)
    run(starts2, ys)
    env = ys.reshape(B, P * chunk)[:, :T]
    return env, env[:, -1]


def peak_envelope(x, attack_frames=0.0, release_frames=0.0, env0=0.0):
    """Full-wave peak detection along the last axis of ``x`` [..., T].

    Frame counts are concrete numbers.  Returns (env [..., T] f32,
    final_env [...])."""
    x = torch.as_tensor(x, dtype=_F32)
    batch, T = x.shape[:-1], x.shape[-1]
    atk = gain_from_frames(attack_frames)
    rel = gain_from_frames(release_frames)
    B = int(np.prod(batch, dtype=np.int64))
    x2 = x.reshape(B, T)
    e0 = torch.as_tensor(env0, dtype=_F32, device=x.device).expand(
        batch).reshape(B)
    chunked = (get_policy().name == "fast" and T > 2 * _CHUNK
               and _frames_in_range(attack_frames)
               and _frames_in_range(release_frames))
    if x.device.type == "cpu":
        env, fin = (_chunked_batched(x2, atk, rel, e0, _CHUNK) if chunked
                    else _seq_scan(x2, atk, rel, e0))
    elif x.device.type == "cuda":
        env, fin = envelope_kernel.peak_envelope_cuda(
            x2.contiguous(), atk, rel, e0.contiguous(),
            chunk=_CHUNK if chunked else T)
    else:
        raise ValueError(f"peak_envelope: no kernel for device {x.device}")
    return env.reshape(*batch, T), fin.reshape(batch)
