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
chunk; there is no fallback.

``EnvCore`` makes the follower differentiable with the JAX package's
analytic adjoint (``_env_core_bwd``): with g_t the gain the forward chose
at step t, the cotangent obeys the LINEAR reverse recurrence
lam_t = ybar_t + g_{t+1} lam_{t+1}, a time-varying first-order solve
(ops/scan.first_order_solve: the first-order kernel on the card).  Frame
counts that are tensors (fitted sliders) give tensor gains; the kernels
take their gains as host floats, read once per render.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops import envelope_kernel, scan
from dsp_stuff_tpu_torch.utils.precision import get_policy, scalar_on

_F32 = torch.float32

# Chunk length of the chunk-parallel path.  Convergence of the guessed
# chunk starts is g^CHUNK with g = exp(-1/frames); at the slider maximum
# (1000 frames) that is exp(-32.8) ~= 6e-15, far below f32 rounding.
_CHUNK = 32768

# The chunked path's contraction bound needs frames <~ _CHUNK / 21; larger
# (or negative, or NaN) frame counts take the sequential recurrence.
_MAX_CHUNKED_FRAMES = 1500.0


def gain_from_frames(frames):
    """exp(-1/frames); 0 when frames == 0 (dasp_envelope calc_gain).

    A concrete frame count gives a NumPy f32 host float: the recurrence
    amplifies a 1-ulp gain difference over thousands of samples, so the
    gain is one host constant, identical on every device.  A tensor frame
    count (a fitted slider) gives a differentiable tensor gain, the JAX
    package's device branch; the 0 case is guarded so its gradient stays
    finite."""
    if isinstance(frames, torch.Tensor):
        f = frames.to(_F32)
        zero = f == 0.0
        safe = torch.where(zero, torch.ones_like(f), f)
        return torch.where(zero, torch.zeros_like(f), torch.exp(-1.0 / safe))
    f = np.float32(frames)
    if f == 0.0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0) / f)))


def _frames_in_range(frames) -> bool:
    if isinstance(frames, torch.Tensor):
        frames = frames.detach()
    return 0.0 <= float(frames) <= _MAX_CHUNKED_FRAMES


def _seq_scan(x, atk: float, rel: float, env0):
    """The recurrence sample by sample along the last axis (any leading
    batch dimensions): the plain version of the sequential kernel.
    Returns (env [..., T], final [...])."""
    d = torch.abs(x)
    env = torch.as_tensor(env0, dtype=_F32, device=x.device).expand(
        x.shape[:-1]).clone()
    out = torch.empty_like(d)
    a = scalar_on(float(atk), x.device)
    r = scalar_on(float(rel), x.device)
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
    a = scalar_on(float(atk), x.device)
    r = scalar_on(float(rel), x.device)
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


def _forward(x2, atk: float, rel: float, e0, chunked: bool):
    """The follower over [B, T]: the plain versions on the CPU, the
    envelope kernel on the card."""
    T = x2.shape[-1]
    if x2.device.type == "cpu":
        return (_chunked_batched(x2, atk, rel, e0, _CHUNK) if chunked
                else _seq_scan(x2, atk, rel, e0))
    if x2.device.type == "cuda":
        return envelope_kernel.peak_envelope_cuda(
            x2.contiguous(), atk, rel, e0.contiguous(),
            chunk=_CHUNK if chunked else T)
    raise ValueError(f"peak_envelope: no kernel for device {x2.device}")


def _host_gain(g) -> float:
    return float(g.detach()) if isinstance(g, torch.Tensor) else g


class EnvCore(torch.autograd.Function):
    """The follower over x [B, T] from env0 [B] with gains atk, rel (host
    floats, or 0-d tensors that may require grad): forward ``_forward``,
    backward the JAX package's analytic adjoint (ops/envelope.py:
    _env_core_bwd)."""

    @staticmethod
    def forward(ctx, x, atk, rel, env0, chunked):
        a, r = _host_gain(atk), _host_gain(rel)
        env, fin = _forward(x, a, r, env0, chunked)
        ctx.save_for_backward(x, env, env0)
        ctx.gains = (a, r)
        return env, fin.clone()      # fin may be a view of env

    @staticmethod
    def backward(ctx, ybar, fbar):
        x, env, env0 = ctx.saved_tensors
        a, r = ctx.gains
        ybar = (torch.zeros_like(env) if ybar is None
                else ybar.to(_F32).clone())
        if fbar is not None:
            ybar[:, -1] += fbar
        d = torch.abs(x)
        env_prev = torch.cat([env0[:, None], env[:, :-1]], dim=1)
        is_atk = env_prev < d
        g = torch.where(is_atk, scalar_on(float(a), x.device),
                        scalar_on(float(r), x.device))
        # lam_t = ybar_t + g_{t+1} lam_{t+1}: the reverse solve with the
        # next sample's gain (none after the last)
        lam = scan.first_order_solve(F.pad(g[:, 1:], (0, 1)), ybar,
                                     torch.zeros_like(env0), reverse=True)
        xbar = lam * (1.0 - g) * torch.sign(x) if ctx.needs_input_grad[0] \
            else None
        atkbar = relbar = None
        dem = lam * (env_prev - d)             # lam_t d env_t / d gain_t
        if ctx.needs_input_grad[1]:
            atkbar = torch.sum(torch.where(is_atk, dem, 0.0),
                               dtype=torch.float64).to(_F32)
        if ctx.needs_input_grad[2]:
            relbar = torch.sum(torch.where(is_atk, 0.0, dem),
                               dtype=torch.float64).to(_F32)
        env0bar = lam[:, 0] * g[:, 0] if ctx.needs_input_grad[3] else None
        return xbar, atkbar, relbar, env0bar, None


def peak_envelope(x, attack_frames=0.0, release_frames=0.0, env0=0.0):
    """Full-wave peak detection along the last axis of ``x`` [..., T].

    Frame counts are concrete numbers or 0-d tensors (fitted sliders; the
    chunk decision reads them on the host).  Differentiable in x, env0 and
    tensor frame counts through ``EnvCore``.  Returns (env [..., T] f32,
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
    env, fin = EnvCore.apply(x2, atk, rel, e0, chunked)
    return env.reshape(*batch, T), fin.reshape(batch)
