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
(ops/scan.first_order_solve: the first-order kernel on the card).

The two gains reach the follower as one [2] f32 tensor on the device,
(attack, release), which the kernel reads from memory, as the Pallas
kernels read theirs from SMEM: for concrete frame counts the host's
gains in a cached device constant, for a stream's sliders
(utils/sliders.Data) the same host gains in the buffer the step refills
when a slider moves, for tensor frame counts (fitted sliders) the
device's.  Nothing reads a gain back to the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops import envelope_kernel, scan
from dsp_stuff_tpu_torch.utils.precision import get_policy, on_device
from dsp_stuff_tpu_torch.utils.sliders import form, lift

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
    gain is one host constant, identical on every device (a stream's
    slider, a Data, gives the Data of that constant).  A tensor frame
    count (a fitted slider) gives a differentiable tensor gain, the JAX
    package's device branch; the 0 case is guarded so its gradient stays
    finite."""
    if isinstance(frames, torch.Tensor):
        f = frames.to(_F32)
        zero = f == 0.0
        safe = torch.where(zero, torch.ones_like(f), f)
        return torch.where(zero, torch.zeros_like(f), torch.exp(-1.0 / safe))
    return lift(_frames_gain, frames)


def _frames_gain(frames) -> float:
    f = np.float32(frames)
    if f == 0.0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0) / f)))


def _in_range(frames) -> bool:
    return 0.0 <= float(frames) <= _MAX_CHUNKED_FRAMES


def _frames_in_range(frames) -> bool:
    """Whether the chunked route may take ``frames``, decided with no
    device read: a tensor frame count is in range by construction (the
    Envelope node clamps it to the sliders' 0..1000 frames), a stream's
    slider by its host value (a form: moving it out of range captures
    again), a number by its value."""
    if isinstance(frames, torch.Tensor):
        return True
    return form(lift(_in_range, frames))


def _gains(atk, rel, device) -> torch.Tensor:
    """(attack, release) gains as one [2] f32 tensor on ``device``: the
    cached constant of host gains, the buffer of a stream's, the stack of
    tensor ones."""
    if isinstance(atk, torch.Tensor) or isinstance(rel, torch.Tensor):
        return torch.stack([on_device(atk, device), on_device(rel, device)])
    return scan.const_on(lift(_pair, atk, rel), device)


def _pair(atk, rel) -> np.ndarray:
    return np.asarray([atk, rel], np.float32)


def _seq_scan(x, atk: float, rel: float, env0):
    """The recurrence sample by sample along the last axis (any leading
    batch dimensions): the plain version of the sequential kernel.  The
    gains are host floats or 0-d f32 tensors on x's device.  Returns (env
    [..., T], final [...])."""
    d = torch.abs(x)
    env = torch.as_tensor(env0, dtype=_F32, device=x.device).expand(
        x.shape[:-1]).clone()
    out = torch.empty_like(d)
    a = on_device(atk, x.device)
    r = on_device(rel, x.device)
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
    g^chunk of the true envelope.  The gains are host floats or 0-d f32
    tensors on x's device.  Returns (env [B, T], final [B])."""
    B, T = x.shape
    P = -(-T // chunk)
    xp = torch.nn.functional.pad(x, (0, P * chunk - T))
    d = torch.abs(xp).reshape(B, P, chunk)
    a = on_device(atk, x.device)
    r = on_device(rel, x.device)
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


def _forward(x2, gains, e0, chunked: bool):
    """The follower over [B, T] with ``gains`` [2] on x2's device: the
    plain versions on the CPU, the envelope kernel on the card."""
    T = x2.shape[-1]
    if x2.device.type == "cpu":
        return (_chunked_batched(x2, gains[0], gains[1], e0, _CHUNK)
                if chunked else _seq_scan(x2, gains[0], gains[1], e0))
    if x2.device.type == "cuda":
        return envelope_kernel.peak_envelope_cuda(
            x2.contiguous(), gains, e0.contiguous(),
            chunk=_CHUNK if chunked else T)
    raise ValueError(f"peak_envelope: no kernel for device {x2.device}")


class EnvCore(torch.autograd.Function):
    """The follower over x [B, T] from env0 [B] with gains [2] (attack,
    release; an f32 tensor on x's device, which may require grad):
    forward ``_forward``, backward the JAX package's analytic adjoint
    (ops/envelope.py: _env_core_bwd)."""

    @staticmethod
    def forward(ctx, x, gains, env0, chunked):
        env, fin = _forward(x, gains, env0, chunked)
        ctx.save_for_backward(x, env, env0, gains)
        return env, fin.clone()      # fin may be a view of env

    @staticmethod
    def backward(ctx, ybar, fbar):
        x, env, env0, gains = ctx.saved_tensors
        ybar = (torch.zeros_like(env) if ybar is None
                else ybar.to(_F32).clone())
        if fbar is not None:
            ybar[:, -1] += fbar
        d = torch.abs(x)
        env_prev = torch.cat([env0[:, None], env[:, :-1]], dim=1)
        is_atk = env_prev < d
        g = torch.where(is_atk, gains[0], gains[1])
        # lam_t = ybar_t + g_{t+1} lam_{t+1}: the reverse solve with the
        # next sample's gain (none after the last)
        lam = scan.first_order_solve(F.pad(g[:, 1:], (0, 1)), ybar,
                                     torch.zeros_like(env0), reverse=True)
        xbar = lam * (1.0 - g) * torch.sign(x) if ctx.needs_input_grad[0] \
            else None
        gbar = None
        if ctx.needs_input_grad[1]:
            dem = lam * (env_prev - d)         # lam_t d env_t / d gain_t
            gbar = torch.stack([
                torch.sum(torch.where(is_atk, dem, 0.0), dtype=torch.float64),
                torch.sum(torch.where(is_atk, 0.0, dem), dtype=torch.float64)
            ]).to(_F32)
        env0bar = lam[:, 0] * g[:, 0] if ctx.needs_input_grad[2] else None
        return xbar, gbar, env0bar, None


def peak_envelope(x, attack_frames=0.0, release_frames=0.0, env0=0.0):
    """Full-wave peak detection along the last axis of ``x`` [..., T].

    Frame counts are concrete numbers, a stream's sliders (Data) or 0-d
    tensors (fitted sliders).  The chunked route is taken under ``fast``
    past two chunks when the frame counts are in range
    (``_frames_in_range``, no device read).  Differentiable in x, env0 and
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
    env, fin = EnvCore.apply(x2, _gains(atk, rel, x.device), e0, chunked)
    return env.reshape(*batch, T), fin.reshape(batch)
