"""FIR filtering with the reference's exact warm-up semantics.

The reference FIR node (fir.rs:179-225) keeps a ``VecDeque<f64>`` of recent
inputs, capped at ``taps.len()``, and emits the dot product of the deque
(oldest first) with the *stored* taps, which were reversed at IR-load time
(fir.rs:160-170).  Consequences kept here, as in the JAX package:

* steady state (>= N samples seen): causal convolution with the
  un-reversed IR, accumulated in the policy's ``fir_accum_dtype`` (f64
  under ``parity``, as the reference), cast to f32, then scaled by the mode
  divisor (Average: 1/N, Balanced: 1 -- fir.rs:187-190).
* warm-up (the first N-1 samples ever): the deque is shorter than the taps
  and zips from the *front* of the reversed-tap array, so sample g (global
  index, g < N-1) emits  sum_{k=0..g} x[k] * taps_rev[k]  -- a running
  cumulative sum along the reversed taps, not a convolution prefix.

The global sample counter ``n_seen`` is a lockstep counter
(ops/lockstep.py: every stream of a batched render advances together; a
Python int in a render, a 0-d tensor on the device in a stream session's
block step).  The warm-up never reads it on the host: it takes its sums
with masks over the first N-1 global positions (``_warm_up``).

Convolution: ``F.conv1d`` for IRs of up to 256 taps, else ``torch.fft``
(one transform for a short signal, overlap-save frames for a long one).
Both run in the accumulation dtype on any device: cuFFT transforms f64
natively, so ``parity`` stays f64 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dsp_stuff_tpu_torch.ops.lockstep import advance, counter
from dsp_stuff_tpu_torch.utils.capture import device_cache
from dsp_stuff_tpu_torch.utils.precision import get_policy

# IRs longer than this use FFT convolution (O(T log N) vs O(T*N))
DIRECT_CONV_MAX_TAPS = 256

# n_seen saturates here (an int32 counter in the JAX package's state)
_N_SEEN_MAX = 2 ** 30


def accum_dtype() -> torch.dtype:
    """The FIR accumulation dtype of the current precision policy."""
    return (torch.float64 if get_policy().fir_accum_dtype == "float64"
            else torch.float32)


def init_fir_state(n_taps: int, device=None):
    """(hist, first, n_seen): the last N-1 inputs (newest last, zeros
    before warm), the first N-1 inputs ever seen (for the warm-up), both
    f32 (they hold inputs) and broadcast against a batch, and the global
    sample counter, an int."""
    z = torch.zeros((max(n_taps - 1, 0),), dtype=torch.float32,
                    device=device)
    return z, z.clone(), 0


def causal_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_m h[m] * x[n-m], zero history; x [..., T], h [N], both in
    the accumulation dtype."""
    N = h.shape[0]
    if N <= DIRECT_CONV_MAX_TAPS:
        return _conv_direct(F.pad(x, (N - 1, 0)), h)
    return _fft_conv(x, h)


def _conv_direct(xp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Direct convolution on [..., T+N-1] (the first N-1 samples are the
    history): a VALID cross-correlation with the reversed kernel."""
    N = h.shape[0]
    lead = xp.shape[:-1]
    flat = xp.reshape(-1, 1, xp.shape[-1])                       # [B, 1, W]
    out = F.conv1d(flat, h.flip(0).reshape(1, 1, N).to(xp.dtype))
    return out.reshape(*lead, -1)


def _fft_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """FFT convolution in x's dtype; overlap-save frames when the signal is
    much longer than the IR (bounded FFT size, batched frame transforms
    instead of one signal-length transform)."""
    T = x.shape[-1]
    N = h.shape[0]
    h = h.to(x.dtype)
    nfft_os = 1 << max(int(np.ceil(np.log2(max(2 * N, 2)))), 10)
    if T <= 4 * nfft_os:
        # short signal: one transform is cheaper than framing
        nfft = 1 << (T + N - 2).bit_length()
        X = torch.fft.rfft(x, nfft)
        H = torch.fft.rfft(h, nfft)
        return torch.fft.irfft(X * H, nfft)[..., :T]

    # overlap-save: frames of nfft with N-1 samples of history each; every
    # frame yields hop = nfft-(N-1) valid outputs after discarding the
    # wrap-around prefix.  nfft >= 2N guarantees (N-1) <= hop, so the
    # overlapping frames build from two contiguous reshapes, no gather.
    nfft = nfft_os
    hop = nfft - (N - 1)
    K = -(-T // hop)
    lead = x.shape[:-1]
    xp = F.pad(x, (N - 1, K * hop - T + hop))
    W1 = xp[..., :K * hop].reshape(*lead, K, hop)
    W2 = xp[..., hop:hop + K * hop].reshape(*lead, K, hop)[..., :N - 1]
    frames = torch.cat([W1, W2], dim=-1)                   # [..., K, nfft]
    H = torch.fft.rfft(h, nfft)
    Y = torch.fft.irfft(torch.fft.rfft(frames, nfft) * H, nfft)
    return Y[..., N - 1:].reshape(*lead, K * hop)[..., :T]


@device_cache(maxsize=64)
def _taps_on(raw: bytes, device) -> torch.Tensor:
    """The stored taps (float64 bytes) on ``device``, copied there once."""
    return torch.tensor(np.frombuffer(raw, np.float64), device=device)


def _warm_up(x, y, first, taps_rev, n_seen, acc):
    """The warm-up of ``fir_apply``: the global samples n_seen .. N-2
    take the running sum along the reversed taps.  The inputs at those
    positions land in ``first`` (the first N-1 inputs ever); the running
    sum runs over all N-1 positions (a running sum does not look ahead,
    so its entries up to the last warm sample are those of a sum over
    just the warm ones), and each output sample still in the warm-up
    takes its entry.  Masks, not slices, so that a counter on the device
    is never read on the host; only the first min(N-1, T) outputs can be
    warm.  Returns (y, first)."""
    N1, T = first.shape[-1], x.shape[-1]
    W = min(N1, T)
    dev = x.device
    src = torch.arange(N1, device=dev) - n_seen        # x index of each slot
    take = (src >= 0) & (src < T)
    xs = x.to(first.dtype).expand(*first.shape[:-1], T)[
        ..., src.clamp(0, T - 1)]
    first = torch.where(take, xs, first)
    warm = torch.cumsum(first.to(acc) * taps_rev[:N1].to(acc), dim=-1)
    g = n_seen + torch.arange(W, device=dev)            # global sample index
    head = torch.where(g < N1, warm[..., g.clamp(max=N1 - 1)], y[..., :W])
    return torch.cat([head, y[..., W:]], dim=-1), first


def fir_apply(x: torch.Tensor, taps_rev, state=None, divisor=1.0):
    """Apply the reference FIR semantics to a segment.

    x        -- [..., T] f32 input segment
    taps_rev -- [N] stored taps (already reversed, as saved in configs)
    state    -- from init_fir_state (or None for a fresh filter); hist and
                first broadcast against x's batch shape
    divisor  -- f32 mode divisor (fir.rs:187-190)

    Returns (y [..., T] f32, new_state)."""
    acc = accum_dtype()
    taps_rev = np.ascontiguousarray(taps_rev, np.float64)
    taps_rev = _taps_on(taps_rev.tobytes(), x.device)
    N = taps_rev.shape[0]
    T = x.shape[-1]
    if state is None:
        state = init_fir_state(N, device=x.device)
    hist, first, n_seen = state
    n_seen = counter(n_seen)
    xd = x.to(acc)
    ha = taps_rev.flip(0).to(acc)              # un-reversed IR
    div = float(np.float32(divisor))

    if N == 1:
        return (xd * ha[0]).to(torch.float32) * div, state

    batch = torch.broadcast_shapes(x.shape[:-1], hist.shape[:-1],
                                   first.shape[:-1])
    xd = xd.expand(*batch, T)

    # -- steady path: convolution over [hist, x] ----------------------------
    full = torch.cat([hist.to(acc).expand(*batch, N - 1), xd], dim=-1)
    y = causal_conv(full, ha)[..., N - 1:]                       # [..., T]

    # -- warm-up path ------------------------------------------------------
    y, first = _warm_up(x, y, first.expand(*batch, N - 1), taps_rev, n_seen,
                        acc)
    y = y.to(torch.float32) * div

    new_hist = full[..., -(N - 1):].to(hist.dtype)
    return y, (new_hist, first, advance(n_seen, T, _N_SEEN_MAX))
