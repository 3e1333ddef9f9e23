"""The reference's node semantics as whole-signal plain PyTorch.

Each function computes one dsp-stuff node over [..., T] signals, the
semantics of ``oracle.py`` (the sequential per-sample oracle), vectorised
so that a reference of 10 s of audio runs in seconds:

* a linear recurrence (low pass, high pass, the biquad's poles) is solved
  in blocks of ``BLOCK`` samples: each block's zero-state response is one
  product with a lower-triangular Toeplitz matrix of the impulse response,
  and the two-number state is carried from block to block;
* the comb (reverb) runs a delay line's length at a time;
* the peak envelope, whose branch depends on its own state, runs each
  chunk of the signal from zero after a warm-up long enough that the
  start state is forgotten to below float64's resolution (the follower
  contracts by max(attack gain, release gain) a sample).

``Prec`` says how it computes: ``"f64"`` is the reference, float64
throughout; ``"tf32"`` is its control, float32 with every block product
taken on operands rounded to TF32 (10 mantissa bits), the precision a
float32 matrix product falls to when TF32 is switched on.

Constants that dsp-stuff holds in f32 (a slider's value, a filter's
``1 - ratio``, an envelope's gains, the fan-in divisor ``n + 1e-4``, the
LFO's phase and the chorus's delay) are taken at their f32 values, since
they are part of the defined result.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 48_000
BUF = 128
BLOCK = 1280                # samples a block solve takes at a time
F32 = np.float32


def f32(v) -> float:
    """A value as dsp-stuff holds it: rounded to f32 (a tensor passes)."""
    if isinstance(v, torch.Tensor):
        return v
    return float(F32(v))


def fanin_divisor(n: int) -> float:
    """collect_and_average's divisor (node.rs:162-194): 1e-4 + n, summed
    in f32."""
    acc = F32(0.0001)
    for _ in range(n):
        acc = F32(acc + F32(1.0))
    return float(acc)



def h(*sigs):
    """A port's fan-in average of its connected signals."""
    acc = sigs[0]
    for s in sigs[1:]:
        acc = acc + s
    return acc / fanin_divisor(len(sigs))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero); its gradient passes the rounding unchanged."""
    b = x.detach().contiguous().view(torch.int32)
    r = ((b + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


class Prec:
    """How the reference computes, and where: ``mode`` "f64" or "tf32"."""

    def __init__(self, mode: str = "f64", device="cpu"):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.device = torch.device(device)
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), device=self.device).to(
            self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b: in float64, or on TF32-rounded float32 operands (with
        the card's own TF32 off, so the rounding is this one)."""
        if self.mode == "tf32":
            a, b = tf32(a.to(torch.float32)), tf32(b.to(torch.float32))
        return torch.matmul(a, b)


def _powers(A: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 2, 2]: A^0 .. A^(n-1), by doubling."""
    P = torch.eye(2, dtype=A.dtype, device=A.device)[None]
    Am = A
    while P.shape[0] < n:
        P = torch.cat([P, Am @ P])
        Am = Am @ Am
    return P[:n]


def allpole(u: torch.Tensor, a1, a2, p: Prec, block: int = BLOCK):
    """y[n] = u[n] - a1 y[n-1] - a2 y[n-2] from a zero state, over the
    last axis of ``u``."""
    T = u.shape[-1]
    L = min(block, -(-T // BUF) * BUF)
    nb = -(-T // L)
    if nb * L != T:
        u = torch.nn.functional.pad(u, (0, nb * L - T))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    A = torch.stack([torch.stack([-a1 * one, -a2 * one]),
                     torch.stack([one, zero])])
    pw = _powers(A, L + 1)
    i = torch.arange(L, device=p.device)
    lag = i[:, None] - i[None, :]
    H = torch.where(lag >= 0, pw[lag.clamp(min=0), 0, 0], zero)    # [L, L]
    G = pw[L - 1 - i, :, 0]                                          # [L, 2]
    C = pw[1:L + 1, 0, :]                                            # [L, 2]
    AL = pw[L]
    lead = u.shape[:-1]
    U = u.reshape(*lead, nb, L)
    Z = p.mm(U, G)                                   # each block's end state
    s = torch.zeros((*lead, 2), dtype=p.dtype, device=p.device)
    starts = []
    for b in range(nb):
        starts.append(s)
        s = s @ AL.T + Z[..., b, :]
    S = torch.stack(starts, dim=-2)                  # [..., nb, 2]
    y = p.mm(U, H.T) + p.mm(S, C.T)
    return y.reshape(*lead, nb * L)[..., :T]


def last(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` samples of ``x``, oldest first, with zeros before
    the start: what a line of ``n`` samples holds at the end."""
    return torch.nn.functional.pad(x, (max(n - x.shape[-1], 0), 0))[..., -n:]


def df1_state(x, y) -> dict:
    """A DirectForm1 biquad's end state: its last two inputs and
    outputs."""
    return {"x1": x[..., -1], "x2": x[..., -2], "y1": y[..., -1],
            "y2": y[..., -2]}


def delayed(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[n - k] with zeros before the start."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x, (k, 0))[..., :x.shape[-1]]


# -- nodes -------------------------------------------------------------------

def gain(x, level):
    return x * f32(level)


def mix(a, b, ratio):
    r = f32(ratio)
    return b * r + a * (1.0 - r)


def mod_map(sig, lo, hi):
    """A modulation input mapped onto a slider's range (derive lib.rs:
    140-148)."""
    z = torch.clamp((sig + 1.0) / 2.0, 0.0, 1.0)
    return f32(lo) + f32(f32(hi) - f32(lo)) * z


def _bypass(level, shaped, x):
    """A shaper whose level is under 0.001 passes its input."""
    if isinstance(level, torch.Tensor):
        return torch.where(level < 0.001, x, shaped)
    return x if level < 0.001 else shaped


def overdrive(x, boost, drive, level):
    """overdrive.rs:31-43."""
    a = x * f32(boost)
    d = float(F32(2.0 / np.pi)) * torch.atan(float(F32(np.pi / 4.0)) * a)
    drive = f32(drive)
    m = drive * d + (1.0 - drive) * x
    return _bypass(f32(level), m * f32(level), x)


def soft_clip(x, level):
    """distort.rs:71-86."""
    lv = f32(level)
    s = x * lv
    inner = s - s * s * s / 3.0
    shaped = torch.where(s > 1.0, torch.full_like(s, 2.0 / 3.0),
                         torch.where(s >= -1.0, inner,
                                     torch.full_like(s, -2.0 / 3.0)))
    return _bypass(lv, torch.clamp(shaped, -1.0, 1.0) / lv, x)


def tanh_clip(x, level):
    lv = f32(level)
    return _bypass(lv, torch.tanh(x * lv), x)


def chebyshev(x, level_pos, level_neg):
    """chebyshev.rs:28-42."""
    out = []
    for lv in (f32(level_pos), f32(level_neg)):
        t = lv if isinstance(lv, torch.Tensor) else torch.tensor(
            lv, dtype=x.dtype, device=x.device)
        out.append(_bypass(lv, torch.tanh(x * lv) / torch.tanh(t), x))
    return torch.where(x >= 0.0, out[0], out[1])


def low_pass(x, ratio, p: Prec):
    """low_pass.rs:36-41: y = (1 - r) x + r y[n-1]."""
    r = f32(ratio)
    return allpole(f32(1.0 - r) * x, -r, 0.0, p)


def high_pass(x, ratio, p: Prec):
    """high_pass.rs:36-41: x minus the low pass's state."""
    return x - low_pass(x, ratio, p)


def biquad(x, a0, a1, a2, b0, b1, b2, p: Prec):
    """The biquad crate's DirectForm1, coefficients over a0
    (biquad.rs:62-89)."""
    a0 = f32(a0)
    na1, na2, nb0, nb1, nb2 = (f32(f32(v) / a0) for v in (a1, a2, b0, b1,
                                                           b2))
    u = nb0 * x + nb1 * delayed(x, 1) + nb2 * delayed(x, 2)
    return allpole(u, na1, na2, p)


def reverb_delay(seconds) -> int:
    """reverb.rs:76-111's delay in samples."""
    return max(int(F32(seconds) * F32(48000.0)), 128)


def comb(x, D: int, decay):
    """y[n] = x[n] + decay y[n - D] from a silent line, D at a time."""
    T = x.shape[-1]
    g = f32(decay)
    parts, prev = [], None
    for k in range(0, T, D):
        c = x[..., k:k + D]
        if prev is not None:
            c = c + g * prev[..., :c.shape[-1]]
        parts.append(c)
        prev = c
    return torch.cat(parts, dim=-1)


def envelope_gain(frames) -> float:
    """dasp_envelope's gain of a time in frames, as f32."""
    n = F32(frames)
    return 0.0 if n == F32(0.0) else float(F32(np.exp(F32(-1.0) / n)))


def envelope(x, attack, release, p: Prec, chunk: int = 16_384):
    """The peak follower (envelope.rs:43-51) from env = 0: each chunk of
    ``chunk`` samples runs from zero over the ``warm`` samples before it,
    which leave the start state's influence under 1e-18 of it."""
    atk, rel = envelope_gain(attack), envelope_gain(release)
    d = torch.abs(x)
    T = d.shape[-1]
    g_max = max(atk, rel)
    warm = (T if g_max >= 1.0 else
            min(T, math.ceil(math.log(1e-18) / math.log(max(g_max, 1e-30)))))
    nc = -(-T // chunk)
    lead = d.shape[:-1]
    dp = torch.nn.functional.pad(d, (warm, nc * chunk - T))
    # chunk c covers padded samples [c * chunk, c * chunk + warm + chunk)
    idx = (torch.arange(nc, device=d.device)[:, None] * chunk
           + torch.arange(warm + chunk, device=d.device)[None, :])
    w = dp[..., idx]                               # [..., nc, warm + chunk]
    env = torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
    out = torch.empty_like(w[..., warm:])
    for i in range(warm + chunk):
        di = w[..., i]
        g = torch.where(env < di, atk, rel)
        env = di + g * (env - di)
        if i >= warm:
            out[..., i - warm] = env
    return out.reshape(*lead, nc * chunk)[..., :T]


def lfo_sine(amplitude, frequency, T: int):
    """signal_gen.rs:57-108 in Sine mode with constant sliders, from clock
    0: per 128-block f32 phase accumulation, the sine of the f32 phase
    rounded to f32.  NumPy [T] f32."""
    step = F32(F32(frequency) / F32(48000.0))
    totals = np.empty(BUF, F32)
    acc = F32(0.0)
    for i in range(BUF):
        acc = F32(acc + step)
        totals[i] = acc
    nb = -(-T // BUF)
    clocks = np.empty(nb, F32)
    clock = F32(0.0)
    for b in range(nb):
        clocks[b] = clock
        clock = F32(np.fmod(F32(clock + totals[-1]), F32(1.0)))
    ph = ((clocks[:, None] + totals[None, :]).astype(F32)
          * F32(2 * np.pi)).astype(F32)
    s = np.sin(ph.astype(np.float64)).astype(F32)
    return (s * F32(amplitude)).astype(F32).reshape(-1)[:T]


def chorus_taps(rate, depth, base, T: int):
    """The chorus's read positions (ops/modfx.py's defined semantics: f64
    phase, f32 sine LFO, f64 tap position): (history length L, index i
    [T] int64 into [silence L, x], f32 fraction [T])."""
    L = int(np.ceil((base + depth) * SR)) + 2
    n = np.arange(T, dtype=np.float64)
    cycles = np.float64(rate) * n / SR
    phase = (cycles - np.floor(cycles)).astype(F32)
    s = np.sin((F32(2 * np.pi) * phase).astype(F32).astype(np.float64)
               ).astype(F32)
    d = (F32(base) * F32(SR) + (F32(depth) * F32(SR) * s).astype(F32)
         ).astype(F32)
    pos = np.clip((L + n) - d.astype(np.float64), 0.0, L + T - 2)
    i = np.floor(pos).astype(np.int64)
    frac = (pos - np.floor(pos)).astype(F32)
    return L, i, frac


def chorus(x, rate, depth, base, mix_, p: Prec):
    L, i, frac = chorus_taps(rate, depth, base, x.shape[-1])
    xx = torch.nn.functional.pad(x, (L, 0))
    it = torch.as_tensor(i, device=x.device)
    fr = p.t(frac)
    wet = xx[..., it] * (1.0 - fr) + xx[..., it + 1] * fr
    m = f32(mix_)
    return x * (1.0 - m) + wet * m


def catmull_rom(n: int, k_out: int) -> np.ndarray:
    """[k_out, n] weights taking values at the exponential display
    positions sqrt(i / (n - 1)) onto k_out uniform ones (Catmull-Rom,
    outer control points clamped at the edges)."""
    pos = np.sqrt(np.arange(n, dtype=np.float64) / (n - 1))
    u = np.linspace(0.0, 1.0, k_out)
    j = (np.searchsorted(pos, u, side="right") - 1).clip(0, n - 2)
    t = (u - pos[j]) / (pos[j + 1] - pos[j])
    W = np.zeros((k_out, n), np.float64)
    rows = np.arange(k_out)
    for off, wt in ((-1, 0.5 * (-t ** 3 + 2 * t ** 2 - t)),
                    (0, 0.5 * (3 * t ** 3 - 5 * t ** 2 + 2)),
                    (1, 0.5 * (-3 * t ** 3 + 4 * t ** 2 + t)),
                    (2, 0.5 * (t ** 3 - t ** 2))):
        np.add.at(W, (rows, (j + off).clip(0, n - 1)), wt)
    return W.astype(F32)


def spectrogram(x, fft_size: int, lower: float, upper: float, keep: int,
                p: Prec):
    """The spectrogram's columns (spectrogram.rs:225-269 as the port
    defines them): hann window, |rfft| / fft_size, the bins inside
    [lower, upper], tilted by sqrt(max(f, 1)) / sqrt(sr / 2), resampled
    onto the display grid; the last ``keep`` columns.  [..., n, K]."""
    n_frames = x.shape[-1] // fft_size
    frames = x[..., :n_frames * fft_size].reshape(*x.shape[:-1], n_frames,
                                                  fft_size)
    win = p.t(np.hanning(fft_size).astype(F32))
    mag = torch.abs(torch.fft.rfft(frames * win, dim=-1)) / fft_size
    freqs = np.fft.rfftfreq(fft_size, 1.0 / SR)
    kept = np.nonzero((freqs >= lower) & (freqs <= upper))[0]
    boost = np.sqrt(np.maximum(freqs[kept], 1.0).astype(F32))
    spec = (mag[..., torch.as_tensor(kept, device=mag.device)]
            * p.t(boost) / float(np.sqrt(F32(SR / 2.0))))
    W = p.t(catmull_rom(kept.size, kept.size))
    cols = p.mm(spec, W.T)
    return cols[..., -keep:, :] if keep > 0 else cols[..., :0, :]
