"""McLeod Pitch Method (MPM) -- batch analog of the Pitch node.

The reference accumulates 1024-sample windows (hop 1024) in a ring and runs
``pitch_detection::McLeodDetector::new(1024, 512)`` with power/clarity/pick
thresholds (pitch.rs:115-147).  MPM computes the normalized square
difference function

    nsdf[tau] = 2 * acf[tau] / m[tau]
    acf[tau]  = sum_j x[j] * x[j+tau]
    m[tau]    = sum_j (x[j]^2 + x[j+tau]^2)

picks key maxima between positive-going zero crossings, takes the first
peak above ``pick_threshold * max_peak``, refines it with parabolic
interpolation, and reports frequency = sr / tau and clarity = peak value,
gated on signal power and clarity thresholds.

All windows of all streams run at once on the tensor's device: the
autocorrelation by torch.fft (cuFFT on the card), each zero-crossing
interval's maximum by a scatter_reduce over interval ids, the first
qualifying peak by an argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.precision import scalar_on


def nsdf(x: torch.Tensor) -> torch.Tensor:
    """x [..., W] -> nsdf [..., W//2] via FFT autocorrelation."""
    W = x.shape[-1]
    X = torch.fft.rfft(x, n=2 * W)
    acf = torch.fft.irfft(X * torch.conj(X), n=2 * W)[..., : W // 2]
    # m[tau] = sum_{j<W-tau} x[j]^2 + sum_{j>=tau} x[j]^2
    c = torch.cumsum(x * x, dim=-1)
    tau = torch.arange(W // 2, device=x.device)
    head = c[..., W - 1 - tau]
    cpad = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    m = head + (c[..., -1:] - cpad[..., tau])
    return torch.where(m > 0, 2.0 * acf / m, 0.0)


def _interval_max(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each position's maximum of ``d`` over the positions that share its
    interval id (ids ascending along the last axis)."""
    L = d.shape[-1]
    flat, fid = d.reshape(-1, L), ids.reshape(-1, L)
    mx = torch.full((flat.shape[0], L + 1), -np.inf, dtype=d.dtype,
                    device=d.device)
    mx = mx.scatter_reduce(1, fid, flat, reduce="amax", include_self=True)
    return mx.gather(1, fid).reshape(d.shape)


def detect_pitch(x, sample_rate: int = 48_000, power_threshold: float = 0.5,
                 clarity_threshold: float = 0.5, pick_threshold: float = 0.5,
                 window: int = 1024):
    """x [..., T] -> dict of per-window pitch tracks.

    Returns {"frequency": [..., n_win], "clarity": [..., n_win],
             "voiced": bool [..., n_win], "note_nr": int32 [..., n_win]}
    with hop == window (the node's read-1024 / release-1024 cycle,
    pitch.rs:120-139)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n_win = x.shape[-1] // window
    if n_win == 0:
        # shorter than a window (a stream block): no window to detect in,
        # and no FFT of an empty batch
        z = torch.zeros((*x.shape[:-1], 0), dtype=torch.float32,
                        device=x.device)
        return {"frequency": z, "clarity": z.clone(),
                "voiced": z.to(torch.bool), "note_nr": z.to(torch.int32)}
    xw = x[..., : n_win * window].reshape(*x.shape[:-1], n_win, window)
    d = nsdf(xw)                                            # [..., n_win, W/2]
    W2 = d.shape[-1]

    # MPM key maxima: ONE candidate per interval between positive-going
    # zero crossings, the interval's maximum (taking every local max lets
    # a sub-peak ripple win "first above threshold" and report a sharp
    # pitch).  An interval starts where d rises through zero; its id is the
    # count of such crossings so far.
    rising = (d[..., 1:] > 0) & (d[..., :-1] <= 0)          # crossing before t+1
    ids = torch.cumsum(rising.to(torch.int64), dim=-1)
    started = ids > 0
    dpad = d[..., 1:]
    region_max = _interval_max(dpad, ids)

    is_peak = torch.zeros_like(dpad, dtype=torch.bool)
    is_peak[..., 1:-1] = ((dpad[..., 1:-1] > dpad[..., :-2])
                          & (dpad[..., 1:-1] >= dpad[..., 2:]))
    is_peak = is_peak & started & (dpad == region_max)

    peaks = torch.where(is_peak, dpad, -np.inf)
    max_peak = peaks.amax(dim=-1, keepdim=True)
    candidates = torch.where(peaks >= pick_threshold * max_peak, peaks,
                             -np.inf)
    # the first qualifying peak (argmax returns the first maximum)
    first_idx = torch.argmax((candidates > -np.inf).to(torch.int8), dim=-1)
    tau0 = first_idx + 1                                     # offset from slice
    val = d.gather(-1, tau0[..., None])[..., 0]

    # parabolic interpolation around tau0
    ym = d.gather(-1, torch.clamp(tau0 - 1, 0, W2 - 1)[..., None])[..., 0]
    yp = d.gather(-1, torch.clamp(tau0 + 1, 0, W2 - 1)[..., None])[..., 0]
    denom = ym - 2.0 * val + yp
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
    tau_ref = tau0.to(torch.float32) + shift
    freq = (scalar_on(float(sample_rate), x.device)
            / torch.clamp(tau_ref, min=1.0))

    power = torch.sum(xw * xw, dim=-1)
    voiced = (is_peak.any(dim=-1) & (power >= power_threshold)
              & (val >= clarity_threshold))
    freq_out = torch.where(voiced, freq, 0.0)
    return {"frequency": freq_out,
            "clarity": torch.where(voiced, val, 0.0),
            "voiced": voiced,
            "note_nr": torch.where(voiced, freq_to_note_nr(freq_out), 0)}


# -- note-name readout (the reference's instrument display) -------------------
#
# pitch.rs:61-74 maps frequency -> rust-music-theory Note:
#     note_nr(Note) = pitch_class u8 + 12 * octave      (C = 0 .. B = 11)
#     freq_to_note(f) = from_note_nr(
#         ((12 * log2(f / 440)) as i16 + 57) as u8)     (A4 = nr 57)
# Two quirks are load-bearing for parity: the Rust `as i16` cast TRUNCATES
# TOWARD ZERO (466.16 Hz is +99.97 cents above A4 and still displays "A 4";
# only >= +100 cents reaches A#), and the `as u8` cast wraps mod 256 for
# sub-16.35 Hz detections.  ``nearest=True`` is the extension musicians
# expect (round to the closest note + signed cent offset).

NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F",
              "F#", "G", "G#", "A", "A#", "B")
_A4_NR = 57        # note_nr(Note::new(PitchClass::A, 4)), pitch.rs:72


def freq_to_note_nr(freq, nearest: bool = False) -> torch.Tensor:
    """freq [..] -> int32 note number (C0 = 0, A4 = 57), reference
    semantics, in freq's dtype (f32 tensors, f64 host scalars).  freq <= 0
    maps to 0 (callers mask with ``voiced``)."""
    freq = torch.as_tensor(freq)
    safe = torch.where(freq > 0, freq, 440.0)
    steps = 12.0 * torch.log2(safe / scalar_on(440.0, freq.device))
    stepi = torch.round(steps) if nearest else torch.trunc(steps)
    nr = stepi.to(torch.int32) + _A4_NR
    return torch.where(freq > 0, nr & 0xFF, 0).to(torch.int32)   # the u8 wrap


def note_name(nr) -> str:
    """Note number -> the display string of pitch.rs:84 ("A 4")."""
    nr = int(nr)
    return f"{NOTE_NAMES[nr % 12]} {nr // 12}"


def describe_pitch(freq, nearest: bool = False):
    """Host-side readout for one frequency: (name, octave, cents).

    ``cents`` is the signed offset of ``freq`` from the reported note
    (for the default truncating map it lies in (-100, 100); with
    ``nearest=True`` in [-50, 50])."""
    freq = float(freq)
    if freq <= 0:
        return ("", 0, 0.0)
    nr = int(freq_to_note_nr(np.float64(freq), nearest=nearest))
    cents = 1200.0 * np.log2(freq / 440.0) - 100.0 * (nr - _A4_NR)
    return (f"{NOTE_NAMES[nr % 12]} {nr // 12}", nr // 12, float(cents))
