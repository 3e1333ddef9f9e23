"""NumPy oracle, frozen: a straight re-implementation of dsp-stuff's
per-sample f32 semantics (sequential loops, f32 arithmetic order
preserved).  Each function cites the Rust source it mirrors.  These are
deliberately slow and simple; the benchmark's tests hold the vectorised
reference (blocks.py) against them at small sizes."""

import numpy as np

F32 = np.float32
BUF = 128  # node.rs:257


def fanin_average(buffers):
    """collect_and_average (node.rs:162-194): sum connected, divide by
    0.0001 + n (f32 accumulation order)."""
    n = F32(0.0001)
    if not buffers:
        return np.zeros(0, F32)
    acc = np.zeros_like(buffers[0], dtype=F32)
    for b in buffers:
        acc = (acc + b.astype(F32)).astype(F32)
        n = F32(n + F32(1.0))
    return (acc / n).astype(F32)


def mod_map(sig, lo, hi):
    """derive lib.rs:140-148."""
    y = ((sig.astype(F32) + F32(1.0)) / F32(2.0)).astype(F32)
    z = np.clip(y, F32(0.0), F32(1.0)).astype(F32)
    return (F32(lo) + (F32(F32(hi) - F32(lo)) * z).astype(F32)).astype(F32)


# ---- stateless shapers (distort.rs) ----------------------------------------

def clip(x):
    return np.clip(x, F32(-1.0), F32(1.0)).astype(F32)


def _bypass(level, shaped, x):
    return np.where(level < F32(0.001), x, shaped).astype(F32)


def hard_clip(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    return _bypass(level, clip((x * level).astype(F32)) / level, x)


def soft_clip(x, level):
    """distort.rs:71-86.  ``powi(3)`` is LLVM repeated multiplication
    ((s*s)*s), NOT libm powf (numpy's ``**`` -- up to 1 ulp apart); and the
    branch chain sends NaN to the trailing -2/3 arm (NaN fails both the
    ``> 1.0`` test and the ``(-1.0..=1.0).contains`` test)."""
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    s = (x * level).astype(F32)
    s3 = ((s * s).astype(F32) * s).astype(F32)
    inner = (s - (s3 / F32(3.0)).astype(F32)).astype(F32)
    in_range = (s >= F32(-1.0)) & (s <= F32(1.0))
    shaped = np.where(s > F32(1.0), F32(2.0 / 3.0),
                      np.where(in_range, inner, F32(-2.0 / 3.0)))
    return _bypass(level, (clip(shaped.astype(F32)) / level).astype(F32), x)


def _t(fn, v):
    # stand-in for Rust libm f32 transcendentals (<=1 ulp): correctly
    # rounded via f64
    return fn(v.astype(np.float64)).astype(F32)


def tanh_clip(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    return _bypass(level, _t(np.tanh, (x * level).astype(F32)), x)


def recip_soft_clip(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    shaped = (np.sign(x) * (F32(1.0) - F32(1.0) /
                            ((np.abs(x) * level).astype(F32) + F32(1.0)))).astype(F32)
    return _bypass(level, shaped, x)


def sin_shape(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    return _bypass(level, _t(np.sin, (x * level).astype(F32)), x)


def atan_shape(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    return _bypass(level, _t(np.arctan, (x * level).astype(F32)), x)


def square_shape(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    v = (x * level).astype(F32)
    return _bypass(level, ((v ** 2).astype(F32) * np.sign(v)).astype(F32), x)


def chebyshev4(x, level):
    x, level = x.astype(F32), np.broadcast_to(level, x.shape).astype(F32)
    v = (x * level).astype(F32)
    v2 = (v * v).astype(F32)
    v4 = (v2 * v2).astype(F32)   # Rust powi(4) = (v*v)*(v*v)
    shaped = ((F32(8.0) * v4).astype(F32)
              - (F32(8.0) * v2).astype(F32) + F32(1.0)).astype(F32)
    return _bypass(level, shaped, x)


def fuzz_block(x, level):
    """distort.rs:146-172, one 128-sample block."""
    x = x.astype(F32)
    level = np.broadcast_to(level, x.shape).astype(F32)
    mx = F32(np.max(np.abs(x)))
    q = (clip((x * level).astype(F32)) / mx).astype(F32)
    z = (-(F32(1.0) - _t(np.exp, -np.abs(q)))).astype(F32)
    mz = F32(np.max(np.abs(z)))
    y = (clip((z * mx).astype(F32)) / mz).astype(F32)
    my = F32(np.max(np.abs(y)))
    return ((y * mx).astype(F32) / my).astype(F32)


def fuzz(x, level, block=BUF):
    out = np.empty_like(x, dtype=F32)
    level = np.broadcast_to(level, x.shape).astype(F32)
    for i in range(0, len(x), block):
        out[i:i + block] = fuzz_block(x[i:i + block], level[i:i + block])
    return out


def overdrive(x, boost, drive, level):
    """overdrive.rs:31-43."""
    x = x.astype(F32)
    boost = np.broadcast_to(boost, x.shape).astype(F32)
    drive = np.broadcast_to(drive, x.shape).astype(F32)
    level = np.broadcast_to(level, x.shape).astype(F32)
    a = (x * boost).astype(F32)
    b = (F32(np.pi / 4.0) * a).astype(F32)
    c = _t(np.arctan, b)
    d = (F32(2.0 / np.pi) * c).astype(F32)
    mix = ((drive * d).astype(F32) + ((F32(1.0) - drive) * x).astype(F32)).astype(F32)
    return np.where(level < F32(0.001), x, (mix * level).astype(F32))


def chebyshev_asym(x, level_pos, level_neg):
    """chebyshev.rs:28-42."""
    x = x.astype(F32)
    lp, ln = F32(level_pos), F32(level_neg)
    pos = x if lp < F32(0.001) else \
        (_t(np.tanh, (x * lp).astype(F32)) / F32(np.tanh(np.float64(lp)))).astype(F32)
    neg = x if ln < F32(0.001) else \
        (_t(np.tanh, (x * ln).astype(F32)) / F32(np.tanh(np.float64(ln)))).astype(F32)
    return np.where(x >= F32(0.0), pos, neg).astype(F32)


# ---- stateful filters ------------------------------------------------------

def low_pass(x, ratio, z=F32(0.0)):
    """low_pass.rs:36-41 sequential."""
    x = x.astype(F32)
    ratio = F32(ratio)
    one_minus = F32(F32(1.0) - ratio)
    out = np.empty_like(x)
    z = F32(z)
    for i, v in enumerate(x):
        y = F32(F32(v * one_minus) + F32(ratio * z))
        out[i] = y
        z = y
    return out, z


def high_pass(x, ratio, z=F32(0.0)):
    """high_pass.rs:36-41 sequential."""
    x = x.astype(F32)
    ratio = F32(ratio)
    one_minus = F32(F32(1.0) - ratio)
    out = np.empty_like(x)
    z = F32(z)
    for i, v in enumerate(x):
        z = F32(F32(v * one_minus) + F32(ratio * z))
        out[i] = F32(v - z)
    return out, z


def biquad_df1(x, a0, a1, a2, b0, b1, b2, state=None):
    """biquad crate DirectForm1 with coefficients / a0 (biquad.rs:62-89)."""
    x = x.astype(F32)
    a0 = F32(a0)
    a1, a2 = F32(F32(a1) / a0), F32(F32(a2) / a0)
    b0, b1, b2 = F32(F32(b0) / a0), F32(F32(b1) / a0), F32(F32(b2) / a0)
    x1, x2, y1, y2 = state or (F32(0), F32(0), F32(0), F32(0))
    out = np.empty_like(x)
    for i, v in enumerate(x):
        y = F32(F32(F32(F32(F32(b0 * v) + F32(b1 * x1)) + F32(b2 * x2))
                    - F32(a1 * y1)) - F32(a2 * y2))
        out[i] = y
        x2, x1, y2, y1 = x1, F32(v), y1, y
    return out, (x1, x2, y1, y2)


def envelope(x, attack_frames, release_frames, env=F32(0.0)):
    """dasp_envelope peak detector (envelope.rs:43-51)."""
    def gain(n):
        n = F32(n)
        return F32(0.0) if n == F32(0.0) else F32(np.exp(F32(-1.0) / n))
    atk, rel = gain(attack_frames), gain(release_frames)
    x = x.astype(F32)
    out = np.empty_like(x)
    env = F32(env)
    for i, v in enumerate(x):
        d = F32(abs(v))
        g = atk if env < d else rel
        env = F32(d + F32(g * F32(env - d)))
        out[i] = env
    return out, env


def fir(x, taps_rev, mode="Balanced", state=None):
    """fir.rs:179-225: VecDeque warm-up + f64 accumulate."""
    taps = np.asarray(taps_rev, np.float64)
    n = len(taps)
    divisor = F32(1.0 / n) if mode == "Average" else F32(1.0)
    from collections import deque
    state = state if state is not None else deque()
    out = np.empty_like(x, dtype=F32)
    for i, v in enumerate(x.astype(F32)):
        state.append(np.float64(v))
        if len(state) > n:
            state.popleft()
        acc = np.float64(0.0)
        for s, t in zip(state, taps):
            acc += s * t
        out[i] = F32(F32(acc) * divisor)
    return out, state


def reverb(x, seconds, decay, ring=None):
    """reverb.rs:76-111: y[n] = x[n] + decay*y[n-D], D zeros pre-fill."""
    D = max(int(F32(seconds) * F32(48000.0)), 128)
    decay = F32(decay)
    x = x.astype(F32)
    if ring is None:
        ring = np.zeros(D, F32)
    from collections import deque
    hist = deque(ring)
    out = np.empty_like(x)
    for i, v in enumerate(x):
        delayed = hist.popleft()
        y = F32(v + F32(delayed * decay))
        out[i] = y
        hist.append(y)
    return out, np.asarray(hist, F32)


def signal_gen(mode, amplitude, frequency, T, clock=F32(0.0), block=BUF):
    """signal_gen.rs:57-108 with per-block f32 phase accumulation."""
    amplitude = np.broadcast_to(amplitude, (T,)).astype(F32)
    frequency = np.broadcast_to(frequency, (T,)).astype(F32)
    out = np.empty(T, F32)
    clock = F32(clock)
    sr = F32(48000.0)
    for b0 in range(0, T, block):
        total = F32(0.0)
        for i in range(b0, min(b0 + block, T)):
            step = F32(frequency[i] / sr)
            total = F32(total + step)
            if mode == "Sine":
                # f64-rounded sin (the <=1-ulp transcendental convention,
                # see _t): numpy's own f32 sin is a different 1-ulp-class
                # value than XLA's, and chorus-rate modulation amplifies
                # that ulp past the graph parity budget
                s = _t(np.sin, F32(F32(clock + total) * F32(2 * np.pi)))
                out[i] = F32(s * amplitude[i])
            elif mode == "Triangle":
                out[i] = F32((F32(2.0) * F32(np.fmod(F32(clock + total), F32(1.0)))
                              - F32(1.0)) * amplitude[i])
            elif mode == "Square":
                out[i] = F32((F32(1.0) if total > F32(0.5) else F32(-1.0))
                             * amplitude[i])
            elif mode == "Constant":
                out[i] = amplitude[i]
        clock = F32(np.fmod(F32(clock + total), F32(1.0)))
    return out, clock


def chorus(x, rate, depth, base, mix, hist=None, t0=0, sr=48000):
    """NumPy mirror of the chorus extension's defined semantics
    (ops/modfx.py modulated_delay: f64 phase reduction, f32 sin LFO,
    f64 tap position, f32 linear interpolation).  No reference analog —
    this pins OUR extension, independently of the JAX implementation."""
    x = x.astype(F32)
    T = len(x)
    L = int(np.ceil((base + depth) * sr)) + 2
    if hist is None:
        hist = np.zeros(L, F32)
    xx = np.concatenate([hist.astype(F32), x])
    t_abs = np.float64(t0) + np.arange(T, dtype=np.float64)
    cycles = np.float64(rate) * t_abs / sr
    phase = (cycles - np.floor(cycles)).astype(F32)
    d = (F32(base) * F32(sr)
         + (F32(depth) * F32(sr)
            * _t(np.sin, (F32(2 * np.pi) * phase).astype(F32))).astype(F32)
         ).astype(F32)
    pos = (L + np.arange(T, dtype=np.float64)) - d.astype(np.float64)
    pos = np.clip(pos, 0.0, L + T - 2)
    i = np.floor(pos).astype(np.int64)
    frac = (pos - np.floor(pos)).astype(F32)
    wet = (xx[i] * (F32(1.0) - frac) + xx[i + 1] * frac).astype(F32)
    y = (x * (F32(1.0) - F32(mix)) + wet * F32(mix)).astype(F32)
    return y, xx[-L:], t0 + T


def max_err_dbfs(a, b):
    """20*log10(max |a-b|); -inf when identical."""
    err = np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
    if err == 0:
        return -np.inf
    return 20.0 * np.log10(err)
