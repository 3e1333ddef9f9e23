"""The reverse pointwise kernel's divides by a uniform divisor
(csrc/pointwise_ops.cuh: ``pw_recip``, ``pw_div``, ``pw_div_pow2``) on the
CPU, where CUDA cannot run: a NumPy model of each, its fma exact (the
product and the sum taken exactly, rounded once), held bitwise against
NumPy's IEEE division, float32 over every significand against a few
divisors and random pairs from every binade, float64 on random pairs,
with NaN, +-inf, +-0, subnormals and values near overflow planted.  The
model's constants are the header's (pinned by regex), and the exact fma
is held against rational arithmetic.  chip_smoke.py holds the CUDA helper
itself against ``__fdiv_rn`` over all 2^32 float32 dividends.
"""

import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest

F32, F64 = np.float32, np.float64

HEADER = (pathlib.Path(__file__).resolve().parent.parent
          / "dsp_stuff_tpu_torch" / "csrc" / "pointwise_ops.cuh")

#: the fast path's bounds (pointwise_ops.cuh): |d| in [D_LO, D_HI), |a| in
#: [A_LO, A_HI) or 0, by dtype
BOUNDS = {F32: (2.0**-24, 2.0**24, 2.0**-64, 2.0**64),
          F64: (2.0**-64, 2.0**64, 2.0**-512, 2.0**512)}


# -- an exact fma -------------------------------------------------------------

def fma32(x, y, z):
    """RN32(x * y + z) for float32 arrays, exactly: the product is exact in
    float64, the sum is split exactly into s + t (TwoSum), and s + t rounds
    to float32 as s does unless s lies on a float32 midpoint, where t's
    sign decides."""
    x, y, z = (np.asarray(v, F32) for v in (x, y, z))
    with np.errstate(all="ignore"):
        p = x.astype(F64) * y.astype(F64)
        s = p + z.astype(F64)
        bp = s - p
        t = (p - (s - bp)) + (z.astype(F64) - bp)
        c = s.astype(F32)
        c64 = c.astype(F64)
        toward = np.where(s > c64, F32(np.inf), F32(-np.inf))
        other = np.nextafter(c, toward)
        mid = (c64 + other.astype(F64)) / 2
        tie = (s != c64) & (s == mid) & (t != 0) & np.isfinite(s)
        up = np.sign(t) == np.sign(other.astype(F64) - c64)
        t = np.where(np.isfinite(s), t, 0.0)
    return np.where(tie & up, other, c).astype(F32)


def _rn64(q: Fraction) -> float:
    return float(q)              # int / int: correctly rounded in CPython


def fma64(x: float, y: float, z: float) -> float:
    """RN64(x * y + z) of Python floats by rational arithmetic rounded once
    (finite operands; the zero's sign by IEEE's rules)."""
    exact = Fraction(x) * Fraction(y) + Fraction(z)
    if exact == 0:
        neg = np.signbit(x) != np.signbit(y)
        return -0.0 if (neg and np.signbit(z) and x * y == 0) else 0.0
    return _rn64(exact)


# -- the model of pointwise_ops.cuh -------------------------------------------

def recip(d, dt=F32):
    """pw_recip: (d, r = RN(1/d), lo = RN(RN(1 - d r) r), whether d is in
    the fast path's range)."""
    d = dt(d)
    d_lo, d_hi, _, _ = BOUNDS[dt]
    with np.errstate(all="ignore"):
        r = dt(1) / d
        if dt == F32:
            lo = (fma32(-d, r, F32(1)) * r).astype(F32)
        else:
            lo = (F64(fma64(-float(d), float(r), 1.0)) * r
                  if np.isfinite(r) and np.isfinite(d) else F64(np.nan))
    m = abs(float(d))
    return d, r, lo, bool(d_lo <= m < d_hi)


def div32(a, R):
    """pw_div over a float32 array ``a`` by the divisor of ``R`` (recip)."""
    d, r, lo, ok = R
    a = np.asarray(a, F32)
    _, _, a_lo, a_hi = BOUNDS[F32]
    m = np.abs(a)
    fast = ok & (m >= a_lo) & (m < a_hi)
    with np.errstate(all="ignore"):
        q0 = fma32(a, r, (a * lo).astype(F32))
        q = fma32(fma32(-d, q0, a), r, q0)
        zero = (a * r).astype(F32)
        slow = a / d
    return np.where(fast, q, np.where(ok & (m == 0), zero, slow)).astype(F32)


def div64(a: float, R) -> float:
    """pw_div of one float64 dividend."""
    d, r, lo, ok = R
    _, _, a_lo, a_hi = BOUNDS[F64]
    m = abs(a)
    if ok and a_lo <= m < a_hi:
        d, r, lo = float(d), float(r), float(lo)
        q0 = fma64(a, r, a * lo)
        return fma64(fma64(-d, q0, a), r, q0)
    with np.errstate(all="ignore"):
        return float(F64(a) * r) if ok and m == 0 else float(F64(a) / d)


def same_bits(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all((got.view(np.uint32 if got.dtype == F32 else np.uint64)
                        == want.view(np.uint32 if want.dtype == F32
                                     else np.uint64))
                       | (np.isnan(got) & np.isnan(want))))


# -- the tests ----------------------------------------------------------------

def test_model_bounds_are_the_headers():
    src = HEADER.read_text()
    for line in ("return {d, r, __fmul_rn(__fmaf_rn(-d, r, 1.0f), r),",
                 "m >= 0x1p-24f && m < 0x1p24f};",
                 "return {d, r, __dmul_rn(__fma_rn(-d, r, 1.0), r),",
                 "m >= 0x1p-64 && m < 0x1p64};",
                 "const float m = fabsf(d), r = __frcp_rn(d);",
                 "const double m = fabs(d), r = __drcp_rn(d);",
                 "if (R.ok && m >= 0x1p-64f && m < 0x1p64f) {",
                 "if (R.ok && m >= 0x1p-512 && m < 0x1p512) {",
                 "const float q0 = __fmaf_rn(a, R.r, __fmul_rn(a, R.lo));",
                 "return __fmaf_rn(__fmaf_rn(-R.d, q0, a), R.r, q0);",
                 "const double q0 = __fma_rn(a, R.r, __dmul_rn(a, R.lo));",
                 "return __fma_rn(__fma_rn(-R.d, q0, a), R.r, q0);",
                 "return R.ok && m == 0.0f ? __fmul_rn(a, R.r) : "
                 "__fdiv_rn(a, R.d);",
                 "return R.ok && m == 0.0 ? __dmul_rn(a, R.r) : "
                 "__ddiv_rn(a, R.d);",
                 "return __fmul_rn(a, inv);"):
        assert line in src, line
    assert re.search(r"pw_div_pow2\(float a, float inv\)", src)


def test_exact_fma_is_rational_arithmetic():
    """fma32 against Fractions rounded once (through float64, which holds
    every float32 midpoint exactly), on random triples whose product and
    addend cancel, and on planted ties."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(3000) * 2.0 ** rng.integers(-20, 20, 3000)
         ).astype(F32)
    y = (rng.standard_normal(3000) * 2.0 ** rng.integers(-20, 20, 3000)
         ).astype(F32)
    z = (-(x.astype(F64) * y) * (1 + rng.standard_normal(3000) * 1e-6)
         ).astype(F32)
    z[::3] = rng.standard_normal(1000).astype(F32)
    # ties: (1 + 2^-23) * 2^-24 (1 - 2^-23) + (1 + 2^-23) lies 2^-70 below
    # the midpoint that float64 rounds it to, where ties-to-even goes up
    one = F32(1 + 2.0**-23)
    tie = (one, F32(2.0**-24 * (1 - 2.0**-23)), one)
    for k, (sx, sz) in enumerate(((1, 1), (-1, -1), (1, 1))):
        x[k], y[k], z[k] = sx * tie[0], tie[1] * 2.0**(-k), sz * tie[2]
    got = fma32(x, y, z)
    for i in range(len(x)):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(
            float(z[i]))
        want = _f32_of(exact)
        assert same_bits(got[i:i + 1], np.asarray([want], F32)), i


def _f32_of(q: Fraction) -> np.float32:
    """RN32 of a rational, by comparing with the midpoint of the two
    float32 neighbours of its float64 rounding."""
    if q == 0:
        return F32(0.0)
    c = F32(float(q))
    lo, hi = sorted((c, np.nextafter(c, F32(np.inf if Fraction(float(c)) < q
                                                 else -np.inf))))
    flo, fhi = Fraction(float(lo)), Fraction(float(hi))
    if q <= flo:
        return lo
    if q >= fhi:
        return hi
    mid = (flo + fhi) / 2
    if q != mid:
        return lo if q < mid else hi
    return lo if int(lo.view(np.uint32)) % 2 == 0 else hi


def _divisors(rng, n):
    """n divisors: random significands at exponents inside and outside the
    fast path's range, both signs."""
    sig = rng.uniform(1.0, 2.0, n)
    e = rng.integers(-30, 30, n)
    return (np.where(rng.random(n) < 0.5, -1.0, 1.0) * sig * 2.0 ** e
            ).astype(F32)


SPECIAL32 = np.asarray(
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754942e-38,
     1.1754944e-38, 3.4028235e38, -3.4028235e38, 3e38, 2.0**64, 2.0**-64,
     np.nextafter(F32(2.0**64), F32(0)), np.nextafter(F32(2.0**-64), F32(0)),
     1.0, -1.0, 3.0], F32)


def test_a_rounded_reciprocal_alone_is_not_faithful():
    """Why pw_recip keeps a second part lo: q0 = RN(a RN(1/d)) can be off
    by more than an ulp (its remainder a - d q0 then needs more than 24
    bits), so one Markstein step from it has no proof; with lo it is
    faithful over every significand (the remainder exact)."""
    d = F32(1.7294966)
    _, r, lo, _ = recip(d)
    a = (np.arange(2**23, dtype=np.uint32) | np.uint32(127 << 23)).view(F32)
    for q0, inexact in (((a * r).astype(F32), True),
                        (fma32(a, r, (a * lo).astype(F32)), False)):
        rem = a.astype(F64) - F64(d) * q0.astype(F64)    # exact in float64
        assert bool(np.any(rem.astype(F32).astype(F64) != rem)) == inexact


@pytest.mark.parametrize("d", [3.0, 1.0001, 0.001, -0.8, 1.7294966,
                               2.0**24 * 0.99999994])
def test_f32_every_significand(d):
    """pw_div by d over every float32 significand (in [1, 2)), every 16th
    at two more exponents (the quotient crossing a binade both ways), and
    the specials: bitwise IEEE division."""
    R = recip(d)
    base = (np.arange(2**23, dtype=np.uint32) | np.uint32(127 << 23)).view(F32)
    for scale, step in ((1.0, 1), (2.0**-40, 16), (2.0**50, 16)):
        for lo in range(0, 2**23, 2**21):
            a = (base[lo:lo + 2**21:step] * F32(scale)).astype(F32)
            with np.errstate(all="ignore"):
                assert same_bits(div32(a, R), a / R[0]), (d, scale)
    with np.errstate(all="ignore"):
        assert same_bits(div32(SPECIAL32, R), SPECIAL32 / R[0])


def test_f32_random_pairs_every_binade():
    """Random float32 bit patterns for dividends (every binade, subnormals,
    NaN and inf among them) against 64 divisors in and out of range, and
    the planted special divisors: bitwise IEEE division."""
    rng = np.random.default_rng(2)
    ds = np.concatenate([_divisors(rng, 64), SPECIAL32])
    for d in ds:
        a = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(
            np.uint32).view(F32)
        a = np.concatenate([a, SPECIAL32])
        with np.errstate(all="ignore"):
            assert same_bits(div32(a, recip(d)), a / F32(d)), d


def test_f64_random_pairs():
    """Random float64 pairs (significands at exponents inside and outside
    the range, and the specials) through pw_div's float64 model: bitwise
    IEEE division."""
    rng = np.random.default_rng(3)
    n = 1500
    a = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-600, 600, n)
    a *= np.where(rng.random(n) < 0.5, -1.0, 1.0)
    d = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-80, 80, n)
    d *= np.where(rng.random(n) < 0.5, -1.0, 1.0)
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 2.2e-308,
                1.7e308, 2.0**512, 2.0**-512, 3.0]
    pairs = list(zip(a, d)) + [(s, 3.0) for s in specials] + [
        (1.5, s) for s in specials]
    for x, y in pairs:
        R = recip(y, F64)
        with np.errstate(all="ignore"):
            want = F64(x) / F64(y)
        got = F64(div64(float(x), R))
        assert same_bits(np.asarray([got]), np.asarray([want])), (x, y)


@pytest.mark.parametrize("dt", [F32, F64])
def test_power_of_two_divisor_is_a_product(dt):
    """pw_div_pow2: the product by 2^-k is the quotient by 2^k, bitwise,
    for random bit patterns (subnormal results included)."""
    rng = np.random.default_rng(4)
    if dt == F32:
        a = rng.integers(0, 2**32, 400_000, dtype=np.uint64).astype(
            np.uint32).view(F32)
    else:
        a = rng.integers(0, 2**63, 400_000, dtype=np.int64).view(F64)
    for k in (1, -1, 3, 20):
        c = dt(2.0**k)
        with np.errstate(all="ignore"):
            assert same_bits((a * (dt(1) / c)).astype(dt), a / c), k
