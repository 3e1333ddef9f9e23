// pointwise_ops.cuh -- the operations the generated pointwise programs
// call beside the rounded intrinsics, shared by the pointwise kernel
// (pointwise_kernel.cu) and its reverse (pointwise_reverse_kernel.cu).
// Each keeps torch's NaN and signed-zero rules.
#pragma once

// torch.sign: (0 < v) - (v < 0), so NaN and -0 give +0
__device__ __forceinline__ float pw_sign(float v) {
  return (float)((0.0f < v) - (v < 0.0f));
}
__device__ __forceinline__ double pw_sign(double v) {
  return (double)((0.0 < v) - (v < 0.0));
}

// A divisor that depends on scalar operands alone, made opaque where it is
// used, so that the divide stays at its use (the same div.rn rounding):
// left loop-invariant, the compiled divide of a float4 unit by it took
// about twice the time of a divide by a value loaded in the loop (PERF.md
// section 6, row 7).
__device__ __forceinline__ float pw_fresh(float v) {
  asm volatile("" : "+f"(v));
  return v;
}
__device__ __forceinline__ double pw_fresh(double v) {
  asm volatile("" : "+d"(v));
  return v;
}

// A divide by a uniform divisor d through its reciprocal, computed once a
// thread (pw_recip), bitwise __fdiv_rn (__ddiv_rn) for every dividend a.
// With p the precision (24, 53), u = 2^-p and E(x) the exponent of x
// (2^E(x) <= |x| < 2^(E(x)+1)), pw_recip takes r = RN(1/d) (rcp.rn) and
// lo = RN(RN(1 - d r) r), and the fast path
//   q0 = RN(a r + RN(a lo)),  q = RN(q0 + (a - d q0) r)
// (a product and three fmas, each one rounding), where z = a/d:
//  1. r is a faithful 1/d, so 1 - d r is exact in one float (the remainder
//     lemma), and lo = (1/d - r)(1 + e), |e| < 2.01 u, with |1/d - r| <=
//     u |1/d|: r + lo = (1/d)(1 + t), |t| < 2.01 u^2;
//  2. a r + RN(a lo) lies within 3.1 u^2 |z| < 3.1 u ulp(z) of z (RN(a lo)
//     adds u |a lo| <= 1.01 u^2 |z|, or 2^-150 (2^-1075) where a lo is
//     subnormal, under 2^-38 ulp(z) in the bounds below): no float lies
//     between it and z but one that close to z, so q0 = RN(it) is a
//     neighbour of z (faithful);
//  3. q0 faithful makes a - d q0 exact in one float (its bits span less
//     than p places above 2^(E(d) + E(q0) - 2p + 2) >= 2^(E(a) - 2p),
//     normal in the bounds below), and with r = RN(1/d), Markstein's
//     theorem (IBM J. Res. Dev. 34(1), 1990, Thm. 1) gives
//     RN(q0 + (a - d q0) r) = RN(z).
// Bounds that keep every step normal and finite (z's exponent then lies in
// [-88, 87] for f32, [-576, 575] for f64): 2^-24 <= |d| < 2^24 (f64 2^-64,
// 2^64), decided once a thread, and 2^-64 <= |a| < 2^64 (f64 2^-512,
// 2^512), two compares an element.  a = +-0 gives RN(a r), the zero of the
// quotient's sign; any other a or d (NaN, +-inf, subnormal, out of range)
// takes __fdiv_rn (__ddiv_rn) itself.  A divisor that varies by element
// stays __fdiv_rn.  chip_smoke.py holds pw_div to __fdiv_rn over all 2^32
// f32 dividends (and to __ddiv_rn on random f64 pairs):
// csrc/pointwise_divide_check.cu.
struct PwRecip {
  float d, r, lo;
  bool ok;
};
struct PwRecip64 {
  double d, r, lo;
  bool ok;
};
__device__ __forceinline__ PwRecip pw_recip(float d) {
  const float m = fabsf(d), r = __frcp_rn(d);
  return {d, r, __fmul_rn(__fmaf_rn(-d, r, 1.0f), r),
          m >= 0x1p-24f && m < 0x1p24f};
}
__device__ __forceinline__ PwRecip64 pw_recip(double d) {
  const double m = fabs(d), r = __drcp_rn(d);
  return {d, r, __dmul_rn(__fma_rn(-d, r, 1.0), r),
          m >= 0x1p-64 && m < 0x1p64};
}
__device__ __forceinline__ float pw_div(float a, const PwRecip& R) {
  const float m = fabsf(a);
  if (R.ok && m >= 0x1p-64f && m < 0x1p64f) {
    const float q0 = __fmaf_rn(a, R.r, __fmul_rn(a, R.lo));
    return __fmaf_rn(__fmaf_rn(-R.d, q0, a), R.r, q0);
  }
  return R.ok && m == 0.0f ? __fmul_rn(a, R.r) : __fdiv_rn(a, R.d);
}
__device__ __forceinline__ double pw_div(double a, const PwRecip64& R) {
  const double m = fabs(a);
  if (R.ok && m >= 0x1p-512 && m < 0x1p512) {
    const double q0 = __fma_rn(a, R.r, __dmul_rn(a, R.lo));
    return __fma_rn(__fma_rn(-R.d, q0, a), R.r, q0);
  }
  return R.ok && m == 0.0 ? __dmul_rn(a, R.r) : __ddiv_rn(a, R.d);
}

// A divide by a constant power of two 2^k (|k| < 126): the product by its
// reciprocal 2^-k, the same exact value rounded once, so bitwise
// __fdiv_rn (__ddiv_rn) for every dividend.
__device__ __forceinline__ float pw_div_pow2(float a, float inv) {
  return __fmul_rn(a, inv);
}
__device__ __forceinline__ double pw_div_pow2(double a, double inv) {
  return __dmul_rn(a, inv);
}

// torch.amax's rule: NaN propagates (a bare fmaxf would drop it)
__device__ __forceinline__ float pw_maxn(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The max of a value over its 128-sample block (compiler/pointwise.py
// ``bmax``), in the pointwise kernel's float4 build with T % 128 == 0,
// where a warp's 32 lanes x 4 samples are one block of a row: the max of
// the lane's N samples, then over the warp by xor shuffles (every lane
// ends with it), spread over the lane's samples.  The operand is an abs
// (>= +0 or NaN), so the order of the maxima does not show in the result
// but for which NaN comes out.
template <int N>
__device__ __forceinline__ void pw_bmax(float (&m)[N], const float (&v)[N]) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = pw_maxn(r, v[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = pw_maxn(r, __shfl_xor_sync(0xffffffffu, r, o));
#pragma unroll
  for (int i = 0; i < N; ++i) m[i] = r;
}

// bmax's vjp in the reverse kernel's staged build (compiler/pointwise.py
// ``bsum`` and ``bcnt``), as pw_bmax a warp one 128-sample block of a row:
// the block's sum in float64 from +0.0 (the lane's N samples in order,
// then the warp's xor tree, lane i adding lane i + o for o = 16 .. 1),
// rounded once; the count of the block's samples where a == b.  Each
// spread over the lane's samples.
template <int N>
__device__ __forceinline__ void pw_bsum(float (&s)[N], const float (&v)[N]) {
  double r = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) r = __dadd_rn(r, (double)v[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
  const float f = __double2float_rn(r);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = f;
}
template <int N>
__device__ __forceinline__ void pw_bcnt(float (&c)[N], const float (&a)[N],
                                        const float (&b)[N]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) n += a[i] == b[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = (float)n;
}

// torch.clamp with constant bounds: NaN propagates
__device__ __forceinline__ float pw_clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ double pw_clamp(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
