// oscillator_ops.cuh -- what the oscillator kernel (oscillator_kernel.cu)
// and its reverse (oscillator_reverse_kernel.cu) share: the block, the
// modes, the eager code's constants and torch.remainder(x, 1).
#pragma once

#define OSC_BLOCK 128              // the reference's block (node.rs:257)

#define OSC_SINE 0
#define OSC_TRIANGLE 1
#define OSC_SQUARE 2
#define OSC_CONSTANT 3

// float32(2 pi), 2 pi and 1 / (2 pi) in f64 (the eager code's constants)
#define OSC_TAU 0x1.921fb6p+2f
#define OSC_TWO_PI 0x1.921fb54442d18p+2
#define OSC_INV_TWO_PI 0x1.45f306dc9c883p-3

// torch.remainder(x, 1): fmod(x, 1) = x - trunc(x), exact for every finite
// x, with the sign of x when it is 0 (copysign); then + 1 (rounded) where
// it is negative.  inf and NaN give NaN, as fmod does.
__device__ __forceinline__ float osc_rem1(float x) {
  float m = copysignf(__fsub_rn(x, truncf(x)), x);
  return m < 0.0f ? __fadd_rn(m, 1.0f) : m;
}
__device__ __forceinline__ double osc_rem1(double x) {
  double m = copysign(__dsub_rn(x, trunc(x)), x);
  return m < 0.0 ? __dadd_rn(m, 1.0) : m;
}


// Lane L's in-block totals (samples 4L .. 4L + 3 of a 128-sample block),
// the block's steps in shared memory `sm` and its own in s: the steps of
// the lanes before it in order from 0, then its own, one f32 add each
// (bitwise the plain version's sequential sum).
__device__ __forceinline__ void osc_totals(const float* sm, int lane,
                                           const float (&s)[4],
                                           float (&tot)[4]) {
  float acc = 0.0f;
  for (int q = 0; q < lane; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(sm + 4 * q);
    acc = __fadd_rn(acc, v.x);
    acc = __fadd_rn(acc, v.y);
    acc = __fadd_rn(acc, v.z);
    acc = __fadd_rn(acc, v.w);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) tot[j] = acc = __fadd_rn(acc, s[j]);
}
