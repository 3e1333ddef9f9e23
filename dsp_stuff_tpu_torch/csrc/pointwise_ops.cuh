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

// torch.clamp with constant bounds: NaN propagates
__device__ __forceinline__ float pw_clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ double pw_clamp(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
