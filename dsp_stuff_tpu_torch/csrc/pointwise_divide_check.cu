// pointwise_divide_check.cu -- holds the reverse pointwise kernel's divide
// by a uniform divisor (pointwise_ops.cuh: pw_recip, pw_div) to the IEEE
// divide it stands for, on the card: for each f32 divisor, every one of the
// 2^32 f32 dividends against __fdiv_rn; and n pseudo-random f64 pairs
// against __ddiv_rn.  Each counts the results whose bits differ (NaN
// included: pw_div takes __fdiv_rn itself wherever a NaN can arise) and
// keeps one such pair.  A check, run by chip_smoke.py; no model path
// launches it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pointwise_ops.cuh"

#define DC_THREADS 256

// One dividend bit pattern a step; a CTA row (blockIdx.y) a divisor.
__global__ void __launch_bounds__(DC_THREADS)
divide_check_f32(const float* ds, unsigned long long* bad,
                 unsigned long long* first) {
  const float d = ds[blockIdx.y];
  const PwRecip R = pw_recip(d);
  unsigned long long n = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * DC_THREADS;
  for (unsigned long long i = (unsigned long long)blockIdx.x * DC_THREADS +
                              threadIdx.x;
       i < (1ull << 32); i += step) {
    const float a = __uint_as_float((unsigned)i);
    const float q = pw_div(a, R);
    const float w = __fdiv_rn(a, pw_fresh(d));
    if (__float_as_uint(q) != __float_as_uint(w)) {
      ++n;
      atomicExch(first, (unsigned long long)blockIdx.y << 32 | i);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

// splitmix64: the i-th pseudo-random 64-bit word of a seed
__device__ __forceinline__ unsigned long long dc_mix(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// A random f64: three draws in four a significand at an exponent inside
// the fast path's range and around it, the fourth any bit pattern.
__device__ __forceinline__ double dc_f64(unsigned long long z, int span) {
  if ((z & 3) == 0) return __longlong_as_double((long long)dc_mix(z));
  const unsigned long long e = 1023 + (long long)((z >> 2) % (2 * span + 1)) -
                               span;
  return __longlong_as_double(
      (long long)((z & (1ull << 63)) | e << 52 | (dc_mix(z) >> 12)));
}

__global__ void __launch_bounds__(DC_THREADS)
divide_check_f64(unsigned long long n_pairs, unsigned long long seed,
                 unsigned long long* bad, unsigned long long* first) {
  unsigned long long n = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * DC_THREADS;
  for (unsigned long long i = (unsigned long long)blockIdx.x * DC_THREADS +
                              threadIdx.x;
       i < n_pairs; i += step) {
    const unsigned long long z = dc_mix(seed ^ dc_mix(i));
    const double a = dc_f64(dc_mix(z), 600);
    const double d = dc_f64(dc_mix(z + 1), 80);
    const double q = pw_div(a, pw_recip(d));
    const double w = __ddiv_rn(a, d);
    if (__double_as_longlong(q) != __double_as_longlong(w)) {
      ++n;
      atomicExch(first, i);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

// The f32 check of the nd divisors ds (device memory): *bad the count of
// differing results, *first one of them (divisor index << 32 | dividend
// bits); the f64 check of n_pairs pairs of `seed`: its count and a pair's
// index.  bad and first are 2 words each in device memory, zeroed by the
// caller.  Returns the CUDA error, 0 on success.
extern "C" int pointwise_divide_check(const float* ds, int nd,
                                      unsigned long long n_pairs,
                                      unsigned long long seed,
                                      unsigned long long* bad,
                                      unsigned long long* first, int n_sm,
                                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nd > 0) {
    divide_check_f32<<<dim3(8 * n_sm, nd), DC_THREADS, 0, s>>>(ds, bad, first);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n_pairs)
    divide_check_f64<<<8 * n_sm, DC_THREADS, 0, s>>>(n_pairs, seed, bad + 1,
                                                     first + 1);
  return (int)cudaGetLastError();
}
