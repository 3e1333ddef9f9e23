// stages.cuh -- device code shared by the chain kernel (chain_kernel.cu)
// and the cycle kernel (cycle_kernel.cu), so that both round alike.
//
// The shapers (apply_ew) serve both kernels: each thread passes the NV
// samples it holds of one 128-sample block and a functor that takes the
// max of a value over that block (the chain kernel's warp per block, the
// cycle kernel's CTA per block).  The cascade and comb steps below them
// are the cycle kernel's: one CTA of CK_C = 128 threads per stream row,
// thread c owning sample column c of every block, every thread calling
// at the same point (they contain __syncthreads).
//
// Arithmetic is plain FP32 and the build passes -fmad=false, so each
// operation rounds once, as in eager PyTorch; the cascade products use
// explicit fmaf.  tanhf, atanf, sinf and expf are CUDA's accurate device
// functions (no --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CK_C 128
#define CK_NS 8

// elementwise ops (the order of ops/chain_kernel.py:EW_CODES)
#define EW_OVERDRIVE 0
#define EW_CHEBYSHEV 1
#define EW_HARDCLIP 2
#define EW_SOFTCLIP 3
#define EW_TANH 4
#define EW_RECIPSOFTCLIP 5
#define EW_FUZZ 6
#define EW_SIN 7
#define EW_ATAN 8
#define EW_SQUARE 9
#define EW_CHEBYSHEV4 10

#define BYPASS 0.001f

// Shared-memory scratch of one CTA for the stage functions.
struct StageScratch {
  float xs[CK_C];          // the block a cascade reads
  float red[CK_NS][4];     // per-warp carry partials
  float redm[4];           // per-warp block maxima
};

// NaN-propagating clamp, as torch.clamp and jnp.clip
__device__ __forceinline__ float clampn(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tanh with the argument clamped to +-20 (ops/shaping.py:_tanh)
__device__ __forceinline__ float tanh20(float v) {
  return tanhf(clampn(v, -20.0f, 20.0f));
}

__device__ __forceinline__ float signn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

__device__ __forceinline__ float maxn(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// max over the CTA's 128 values, NaN-propagating
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = maxn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return maxn(maxn(red[0], red[1]), maxn(red[2], red[3]));
}

// Block max over one CTA of 128 threads, one sample each.
struct CtaMax {
  float* red;
  __device__ float operator()(float v) const { return block_max(v, red); }
};

// Block max over one warp holding a block, four samples a lane.
struct WarpMax {
  __device__ float operator()(float v) const {
    for (int o = 16; o > 0; o >>= 1)
      v = maxn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
};

// v[i] = f(v[i]) over a thread's NV samples, unrolled so that the
// samples' chains interleave
template <int NV, class F>
__device__ __forceinline__ void each(float (&v)[NV], F f) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = f(v[i]);
}

// The elementwise shapers other than Fuzz (ops/shaping.py) on the NV
// samples a thread holds; the op and its bypass are decided once.
template <int NV>
__device__ __forceinline__ void ew_points(int op, const float* p,
                                          float (&v)[NV]) {
  if (op == EW_OVERDRIVE) {
    const float boost = p[0], drive = p[1], level = p[2];
    if (level < BYPASS) return;
    each(v, [=](float x) {
      const float a = x * boost;
      const float b = (float)(3.141592653589793 / 4.0) * a;
      const float d = (float)(2.0 / 3.141592653589793) * atanf(b);
      const float mix = drive * d + (1.0f - drive) * x;
      return mix * level;
    });
    return;
  }
  if (op == EW_CHEBYSHEV) {
    const float lp = p[0], ln = p[1];
    const float tp = tanh20(lp < BYPASS ? 1.0f : lp);
    const float tn = tanh20(ln < BYPASS ? 1.0f : ln);
    each(v, [=](float x) {
      const bool pos = x >= 0.0f;
      const float l = pos ? lp : ln;
      return l < BYPASS ? x : tanh20(x * l) / (pos ? tp : tn);
    });
    return;
  }
  const float level = p[0];
  if (level < BYPASS) return;
  switch (op) {
    case EW_HARDCLIP:
      each(v, [=](float x) { return clampn(x * level, -1.0f, 1.0f) / level; });
      return;
    case EW_SOFTCLIP:
      each(v, [=](float x) {
        const float w = x * level;
        const float inner = w - (w * w) * w / 3.0f;
        const float two3 = (float)(2.0 / 3.0);
        const float shaped = w > 1.0f ? two3
            : ((w >= -1.0f && w <= 1.0f) ? inner : -two3);
        return clampn(shaped, -1.0f, 1.0f) / level;
      });
      return;
    case EW_TANH:
      each(v, [=](float x) { return tanh20(x * level); });
      return;
    case EW_RECIPSOFTCLIP:
      each(v, [=](float x) {
        return signn(x) * (1.0f - 1.0f / (fabsf(x) * level + 1.0f));
      });
      return;
    case EW_SIN:
      each(v, [=](float x) { return sinf(x * level); });
      return;
    case EW_ATAN:
      each(v, [=](float x) { return atanf(x * level); });
      return;
    case EW_SQUARE:
      each(v, [=](float x) {
        const float w = x * level;
        return w * w * signn(w);
      });
      return;
    case EW_CHEBYSHEV4:
      each(v, [=](float x) {
        const float w = x * level;
        const float w2 = w * w;
        const float w4 = w2 * w2;
        return 8.0f * w4 - 8.0f * w2 + 1.0f;
      });
      return;
  }
}

// NaN-propagating max of |v[i]| over this thread's samples
template <int NV>
__device__ __forceinline__ float abs_max(const float (&v)[NV]) {
  float m = fabsf(v[0]);
#pragma unroll
  for (int i = 1; i < NV; ++i) m = maxn(m, fabsf(v[i]));
  return m;
}

// One elementwise shaper on the NV samples this thread holds of one
// 128-sample block.  Fuzz (distort.rs:146-172, no bypass) takes three
// block maxima through `bmax`, which every thread holding a sample of
// the block calls together.
template <int NV, class BlockMax>
__device__ __forceinline__ void apply_ew(int op, const float* p,
                                         float (&v)[NV], BlockMax bmax) {
  if (op != EW_FUZZ) {
    ew_points(op, p, v);
    return;
  }
  const float level = p[0];
  const float mx = bmax(abs_max(v));
  float z[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float q = clampn(v[i] * level, -1.0f, 1.0f) / mx;
    z[i] = -(1.0f - expf(-fabsf(q)));
  }
  const float mz = bmax(abs_max(z));
#pragma unroll
  for (int i = 0; i < NV; ++i) z[i] = clampn(z[i] * mx, -1.0f, 1.0f) / mz;
  const float my = bmax(abs_max(z));
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = z[i] * mx / my;
}

// One 128-sample cascade step (ops/cascade.py blocked solve):
//   y[c]   = sum_{i<=c} X[i] Ltg[i,c] + sum_j carry[j] Ecb[j,c]
//   carry' = X.W + carry.ACt        (N <= 8 lanes, warp-shuffle sums)
// cr is the cascade's carry in shared memory, updated in place.
__device__ float cascade_step(float v, int N, float* cr,
                              const float* __restrict__ ltg,
                              const float* __restrict__ w,
                              const float* __restrict__ ecb,
                              const float* __restrict__ act,
                              StageScratch& sh) {
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  sh.xs[c] = v;
  __syncthreads();
  // y[c] = X . Ltg[:, c] over i <= c (Ltg is upper-triangular), four
  // partial sums to shorten the dependent FMA chain
  const float* __restrict__ L = ltg + c;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int i = 0;
  for (; i + 3 <= c; i += 4) {
    a0 = fmaf(sh.xs[i], __ldg(L + i * CK_C), a0);
    a1 = fmaf(sh.xs[i + 1], __ldg(L + (i + 1) * CK_C), a1);
    a2 = fmaf(sh.xs[i + 2], __ldg(L + (i + 2) * CK_C), a2);
    a3 = fmaf(sh.xs[i + 3], __ldg(L + (i + 3) * CK_C), a3);
  }
  for (; i <= c; ++i) a0 = fmaf(sh.xs[i], __ldg(L + i * CK_C), a0);
  float acc = (a0 + a1) + (a2 + a3);
  const float* __restrict__ E = ecb + c;
  const float* __restrict__ W = w + c * CK_NS;
  float part[CK_NS];
#pragma unroll
  for (int j = 0; j < CK_NS; ++j) {
    if (j < N) {
      acc = fmaf(cr[j], __ldg(E + j * CK_C), acc);
      float t = v * __ldg(W + j);
      for (int o = 16; o > 0; o >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, o);
      part[j] = t;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < CK_NS; ++j)
      if (j < N) sh.red[j][warp] = part[j];
  }
  __syncthreads();
  float nc = 0.0f;
  if (c < N) {
    nc = (sh.red[c][0] + sh.red[c][1]) + (sh.red[c][2] + sh.red[c][3]);
    const float* __restrict__ A = act + c;
    for (int k = 0; k < N; ++k) nc = fmaf(cr[k], __ldg(A + k * CK_NS), nc);
  }
  __syncthreads();                     // every thread has read cr
  if (c < N) cr[c] = nc;
  return acc;
}

// Feedback comb y = x + decay * y[n-D] on this thread's sample at time
// pos (= block * 128 + column), over a ring of RL = ceil(D/128)*128
// samples of this row's past outputs in global memory: linear position p
// holds the output at time p (mod RL).  Columns [lo, lo + span) read only
// samples written before their round: span = D for D < 128 (feedback
// inside the block), else the whole block in one round.
__device__ float comb_step(float v, float* ring, int RL, int D, float decay,
                           long long pos) {
  const int c = threadIdx.x;
  const int span = D < CK_C ? D : CK_C;
  float out = v;
  for (int lo = 0; lo < CK_C; lo += span) {
    const bool act = c >= lo && c < lo + span;
    float yv = 0.0f;
    if (act) {
      int rd = (int)((pos - D) % RL);
      if (rd < 0) rd += RL;
      yv = __fadd_rn(v, __fmul_rn(ring[rd], decay));
      out = yv;
    }
    __syncthreads();                   // all reads before writes
    if (act) ring[(int)(pos % RL)] = yv;
    __syncthreads();                   // writes visible to reads
  }
  return out;
}
