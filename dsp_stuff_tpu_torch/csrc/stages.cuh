// stages.cuh -- device code shared by the chain kernel (chain_kernel.cu)
// and the cycle kernel (cycle_kernel.cu), so that both round alike: the
// elementwise shapers (apply_ew); and by their reverses
// (chain_reverse_kernel.cu, cycle_reverse_kernel.cu): the shapers'
// derivatives (ew_grad, fuzz_grad; ew_grads over a thread's samples).
// Each thread passes the NV samples it
// holds of one 128-sample block and a functor that takes the max (and for
// fuzz_grad one that takes the sum) of a value over that block (the chain
// kernels' warp per block, the cycle kernels' CTA per block).
//
// Arithmetic is plain FP32 and the build passes -fmad=false, so each
// operation rounds once, as in eager PyTorch.  tanhf, atanf, sinf and expf
// are CUDA's accurate device functions (no --use_fast_math).

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

// ---- the shapers' derivatives (the reverses') ------------------------------

__device__ __forceinline__ float mask1(bool in) { return in ? 1.0f : 0.0f; }

// g through tanh(clamp(v, -20, 20)), the derivative from the input
__device__ __forceinline__ float tanh20_grad(float g, float v) {
  const float t = tanhf(clampn(v, -20.0f, 20.0f));
  return g * (1.0f - t * t) * mask1(v >= -20.0f && v <= 20.0f);
}

// The vjp of shaper op (not Fuzz) at the NV inputs v a thread holds, the
// cotangents g replaced by the gradients.  p holds the params;
// chebyshev's p[2], p[3] are its two denominators (computed by the wrapper
// as its plain version does).  The op, its params and its bypass are
// decided once, then each sample's derivative with no branch between the
// samples, so that their chains interleave.
template <int NV>
__device__ __forceinline__ void ew_grads(int op, const float* p,
                                         float (&g)[NV],
                                         const float (&v)[NV]) {
  const float c4 = (float)(3.141592653589793 / 4.0);
  if (op == EW_OVERDRIVE) {
    const float boost = p[0], drive = p[1], level = p[2];
    if (level < BYPASS) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float b = c4 * (v[i] * boost);
      const float gm = g[i] * level;
      const float gb =
          gm * drive * (float)(2.0 / 3.141592653589793) / (1.0f + b * b);
      g[i] = gm * (1.0f - drive) + gb * c4 * boost;
    }
    return;
  }
  if (op == EW_CHEBYSHEV) {
    const float lp = p[0], ln = p[1], dp = p[2], dn = p[3];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const bool pos = v[i] >= 0.0f;
      const float l = pos ? lp : ln;
      const float d = tanh20_grad(g[i] / (pos ? dp : dn), v[i] * l) * l;
      g[i] = l < BYPASS ? g[i] : d;
    }
    return;
  }
  const float level = p[0];
  if (level < BYPASS) return;
  switch (op) {
    case EW_HARDCLIP:
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float w = v[i] * level;
        g[i] = g[i] / level * mask1(w >= -1.0f && w <= 1.0f) * level;
      }
      return;
    case EW_SOFTCLIP:
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float w = v[i] * level;
        g[i] = ((w >= -1.0f && w <= 1.0f) ? g[i] / level * (1.0f - w * w)
                                          : 0.0f) * level;
      }
      return;
    case EW_TANH:
#pragma unroll
      for (int i = 0; i < NV; ++i)
        g[i] = tanh20_grad(g[i], v[i] * level) * level;
      return;
    case EW_RECIPSOFTCLIP:
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float s = signn(v[i]);
        const float r = 1.0f / (fabsf(v[i]) * level + 1.0f);
        g[i] = g[i] * s * (r * r) * level * s;
      }
      return;
    case EW_SIN:
#pragma unroll
      for (int i = 0; i < NV; ++i) g[i] = g[i] * cosf(v[i] * level) * level;
      return;
    case EW_ATAN:
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float w = v[i] * level;
        g[i] = g[i] / (1.0f + w * w) * level;
      }
      return;
    case EW_SQUARE:
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float w = v[i] * level;
        g[i] = 2.0f * (g[i] * signn(w)) * w * level;
      }
      return;
    default:  // EW_CHEBYSHEV4
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float w = v[i] * level;
        g[i] = 2.0f * (16.0f * g[i] * (w * w) - 8.0f * g[i]) * w * level;
      }
      return;
  }
}

// ew_grads at one sample: the vjp of shaper op (not Fuzz) at its input v,
// cotangent g.
__device__ __forceinline__ float ew_grad(int op, const float* p, float g,
                                         float v) {
  float gg[1] = {g};
  const float vv[1] = {v};
  ew_grads<1>(op, p, gg, vv);
  return gg[0];
}

// The sum of this thread's values: its part of a block sum
template <int NV>
__device__ __forceinline__ float sum_of(const float (&t)[NV]) {
  float s = t[0];
#pragma unroll
  for (int i = 1; i < NV; ++i) s = s + t[i];
  return s;
}

// Block sum over one warp holding a block, four samples a lane.
struct WarpSum {
  __device__ float operator()(float v) const {
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
};

// The vjp of Fuzz at the NV inputs v this thread holds of one block, the
// cotangents g replaced by the gradients: the forward again from v, then
// back through its three block maxima (each one's gradient split evenly
// among its ties, as torch.amax's backward) with block sums.  Every
// thread holding a sample of the block calls it together.
template <int NV, class BlockMax, class BlockSum>
__device__ __forceinline__ void fuzz_grad(float level, float (&g)[NV],
                                          const float (&v)[NV],
                                          BlockMax bmax, BlockSum bsum) {
  float t[NV], z[NV], e[NV], y[NV];
  const float mx = bmax(abs_max(v));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float q = clampn(v[i] * level, -1.0f, 1.0f) / mx;
    e[i] = expf(-fabsf(q));
    z[i] = -(1.0f - e[i]);
  }
  const float mz = bmax(abs_max(z));
#pragma unroll
  for (int i = 0; i < NV; ++i)
    y[i] = clampn(z[i] * mx, -1.0f, 1.0f) / mz;
  const float my = bmax(abs_max(y));
#pragma unroll
  for (int i = 0; i < NV; ++i) t[i] = -(g[i] * (y[i] * mx)) / (my * my);
  const float gmy = bsum(sum_of(t));
#pragma unroll
  for (int i = 0; i < NV; ++i) t[i] = mask1(fabsf(y[i]) == my);
  const float ny = bsum(sum_of(t));
  float gy[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float hy = mask1(fabsf(y[i]) == my);
    gy[i] = g[i] / my * mx + gmy / ny * hy * signn(y[i]);
    t[i] = -(gy[i] * clampn(z[i] * mx, -1.0f, 1.0f)) / (mz * mz);
  }
  const float gmz = bsum(sum_of(t));
#pragma unroll
  for (int i = 0; i < NV; ++i) t[i] = mask1(fabsf(z[i]) == mz);
  const float nz = bsum(sum_of(t));
  float gq[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float w = z[i] * mx;
    const float gw = gy[i] / mz * mask1(w >= -1.0f && w <= 1.0f);
    const float hz = mask1(fabsf(z[i]) == mz);
    const float gz = gw * mx + gmz / nz * hz * signn(z[i]);
    const float cu = clampn(v[i] * level, -1.0f, 1.0f);
    gq[i] = -(gz * e[i] * signn(cu / mx));
    t[i] = g[i] / my * y[i] + gw * z[i] - gq[i] * cu / (mx * mx);
  }
  const float gmx = bsum(sum_of(t));
#pragma unroll
  for (int i = 0; i < NV; ++i) t[i] = mask1(fabsf(v[i]) == mx);
  const float nx = bsum(sum_of(t));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float u = v[i] * level;
    g[i] = gq[i] / mx * mask1(u >= -1.0f && u <= 1.0f) * level +
           gmx / nx * mask1(fabsf(v[i]) == mx) * signn(v[i]);
  }
}
