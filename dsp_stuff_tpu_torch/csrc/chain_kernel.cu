// chain_kernel.cu -- a whole chain segment in one pass over the signal.
//
// Replaces dsp_stuff_tpu/ops/pallas_chain.py:chain_kernel_call (the Pallas
// megakernel of the JAX package) in the PyTorch port.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/chain_segment.py:segment_fallback;
// the wrapper that builds, binds and launches it is
// dsp_stuff_tpu_torch/ops/chain_kernel.py.
//
// Design.  One CTA of 128 threads per stream row; thread c owns sample
// column c of every 128-sample block, and the CTA walks the K = T/128
// blocks in order.  A block passes through every stage while it sits in
// registers:
//   cascade  y[c] = sum_{i<=c} X[i] Ltg[i,c] + sum_j carry[j] Ecb[j,c]
//            carry' = X.W + carry.ACt   (N <= 8 lanes, warp-shuffle sums)
//   scale    the folded fan-in scale
//   ew       the shapers (all nine distort modes, overdrive, chebyshev);
//            Fuzz takes three block-wide max reductions
//   tap      writes the flow out as an extra sequence
//   comb     y = x + d * y[n-D] from a ring of ceil(D/128)*128 samples
//            per row in global memory (wrapper-allocated, seeded with the
//            history); a comb with D < 128 has feedback inside the block
//            and runs in rounds of D columns
// At the last block each cascade writes the carry entering it and its
// stage input, and the rings are left holding slot s = block b mod NR:
// the raw-output layout of the TPU kernel, which
// chain_segment.rebuild_states turns into node states.
//
// Arithmetic is plain FP32: FMAs (fmaf) in the cascade products, and
// elsewhere one rounding per operation -- the build passes -fmad=false so
// that no multiply-add is contracted, which keeps the shapers and the
// comb on the same roundings as the eager PyTorch version.  tanhf, atanf,
// sinf and expf are CUDA's accurate device functions (no --use_fast_math:
// it would also turn '/' and tanhf approximate).  The TPU kernel's bf16x3
// split, time padding and tile geometry do not exist here.
//
// What bounds it.  At B = 512 rows x 10 s the signal I/O is 2 x 0.98 GB,
// well under a millisecond of HBM time on an H100.  The kernel is bound
// instead by the sequential loop over 3750 blocks per row and, per block
// and cascade, the triangular 128 x 128 product (8,256 FMAs fed from the
// read-only cache) plus three CTA barriers.  512 CTAs of 4 warps put only
// about 16 warps on each SM, too few to hide that latency.  Later PRs:
// several rows per CTA so the cascade becomes a [rows,128]x[128,128] GEMM
// on the tensor cores (Ltg is Toeplitz, so one 128-tap row in shared
// memory describes it), and the rings in shared memory where they fit.

#include <cuda_runtime.h>
#include <math.h>

#define CK_C 128
#define CK_NS 8
#define CK_MAX_STAGES 32
#define CK_MAX_CASC 8
#define CK_MAX_COMB 8
#define CK_MAX_TAP 8

// stage kinds
#define CK_CASCADE 0
#define CK_SCALE 1
#define CK_EW 2
#define CK_TAP 3
#define CK_COMB 4

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

// Mirrored field for field by ops/chain_kernel.py (_Stage, _Program);
// chain_kernel_abi() lets the wrapper check the size.
typedef struct {
  int kind;     // CK_*
  int idx;      // cascade / ew op / tap / comb index
  int n;        // cascade: carry lanes N; comb: delay D
  float p[3];   // scale factor, shaper params, or comb decay
} CkStage;

typedef struct {
  int n_stages;
  int pad_;
  CkStage st[CK_MAX_STAGES];
  const float* ltg[CK_MAX_CASC];   // [128, 128]
  const float* w[CK_MAX_CASC];     // [128, 8]
  const float* ecb[CK_MAX_CASC];   // [8, 128]
  const float* act[CK_MAX_CASC];   // [8, 8]
  const float* s0[CK_MAX_CASC];    // [B, 8] carry entering block 0
  float* carry_out[CK_MAX_CASC];   // [B, 8] carry entering block K-1
  float* xlast_out[CK_MAX_CASC];   // [B, 128] stage input of block K-1
  float* ring[CK_MAX_COMB];        // [B, NR*128], seeded with the history
  float* tap[CK_MAX_TAP];          // [B, T]
} CkProgram;

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

// max over the CTA's 128 values, NaN-propagating; every thread calls it
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = maxn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return maxn(maxn(red[0], red[1]), maxn(red[2], red[3]));
}

__device__ float apply_ew(int op, const float* p, float v, float* red) {
  if (op == EW_OVERDRIVE) {
    const float boost = p[0], drive = p[1], level = p[2];
    const float a = v * boost;
    const float b = (float)(3.141592653589793 / 4.0) * a;
    const float d = (float)(2.0 / 3.141592653589793) * atanf(b);
    const float mix = drive * d + (1.0f - drive) * v;
    return level < BYPASS ? v : mix * level;
  }
  if (op == EW_CHEBYSHEV) {
    const float lp = p[0], ln = p[1];
    const bool pos = v >= 0.0f;
    const float l = pos ? lp : ln;
    const float safe = pos ? (lp < BYPASS ? 1.0f : lp)
                           : (ln < BYPASS ? 1.0f : ln);
    return l < BYPASS ? v : tanh20(v * l) / tanh20(safe);
  }
  const float level = p[0];
  if (op == EW_FUZZ) {                  // no bypass (distort.rs:146-172)
    const float mx = block_max(fabsf(v), red);
    const float q = clampn(v * level, -1.0f, 1.0f) / mx;
    const float z = -(1.0f - expf(-fabsf(q)));
    const float mz = block_max(fabsf(z), red);
    const float y = clampn(z * mx, -1.0f, 1.0f) / mz;
    const float my = block_max(fabsf(y), red);
    return y * mx / my;
  }
  if (level < BYPASS) return v;
  const float w = v * level;
  switch (op) {
    case EW_HARDCLIP:
      return clampn(w, -1.0f, 1.0f) / level;
    case EW_SOFTCLIP: {
      const float inner = w - (w * w) * w / 3.0f;
      const float two3 = (float)(2.0 / 3.0);
      const float shaped = w > 1.0f ? two3
          : ((w >= -1.0f && w <= 1.0f) ? inner : -two3);
      return clampn(shaped, -1.0f, 1.0f) / level;
    }
    case EW_TANH:
      return tanh20(w);
    case EW_RECIPSOFTCLIP:
      return signn(v) * (1.0f - 1.0f / (fabsf(v) * level + 1.0f));
    case EW_SIN:
      return sinf(w);
    case EW_ATAN:
      return atanf(w);
    case EW_SQUARE:
      return w * w * signn(w);
    case EW_CHEBYSHEV4: {
      const float w2 = w * w;
      const float w4 = w2 * w2;
      return 8.0f * w4 - 8.0f * w2 + 1.0f;
    }
  }
  return v;
}

__global__ void __launch_bounds__(CK_C)
chain_kernel(const CkProgram P, const float* __restrict__ x,
             float* __restrict__ y, int T) {
  __shared__ float xs[CK_C];                 // the block a cascade reads
  __shared__ float carry[CK_MAX_CASC][CK_NS];
  __shared__ float red[CK_NS][4];            // per-warp carry partials
  __shared__ float redm[4];                  // per-warp block maxima
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  const long long row = blockIdx.x;
  const int K = T / CK_C;
  const long long base = row * (long long)T;

  if (c < CK_NS) {
    for (int s = 0; s < P.n_stages; ++s)
      if (P.st[s].kind == CK_CASCADE)
        carry[P.st[s].idx][c] = P.s0[P.st[s].idx][row * CK_NS + c];
  }
  __syncthreads();

  for (int b = 0; b < K; ++b) {
    const long long off = base + (long long)b * CK_C + c;
    float v = x[off];
    for (int s = 0; s < P.n_stages; ++s) {
      const int kind = P.st[s].kind;
      const int idx = P.st[s].idx;
      if (kind == CK_CASCADE) {
        const int N = P.st[s].n;
        float* cr = carry[idx];
        if (b == K - 1) {
          P.xlast_out[idx][row * CK_C + c] = v;
          if (c < CK_NS) P.carry_out[idx][row * CK_NS + c] = cr[c];
        }
        xs[c] = v;
        __syncthreads();
        // y[c] = X . Ltg[:, c] over i <= c (Ltg is upper-triangular),
        // four partial sums to shorten the dependent FMA chain
        const float* __restrict__ L = P.ltg[idx] + c;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int i = 0;
        for (; i + 3 <= c; i += 4) {
          a0 = fmaf(xs[i], __ldg(L + i * CK_C), a0);
          a1 = fmaf(xs[i + 1], __ldg(L + (i + 1) * CK_C), a1);
          a2 = fmaf(xs[i + 2], __ldg(L + (i + 2) * CK_C), a2);
          a3 = fmaf(xs[i + 3], __ldg(L + (i + 3) * CK_C), a3);
        }
        for (; i <= c; ++i) a0 = fmaf(xs[i], __ldg(L + i * CK_C), a0);
        float acc = (a0 + a1) + (a2 + a3);
        const float* __restrict__ E = P.ecb[idx] + c;
        const float* __restrict__ W = P.w[idx] + c * CK_NS;
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
            if (j < N) red[j][warp] = part[j];
        }
        __syncthreads();
        float nc = 0.0f;
        if (c < N) {
          nc = (red[c][0] + red[c][1]) + (red[c][2] + red[c][3]);
          const float* __restrict__ A = P.act[idx] + c;
          for (int k = 0; k < N; ++k) nc = fmaf(cr[k], __ldg(A + k * CK_NS), nc);
        }
        __syncthreads();                     // every thread has read cr
        if (c < N) cr[c] = nc;
        v = acc;
      } else if (kind == CK_SCALE) {
        v = v * P.st[s].p[0];
      } else if (kind == CK_EW) {
        v = apply_ew(idx, P.st[s].p, v, redm);
      } else if (kind == CK_TAP) {
        P.tap[idx][off] = v;
      } else {                               // CK_COMB
        const int D = P.st[s].n;
        const float decay = P.st[s].p[0];
        const int RL = ((D + CK_C - 1) / CK_C) * CK_C;
        float* ring = P.ring[idx] + row * RL;
        const long long pos = (long long)b * CK_C + c;
        // columns [lo, lo + span) read only samples written before this
        // round: span = D for D < 128 (feedback inside the block), else
        // the whole block in one round
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
        v = out;
      }
    }
    y[off] = v;
  }
}

extern "C" int chain_kernel_abi(void) { return (int)sizeof(CkProgram); }

// Launch on `stream` (the caller's current PyTorch stream); returns the
// cudaGetLastError() code of the launch, 0 on success.
extern "C" int chain_kernel_launch(const CkProgram* prog, const float* x,
                                   float* y, int B, int T, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<<<B, CK_C, 0, (cudaStream_t)stream>>>(*prog, x, y, T);
  return (int)cudaGetLastError();
}
