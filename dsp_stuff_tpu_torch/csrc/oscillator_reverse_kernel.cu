// oscillator_reverse_kernel.cu -- the signal generator's backward: the
// gradients of its amplitude, frequency and first clock from the
// cotangents of its wave and final clock, for every mode and policy.
//
// Replaces no TPU kernel: it is the counterpart of the vjp that XLA
// compiles for jax.grad through jax.jit(self.fn)
// (dsp_stuff_tpu/compiler/compile.py:230-231) of
// dsp_stuff_tpu/ops/gen.py:35 _block_totals and :97 oscillator, as the
// forward (oscillator_kernel.cu) is of the functions themselves.  The
// plain version is ops/gen.py:oscillator_adjoint; the wrapper is
// ops/oscillator_reverse_kernel.py.
//
// Semantics (ops/gen.py oscillator_adjoint, autograd's formulas for
// oscillator_plain).  With the forward's totals and block clocks, phase =
// clock + total and the wave w (before the amplitude):
//   g_amp   = ct * w, summed to the amplitude (a slider: all of it);
//   g_w     = ct * amp (one clock row under a batched amplitude: summed
//             over the rows in order in f64, rounded once);
//   g_phase = (g_w * cosf(arg)) * TAU                   Sine, fast;
//             f32(f64(g_w) * cos(a64) + 0) * TAU        Sine, parity/exact
//                                                       (the round's zero
//                                                       gradient added);
//             g_w * 2                                   Triangle;
//             none                                      Square, Constant;
//   g_clk[k] = block k's sum of g_phase (f64, rounded once);
//   the carry walked backwards from the final clock's cotangent g:
//     fast:          f64 r = g; g_bs[k] = f32(r); r += f64(g_clk[k]);
//     parity, exact: f32 g;     g_bs[k] = g;      g = g_clk[k] + g;
//   g_c0    = the carry's value after block 0;
//   g_step  = the f32 chain from the block's end: g_step[127] = g_phase +
//             g_bs[k], g_step[i] = g_phase[i] + g_step[i + 1];
//   g_freq  = g_step / sr (a true divide; a slider: the sum, then one
//             divide).
// Every f64 sum starts from +0.0 in one fixed order, which the plain
// version takes too: a block is its lanes' sums (lane L: samples 4L ..
// 4L + 3 in order) added by the warp's xor tree (lane i takes lane i + o,
// o = 16, 8, 4, 2, 1); a sum over the summing CTA is thread t's items t,
// t + ORV_SUM_THREADS, ... in order, each warp's xor tree, then the warps
// in order.  Each f32 operation is one __f*_rn intrinsic (-fmad=false), as
// the eager op autograd runs.
//
// What bounds it.  Pass A is bound by bytes: the wave's cotangent (and a
// modulated amplitude or frequency) read once, each per-sample gradient
// written once, beside a sine and a cosine a sample.  Pass B is bound by
// its dependent chain: the carry over the T / 128 blocks of a clock row is
// sequential (an f64 add a block under fast, an f32 add under parity and
// exact), as the forward's clock pass is.  Up to three launches a call:
//  A. the wave pass, a warp a (clock row, block), four consecutive
//     samples a lane: the steps and in-block totals recomputed by the
//     forward's sequential sum (osc_totals, bitwise its totals), the
//     block's clock read from the forward's clock pass (`clocks`; c0 for
//     one block), the wave and its derivative, then for each output row of
//     the clock row: the amplitude's gradient (written, or a slider's
//     partial a warp), g_w; then g_phase (kept in `gph` for the
//     frequency's chains) and the block's sum g_clk;
//  B. the summing pass, one CTA of ORV_SUM_THREADS: the reverse carry, a
//     warp a clock row (the chain in chunks of 32 blocks, each lane one
//     block's g_clk, broadcast in order by shuffles, every lane running the
//     same chain), each block's g_bs, clock0's gradient; then the fixed-
//     order sums: a slider amplitude's partials, clock0's rows where one
//     clock0 served them, and a slider frequency's chains (a thread a
//     block, its 128 steps from the block's end);
//  C. the frequency pass (a modulated frequency), a warp a (clock row,
//     block): lane L runs the chain from g_bs[k] down through the lanes
//     after it and its own samples, and writes g_step / sr.
// Nothing is zeroed by the wrapper and nothing is added by atomics: every
// workspace value is written before it is read, every sum's order is fixed
// by the launch's shape, so two calls are bitwise equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "oscillator_ops.cuh"

#define ORV_WARPS 8               // warps a CTA of passes A and C
#define ORV_SUM_THREADS 1024      // pass B's one CTA

// what a gradient takes: none, one value an element, one sum (a slider)
#define ORV_NONE 0
#define ORV_ELEM 1
#define ORV_SUM 2

struct OrvArgs {
  const float* freq;       // the frequency over the clock rows
  long long f_sb;          // its row stride (0: one row for all)
  int f_st;                // its time stride (0: a slider)
  const float* amp;        // the amplitude over the output rows
  long long a_sb;
  int a_st;
  const float* c0;         // the first clock, [crows]
  const float* clocks;     // the forward's block clocks [crows, nb], or
                           // null for one block (the clock from c0)
  const float* ct;         // the wave's cotangent [rows, T], or null
  const float* ct_clock;   // the final clock's [crows], or null
  float* g_amp;            // [rows, T] (ELEM) or [1] (SUM)
  float* g_freq;           // [crows, T] (ELEM) or [1] (SUM)
  float* g_c0;             // [crows], or [1] where c0_shared
  float* gph;              // g_phase [crows, T] (the frequency's chains)
  float* gclk;             // g_clk [crows, nb]
  float* gbs;              // g_bs [crows, nb]
  float* gc0r;             // clock0's rows before their sum (c0_shared)
  double* pamp;            // a slider amplitude's partials [crows * nb]
  long long rows, crows, T;
  float sr;
  int mode, exact, ga, gf, gc, c0_shared;
};

// The warp's xor tree of an f64 value: every lane ends with the sum.
__device__ __forceinline__ double orv_tree(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The summing CTA's sum of each thread's v (each warp's tree, then the
// warps in order from +0.0), valid in thread 0; `sh` holds a double a
// warp.  Every thread calls it.
__device__ __forceinline__ double orv_cta_sum(double v, double* sh) {
  v = orv_tree(v);
  __syncthreads();                        // sh is free
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < ORV_SUM_THREADS / 32; ++w) s = __dadd_rn(s, sh[w]);
  return s;
}

__device__ __forceinline__ float orv_step(const OrvArgs& a, long long cr,
                                          long long t) {
  return __fdiv_rn(a.freq[cr * a.f_sb + t * a.f_st], a.sr);
}

// Pass A: a warp a (clock row, block), grid-stride over them; lane L takes
// samples 4L .. 4L + 3 of the block.
__global__ void __launch_bounds__(ORV_WARPS * 32)
oscillator_reverse_wave_kernel(const OrvArgs a) {
  __shared__ __align__(16) float steps[ORV_WARPS][OSC_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nb = a.T / OSC_BLOCK;
  const long long n = a.crows * nb;
  const bool wave = a.mode == OSC_SINE || a.mode == OSC_TRIANGLE;
  const bool phase = wave && (a.gf != ORV_NONE || a.gc);
  const bool one = a.crows == a.rows;     // a clock row for each row
  float* sm = steps[warp];
  for (long long w = (long long)blockIdx.x * ORV_WARPS + warp; w < n;
       w += (long long)gridDim.x * ORV_WARPS) {
    const long long cr = w / nb, k = w - cr * nb;
    const long long t0 = k * OSC_BLOCK + 4 * lane;
    float wv[4], arg[4];
    double red[4];
    if (a.mode == OSC_CONSTANT) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = 1.0f;
    } else {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = orv_step(a, cr, t0 + j);
      __syncwarp();
      *reinterpret_cast<float4*>(sm + 4 * lane) =
          make_float4(s[0], s[1], s[2], s[3]);
      __syncwarp();
      float tot[4];
      osc_totals(sm, lane, s, tot);
      float clock;
      if (a.clocks) {
        clock = a.clocks[cr * nb + k];
      } else {
        const float c0 = a.c0[cr];
        clock = a.exact ? c0
            : __double2float_rn(osc_rem1(__dadd_rn((double)c0, 0.0)));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ph = __fadd_rn(clock, tot[j]);
        if (a.mode == OSC_SINE) {
          arg[j] = __fmul_rn(ph, OSC_TAU);
          if (a.exact) {
            double r = (double)arg[j];
            r = __dsub_rn(r, __dmul_rn(OSC_TWO_PI,
                                       rint(__dmul_rn(r, OSC_INV_TWO_PI))));
            red[j] = r;
            wv[j] = __double2float_rn(sin(r));
          } else {
            wv[j] = sinf(arg[j]);
          }
        } else if (a.mode == OSC_TRIANGLE) {
          wv[j] = __fsub_rn(__fmul_rn(2.0f, osc_rem1(ph)), 1.0f);
        } else {
          wv[j] = tot[j] > 0.5f ? 1.0f : -1.0f;
        }
      }
    }
    if (!a.ct) continue;
    // the output rows of this clock row: their amplitude gradients and g_w
    const long long r0 = one ? cr : 0, r1 = one ? cr + 1 : a.rows;
    double pa = 0.0, gw64[4] = {0.0, 0.0, 0.0, 0.0};
    float gw[4];
    for (long long r = r0; r < r1; ++r) {
      const float4 c4 = *reinterpret_cast<const float4*>(a.ct + r * a.T + t0);
      const float ct[4] = {c4.x, c4.y, c4.z, c4.w};
      if (a.ga != ORV_NONE) {
        float ge[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) ge[j] = __fmul_rn(ct[j], wv[j]);
        if (a.ga == ORV_ELEM) {
          *reinterpret_cast<float4*>(a.g_amp + r * a.T + t0) =
              make_float4(ge[0], ge[1], ge[2], ge[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) pa = __dadd_rn(pa, (double)ge[j]);
        }
      }
      if (phase) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = __fmul_rn(
              ct[j], a.amp[r * a.a_sb + (t0 + j) * a.a_st]);
          if (one)
            gw[j] = p;
          else
            gw64[j] = __dadd_rn(gw64[j], (double)p);
        }
      }
    }
    if (a.ga == ORV_SUM) {
      pa = orv_tree(pa);
      if (lane == 0) a.pamp[w] = pa;
    }
    if (!phase) continue;
    float gp[4];
    double bsum = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!one) gw[j] = __double2float_rn(gw64[j]);
      if (a.mode == OSC_TRIANGLE)
        gp[j] = __fmul_rn(gw[j], 2.0f);
      else if (a.exact)
        gp[j] = __fmul_rn(__double2float_rn(__dadd_rn(
                    __dmul_rn((double)gw[j], cos(red[j])), 0.0)), OSC_TAU);
      else
        gp[j] = __fmul_rn(__fmul_rn(gw[j], cosf(arg[j])), OSC_TAU);
      bsum = __dadd_rn(bsum, (double)gp[j]);
    }
    if (a.gph)
      *reinterpret_cast<float4*>(a.gph + cr * a.T + t0) =
          make_float4(gp[0], gp[1], gp[2], gp[3]);
    bsum = orv_tree(bsum);
    if (lane == 0) a.gclk[w] = __double2float_rn(bsum);
  }
}

// One chunk of n <= 32 steps of the reverse carry, from the chunk's last
// block down, the chunk's g_clk in the lanes' `mine` (lane j: the chunk's
// j-th block from its end): slot j gets the carry before step j (g_bs of
// that block).  Every lane runs the same chain.  A whole chunk (N = 32)
// is unrolled, so the shuffles issue ahead of the chain.
template <bool EXACT, int N>
__device__ __forceinline__ void orv_carry_chunk(int n, float mine, float& g,
                                                double& r, float* slot) {
#pragma unroll
  for (int j = 0; j < (N ? N : 32); ++j) {
    if (N || j < n) {
      const float x = __shfl_sync(0xffffffffu, mine, j);
      if (EXACT) {
        slot[j] = g;
        g = __fadd_rn(x, g);
      } else {
        slot[j] = __double2float_rn(r);
        r = __dadd_rn(r, (double)x);
      }
    }
  }
}

// The reverse carry of clock row cr by one warp: g_bs of every block (to
// gbs, where the frequency needs it) and the value after block 0 (clock0's
// gradient of this row, returned in every lane).  The lanes take the
// blocks in chunks of 32 from the last, each lane loading one g_clk (the
// next chunk's loaded while this one runs).
template <bool EXACT>
__device__ __forceinline__ float orv_carry(const OrvArgs& a, long long cr,
                                           long long nb, float* slot) {
  const int lane = threadIdx.x & 31;
  const float* gc = a.gclk ? a.gclk + cr * nb : nullptr;
  const float ctc = a.ct_clock ? a.ct_clock[cr] : 0.0f;
  float g = ctc;                              // parity, exact
  double r = __dadd_rn(0.0, (double)ctc);     // fast
  float next = gc && lane < nb ? gc[nb - 1 - lane] : 0.0f;
  for (long long base = 0; base < nb; base += 32) {
    const float mine = next;
    const long long kn = nb - 1 - (base + 32 + lane);
    next = gc && kn >= 0 ? gc[kn] : 0.0f;
    const int n = nb - base < 32 ? (int)(nb - base) : 32;
    if (n == 32)
      orv_carry_chunk<EXACT, 32>(n, mine, g, r, slot);
    else
      orv_carry_chunk<EXACT, 0>(n, mine, g, r, slot);
    __syncwarp();
    if (a.gbs && lane < n) a.gbs[cr * nb + (nb - 1 - base - lane)] = slot[lane];
    __syncwarp();
  }
  return EXACT ? g : __double2float_rn(r);
}

// Pass B: one CTA of ORV_SUM_THREADS.
__global__ void __launch_bounds__(ORV_SUM_THREADS)
oscillator_reverse_sum_kernel(const OrvArgs a) {
  __shared__ double sh[ORV_SUM_THREADS / 32];
  __shared__ float slots[ORV_SUM_THREADS / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nb = a.T / OSC_BLOCK;
  const long long n = a.crows * nb;
  if (a.gf != ORV_NONE || a.gc) {
    for (long long cr = warp; cr < a.crows; cr += ORV_SUM_THREADS / 32) {
      const float g0 = a.exact ? orv_carry<true>(a, cr, nb, slots[warp])
                               : orv_carry<false>(a, cr, nb, slots[warp]);
      if (a.gc && lane == 0) (a.c0_shared ? a.gc0r : a.g_c0)[cr] = g0;
    }
  }
  __syncthreads();
  if (a.gc && a.c0_shared && threadIdx.x == 0) {
    double s = 0.0;
    for (long long cr = 0; cr < a.crows; ++cr)
      s = __dadd_rn(s, (double)a.gc0r[cr]);
    a.g_c0[0] = __double2float_rn(s);
  }
  if (a.ga == ORV_SUM) {
    double v = 0.0;
    for (long long i = threadIdx.x; i < n; i += ORV_SUM_THREADS)
      v = __dadd_rn(v, a.pamp[i]);
    v = orv_cta_sum(v, sh);
    if (threadIdx.x == 0) a.g_amp[0] = __double2float_rn(v);
  }
  if (a.gf == ORV_SUM) {
    // a slider: each block's chain from its end, every step summed (the
    // block's g_phase read four samples at a time, eight reads in flight)
    double v = 0.0;
    for (long long b = threadIdx.x; b < n; b += ORV_SUM_THREADS) {
      float acc = a.gbs[b];
      const float4* gp = a.gph
          ? reinterpret_cast<const float4*>(a.gph + b * OSC_BLOCK) : nullptr;
#pragma unroll 8
      for (int q = OSC_BLOCK / 4 - 1; q >= 0; --q) {
        const float4 g4 = gp ? gp[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          acc = __fadd_rn(g[j], acc);
          v = __dadd_rn(v, (double)acc);
        }
      }
    }
    v = orv_cta_sum(v, sh);
    if (threadIdx.x == 0)
      a.g_freq[0] = __fdiv_rn(__double2float_rn(v), a.sr);
  }
}

// Pass C: a warp a (clock row, block); lane L writes g_step / sr of its
// samples, the chain from the block's end through the lanes after it.
__global__ void __launch_bounds__(ORV_WARPS * 32)
oscillator_reverse_freq_kernel(const OrvArgs a) {
  __shared__ __align__(16) float gps[ORV_WARPS][OSC_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nb = a.T / OSC_BLOCK;
  const long long n = a.crows * nb;
  float* sm = gps[warp];
  for (long long w = (long long)blockIdx.x * ORV_WARPS + warp; w < n;
       w += (long long)gridDim.x * ORV_WARPS) {
    const long long cr = w / nb, k = w - cr * nb;
    const long long t = cr * a.T + k * OSC_BLOCK + 4 * lane;
    float4 g4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a.gph) g4 = *reinterpret_cast<const float4*>(a.gph + t);
    const float gp[4] = {g4.x, g4.y, g4.z, g4.w};
    __syncwarp();
    *reinterpret_cast<float4*>(sm + 4 * lane) = g4;
    __syncwarp();
    float acc = a.gbs[w];
    for (int q = 31; q > lane; --q) {
      const float4 v = *reinterpret_cast<const float4*>(sm + 4 * q);
      acc = __fadd_rn(v.w, acc);
      acc = __fadd_rn(v.z, acc);
      acc = __fadd_rn(v.y, acc);
      acc = __fadd_rn(v.x, acc);
    }
    float gs[4];
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      acc = __fadd_rn(gp[j], acc);
      gs[j] = __fdiv_rn(acc, a.sr);
    }
    *reinterpret_cast<float4*>(a.g_freq + t) =
        make_float4(gs[0], gs[1], gs[2], gs[3]);
  }
}

// The geometry the wrapper mirrors (ops/oscillator_reverse_kernel.py).
extern "C" int oscillator_reverse_geometry() {
  return OSC_BLOCK | ORV_WARPS << 8 | ORV_SUM_THREADS << 12;
}

// Passes `passes` (bit 0 A, bit 1 B, bit 2 C) on `stream`, A and C over
// `grid` CTAs.  Returns the CUDA error, 0 on success.
extern "C" int oscillator_reverse_launch(
    const float* freq, long long f_sb, int f_st, const float* amp,
    long long a_sb, int a_st, const float* c0, const float* clocks,
    const float* ct, const float* ct_clock, float* g_amp, float* g_freq,
    float* g_c0, float* gph, float* gclk, float* gbs, float* gc0r,
    double* pamp, long long rows, long long crows, long long T, float sr,
    int mode, int exact, int ga, int gf, int gc, int c0_shared, int passes,
    int grid, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows < 1 || crows < 1 || (crows != 1 && crows != rows) ||
      T < OSC_BLOCK || T % OSC_BLOCK || grid < 1 || mode < OSC_SINE ||
      mode > OSC_CONSTANT || (f_st != 0 && f_st != 1) ||
      (a_st != 0 && a_st != 1) || (T > OSC_BLOCK && mode != OSC_CONSTANT &&
                                   !clocks))
    return (int)cudaErrorInvalidValue;
  OrvArgs a = {freq, f_sb, f_st, amp, a_sb, a_st, c0,
               T > OSC_BLOCK ? clocks : nullptr, ct, ct_clock, g_amp,
               g_freq, g_c0, gph, gclk, gbs, gc0r, pamp, rows, crows, T, sr,
               mode, exact, ga, gf, gc, c0_shared};
  const cudaStream_t s = (cudaStream_t)stream;
  if (passes & 1) {
    oscillator_reverse_wave_kernel<<<grid, ORV_WARPS * 32, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (passes & 2) {
    oscillator_reverse_sum_kernel<<<1, ORV_SUM_THREADS, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (passes & 4)
    oscillator_reverse_freq_kernel<<<grid, ORV_WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
