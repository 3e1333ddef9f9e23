// oscillator_kernel.cu -- the signal generator (nodes/gen.py SignalGen):
// its per-block phase clock and its four waves, one kernel for every mode
// and policy.
//
// Replaces no TPU kernel: it is the counterpart of what XLA compiles for
// dsp_stuff_tpu/ops/gen.py:35 _block_totals and :97 oscillator inside
// jax.jit(self.fn) (dsp_stuff_tpu/compiler/compile.py:231): the in-block
// running total (one lax.scan), the clock carried over the 128-sample
// blocks (an f64 cumsum under fast, another lax.scan under parity and
// exact) and the wave.  The plain version is ops/gen.py:oscillator_plain;
// the wrapper is ops/oscillator_kernel.py.
//
// Semantics (signal_gen.rs:57-108, ops/gen.py): step[t] = f[t] / 48000 (a
// true divide); total[t] is the sequential f32 sum of the steps from its
// block's start (block k holds samples 128k .. 128k + 127); bs[k] =
// total[128k + 127]; the clock of block k is c[k], with
//   parity, exact: c[0] = c0, c[k + 1] = rem(c[k] + bs[k]) in f32;
//   fast:          c[k] = f32(rem(f64(c0) + s[k])), s[0] = 0, s[k + 1] =
//                  s[k] + f64(bs[k]) (the f64 running sum);
// rem(x) = torch.remainder(x, 1) (fmod, plus 1 where the result is
// negative); the final clock is the clock after the last block.  With
// phase = c[k] + total[t]:
//   Sine      sinf(phase * TAU) * amp under fast; under parity and exact
//             the f64 range reduction of a = f64(phase * TAU), a - 2pi *
//             rint(a * (1 / 2pi)), sin in f64, one rounding, times amp;
//   Triangle  (2 * rem(phase) - 1) * amp;
//   Square    (total > 0.5 ? 1 : -1) * amp (the reference's bug: the
//             in-block total, not the phase);
//   Constant  amp over T; the clock is left as it was.
// Each operation is the eager op's, rounded once (the build passes
// -fmad=false), so the kernel is bitwise its plain version on the card.
// The range reduction multiplies by the reciprocal of 2pi, as CUDA's
// divide of a tensor by a Python float does (the eager a64 / (2 pi)).
//
// What bounds it.  The wave pass is bound by bytes: the output (and a
// modulated frequency or amplitude) once each; its arithmetic, a
// sequential in-block sum of at most 128 adds a lane and one sine a
// sample, is small beside them at 3.35 TB/s.  The clock pass is bound by
// its dependent chain: the carry over the T / 128 blocks of a row is
// sequential in f32 under parity and exact (an add and a remainder a
// block), and an f64 running sum under fast.  Two launches a node:
//  1. the clock pass, one CTA of OSC_CLOCK_THREADS a clock row: a thread
//     a block takes the block's 128-step sum (a modulated frequency read
//     from device memory, a slider's step computed once), the sums go to
//     the clocks buffer, then warp 0 walks the carry over them (osc_carry)
//     and writes each block's clock over its sum, and the final clock;
//  2. the wave pass, a warp a (row, block), four consecutive samples a
//     lane: the lanes write the block's 128 steps to shared memory, and
//     each lane recomputes its samples' totals by the same sequential sum
//     from the block start (bitwise the plain version's; a reassociated
//     scan is not, and a 1-ulp phase at a mod-1 wrap flips the triangle by
//     full scale, ops/gen.py:_block_totals), then the wave.
// A render of one block (a stream block, the per-node cycle scan's
// block) is one launch: the wave pass takes the clock from c0 and lane 31
// of the block's warp writes the final clock.  Constant is one launch of
// the wave pass too.
//
// Every operand is read from device memory (a slider by its pointer), so
// a moved slider rebuilds nothing and a captured CUDA graph replays the
// launch reading the moved value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "oscillator_ops.cuh"

#define OSC_CLOCK_THREADS 1024     // threads a CTA of the clock pass
#define OSC_WAVE_WARPS 8           // warps a CTA of the wave pass

struct OscArgs {
  const float* freq;     // the frequency over the clock rows
  long long f_sb;        // its row stride (0: one row for all)
  int f_st;              // its time stride (0: a slider or a [..., 1])
  const float* amp;      // the amplitude over the output rows
  long long a_sb;
  int a_st;
  const float* c0;       // the clock at the first block, [crows]
  float* clocks;         // each block's clock, [crows, nb] (two passes)
  float* final_clock;    // [crows]
  float* y;              // the wave, [rows, T]
  long long rows, crows, T;
  float sr;              // the sample rate, the step's divisor
  int mode, exact;       // exact: the f32 carry and the f64 sine
  int fused;             // one launch: the clock from c0, lane 31's final
};

__device__ __forceinline__ float osc_step(const OscArgs& a, long long cr,
                                          long long t) {
  return __fdiv_rn(a.freq[cr * a.f_sb + t * a.f_st], a.sr);
}

// the clock of the first block, fast: f32(rem(f64(c0) + 0))
__device__ __forceinline__ float osc_first_clock(const OscArgs& a, float c0) {
  return a.exact ? c0 : __double2float_rn(osc_rem1(__dadd_rn((double)c0,
                                                             0.0)));
}

// One chunk of n <= 32 carry steps, the sums in the lanes' `mine`
// (broadcast in order by shuffles), the carry at each step to slot j of
// shared memory.  Parity and exact: a clock in [0, 1] plus a block's sum
// below 1 lies in [0, 2), where the remainder is x, or x - 1 for x >= 1
// (exact: Sterbenz), the bits of osc_rem1 in a compare and a subtract off
// each other's path.  A whole chunk runs that chain, noting whether every
// x lay in [0, 2); where one did not (a negative or a large step, NaN),
// the chunk runs again from its start through osc_rem1.  Every lane runs
// the same chain, so the branches are uniform.
template <bool EXACT, int N>
__device__ __forceinline__ void osc_carry_chunk(int n, float mine, float& c,
                                                double& s, float* carry_c,
                                                double* carry_s) {
  if (EXACT) {
    const float c_start = c;
    bool in_range = true;
#pragma unroll
    for (int j = 0; j < (N ? N : 32); ++j) {
      if (N || j < n) {
        const float x = __fadd_rn(c, __shfl_sync(0xffffffffu, mine, j));
        carry_c[j] = c;
        in_range &= x >= 0.0f && x < 2.0f;
        c = x >= 1.0f ? __fsub_rn(x, 1.0f) : x;
      }
    }
    if (!in_range) {
      c = c_start;
      for (int j = 0; j < n; ++j) {
        carry_c[j] = c;
        c = osc_rem1(__fadd_rn(c, __shfl_sync(0xffffffffu, mine, j)));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < (N ? N : 32); ++j) {
      if (N || j < n) {
        const float bs = __shfl_sync(0xffffffffu, mine, j);
        carry_s[j] = s;
        s = __dadd_rn(s, (double)bs);
      }
    }
  }
}

// The carry over a row's nb block sums in cl, by warp 0: each block's
// clock over its sum, and the final clock.  The chain is sequential; the
// lanes take it in chunks of 32 blocks, each lane loading one sum (the
// next chunk's loaded while this one runs, off the chain).  Every lane
// runs the same chain on the sums broadcast in order by shuffles and
// writes the carry at each block to the same slot of shared memory (the
// same value: no lane branches off), then lane j stores block j's clock.
// Under fast the chain is the f64 running sum alone, and each lane rounds
// its clock from its sum after the chunk.  A chunk is unrolled (the
// shuffles issue ahead of the chain).
template <bool EXACT>
__device__ __forceinline__ void osc_carry(const OscArgs& a, float* cl,
                                          float c0, long long nb,
                                          long long cr, float* carry_c,
                                          double* carry_s) {
  const int lane = threadIdx.x & 31;
  const double c0d = (double)c0;
  float c = c0;                    // parity, exact: the f32 clock
  double s = 0.0;                  // fast: the f64 running sum
  float next = lane < nb ? cl[lane] : 0.0f;
  for (long long base = 0; base < nb; base += 32) {
    const float mine = next;
    if (base + 32 + lane < nb) next = cl[base + 32 + lane];
    const int n = nb - base < 32 ? (int)(nb - base) : 32;
    if (n == 32)
      osc_carry_chunk<EXACT, 32>(n, mine, c, s, carry_c, carry_s);
    else
      osc_carry_chunk<EXACT, 0>(n, mine, c, s, carry_c, carry_s);
    __syncwarp();
    if (lane < n)
      cl[base + lane] = EXACT ? carry_c[lane]
          : __double2float_rn(osc_rem1(__dadd_rn(c0d, carry_s[lane])));
    __syncwarp();
  }
  if (lane == 0)
    a.final_clock[cr] = EXACT
        ? c : __double2float_rn(osc_rem1(__dadd_rn(c0d, s)));
}

// The clock pass: one CTA a clock row (grid-stride over them).
__global__ void __launch_bounds__(OSC_CLOCK_THREADS)
oscillator_clock_kernel(const OscArgs a) {
  __shared__ float carry_c[32];
  __shared__ double carry_s[32];
  const long long nb = a.T / OSC_BLOCK;
  for (long long cr = blockIdx.x; cr < a.crows; cr += gridDim.x) {
    float* cl = a.clocks + cr * nb;
    // each block's sum: 128 sequential adds of its steps from 0
    for (long long k = threadIdx.x; k < nb; k += OSC_CLOCK_THREADS) {
      float acc = 0.0f;
      if (a.f_st == 0) {
        const float s = osc_step(a, cr, 0);
#pragma unroll 16
        for (int i = 0; i < OSC_BLOCK; ++i) acc = __fadd_rn(acc, s);
      } else {
        const long long t0 = k * OSC_BLOCK;
#pragma unroll 16
        for (int i = 0; i < OSC_BLOCK; ++i)
          acc = __fadd_rn(acc, osc_step(a, cr, t0 + i));
      }
      cl[k] = acc;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      if (a.exact)
        osc_carry<true>(a, cl, a.c0[cr], nb, cr, carry_c, carry_s);
      else
        osc_carry<false>(a, cl, a.c0[cr], nb, cr, carry_c, carry_s);
    }
    __syncthreads();
  }
}

// One sample of the wave at phase clock + total.
__device__ __forceinline__ float osc_wave(const OscArgs& a, float clock,
                                          float total, float amp) {
  const float phase = __fadd_rn(clock, total);
  if (a.mode == OSC_SINE) {
    const float arg = __fmul_rn(phase, OSC_TAU);
    if (!a.exact) return __fmul_rn(sinf(arg), amp);
    double r = (double)arg;
    r = __dsub_rn(r, __dmul_rn(OSC_TWO_PI,
                               rint(__dmul_rn(r, OSC_INV_TWO_PI))));
    return __fmul_rn(__double2float_rn(sin(r)), amp);
  }
  if (a.mode == OSC_TRIANGLE)
    return __fmul_rn(__fsub_rn(__fmul_rn(2.0f, osc_rem1(phase)), 1.0f), amp);
  return __fmul_rn(total > 0.5f ? 1.0f : -1.0f, amp);
}

// The wave pass: a warp a (row, block), grid-stride over them; lane L
// takes samples 4L .. 4L + 3 of the block.
__global__ void __launch_bounds__(OSC_WAVE_WARPS * 32)
oscillator_wave_kernel(const OscArgs a) {
  __shared__ __align__(16) float steps[OSC_WAVE_WARPS][OSC_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nb = a.T / OSC_BLOCK;
  const long long n = a.rows * nb;
  float* sm = steps[warp];
  for (long long w = (long long)blockIdx.x * OSC_WAVE_WARPS + warp; w < n;
       w += (long long)gridDim.x * OSC_WAVE_WARPS) {
    const long long row = w / nb, k = w - row * nb;
    const long long cr = a.crows == 1 ? 0 : row;
    const long long t0 = k * OSC_BLOCK + 4 * lane;
    float amp[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      amp[j] = a.amp[row * a.a_sb + (t0 + j) * a.a_st];
    if (a.mode == OSC_CONSTANT) {
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(amp[j], 1.0f);
    } else {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = osc_step(a, cr, t0 + j);
      __syncwarp();
      *reinterpret_cast<float4*>(sm + 4 * lane) =
          make_float4(s[0], s[1], s[2], s[3]);
      __syncwarp();
      float tot[4];
      osc_totals(sm, lane, s, tot);
      float clock;
      if (a.fused) {
        const float c0 = a.c0[cr];
        clock = osc_first_clock(a, c0);
        if (lane == 31 && (a.crows != 1 || row == 0)) {
          // the final clock after the one block: bs = tot[3]
          a.final_clock[cr] = a.exact
              ? osc_rem1(__fadd_rn(c0, tot[3]))
              : __double2float_rn(osc_rem1(__dadd_rn(
                    (double)c0, __dadd_rn(0.0, (double)tot[3]))));
        }
      } else {
        clock = a.clocks[cr * nb + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = osc_wave(a, clock, tot[j], amp[j]);
    }
    *reinterpret_cast<float4*>(a.y + row * a.T + t0) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// torch.remainder(x, 1) as the kernel takes it, over n values, in f32
// (x32 -> y32) and f64 (x64 -> y64): chip_smoke.py holds it to torch's.
__global__ void oscillator_rem_kernel(const float* x32, float* y32,
                                      const double* x64, double* y64,
                                      long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    y32[i] = osc_rem1(x32[i]);
    y64[i] = osc_rem1(x64[i]);
  }
}

// The geometry the wrapper mirrors (ops/oscillator_kernel.py).
extern "C" int oscillator_kernel_geometry() {
  return OSC_BLOCK | OSC_CLOCK_THREADS << 8 | OSC_WAVE_WARPS << 20;
}

// One pass on `stream`: `pass` 0 the clock pass over grid CTAs, 1 the wave
// pass.  Returns the CUDA error, 0 on success.
extern "C" int oscillator_kernel_launch(
    int pass, const float* freq, long long f_sb, int f_st, const float* amp,
    long long a_sb, int a_st, const float* c0, float* clocks,
    float* final_clock, float* y, long long rows, long long crows,
    long long T, float sr, int mode, int exact, int fused, int grid,
    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows < 1 || crows < 1 || T < OSC_BLOCK || T % OSC_BLOCK || grid < 1 ||
      mode < OSC_SINE || mode > OSC_CONSTANT || (f_st != 0 && f_st != 1) ||
      (a_st != 0 && a_st != 1))
    return (int)cudaErrorInvalidValue;
  OscArgs a = {freq, f_sb, f_st, amp, a_sb, a_st, c0, clocks, final_clock,
               y, rows, crows, T, sr, mode, exact, fused};
  if (pass == 0)
    oscillator_clock_kernel<<<grid, OSC_CLOCK_THREADS, 0,
                              (cudaStream_t)stream>>>(a);
  else
    oscillator_wave_kernel<<<grid, OSC_WAVE_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int oscillator_rem_launch(const float* x32, float* y32,
                                     const double* x64, double* y64,
                                     long long n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  oscillator_rem_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(x32, y32,
                                                                x64, y64, n);
  return (int)cudaGetLastError();
}
