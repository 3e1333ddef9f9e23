// pointwise_kernel.cu -- one pointwise group: the stateless per-sample ops
// that the planner gathers between the port's other kernels (fan-in
// averages, modulation maps, gains, adds, mixes, the shapers at base rate;
// compiler/compile.py _plan_pointwise), as one pass over the broadcast
// [rows, T] shape.
//
// Replaces no TPU kernel: it is the counterpart of the loop fusion XLA
// gives the JAX package inside jax.jit(self.fn)
// (dsp_stuff_tpu/compiler/compile.py:230).  The group's program
// (compiler/pointwise.py) is generated as straight-line CUDA by
// ops/pointwise_kernel.py:source and included here as KERNEL_PROGRAM_H:
// PW_NSIG, PW_NSCAL, PW_NOUT, the struct PwUniform of the values that
// depend on scalar operands alone (computed once a thread), pw_uniform and
// pw_point (one element).  The plain version is compiler/pointwise.py:
// interpret; the wrapper is ops/pointwise_kernel.py.
//
// A program with a block max (Fuzz's normalization, ``bmax``) defines
// PW_STAGED and pw_block in place of pw_point: a thread's four samples at
// once, in stages around each max, the max a warp reduction
// (pointwise_ops.cuh pw_bmax).  In the float4 build with T % 128 == 0 a
// warp's 32 lanes x 4 samples are exactly one 128-sample block of a row:
// a warp's units start at a multiple of 32 (the CTA's 256 threads and the
// grid stride are multiples of 32) and a row holds T / 4 units, a multiple
// of 32, so every lane of a warp is in the loop together.  Such a build
// has no scalar loop: its launch refuses !vec or T % 128 != 0.
//
// What bounds it: bytes.  Each signal operand is read once and each output
// written once; the arithmetic is a few dozen operations an element (the
// shapers' atanf / tanhf / sinf the most), far below the FP32 rate at
// HBM's 3.35 TB/s.  So the design is the plain one that moves the bytes in
// 16-byte pieces, as PyTorch's own elementwise kernels do: a thread takes
// 4 consecutive samples of a row (one float4 a signal operand, one a
// store), the grid's y is the row and its x the row's units, one unit a
// thread, so consecutive CTAs stream consecutive memory and no thread
// divides to find its row (grid-stride loops over both cover what the
// grid's limits leave); a row whose T is not a multiple of 4 ends in a
// tail of single samples; where a signal's row start or an output's is
// not 16-byte aligned the launch takes the build's scalar loop (VEC false:
// one sample a thread).  A group with many divides and transcendentals
// (config5's pre -> overdrive -> distort: six IEEE divides and an atanf a
// sample) is bound by its instructions instead.
//
// Every operand is read from device memory: a signal by its pointer and
// its batch stride (0 for an unbatched [T] signal such as an LFO) and time
// stride (0 for a [..., 1] operand); a scalar (a slider, a level, a fan-in
// divisor) by its pointer.  No operand's value is in the source, so a
// moved slider rebuilds nothing and a captured CUDA graph replays the
// launch reading the moved value; two groups of one structure share one
// build.  An output whose shape has no batch (it depends on unbatched
// operands alone) is written by row 0 only (its batch stride is 0).
//
// Rounding: the generated code writes each f32 operation as __fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn (f64: __dadd_rn ...), each rounded once
// as the eager PyTorch op it mirrors, and the build passes -fmad=false.
// sign, clamp and where keep torch's NaN and signed-zero rules: sign(NaN)
// and sign(-0) are +0; clamp propagates NaN; a comparison with NaN is
// false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pointwise_ops.cuh"

#include KERNEL_PROGRAM_H

#define PW_THREADS 256          // threads a CTA
#define PW_V 4                  // samples a thread takes (one float4)
#define PW_SIG_N (PW_NSIG > 0 ? PW_NSIG : 1)
#define PW_SCAL_N (PW_NSCAL > 0 ? PW_NSCAL : 1)
#define PW_OUT_N (PW_NOUT > 0 ? PW_NOUT : 1)

// The operands, passed by value (the kernel's parameters: a captured
// launch keeps them, and no table lives in device memory).
struct PwArgs {
  const float* sig[PW_SIG_N];
  long long sig_sb[PW_SIG_N];   // batch stride (elements)
  int sig_st[PW_SIG_N];         // time stride: 1, or 0 for a [..., 1] operand
  const float* scal[PW_SCAL_N];
  float* out[PW_OUT_N];
  long long out_sb[PW_OUT_N];   // batch stride: T, or 0 (row 0 writes)
};
static_assert(sizeof(PwArgs) + 32 <= 4096, "pointwise kernel: too many "
              "operands for the kernel's parameters");

template <bool VEC>
__global__ void __launch_bounds__(PW_THREADS)
pointwise_kernel(const PwArgs a, long long rows, long long T) {
  const PwUniform U = pw_uniform(a.scal);
  const long long upr = VEC ? (T + PW_V - 1) / PW_V : T;    // units a row
  const long long step = (long long)gridDim.x * PW_THREADS;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* p[PW_SIG_N];
    float* q[PW_OUT_N];
    bool w[PW_OUT_N];
#pragma unroll
    for (int k = 0; k < PW_NSIG; ++k) p[k] = a.sig[k] + row * a.sig_sb[k];
#pragma unroll
    for (int k = 0; k < PW_NOUT; ++k) {
      q[k] = a.out[k] + row * a.out_sb[k];
      w[k] = a.out_sb[k] != 0 || row == 0;
    }
    for (long long u = (long long)blockIdx.x * PW_THREADS + threadIdx.x;
         u < upr; u += step) {
      const long long t0 = u * (VEC ? PW_V : 1);
      if (VEC && t0 + PW_V <= T) {
        float x[PW_V][PW_SIG_N], y[PW_V][PW_OUT_N];
#pragma unroll
        for (int k = 0; k < PW_NSIG; ++k) {
          if (a.sig_st[k]) {
            const float4 v = *reinterpret_cast<const float4*>(p[k] + t0);
            x[0][k] = v.x;
            x[1][k] = v.y;
            x[2][k] = v.z;
            x[3][k] = v.w;
          } else {
            const float v = *p[k];
#pragma unroll
            for (int i = 0; i < PW_V; ++i) x[i][k] = v;
          }
        }
#ifdef PW_STAGED
        pw_block(U, x, y);
#else
#pragma unroll
        for (int i = 0; i < PW_V; ++i) pw_point(U, x[i], y[i]);
#endif
#pragma unroll
        for (int k = 0; k < PW_NOUT; ++k)
          if (w[k])
            *reinterpret_cast<float4*>(q[k] + t0) =
                make_float4(y[0][k], y[1][k], y[2][k], y[3][k]);
      } else {
#ifndef PW_STAGED
        // one sample (VEC false), or the tail of a row (fewer than PW_V)
        const int m = VEC ? (int)(T - t0) : 1;
        for (int i = 0; i < m; ++i) {
          const long long t = t0 + i;
          float x[PW_SIG_N], y[PW_OUT_N];
#pragma unroll
          for (int k = 0; k < PW_NSIG; ++k) x[k] = p[k][a.sig_st[k] ? t : 0];
          pw_point(U, x, y);
#pragma unroll
          for (int k = 0; k < PW_NOUT; ++k)
            if (w[k]) q[k][t] = y[k];
        }
#endif
      }
    }
  }
}

// The operand counts this build was generated for, checked by the wrapper.
extern "C" int pointwise_kernel_counts() {
  return PW_NSIG | PW_NSCAL << 10 | PW_NOUT << 20;
}

// Launch on `stream` over [rows, T]: `vec` picks the float4 build (every
// signal with time stride 1 and every output 16-byte aligned at each row
// start), a grid of gx x gy CTAs of PW_THREADS (y over the rows, x over a
// row's units).  Returns the CUDA error, 0 on success.
extern "C" int pointwise_kernel_launch(
    const unsigned long long* sig, const long long* sig_sb,
    const int* sig_st, const unsigned long long* scal,
    const unsigned long long* out, const long long* out_sb, long long rows,
    long long T, int vec, int gx, int gy, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows < 1 || T < 1 || gx < 1 || gy < 1 || gy > 65535)
    return (int)cudaErrorInvalidValue;
#ifdef PW_STAGED
  if (!vec || T % 128) return (int)cudaErrorInvalidValue;
#endif
  const dim3 grid(gx, gy);
  PwArgs a = {};
  for (int k = 0; k < PW_NSIG; ++k) {
    a.sig[k] = reinterpret_cast<const float*>(sig[k]);
    a.sig_sb[k] = sig_sb[k];
    a.sig_st[k] = sig_st[k];
  }
  for (int k = 0; k < PW_NSCAL; ++k)
    a.scal[k] = reinterpret_cast<const float*>(scal[k]);
  for (int k = 0; k < PW_NOUT; ++k) {
    a.out[k] = reinterpret_cast<float*>(out[k]);
    a.out_sb[k] = out_sb[k];
  }
  if (vec)
    pointwise_kernel<true><<<grid, PW_THREADS, 0, (cudaStream_t)stream>>>(
        a, rows, T);
#ifndef PW_STAGED
  else
    pointwise_kernel<false><<<grid, PW_THREADS, 0, (cudaStream_t)stream>>>(
        a, rows, T);
#endif
  return (int)cudaGetLastError();
}
