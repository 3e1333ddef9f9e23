// sequential_kernel.cu -- the exact policy's per-sample recurrences, in the
// reference's operation order, one rounding an operation:
//   first order   y[t] = a[t] * y[t-1] + b[t]           (a scalar or per sample)
//   DF1 biquad    y[t] = b0*x[t] + b1*x[t-1] + b2*x[t-2] - a1*y[t-1] - a2*y[t-2]
//                 summed left to right, each product rounded on its own
// over [R, T] rows, one thread a row walking it in time order.
//
// No TPU kernel of the JAX package computes these: its exact policy runs
// them as lax.scan loops, dsp_stuff_tpu/ops/scan.py:_first_order_sequential
// (:299) and _biquad_sequential (:745), one device loop each.  This kernel
// is their counterpart on the card, one launch a solve.  The plain PyTorch
// versions are the loops of the same names in ops/scan.py; the wrapper is
// ops/sequential_kernel.py.
//
// Rounding.  Every operation is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn in the order above, so the result does not rest on the
// build's -fmad=false alone: it is bitwise the plain loop's, on the card
// and on the CPU, and the reference's.
//
// What bounds it.  The dependent chain of a row: per step a multiply and
// an add for the first order, and for the biquad a multiply and two
// subtracts on y[t-1]'s path (the x terms and a2*y[t-2] are off it).  At 4
// cycles an operation that is 2 x 4 and 3 x 4 cycles a sample, 1.94 and
// 2.91 ms for 480,000 samples at 1.98 GHz, whatever the number of rows; a
// lone warp's chain measures nearer 7 cycles an operation (the
// SQ_CHAIN_ONLY build, tools/measure_torch_sequential.py).  The bytes (x
// or b read once, y written once, 8 bytes a sample; 12 with a per-sample
// a) take 0.59 ms at [512, 480,000], so the chain bounds it, and a warp
// runs 32 rows' chains side by side.  The design keeps the loads' latency
// off the chain: each thread copies its row into its own slots of a
// shared-memory ring (cp.async, 16-byte pieces where the rows allow, else
// single floats) SQ_NST - 1 runs of SQ_RUN samples ahead of the run it
// computes, and waits only for its own copies, so there is no barrier.  A
// run's samples come out of the ring as 16-byte reads into registers
// before its chain starts; its outputs go straight to device memory
// (16-byte stores where aligned).  A thread's slots are SQ_LD floats
// apart, which keeps a warp's 16-byte copies and reads free of bank
// conflicts.  What the warp issues besides the chain (the copies, reads
// and stores, about 50 instructions a run) still waits behind it, in
// order, so the kernel takes about twice the probe's time; three other
// layouts of that work measured slower on the card (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#define SQ_THREADS 32           // threads (rows) of a CTA
#define SQ_RUN 32               // samples of a run (a multiple of 4)
#define SQ_NST 4                // runs in a thread's ring
#define SQ_LD (SQ_RUN + 4)      // floats between two threads' slots

enum { SQ_FIRST_ORDER = 0, SQ_FIRST_ORDER_PS = 1, SQ_BIQUAD = 2 };

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// Copy run k of a row (samples [k * SQ_RUN, (k + 1) * SQ_RUN) clipped to
// T; the rest zero-filled) into `slot`.
__device__ __forceinline__ void load_run(float* slot, const float* row,
                                         long long T, long long k, int vec) {
  const long long s0 = k * SQ_RUN;
  if (vec) {
#pragma unroll
    for (int e = 0; e < SQ_RUN; e += 4) {
      const bool ok = s0 + e < T;        // T % 4 == 0: all four or none
      cp_async16(slot + e, ok ? row + s0 + e : row, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < SQ_RUN; ++e) {
      const bool ok = s0 + e < T;
      cp_async4(slot + e, ok ? row + s0 + e : row, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void read_run(float (&v)[SQ_RUN],
                                         const float* slot) {
#pragma unroll
  for (int e = 0; e < SQ_RUN; e += 4) {
    const float4 q = *reinterpret_cast<const float4*>(slot + e);
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
  }
}

__device__ __forceinline__ void store_run(float* row, const float (&v)[SQ_RUN],
                                          long long T, long long k, int vec) {
  const long long s0 = k * SQ_RUN;
  if (vec) {
#pragma unroll
    for (int e = 0; e < SQ_RUN; e += 4)
      if (s0 + e < T)
        *reinterpret_cast<float4*>(row + s0 + e) =
            make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < SQ_RUN; ++e)
      if (s0 + e < T) row[s0 + e] = v[e];
  }
}

// The recurrence's state and step.  First order: y; biquad: x1, x2, y1, y2.
struct SqState {
  float x1, x2, y1, y2;
};

template <int MODE>
__device__ __forceinline__ float step(SqState& s, float x, float a,
                                      const float (&c)[5]) {
  if (MODE == SQ_BIQUAD) {
    // b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2, left to right
    float out = __fadd_rn(__fmul_rn(c[2], x), __fmul_rn(c[3], s.x1));
    out = __fadd_rn(out, __fmul_rn(c[4], s.x2));
    out = __fsub_rn(out, __fmul_rn(c[0], s.y1));
    out = __fsub_rn(out, __fmul_rn(c[1], s.y2));
    s.x2 = s.x1;
    s.x1 = x;
    s.y2 = s.y1;
    s.y1 = out;
    return out;
  } else {
    s.y1 = __fadd_rn(__fmul_rn(a, s.y1), x);
    return s.y1;
  }
}

// x [R, T] (the biquad's input, the first order's b); a the first order's
// coefficient (one float, or [R, T] per sample); c the biquad's (a1, a2,
// b0, b1, b2); s_in / s_out the states ([R] y for the first order, [R, 4]
// (x1, x2, y1, y2) for the biquad).
template <int MODE>
__global__ void __launch_bounds__(SQ_THREADS)
sequential_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ coef,
                  const float* __restrict__ s_in, float* __restrict__ y,
                  float* __restrict__ s_out, int R, long long T, int vec) {
  __shared__ __align__(16) float xs[SQ_NST][SQ_THREADS * SQ_LD];
  __shared__ __align__(16) float as[MODE == SQ_FIRST_ORDER_PS ? SQ_NST : 1]
                                   [MODE == SQ_FIRST_ORDER_PS
                                        ? SQ_THREADS * SQ_LD : 4];
  const int lane = threadIdx.x;
  const long long r = (long long)blockIdx.x * SQ_THREADS + lane;
  if (r >= R) return;
  const float* xr = x + r * T;
  const float* ar = MODE == SQ_FIRST_ORDER_PS ? a + r * T : a;
  float* yr = y + r * T;
  const long long n_runs = (T + SQ_RUN - 1) / SQ_RUN;

  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float a0 = 0.f;
  SqState s = {0.f, 0.f, 0.f, 0.f};
  if (MODE == SQ_BIQUAD) {
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = coef[i];
    s = SqState{s_in[4 * r], s_in[4 * r + 1], s_in[4 * r + 2],
                s_in[4 * r + 3]};
  } else {
    if (MODE == SQ_FIRST_ORDER) a0 = a[0];
    s.y1 = s_in[r];
  }

  auto issue = [&](long long k) {
    // keeps the previous run's shared-memory reads above the copies
    asm volatile("" ::: "memory");
    if (k < n_runs) {
      const int st = (int)(k % SQ_NST);
      load_run(&xs[st][lane * SQ_LD], xr, T, k, vec);
      if (MODE == SQ_FIRST_ORDER_PS)
        load_run(&as[st][lane * SQ_LD], ar, T, k, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#ifndef SQ_CHAIN_ONLY
  for (int k = 0; k < SQ_NST - 1; ++k) issue(k);
#endif

  for (long long k = 0; k < n_runs; ++k) {
    float v[SQ_RUN], av[SQ_RUN];
#ifdef SQ_CHAIN_ONLY
    // a measuring build: the chain alone, on values made in registers
#pragma unroll
    for (int u = 0; u < SQ_RUN; ++u) {
      v[u] = 1e-3f * (float)(u + (int)k);
      av[u] = 0.5f;
    }
#else
    // refill the slot run k - 1 was read from (its values are in the
    // registers that computed it), then wait for run k's group
    issue(k + SQ_NST - 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(SQ_NST - 1) : "memory");
    const int st = (int)(k % SQ_NST);
    read_run(v, &xs[st][lane * SQ_LD]);
    if (MODE == SQ_FIRST_ORDER_PS) read_run(av, &as[st][lane * SQ_LD]);
#endif
    const long long left = T - k * SQ_RUN;
    if (left >= SQ_RUN) {
#pragma unroll
      for (int u = 0; u < SQ_RUN; ++u)
        v[u] = step<MODE>(s, v[u], MODE == SQ_FIRST_ORDER_PS ? av[u] : a0,
                          c);
    } else {
#pragma unroll
      for (int u = 0; u < SQ_RUN; ++u)
        if (u < left)
          v[u] = step<MODE>(s, v[u], MODE == SQ_FIRST_ORDER_PS ? av[u] : a0,
                            c);
    }
#ifndef SQ_CHAIN_ONLY
    store_run(yr, v, T, k, vec);
#else
    if (v[0] == 12345.f) yr[0] = v[SQ_RUN - 1];   // keeps the chain live
#endif
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (MODE == SQ_BIQUAD) {
    s_out[4 * r] = s.x1;
    s_out[4 * r + 1] = s.x2;
    s_out[4 * r + 2] = s.y1;
    s_out[4 * r + 3] = s.y2;
  } else {
    s_out[r] = s.y1;
  }
}

// One solve on `stream`: mode 0 the first order with one coefficient (a
// points at it), 1 with a per-sample coefficient (a is [R, T]), 2 the
// biquad (coef points at a1, a2, b0, b1, b2).  s_in / s_out: [R] for the
// first order, [R, 4] for the biquad.  The 16-byte copies and stores are
// taken when every row start is 16-byte aligned.  Returns the
// cudaGetLastError() code of the launch, 0 on success.
extern "C" int sequential_kernel_launch(int mode, const float* x,
                                        const float* a, const float* coef,
                                        const float* s_in, float* y,
                                        float* s_out, int R, long long T,
                                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R < 1 || T < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0
      && (mode != SQ_FIRST_ORDER_PS || (uintptr_t)a % 16 == 0) && T % 4 == 0;
  const unsigned grid = (unsigned)((R + SQ_THREADS - 1) / SQ_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SQ_FIRST_ORDER)
    sequential_kernel<SQ_FIRST_ORDER><<<grid, SQ_THREADS, 0, st>>>(
        x, a, coef, s_in, y, s_out, R, T, vec);
  else if (mode == SQ_FIRST_ORDER_PS)
    sequential_kernel<SQ_FIRST_ORDER_PS><<<grid, SQ_THREADS, 0, st>>>(
        x, a, coef, s_in, y, s_out, R, T, vec);
  else
    sequential_kernel<SQ_BIQUAD><<<grid, SQ_THREADS, 0, st>>>(
        x, a, coef, s_in, y, s_out, R, T, vec);
  return (int)cudaGetLastError();
}
