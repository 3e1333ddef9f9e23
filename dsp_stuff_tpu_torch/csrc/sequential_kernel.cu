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

// ---------------------------------------------------------------------------
// Reverse mode: the adjoints of the three solves, for the exact policy's
// gradients on the card (the counterpart of jax.grad through the JAX
// package's lax.scan loops).  One thread a row walks it backwards in time,
// run by run from the last, in f32 with one rounding an operation, the
// coefficients' sums in float64; the plain PyTorch versions are
// ops/scan.py:_first_order_adjoint_sequential and
// _biquad_adjoint_sequential, which repeat these operations in this order.
//
//   first order   lam[t] = ybar[t] + a[t+1] * lam[t+1]   (lam[T] = 0)
//                 bbar = lam, y0bar = a[0] * lam[0],
//                 abar[t] = lam[t] * y[t-1]   (y[-1] = y0), written per
//                 sample, or for one coefficient summed over the row in
//                 float64 from t = T-1 down to 0
//   DF1 biquad    g[t] = ybar[t] - a1 * g[t+1] - a2 * g[t+2]  (g[T] =
//                 g[T+1] = 0), xbar[t] = b0 g[t] + b1 g[t+1] + b2 g[t+2];
//                 the coefficients' row sums, float64, over each t of
//                 g[t+1] y[t] (a1, negated), g[t+2] y[t] (a2, negated),
//                 g[t] x[t] (b0), g[t+1] x[t] (b1), g[t+2] x[t] (b2), then
//                 the boundary terms of the initial state (x1, x2, y1, y2)
//                 = (x[-1], x[-2], y[-1], y[-2]), which also give its
//                 gradient: (b1 g0 + b2 g1, b2 g0, -a1 g0 - a2 g1, -a2 g0)
//
// The biquad's sums are indexed so that a step reads only samples of its
// own t (ybar, x, y), never its neighbours in the next run; the first
// order reads y[t-1] from a copy of y shifted one sample back (single
// floats: the shifted run is not 16-byte aligned).  Rings of SQ_RNST runs,
// one ring an array (two or three), fit the 48 KB of static shared
// memory.  The bound is the forward's: the dependent chain, a multiply and
// an add a step (first order), two multiplies and two subtracts (biquad's
// g on g[t+1]'s path); the other operations and the float64 adds are off
// it.

#define SQ_RNST 3               // runs in a thread's ring, reverse modes

// Copy run k of a row shifted one sample back: samples [k * SQ_RUN - 1,
// (k + 1) * SQ_RUN - 1) clipped to [0, T), the rest zero-filled.
__device__ __forceinline__ void load_run_prev(float* slot, const float* row,
                                              long long T, long long k) {
  const long long s0 = k * SQ_RUN - 1;
#pragma unroll
  for (int e = 0; e < SQ_RUN; ++e) {
    const long long i = s0 + e;
    const bool ok = i >= 0 && i < T;
    cp_async4(slot + e, ok ? row + i : row, ok ? 4 : 0);
  }
}

// ybar [R, T] the output's cotangent; a the first order's coefficient (one
// float or [R, T]); y [R, T] the forward's output; x [R, T] the biquad's
// input; coef its (a1, a2, b0, b1, b2); s_in the forward's initial state
// ([R] y0, or [R, 4] (x1, x2, y1, y2)).  Out: gx [R, T] (bbar = lam, or
// xbar), ga [R, T] (abar, per-sample mode), s_out the initial state's
// gradient ([R] or [R, 4]), acc the coefficients' float64 row sums ([R]
// for one first-order coefficient, [R, 5] for the biquad).
template <int MODE>
__global__ void __launch_bounds__(SQ_THREADS)
sequential_reverse_kernel(const float* __restrict__ ybar,
                          const float* __restrict__ a,
                          const float* __restrict__ y,
                          const float* __restrict__ x,
                          const float* __restrict__ coef,
                          const float* __restrict__ s_in,
                          float* __restrict__ gx, float* __restrict__ ga,
                          float* __restrict__ s_out,
                          double* __restrict__ acc, int R, long long T,
                          int vec) {
  constexpr int NA = MODE == SQ_FIRST_ORDER ? 2 : 3;
  // ring 0 ybar; ring 1 y[t-1] (first order) or x (biquad); ring 2 a
  // (per-sample) or y (biquad)
  __shared__ __align__(16) float ring[NA][SQ_RNST][SQ_THREADS * SQ_LD];
  const int lane = threadIdx.x;
  const long long r = (long long)blockIdx.x * SQ_THREADS + lane;
  if (r >= R) return;
  const float* br = ybar + r * T;
  const float* yr = y + r * T;
  const float* xr = MODE == SQ_BIQUAD ? x + r * T : nullptr;
  const float* ar = MODE == SQ_FIRST_ORDER_PS ? a + r * T : nullptr;
  float* gr = gx + r * T;
  float* gar = MODE == SQ_FIRST_ORDER_PS ? ga + r * T : nullptr;
  const long long n_runs = (T + SQ_RUN - 1) / SQ_RUN;

  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (MODE == SQ_BIQUAD) {
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = coef[i];
  }
  // first order: lam, the next sample's coefficient, y0; biquad: g[t+1],
  // g[t+2]
  float lam = 0.f, a_next = MODE == SQ_FIRST_ORDER ? a[0] : 0.f;
  float g1 = 0.f, g2 = 0.f;
  double d[5] = {0.0, 0.0, 0.0, 0.0, 0.0};

  // the j-th run of the walk is run n_runs - 1 - j
  auto issue = [&](long long j) {
    asm volatile("" ::: "memory");
    if (j < n_runs) {
      const long long k = n_runs - 1 - j;
      const int st = (int)(j % SQ_RNST);
      load_run(&ring[0][st][lane * SQ_LD], br, T, k, vec);
      if (MODE == SQ_BIQUAD) {
        load_run(&ring[1][st][lane * SQ_LD], xr, T, k, vec);
        load_run(&ring[NA - 1][st][lane * SQ_LD], yr, T, k, vec);
      } else {
        load_run_prev(&ring[1][st][lane * SQ_LD], yr, T, k);
        if (MODE == SQ_FIRST_ORDER_PS)
          load_run(&ring[NA - 1][st][lane * SQ_LD], ar, T, k, vec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int j = 0; j < SQ_RNST - 1; ++j) issue(j);

  for (long long j = 0; j < n_runs; ++j) {
    const long long k = n_runs - 1 - j;
    issue(j + SQ_RNST - 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(SQ_RNST - 1) : "memory");
    const int st = (int)(j % SQ_RNST);
    float v[SQ_RUN], w[SQ_RUN], u[SQ_RUN];
    read_run(v, &ring[0][st][lane * SQ_LD]);
    read_run(w, &ring[1][st][lane * SQ_LD]);
    if (NA == 3) read_run(u, &ring[NA - 1][st][lane * SQ_LD]);
    if (MODE != SQ_BIQUAD && k == 0) w[0] = s_in[r];       // y[-1] = y0
    const long long left = T - k * SQ_RUN;
#pragma unroll
    for (int i = SQ_RUN - 1; i >= 0; --i) {
      if (left >= SQ_RUN || i < left) {
        if (MODE == SQ_BIQUAD) {
          const float g = __fsub_rn(__fsub_rn(v[i], __fmul_rn(c[0], g1)),
                                    __fmul_rn(c[1], g2));
          const float xb = __fadd_rn(__fadd_rn(__fmul_rn(c[2], g),
                                               __fmul_rn(c[3], g1)),
                                     __fmul_rn(c[4], g2));
          d[0] = __dadd_rn(d[0], (double)__fmul_rn(g1, u[i]));
          d[1] = __dadd_rn(d[1], (double)__fmul_rn(g2, u[i]));
          d[2] = __dadd_rn(d[2], (double)__fmul_rn(g, w[i]));
          d[3] = __dadd_rn(d[3], (double)__fmul_rn(g1, w[i]));
          d[4] = __dadd_rn(d[4], (double)__fmul_rn(g2, w[i]));
          g2 = g1;
          g1 = g;
          v[i] = xb;
        } else {
          lam = __fadd_rn(v[i], __fmul_rn(a_next, lam));
          const float p = __fmul_rn(lam, w[i]);
          v[i] = lam;
          if (MODE == SQ_FIRST_ORDER_PS) {
            w[i] = p;
            a_next = u[i];
          } else {
            d[0] = __dadd_rn(d[0], (double)p);
          }
        }
      }
    }
    store_run(gr, v, T, k, vec);
    if (MODE == SQ_FIRST_ORDER_PS) store_run(gar, w, T, k, vec);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (MODE == SQ_BIQUAD) {
    // g1 = g[0], g2 = g[1]; the initial state's boundary terms
    const float x1 = s_in[4 * r], x2 = s_in[4 * r + 1];
    const float y1 = s_in[4 * r + 2], y2 = s_in[4 * r + 3];
    d[0] = __dadd_rn(d[0], (double)__fmul_rn(g1, y1));
    d[1] = __dadd_rn(d[1], (double)__fmul_rn(g2, y1));
    d[1] = __dadd_rn(d[1], (double)__fmul_rn(g1, y2));
    d[3] = __dadd_rn(d[3], (double)__fmul_rn(g1, x1));
    d[4] = __dadd_rn(d[4], (double)__fmul_rn(g2, x1));
    d[4] = __dadd_rn(d[4], (double)__fmul_rn(g1, x2));
    s_out[4 * r] = __fadd_rn(__fmul_rn(c[3], g1), __fmul_rn(c[4], g2));
    s_out[4 * r + 1] = __fmul_rn(c[4], g1);
    s_out[4 * r + 2] = __fsub_rn(-__fmul_rn(c[0], g1), __fmul_rn(c[1], g2));
    s_out[4 * r + 3] = -__fmul_rn(c[1], g1);
    acc[5 * r] = -d[0];
    acc[5 * r + 1] = -d[1];
#pragma unroll
    for (int i = 2; i < 5; ++i) acc[5 * r + i] = d[i];
  } else {
    s_out[r] = __fmul_rn(a_next, lam);                  // a[0] * lam[0]
    if (MODE == SQ_FIRST_ORDER) acc[r] = d[0];
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

// One reverse solve on `stream` (see sequential_reverse_kernel): mode 0 the
// first order with one coefficient (a points at it; acc [R]), 1 with a
// per-sample coefficient (a and ga [R, T]), 2 the biquad (x, coef; acc
// [R, 5]).  The 16-byte copies and stores are taken when every array read
// or written a run at a time starts 16-byte aligned.  Returns the
// cudaGetLastError() code of the launch, 0 on success.
extern "C" int sequential_reverse_launch(int mode, const float* ybar,
                                         const float* a, const float* y,
                                         const float* x, const float* coef,
                                         const float* s_in, float* gx,
                                         float* ga, float* s_out,
                                         double* acc, int R, long long T,
                                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R < 1 || T < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = al(ybar) && al(gx) && T % 4 == 0
      && (mode != SQ_FIRST_ORDER_PS || (al(a) && al(ga)))
      && (mode != SQ_BIQUAD || (al(x) && al(y)));
  const unsigned grid = (unsigned)((R + SQ_THREADS - 1) / SQ_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SQ_FIRST_ORDER)
    sequential_reverse_kernel<SQ_FIRST_ORDER><<<grid, SQ_THREADS, 0, st>>>(
        ybar, a, y, x, coef, s_in, gx, ga, s_out, acc, R, T, vec);
  else if (mode == SQ_FIRST_ORDER_PS)
    sequential_reverse_kernel<SQ_FIRST_ORDER_PS><<<grid, SQ_THREADS, 0, st>>>(
        ybar, a, y, x, coef, s_in, gx, ga, s_out, acc, R, T, vec);
  else
    sequential_reverse_kernel<SQ_BIQUAD><<<grid, SQ_THREADS, 0, st>>>(
        ybar, a, y, x, coef, s_in, gx, ga, s_out, acc, R, T, vec);
  return (int)cudaGetLastError();
}
