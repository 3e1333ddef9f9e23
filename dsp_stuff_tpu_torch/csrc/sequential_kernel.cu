// sequential_kernel.cu -- the exact policy's per-sample recurrences, in the
// reference's operation order, one rounding an operation:
//   first order   y[t] = a[t] * y[t-1] + b[t]           (a scalar or per sample)
//   DF1 biquad    y[t] = b0*x[t] + b1*x[t-1] + b2*x[t-2] - a1*y[t-1] - a2*y[t-2]
//                 summed left to right, each product rounded on its own
// over [R, T] rows, one thread a row walking it in time order, and their
// reverse mode (below).
//
// No TPU kernel of the JAX package computes these: its exact policy runs
// them as lax.scan loops, dsp_stuff_tpu/ops/scan.py:_first_order_sequential
// (:299) and _biquad_sequential (:745), one device loop each.  This kernel
// is their counterpart on the card, one launch a solve.  The plain PyTorch
// versions are the loops of the same names in ops/scan.py; the wrapper is
// ops/sequential_kernel.py.
//
// Rounding.  Every operation is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn / __dadd_rn in the reference's order, so the result does not
// rest on the build's -fmad=false alone: it is bitwise the plain loop's,
// on the card and on the CPU, and the reference's.
//
// What bounds it.  The dependent chain of a row: per step a multiply and
// an add for the first order, and for the biquad a multiply and two
// subtracts on y[t-1]'s path (the x terms and a2*y[t-2] are off it).  At 4
// cycles an operation that is 2 x 4 and 3 x 4 cycles a sample, 1.94 and
// 2.91 ms for 480,000 samples at 1.98 GHz, whatever the number of rows.
// The bytes (x or b read once, y written once, 8 bytes a sample; 12 with a
// per-sample a) take 0.59 ms at [512, 480,000], so the chain bounds it.
//
// The design: a CTA owns 32 rows, lane l of each of its warps row l, and
// gives each warp one job, so that the warp that runs the chain issues
// nothing else (a warp issues in order: what it does besides the chain
// waits behind it).
//   * the memory warp copies [32 rows x SQ_RUN samples] tiles of each
//     input into a ring of SQ_NST stages in shared memory (cp.async,
//     arriving on the stage's full barrier as they land) and writes the
//     finished tiles back.  Its lanes walk a tile's rows together, so each
//     instruction moves contiguous bytes: 16-byte pieces, half a warp a
//     row, where every row start is 16-byte aligned and T % 4 == 0, else
//     single floats, the warp on 32 samples of a row;
//   * the chain warp waits for a tile, reads its row's samples as 16-byte
//     loads, runs the chain, writes the results in place and arrives;
//   * the biquad's prep warp computes p = (b0*x + b1*x1) + b2*x2 in place
//     before the chain warp reads it: the reference sums left to right,
//     so the x terms are one rounded value before a y term comes in, and
//     the chain is out = (p - a1*y1) - a2*y2, bitwise the same.
// Stage s has three mbarriers: full (the copies landed), ready (prep's p,
// or in reverse the chain's tile), done (the tile's last consumer; the
// memory warp then stores it and refills the stage).  Rows are SQ_LD
// floats apart in a tile, so a warp's 16-byte reads of 32 rows are free
// of bank conflicts.  The ring is dynamic shared memory (up to 204 KB).
// Each walk over a tile has a full-tile form and a tail form: a guard
// inside the loop would put a select on every loop-carried chain.
// Per-row cp.async.bulk copies (the TMA engine, one a row a tile each
// way) measured slower than these copies (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#define SQ_ROWS 32              // rows of a CTA (a lane of each warp a row)
#ifndef SQ_RUN
#define SQ_RUN 64               // samples of a tile (a multiple of 4)
#endif
#ifndef SQ_NST
#define SQ_NST 6                // stages of the ring
#endif
#define SQ_LD (SQ_RUN + 4)      // floats between two rows of a tile
#define SQ_TILE (SQ_ROWS * SQ_LD)     // floats of one array's tile
#define SQ_BAR_BYTES 256        // the barriers, ahead of the tiles
#define SQ_MAX_WARPS 5
#define SQ_MAX_DEVICES 64

enum { SQ_FIRST_ORDER = 0, SQ_FIRST_ORDER_PS = 1, SQ_BIQUAD = 2 };
// the warps of a CTA: memory, chain, then prep (forward biquad) or the
// reverse mode's epilogues (one, three for the biquad)
enum { SQ_W_MEM = 0, SQ_W_CHAIN = 1, SQ_W_SIDE = 2 };

// tile arrays of the ring, warps and shared-memory bytes of each instance
__host__ __device__ constexpr int fwd_arrays(int mode) {
  return mode == SQ_FIRST_ORDER_PS ? 2 : 1;
}
__host__ __device__ constexpr int fwd_warps(int mode) {
  return mode == SQ_BIQUAD ? 3 : 2;
}
__host__ __device__ constexpr int rev_loads(int mode) {
  return mode == SQ_FIRST_ORDER ? 2 : 3;
}
__host__ __device__ constexpr int rev_arrays(int mode) {
  return rev_loads(mode) + (mode == SQ_BIQUAD ? 1 : 0);
}
__host__ __device__ constexpr int rev_epilogues(int mode) {
  return mode == SQ_BIQUAD ? 3 : 1;
}
__host__ __device__ constexpr int rev_warps(int mode) {
  return 2 + rev_epilogues(mode);
}
__host__ __device__ constexpr int smem_bytes(int arrays) {
  return SQ_BAR_BYTES + arrays * SQ_NST * SQ_TILE * (int)sizeof(float);
}
static_assert(smem_bytes(4) <= 232448, "the ring exceeds a CTA's 227 KB");
static_assert(SQ_NST >= 2, "the first order's reverse reads the next tile");

// SQ_PHASES, a measuring build: each warp's clock cycles by phase (0
// waiting on a barrier, 1 its work, 2 the memory warp's copies into the
// ring, 3 the rest), lane 0's summed over the CTAs into sq_phases[warp],
// which sequential_phases() reads.
#ifdef SQ_PHASES
__device__ unsigned long long sq_phases[SQ_MAX_WARPS][4];
#define PH_OPEN() \
  long long ph_t = clock64(); \
  unsigned long long ph[4] = {0, 0, 0, 0}
#define PH(k) \
  do { \
    const long long t_ = clock64(); \
    ph[k] += (unsigned long long)(t_ - ph_t); \
    ph_t = t_; \
  } while (0)
#define PH_CLOSE(warp) \
  do { \
    PH(3); \
    if ((threadIdx.x & 31) == 0) \
      for (int k_ = 0; k_ < 4; ++k_) atomicAdd(&sq_phases[warp][k_], ph[k_]); \
  } while (0)
#else
#define PH_OPEN() do {} while (0)
#define PH(k) do {} while (0)
#define PH_CLOSE(warp) do {} while (0)
#endif

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(sa(b)), "r"(count) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile("{\n"
               ".reg .pred p;\n"
               "SQ_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra SQ_WAIT;\n"
               "}\n" :: "r"(sa(b)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(sa(b)) : "memory");
}

// the thread's earlier cp.async copies arrive on b once they have landed
__device__ __forceinline__ void bar_arrive_cp(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(sa(b)) : "memory");
}

__device__ __forceinline__ void cp_async16(const float* dst,
                                           const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(sa(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(const float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(sa(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  float4 q;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
               : "r"(sa(p)) : "memory");
  return q;
}

__device__ __forceinline__ void sts4(const float* p, float4 q) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(sa(p)), "f"(q.x), "f"(q.y), "f"(q.z), "f"(q.w)
               : "memory");
}

__device__ __forceinline__ void read_run(float (&v)[SQ_RUN],
                                         const float* row) {
#pragma unroll
  for (int e = 0; e < SQ_RUN; e += 4) {
    const float4 q = lds4(row + e);
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
  }
}

__device__ __forceinline__ void write_run(float* row,
                                          const float (&v)[SQ_RUN]) {
#pragma unroll
  for (int e = 0; e < SQ_RUN; e += 4)
    sts4(row + e, make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
}

// f(e) for each sample e of a tile with `left` samples (all SQ_RUN when
// left >= SQ_RUN), ascending or descending; the full tile's loop has no
// guard.
template <bool DESC, typename F>
__device__ __forceinline__ void walk(long long left, F&& f) {
  if (left >= SQ_RUN) {
#pragma unroll
    for (int k = 0; k < SQ_RUN; ++k) f(DESC ? SQ_RUN - 1 - k : k);
  } else {
#pragma unroll
    for (int k = 0; k < SQ_RUN; ++k) {
      const int e = DESC ? SQ_RUN - 1 - k : k;
      if (e < left) f(e);
    }
  }
}

// The ring in dynamic shared memory: per stage the full, ready and done
// barriers, then the tiles, [array][stage][row][SQ_LD].
struct Ring {
  uint64_t* bar;
  float* tiles;
  int lane;
  __device__ uint64_t* full(int s) const { return bar + s; }
  __device__ uint64_t* ready(int s) const { return bar + SQ_NST + s; }
  __device__ uint64_t* done(int s) const { return bar + 2 * SQ_NST + s; }
  __device__ float* tile(int a, int s) const {
    return tiles + (a * SQ_NST + s) * SQ_TILE;
  }
  __device__ float* row(int a, int s) const {
    return tile(a, s) + lane * SQ_LD;
  }
};

__device__ __forceinline__ Ring ring_open(unsigned char* smem, int n_done) {
  Ring g{reinterpret_cast<uint64_t*>(smem),
         reinterpret_cast<float*>(smem + SQ_BAR_BYTES),
         (int)(threadIdx.x & 31)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < SQ_NST; ++s) {
      bar_init(g.full(s), SQ_ROWS);
      bar_init(g.ready(s), SQ_ROWS);
      bar_init(g.done(s), n_done);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return g;
}

// Stage and phase parity of the walk's i-th tile.
__device__ __forceinline__ int stage(long long i) {
  return (int)(i % SQ_NST);
}
__device__ __forceinline__ uint32_t parity(long long i) {
  return (uint32_t)((i / SQ_NST) & 1);
}

// The memory warp.  It copies the CTA's tiles of the NI arrays in[]
// (rows r0 .. r0 + 31, [R, T] each) into ring arrays 0..NI-1, SQ_NST tiles
// ahead, and once a tile's done barrier completes writes ring arrays oa[]
// of it to out[]; the walk's i-th tile is samples [k * SQ_RUN, ...)
// clipped to T, k = i (forward) or n - 1 - i (reverse).
template <int NI, int NO>
__device__ void memory_warp(const Ring& g, const float* const (&in)[3],
                            float* const (&out)[2], const int (&oa)[2],
                            long long r0, int R, long long T, long long n,
                            bool rev, int vec) {
  constexpr int NP = SQ_RUN / 4;         // 16-byte pieces of a tile's row
  constexpr int RPI = 32 / NP;           // rows an instruction moves
  constexpr int NJ = SQ_ROWS / RPI;      // instructions a tile
  static_assert(SQ_RUN % 4 == 0 && 32 % NP == 0, "SQ_RUN: 4 .. 128");
  const int rows = (int)(R - r0 < SQ_ROWS ? R - r0 : SQ_ROWS);
  const int lane = g.lane;
  // where vec, lane l moves the 16-byte piece at sample e0 of rows h0,
  // h0 + RPI, ...; else single floats, samples l, l + 32, ... of each row
  const int e0 = vec ? 4 * (lane % NP) : lane;
  const int h0 = vec ? lane / NP : 0;
  auto span = [&](long long i, long long& s0) {
    s0 = (rev ? n - 1 - i : i) * SQ_RUN;
    return (int)(T - s0 < SQ_RUN ? T - s0 : SQ_RUN);
  };
  auto load = [&](long long i) {
    const int s = stage(i);
    long long s0;
    const int len = span(i, s0);
#ifndef SQ_NO_LOADS                      // a measuring build: no loads
#pragma unroll
    for (int a = 0; a < NI; ++a) {
      const float* src = in[a] + (r0 + h0) * T + s0 + e0;
      const float* dst = g.tile(a, s) + h0 * SQ_LD + e0;
      if (vec) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (h0 + j * RPI < rows && e0 < len)
            cp_async16(dst + j * RPI * SQ_LD, src);
          src += RPI * T;
        }
      } else {
        for (int h = 0; h < rows; ++h) {
          for (int e = 0; e0 + e < len; e += 32)
            cp_async4(dst + h * SQ_LD + e, src + e);
          src += T;
        }
      }
    }
#endif
    bar_arrive_cp(g.full(s));
  };
  PH_OPEN();
  for (long long i = 0; i < n && i < SQ_NST; ++i) load(i);
  PH(2);
  for (long long i = 0; i < n; ++i) {
    const int s = stage(i);
    bar_wait(g.done(s), parity(i));
    PH(0);
#ifndef SQ_NO_STORES                     // a measuring build: no stores
    long long s0;
    const int len = span(i, s0);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float* dst = out[o] + (r0 + h0) * T + s0 + e0;
      const float* src = g.tile(oa[o], s) + h0 * SQ_LD + e0;
      if (vec) {
        // the tile's pieces into registers first, then out
        float4 q[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) q[j] = lds4(src + j * RPI * SQ_LD);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (h0 + j * RPI < rows && e0 < len)
            *reinterpret_cast<float4*>(dst) = q[j];
          dst += RPI * T;
        }
      } else {
        for (int h = 0; h < rows; ++h) {
          for (int e = 0; e0 + e < len; e += 32) dst[e] = src[h * SQ_LD + e];
          dst += T;
        }
      }
    }
#endif
    // keeps the stores' shared-memory reads above the refill's copies
    asm volatile("" ::: "memory");
    PH(1);
    if (i + SQ_NST < n) load(i + SQ_NST);
    PH(2);
  }
  PH_CLOSE(SQ_W_MEM);
}

// The forward step on the chain warp.  First order: y = a*y + b; biquad:
// out = (p - a1*y1) - a2*y2 with the prep warp's p.  c = (a1, a2, ...).
template <int MODE>
__device__ __forceinline__ float step(float& y1, float& y2, float v, float a,
                                      const float (&c)[5]) {
  if (MODE == SQ_BIQUAD) {
    const float out = __fsub_rn(__fsub_rn(v, __fmul_rn(c[0], y1)),
                                __fmul_rn(c[1], y2));
    y2 = y1;
    y1 = out;
    return out;
  }
  y1 = __fadd_rn(__fmul_rn(a, y1), v);
  return y1;
}

// x [R, T] (the biquad's input, the first order's b); a the first order's
// coefficient (one float, or [R, T] per sample); c the biquad's (a1, a2,
// b0, b1, b2); s_in / s_out the states ([R] y for the first order, [R, 4]
// (x1, x2, y1, y2) for the biquad).  Ring array 0: x, then p (biquad),
// then y; array 1: a (per sample).
template <int MODE>
__global__ void __launch_bounds__(32 * 3)
sequential_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ coef,
                  const float* __restrict__ s_in, float* __restrict__ y,
                  float* __restrict__ s_out, int R, long long T, int vec) {
  extern __shared__ __align__(128) unsigned char sq_smem[];
  const Ring g = ring_open(sq_smem, SQ_ROWS);
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * SQ_ROWS + g.lane;
  const bool ok = r < R;
  const long long n = (T + SQ_RUN - 1) / SQ_RUN;
  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (MODE == SQ_BIQUAD) {
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = coef[i];
  }

  if (warp == SQ_W_MEM) {
#ifndef SQ_CHAIN_ONLY
    const float* in[3] = {x, a, x};
    float* out[2] = {y, y};
    const int oa[2] = {0, 0};
    memory_warp<fwd_arrays(MODE), 1>(g, in, out, oa, r - g.lane, R, T, n,
                                     false, vec);
#endif
  } else if (warp == SQ_W_CHAIN) {
    float y1 = 0.f, y2 = 0.f;
    const float a0 = MODE == SQ_FIRST_ORDER ? a[0] : 0.f;
    if (ok) {
      if (MODE == SQ_BIQUAD) {
        y1 = s_in[4 * r + 2];
        y2 = s_in[4 * r + 3];
      } else {
        y1 = s_in[r];
      }
    }
    PH_OPEN();
    for (long long i = 0; i < n; ++i) {
      const int s = stage(i);
      float v[SQ_RUN], av[SQ_RUN];
#ifdef SQ_CHAIN_ONLY
      // a measuring build: the chain alone, on values made in registers
#pragma unroll
      for (int u = 0; u < SQ_RUN; ++u) {
        v[u] = 1e-3f * (float)(u + (int)i);
        av[u] = 0.5f;
      }
#else
      PH(3);
      bar_wait(MODE == SQ_BIQUAD ? g.ready(s) : g.full(s), parity(i));
      PH(0);
      read_run(v, g.row(0, s));
      if (MODE == SQ_FIRST_ORDER_PS) read_run(av, g.row(1, s));
#endif
      walk<false>(T - i * SQ_RUN, [&](int u) {
        v[u] = step<MODE>(y1, y2, v[u],
                          MODE == SQ_FIRST_ORDER_PS ? av[u] : a0, c);
      });
#ifdef SQ_CHAIN_ONLY
      if (v[0] == 12345.f) y[0] = v[SQ_RUN - 1];     // keeps the chain live
#else
      write_run(g.row(0, s), v);
      bar_arrive(g.done(s));
      PH(1);
#endif
    }
    PH_CLOSE(SQ_W_CHAIN);
    if (ok) {
      if (MODE == SQ_BIQUAD) {
        s_out[4 * r + 2] = y1;
        s_out[4 * r + 3] = y2;
      } else {
        s_out[r] = y1;
      }
    }
  } else if (MODE == SQ_BIQUAD) {
#ifndef SQ_CHAIN_ONLY
    // the prep warp: p = (b0*x + b1*x1) + b2*x2 in place of x, the x
    // history in registers across tiles
    float x1 = ok ? s_in[4 * r] : 0.f, x2 = ok ? s_in[4 * r + 1] : 0.f;
    PH_OPEN();
    for (long long i = 0; i < n; ++i) {
      const int s = stage(i);
      float v[SQ_RUN];
      PH(3);
      bar_wait(g.full(s), parity(i));
      PH(0);
      read_run(v, g.row(0, s));
      walk<false>(T - i * SQ_RUN, [&](int u) {
        const float p = __fadd_rn(__fadd_rn(__fmul_rn(c[2], v[u]),
                                            __fmul_rn(c[3], x1)),
                                  __fmul_rn(c[4], x2));
        x2 = x1;
        x1 = v[u];
        v[u] = p;
      });
      write_run(g.row(0, s), v);
      bar_arrive(g.ready(s));
      PH(1);
    }
    PH_CLOSE(SQ_W_SIDE);
    if (ok) {
      s_out[4 * r] = x1;
      s_out[4 * r + 1] = x2;
    }
#endif
  }
}

// ---------------------------------------------------------------------------
// Reverse mode: the adjoints of the three solves, for the exact policy's
// gradients on the card (the counterpart of jax.grad through the JAX
// package's lax.scan loops).  One thread a row walks it backwards in time,
// tile by tile from the last, in f32 with one rounding an operation, the
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
// The plain versions run the chain first and the rest from it; so does
// the kernel, on separate warps.  The chain warp computes only lam (or g),
// in place of ybar, and arrives on the stage's ready barrier.  The
// epilogue warps then compute everything else from that tile: the first
// order's abar from lam and y[t-1] (y's tile, and at the tile's first
// sample the last of the tile before it in time, which the walk meets
// next: the ring holds it, SQ_NST >= 2) and its float64 sum; for the
// biquad three warps, the a1 and a2 sums, the b0 and b1 sums, the b2 sum
// and xbar (into a tile of its own), each sum in its own order, their
// histories g[t+1], g[t+2] in registers across tiles.  A float64 sum costs
// its SM sub-partition a conversion a sample, which the card does at a
// fraction of its FP32 rate: the sums are spread over warps (warp w runs
// on sub-partition w % 4), and the biquad's five set its pace (the
// SQ_NO_F64 probe).  The bound is the forward's chain.

// The biquad's coefficients j = 0..4 (a1, a2, b0, b1, b2): the row sum of
// j is over g[t + kof(j)] z[t], z = y for the a's (ring array 2), x for the
// b's (array 1).
__host__ __device__ constexpr int kof(int j) {
  return j == 2 ? 0 : j == 1 || j == 4 ? 2 : 1;
}

// A biquad epilogue warp: the row sums of coefficients J0 .. J0 + NS - 1
// (all over one z), then their boundary terms; with XBAR also xbar (into
// ring array 3) and the initial state's gradient.
template <int J0, int NS, bool XBAR>
__device__ void biquad_epilogue(const Ring& g, const float (&c)[5],
                                const float* __restrict__ s_in,
                                float* __restrict__ s_out,
                                double* __restrict__ acc, long long r,
                                bool ok, long long T, long long n) {
  constexpr int Z = J0 < 2 ? 2 : 1;      // ring array of y or x
  double d[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) d[j] = 0.0;
  float g1 = 0.f, g2 = 0.f;              // g[t+1], g[t+2]
  PH_OPEN();
  for (long long i = 0; i < n; ++i) {
    const int s = stage(i);
    float v[SQ_RUN], w[SQ_RUN];
    PH(3);
    bar_wait(g.ready(s), parity(i));
    PH(0);
    read_run(v, g.row(0, s));            // g
    read_run(w, g.row(Z, s));
    walk<true>(T - (n - 1 - i) * SQ_RUN, [&](int e) {
      const float gt = v[e];
#ifndef SQ_NO_F64
#pragma unroll
      for (int j = 0; j < NS; ++j)
        d[j] = __dadd_rn(d[j], (double)__fmul_rn(
            kof(J0 + j) == 0 ? gt : kof(J0 + j) == 1 ? g1 : g2, w[e]));
#endif
      if (XBAR)
        v[e] = __fadd_rn(__fadd_rn(__fmul_rn(c[2], gt), __fmul_rn(c[3], g1)),
                         __fmul_rn(c[4], g2));
      g2 = g1;
      g1 = gt;
    });
    if (XBAR) write_run(g.row(3, s), v);
    bar_arrive(g.done(s));
    PH(1);
  }
  PH_CLOSE(SQ_W_SIDE + J0 / 2);
  if (!ok) return;
  // g1 = g[0], g2 = g[1]; z[-1], z[-2] are the initial (y1, y2) or (x1, x2)
  const float z1 = s_in[4 * r + (Z == 2 ? 2 : 0)];
  const float z2 = s_in[4 * r + (Z == 2 ? 3 : 1)];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (kof(J0 + j) == 1) {
      d[j] = __dadd_rn(d[j], (double)__fmul_rn(g1, z1));
    } else if (kof(J0 + j) == 2) {
      d[j] = __dadd_rn(d[j], (double)__fmul_rn(g2, z1));
      d[j] = __dadd_rn(d[j], (double)__fmul_rn(g1, z2));
    }
    acc[5 * r + J0 + j] = J0 + j < 2 ? -d[j] : d[j];
  }
  if (XBAR) {
    s_out[4 * r] = __fadd_rn(__fmul_rn(c[3], g1), __fmul_rn(c[4], g2));
    s_out[4 * r + 1] = __fmul_rn(c[4], g1);
    s_out[4 * r + 2] = __fsub_rn(-__fmul_rn(c[0], g1), __fmul_rn(c[1], g2));
    s_out[4 * r + 3] = -__fmul_rn(c[1], g1);
  }
}

// ybar [R, T] the output's cotangent; a the first order's coefficient (one
// float or [R, T]); y [R, T] the forward's output; x [R, T] the biquad's
// input; coef its (a1, a2, b0, b1, b2); s_in the forward's initial state
// ([R] y0, or [R, 4] (x1, x2, y1, y2)).  Out: gx [R, T] (bbar = lam, or
// xbar), ga [R, T] (abar, per-sample mode), s_out the initial state's
// gradient ([R] or [R, 4]), acc the coefficients' float64 row sums ([R]
// for one first-order coefficient, [R, 5] for the biquad).  Ring arrays:
// 0 ybar, then lam or g; 1 y (first order) or x (biquad); 2 a, then abar
// (per sample), or y (biquad); 3 xbar (biquad).
template <int MODE>
__global__ void __launch_bounds__(32 * SQ_MAX_WARPS)
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
  constexpr bool BQ = MODE == SQ_BIQUAD, PS = MODE == SQ_FIRST_ORDER_PS;
  extern __shared__ __align__(128) unsigned char sq_smem[];
  const Ring g = ring_open(sq_smem, SQ_ROWS * rev_epilogues(MODE));
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * SQ_ROWS + g.lane;
  const bool ok = r < R;
  const long long n = (T + SQ_RUN - 1) / SQ_RUN;
  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (BQ) {
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = coef[i];
  }

  if (warp == SQ_W_MEM) {
#ifndef SQ_CHAIN_ONLY
    const float* in[3] = {ybar, BQ ? x : y, BQ ? y : a};
    float* out[2] = {gx, ga};
    const int oa[2] = {BQ ? 3 : 0, 2};
    memory_warp<rev_loads(MODE), PS ? 2 : 1>(g, in, out, oa, r - g.lane, R,
                                             T, n, true, vec);
#endif
  } else if (warp == SQ_W_CHAIN) {
    // first order: lam and the next sample's coefficient; biquad: g[t+1],
    // g[t+2]
    float lam = 0.f, a_next = MODE == SQ_FIRST_ORDER ? a[0] : 0.f;
    float g1 = 0.f, g2 = 0.f;
    PH_OPEN();
    for (long long i = 0; i < n; ++i) {
      const int s = stage(i);
      float v[SQ_RUN], u[SQ_RUN];
#ifdef SQ_CHAIN_ONLY
      // a measuring build: the chain alone, on values made in registers;
      // no copies, no stores, none of the chain's consumers
#pragma unroll
      for (int e = 0; e < SQ_RUN; ++e) {
        v[e] = 1e-3f * (float)(e + (int)i);
        u[e] = 0.5f;
      }
#else
      PH(3);
      bar_wait(g.full(s), parity(i));
      PH(0);
      read_run(v, g.row(0, s));
      if (PS) read_run(u, g.row(2, s));
#endif
      walk<true>(T - (n - 1 - i) * SQ_RUN, [&](int e) {
        if (BQ) {
          const float gt = __fsub_rn(__fsub_rn(v[e], __fmul_rn(c[0], g1)),
                                     __fmul_rn(c[1], g2));
          g2 = g1;
          g1 = gt;
          v[e] = gt;
        } else {
          lam = __fadd_rn(v[e], __fmul_rn(a_next, lam));
          v[e] = lam;
          if (PS) a_next = u[e];
        }
      });
#ifdef SQ_CHAIN_ONLY
      if (lam == 12345.f || g1 == 12345.f) gx[0] = lam + g1;  // keeps it live
#else
      write_run(g.row(0, s), v);
      bar_arrive(g.ready(s));
      PH(1);
#endif
    }
    PH_CLOSE(SQ_W_CHAIN);
    if (ok && !BQ) s_out[r] = __fmul_rn(a_next, lam);     // a[0] * lam[0]
  } else {
#ifndef SQ_CHAIN_ONLY
    if constexpr (BQ) {
      // a1, a2; b0, b1; b2 and xbar
      if (warp == SQ_W_SIDE)
        biquad_epilogue<0, 2, false>(g, c, s_in, s_out, acc, r, ok, T, n);
      else if (warp == SQ_W_SIDE + 1)
        biquad_epilogue<2, 2, false>(g, c, s_in, s_out, acc, r, ok, T, n);
      else
        biquad_epilogue<4, 1, true>(g, c, s_in, s_out, acc, r, ok, T, n);
      return;
    }
    double d = 0.0;
    const float y0 = ok ? s_in[r] : 0.f;
    PH_OPEN();
    for (long long i = 0; i < n; ++i) {
      const int s = stage(i);
      const long long k = n - 1 - i;
      float v[SQ_RUN], w[SQ_RUN];
      PH(3);
      bar_wait(g.ready(s), parity(i));
      PH(0);
      read_run(v, g.row(0, s));          // lam
      // y[t-1]: this tile's y, at its first sample the last y of tile
      // k - 1, the walk's next
      float y_edge = y0;
      if (k > 0) {
        PH(1);
        bar_wait(g.full(stage(i + 1)), parity(i + 1));
        PH(0);
        y_edge = g.row(1, stage(i + 1))[SQ_RUN - 1];
      }
      read_run(w, g.row(1, s));
      walk<true>(T - k * SQ_RUN, [&](int e) {
        v[e] = __fmul_rn(v[e], e ? w[e - 1] : y_edge);      // abar
#ifndef SQ_NO_F64
        if (!PS) d = __dadd_rn(d, (double)v[e]);
#endif
      });
      if (PS) write_run(g.row(2, s), v);
      bar_arrive(g.done(s));
      PH(1);
    }
    PH_CLOSE(SQ_W_SIDE);
    if (ok && !PS) acc[r] = d;
#endif
  }
}

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device (once a device and instance: the first launch is never inside a
// graph capture, the callers warm up first).
template <typename K>
static cudaError_t allow_smem(K kernel, int bytes, int device, int slot) {
  static bool set[SQ_MAX_DEVICES][6];
  if (device >= 0 && device < SQ_MAX_DEVICES && set[device][slot])
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && device >= 0 && device < SQ_MAX_DEVICES)
    set[device][slot] = true;
  return e;
}

template <int MODE>
static cudaError_t launch_forward(const float* x, const float* a,
                                  const float* coef, const float* s_in,
                                  float* y, float* s_out, int R, long long T,
                                  int vec, int device, cudaStream_t st) {
  constexpr int bytes = smem_bytes(fwd_arrays(MODE));
  const cudaError_t e = allow_smem(sequential_kernel<MODE>, bytes, device,
                                   MODE);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((R + SQ_ROWS - 1) / SQ_ROWS);
  sequential_kernel<MODE><<<grid, 32 * fwd_warps(MODE), bytes, st>>>(
      x, a, coef, s_in, y, s_out, R, T, vec);
  return cudaGetLastError();
}

template <int MODE>
static cudaError_t launch_reverse(const float* ybar, const float* a,
                                  const float* y, const float* x,
                                  const float* coef, const float* s_in,
                                  float* gx, float* ga, float* s_out,
                                  double* acc, int R, long long T, int vec,
                                  int device, cudaStream_t st) {
  constexpr int bytes = smem_bytes(rev_arrays(MODE));
  const cudaError_t e = allow_smem(sequential_reverse_kernel<MODE>, bytes,
                                   device, 3 + MODE);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((R + SQ_ROWS - 1) / SQ_ROWS);
  sequential_reverse_kernel<MODE><<<grid, 32 * rev_warps(MODE), bytes,
                                    st>>>(ybar, a, y, x, coef, s_in, gx, ga,
                                          s_out, acc, R, T, vec);
  return cudaGetLastError();
}

static bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// One solve on `stream`: mode 0 the first order with one coefficient (a
// points at it), 1 with a per-sample coefficient (a is [R, T]), 2 the
// biquad (coef points at a1, a2, b0, b1, b2).  s_in / s_out: [R] for the
// first order, [R, 4] for the biquad.  The 16-byte copies are taken when
// every row start is 16-byte aligned.  Returns the cudaGetLastError()
// code of the launch, 0 on success.
extern "C" int sequential_kernel_launch(int mode, const float* x,
                                        const float* a, const float* coef,
                                        const float* s_in, float* y,
                                        float* s_out, int R, long long T,
                                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R < 1 || T < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned(x) && aligned(y) && T % 4 == 0
      && (mode != SQ_FIRST_ORDER_PS || aligned(a));
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SQ_FIRST_ORDER)
    e = launch_forward<SQ_FIRST_ORDER>(x, a, coef, s_in, y, s_out, R, T, vec,
                                       device, st);
  else if (mode == SQ_FIRST_ORDER_PS)
    e = launch_forward<SQ_FIRST_ORDER_PS>(x, a, coef, s_in, y, s_out, R, T,
                                          vec, device, st);
  else
    e = launch_forward<SQ_BIQUAD>(x, a, coef, s_in, y, s_out, R, T, vec,
                                  device, st);
  return (int)e;
}

// One reverse solve on `stream` (see sequential_reverse_kernel): mode 0 the
// first order with one coefficient (a points at it; acc [R]), 1 with a
// per-sample coefficient (a and ga [R, T]), 2 the biquad (x, coef; acc
// [R, 5]).  The 16-byte copies are taken when every array read or written
// a tile at a time starts 16-byte aligned.  Returns the cudaGetLastError()
// code of the launch, 0 on success.
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
  const int vec = aligned(ybar) && aligned(gx) && aligned(y) && T % 4 == 0
      && (mode != SQ_FIRST_ORDER_PS || (aligned(a) && aligned(ga)))
      && (mode != SQ_BIQUAD || aligned(x));
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SQ_FIRST_ORDER)
    e = launch_reverse<SQ_FIRST_ORDER>(ybar, a, y, x, coef, s_in, gx, ga,
                                       s_out, acc, R, T, vec, device, st);
  else if (mode == SQ_FIRST_ORDER_PS)
    e = launch_reverse<SQ_FIRST_ORDER_PS>(ybar, a, y, x, coef, s_in, gx, ga,
                                          s_out, acc, R, T, vec, device, st);
  else
    e = launch_reverse<SQ_BIQUAD>(ybar, a, y, x, coef, s_in, gx, ga, s_out,
                                  acc, R, T, vec, device, st);
  return (int)e;
}

#ifdef SQ_PHASES
// The measuring build's cycles by warp and phase, [5][4] into `out`
// (summed over the launches since the last reset), then zeroed if `reset`.
extern "C" int sequential_phases(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sq_phases, sizeof(sq_phases));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[SQ_MAX_WARPS][4] = {};
    e = cudaMemcpyToSymbol(sq_phases, zero, sizeof(sq_phases));
  }
  return (int)e;
}
#endif
