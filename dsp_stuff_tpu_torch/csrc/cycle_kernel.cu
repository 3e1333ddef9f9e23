// cycle_kernel.cu -- a feedback SCC's block program over the whole render.
//
// Replaces dsp_stuff_tpu/ops/pallas_cycle.py:cycle_kernel_call (the Pallas
// cycle kernel of the JAX package) in the PyTorch port.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/cycle_segment.py:interpret; the
// wrapper that generates the program's block code, packs the pointer
// tables, builds, binds and launches it is ops/cycle_kernel.py.
//
// What bounds it.  The feedback: a block's program needs the registers the
// previous block set, so each row walks its K = T/128 blocks one after the
// other, and the signal I/O (one read per feed, one write per tap: 0.15 ms
// of HBM time at 128 rows x 10 s) is small next to that walk.  A block's
// time is its critical path.  The phase probes (tools/measure_torch_cycle.py
// --phases) count it by phase.
//
// Design.  One CTA of 128 threads per stream row; thread c owns sample
// column c of every block.  The block program (cycle_segment's grammar:
// join, lin2, cascade, comb, ew, scale, setreg, tap) is not interpreted
// here: as the TPU kernel is traced once per program, the wrapper writes
// the program's block as straight-line code over the helpers below
// (cy_block in the generated header KERNEL_PROGRAM_H, with every constant
// a literal) and builds this source once per program.  So a block costs
// no instruction loads or dispatch, the SCC's registers are the thread's
// own registers (thread c reads and writes only column c of each; a join
// reads a register before that block's setreg and so sees the previous
// block's value, the reference's one-block feedback latency), and a
// comb's ring index is a constant modulus.
// Everything else a block reads lives in shared memory, at offsets the
// wrapper computes (ops/cycle_kernel.smem_plan) and packs with the
// pointer tables:
// * the external feeds, staged CY_FB blocks ahead: each thread copies its
//   own column of the block CY_FB - 1 ahead with cp.async and waits only
//   for its own copies, so no barrier and no load latency is left on a
//   block's path;
// * per cascade its constants: four reversed, phase-shifted copies of the
//   Toeplitz row h (Ltg[i, c] = h[c - i]), so thread c reads h[c - i..c -
//   i - 3] as one aligned 16-byte load while X[i..i+3] is a broadcast one;
//   W^T, Ecb and ACt; and a double-buffered carry.  The block's input X
//   goes through a double-buffered row of shared memory, so a cascade
//   costs one __syncthreads.  Thread c sums its column's triangle in
//   batches of eight such loads (c/4 + 1 steps); warp 0, whose triangle
//   is the shortest, also computes the next block's carry C' (lane = lane
//   j, quarter of the rows) into the other carry buffer, which the next
//   block's barrier publishes;
// * per comb its ring of NR + 1 blocks (NR = ceil(D/128)): position t mod
//   (NR+1)*128 holds the output at time t.  With the spare block no slot
//   is read and written in the same block, so the comb needs no barrier
//   of its own; a block's read of a slot another thread wrote is ordered
//   by a barrier between blocks (the cascade's, else one at the block's
//   start).  The ring is seeded from the raw ring (the history) at the
//   start and written back to it at the end.
// What does not fit in the card's shared memory per block (a cascade's
// constants, a ring) stays in device memory (a ring then in a
// wrapper-allocated scratch ring of the same NR + 1 blocks); the
// generated code names each placement, so no program size is fixed here.
//
// Raw outputs, in the TPU kernel's layout: per cascade the carry entering
// the last block (padded to 8) and that block's input; per comb the raw
// ring [B, NR*128], slot s = block b mod NR; the final registers.
// cycle_segment.rebuild turns them into node states.
//
// Arithmetic is plain FP32 (-fmad=false; the products use explicit fmaf),
// the function cycle_segment.interpret computes: the joins, scales, combs
// and shapers in its order, the cascade's sums in another.
//
// The record build (-DCY_RECORD, with the generated cy_record lines of
// ops/cycle_kernel.program_source(record=True)) also writes each shaper's
// input to rec [n_ew, B, T]: the residuals of the reverse kernel
// (cycle_reverse_kernel.cu), the only forward values the vjp of the
// block program reads.  Without the define the preprocessed source is the
// render build's.

#include <stdint.h>

// Phase probes, built only by tools/measure_torch_cycle.py --phases
// (-DCY_PHASES): threads 0 and 127 of each CTA (the shortest and the
// longest column of the cascade's triangular product) each add the cycles
// since their last probe to the phase's counter; CY_USE(v) makes the
// probe wait for v (a load's latency lands in the phase that loaded it).
// The counters go to cy_phases at the exit.
#define CY_PH_FEED 0        // the external feeds: issuing the copies, waiting
#define CY_PH_JOIN 1        // join, lin2, scale: reads and arithmetic
#define CY_PH_PRODUCT 2     // the cascade's product X Ltg
#define CY_PH_CARRY 3       // its carry: C Ecb, and warp 0's X W + C ACt
#define CY_PH_COMB 4
#define CY_PH_EW 5          // shapers
#define CY_PH_OUT 6         // taps
#define CY_PH_BARRIER 7     // waiting at __syncthreads
#define CY_PH_BLOCK 8       // the block loop's own work
#define CY_NPH 9
#ifdef CY_PHASES
#define CY_PH_CTAS 4096
__device__ unsigned long long cy_phases[CY_PH_CTAS][2][CY_NPH];
__shared__ unsigned long long cy_acc[2][CY_NPH];
__shared__ long long cy_last[2];
__shared__ int cy_sink;
#define CY_SLOT_ (threadIdx.x == 0 ? 0 : (threadIdx.x == blockDim.x - 1 ? 1 : -1))
#define CY_PHASE(i)                                      \
  do {                                                   \
    const int s_ = CY_SLOT_;                             \
    if (s_ >= 0) {                                       \
      const long long now_ = clock64();                  \
      cy_acc[s_][i] += now_ - cy_last[s_];               \
      cy_last[s_] = now_;                                \
    }                                                    \
  } while (0)
#define CY_USE(v) do { if ((v) == 3.0e-39f) cy_sink = 1; } while (0)
#else
#define CY_PHASE(i) do {} while (0)
#define CY_USE(v) do {} while (0)
#endif

#include "stages.cuh"

#define CY_FB 8                 // feed blocks in flight (a power of two)
// A cascade's constants, floats from its base (ops/cycle_kernel.py:
// cycle_casc_consts): R [4][CY_RS], copy q holding h[128 + q - j] at j
// (zeros outside h: a warp's steps read up to j = 159); W^T [8][CY_WS];
// Ecb [8][128]; ACt [8][8].  CY_RS = 8 (mod 32) floats keeps a quarter
// warp's reads of the four copies on distinct banks.
#define CY_RS 168
#define CY_WS 132
#define CY_OFF_R 0
#define CY_OFF_W (4 * CY_RS)
#define CY_OFF_E (CY_OFF_W + CK_NS * CY_WS)
#define CY_OFF_A (CY_OFF_E + CK_NS * CK_C)
#define CY_NCONST (CY_OFF_A + CK_NS * CK_NS)

// The packed pointer tables, mirrored by ops/cycle_kernel.py (HEADER,
// CASC, COMB); cycle_kernel_abi() lets the wrapper check the sizes.
typedef struct {
  long long off_ext, off_tap, off_reg0, off_reg_out;  // bytes from the base
  long long off_casc, off_comb;
  int n_regs, n_casc, n_comb, n_ext;
  int n_tap, smem_bytes, prog_bytes, sm_feeds;        // sm_*: byte offsets
  int sm_xs, pad0, pad1, pad2;                        // in shared memory
} CyHeader;

typedef struct {
  const float* consts;  // [CY_NCONST] in device memory
  const float* s0;      // [B, 8] the carry entering block 0
  float* carry_out;     // [B, 8] carry entering block K-1
  float* xlast_out;     // [B, 128] input of block K-1
  int sm_consts;        // byte offset of the constants in shared memory,
                        // or -1: they are read from device memory
  int sm_cbuf;          // byte offset of the carry buffers [2][8]
  int n, pad_;
} CyCasc;

typedef struct {
  float* raw;           // [B, rl]: the history in, the raw ring out
  float* scratch;       // [B, rl2]: the working ring when it is not in
                        // shared memory, else null
  int sm_ring;          // byte offset of the working ring [rl2], or -1
  int rl, rl2, pad_;    // rl = NR*128, rl2 = (NR + 1)*128
} CyComb;

// What the block code reads: the pointer tables and the shared-memory
// sections (in shared memory), and where the block is.
struct CyCtx {
  char* ps;                    // the dynamic shared memory
  const float* const* ext;     // [B, T] each
  float* const* tap;           // [B, T] each
  const CyCasc* casc;
  const CyComb* comb;
  float* feeds;                // [n_ext][CY_FB][128]
  float* xs;                   // [2][128]
  float* redm;                 // [4] the shapers' block maxima
  long long row, off;          // the row; this thread's offset in [B, T]
  int K, b, fs, xsel;          // blocks; this block; its feed slot; X row
#ifdef CY_RECORD
  float* rec;                  // [n_ew, B, T] the shapers' inputs
#endif
};

// max over the CTA's 128 values, NaN-propagating; red holds 4 floats
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = maxn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return maxn(maxn(red[0], red[1]), maxn(red[2], red[3]));
}

// Block max over one CTA of 128 threads, one sample each (Fuzz).
struct CtaMax {
  float* red;
  __device__ float operator()(float v) const { return block_max(v, red); }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  // no "memory" clobber: the destination is read only after a
  // cp.async.wait_group (which has one), and the clobber would pin every
  // shared-memory access around each copy
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// This thread's column of every feed's block `blk` into its staging slot
// (zeros past the render), as one cp.async group.
__device__ __forceinline__ void stage_feeds(const CyCtx& x, int n_ext,
                                            long long base, int blk) {
  const int c = threadIdx.x;
  const bool ok = blk < x.K;
  for (int e = 0; e < n_ext; ++e) {
    float* dst = x.feeds + (e * CY_FB + (blk & (CY_FB - 1))) * CK_C + c;
    const float* src = x.ext[e] + (ok ? base + (long long)blk * CK_C + c : 0);
    cp_async4(dst, src, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---- the helpers the generated block code calls ---------------------------

// This thread's sample of feed e in the current block.
__device__ __forceinline__ float cy_feed(const CyCtx& x, int e) {
  return x.feeds[e * (CY_FB * CK_C) + x.fs + threadIdx.x];
}

__device__ __forceinline__ void cy_tap(const CyCtx& x, int t, float v) {
  x.tap[t][x.off] = v;
  CY_PHASE(CY_PH_OUT);
}

// A shaper with literal op and params (ops/shaping.py via stages.cuh).
template <int OP>
__device__ __forceinline__ float cy_ew(const CyCtx& x, float v, float p0,
                                       float p1, float p2, float p3) {
  const float p[4] = {p0, p1, p2, p3};
  float a[1] = {v};
  apply_ew<1>(OP, p, a, CtaMax{x.redm});
  CY_USE(a[0]);
  CY_PHASE(CY_PH_EW);
  return a[0];
}

// y = x + decay * y[t - D] over comb k's working ring (SM: in shared
// memory, else the scratch ring).
template <int D, bool SM>
__device__ __forceinline__ float cy_comb(const CyCtx& x, int k, float v,
                                         float decay) {
  constexpr int RL2 = ((D + CK_C - 1) / CK_C + 1) * CK_C;
  const CyComb& R = x.comb[k];
  float* rb = SM ? reinterpret_cast<float*>(x.ps + R.sm_ring)
                 : R.scratch + x.row * RL2;
  const int c = threadIdx.x;
  const int wb = (int)((unsigned)x.b % (unsigned)(RL2 / CK_C)) * CK_C;
  int rd = wb + c - D;
  if (rd < 0) rd += RL2;
  const float y = __fadd_rn(v, __fmul_rn(rb[rd], decay));
  rb[wb + c] = y;
  CY_USE(y);
  CY_PHASE(CY_PH_COMB);
  return y;
}

// The constants of one cascade a thread reads in a block, in registers:
// its column's reversed Toeplitz prefix (the steps of its warp), and for
// warp 0 the W^T rows and ACt of its carry lanes; Ecb's column.
struct CyHold {
  float4 hv[32];
  float4 wv[8];
  float at[CK_NS];
  float en[CK_NS];
};

template <int N, bool SM>
__device__ __forceinline__ void cy_hold(const CyCtx& x, int k, CyHold& h) {
  const int c = threadIdx.x;
  const CyCasc& Q = x.casc[k];
  const float* kc = SM ? reinterpret_cast<const float*>(x.ps + Q.sm_consts)
                       : Q.consts;
  // steps of this warp: its last lane's column c/4 + 1 (lanes past their
  // own diagonal read zeros of the padded copies)
  const int mw = 8 * ((c >> 5) + 1);
  const int q = c & 3;
  const float4* R4 = reinterpret_cast<const float4*>(
      kc + CY_OFF_R + q * CY_RS + CK_C + q - c);
#pragma unroll
  for (int m = 0; m < 32; ++m)
    if (m < mw) h.hv[m] = R4[m];
  if (c < 32) {
    const int j = c & 7, r = c >> 3;
    const float4* W4 = reinterpret_cast<const float4*>(
        kc + CY_OFF_W + j * CY_WS + 32 * r);
#pragma unroll
    for (int t = 0; t < 8; ++t) h.wv[t] = W4[t];
#pragma unroll
    for (int k2 = 0; k2 < N; ++k2) h.at[k2] = kc[CY_OFF_A + k2 * CK_NS + j];
  }
#pragma unroll
  for (int k2 = 0; k2 < N; ++k2) h.en[k2] = kc[CY_OFF_E + k2 * CK_C + c];
}

// One cascade step of the block on this thread's sample v (see the
// header), its constants in h: after the barrier only X and the carry are
// read, the product's loads are broadcasts, eight steps in flight at once.
template <int N>
__device__ __forceinline__ float cy_cascade_held(CyCtx& x, int k, float v,
                                                 const CyHold& h) {
  const int c = threadIdx.x;
  const CyCasc& Q = x.casc[k];
  float* cb = reinterpret_cast<float*>(x.ps + Q.sm_cbuf);
  float* X = x.xs + x.xsel * CK_C;
  x.xsel ^= 1;
  const int b = x.b;
  const int mw = 8 * ((c >> 5) + 1);
  X[c] = v;
  if (b == x.K - 1) Q.xlast_out[x.row * CK_C + c] = v;
  CY_PHASE(CY_PH_CARRY);
  __syncthreads();                     // X is in; C_b is published
  CY_PHASE(CY_PH_BARRIER);
  const float* cur = cb + (b & 1) * CK_NS;          // C_b
  if (b == x.K - 1 && c < CK_NS) Q.carry_out[x.row * CK_NS + c] = cur[c];
  float cN[N];
#pragma unroll
  for (int k2 = 0; k2 < N; ++k2) cN[k2] = cur[k2];

  // y[c] = sum_{i <= c} X[i] h[c - i], four samples a step: X[4m..4m+3]
  // from a broadcast load, h[c - 4m .. c - 4m - 3] from the registers
  const float4* X4 = reinterpret_cast<const float4*>(X);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (8 * g < mw) {
      float4 xv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) xv[u] = X4[8 * g + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 hh = h.hv[8 * g + u];
        a0 = fmaf(xv[u].x, hh.x, a0);
        a1 = fmaf(xv[u].y, hh.y, a1);
        a2 = fmaf(xv[u].z, hh.z, a2);
        a3 = fmaf(xv[u].w, hh.w, a3);
      }
    }
  }
  const float prod = (a0 + a1) + (a2 + a3);
  CY_USE(prod);
  CY_PHASE(CY_PH_PRODUCT);

  // warp 0: C_{b+1} = X W + C_b ACt; lane (j, r) sums rows 32r..32r+31
  // of lane j, the four quarters meet by shuffles
  if (c < 32) {
    const int j = c & 7, r = c >> 3;
    const float4* Xr = X4 + 8 * r;
    float4 xv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) xv[t] = Xr[t];
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s0 = fmaf(xv[t].x, h.wv[t].x, s0);
      s1 = fmaf(xv[t].y, h.wv[t].y, s1);
      s0 = fmaf(xv[t].z, h.wv[t].z, s0);
      s1 = fmaf(xv[t].w, h.wv[t].w, s1);
    }
    float s = s0 + s1;
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (c < CK_NS) {
      float t = 0.0f;
#pragma unroll
      for (int k2 = 0; k2 < N; ++k2) t = fmaf(cN[k2], h.at[k2], t);
      cb[((b + 1) & 1) * CK_NS + j] = s + t;
    }
  }
  float e = 0.0f;
#pragma unroll
  for (int k2 = 0; k2 < N; ++k2) e = fmaf(cN[k2], h.en[k2], e);
  const float y = prod + e;
  CY_USE(y);
  CY_PHASE(CY_PH_CARRY);
  return y;
}

// A cascade of a program with several: its constants into registers in
// this block (before the barrier), then the step.
template <int N, bool SM>
__device__ __forceinline__ float cy_cascade(CyCtx& x, int k, float v) {
  CyHold h;
  cy_hold<N, SM>(x, k, h);
  return cy_cascade_held<N>(x, k, v, h);
}

#ifdef CY_RECORD
// The input of shaper k (program order) at this thread's sample.
__device__ __forceinline__ void cy_record(const CyCtx& x, int k, float v) {
  x.rec[(long long)k * gridDim.x * x.K * CK_C + x.off] = v;
}
#define CY_REC_PARAM , float* __restrict__ rec
#define CY_REC_ARG , rec
#else
#define CY_REC_PARAM
#define CY_REC_ARG
#endif

// The program's block code: CY_NREG (its registers, at least 1),
// CY_BLOCK_BARRIER (1 when no cascade gives each block a barrier but a
// comb needs one), CY_HOLD_N and CY_HOLD_SM (a program of one cascade:
// its carry lanes and constants' placement; its constants are held in
// registers for the whole render) and cy_block(CyCtx&,
// float (&r)[CY_NREG], const CyHold&).
#ifndef KERNEL_PROGRAM_H
#error "the cycle kernel is built once per block program: ops/cycle_kernel.py passes -DKERNEL_PROGRAM_H"
#endif
#include KERNEL_PROGRAM_H

// The working ring of comb R for this row: in shared memory or scratch.
__device__ __forceinline__ float* ring_of(const CyComb& R, char* ps,
                                          long long row) {
  return R.sm_ring >= 0 ? reinterpret_cast<float*>(ps + R.sm_ring)
                        : R.scratch + row * R.rl2;
}

__global__ void __launch_bounds__(CK_C, 2)
cycle_kernel(const char* __restrict__ prog, int prog_bytes, int T
             CY_REC_PARAM) {
  __shared__ float redm[4];
  extern __shared__ int4 dyn4[];
  char* ps = reinterpret_cast<char*>(dyn4);
  const int c = threadIdx.x;
  for (int i = c; i < prog_bytes / 16; i += CK_C)
    dyn4[i] = reinterpret_cast<const int4*>(prog)[i];
  __syncthreads();
  const CyHeader& H = *reinterpret_cast<const CyHeader*>(ps);
  const float* const* reg0 =
      reinterpret_cast<const float* const*>(ps + H.off_reg0);
  float* const* reg_out = reinterpret_cast<float* const*>(ps + H.off_reg_out);
  CyCtx x;
  x.ps = ps;
  x.ext = reinterpret_cast<const float* const*>(ps + H.off_ext);
  x.tap = reinterpret_cast<float* const*>(ps + H.off_tap);
  x.casc = reinterpret_cast<const CyCasc*>(ps + H.off_casc);
  x.comb = reinterpret_cast<const CyComb*>(ps + H.off_comb);
  x.feeds = reinterpret_cast<float*>(ps + H.sm_feeds);
  x.xs = reinterpret_cast<float*>(ps + H.sm_xs);
  x.redm = redm;
#ifdef CY_RECORD
  x.rec = rec;
#endif
  x.row = blockIdx.x;
  x.K = T / CK_C;
  x.xsel = 0;
  const int n_ext = H.n_ext, n_regs = H.n_regs;
  const long long base = x.row * (long long)T;

  float r[CY_NREG];
#pragma unroll
  for (int i = 0; i < CY_NREG; ++i)
    r[i] = i < n_regs ? reg0[i][x.row * CK_C + c] : 0.0f;
  CyHold hold;
  for (int k = 0; k < H.n_casc; ++k) {
    const CyCasc& Q = x.casc[k];
    if (Q.sm_consts >= 0) {
      float4* dst = reinterpret_cast<float4*>(ps + Q.sm_consts);
      for (int i = c; i < CY_NCONST / 4; i += CK_C)
        dst[i] = reinterpret_cast<const float4*>(Q.consts)[i];
    }
    if (c < CK_NS)
      reinterpret_cast<float*>(ps + Q.sm_cbuf)[c] = Q.s0[x.row * CK_NS + c];
  }
  // each working ring holds the history: time t in [-rl, 0) at t + rl2
  for (int k = 0; k < H.n_comb; ++k) {
    const CyComb& R = x.comb[k];
    float* rb = ring_of(R, ps, x.row);
    const float* raw = R.raw + x.row * R.rl;
    for (int t = c - R.rl; t < 0; t += CK_C) rb[t + R.rl2] = raw[t + R.rl];
  }
  for (int j = 0; j < CY_FB - 1; ++j) stage_feeds(x, n_ext, base, j);
  __syncthreads();
#ifdef CY_HOLD_N
  cy_hold<CY_HOLD_N, CY_HOLD_SM>(x, 0, hold);
#endif
#ifdef CY_PHASES
  if (CY_SLOT_ >= 0) {
    for (int i = 0; i < CY_NPH; ++i) cy_acc[CY_SLOT_][i] = 0;
    cy_last[CY_SLOT_] = clock64();
  }
#endif

  for (int b = 0; b < x.K; ++b) {
    CY_PHASE(CY_PH_BLOCK);
    stage_feeds(x, n_ext, base, b + CY_FB - 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(CY_FB - 1) : "memory");
    CY_PHASE(CY_PH_FEED);
    if (CY_BLOCK_BARRIER) {          // rings: the last block's writes in
      __syncthreads();
      CY_PHASE(CY_PH_BARRIER);
    }
    x.b = b;
    x.fs = (b & (CY_FB - 1)) * CK_C;
    x.off = base + (long long)b * CK_C + c;
    cy_block(x, r, hold);
  }
#pragma unroll
  for (int i = 0; i < CY_NREG; ++i)
    if (i < n_regs) reg_out[i][x.row * CK_C + c] = r[i];
  __syncthreads();                     // every ring slot is written
  // the raw ring: time t in [T - rl, T) at t mod rl
  for (int k = 0; k < H.n_comb; ++k) {
    const CyComb& R = x.comb[k];
    const float* rb = ring_of(R, ps, x.row);
    float* raw = R.raw + x.row * R.rl;
    for (int t = T - R.rl + c; t < T; t += CK_C)
      raw[t < 0 ? t + R.rl : t % R.rl] = rb[t < 0 ? t + R.rl2 : t % R.rl2];
  }
#ifdef CY_PHASES
  if (CY_SLOT_ >= 0 && blockIdx.x < CY_PH_CTAS)
    for (int i = 0; i < CY_NPH; ++i)
      cy_phases[blockIdx.x][CY_SLOT_][i] = cy_acc[CY_SLOT_][i];
#endif
}

// Record sizes for the wrapper's layout check: header, cascade and comb
// records, one byte each.
extern "C" int cycle_kernel_abi(void) {
  return (int)sizeof(CyHeader) | (int)sizeof(CyCasc) << 8
      | (int)sizeof(CyComb) << 16;
}

// The layout constants the wrapper packs by: (0) floats of a cascade's
// constants, (1) feed blocks in flight, (2, 3) the two row strides.
extern "C" int cycle_kernel_shape(int what) {
  switch (what) {
    case 0: return CY_NCONST;
    case 1: return CY_FB;
    case 2: return CY_RS;
    case 3: return CY_WS;
  }
  return -1;
}

#ifdef CY_PHASES
// The phase counters of the first n CTAs of the last launch into
// host[n][2][CY_NPH].
extern "C" int cycle_kernel_phases(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(
      host, cy_phases,
      sizeof(unsigned long long) * 2 * CY_NPH
          * (n < CY_PH_CTAS ? n : CY_PH_CTAS));
}
#endif

// Launch B CTAs on `stream` (the caller's current PyTorch stream) over the
// packed tables `prog` of prog_bytes (a multiple of 16) in device memory,
// with `smem` bytes of dynamic shared memory (the header's smem_bytes, from
// the wrapper's smem_plan); returns the cudaGetLastError() code of the
// launch, 0 on success, or cudaErrorInvalidValue when that exceeds the
// card's shared memory per block.
static int launch(const void* prog, int prog_bytes, int smem, int B, int T,
                  int device, void* stream CY_REC_PARAM) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (prog_bytes % 16 || smem < prog_bytes) return (int)cudaErrorInvalidValue;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, cycle_kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem + (int)fa.sharedSizeBytes > optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(cycle_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cycle_kernel<<<B, CK_C, smem, (cudaStream_t)stream>>>(
      (const char*)prog, prog_bytes, T CY_REC_ARG);
  return (int)cudaGetLastError();
}

#ifdef CY_RECORD
// The record build's launch: `rec` [n_ew, B, T] receives the shapers'
// inputs.
extern "C" int cycle_kernel_record_launch(const void* prog, int prog_bytes,
                                          int smem, int B, int T, float* rec,
                                          int device, void* stream) {
  return launch(prog, prog_bytes, smem, B, T, device, stream, rec);
}
#else
extern "C" int cycle_kernel_launch(const void* prog, int prog_bytes,
                                   int smem, int B, int T, int device,
                                   void* stream) {
  return launch(prog, prog_bytes, smem, B, T, device, stream);
}
#endif
