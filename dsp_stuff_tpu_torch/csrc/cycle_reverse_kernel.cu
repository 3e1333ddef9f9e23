// cycle_reverse_kernel.cu -- the vjp of a feedback SCC's block program.
//
// Replaces, in the PyTorch port, the reverse scan that XLA compiles for
// dsp_stuff_tpu/ops/cycle_segment.py:_cycle_vjp (:270-288, the vjp of its
// lax.scan interpret).  Its plain PyTorch version is
// dsp_stuff_tpu_torch/ops/cycle_segment.py:interpret_adjoint; the wrapper
// that generates the program's adjoint block code, packs the tables,
// builds, binds and launches it is ops/cycle_reverse_kernel.py.
//
// What bounds it.  As the forward (cycle_kernel.cu): the feedback.  The
// adjoint of block b needs the register, carry and comb adjoints of
// block b + 1, so each row walks its K = T/128 blocks from the last to the
// first, and a block's time is its critical path; the signal I/O (the
// taps' cotangents and the shapers' recorded inputs in, the feeds'
// gradients out) is small next to that walk.
//
// Design.  The forward's, run backwards.  One CTA of 128 threads per
// stream row; thread c owns sample column c of every block.  The wrapper
// writes the program's block adjoint as straight-line code (cy_block_
// adjoint in the generated header KERNEL_PROGRAM_H): the program's
// instructions in reverse order, one statement each, every constant a
// literal.  The adjoint of the flow f is a register of the thread; the
// SCC's register adjoints g[] are the thread's registers too and carry
// from block to block (the final registers' cotangents seed them, and
// after block 0 they are the initial registers' gradients), so a join
// that read a register before its setreg (the previous block's value)
// and one that read it after both come out of the same rules:
//   setreg r: f += g[r], g[r] = 0;   a join's term reg r: g[r] += s;
//   a join's term ext e: e[e] += s (written once a block);
//   join / lin2: f = 0 after distributing it;  scale: f *= s;
//   tap t: f += its cotangent;  ew: f through the shaper's derivative at
//   its recorded input.
// Shared memory, at offsets the wrapper computes (the forward's
// smem_plan):
// * the streams it reads, the taps' cotangents then the shapers' inputs,
//   staged CR_FB blocks ahead of the walk with cp.async, each thread its
//   own column (a missing cotangent is a zero-filled copy);
// * per cascade its constants, the forward's packed layout
//   (cycle_kernel.py:cycle_casc_consts) read transposed, and a
//   double-buffered carry adjoint.  The adjoint of y = X Ltg + c Ecb,
//   c' = X W + c ACt is gX = gy Ltg^T + gc' W^T, gc = gy Ecb^T + gc' ACt^T:
//   gy goes through a double-buffered row (one barrier a cascade).  The
//   anti-causal product gX[c] = sum_{i >= c} gy[i] h[i - c] is cut so
//   that no column's sum is a long chain and a gy load feeds sixteen
//   products: thread c = 4q + e sums, for all four columns 4q + d of its
//   quad, a quarter of its warp's steps, m = 8w + e + 4s (s < 8 - 2w:
//   the steps 8w..31 that warp w's columns 32w..32w+31 need, the same
//   count for every lane; a column past m reads zeros), gy[4m..4m+3] from
//   one 16-byte load (four addresses a warp, on distinct banks) against
//   h[4(m - q) + f - d], two aligned float4s of the first reversed copy
//   read backwards (zeros below h[0]); the quad's four partial sums of
//   each column then meet in lane d by three shuffles.  For a program of
//   one cascade those h values, W^T's column, and warp 3's Ecb row and
//   ACt row stay in registers for the whole walk (CR_HOLD_N), else they
//   are loaded before each barrier, in a called function
//   (cr_cascade_call).  Warp 3, whose steps are the fewest, also sums the
//   carry adjoint of the block before (lane j, quarter r of the columns)
//   into the other buffer;
// * per comb a ring of the future adjoints vbar over NR + 1 blocks:
//   vbar[n] = f[n] + d vbar[n + D] (+ the final history's cotangent in
//   the last D samples), as the forward's ring of outputs; with the spare
//   block no slot is read and written in the same block.  After the walk
//   d vbar[0..D) (and past T, the cotangent) is the history's gradient.
// What does not fit stays in device memory (a ring in a scratch ring).
// The cascade infos' cotangents touch only the last block: the wrapper
// pulls them back (cascade_tail_states) and passes seeds on that block's
// cascade input and carry.  A block needs a barrier between the
// ring writes of the block after it and its own reads: a cascade's, else
// one at the block's start (CY_BLOCK_BARRIER).
//
// Arithmetic is plain FP32 (-fmad=false; products with explicit fmaf),
// interpret_adjoint's operations in its order, the cascade's and the
// Fuzz shaper's sums in another.

#include <stdint.h>

// Phase probes, built only by tools/measure_torch_cycle.py --phases
// (-DCR_PHASES): threads 0 and 127 of each CTA (warp 0, the most steps of
// the cascade's anti-causal product, and warp 3, the fewest and the carry
// adjoint) each add the cycles since their last probe to the phase's
// counter; CR_USE(v) makes the probe wait for v (a load's latency lands in
// the phase that loaded it).  A helper's entry probe gives the block
// code's own statements since the last probe (setregs, joins, lin2,
// scales, taps) to CR_PH_JOIN.  The counters go to cr_phases at the exit.
#define CR_PH_STAGE 0       // the read streams: issuing the copies, waiting
#define CR_PH_JOIN 1        // setreg, join, lin2, scale, tap
#define CR_PH_PRODUCT 2     // the product gy Ltg^T (warp 3: and gy Ecb^T)
#define CR_PH_CARRY 3       // gy's row in; gc' W^T, warp 3's gc' ACt^T
#define CR_PH_COMB 4
#define CR_PH_EW 5          // shapers' derivatives
#define CR_PH_FEEDS 6       // the feed gradients out
#define CR_PH_BARRIER 7     // waiting at __syncthreads
#define CR_PH_BLOCK 8       // the block loop's own work
#define CR_NPH 9
#ifdef CR_PHASES
#define CR_PH_CTAS 4096
__device__ unsigned long long cr_phases[CR_PH_CTAS][2][CR_NPH];
__shared__ unsigned long long cr_acc[2][CR_NPH];
__shared__ long long cr_last[2];
__shared__ int cr_sink;
#define CR_SLOT_ (threadIdx.x == 0 ? 0 : (threadIdx.x == blockDim.x - 1 ? 1 : -1))
#define CR_PHASE(i)                                      \
  do {                                                   \
    const int s_ = CR_SLOT_;                             \
    if (s_ >= 0) {                                       \
      const long long now_ = clock64();                  \
      cr_acc[s_][i] += now_ - cr_last[s_];               \
      cr_last[s_] = now_;                                \
    }                                                    \
  } while (0)
#define CR_USE(v) do { if ((v) == 3.0e-39f) cr_sink = 1; } while (0)
#else
#define CR_PHASE(i) do {} while (0)
#define CR_USE(v) do {} while (0)
#endif
// the block code's statements before a helper: their time is the joins'
#define CR_ENTER(v) do { CR_USE(v); CR_PHASE(CR_PH_JOIN); } while (0)

#include "stages.cuh"

#define CR_FB 8                 // blocks staged ahead (a power of two)
// The forward's constants layout (cycle_kernel.cu; the wrapper checks it
// through cycle_reverse_shape)
#define CY_RS 168
#define CY_WS 132
#define CY_OFF_R 0
#define CY_OFF_W (4 * CY_RS)
#define CY_OFF_E (CY_OFF_W + CK_NS * CY_WS)
#define CY_OFF_A (CY_OFF_E + CK_NS * CK_C)
#define CY_NCONST (CY_OFF_A + CK_NS * CK_NS)

// The packed tables, mirrored by ops/cycle_reverse_kernel.py (HEADER,
// CASC, COMB); cycle_reverse_abi() lets the wrapper check the sizes.
typedef struct {
  long long off_gext, off_src, off_greg_in, off_greg_out;  // bytes from
  long long off_casc, off_comb;                           // the base
  int n_regs, n_casc, n_comb, n_ext;
  int n_src, smem_bytes, prog_bytes, sm_src;   // sm_*: byte offsets in
  int sm_gy, pad0, pad1, pad2;                 // shared memory
} CrHeader;

typedef struct {
  const float* consts;  // [CY_NCONST] in device memory
  const float* seed_x;  // [B, 128] the last block's input seed, or null
  const float* seed_c;  // [B, 8] the seed of the carry entering it, or null
  float* g_s0;          // [B, 8] the gradient of the carry entering block 0
  int sm_consts;        // byte offset of the constants in shared memory,
                        // or -1: read from device memory
  int sm_cbuf;          // byte offset of the carry adjoints [2][8]
  int n, pad_;
} CrCasc;

typedef struct {
  const float* ct_hist;  // [B, D] the final history's cotangent, or null
  float* g_hist;         // [B, D] the initial history's gradient
  float* scratch;        // [B, rl2] the ring when not in shared memory
  int sm_ring;           // byte offset of the ring [rl2], or -1
  int d, rl2;            // the delay; (NR + 1) * 128
  float decay;
} CrComb;

// The program's sizes first (its generated header without the block
// code, KERNEL_PROGRAM_H: CY_NEXT, CY_NSRC, CY_NCOMB ...), so that the
// context holds the row's pointers of its tables, read once.
#ifndef KERNEL_PROGRAM_H
#error "the reverse cycle kernel is built once per block program: ops/cycle_reverse_kernel.py passes -DKERNEL_PROGRAM_H"
#endif
#define CR_SIZES_ONLY
#include KERNEL_PROGRAM_H
#undef CR_SIZES_ONLY
#define CR_NRING (CY_NCOMB > 0 ? CY_NCOMB : 1)
// The launch bound's CTAs an SM, CR_CTAS, comes with the sizes: as many
// as an SM's shared memory holds at this program's plan, at most 4 (128
// registers a thread, one wave at 512 rows on 132 SMs).

struct CrCtx {
  char* ps;                     // the dynamic shared memory
  const CrCasc* casc;
  float* staged;                // [n_src][CR_FB][128]
  float* gys;                   // [2][128]
  float* red;                   // [4] block reductions
  float* ge[CY_NEXT];           // each feed's gradient at this thread's
                                // column of the row, or null: not wanted
  int ro[CR_NRING];             // each comb's ring: its byte offset in
  float* rs[CR_NRING];          // shared memory, or the row's scratch ring
  const float* cth[CR_NRING];   // the row's final history cotangent, or null
  long long row;
  int K, T, b, fs, xsel;        // blocks, samples; this block; its staged
};                              // slot; gy row

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

// This thread's column of every read stream's block `blk` into its slot
// (zeros before the render or for a missing stream), as one group: sp[i]
// is stream i's pointer at this thread's column of the row, or null; zsrc
// is a valid device address for the zero-filled copies.
template <int NSRC>
__device__ __forceinline__ void stage_src(const CrCtx& x,
                                          const float* const* sp,
                                          const float* zsrc, int blk) {
  const int c = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NSRC; ++i) {
    float* dst = x.staged + (i * CR_FB + (blk & (CR_FB - 1))) * CK_C + c;
    const bool ok = blk >= 0 && sp[i] != nullptr;
    cp_async4(dst, ok ? sp[i] + (long long)blk * CK_C : zsrc, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// NaN-propagating max and the sum over the CTA's 128 values
__device__ float cr_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = maxn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return maxn(maxn(red[0], red[1]), maxn(red[2], red[3]));
}

__device__ float cr_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// ---- the shapers' derivatives (interpret_adjoint's ew_adjoint) ----------
// ew_grad and fuzz_grad are in stages.cuh, shared with the reverse chain
// kernel; Fuzz's block reductions here are the CTA's.

struct CrMax {
  float* red;
  __device__ float operator()(float v) const { return cr_max(v, red); }
};

struct CrSum {
  float* red;
  __device__ float operator()(float v) const { return cr_sum(v, red); }
};

// The vjp of Fuzz at this thread's input v of the block, cotangent g.
// Every thread of the CTA calls it together.
__device__ float cr_fuzz_grad(const CrCtx& x, float level, float g,
                             float v) {
  float gv[1] = {g};
  const float vv[1] = {v};
  fuzz_grad<1>(level, gv, vv, CrMax{x.red}, CrSum{x.red});
  return gv[0];
}

// ---- the helpers the generated block code calls ---------------------------

// This thread's sample of read stream i (tap cotangent t at i = t, the
// k-th shaper's input at n_taps + k) in the current block.
__device__ __forceinline__ float cr_in(const CrCtx& x, int i) {
  return x.staged[i * (CR_FB * CK_C) + x.fs + threadIdx.x];
}

// The block's feed gradients e[] into their outputs.
template <int NE>
__device__ __forceinline__ void cr_feeds(const CrCtx& x, const float (&e)[NE]) {
  CR_ENTER(e[0]);
#pragma unroll
  for (int j = 0; j < NE; ++j)
    if (x.ge[j] != nullptr) x.ge[j][(long long)x.b * CK_C] = e[j];
  CR_PHASE(CR_PH_FEEDS);
}

// A shaper's adjoint with literal op and params at its recorded input v.
template <int OP>
__device__ __forceinline__ float cr_ew(const CrCtx& x, float g, float v,
                                       float p0, float p1, float p2,
                                       float p3) {
  CR_ENTER(g);
  float r;
  if (OP == EW_FUZZ) {
    r = cr_fuzz_grad(x, p0, g, v);
  } else {
    const float p[4] = {p0, p1, p2, p3};
    r = ew_grad(OP, p, g, v);
  }
  CR_USE(r);
  CR_PHASE(CR_PH_EW);
  return r;
}

// The adjoint of comb k (y = x + decay * y[t - D]) at this thread's
// sample: vbar = g (+ the final history's cotangent) + decay * vbar[t + D]
// over the ring of future adjoints (SM: in shared memory, else scratch).
template <int D, bool SM>
__device__ __forceinline__ float cr_comb(const CrCtx& x, int k, float g,
                                         float decay) {
  CR_ENTER(g);
  constexpr int RL2 = ((D + CK_C - 1) / CK_C + 1) * CK_C;
  float* rb = SM ? reinterpret_cast<float*>(x.ps + x.ro[k]) : x.rs[k];
  const int c = threadIdx.x;
  const int wb = (int)((unsigned)x.b % (unsigned)(RL2 / CK_C)) * CK_C;
  int rd = wb + c + D;
  if (rd >= RL2) rd -= RL2;
  const int n = x.b * CK_C + c;
  float v = g;
  if (n >= x.T - D && x.cth[k] != nullptr)
    v = __fadd_rn(v, x.cth[k][n - (x.T - D)]);
  v = __fadd_rn(v, __fmul_rn(rb[rd], decay));
  rb[wb + c] = v;
  CR_USE(v);
  CR_PHASE(CR_PH_COMB);
  return v;
}

// The constants of one cascade a thread reads in a block, in registers:
// per step s of its quarter of the product, h[k0 - 3 .. k0 + 4] (k0 =
// 4(m - q)) in hv[2s], hv[2s + 1]; W^T's column; warp 3 (two steps) also
// Ecb's row j, quarter r, in hv[4 .. 11] and ACt's row j; the carry
// adjoints' buffers.
struct CrHold {
  float4 hv[16];
  float wt[CK_NS];
  float at[CK_NS];
  float* cb;
};

template <int N, bool SM>
__device__ __forceinline__ void cr_hold(const CrCtx& x, int k, CrHold& h) {
  const int c = threadIdx.x, w = c >> 5, e = c & 3, qw = (c >> 2) & 7;
  const CrCasc& Q = x.casc[k];
  const float* kc = SM ? reinterpret_cast<const float*>(x.ps + Q.sm_consts)
                       : Q.consts;
  h.cb = reinterpret_cast<float*>(x.ps + Q.sm_cbuf);
  // R[0][j] = h[128 - j] (zeros outside h): h[k0 - 3 .. k0 + 4] are the
  // float4s at j = 128 - k0 and 124 - k0, read backwards; j stays in
  // 0 .. 159 for k0 = 4(e + 4s - qw) in -28 .. 124
  const float4* R4 = reinterpret_cast<const float4*>(kc + CY_OFF_R);
  const int ns = 8 - 2 * w;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (s < ns) {
      const int k0 = 4 * (e + 4 * s - qw);
      const float4 lo = R4[(128 - k0) >> 2], hi = R4[(124 - k0) >> 2];
      h.hv[2 * s] = make_float4(lo.w, lo.z, lo.y, lo.x);
      h.hv[2 * s + 1] = make_float4(hi.w, hi.z, hi.y, hi.x);
    }
#pragma unroll
  for (int k2 = 0; k2 < N; ++k2) h.wt[k2] = kc[CY_OFF_W + k2 * CY_WS + c];
  if (w == 3) {
    const int lane = c & 31, j = lane & 7, r = lane >> 3;
    const float4* E4 = reinterpret_cast<const float4*>(
        kc + CY_OFF_E + j * CK_C + 32 * r);
#pragma unroll
    for (int t = 0; t < 8; ++t) h.hv[4 + t] = E4[t];
#pragma unroll
    for (int k2 = 0; k2 < N; ++k2) h.at[k2] = kc[CY_OFF_A + j * CK_NS + k2];
  }
}

// The quad walk's partial sums of this lane: the quad's four columns 4q +
// d over the lane's NSTEP steps m = 8w + e + 4s, gy[4m + f] (G4 = gy's
// float4s from 8w + e) against h[4(m - q) + f - d], f even and odd in two
// sums a column.
template <int NSTEP>
__device__ __forceinline__ void cr_partials(const float4* G4,
                                            const CrHold& h, float (&p)[4]) {
  float4 gv[NSTEP];
#pragma unroll
  for (int s = 0; s < NSTEP; ++s) gv[s] = G4[4 * s];
  float pe[4] = {0.0f, 0.0f, 0.0f, 0.0f}, po[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < NSTEP; ++s) {
    const float4 lo = h.hv[2 * s], hi = h.hv[2 * s + 1];
    const float hh[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      pe[d] = fmaf(gv[s].x, hh[3 - d], pe[d]);
      po[d] = fmaf(gv[s].y, hh[4 - d], po[d]);
      pe[d] = fmaf(gv[s].z, hh[5 - d], pe[d]);
      po[d] = fmaf(gv[s].w, hh[6 - d], po[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) p[d] = pe[d] + po[d];
}

// Lane e's column of its quad: it keeps columns e & 1 and (e & 1) + 2,
// adding its neighbour's partials across lane bit 0, then column e,
// adding its neighbour's across bit 1.
__device__ __forceinline__ float cr_quad_sum(const float (&p)[4], int e) {
  const bool odd = e & 1, up = e & 2;
  const float u0 = (odd ? p[1] : p[0])
      + __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[1], 1);
  const float u1 = (odd ? p[3] : p[2])
      + __shfl_xor_sync(0xffffffffu, odd ? p[2] : p[3], 1);
  return (up ? u1 : u0) + __shfl_xor_sync(0xffffffffu, up ? u0 : u1, 2);
}

template <int NSTEP>
__device__ __forceinline__ float cr_product(const float4* G4,
                                           const CrHold& h, int e) {
  float p[4];
  cr_partials<NSTEP>(G4, h, p);
  return cr_quad_sum(p, e);
}

// Warp 3's lane (j, r): gy's quarter r against Ecb's row j (in hv[4..11])
// in two sums, then the four quarters' sums across lane bits 3 and 4.
__device__ __forceinline__ float cr_carry_sum(const float* GY,
                                             const CrHold& h) {
  const float4* Y4 = reinterpret_cast<const float4*>(GY)
      + 8 * ((threadIdx.x & 31) >> 3);
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float4 ev = h.hv[4 + t], yv = Y4[t];
    s0 = fmaf(yv.x, ev.x, s0);
    s1 = fmaf(yv.y, ev.y, s1);
    s0 = fmaf(yv.z, ev.z, s0);
    s1 = fmaf(yv.w, ev.w, s1);
  }
  float s = s0 + s1;
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  return s + __shfl_xor_sync(0xffffffffu, s, 16);
}

// The adjoint of cascade k's block step at this thread's sample g (see
// the header), its constants in h: returns gX; warp 3 writes the carry
// adjoint entering the block (and at block 0 the state's gradient).
template <int N>
__device__ __forceinline__ float cr_cascade_held(CrCtx& x, int k, float g,
                                                 const CrHold& h) {
  CR_ENTER(g);
  const int c = threadIdx.x, w = c >> 5, e = c & 3;
  float* GY = x.gys + x.xsel * CK_C;
  x.xsel ^= 1;
  const int b = x.b;
  GY[c] = g;
  CR_PHASE(CR_PH_CARRY);
  __syncthreads();                     // gy is in; gc' is published
  CR_PHASE(CR_PH_BARRIER);
  const float* gn = h.cb + ((b + 1) & 1) * CK_NS;   // leaving the block
  float gnv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) gnv[j] = gn[j];

  // the quad's four columns 4q + d over this lane's steps, a count fixed
  // for each warp
  const float4* G4 = reinterpret_cast<const float4*>(GY) + 8 * w + e;
  float prod, cs = 0.0f;
  switch (w) {
    case 0: prod = cr_product<8>(G4, h, e); break;
    case 1: prod = cr_product<6>(G4, h, e); break;
    case 2: prod = cr_product<4>(G4, h, e); break;
    default: {        // warp 3: its two steps beside the carry's sums
      float p[4];
      cr_partials<2>(G4, h, p);
      cs = cr_carry_sum(GY, h);
      prod = cr_quad_sum(p, e);
      break;
    }
  }
  CR_USE(prod);
  CR_PHASE(CR_PH_PRODUCT);
  float wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) wsum = fmaf(gnv[j], h.wt[j], wsum);
  float gx = prod + wsum;
  const CrCasc& Q = x.casc[k];
  if (b == x.K - 1 && Q.seed_x != nullptr)     // the walk's first block
    gx = gx + Q.seed_x[x.row * CK_C + c];

  // warp 3: gc = gy Ecb^T + gc' ACt^T, lane j < 8
  if (w == 3 && (c & 31) < CK_NS) {
    const int j = c & 7;
    float t = 0.0f;
#pragma unroll
    for (int k2 = 0; k2 < N; ++k2) t = fmaf(gnv[k2], h.at[k2], t);
    float gc = cs + t;
    if (b == x.K - 1 && Q.seed_c != nullptr)
      gc = gc + Q.seed_c[x.row * CK_NS + j];
    h.cb[(b & 1) * CK_NS + j] = gc;
    if (b == 0) Q.g_s0[x.row * CK_NS + j] = gc;
  }
  CR_USE(gx);
  CR_PHASE(CR_PH_CARRY);
  return gx;
}

// A cascade of a program with several: its constants into registers in
// this block (before the barrier), then the step, in a function called
// from each cascade's statement: one copy of its code for each (N, SM),
// its registers its own, where the block code inlined every cascade's
// and spilled.
template <int N, bool SM>
__device__ __noinline__ float cr_cascade_call(const CrCasc* casc, char* ps,
                                              float* gys, int xsel, int b,
                                              int K, long long row, int k,
                                              float g) {
  CrCtx y;
  y.ps = ps;
  y.casc = casc;
  y.gys = gys;
  y.xsel = xsel;
  y.b = b;
  y.K = K;
  y.row = row;
  CrHold h;
  cr_hold<N, SM>(y, k, h);
  return cr_cascade_held<N>(y, k, g, h);
}

template <int N, bool SM>
__device__ __forceinline__ float cr_cascade(CrCtx& x, int k, float g) {
  const float r = cr_cascade_call<N, SM>(x.casc, x.ps, x.gys, x.xsel, x.b,
                                         x.K, x.row, k, g);
  x.xsel ^= 1;
  return r;
}

// The program's block adjoint: CY_NREG (its registers, at least 1),
// CY_NEXT (its feeds, at least 1), CY_NSRC (the streams it reads: the
// taps' cotangents and the shapers' inputs), CY_NCOMB, CY_BLOCK_BARRIER,
// CR_CTAS, CR_HOLD_N and CR_HOLD_SM (a program of one cascade: its carry
// lanes and constants' placement; its constants are held in registers for
// the whole walk) and cy_block_adjoint(CrCtx&, float (&g)[CY_NREG],
// const CrHold&).
#include KERNEL_PROGRAM_H

__device__ __forceinline__ float* ring_of(const CrComb& R, char* ps,
                                          long long row) {
  return R.sm_ring >= 0 ? reinterpret_cast<float*>(ps + R.sm_ring)
                        : R.scratch + row * R.rl2;
}

__global__ void __launch_bounds__(CK_C, CR_CTAS)
cycle_reverse_kernel(const char* __restrict__ prog, int prog_bytes, int T) {
  __shared__ float red[4];
  extern __shared__ int4 dyn4[];
  char* ps = reinterpret_cast<char*>(dyn4);
  const int c = threadIdx.x;
  for (int i = c; i < prog_bytes / 16; i += CK_C)
    dyn4[i] = reinterpret_cast<const int4*>(prog)[i];
  __syncthreads();
  const CrHeader& H = *reinterpret_cast<const CrHeader*>(ps);
  const float* const* greg_in =
      reinterpret_cast<const float* const*>(ps + H.off_greg_in);
  float* const* greg_out = reinterpret_cast<float* const*>(ps + H.off_greg_out);
  const float* zsrc = reinterpret_cast<const float*>(prog);
  const CrComb* comb = reinterpret_cast<const CrComb*>(ps + H.off_comb);
  CrCtx x;
  x.ps = ps;
  x.casc = reinterpret_cast<const CrCasc*>(ps + H.off_casc);
  x.staged = reinterpret_cast<float*>(ps + H.sm_src);
  x.gys = reinterpret_cast<float*>(ps + H.sm_gy);
  x.red = red;
  x.row = blockIdx.x;
  x.T = T;
  x.K = T / CK_C;
  x.xsel = 0;
  const int n_regs = H.n_regs;
  const long long base = x.row * (long long)T;
#pragma unroll
  for (int j = 0; j < CY_NEXT; ++j) {
    float* p = j < H.n_ext
        ? reinterpret_cast<float* const*>(ps + H.off_gext)[j] : nullptr;
    x.ge[j] = p != nullptr ? p + base + c : nullptr;
  }
#pragma unroll
  for (int k = 0; k < CY_NCOMB; ++k) {
    const CrComb& R = comb[k];
    x.ro[k] = R.sm_ring;
    x.rs[k] = R.scratch != nullptr ? R.scratch + x.row * R.rl2 : nullptr;
    x.cth[k] = R.ct_hist != nullptr ? R.ct_hist + x.row * R.d : nullptr;
  }
  // the read streams at this thread's column of the row (CY_NSRC of them)
  const float* sp[CY_NSRC > 0 ? CY_NSRC : 1] = {};
#pragma unroll
  for (int i = 0; i < CY_NSRC; ++i) {
    const float* p = reinterpret_cast<const float* const*>(ps + H.off_src)[i];
    sp[i] = p != nullptr ? p + base + c : nullptr;
  }

  float g[CY_NREG];
#pragma unroll
  for (int i = 0; i < CY_NREG; ++i)
    g[i] = (i < n_regs && greg_in[i] != nullptr)
               ? greg_in[i][x.row * CK_C + c] : 0.0f;
  for (int k = 0; k < H.n_casc; ++k) {
    const CrCasc& Q = x.casc[k];
    if (Q.sm_consts >= 0) {
      float4* dst = reinterpret_cast<float4*>(ps + Q.sm_consts);
      for (int i = c; i < CY_NCONST / 4; i += CK_C)
        dst[i] = reinterpret_cast<const float4*>(Q.consts)[i];
    }
    if (c < 2 * CK_NS) reinterpret_cast<float*>(ps + Q.sm_cbuf)[c] = 0.0f;
  }
  for (int k = 0; k < H.n_comb; ++k) {      // no adjoint past the render
    const CrComb& R = comb[k];
    float* rb = ring_of(R, ps, x.row);
    for (int i = c; i < R.rl2; i += CK_C) rb[i] = 0.0f;
  }
  for (int j = 0; j < CR_FB - 1; ++j)
    stage_src<CY_NSRC>(x, sp, zsrc, x.K - 1 - j);
  __syncthreads();
  CrHold hold;
#ifdef CR_HOLD_N
  cr_hold<CR_HOLD_N, CR_HOLD_SM>(x, 0, hold);
#endif
#ifdef CR_PHASES
  if (CR_SLOT_ >= 0) {
    for (int i = 0; i < CR_NPH; ++i) cr_acc[CR_SLOT_][i] = 0;
    cr_last[CR_SLOT_] = clock64();
  }
#endif

  for (int b = x.K - 1; b >= 0; --b) {
    CR_PHASE(CR_PH_BLOCK);
    stage_src<CY_NSRC>(x, sp, zsrc, b - (CR_FB - 1));
    asm volatile("cp.async.wait_group %0;\n" :: "n"(CR_FB - 1) : "memory");
    CR_PHASE(CR_PH_STAGE);
    if (CY_BLOCK_BARRIER) {          // rings: the later block's writes in
      __syncthreads();
      CR_PHASE(CR_PH_BARRIER);
    }
    x.b = b;
    x.fs = (b & (CR_FB - 1)) * CK_C;
    cy_block_adjoint(x, g, hold);
  }
#pragma unroll
  for (int i = 0; i < CY_NREG; ++i)
    if (i < n_regs) greg_out[i][x.row * CK_C + c] = g[i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                     // every ring slot is written
  // the initial history's gradient: d vbar[j] for j < T, the final
  // history's cotangent past T (a history longer than the render)
  for (int k = 0; k < H.n_comb; ++k) {
    const CrComb& R = comb[k];
    const float* rb = ring_of(R, ps, x.row);
    for (int j = c; j < R.d; j += CK_C) {
      float v = j < T ? __fmul_rn(rb[j % R.rl2], R.decay) : 0.0f;
      if (R.ct_hist != nullptr && j >= T)
        v = __fadd_rn(v, R.ct_hist[x.row * R.d + (j - T)]);
      R.g_hist[x.row * R.d + j] = v;
    }
  }
#ifdef CR_PHASES
  if (CR_SLOT_ >= 0 && blockIdx.x < CR_PH_CTAS)
    for (int i = 0; i < CR_NPH; ++i)
      cr_phases[blockIdx.x][CR_SLOT_][i] = cr_acc[CR_SLOT_][i];
#endif
}

// Record sizes for the wrapper's layout check: header, cascade and comb
// records, one byte each.
extern "C" int cycle_reverse_abi(void) {
  return (int)sizeof(CrHeader) | (int)sizeof(CrCasc) << 8
      | (int)sizeof(CrComb) << 16;
}

// The layout constants the wrapper packs by: (0) floats of a cascade's
// constants, (1) blocks staged ahead, (2, 3) the constants' row strides.
extern "C" int cycle_reverse_shape(int what) {
  switch (what) {
    case 0: return CY_NCONST;
    case 1: return CR_FB;
    case 2: return CY_RS;
    case 3: return CY_WS;
  }
  return -1;
}

#ifdef CR_PHASES
// The phase counters of the first n CTAs of the last launch into
// host[n][2][CR_NPH].
extern "C" int cycle_reverse_phases(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(
      host, cr_phases,
      sizeof(unsigned long long) * 2 * CR_NPH
          * (n < CR_PH_CTAS ? n : CR_PH_CTAS));
}
#endif

// Launch B CTAs on `stream` over the packed tables `prog` of prog_bytes (a
// multiple of 16) in device memory with `smem` bytes of dynamic shared
// memory; returns the cudaGetLastError() code of the launch, 0 on
// success, or cudaErrorInvalidValue when that exceeds the card's shared
// memory per block.
extern "C" int cycle_reverse_launch(const void* prog, int prog_bytes,
                                    int smem, int B, int T, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (prog_bytes % 16 || smem < prog_bytes) return (int)cudaErrorInvalidValue;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, cycle_reverse_kernel);
  if (e != cudaSuccess) return (int)e;
  if (smem + (int)fa.sharedSizeBytes > optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(cycle_reverse_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cycle_reverse_kernel<<<B, CK_C, smem, (cudaStream_t)stream>>>(
      (const char*)prog, prog_bytes, T);
  return (int)cudaGetLastError();
}
