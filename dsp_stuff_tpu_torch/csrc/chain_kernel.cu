// chain_kernel.cu -- a whole chain segment in one pass over the signal.
//
// Replaces dsp_stuff_tpu/ops/pallas_chain.py:chain_kernel_call (the Pallas
// megakernel of the JAX package) in the PyTorch port.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/chain_segment.py:segment_fallback;
// the wrapper that packs the stage program, builds, binds and launches
// it is dsp_stuff_tpu_torch/ops/chain_kernel.py.
//
// What bounds it.  The signal moves once in and once out (2 x 0.98 GB at
// 512 rows x 10 s, 0.59 ms of HBM time on an H100).  Each cascade is a
// triangular Toeplitz product of every 128-sample block (about 34 GFLOP a
// cascade at that size), done as three TF32 products on the tensor cores:
// about 0.2 ms a cascade at the card's TF32 rate, so the bytes set the
// bound.  An earlier design ran one CTA per row through its blocks one at
// a time, with the product on the CUDA cores behind three barriers per
// block: bound by that per-block latency.  This one is bound by each
// tile's walk through its stages (tools/measure_torch_chain.py --phases
// counts the cycles of each phase): the tensor-core products and the
// shapers' arithmetic, then the comb, the carry scan (one thread) and the
// barriers between stages.
//
// The record build (-DCK_RECORD) also writes each ew stage's input to a
// record [B, T] (its pointer in the program), the residuals of the
// reverse chain kernel (chain_reverse_kernel.cu).
//
// Design.  A CTA of 256 threads owns one row and walks it in tiles of 64
// consecutive blocks: a tile is [64, 128] f32 in shared memory, M-row m
// holding the tile's block m.  Up to one row an SM the wrapper launches
// the kernel built for one CTA an SM, with the whole register file
// (chain_kernel<1>); past that the one built for two (chain_kernel<2>).
// The stages run on the tile in order:
//   cascade  Z = X [Ltg | W] is one [64, 128] x [128, 136] product on the
//            tensor cores (mma.sync m16n8k8 in 3xTF32: hi*hi + hi*lo +
//            lo*hi, f32 accumulate), skipping the zero k-tiles below
//            Ltg's diagonal.  Ltg[i, c] = h[c - i] is Toeplitz, so a
//            fragment depends on n - k alone: each warp reads its 16 from
//            the 128-tap row h in shared memory into registers.  Only the
//            carry runs block by block, one thread scanning
//            c_{j+1} = u_j + c_j ACt over the tile's blocks (u = Z[:,
//            128:]); Y = Z[:, :128] + C Ecb is one more product.  The
//            running carry lives in device memory between tiles.
//   scale, ew, tap
//            elementwise: warp w holds M-rows w, w + 8, ... in registers
//            through a whole run of them, so Fuzz's three block maxima
//            are warp reductions and the run needs no barrier.
//   comb     y = x + d * y[n - D] as min(D, 64 * 128) independent chains
//            (positions c, c + D, ...), each from one load of a ring of
//            ceil(D/128)*128 outputs a row in device memory (the L2
//            holds it; config2's 12,032 samples a row would not fit in
//            shared memory), which takes the tile's last outputs.
//   mtap     the chorus: a modulated fractional tap on the stage INPUT,
//            t' = q[b] + r[t] + t - NH*128 (modfx.mtap_shared),
//            y = x*(1-mix) + (a*(1-frac) + b*frac)*mix.  Taps inside the
//            tile gather from the tile in shared memory, taps before it
//            from a ring of (NH+1)*128 input samples a row in device
//            memory, which takes the tile's last inputs after the gather.
// While a tile is in the stages, the next x tile loads into the other of
// two shared-memory buffers with cp.async, and the TMA engine stores the
// finished tile (cp.async.bulk); the ragged last tile is masked
// (zero-filled, never stored).  x and y rows start 16-byte aligned (the
// wrapper sees to x's start; T is a multiple of 128).
//
// The stage program is a packed array in device memory (header, stage
// records, per-cascade and per-ring pointer records, tap pointers), so no
// list length is fixed here; shared memory does not grow with it either.
// Raw outputs, in the TPU kernel's layout: per cascade the carry entering
// the render's last block and that block's stage input; per comb or mtap
// the ring, slot s = block b mod NR; the taps.  chain_segment.
// rebuild_states turns them into node states.

#include <stdint.h>

#include "chain_tiles.cuh"

#define CK_CB 8             // comb positions a thread loads at once

// Phase probes, built only by tools/measure_torch_chain.py --phases
// (-DCK_PHASES): thread 0 of each CTA adds the cycles since its last probe
// to the phase's counter, and the counters go to ck_phases at the exit.
#define PH_WAIT 0           // the tile's x in
#define PH_OPEN 1           // the barrier before a cascade, comb or mtap
#define PH_PRODUCT 2        // Z = X [Ltg | W]
#define PH_SCAN 3           // the carry scan
#define PH_ECB 4            // Y = Z + C Ecb
#define PH_EW 5             // a run of scale, ew and tap stages
#define PH_COMB 6
#define PH_MTAP 7
#define PH_OUT 8            // the output tile to the TMA engine
#define CK_NPH 9
#ifdef CK_PHASES
#define CK_PH_CTAS 4096
__device__ unsigned long long ck_phases[CK_PH_CTAS][CK_NPH];
__shared__ unsigned long long ck_acc[CK_NPH];
__shared__ long long ck_last;
#define PHASE(i)                                          \
  do {                                                    \
    if (threadIdx.x == 0) {                               \
      const long long now_ = clock64();                   \
      ck_acc[i] += now_ - ck_last;                        \
      ck_last = now_;                                     \
    }                                                     \
  } while (0)
#else
#define PHASE(i) do {} while (0)
#endif

// The cascade and ring records, mirrored by ops/chain_kernel.py (CASC,
// RING); chain_kernel_abi() lets the wrapper check the sizes.
typedef struct {
  const float* hp;    // [2][136] hi, lo TF32 parts of the padded row h
  const float* w;     // [2][128][8] hi, lo of W
  const float* ecb;   // [2][8][128] hi, lo of Ecb
  const float* act;   // [8][8] ACt, the carry's step over one block
  float* carry;       // [B][8] running carry: the state entering the tile
  float* carry_out;   // [B][8] carry entering block K-1
  float* xlast_out;   // [B][128] stage input of block K-1
  const void* pad_;
} CkCasc;

typedef struct {
  float* ring;        // comb: [B][NR*128] outputs;
                      // mtap: [B][(NH+1)*128] inputs
  const int* mq;      // mtap: [K] per-block window start
  const int* mr;      // mtap: [T] residual offset
  const float* mfr;   // mtap: [T] interpolation weight
} CkRing;

// A run of elementwise stages [s0, s1) over the tile: warp w holds M-rows
// w, w + 8, ... (four samples a lane, 32 a thread) in registers while
// every stage of the run passes over them, each stage read once.  M-rows
// past the render are shaped too (they are never read into one that is
// not), but not stored as taps.  The record build (-DCK_RECORD) also
// stores each ew stage's input rows to its record.
__device__ __forceinline__ void ew_run(float* F,
                                       const CkStage* __restrict__ st, int s0,
                                       int s1,
                                       float* const* __restrict__ taps,
                                       float* const* __restrict__ recs,
                                       const Tile t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v[CK_NQ * 4];
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q) {
    const float4 f = reinterpret_cast<const float4*>(
        F + (warp + q * CK_NW) * CK_LD)[lane];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
  for (int s = s0; s < s1; ++s) {
    const CkStage S = st[s];
    if (S.kind == CK_SCALE) {
      const float h = S.p[0];
      each(v, [=](float x) { return x * h; });
    } else if (S.kind == CK_EW) {
#ifdef CK_RECORD
#pragma unroll
      for (int q = 0; q < CK_NQ; ++q) {
        const int m = warp + q * CK_NW;
        if (t.valid(m))
          reinterpret_cast<float4*>(recs[S.rec] + t.off(m))[lane] =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
#endif
      if (S.idx != EW_FUZZ) {
        ew_points(S.idx, S.p, v);
      } else {                                 // Fuzz: per block, a warp max
#pragma unroll
        for (int q = 0; q < CK_NQ; ++q)
          apply_ew(S.idx, S.p, *reinterpret_cast<float(*)[4]>(v + 4 * q),
                   WarpMax());
      }
    } else {                                   // CK_TAP
#pragma unroll
      for (int q = 0; q < CK_NQ; ++q) {
        const int m = warp + q * CK_NW;
        if (t.valid(m))
          reinterpret_cast<float4*>(taps[S.idx] + t.off(m))[lane] =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q)
    reinterpret_cast<float4*>(F + (warp + q * CK_NW) * CK_LD)[lane] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The carry scan over the tile's blocks, c_{j+1} = u_j + c_j ACt, by one
// thread holding the N live lanes (2, 4 or 8): N FMAs deep a block.  c0
// is the running carry entering the tile; cb takes the carry entering
// each block, and the running carry leaves for the next tile.
template <int N>
__device__ __forceinline__ void scan_row(const CkCasc& cc,
                                         const float* __restrict__ u,
                                         float* __restrict__ cb, const Tile t,
                                         const float (&c0)[CK_NS]) {
  float a[N][N], c[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) a[k][j] = __ldg(cc.act + k * CK_NS + j);
  const long long g = (long long)t.row * CK_NS;
#pragma unroll
  for (int j = 0; j < N; ++j) c[j] = c0[j];
  float un[N];
#pragma unroll
  for (int j = 0; j < N; ++j) un[j] = u[j];
  for (int jb = 0; jb < t.KTv; ++jb) {
    float nc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) nc[j] = un[j];
    if (jb + 1 < t.KTv) {                // the next block's u, ahead
#pragma unroll
      for (int j = 0; j < N; ++j) un[j] = u[(jb + 1) * CK_CLD + j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) cb[jb * CK_CLD + j] = c[j];
    if (t.b0 + jb == t.K - 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) cc.carry_out[g + j] = c[j];
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j) nc[j] = fmaf(c[k], a[k][j], nc[j]);
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = nc[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) cc.carry[g + j] = c[j];
}

// Z = X [Ltg | W] for the warp of m-tile m0 and n-tiles n = P i + PAR
// (PAR 0 also the W column tile, n = 16).  The fragments of Ltg depend
// on d = n - k alone (Toeplitz), so the warp reads its 16 from the row h
// in shared memory once and keeps them in registers.
template <int PAR>
__device__ __forceinline__ void ltg_product(const float* F, const float* hs,
                                            const float* __restrict__ w,
                                            int m0,
                                            float (&acc)[16 / CK_P + 1][4]) {
  constexpr int NI = 16 / CK_P;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float b[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const float* hb = hs + 8 * d + gid - tig + 8;     // h[8d + gid - tig]
    b[d][0] = hb[0];
    b[d][1] = hb[-4];
    b[d][2] = hb[CK_HP];
    b[d][3] = hb[CK_HP - 4];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint32_t ah[4], al[4];
    load_a(F, CK_LD, m0, 8 * k, ah, al);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = CK_P * i + PAR - k;   // n-tile n uses k-tiles k <= n
      if (d >= 0) mma3(acc[i], ah, al, b[d][0], b[d][1], b[d][2], b[d][3]);
    }
    if (PAR == 0) {
      const float* wb = w + (8 * k + tig) * CK_NS + gid;
      mma3(acc[NI], ah, al, __ldg(wb), __ldg(wb + 4 * CK_NS),
           __ldg(wb + CK_C * CK_NS), __ldg(wb + CK_C * CK_NS + 4 * CK_NS));
    }
  }
}

template <int PAR = 0>
__device__ __forceinline__ void ltg_product_of(int par, const float* F,
                                               const float* hs,
                                               const float* w, int m0,
                                               float (&acc)[16 / CK_P + 1][4]) {
  if (par == PAR) {
    ltg_product<PAR>(F, hs, w, m0, acc);
  } else if constexpr (PAR + 1 < CK_P) {
    ltg_product_of<PAR + 1>(par, F, hs, w, m0, acc);
  }
}

// One cascade stage of N carry lanes on the tile (see the header).  Ub
// and Cb are [64][12] scratch for u and the carries; hs holds the stage's
// [2][136] row h, copied in before the barrier that opens the stage.
__device__ __forceinline__ void cascade_tile(float* F, const CkCasc& cc,
                                             int N, float* Ub, float* Cb,
                                             float* hs, const Tile t) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  float c0[CK_NS];                       // the scan's carry, read ahead
#pragma unroll
  for (int j = 0; j < CK_NS; ++j)
    c0[j] = tid == 0 ? cc.carry[(long long)t.row * CK_NS + j] : 0.0f;
  // raw outputs: the stage input of the render's last block
  if (t.b0 + t.KTv == t.K && tid < CK_C)
    cc.xlast_out[(long long)t.row * CK_C + tid] =
        F[(t.KTv - 1) * CK_LD + tid];

  // Z = X [Ltg | W]: warp (mt, par) takes the 16 M-rows of m-tile mt and
  // the n-tiles n = P i + par; par 0 also the W column tile (n = 16)
  constexpr int NI = 16 / CK_P;
  const int mt = warp % CK_MT, par = warp / CK_MT, m0 = mt * 16;
  float acc[NI + 1][4];
#pragma unroll
  for (int i = 0; i <= NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  ltg_product_of(par, F, hs, cc.w, m0, acc);
  float eh[NI][4];                     // Ecb's fragments, ahead of the scan
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float* eb = cc.ecb + tig * CK_C + 8 * (CK_P * i + par) + gid;
    eh[i][0] = __ldg(eb);
    eh[i][1] = __ldg(eb + 4 * CK_C);
    eh[i][2] = __ldg(eb + CK_NS * CK_C);
    eh[i][3] = __ldg(eb + CK_NS * CK_C + 4 * CK_C);
  }
  if (par == 0) {
    float* u = Ub + (m0 + gid) * CK_CLD + 2 * tig;
    u[0] = acc[NI][0];
    u[1] = acc[NI][1];
    u[8 * CK_CLD] = acc[NI][2];
    u[8 * CK_CLD + 1] = acc[NI][3];
  }
  __syncthreads();
  PHASE(PH_PRODUCT);

  // the carry scan, by thread 0
  if (tid == 0) {
    if (N <= 2) scan_row<2>(cc, Ub, Cb, t, c0);
    else if (N <= 4) scan_row<4>(cc, Ub, Cb, t, c0);
    else scan_row<8>(cc, Ub, Cb, t, c0);
  }
  __syncthreads();
  PHASE(PH_SCAN);

  // Y = Z[:, :128] + C Ecb, into the tile
  {
    uint32_t ah[4], al[4];
    load_a(Cb, CK_CLD, m0, 0, ah, al);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int n = CK_P * i + par;
      mma3(acc[i], ah, al, eh[i][0], eh[i][1], eh[i][2], eh[i][3]);
      float* o = F + (m0 + gid) * CK_LD + 8 * n + 2 * tig;
      o[0] = acc[i][0];
      o[1] = acc[i][1];
      o[8 * CK_LD] = acc[i][2];
      o[8 * CK_LD + 1] = acc[i][3];
    }
  }
}

// One feedback comb on the tile.  y[s] = x[s] + d y[s - D] splits into
// min(D, KTv*128) chains, positions s = c, c + D, c + 2D, ...; a thread
// walks CK_CB chains at once, each from one ring load (the output D
// before its first position) through its positions in the tile, so no
// barrier separates the steps.
__device__ __forceinline__ void comb_tile(float* F, const CkStage& S,
                                          float* rings, const Tile t) {
  const int D = S.n;
  const float decay = S.p[0];
  const int RL = ((D + CK_C - 1) / CK_C) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0m = (int)((long long)t.b0 * CK_C % RL);   // tile start mod RL
  const int nch = min(D, Lv);
  float* const ring = rings + (long long)t.row * RL;
  for (int i0 = threadIdx.x; i0 < nch; i0 += CK_CB * CK_NT) {
    float prev[CK_CB];
    int c[CK_CB];
#pragma unroll
    for (int u = 0; u < CK_CB; ++u) {
      const int i = i0 + u * CK_NT;
      c[u] = i < nch ? i : Lv;                          // Lv: no chain
      const int p = t0m + min(c[u], D - 1) - D;        // in (t0m - RL, t0m)
      prev[u] = ring[p < 0 ? p + RL : p];
    }
    for (int k = 0; k * D < Lv; ++k) {
#pragma unroll
      for (int u = 0; u < CK_CB; ++u) {
        const int s = c[u] + k * D;
        if (s < Lv) {
          float* f = F + (s >> 7) * CK_LD + (s & (CK_C - 1));
          prev[u] = __fadd_rn(*f, __fmul_rn(prev[u], decay));
          *f = prev[u];
        }
      }
    }
  }
  __syncthreads();                         // the ring takes other columns
  const int first = Lv - min(RL, Lv);     // the samples the ring keeps
  const int p0 = (t0m + first) % RL;       // and where the first goes
  for (int s = first + threadIdx.x; s < Lv; s += CK_NT) {
    const int p = p0 + s - first;
    ring[p < RL ? p : p - RL] = F[(s >> 7) * CK_LD + (s & (CK_C - 1))];
  }
}

// One mtap stage on the tile: gather from the tile's input and the ring,
// then (after a barrier) the ring takes the tile's input and the tile the
// outputs, each thread writing the samples it gathered for.
__device__ __forceinline__ void mtap_tile(float* F, const CkStage& S,
                                          const CkRing& rg, const Tile t) {
  const int NH = S.n;
  const float mix = S.p[0];
  const int RL = (NH + 1) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0 = t.b0 * CK_C;            // times within a row fit an int
  const int t0m = t0 % RL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const ring = rg.ring + (long long)t.row * RL;
  float out[CK_NQ][4];
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q) {
    // M-rows past the render gather (from real addresses) too; their
    // outputs are never stored, and no branch holds the loads apart
    const int m = warp + q * CK_NW;
    const int blk = min(t.b0 + m, t.K - 1);
    const int tt0 = blk * CK_C + 4 * lane;
    const int base = __ldg(rg.mq + blk) - NH * CK_C + tt0;
    const int4 rr = __ldg(reinterpret_cast<const int4*>(rg.mr + tt0));
    const float4 ff = __ldg(reinterpret_cast<const float4*>(rg.mfr + tt0));
    const int ro[4] = {rr.x, rr.y, rr.z, rr.w};
    const float fr[4] = {ff.x, ff.y, ff.z, ff.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tm = base + ro[e] + e;   // the tap time, in (t0 - RL, t0 + Lv)
      float ab[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = tm + h - t0;        // both addresses stay in bounds
        const int sf = max(s, 0), p = t0m + min(s, -1);
        ab[h] = s >= 0 ? F[(sf >> 7) * CK_LD + (sf & (CK_C - 1))]
                       : ring[p < 0 ? p + RL : p];
      }
      const float wet = ab[0] * (1.0f - fr[e]) + ab[1] * fr[e];
      out[q][e] = F[m * CK_LD + 4 * lane + e] * (1.0f - mix) + wet * mix;
    }
  }
  __syncthreads();                       // every gather has read its input
  const int first = Lv - min(RL, Lv);    // the samples the ring keeps
  const int p0 = (t0m + first) % RL;      // and where the first goes
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q) {
    const int m = warp + q * CK_NW;
    if (!t.valid(m)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * lane + e, s = m * CK_C + c;
      float* f = F + m * CK_LD + c;
      const int p = p0 + s - first;
      if (s >= first) ring[p < RL ? p : p - RL] = *f;
      *f = out[q][e];
    }
  }
}

// CTAS: the CTAs an SM the register budget allows (1: up to 255 a thread)
template <int CTAS>
__global__ void __launch_bounds__(CK_NT, CTAS)
chain_kernel(const char* __restrict__ prog, const float* __restrict__ x,
             float* __restrict__ y, int T) {
  extern __shared__ float4 smem4[];
  float* F0 = reinterpret_cast<float*>(smem4);
  float* F1 = F0 + CK_M * CK_LD;
  float* Ub = F1 + CK_M * CK_LD;
  float* Cb = Ub + CK_M * CK_CLD;
  float* hs = Cb + CK_M * CK_CLD;
  const CkHeader* H = reinterpret_cast<const CkHeader*>(prog);
  const CkStage* st = reinterpret_cast<const CkStage*>(prog + H->off_stage);
  const CkCasc* casc = reinterpret_cast<const CkCasc*>(prog + H->off_casc);
  const CkRing* rings = reinterpret_cast<const CkRing*>(prog + H->off_ring);
  float* const* taps = reinterpret_cast<float* const*>(prog + H->off_tap);
  float* const* recs = reinterpret_cast<float* const*>(prog + H->off_rec);
  const int n_stages = H->n_stages;

  Tile t;
  t.row = blockIdx.x;
  t.T = T;
  t.K = T / CK_C;
  const int n_tiles = (t.K + CK_M - 1) / CK_M;

  // the carry buffers' rows past a ragged tile are read (never used) by
  // the product: keep them finite
  for (int i = threadIdx.x; i < 2 * CK_M * CK_CLD; i += CK_NT) Ub[i] = 0.0f;
#ifdef CK_PHASES
  if (threadIdx.x < CK_NPH) ck_acc[threadIdx.x] = 0;
  if (threadIdx.x == 0) ck_last = clock64();
#endif
  load_tile(F0, x, t, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    float* F = (tile & 1) ? F1 : F0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if ((threadIdx.x & 31) == 0)         // the TMA has read the other buffer
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();                     // the tile is in; the other
                                         // buffer is free
    PHASE(PH_WAIT);
    if (tile + 1 < n_tiles) load_tile((tile & 1) ? F0 : F1, x, t,
                                      (tile + 1) * CK_M);
    t.b0 = tile * CK_M;
    t.KTv = min(CK_M, t.K - t.b0);

    for (int s = 0; s < n_stages;) {
      const int kind = st[s].kind;
      if (kind == CK_SCALE || kind == CK_EW || kind == CK_TAP) {
        int e = s + 1;
        while (e < n_stages && (st[e].kind == CK_SCALE || st[e].kind == CK_EW
                                || st[e].kind == CK_TAP))
          ++e;
        ew_run(F, st, s, e, taps, recs, t);
        PHASE(PH_EW);
        s = e;
        continue;
      }
      const CkStage S = st[s];
      if (kind == CK_CASCADE)            // its Toeplitz row
        for (int i = threadIdx.x; i < 2 * CK_HP; i += CK_NT)
          hs[i] = __ldg(casc[S.idx].hp + i);
      __syncthreads();                   // the tile is consistent
      PHASE(PH_OPEN);
      if (kind == CK_CASCADE) {
        cascade_tile(F, casc[S.idx], S.n, Ub, Cb, hs, t);
      } else if (kind == CK_COMB) {
        comb_tile(F, S, rings[S.idx].ring, t);
      } else {                           // CK_MTAP
        mtap_tile(F, S, rings[S.idx], t);
      }
      __syncthreads();                   // its writes are visible
      PHASE(kind == CK_CASCADE ? PH_ECB : kind == CK_COMB ? PH_COMB : PH_MTAP);
      ++s;
    }

    // y: each block row to device memory by the TMA engine, which reads
    // shared memory while the next tile starts; lane 0 of each warp sends
    // the rows its warp owns
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      for (int m = threadIdx.x >> 5; m < CK_M; m += CK_NW)
        if (t.valid(m))
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              :: "l"(y + t.off(m)),
                 "r"((uint32_t)__cvta_generic_to_shared(F + m * CK_LD)),
                 "n"(CK_C * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    PHASE(PH_OUT);
  }
  if ((threadIdx.x & 31) == 0)             // y is written before the exit
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#ifdef CK_PHASES
  if (threadIdx.x < CK_NPH && blockIdx.x < CK_PH_CTAS)
    ck_phases[blockIdx.x][threadIdx.x] = ck_acc[threadIdx.x];
#endif
}

// Dynamic shared memory of a CTA: two tiles, the carry buffers, the row h.
static const int SMEM_BYTES =
    (2 * CK_M * CK_LD + 2 * CK_M * CK_CLD + 2 * CK_HP) * (int)sizeof(float);

// Struct sizes for the wrapper's layout check: header, stage, cascade and
// ring records, one byte each.
extern "C" int chain_kernel_abi(void) {
  return (int)sizeof(CkHeader) | (int)sizeof(CkStage) << 8
      | (int)sizeof(CkCasc) << 16 | (int)sizeof(CkRing) << 24;
}

#ifdef CK_PHASES
// The phase counters of the first n CTAs of the last launch into host[n][9].
extern "C" int chain_kernel_phases(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, ck_phases, sizeof(unsigned long long)
                                   * CK_NPH * min(n, CK_PH_CTAS));
}
#endif

// The blocks of a tile, which the wrapper's model of the walk assumes.
extern "C" int chain_kernel_shape(void) { return CK_M; }

// Launch B CTAs, one a row, of the kernel built for `ctas` CTAs an SM (1
// or 2) on `stream` (the caller's current PyTorch stream); returns the
// cudaGetLastError() code of the launch, 0 on success.  `prog` is the
// packed program in device memory.
extern "C" int chain_kernel_launch(const void* prog, const float* x, float* y,
                                   int B, int T, int ctas, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || (ctas != 1 && ctas != 2)) return (int)cudaErrorInvalidValue;
  void (*kern)(const char*, const float*, float*, int) =
      ctas == 1 ? chain_kernel<1> : chain_kernel<2>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, CK_NT, SMEM_BYTES, (cudaStream_t)stream>>>((const char*)prog, x,
                                                       y, T);
  return (int)cudaGetLastError();
}
