// chain_reverse_kernel.cu -- the vjp of a chain segment in one backward
// pass over the signal.
//
// Replaces, in the PyTorch port, the program XLA compiles for the JAX
// package's chain segment backward: dsp_stuff_tpu/ops/chain_segment.py:
// _segment_vjp (:246), whose bwd (:256-261) is jax.vjp of its
// segment_fallback.  It has no pallas_call of its own.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/chain_segment.py:segment_adjoint; the
// wrapper that packs the stage program, builds, binds and launches it is
// ops/chain_reverse_kernel.py.
//
// What bounds it.  As the forward (chain_kernel.cu): the signal's bytes.
// y's cotangent, each tap's cotangent and each shaper's input (written by
// the forward's record build) are read once, x's gradient is written once;
// the cascades' transposed products are as many TF32 tensor-core
// operations as the forward's, well under the bytes' time.
//
// Design.  The forward's walk, run backwards.  A CTA of 256 threads owns
// one row and walks its tiles of 64 blocks from the last to the first; a
// tile [64, 128] f32 in shared memory holds the flow's adjoint, M-row m
// the tile's block m.  It starts as y's cotangent (loaded a tile ahead
// with cp.async into the other of two buffers) and goes through the
// stages in reverse; what is left is x's gradient, stored by the TMA
// engine (cp.async.bulk) while the walk goes on.
//   cascade  the forward is Z = X [Ltg | W], c_{j+1} = u_j + c_j ACt,
//            Y = Z[:, :128] + C Ecb.  Its adjoint: Cbar_j = Ybar_j Ecb^T
//            + Cbar_{j+1} ACt^T, one block at a time from the tile's end
//            by one thread (the running carry adjoint in device memory
//            between tiles), and Xbar = Ybar Ltg^T + Cbar_next W^T, both
//            products 3xTF32 mma.sync on the tensor cores as the
//            forward's.  Ltg^T is upper-triangular Toeplitz in the same
//            taps h, so a fragment depends on k - n alone and the zero
//            k-tiles above the diagonal are skipped; Ybar Ecb^T is one
//            more n-tile of the same pass.  The info cotangents come as
//            seeds on the render's last block (the wrapper pulls them back
//            through cascade_tail_states); the state's gradient is the
//            carry adjoint at block 0.
//   comb     the anti-causal comb vbar[n] = ybar[n] + d vbar[n + D] (the
//            new history's cotangent added on the last D samples) as
//            min(D, 64*128) independent chains walked backwards, each
//            from one load of a ring of the ceil(D/128)*128 later
//            adjoints a row in device memory, which then takes the tile's
//            first adjoints; the history's gradient is d vbar[j], j < D.
//   mtap     output t read the stage input at t' = q[b] + r[t] + t -
//            NH*128 and t' + 1, t - (NH+1)*128 < t' < t - 1.  Input p's
//            adjoint is ybar[p] (1 - mix), plus mix ybar[t] (1 - frac[t])
//            over the outputs with t' = p and mix ybar[t] frac[t] over
//            those with t' = p - 1: gathered, not scattered, so that no
//            float atomics make the sums' order vary.  t' is monotone in t
//            (mtap_static's gate keeps the delay's change under a sample a
//            sample), so each such set is a run of outputs; shared memory
//            holds each run's first output, by t'.  What lands before the
//            tile (up to (NH+1)*128 inputs back) waits in a ring of two
//            buffers a row in device memory (read one, write the other)
//            for the tile before; after the walk the ring holds the
//            history's gradient.
//   scale, ew, tap
//            elementwise in registers, warp w holding M-rows w, w + 8, ...
//            as in the forward; a shaper's derivative from its recorded
//            input (stages.cuh's ew_grad; Fuzz's three block maxima again
//            from the recorded block, warp reductions, with its tie rule,
//            fuzz_grad); a tap's cotangent added in.
// Every sum is taken in a fixed order, so launches repeat bit for bit.
// Arithmetic is plain FP32 (-fmad=false) but for the 3xTF32 products.

#include <stdint.h>

#include "chain_tiles.cuh"

#define CR_CB 8             // comb chains a thread walks at once

// The cascade and ring records, mirrored by ops/chain_reverse_kernel.py
// (CASC, RING); chain_reverse_abi() lets the wrapper check the sizes.
typedef struct {
  const float* hp;      // [2][136] the forward's padded row h, hi and lo
  const float* w;       // [2][128][8] W, hi and lo
  const float* ecb;     // [2][8][128] Ecb, hi and lo
  const float* act;     // [8][8] ACt
  float* gcarry;        // [B][8] running carry adjoint: of the carry leaving
                        // the tile (zeros before the walk)
  float* g_state;       // [B][8] the state's gradient (the carry adjoint at
                        // block 0)
  const float* seed_x;  // [B][128] the last block's input seed, or null
  const float* seed_c;  // [B][8] the seed of the carry entering it, or null
} CrvCasc;

typedef struct {
  float* ring;           // comb: [B][RL] later adjoints (zeros before);
                         // mtap: two [B][RL] buffers of the inputs'
                         // pending adjoints
  const float* ct_hist;  // [B][n] the new history's cotangent, or null
  float* g_hist;         // [B][n] the history's gradient
  const int* mq;         // mtap: [K] per-block window start
  const int* mr;         // mtap: [T] residual offset
  const float* mfr;      // mtap: [T] interpolation weight
  int n, nh;             // comb: D, 0; mtap: L, NH
  const void* pad_;
} CrvRing;

__device__ __forceinline__ bool elementwise(int kind) {
  return kind == CK_SCALE || kind == CK_EW || kind == CK_TAP;
}

// A run of elementwise stages [s0, s1) over the tile, in reverse: warp w
// holds M-rows w, w + 8, ... in registers while the run passes.  M-rows
// past the render read no cotangent or record (zeros) and are never
// stored.
__device__ __forceinline__ void ew_run_rev(
    float* F, const CkStage* __restrict__ st, int s0, int s1,
    const float* const* __restrict__ ct_taps,
    const float* const* __restrict__ recs, const Tile t) {
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
  for (int s = s1 - 1; s >= s0; --s) {
    const CkStage S = st[s];
    if (S.kind == CK_SCALE) {
      const float h = S.p[0];
      each(v, [=](float x) { return x * h; });
      continue;
    }
    const float* src = S.kind == CK_TAP ? ct_taps[S.idx] : recs[S.rec];
    if (src == nullptr) continue;           // a tap with no cotangent
#pragma unroll
    for (int q = 0; q < CK_NQ; ++q) {
      const int m = warp + q * CK_NW;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t.valid(m))
        r = __ldg(reinterpret_cast<const float4*>(src + t.off(m)) + lane);
      float* g = v + 4 * q;
      if (S.kind == CK_TAP) {
        g[0] = g[0] + r.x;
        g[1] = g[1] + r.y;
        g[2] = g[2] + r.z;
        g[3] = g[3] + r.w;
      } else if (S.idx != EW_FUZZ) {
        g[0] = ew_grad(S.idx, S.p, g[0], r.x);
        g[1] = ew_grad(S.idx, S.p, g[1], r.y);
        g[2] = ew_grad(S.idx, S.p, g[2], r.z);
        g[3] = ew_grad(S.idx, S.p, g[3], r.w);
      } else {                               // Fuzz: per block, a warp
        const float x4[4] = {r.x, r.y, r.z, r.w};
        fuzz_grad<4>(S.p[0], *reinterpret_cast<float(*)[4]>(g), x4,
                     WarpMax(), WarpSum());
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q)
    reinterpret_cast<float4*>(F + (warp + q * CK_NW) * CK_LD)[lane] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The carry adjoint's walk over the tile's blocks from its end, by one
// thread holding the N live lanes: Cbar_j = V_j + Cbar_{j+1} ACt^T (the
// seed added at the render's last block).  c0 is the adjoint of the carry
// leaving the tile; cn takes, per block, that of the carry leaving it
// (all 8 lanes, zeros past N), and the running adjoint leaves for the
// tile before.
template <int N>
__device__ __forceinline__ void rscan_row(const CrvCasc& cc,
                                          const float* __restrict__ v,
                                          float* __restrict__ cn,
                                          const Tile t,
                                          const float (&c0)[CK_NS]) {
  float a[N][N], c[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) a[k][j] = __ldg(cc.act + k * CK_NS + j);
  const long long g = (long long)t.row * CK_NS;
#pragma unroll
  for (int j = 0; j < N; ++j) c[j] = c0[j];
  for (int jb = t.KTv - 1; jb >= 0; --jb) {
#pragma unroll
    for (int j = 0; j < N; ++j) cn[jb * CK_CLD + j] = c[j];
#pragma unroll
    for (int j = N; j < CK_NS; ++j) cn[jb * CK_CLD + j] = 0.0f;
    float nc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) nc[k] = v[jb * CK_CLD + k];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j) nc[k] = fmaf(c[j], a[k][j], nc[k]);
    if (t.b0 + jb == t.K - 1 && cc.seed_c != nullptr) {
#pragma unroll
      for (int k = 0; k < N; ++k) nc[k] = nc[k] + cc.seed_c[g + k];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = nc[k];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) cc.gcarry[g + j] = c[j];
  if (t.b0 == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) cc.g_state[g + j] = c[j];
#pragma unroll
    for (int j = N; j < CK_NS; ++j) cc.g_state[g + j] = 0.0f;
  }
}

// P = Ybar Ltg^T for the warp of m-tile m0 and n-tiles n = P i + PAR, and
// (PAR 0) V = Ybar Ecb^T as one more n-tile.  Ltg^T[k][n] = h[k - n] for
// k >= n: the warp's 16 fragments, on d = k - n alone, come from the row
// h in shared memory (8 zeros before h[0]).
template <int PAR>
__device__ __forceinline__ void ltgT_product(const float* F, const float* hs,
                                             const float* __restrict__ ecb,
                                             int m0,
                                             float (&acc)[16 / CK_P + 1][4]) {
  constexpr int NI = 16 / CK_P;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float b[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const float* hb = hs + 8 * d + tig - gid + 8;     // h[8d + tig - gid]
    b[d][0] = hb[0];
    b[d][1] = hb[4];
    b[d][2] = hb[CK_HP];
    b[d][3] = hb[CK_HP + 4];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint32_t ah[4], al[4];
    load_a(F, CK_LD, m0, 8 * k, ah, al);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = k - (CK_P * i + PAR);   // n-tile n uses k-tiles k >= n
      if (d >= 0) mma3(acc[i], ah, al, b[d][0], b[d][1], b[d][2], b[d][3]);
    }
    if (PAR == 0) {
      const float* eb = ecb + gid * CK_C + 8 * k + tig;   // Ecb[gid][8k+tig]
      mma3(acc[NI], ah, al, __ldg(eb), __ldg(eb + 4),
           __ldg(eb + CK_NS * CK_C), __ldg(eb + CK_NS * CK_C + 4));
    }
  }
}

template <int PAR = 0>
__device__ __forceinline__ void ltgT_product_of(
    int par, const float* F, const float* hs, const float* ecb, int m0,
    float (&acc)[16 / CK_P + 1][4]) {
  if (par == PAR) {
    ltgT_product<PAR>(F, hs, ecb, m0, acc);
  } else if constexpr (PAR + 1 < CK_P) {
    ltgT_product_of<PAR + 1>(par, F, hs, ecb, m0, acc);
  }
}

// The adjoint of one cascade stage of N carry lanes on the tile (see the
// header).  Vb and Cb are [64][12] scratch for V and the carry adjoints;
// hs holds the stage's row h, copied in before the barrier that opens the
// stage.
__device__ __forceinline__ void cascade_rev(float* F, const CrvCasc& cc,
                                            int N, float* Vb, float* Cb,
                                            float* hs, const Tile t) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  float c0[CK_NS];                       // the scan's carry adjoint, ahead
#pragma unroll
  for (int j = 0; j < CK_NS; ++j)
    c0[j] = tid == 0 ? cc.gcarry[(long long)t.row * CK_NS + j] : 0.0f;

  constexpr int NI = 16 / CK_P;
  const int mt = warp % CK_MT, par = warp / CK_MT, m0 = mt * 16;
  float acc[NI + 1][4];
#pragma unroll
  for (int i = 0; i <= NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  ltgT_product_of(par, F, hs, cc.ecb, m0, acc);
  float wt[NI][4];                       // W^T's fragments, ahead of the scan
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float* wb = cc.w + (8 * (CK_P * i + par) + gid) * CK_NS + tig;
    wt[i][0] = __ldg(wb);                // W[8n + gid][tig]
    wt[i][1] = __ldg(wb + 4);
    wt[i][2] = __ldg(wb + CK_C * CK_NS);
    wt[i][3] = __ldg(wb + CK_C * CK_NS + 4);
  }
  if (par == 0) {
    float* u = Vb + (m0 + gid) * CK_CLD + 2 * tig;
    u[0] = acc[NI][0];
    u[1] = acc[NI][1];
    u[8 * CK_CLD] = acc[NI][2];
    u[8 * CK_CLD + 1] = acc[NI][3];
  }
  __syncthreads();
  if (tid == 0) {
    if (N <= 2) rscan_row<2>(cc, Vb, Cb, t, c0);
    else if (N <= 4) rscan_row<4>(cc, Vb, Cb, t, c0);
    else rscan_row<8>(cc, Vb, Cb, t, c0);
  }
  __syncthreads();

  // Xbar = P + Cbar_next W^T into the tile, the seed on the last block
  uint32_t ah[4], al[4];
  load_a(Cb, CK_CLD, m0, 0, ah, al);
  const long long sx = (long long)t.row * CK_C;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = CK_P * i + par;
    mma3(acc[i], ah, al, wt[i][0], wt[i][1], wt[i][2], wt[i][3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + gid + 8 * h, c = 8 * n + 2 * tig;
      float o0 = acc[i][2 * h], o1 = acc[i][2 * h + 1];
      if (cc.seed_x != nullptr && t.b0 + m == t.K - 1) {
        o0 = o0 + cc.seed_x[sx + c];
        o1 = o1 + cc.seed_x[sx + c + 1];
      }
      F[m * CK_LD + c] = o0;
      F[m * CK_LD + c + 1] = o1;
    }
  }
}

// The adjoint of one comb on the tile: vbar[s] = g[s] (+ the history's
// cotangent) + decay vbar[s + D] over min(D, KTv*128) chains, positions
// Lv-1-c, Lv-1-c-D, ...; a thread walks CR_CB chains at once, each from
// one ring load (vbar D after its first position, times past the render
// zeros).  The ring holds vbar at the times [t0 + Lv, t0 + Lv + RL), slot
// time mod RL, and takes the tile's first min(RL, Lv) afterwards.
__device__ __forceinline__ void comb_rev(float* F, const CkStage& S,
                                         const CrvRing& rg, const Tile t) {
  const int D = S.n;
  const float decay = S.p[0];
  const int RL = ((D + CK_C - 1) / CK_C) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0 = t.b0 * CK_C;            // times within a row fit an int
  const int nch = min(D, Lv);
  float* const ring = rg.ring + (long long)t.row * RL;
  const float* cth = rg.ct_hist != nullptr
      ? rg.ct_hist + (long long)t.row * D : nullptr;
  float* const gh = rg.g_hist + (long long)t.row * D;
  const int tail = t.T - D;              // the new history's first time
  for (int i0 = threadIdx.x; i0 < nch; i0 += CR_CB * CK_NT) {
    float prev[CR_CB];
    int s0[CR_CB];
#pragma unroll
    for (int u = 0; u < CR_CB; ++u) {
      const int i = i0 + u * CK_NT;
      s0[u] = i < nch ? Lv - 1 - i : -1;             // -1: no chain
      prev[u] = ring[(t0 + Lv - 1 - min(i, nch - 1) + D) % RL];
    }
    for (int k = 0; k * D < Lv; ++k) {
#pragma unroll
      for (int u = 0; u < CR_CB; ++u) {
        const int s = s0[u] - k * D;
        if (s0[u] >= 0 && s >= 0) {
          float* f = F + (s >> 7) * CK_LD + (s & (CK_C - 1));
          const int tt = t0 + s;
          float v = *f;
          if (cth != nullptr && tt >= tail) v = __fadd_rn(v, cth[tt - tail]);
          v = __fadd_rn(v, __fmul_rn(prev[u], decay));
          *f = v;
          prev[u] = v;
          if (tt < D) gh[tt] = __fmul_rn(v, decay);
        }
      }
    }
  }
  __syncthreads();                         // the ring takes other times
  for (int s = threadIdx.x; s < min(RL, Lv); s += CK_NT)
    ring[(t0 + s) % RL] = F[(s >> 7) * CK_LD + (s & (CK_C - 1))];
}

// The input time output t of an mtap reads (and the one after it).
__device__ __forceinline__ int tap_of(const CrvRing& rg, int t, int NH) {
  return __ldg(rg.mq + (t >> 7)) + __ldg(rg.mr + t) + t - NH * CK_C;
}

// The tile's outputs' part of input p's adjoint: mix g[s] (1 - frac) over
// the run of outputs s that read p first, then mix g[s] frac over those
// that read it second.  first[i] is the run's first output for input
// t0 - RL + i (-1: none).
__device__ __forceinline__ float mtap_gather(const float* F, const int* first,
                                            const CrvRing& rg, int t0, int Lv,
                                            int RL, int NH, float mix,
                                            int p) {
  const int i = p - (t0 - RL);
  float sum = 0.0f;
  for (int s = first[i]; s >= 0 && s < Lv && tap_of(rg, t0 + s, NH) == p;
       ++s) {
    const float gw = F[(s >> 7) * CK_LD + (s & (CK_C - 1))] * mix;
    sum = sum + gw * (1.0f - __ldg(rg.mfr + t0 + s));
  }
  for (int s = i > 0 ? first[i - 1] : -1;
       s >= 0 && s < Lv && tap_of(rg, t0 + s, NH) == p - 1; ++s) {
    const float gw = F[(s >> 7) * CK_LD + (s & (CK_C - 1))] * mix;
    sum = sum + gw * __ldg(rg.mfr + t0 + s);
  }
  return sum;
}

// The adjoint of one mtap on the tile (see the header).  The ring's
// buffer (tile + 1) & 1 holds the pending adjoints of the inputs
// [t0 + Lv - RL, t0 + Lv) from the later tiles' outputs; buffer tile & 1
// takes those of [t0 - RL, t0) for the tile before.  first: RL + 64*128
// ints of shared memory.
__device__ __forceinline__ void mtap_rev(float* F, const CkStage& S,
                                         const CrvRing& rg, int* first,
                                         const Tile t, int tile) {
  const int NH = S.n, L = rg.n;
  const float mix = S.p[0];
  const int RL = (NH + 1) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0 = t.b0 * CK_C;
  const int span = RL + Lv;
  float* const buf = rg.ring + (long long)t.row * 2 * RL;
  const float* rin = buf + ((tile + 1) & 1) * RL;
  float* const rout = buf + (tile & 1) * RL;
  const float* cth = rg.ct_hist != nullptr
      ? rg.ct_hist + (long long)t.row * L : nullptr;
  const int tail = t.T - L;              // the new history's first time
  for (int i = threadIdx.x; i < span; i += CK_NT) first[i] = -1;
  __syncthreads();
  for (int s = threadIdx.x; s < Lv; s += CK_NT) {
    const int tp = tap_of(rg, t0 + s, NH);
    if (s == 0 || tap_of(rg, t0 + s - 1, NH) != tp) {
      const int i = tp - (t0 - RL);
      if (i >= 0 && i < span) first[i] = s;
    }
  }
  __syncthreads();
  // the inputs before the tile: into the ring for the tile before
  for (int i = threadIdx.x; i < RL; i += CK_NT) {
    const int p = t0 - RL + i;
    float v = mtap_gather(F, first, rg, t0, Lv, RL, NH, mix, p);
    if (p >= t0 + Lv - RL) v = rin[p - (t0 + Lv - RL)] + v;
    rout[i] = v;
  }
  // the tile's inputs, then over the outputs' adjoints
  constexpr int NX = CK_M * CK_C / CK_NT;
  const float dry = 1.0f - mix;
  float xin[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const int s = threadIdx.x + k * CK_NT;
    if (s < Lv) {
      float v = F[(s >> 7) * CK_LD + (s & (CK_C - 1))] * dry;
      v = v + mtap_gather(F, first, rg, t0, Lv, RL, NH, mix, t0 + s);
      if (s >= Lv - RL) v = v + rin[s - (Lv - RL)];
      if (cth != nullptr && t0 + s >= tail) v = v + cth[t0 + s - tail];
      xin[k] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const int s = threadIdx.x + k * CK_NT;
    if (s < Lv) F[(s >> 7) * CK_LD + (s & (CK_C - 1))] = xin[k];
  }
}

// CTAS: the CTAs an SM the register budget allows (1: up to 255 a thread)
template <int CTAS>
__global__ void __launch_bounds__(CK_NT, CTAS)
chain_reverse_kernel(const char* __restrict__ prog,
                     const float* __restrict__ ybar, float* __restrict__ gx,
                     int T) {
  extern __shared__ float4 smem4[];
  float* F0 = reinterpret_cast<float*>(smem4);
  float* F1 = F0 + CK_M * CK_LD;
  float* Vb = F1 + CK_M * CK_LD;
  float* Cb = Vb + CK_M * CK_CLD;
  float* hs = Cb + CK_M * CK_CLD;
  int* first = reinterpret_cast<int*>(hs + 2 * CK_HP);
  const CkHeader* H = reinterpret_cast<const CkHeader*>(prog);
  const CkStage* st = reinterpret_cast<const CkStage*>(prog + H->off_stage);
  const CrvCasc* casc = reinterpret_cast<const CrvCasc*>(prog + H->off_casc);
  const CrvRing* rings = reinterpret_cast<const CrvRing*>(prog + H->off_ring);
  const float* const* ct_taps =
      reinterpret_cast<const float* const*>(prog + H->off_tap);
  const float* const* recs =
      reinterpret_cast<const float* const*>(prog + H->off_rec);
  const int n_stages = H->n_stages;

  Tile t;
  t.row = blockIdx.x;
  t.T = T;
  t.K = T / CK_C;
  const int n_tiles = (t.K + CK_M - 1) / CK_M;

  // the carry buffers' rows past a ragged tile are read (never used) by
  // the products: keep them finite
  for (int i = threadIdx.x; i < 2 * CK_M * CK_CLD; i += CK_NT) Vb[i] = 0.0f;
  load_tile(F0, ybar, t, (n_tiles - 1) * CK_M);
  for (int tile = n_tiles - 1, it = 0; tile >= 0; --tile, ++it) {
    float* F = (it & 1) ? F1 : F0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if ((threadIdx.x & 31) == 0)         // the TMA has read the other buffer
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();                     // the tile is in; the other
                                         // buffer is free
    if (tile > 0) load_tile((it & 1) ? F0 : F1, ybar, t, (tile - 1) * CK_M);
    t.b0 = tile * CK_M;
    t.KTv = min(CK_M, t.K - t.b0);

    for (int s = n_stages - 1; s >= 0;) {
      const int kind = st[s].kind;
      if (elementwise(kind)) {
        int e = s;
        while (e > 0 && elementwise(st[e - 1].kind)) --e;
        ew_run_rev(F, st, e, s + 1, ct_taps, recs, t);
        s = e - 1;
        continue;
      }
      const CkStage S = st[s];
      if (kind == CK_CASCADE)            // its Toeplitz row
        for (int i = threadIdx.x; i < 2 * CK_HP; i += CK_NT)
          hs[i] = __ldg(casc[S.idx].hp + i);
      __syncthreads();                   // the tile is consistent
      if (kind == CK_CASCADE) {
        cascade_rev(F, casc[S.idx], S.n, Vb, Cb, hs, t);
      } else if (kind == CK_COMB) {
        comb_rev(F, S, rings[S.idx], t);
      } else {                           // CK_MTAP
        mtap_rev(F, S, rings[S.idx], first, t, tile);
      }
      __syncthreads();                   // its writes are visible
      --s;
    }

    // x's gradient: each block row to device memory by the TMA engine, as
    // the forward stores y
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      for (int m = threadIdx.x >> 5; m < CK_M; m += CK_NW)
        if (t.valid(m))
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              :: "l"(gx + t.off(m)),
                 "r"((uint32_t)__cvta_generic_to_shared(F + m * CK_LD)),
                 "n"(CK_C * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if ((threadIdx.x & 31) == 0)             // gx is written before the exit
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // the histories' gradients not written in the walk: a comb's past the
  // render (D > T: the new history's cotangent), an mtap's from its ring
  // (after tile 0, buffer 0 holds the inputs [-RL, 0)) and its cotangent
  __syncthreads();
  for (int k = 0; k < H->n_ring; ++k) {
    const CrvRing& R = rings[k];
    const long long o = (long long)t.row * R.n;
    const float* cth = R.ct_hist != nullptr ? R.ct_hist + o : nullptr;
    if (R.mq == nullptr) {
      for (int j = T + threadIdx.x; j < R.n; j += CK_NT)
        R.g_hist[o + j] = cth != nullptr ? cth[j - T] : 0.0f;
      continue;
    }
    const int RL = (R.nh + 1) * CK_C;
    const float* buf0 = R.ring + (long long)t.row * 2 * RL;
    for (int j = threadIdx.x; j < R.n; j += CK_NT) {
      float v = buf0[j - R.n + RL];
      if (cth != nullptr && j >= T) v = v + cth[j - T];
      R.g_hist[o + j] = v;
    }
  }
}

// Dynamic shared memory of a CTA beside the mtap's run starts: two tiles,
// the carry buffers, the row h.
static const int SMEM_BASE =
    (2 * CK_M * CK_LD + 2 * CK_M * CK_CLD + 2 * CK_HP) * (int)sizeof(float);

// Struct sizes for the wrapper's layout check: header, stage, cascade and
// ring records, one byte each.
extern "C" int chain_reverse_abi(void) {
  return (int)sizeof(CkHeader) | (int)sizeof(CkStage) << 8
      | (int)sizeof(CrvCasc) << 16 | (int)sizeof(CrvRing) << 24;
}

// The layout constants the wrapper sizes by: (0) the blocks of a tile,
// (1) the dynamic shared memory beside the run starts, in bytes.
extern "C" int chain_reverse_shape(int what) {
  switch (what) {
    case 0: return CK_M;
    case 1: return SMEM_BASE;
  }
  return -1;
}

// Launch B CTAs, one a row, of the kernel built for `ctas` CTAs an SM (1
// or 2) on `stream`, with room for `span` ints of mtap run starts (0: no
// mtap stage); returns the cudaGetLastError() code of the launch, 0 on
// success, or cudaErrorInvalidValue when the shared memory exceeds the
// card's per block.  `prog` is the packed program in device memory.
extern "C" int chain_reverse_launch(const void* prog, const float* ybar,
                                    float* gx, int B, int T, int ctas,
                                    int span, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || span < 0 || (ctas != 1 && ctas != 2))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const char*, const float*, float*, int) =
      ctas == 1 ? chain_reverse_kernel<1> : chain_reverse_kernel<2>;
  const int smem = SMEM_BASE + span * (int)sizeof(int);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, CK_NT, smem, (cudaStream_t)stream>>>((const char*)prog, ybar, gx,
                                                 T);
  return (int)cudaGetLastError();
}
