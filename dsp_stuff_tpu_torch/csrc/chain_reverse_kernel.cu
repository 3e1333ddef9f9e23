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
// operations as the forward's, well under the bytes' time.  A CTA walks a
// row alone, so what it waits for inside a tile sets the pace: operands
// fetched where they are used, a carry adjoint one thread long, searches
// through device memory.  The design keeps each of them off the walk.
//
// Design.  The forward's walk, run backwards.  A CTA of 256 threads owns
// one row and walks its tiles of 64 blocks from the last to the first; a
// tile [64, 128] f32 in shared memory holds the flow's adjoint, M-row m
// the tile's block m.  It starts as y's cotangent (loaded a tile ahead
// with cp.async into the other of two buffers; zeros when there is none)
// and goes through the stages in reverse; what is left is x's gradient,
// stored by the TMA engine (cp.async.bulk) while the walk goes on.
//   operands  a tile of a shaper's record, of a tap's cotangent and of the
//            mtap's r and frac is one contiguous run of 32 KB in device
//            memory.  The wrapper lists them in the order the walk uses
//            them (CrvOp; a stage's `rec` is its index in a tile); thread
//            0 copies each with one TMA bulk copy, completing on an
//            mbarrier, into a ring of nslot slots [64][128] f32, and
//            refills a slot at the first barrier after its operand was
//            used (an elementwise run that would use more operands than
//            there are slots takes a barrier on its way).  With nslot at
//            least a tile's operands (the bench list's three records), a
//            tile's operands arrive while the tile before is in its
//            stages.
//   cascade  the forward is Z = X [Ltg | W], c_{j+1} = u_j + c_j ACt,
//            Y = Z[:, :128] + C Ecb.  Its adjoint: Cbar_j = Ybar_j Ecb^T
//            + Cbar_{j+1} ACt^T over the tile's blocks from its end, and
//            Xbar = Ybar Ltg^T + Cbar_next W^T, both products 3xTF32
//            mma.sync on the tensor cores as the forward's.  Ltg^T is
//            upper-triangular Toeplitz in the same taps h, so a fragment
//            depends on k - n alone and the zero k-tiles above the
//            diagonal are skipped; Ybar Ecb^T is one more n-tile of the
//            same pass, its fragments read from a copy of Ecb in shared
//            memory (rows padded against bank conflicts; 64 more registers
//            would spill), kept there with h and the powers below for the
//            whole walk where they fit.  The carry adjoint is a scan by warp 0 in a fixed
//            order: lane l of 8 takes the chunk of blocks 8l .. 8l + 7
//            (the running adjoint from the later tile folded into the
//            tile's last block) and sums it from its end; a log-depth scan
//            over the 8 chunks takes three steps, the step of distance d a
//            product by (ACt^T)^(8d) (the wrapper packs ACt^T and its 8th,
//            16th and 32nd powers beside the cascade's constants); then
//            each chunk runs again from the adjoint entering it.  18
//            matrix-vector products deep where the one thread's walk was
//            64, each block's adjoint still taken from its successor's
//            (a scan over 32 pairs, 7 deep, lost 1.4 dB against the plain
//            version on slow poles).  The running carry adjoint stays in
//            shared memory between tiles.  The info cotangents come as
//            seeds on the render's last block (the wrapper pulls them
//            back through cascade_tail_states); the state's gradient is
//            the carry adjoint at block 0.
//   comb     the anti-causal comb vbar[n] = ybar[n] + d vbar[n + D] (the
//            new history's cotangent added on the last D samples) as
//            min(D, 64*128) independent chains walked backwards, split
//            evenly: ceil(chains / 256) a thread, in one pass up to CR_CB,
//            a step's loads before its stores, predicated where the
//            history's cotangent and gradient do not reach.  Each starts
//            from one load of a ring of the ceil(D/128)*128 later
//            adjoints, in shared memory where the wrapper has room for it
//            (D up to a tile) and in device memory otherwise, which then
//            takes the tile's first adjoints; the history's gradient is
//            d vbar[j], j < D.
//   mtap     output t read the stage input at t' = q[b] + r[t] + t -
//            NH*128 and t' + 1, t - (NH+1)*128 < t' < t - 1.  Input p's
//            adjoint is ybar[p] (1 - mix), plus mix ybar[t] (1 - frac[t])
//            over the outputs with t' = p and mix ybar[t] frac[t] over
//            those with t' = p - 1: gathered, not scattered, so that no
//            float atomics make the sums' order vary.  t' is monotone in t
//            (mtap_static's gate keeps the delay's change under a sample a
//            sample), so each such set is a run of outputs.  Each output's
//            t' is computed once a tile into r's slot (relative to the
//            first input the tile's outputs can read); the run starts
//            first[] are written from it over the inputs the outputs
//            read, each once (nothing is cleared); the gather reads t' and
//            frac in shared memory, the first two outputs of a run at once
//            and with no branch unless the tile has a longer run, and
//            writes a chunk of 8 inputs a thread back at a time (input s's
//            gather reads only the outputs after s).  What lands before
//            the tile (up to (NH+1)*128 inputs back) waits in a ring of
//            two buffers a row in device memory (read one, write the
//            other) for the tile before; after the walk the ring holds the
//            history's gradient.
//   scale, ew, tap
//            elementwise in registers, warp w holding M-rows w, w + 8, ...
//            as in the forward; a shaper's derivative from its recorded
//            input in its slot (stages.cuh's ew_grads: the op decided
//            once a stage, then the thread's 32 samples with no branch
//            between them, where a branch a sample serialized them; Fuzz's
//            three block maxima again from the recorded block, warp
//            reductions, with its tie rule, fuzz_grad); a tap's cotangent
//            added in.
// The kernel writes every buffer it reads before it reads it (the rings on
// the walk's first tile, the carries in shared memory), so the wrapper
// allocates nothing zeroed.
//
// Shared memory of a CTA: SMEM_BASE (two tiles, the carry buffers, one
// cascade's constants, the slots' mbarriers: 84,352 B), 32 B a cascade
// (its running carry adjoint), nslot slots of 32 KB, the combs' rings that
// fit, the cascades' constants that fit (10,560 B each: h, Ecb, powers,
// kept for the walk instead of copied in at every stage), and the mtap's
// run starts ((NH+1)*128 + 64*128 ints).  The bench list takes three
// slots, its comb's ring and both cascades' constants: 213,568 B;
// config5's [hp, mtap] two slots, its cascade's constants and 35,840 B of
// run starts: 196,320 B; of the 232,448 B a CTA may take
// (ops/chain_reverse_kernel.py: layout).  The kernel is built for one CTA
// an SM at every B.
// Every sum is taken in a fixed order, so launches repeat bit for bit.
// Arithmetic is plain FP32 (-fmad=false) but for the 3xTF32 products.

#include <stdint.h>

#include "chain_tiles.cuh"

#define CR_CB 16            // comb chains a thread walks at once, at most
#define CRV_SLOTS 4         // operand slots, at most
#define CRV_SLOT (CK_M * CK_C)   // floats of a slot: a tile of an operand
#define CRV_CW 8            // blocks of a chunk of the carry adjoint's scan
#define CRV_XC 8            // mtap outputs or inputs a thread takes at once
#define CRV_NPOW 4          // powers (ACt^T)^p of a cascade: p = 1, CW,
                            // 2 CW, 4 CW
// a cascade's constants in shared memory: h, Ecb (rows padded), powers
#define CRV_CONSTS (2 * CK_HP + 2 * CK_NS * CK_LD + CRV_NPOW * CK_NS * CK_NS)

// Phase probes, built only by tools/measure_torch_chain.py --reverse
// --phases (-DCRV_PHASES): thread 0 of each CTA adds the cycles since its
// last probe to the phase's counter, and the counters go to crv_phases at
// the exit.
#define PV_WAIT 0           // the tile's cotangent in
#define PV_OPEN 1           // the barrier before a cascade, comb or mtap
                            // (and the wait for the mtap's operands)
#define PV_PRODUCT 2        // Ybar [Ltg^T | Ecb^T]
#define PV_SCAN 3           // the carry adjoint
#define PV_WT 4             // Xbar = P + Cbar W^T
#define PV_EW_LOAD 5        // an elementwise stage's operand in
#define PV_EW_MATH 6        // ... and its arithmetic
#define PV_COMB 7
#define PV_MT_START 8       // the mtap's t' and run starts
#define PV_MT_GATHER 9      // ... its gather
#define PV_MT_WRITE 10      // ... its write-back
#define PV_OUT 11           // x's gradient to the TMA engine
#define CRV_NPH 12
#ifdef CRV_PHASES
#define CRV_PH_CTAS 4096
__device__ unsigned long long crv_phases[CRV_PH_CTAS][CRV_NPH];
__shared__ unsigned long long crv_acc[CRV_NPH];
__shared__ long long crv_last;
__shared__ int crv_sink;
#define PHASE(i)                                          \
  do {                                                    \
    if (threadIdx.x == 0) {                               \
      const long long now_ = clock64();                   \
      crv_acc[i] += now_ - crv_last;                      \
      crv_last = now_;                                    \
    }                                                     \
  } while (0)
// thread 0 waits for a loaded value before its next probe
#define PHASE_USE(v)                                                  \
  do {                                                                \
    if (threadIdx.x == 0 && (v) == 1.2345e-37f) crv_sink = 1;         \
  } while (0)
#else
#define PHASE(i) do {} while (0)
#define PHASE_USE(v) do {} while (0)
#endif

// The cascade, ring and operand records, mirrored by
// ops/chain_reverse_kernel.py (CASC, RING, OP); chain_reverse_abi() and
// chain_reverse_shape() let the wrapper check the sizes.
typedef struct {
  const float* hp;      // [2][136] the forward's padded row h, hi and lo
  const float* w;       // [2][128][8] W, hi and lo
  const float* ecb;     // [2][8][128] Ecb, hi and lo
  const float* apow;    // [4][8][8] (ACt^T)^p, p = 1, 8, 16, 32,
                        // row-major [j][k]
  float* g_state;       // [B][8] the state's gradient (the carry adjoint at
                        // block 0)
  const float* seed_x;  // [B][128] the last block's input seed, or null
  const float* seed_c;  // [B][N] the seed of the carry entering it, or null
  int coff, pad_;       // the float offset of its h, Ecb and powers kept in
                        // shared memory for the walk (-1: copied in when
                        // its stage opens)
} CrvCasc;

typedef struct {
  float* ring;           // comb: [B][RL] later adjoints in device memory
                         // (null when on chip) and mtap: two [B][RL]
                         // buffers of the inputs' pending adjoints
  const float* ct_hist;  // [B][n] the new history's cotangent, or null
  float* g_hist;         // [B][n] the history's gradient
  const int* mq;         // mtap: [K] per-block window start
  int n, nh;             // comb: D, 0; mtap: L, NH
  int soff, pad_;        // comb: the ring's float offset in shared memory
                         // (-1: in device memory)
} CrvRing;

typedef struct {
  const float* src;      // its tile at block b0: src + row * ld + b0 * 128
  long long ld;          // floats between rows (T; 0: one row for all)
} CrvOp;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool elementwise(int kind) {
  return kind == CK_SCALE || kind == CK_EW || kind == CK_TAP;
}

// The operand ring.  Operand q (in walk order, n_ops a tile) lives in slot
// q % nslot, the (q / nslot)-th phase of that slot's mbarrier.
struct Stager {
  const CrvOp* ops;
  float* slots;
  uint64_t* bars;
  int n_ops, nslot, total;   // total: n_ops * n_tiles
  int issued;                // thread 0's count of operands issued
};

// Thread 0 issues the operands below `upto` not issued yet.
__device__ __forceinline__ void stage_upto(Stager& sg, int upto,
                                           const Tile& t, int n_tiles) {
  if (threadIdx.x != 0) return;
  upto = min(upto, sg.total);
  for (; sg.issued < upto; ++sg.issued) {
    const int q = sg.issued, it = q / sg.n_ops, j = q - it * sg.n_ops;
    const int b0 = (n_tiles - 1 - it) * CK_M;
    const int bytes = min(CK_M, t.K - b0) * CK_C * (int)sizeof(float);
    const CrvOp op = sg.ops[j];
    const float* src = op.src + t.row * op.ld + (long long)b0 * CK_C;
    const int slot = q % sg.nslot;
    const uint32_t bar = smem_u32(sg.bars + slot);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(sg.slots + slot * CRV_SLOT)), "l"(src), "r"(bytes),
           "r"(bar) : "memory");
  }
}

// Wait for operand q; returns its slot.
__device__ __forceinline__ float* stage_wait(const Stager& sg, int q) {
  const int slot = q % sg.nslot;
  const uint32_t bar = smem_u32(sg.bars + slot);
  const uint32_t parity = (q / sg.nslot) & 1;
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
  return sg.slots + slot * CRV_SLOT;
}

// A run of elementwise stages [s0, s1) over the tile, in reverse: warp w
// holds M-rows w, w + 8, ... in registers while the run passes.  M-rows
// past the render read no operand (zeros) and are never stored.  nj is
// the tile's next operand, rel the first one not released at the last
// barrier: an operand whose slot is not refilled yet takes a barrier.
__device__ __forceinline__ void ew_run_rev(float* F,
                                           const CkStage* __restrict__ st,
                                           int s0, int s1, Stager& sg,
                                           int base, int& nj, int& rel,
                                           const Tile t, int n_tiles) {
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
    if (S.rec < 0) continue;                // a tap with no cotangent
    if (S.rec >= rel + sg.nslot) {          // its slot waits for a barrier
      __syncthreads();
      rel = S.rec;
      stage_upto(sg, base + rel + sg.nslot, t, n_tiles);
    }
    const float* src = stage_wait(sg, base + S.rec);
    nj = S.rec + 1;
    float4 rq[CK_NQ];
#pragma unroll
    for (int q = 0; q < CK_NQ; ++q) {
      const int m = warp + q * CK_NW;
      rq[q] = t.valid(m) ? reinterpret_cast<const float4*>(src + m * CK_C)[lane]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    PHASE_USE(rq[0].x + rq[CK_NQ - 1].w);
    PHASE(PV_EW_LOAD);
    if (S.kind == CK_EW && S.idx != EW_FUZZ) {
      float x[CK_NQ * 4];                  // the op decided once
#pragma unroll
      for (int q = 0; q < CK_NQ; ++q) {
        x[4 * q] = rq[q].x;
        x[4 * q + 1] = rq[q].y;
        x[4 * q + 2] = rq[q].z;
        x[4 * q + 3] = rq[q].w;
      }
      ew_grads(S.idx, S.p, v, x);
    } else {
#pragma unroll
      for (int q = 0; q < CK_NQ; ++q) {
        const float4 r = rq[q];
        float* g = v + 4 * q;
        if (S.kind == CK_TAP) {
          g[0] = g[0] + r.x;
          g[1] = g[1] + r.y;
          g[2] = g[2] + r.z;
          g[3] = g[3] + r.w;
        } else {                             // Fuzz: per block, a warp
          const float x4[4] = {r.x, r.y, r.z, r.w};
          fuzz_grad<4>(S.p[0], *reinterpret_cast<float(*)[4]>(g), x4,
                       WarpMax(), WarpSum());
        }
      }
    }
    PHASE(PV_EW_MATH);
  }
#pragma unroll
  for (int q = 0; q < CK_NQ; ++q)
    reinterpret_cast<float4*>(F + (warp + q * CK_NW) * CK_LD)[lane] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// y[k] += sum_j x[j] P[j][k] over N lanes, j in order (P row-major [8][8])
template <int N>
__device__ __forceinline__ void mv(float (&y)[N], const float (&x)[N],
                                   const float* P) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) y[k] = fmaf(x[j], P[j * CK_NS + k], y[k]);
}

// The carry adjoint over the tile's blocks by warp 0 (see the header):
// lane l (lanes 8.. repeat lanes 0-7) takes the chunk of blocks CW l ..
// CW l + CW - 1 of N live lanes.  x_j = V_j (+ the seed on the render's
// last block; + the running adjoint c0 times ACt^T on the tile's last
// block), set in v by lane 0 first, zero past the tile.  A chunk's sum
// from its end (Cbar_j = x_j + Cbar_{j+1} ACt^T, nothing entering), the
// scan over the chunks (the step of distance d a product by (ACt^T)^(CW
// d)), then each chunk again from the adjoint entering it.  cn takes, per
// block, the adjoint of the carry leaving it (all 8 lanes, zeros past N);
// the adjoint entering block 0 goes on in `carry`.
template <int N>
__device__ __forceinline__ void rscan_warp(const CrvCasc& cc, int nl,
                                           const float* pw,
                                           float* __restrict__ v,
                                           float* __restrict__ cn,
                                           float* carry, const Tile t) {
  const int lane = threadIdx.x & 31, l = lane & (CRV_CW - 1);
  float c0[N];
#pragma unroll
  for (int k = 0; k < N; ++k) c0[k] = carry[k];
  if (lane == 0) {
    const int js = t.K - 1 - t.b0;         // the render's last block
    if (cc.seed_c != nullptr && js < t.KTv) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < nl)
          v[js * CK_CLD + k] = v[js * CK_CLD + k]
              + cc.seed_c[(long long)t.row * nl + k];
    }
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = v[(t.KTv - 1) * CK_CLD + k];
    mv<N>(y, c0, pw);
#pragma unroll
    for (int k = 0; k < N; ++k) v[(t.KTv - 1) * CK_CLD + k] = y[k];
  }
  __syncwarp();
  float S[N];                              // the chunk's sum, then l..'s
#pragma unroll
  for (int u = CRV_CW - 1; u >= 0; --u) {
    const int j = CRV_CW * l + u;
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = j < t.KTv ? v[j * CK_CLD + k] : 0.0f;
    if (u < CRV_CW - 1) mv<N>(y, S, pw);
#pragma unroll
    for (int k = 0; k < N; ++k) S[k] = y[k];
  }
#pragma unroll
  for (int i = 1; i < CRV_NPOW; ++i) {
    const int d = 1 << (i - 1);
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      y[k] = __shfl_down_sync(0xffffffffu, S[k], d, CRV_CW);
    if (l + d < CRV_CW) mv<N>(S, y, pw + i * CK_NS * CK_NS);
  }
  float c[N];                              // the adjoint entering the chunk
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c[k] = __shfl_down_sync(0xffffffffu, S[k], 1, CRV_CW);
    if (l == CRV_CW - 1) c[k] = 0.0f;
  }
#pragma unroll
  for (int u = CRV_CW - 1; u >= 0; --u) {
    const int j = CRV_CW * l + u;
    if (lane < CRV_CW) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        cn[j * CK_CLD + k] = j == t.KTv - 1 ? c0[k] : c[k];
#pragma unroll
      for (int k = N; k < CK_NS; ++k) cn[j * CK_CLD + k] = 0.0f;
    }
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = j < t.KTv ? v[j * CK_CLD + k] : 0.0f;
    mv<N>(y, c, pw);
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = y[k];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) carry[k] = c[k];
    if (t.b0 == 0) {
      const long long g = (long long)t.row * CK_NS;
#pragma unroll
      for (int k = 0; k < N; ++k) cc.g_state[g + k] = c[k];
#pragma unroll
      for (int k = N; k < CK_NS; ++k) cc.g_state[g + k] = 0.0f;
    }
  }
}

// P = Ybar Ltg^T for the warp of m-tile m0 and n-tiles n = P i + PAR, and
// (PAR 0) V = Ybar Ecb^T as one more n-tile.  Ltg^T[k][n] = h[k - n] for
// k >= n: the warp's 16 fragments, on d = k - n alone, come from the row
// h in shared memory (8 zeros before h[0]); Ecb's from its copy es
// [2][8][CK_LD] in shared memory.
template <int PAR>
__device__ __forceinline__ void ltgT_product(const float* F, const float* hs,
                                             const float* es, int m0,
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
      const float* eb = es + gid * CK_LD + 8 * k + tig;   // Ecb[gid][8k+tig]
      mma3(acc[NI], ah, al, eb[0], eb[4], eb[CK_NS * CK_LD],
           eb[CK_NS * CK_LD + 4]);
    }
  }
}

template <int PAR = 0>
__device__ __forceinline__ void ltgT_product_of(
    int par, const float* F, const float* hs, const float* es, int m0,
    float (&acc)[16 / CK_P + 1][4]) {
  if (par == PAR) {
    ltgT_product<PAR>(F, hs, es, m0, acc);
  } else if constexpr (PAR + 1 < CK_P) {
    ltgT_product_of<PAR + 1>(par, F, hs, es, m0, acc);
  }
}

// The adjoint of one cascade stage of N carry lanes on the tile (see the
// header).  Vb and Cb are [64][12] scratch for V and the carry adjoints;
// hs, es and pw hold the stage's row h, Ecb and powers, copied in before
// the barrier that opens the stage; carry is its running carry adjoint.
__device__ __forceinline__ void cascade_rev(float* F, const CrvCasc& cc,
                                            int N, float* Vb, float* Cb,
                                            const float* hs, const float* es,
                                            const float* pw, float* carry,
                                            const Tile t) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  constexpr int NI = 16 / CK_P;
  const int mt = warp % CK_MT, par = warp / CK_MT, m0 = mt * 16;
  float acc[NI + 1][4];
#pragma unroll
  for (int i = 0; i <= NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  ltgT_product_of(par, F, hs, es, m0, acc);
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
  PHASE(PV_PRODUCT);
  if (warp == 0) {
    if (N <= 2) rscan_warp<2>(cc, N, pw, Vb, Cb, carry, t);
    else if (N <= 4) rscan_warp<4>(cc, N, pw, Vb, Cb, carry, t);
    else rscan_warp<8>(cc, N, pw, Vb, Cb, carry, t);
  }
  __syncthreads();
  PHASE(PV_SCAN);

  // Xbar = P + Cbar_next W^T into the tile, the seed on the last block
  uint32_t ah[4], al[4];
  load_a(Cb, CK_CLD, m0, 0, ah, al);
  const float* const seed_x = cc.seed_x != nullptr
      ? cc.seed_x + (long long)t.row * CK_C : nullptr;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = CK_P * i + par;
    mma3(acc[i], ah, al, wt[i][0], wt[i][1], wt[i][2], wt[i][3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + gid + 8 * h, c = 8 * n + 2 * tig;
      float o0 = acc[i][2 * h], o1 = acc[i][2 * h + 1];
      if (seed_x != nullptr && t.b0 + m == t.K - 1) {
        o0 = o0 + seed_x[c];
        o1 = o1 + seed_x[c + 1];
      }
      F[m * CK_LD + c] = o0;
      F[m * CK_LD + c + 1] = o1;
    }
  }
}

// The adjoint of one comb on the tile: vbar[s] = g[s] (+ the history's
// cotangent) + decay vbar[s + D] over nch = min(D, KTv*128) chains,
// positions Lv-1-i, Lv-1-i-D, ...; thread x takes the chains i = x + 256
// u, u < ceil(nch / 256), in even passes of at most CR_CB, each chain from
// one ring load (vbar D after its first position; on the walk's first
// tile, times past the render: zeros).  The ring holds vbar at the times
// [t0 + Lv, t0 + Lv + RL), slot time mod RL, and takes the tile's first
// min(RL, Lv) afterwards (all RL on the first tile, zeros past the render).
__device__ __forceinline__ void comb_rev(float* __restrict__ F,
                                         const CkStage& S, const CrvRing& rg,
                                         float* smem, const Tile t,
                                         bool first) {
  const int D = S.n;
  const float decay = S.p[0];
  const int RL = ((D + CK_C - 1) / CK_C) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0 = t.b0 * CK_C;            // times within a row fit an int
  const int nch = min(D, Lv);
  float* const ring = rg.soff >= 0 ? smem + rg.soff
                                   : rg.ring + (long long)t.row * RL;
  const float* cth = rg.ct_hist != nullptr
      ? rg.ct_hist + (long long)t.row * D : nullptr;
  float* const gh = rg.g_hist + (long long)t.row * D;
  const int tail = t.T - D;              // the new history's first time
  const int cb = (nch + CK_NT - 1) / CK_NT;          // chains a thread
  const int np = (cb + CR_CB - 1) / CR_CB;           // passes
  const int per = (cb + np - 1) / np;                // chains a pass
  // whether the history's cotangent or gradient reach into the tile
  const bool edge = (cth != nullptr && t0 + Lv > tail) || t0 < D;
  const int r0 = (t0 + Lv - 1 + D) % RL;            // chain 0's ring slot
  for (int u0 = 0; u0 < cb; u0 += per) {
    float prev[CR_CB];
    int s0[CR_CB];
#pragma unroll
    for (int u = 0; u < CR_CB; ++u) {
      s0[u] = -1;
      prev[u] = 0.0f;
      if (u < per) {
        const int i = threadIdx.x + (u0 + u) * CK_NT;
        const bool live = i < nch;
        const int r = r0 - i;                        // i < nch <= D <= RL
        s0[u] = live ? Lv - 1 - i : -1;              // -1: no chain
        prev[u] = live && !first ? ring[r < 0 ? r + RL : r] : 0.0f;
      }
    }
    for (int k = 0; k * D < Lv; ++k) {
      // the step's positions are the chains' own and distinct: all its
      // loads go before its stores, which the compiler cannot know
      float g[CR_CB];
#pragma unroll
      for (int u = 0; u < CR_CB; ++u) {
        if (u < per) {
          const int s = max(s0[u] - k * D, 0);
          g[u] = F[s + ((s >> 7) << 2)];           // (s >> 7) CK_LD + s % 128
        }
      }
      if (!edge) {                         // no device memory: predicated
#pragma unroll
        for (int u = 0; u < CR_CB; ++u) {
          const int s = s0[u] - k * D;
          const float v = __fadd_rn(g[u], __fmul_rn(prev[u], decay));
          if (u < per && s >= 0) {
            F[s + ((s >> 7) << 2)] = v;
            prev[u] = v;
          }
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < CR_CB; ++u) {
        const int s = s0[u] - k * D;
        if (u < per && s >= 0) {
          float v = g[u];
          if (cth != nullptr && t0 + s >= tail)
            v = __fadd_rn(v, cth[t0 + s - tail]);
          v = __fadd_rn(v, __fmul_rn(prev[u], decay));
          F[s + ((s >> 7) << 2)] = v;
          prev[u] = v;
          if (t0 + s < D) gh[t0 + s] = __fmul_rn(v, decay);
        }
      }
    }
  }
  __syncthreads();                         // the ring takes other times
  const int w0 = t0 % RL;
  for (int s = threadIdx.x; s < (first ? RL : min(RL, Lv)); s += CK_NT) {
    const int r = w0 + s;                  // s < RL
    ring[r < RL ? r : r - RL] = s < Lv ? F[s + ((s >> 7) << 2)] : 0.0f;
  }
}

// One run of outputs' part of an input's adjoint: mix g[s] (1 - frac)
// (second: mix g[s] frac) over the outputs s from s1 (-1: none) whose tap
// tp[s] is i, added to sum in order.  The first two outputs are read at
// once, each term added only where its output is in the run (adding +0
// leaves the sum as it is: it starts at +0 and is never -0), with no
// branch, so that a thread's inputs interleave; a longer run (the delay
// growing by a sample in two; LONG: the tile has one) goes on in a loop.
template <bool LONG>
__device__ __forceinline__ float run_sum(const float* __restrict__ F,
                                         const int* __restrict__ tp,
                                         const float* __restrict__ fr, int s1,
                                         int i, int Lv, float mix, bool second,
                                         float sum) {
  const int sa = max(s1, 0), sb = min(sa + 1, Lv - 1);
  const float ga = F[(sa >> 7) * CK_LD + (sa & (CK_C - 1))] * mix;
  const float gb = F[(sb >> 7) * CK_LD + (sb & (CK_C - 1))] * mix;
  const float wa = second ? fr[sa] : 1.0f - fr[sa];
  const float wb = second ? fr[sb] : 1.0f - fr[sb];
  const bool in_b = s1 >= 0 && sa + 1 < Lv && tp[sb] == i;
  sum = sum + (s1 >= 0 ? ga * wa : 0.0f);
  sum = sum + (in_b ? gb * wb : 0.0f);
  if (LONG && in_b)
    for (int s = sa + 2; s < Lv && tp[s] == i; ++s) {
      const float gw = F[(s >> 7) * CK_LD + (s & (CK_C - 1))] * mix;
      sum = sum + gw * (second ? fr[s] : 1.0f - fr[s]);
    }
  return sum;
}

// The tile's outputs' part of input t0 - RL + i's adjoint: the run of
// outputs that read it first, then the run that reads it second.  tp[s]
// is output s's first input relative to t0 - RL; first[i] the run's
// first output for input i (-1: none), defined over [lo, hi] = [tp[0],
// tp[Lv - 1]].
template <bool LONG>
__device__ __forceinline__ float mtap_gather(const float* __restrict__ F,
                                            const int* __restrict__ first,
                                            const int* __restrict__ tp,
                                            const float* __restrict__ fr,
                                            int lo, int hi, int Lv, float mix,
                                            int i) {
  const int s1 = i >= lo && i <= hi ? first[i] : -1;
  const int s2 = i > lo && i <= hi + 1 ? first[i - 1] : -1;
  const float sum = run_sum<LONG>(F, tp, fr, s1, i, Lv, mix, false, 0.0f);
  return run_sum<LONG>(F, tp, fr, s2, i - 1, Lv, mix, true, sum);
}

// The mtap's gathers (see mtap_rev): the inputs before the tile into the
// ring for the tile before, then the tile's inputs over the outputs'
// adjoints, in chunks from the tile's start: input s's gather reads the
// outputs after s alone, so a chunk is written once its own gathers are
// done (a barrier) and before the next chunk's.
template <bool LONG>
__device__ __forceinline__ void mtap_inputs(
    float* __restrict__ F, const int* __restrict__ first,
    const int* __restrict__ tp, const float* __restrict__ fr, int lo, int hi,
    int Lv, int RL, float mix, const float* rin, float* rout,
    const float* cth, int t0, int tail, bool firstw) {
  constexpr int NX = CK_M * CK_C / CK_NT;
  // each group's gathers first, with no branch between them (an input past
  // the range reads a clamped one and is dropped), then their sums
  for (int i0 = 0; i0 < RL; i0 += CRV_XC * CK_NT) {
    float gs[CRV_XC];
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k)
      gs[k] = mtap_gather<LONG>(F, first, tp, fr, lo, hi, Lv, mix,
                                min(i0 + (int)threadIdx.x + k * CK_NT, RL - 1));
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int i = i0 + (int)threadIdx.x + k * CK_NT;
      if (i < RL) rout[i] = !firstw && i >= Lv ? rin[i - Lv] + gs[k] : gs[k];
    }
  }
  const float dry = 1.0f - mix;
  for (int c = 0; c < NX; c += CRV_XC) {
    float xin[CRV_XC];
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k)
      xin[k] = mtap_gather<LONG>(
          F, first, tp, fr, lo, hi, Lv, mix,
          RL + min((int)threadIdx.x + (c + k) * CK_NT, Lv - 1));
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = threadIdx.x + (c + k) * CK_NT;
      if (s < Lv) {
        float v = F[(s >> 7) * CK_LD + (s & (CK_C - 1))] * dry + xin[k];
        if (!firstw && s >= Lv - RL) v = v + rin[s - (Lv - RL)];
        if (cth != nullptr && t0 + s >= tail) v = v + cth[t0 + s - tail];
        xin[k] = v;
      }
    }
    PHASE_USE(xin[0]);
    PHASE(PV_MT_GATHER);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = threadIdx.x + (c + k) * CK_NT;
      if (s < Lv) F[(s >> 7) * CK_LD + (s & (CK_C - 1))] = xin[k];
    }
    PHASE(PV_MT_WRITE);
  }
}

// The adjoint of one mtap on the tile (see the header).  tp holds the
// tile's r (its slot, rewritten to t' here), fr its frac.  The ring's
// buffer (tile + 1) & 1 holds the pending adjoints of the inputs
// [t0 + Lv - RL, t0 + Lv) from the later tiles' outputs (none on the walk's
// first tile); buffer tile & 1 takes those of [t0 - RL, t0) for the tile
// before.  first: RL + 64*128 ints of shared memory.
__device__ __forceinline__ void mtap_rev(float* __restrict__ F,
                                         const CkStage& S, const CrvRing& rg,
                                         int* __restrict__ first,
                                         int* __restrict__ tp,
                                         const float* __restrict__ fr,
                                         const Tile t, int tile, bool firstw) {
  const int NH = S.n, L = rg.n;
  const float mix = S.p[0];
  const int RL = (NH + 1) * CK_C;
  const int Lv = t.KTv * CK_C;
  const int t0 = t.b0 * CK_C;
  float* const buf = rg.ring + (long long)t.row * 2 * RL;
  const float* rin = buf + ((tile + 1) & 1) * RL;
  float* const rout = buf + (tile & 1) * RL;
  const float* cth = rg.ct_hist != nullptr
      ? rg.ct_hist + (long long)t.row * L : nullptr;
  const int tail = t.T - L;              // the new history's first time
  constexpr int NX = CK_M * CK_C / CK_NT;
  const int* __restrict__ mq = rg.mq;    // (a field read in the loop would
                                         // be read again after each store)
  // t' - (t0 - RL) = q[b] + r[t] + s + 128, in place of r; each group's
  // loads before its stores (a clamped index past the tile, dropped)
  for (int k0 = 0; k0 < NX; k0 += CRV_XC) {
    int r[CRV_XC], q[CRV_XC];
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = min((int)threadIdx.x + (k0 + k) * CK_NT, Lv - 1);
      r[k] = tp[s];
      q[k] = __ldg(mq + ((t0 + s) >> 7));
    }
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = threadIdx.x + (k0 + k) * CK_NT;
      if (s < Lv) tp[s] = q[k] + r[k] + s + CK_C;
    }
  }
  __syncthreads();
  const int lo = tp[0], hi = tp[Lv - 1];
  // run starts: output s writes the inputs past its predecessor's tap
  bool longer = false;                   // a run of three outputs or more
  for (int k0 = 0; k0 < NX; k0 += CRV_XC) {
    int a[CRV_XC], b[CRV_XC], c[CRV_XC];  // tp of s, s - 1, s - 2
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = min((int)threadIdx.x + (k0 + k) * CK_NT, Lv - 1);
      a[k] = tp[s];
      b[k] = tp[max(s - 1, 0)];
      c[k] = tp[max(s - 2, 0)];
    }
#pragma unroll
    for (int k = 0; k < CRV_XC; ++k) {
      const int s = threadIdx.x + (k0 + k) * CK_NT;
      if (s < Lv) {
        const int i1 = a[k], i0 = s > 0 ? b[k] + 1 : i1;
        if (i0 <= i1) first[i1] = s;       // a step of 1 or 2, or more
        if (i0 < i1) first[i1 - 1] = -1;
        for (int i = i0; i < i1 - 1; ++i) first[i] = -1;
        longer = longer || (i0 > i1 && s > 1 && c[k] == i1);
      }
    }
  }
  const bool long_runs = __syncthreads_or(longer);
  PHASE(PV_MT_START);
  if (long_runs)
    mtap_inputs<true>(F, first, tp, fr, lo, hi, Lv, RL, mix, rin, rout, cth,
                      t0, tail, firstw);
  else
    mtap_inputs<false>(F, first, tp, fr, lo, hi, Lv, RL, mix, rin, rout, cth,
                       t0, tail, firstw);
  // r's slot was written here: ordered before the TMA refills it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A cascade's row h [2][136], Ecb [2][8][CK_LD] (rows padded) and powers
// [4][8][8] into c, CRV_CONSTS floats of shared memory, by the CTA.
__device__ __forceinline__ void casc_consts(const CrvCasc& cc, float* c) {
  for (int i = threadIdx.x; i < 2 * CK_HP; i += CK_NT) c[i] = __ldg(cc.hp + i);
  float* es = c + 2 * CK_HP;
  for (int i = threadIdx.x; i < 2 * CK_NS * CK_C; i += CK_NT)
    es[(i >> 7) * CK_LD + (i & (CK_C - 1))] = __ldg(cc.ecb + i);
  float* pw = es + 2 * CK_NS * CK_LD;
  for (int i = threadIdx.x; i < CRV_NPOW * CK_NS * CK_NS; i += CK_NT)
    pw[i] = __ldg(cc.apow + i);
}

// y's cotangent tile at block b0 into F (zeros past the render), or zeros
// when there is none.
__device__ __forceinline__ void ybar_tile(float* F,
                                          const float* __restrict__ ybar,
                                          const Tile t, int b0) {
  if (ybar != nullptr) {
    load_tile(F, ybar, t, b0);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < CK_M; m += CK_NW)
    reinterpret_cast<float4*>(F + m * CK_LD)[lane] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Dynamic shared memory of a CTA before its carries, slots, rings and run
// starts: two tiles, the carry buffers, the row h, Ecb, the powers, then
// the slots' mbarriers (8 bytes each, room for 8).
static const int SMEM_BASE =
    (2 * CK_M * CK_LD + 2 * CK_M * CK_CLD + CRV_CONSTS) * (int)sizeof(float)
    + 8 * 8;

// One CTA an SM, the whole register file (up to 255 a thread).  nslot:
// the operand slots; first_off: the float offset of the mtap's run starts
// in dynamic shared memory.
__global__ void __launch_bounds__(CK_NT, 1)
chain_reverse_kernel(const char* __restrict__ prog,
                     const float* __restrict__ ybar, float* __restrict__ gx,
                     int T, int nslot, int first_off) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* F0 = smem;
  float* F1 = F0 + CK_M * CK_LD;
  float* Vb = F1 + CK_M * CK_LD;
  float* Cb = Vb + CK_M * CK_CLD;
  float* hs = Cb + CK_M * CK_CLD;        // a cascade's constants, copied
                                         // in at its stage (casc_consts)
  uint64_t* bars = reinterpret_cast<uint64_t*>(hs + CRV_CONSTS);
  float* carries = smem + SMEM_BASE / (int)sizeof(float);
  int* first = reinterpret_cast<int*>(smem + first_off);
  const CkHeader* H = reinterpret_cast<const CkHeader*>(prog);
  const CkStage* st = reinterpret_cast<const CkStage*>(prog + H->off_stage);
  const CrvCasc* casc = reinterpret_cast<const CrvCasc*>(prog + H->off_casc);
  const CrvRing* rings = reinterpret_cast<const CrvRing*>(prog + H->off_ring);
  const int n_stages = H->n_stages;

  Tile t;
  t.row = blockIdx.x;
  t.T = T;
  t.K = T / CK_C;
  const int n_tiles = (t.K + CK_M - 1) / CK_M;

  Stager sg;
  sg.ops = reinterpret_cast<const CrvOp*>(prog + H->off_rec);
  sg.slots = carries + CK_NS * H->n_casc;
  sg.bars = bars;
  sg.n_ops = 0;
  for (int s = 0; s < n_stages; ++s) {    // the operands of a tile
    const CkStage& S = st[s];
    if ((S.kind == CK_EW || S.kind == CK_TAP || S.kind == CK_MTAP)
        && S.rec >= 0)
      sg.n_ops = max(sg.n_ops, S.rec + (S.kind == CK_MTAP ? 2 : 1));
  }
  sg.nslot = nslot;
  sg.total = sg.n_ops * n_tiles;
  sg.issued = 0;

  // the carry buffers' rows past a ragged tile are read (never used) by
  // the products: keep them finite; the running carry adjoints start at 0
  for (int i = threadIdx.x; i < 2 * CK_M * CK_CLD; i += CK_NT) Vb[i] = 0.0f;
  for (int i = threadIdx.x; i < CK_NS * H->n_casc; i += CK_NT)
    carries[i] = 0.0f;
  for (int k = 0; k < H->n_casc; ++k)     // the constants kept for the walk
    if (casc[k].coff >= 0) casc_consts(casc[k], smem + casc[k].coff);
  if (threadIdx.x == 0)
    for (int i = 0; i < nslot; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(bars + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef CRV_PHASES
  if (threadIdx.x < CRV_NPH) crv_acc[threadIdx.x] = 0;
  if (threadIdx.x == 0) crv_last = clock64();
#endif
  __syncthreads();
  stage_upto(sg, nslot, t, n_tiles);
  ybar_tile(F0, ybar, t, (n_tiles - 1) * CK_M);
  for (int tile = n_tiles - 1, it = 0; tile >= 0; --tile, ++it) {
    float* F = (it & 1) ? F1 : F0;
    const bool firstw = it == 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if ((threadIdx.x & 31) == 0)         // the TMA has read the other buffer
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();                     // the tile is in; the other
                                         // buffer is free
    PHASE(PV_WAIT);
    const int base = it * sg.n_ops;
    int nj = 0, rel = 0;                 // the tile's next and released ops
    stage_upto(sg, base + nslot, t, n_tiles);
    if (tile > 0) ybar_tile((it & 1) ? F0 : F1, ybar, t, (tile - 1) * CK_M);
    t.b0 = tile * CK_M;
    t.KTv = min(CK_M, t.K - t.b0);

    for (int s = n_stages - 1; s >= 0;) {
      const int kind = st[s].kind;
      if (elementwise(kind)) {
        int e = s;
        while (e > 0 && elementwise(st[e - 1].kind)) --e;
        ew_run_rev(F, st, e, s + 1, sg, base, nj, rel, t, n_tiles);
        s = e - 1;
        continue;
      }
      const CkStage S = st[s];
      if (kind == CK_CASCADE && casc[S.idx].coff < 0)   // its constants
        casc_consts(casc[S.idx], hs);
      __syncthreads();                   // the tile is consistent
      rel = nj;
      stage_upto(sg, base + rel + nslot, t, n_tiles);
      int* tp = nullptr;                 // an mtap's r and frac
      const float* fr = nullptr;
      if (kind == CK_MTAP) {
        tp = reinterpret_cast<int*>(stage_wait(sg, base + S.rec));
        fr = stage_wait(sg, base + S.rec + 1);
      }
      PHASE(PV_OPEN);
      if (kind == CK_CASCADE) {
        const CrvCasc& cc = casc[S.idx];
        const float* c = cc.coff >= 0 ? smem + cc.coff : hs;
        cascade_rev(F, cc, S.n, Vb, Cb, c, c + 2 * CK_HP,
                    c + 2 * CK_HP + 2 * CK_NS * CK_LD,
                    carries + CK_NS * S.idx, t);
      } else if (kind == CK_COMB) {
        comb_rev(F, S, rings[S.idx], smem, t, firstw);
      } else {                           // CK_MTAP
        mtap_rev(F, S, rings[S.idx], first, tp, fr, t, tile, firstw);
        nj = S.rec + 2;
      }
      __syncthreads();                   // its writes are visible
      rel = nj;
      stage_upto(sg, base + rel + nslot, t, n_tiles);
      PHASE(kind == CK_CASCADE ? PV_WT : kind == CK_COMB ? PV_COMB
                                                        : PV_MT_WRITE);
      --s;
    }

    // x's gradient: each block row to device memory by the TMA engine, as
    // the forward stores y
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage_upto(sg, base + sg.n_ops + nslot, t, n_tiles);
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
    PHASE(PV_OUT);
  }
  if ((threadIdx.x & 31) == 0)             // gx is written before the exit
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#ifdef CRV_PHASES
  if (threadIdx.x < CRV_NPH && blockIdx.x < CRV_PH_CTAS)
    crv_phases[blockIdx.x][threadIdx.x] = crv_acc[threadIdx.x];
#endif

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

// Struct sizes for the wrapper's layout check: header, stage, cascade and
// ring records, one byte each.
extern "C" int chain_reverse_abi(void) {
  return (int)sizeof(CkHeader) | (int)sizeof(CkStage) << 8
      | (int)sizeof(CrvCasc) << 16 | (int)sizeof(CrvRing) << 24;
}

#ifdef CRV_PHASES
// The phase counters of the first n CTAs of the last launch into
// host[n][CRV_NPH].
extern "C" int chain_reverse_phases(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, crv_phases, sizeof(unsigned long long)
                                   * CRV_NPH * min(n, CRV_PH_CTAS));
}
#endif

// The layout constants the wrapper sizes by: (0) the blocks of a tile,
// (1) the dynamic shared memory before the carries, in bytes, (2) the
// most operand slots, (3) the powers a cascade packs, (4) the operand
// record's size, in bytes, (5) the floats of a cascade's constants in
// shared memory.
extern "C" int chain_reverse_shape(int what) {
  switch (what) {
    case 0: return CK_M;
    case 1: return SMEM_BASE;
    case 2: return CRV_SLOTS;
    case 3: return CRV_NPOW;
    case 4: return (int)sizeof(CrvOp);
    case 5: return CRV_CONSTS;
  }
  return -1;
}

// Launch B CTAs, one a row, on `stream`, with `smem` bytes of dynamic
// shared memory laid out by the wrapper (`nslot` operand slots, the run starts at float
// `first_off`); returns the cudaGetLastError() code of the launch, 0 on
// success, or cudaErrorInvalidValue when the shared memory exceeds the
// card's per block.  `prog` is the packed program in device memory.
extern "C" int chain_reverse_launch(const void* prog, const float* ybar,
                                    float* gx, int B, int T, int nslot,
                                    int first_off, int smem, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || nslot < 0 || nslot > CRV_SLOTS || first_off < 0
      || smem < SMEM_BASE)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const char*, const float*, float*, int, int, int) =
      chain_reverse_kernel;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, CK_NT, smem, (cudaStream_t)stream>>>((const char*)prog, ybar, gx,
                                                 T, nslot, first_off);
  return (int)cudaGetLastError();
}
