// chain_kernel.cu -- a whole chain segment in one pass over the signal.
//
// Replaces dsp_stuff_tpu/ops/pallas_chain.py:chain_kernel_call (the Pallas
// megakernel of the JAX package) in the PyTorch port.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/chain_segment.py:segment_fallback;
// the wrapper that builds, binds and launches it is
// dsp_stuff_tpu_torch/ops/chain_kernel.py.
//
// Design.  One CTA of 128 threads per stream row; thread c owns sample
// column c of every 128-sample block, and the CTA walks the K = T/128
// blocks in order.  A block passes through every stage while it sits in
// registers (stage code in stages.cuh, shared with the cycle kernel):
//   cascade  y[c] = sum_{i<=c} X[i] Ltg[i,c] + sum_j carry[j] Ecb[j,c]
//            carry' = X.W + carry.ACt   (N <= 8 lanes, warp-shuffle sums)
//   scale    the folded fan-in scale
//   ew       the shapers (all nine distort modes, overdrive, chebyshev);
//            Fuzz takes three block-wide max reductions
//   tap      writes the flow out as an extra sequence
//   comb     y = x + d * y[n-D] from a ring of ceil(D/128)*128 samples
//            per row in global memory (wrapper-allocated, seeded with the
//            history); a comb with D < 128 has feedback inside the block
//            and runs in rounds of D columns
//   mtap     the chorus: a modulated fractional tap on a ring of the
//            stage INPUT, (NH+1)*128 samples per row in global memory.
//            The block is written into the ring first; after a barrier
//            each sample gathers a = ring[t'], b = ring[t'+1] at the
//            shared trajectory's tap time t' = q[b] + r[t] + t - NH*128
//            (modfx.mtap_shared) and mixes
//            y = x*(1-mix) + (a*(1-frac) + b*frac)*mix.  The TPU kernel's
//            3-block window, pltpu.roll and EV-way one-hot select were
//            Mosaic workarounds; a direct gather replaces them.
// At the last block each cascade writes the carry entering it and its
// stage input, and the rings are left holding slot s = block b mod NR:
// the raw-output layout of the TPU kernel, which
// chain_segment.rebuild_states turns into node states.
//
// What bounds it.  At B = 512 rows x 10 s the signal I/O is 2 x 0.98 GB,
// well under a millisecond of HBM time on an H100.  The kernel is bound
// instead by the sequential loop over 3750 blocks per row and, per block
// and cascade, the triangular 128 x 128 product (8,256 FMAs fed from the
// read-only cache) plus three CTA barriers.  512 CTAs of 4 warps put only
// about 16 warps on each SM, too few to hide that latency.  Later PRs:
// several rows per CTA so the cascade becomes a [rows,128]x[128,128] GEMM
// on the tensor cores (Ltg is Toeplitz, so one 128-tap row in shared
// memory describes it), and the rings in shared memory where they fit.

#include "stages.cuh"

#define CK_MAX_STAGES 32
#define CK_MAX_CASC 8
#define CK_MAX_RING 8
#define CK_MAX_TAP 8

// stage kinds
#define CK_CASCADE 0
#define CK_SCALE 1
#define CK_EW 2
#define CK_TAP 3
#define CK_COMB 4
#define CK_MTAP 5

// Mirrored field for field by ops/chain_kernel.py (_Stage, _Program);
// chain_kernel_abi() lets the wrapper check the size.
typedef struct {
  int kind;     // CK_*
  int idx;      // cascade / ew op / tap / ring index
  int n;        // cascade: carry lanes N; comb: delay D; mtap: NH
  float p[3];   // scale factor, shaper params, comb decay or mtap mix
} CkStage;

typedef struct {
  int n_stages;
  int pad_;
  CkStage st[CK_MAX_STAGES];
  const float* ltg[CK_MAX_CASC];   // [128, 128]
  const float* w[CK_MAX_CASC];     // [128, 8]
  const float* ecb[CK_MAX_CASC];   // [8, 128]
  const float* act[CK_MAX_CASC];   // [8, 8]
  const float* s0[CK_MAX_CASC];    // [B, 8] carry entering block 0
  float* carry_out[CK_MAX_CASC];   // [B, 8] carry entering block K-1
  float* xlast_out[CK_MAX_CASC];   // [B, 128] stage input of block K-1
  float* ring[CK_MAX_RING];        // comb: [B, NR*128]; mtap: [B, (NH+1)*128]
  const int* mq[CK_MAX_RING];      // mtap: [K] per-block window start
  const int* mr[CK_MAX_RING];      // mtap: [T] residual offset
  const float* mfr[CK_MAX_RING];   // mtap: [T] interpolation weight
  float* tap[CK_MAX_TAP];          // [B, T]
} CkProgram;

__global__ void __launch_bounds__(CK_C)
chain_kernel(const CkProgram P, const float* __restrict__ x,
             float* __restrict__ y, int T) {
  __shared__ StageScratch sh;
  __shared__ float carry[CK_MAX_CASC][CK_NS];
  const int c = threadIdx.x;
  const long long row = blockIdx.x;
  const int K = T / CK_C;
  const long long base = row * (long long)T;

  if (c < CK_NS) {
    for (int s = 0; s < P.n_stages; ++s)
      if (P.st[s].kind == CK_CASCADE)
        carry[P.st[s].idx][c] = P.s0[P.st[s].idx][row * CK_NS + c];
  }
  __syncthreads();

  for (int b = 0; b < K; ++b) {
    const long long t = (long long)b * CK_C + c;   // time within the render
    const long long off = base + t;
    float v = x[off];
    for (int s = 0; s < P.n_stages; ++s) {
      const int kind = P.st[s].kind;
      const int idx = P.st[s].idx;
      if (kind == CK_CASCADE) {
        float* cr = carry[idx];
        if (b == K - 1) {
          P.xlast_out[idx][row * CK_C + c] = v;
          if (c < CK_NS) P.carry_out[idx][row * CK_NS + c] = cr[c];
        }
        v = cascade_step(v, P.st[s].n, cr, P.ltg[idx], P.w[idx],
                         P.ecb[idx], P.act[idx], sh);
      } else if (kind == CK_SCALE) {
        v = v * P.st[s].p[0];
      } else if (kind == CK_EW) {
        v = apply_ew(idx, P.st[s].p, v, sh.redm);
      } else if (kind == CK_TAP) {
        P.tap[idx][off] = v;
      } else if (kind == CK_COMB) {
        const int D = P.st[s].n;
        const int RL = ((D + CK_C - 1) / CK_C) * CK_C;
        v = comb_step(v, P.ring[idx] + row * RL, RL, D, P.st[s].p[0], t);
      } else {                               // CK_MTAP
        const int NH = P.st[s].n;
        const int RL = (NH + 1) * CK_C;
        float* ring = P.ring[idx] + row * RL;
        ring[(int)(t % RL)] = v;
        __syncthreads();                     // the block is in the ring
        long long tm = (long long)__ldg(P.mq[idx] + b)
            + __ldg(P.mr[idx] + t) + t - (long long)NH * CK_C;
        int ia = (int)(tm % RL);
        if (ia < 0) ia += RL;
        const int ib = ia + 1 == RL ? 0 : ia + 1;
        const float fr = __ldg(P.mfr[idx] + t);
        const float wet = ring[ia] * (1.0f - fr) + ring[ib] * fr;
        const float mix = P.st[s].p[0];
        v = v * (1.0f - mix) + wet * mix;
        __syncthreads();                     // reads before the next write
      }
    }
    y[off] = v;
  }
}

extern "C" int chain_kernel_abi(void) { return (int)sizeof(CkProgram); }

// Launch on `stream` (the caller's current PyTorch stream); returns the
// cudaGetLastError() code of the launch, 0 on success.
extern "C" int chain_kernel_launch(const CkProgram* prog, const float* x,
                                   float* y, int B, int T, int device,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<<<B, CK_C, 0, (cudaStream_t)stream>>>(*prog, x, y, T);
  return (int)cudaGetLastError();
}
