// cycle_kernel.cu -- a feedback SCC's block program over the whole render.
//
// Replaces dsp_stuff_tpu/ops/pallas_cycle.py:cycle_kernel_call (the Pallas
// cycle kernel of the JAX package) in the PyTorch port.  Its plain PyTorch
// version is dsp_stuff_tpu_torch/ops/cycle_segment.py:interpret; the
// wrapper that builds, binds and launches it is ops/cycle_kernel.py.
//
// Design.  One CTA of 128 threads per stream row; thread c owns sample
// column c of every 128-sample block, and the CTA runs the program over
// the K = T/128 blocks in order (the TPU kernel's sequential grid becomes
// this loop, so there are no pad blocks and no write suppression).  The
// program is an instruction array (CyIns), uniform across the CTA:
//   join     flow = (sum of terms) * scale       terms: ext feeds or regs
//   lin2     flow = join(B)*cB + join(A)*cA      (add, mix)
//   cascade  the shared cascade step (stages.cuh); carries in shared memory
//   comb     the shared comb step on a global ring (wrapper-allocated,
//            seeded with the history)
//   ew       the shared shapers
//   scale    flow *= s
//   setreg   register := flow
//   tap      write flow to an output sequence
// Registers live in shared memory, [n_regs][128]; thread c reads and
// writes only column c of them, so they need no barrier of their own.  A
// join reads a register before that block's setreg and so sees the
// previous block's value: the reference's one-block feedback latency.
// The cascade's cross-column product reads the flow through shared memory
// and the comb reads other columns through its ring; both carry their own
// barriers (stages.cuh).
//
// Raw outputs, in the TPU kernel's layout: per cascade the carry entering
// the last block (padded to 8) and that block's input; per comb the ring,
// slot s = block b mod NR; the final registers.  cycle_segment.rebuild
// turns them into node states.
//
// What bounds it.  Like the chain kernel, each row's sequential latency:
// per block a cascade's triangular product and barriers, the comb's ring
// round trip, and the instruction dispatch.  With B = 128 rows only 128
// CTAs run, under one per SM, and the signal I/O (one read per feed, one
// write per tap) is small next to that.  Several rows per CTA would fill
// the card; that is a later PR's work.

#include "stages.cuh"

#define CY_MAX_INS 32
#define CY_MAX_TERMS 32
#define CY_MAX_EXT 8
#define CY_MAX_REG 8
#define CY_MAX_TAP 8
#define CY_MAX_CASC 8
#define CY_MAX_COMB 8
#define CY_REG 0x10000          // term code: CY_REG | r for register r

// instruction ops
#define CY_JOIN 0
#define CY_LIN2 1
#define CY_CASCADE 2
#define CY_COMB 3
#define CY_EW 4
#define CY_SCALE 5
#define CY_SETREG 6
#define CY_TAP 7

// Mirrored field for field by ops/cycle_kernel.py (_Ins, _Program);
// cycle_kernel_abi() lets the wrapper check the size.
typedef struct {
  int op;       // CY_*
  int idx;      // cascade / comb / ew op / register / tap index
  int n;        // cascade: carry lanes N; comb: delay D
  int ta, na;   // terms of join (or lin2's A): terms[ta .. ta+na)
  int tb, nb;   // lin2's B terms
  int pad_;
  float p[4];   // join: scale; lin2: sA, sB, cA, cB; comb: decay;
                // ew: params; scale: factor
} CyIns;

typedef struct {
  int n_ins;
  int n_regs;
  CyIns ins[CY_MAX_INS];
  int terms[CY_MAX_TERMS];
  const float* ext[CY_MAX_EXT];      // [B, T]
  float* tap[CY_MAX_TAP];            // [B, T]
  const float* reg0[CY_MAX_REG];     // [B, 128]
  float* reg_out[CY_MAX_REG];        // [B, 128]
  const float* ltg[CY_MAX_CASC];     // [128, 128]
  const float* w[CY_MAX_CASC];       // [128, 8]
  const float* ecb[CY_MAX_CASC];     // [8, 128]
  const float* act[CY_MAX_CASC];     // [8, 8]
  const float* s0[CY_MAX_CASC];      // [B, 8]
  float* carry_out[CY_MAX_CASC];     // [B, 8] carry entering block K-1
  float* xlast_out[CY_MAX_CASC];     // [B, 128] input of block K-1
  float* ring[CY_MAX_COMB];          // [B, ceil(D/128)*128]
} CyProgram;

__device__ __forceinline__ float term_sum(const CyProgram& P, int t0, int n,
                                          const float (*regs)[CK_C],
                                          long long off, int c) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) {
    const int code = P.terms[t0 + k];
    const float v = (code & CY_REG) ? regs[code & 0xffff][c]
                                    : P.ext[code][off];
    acc = k ? acc + v : v;
  }
  return acc;
}

__device__ __forceinline__ float join_val(const CyProgram& P, int t0, int n,
                                          float scale,
                                          const float (*regs)[CK_C],
                                          long long off, int c) {
  const float acc = term_sum(P, t0, n, regs, off, c);
  return scale != 1.0f ? acc * scale : acc;
}

__global__ void __launch_bounds__(CK_C)
cycle_kernel(const CyProgram P, int T) {
  __shared__ StageScratch sh;
  __shared__ float carry[CY_MAX_CASC][CK_NS];
  __shared__ float regs[CY_MAX_REG][CK_C];
  const int c = threadIdx.x;
  const long long row = blockIdx.x;
  const int K = T / CK_C;
  const long long base = row * (long long)T;

  for (int r = 0; r < P.n_regs; ++r) regs[r][c] = P.reg0[r][row * CK_C + c];
  if (c < CK_NS) {
    for (int i = 0; i < P.n_ins; ++i)
      if (P.ins[i].op == CY_CASCADE)
        carry[P.ins[i].idx][c] = P.s0[P.ins[i].idx][row * CK_NS + c];
  }
  __syncthreads();

  for (int b = 0; b < K; ++b) {
    const long long t = (long long)b * CK_C + c;   // time within the render
    const long long off = base + t;
    float flow = 0.0f;
    for (int i = 0; i < P.n_ins; ++i) {
      const CyIns& I = P.ins[i];
      switch (I.op) {
        case CY_JOIN:
          flow = join_val(P, I.ta, I.na, I.p[0], regs, off, c);
          break;
        case CY_LIN2: {
          const float a = join_val(P, I.ta, I.na, I.p[0], regs, off, c);
          const float bb = join_val(P, I.tb, I.nb, I.p[1], regs, off, c);
          flow = bb * I.p[3] + a * I.p[2];
          break;
        }
        case CY_CASCADE: {
          float* cr = carry[I.idx];
          if (b == K - 1) {
            P.xlast_out[I.idx][row * CK_C + c] = flow;
            if (c < CK_NS) P.carry_out[I.idx][row * CK_NS + c] = cr[c];
          }
          flow = cascade_step(flow, I.n, cr, P.ltg[I.idx], P.w[I.idx],
                              P.ecb[I.idx], P.act[I.idx], sh);
          break;
        }
        case CY_COMB: {
          const int RL = ((I.n + CK_C - 1) / CK_C) * CK_C;
          flow = comb_step(flow, P.ring[I.idx] + row * RL, RL, I.n, I.p[0],
                           t);
          break;
        }
        case CY_EW:
          flow = apply_ew(I.idx, I.p, flow, sh.redm);
          break;
        case CY_SCALE:
          flow = flow * I.p[0];
          break;
        case CY_SETREG:
          regs[I.idx][c] = flow;
          break;
        case CY_TAP:
          P.tap[I.idx][off] = flow;
          break;
      }
    }
  }
  for (int r = 0; r < P.n_regs; ++r) P.reg_out[r][row * CK_C + c] = regs[r][c];
}

extern "C" int cycle_kernel_abi(void) { return (int)sizeof(CyProgram); }

// Launch on `stream` (the caller's current PyTorch stream); returns the
// cudaGetLastError() code of the launch, 0 on success.
extern "C" int cycle_kernel_launch(const CyProgram* prog, int B, int T,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cycle_kernel<<<B, CK_C, 0, (cudaStream_t)stream>>>(*prog, T);
  return (int)cudaGetLastError();
}
