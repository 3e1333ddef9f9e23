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
// Registers live in dynamic shared memory, [n_regs][128]; thread c reads
// and writes only column c of them, so they need no barrier of their
// own.  A join reads a register before that block's setreg and so sees
// the previous block's value: the reference's one-block feedback latency.
// The cascade's cross-column product reads the flow through shared memory
// and the comb reads other columns through its ring; both carry their own
// barriers (stages.cuh).
//
// Raw outputs, in the TPU kernel's layout: per cascade the carry entering
// the last block (padded to 8) and that block's input; per comb the ring,
// slot s = block b mod NR; the final registers.  cycle_segment.rebuild
// turns them into node states.
//
// The program is packed by the wrapper into one array in device memory
// (header, instructions, join terms, pointer tables), sized from the
// program; each CTA copies it into dynamic shared memory beside the
// registers and the cascade carries, so no program size is fixed here.
//
// What bounds it.  Each row's sequential latency: per block a cascade's
// triangular product and barriers, the comb's ring round trip, and the
// instruction dispatch.  With B = 128 rows only 128 CTAs run, under one
// per SM, and the signal I/O (one read per feed, one write per tap) is
// small next to that.  Several rows per CTA would fill the card; that is
// a later PR's work.

#include "stages.cuh"

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

// The packed program, mirrored by ops/cycle_kernel.py (HEADER, INS,
// CASC); cycle_kernel_abi() lets the wrapper check the sizes.
typedef struct {
  int n_ins, n_regs, n_casc, n_comb;
  long long off_ins, off_terms, off_ext, off_tap;   // bytes from the base
  long long off_reg0, off_reg_out, off_casc, off_ring;
} CyHeader;

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
  const float* ltg;    // [128, 128]
  const float* w;      // [128, 8]
  const float* ecb;    // [8, 128]
  const float* act;    // [8, 8]
  const float* s0;     // [B, 8]
  float* carry_out;    // [B, 8] carry entering block K-1
  float* xlast_out;    // [B, 128] input of block K-1
  const void* pad_;
} CyCasc;

// The program's sections, in shared memory.
struct CyProg {
  const CyIns* ins;
  const int* terms;
  const float* const* ext;     // [B, T] each
  float* const* tap;           // [B, T] each
  const float* const* reg0;    // [B, 128] each
  float* const* reg_out;       // [B, 128] each
  const CyCasc* casc;
  float* const* ring;          // [B, ceil(D/128)*128] each
};

// An instruction record in three 16-byte loads issued together, rather
// than a load for each field on the dispatch's dependent path.
__device__ __forceinline__ CyIns load_ins(const CyIns* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 a = q[0], b = q[1];
  const float4 f = reinterpret_cast<const float4*>(q)[2];
  CyIns I;
  I.op = a.x;
  I.idx = a.y;
  I.n = a.z;
  I.ta = a.w;
  I.na = b.x;
  I.tb = b.y;
  I.nb = b.z;
  I.pad_ = b.w;
  I.p[0] = f.x;
  I.p[1] = f.y;
  I.p[2] = f.z;
  I.p[3] = f.w;
  return I;
}

__device__ __forceinline__ float term_sum(const CyProg& P, int t0, int n,
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

__device__ __forceinline__ float join_val(const CyProg& P, int t0, int n,
                                          float scale,
                                          const float (*regs)[CK_C],
                                          long long off, int c) {
  const float acc = term_sum(P, t0, n, regs, off, c);
  return scale != 1.0f ? acc * scale : acc;
}

__global__ void __launch_bounds__(CK_C)
cycle_kernel(const char* __restrict__ prog, int prog_bytes, int T) {
  __shared__ StageScratch sh;
  extern __shared__ int4 dyn4[];
  char* ps = reinterpret_cast<char*>(dyn4);
  const int c = threadIdx.x;
  for (int i = c; i < prog_bytes / 16; i += CK_C)
    dyn4[i] = reinterpret_cast<const int4*>(prog)[i];
  __syncthreads();
  const CyHeader& H = *reinterpret_cast<const CyHeader*>(ps);
  CyProg P;
  P.ins = reinterpret_cast<const CyIns*>(ps + H.off_ins);
  P.terms = reinterpret_cast<const int*>(ps + H.off_terms);
  P.ext = reinterpret_cast<const float* const*>(ps + H.off_ext);
  P.tap = reinterpret_cast<float* const*>(ps + H.off_tap);
  P.reg0 = reinterpret_cast<const float* const*>(ps + H.off_reg0);
  P.reg_out = reinterpret_cast<float* const*>(ps + H.off_reg_out);
  P.casc = reinterpret_cast<const CyCasc*>(ps + H.off_casc);
  P.ring = reinterpret_cast<float* const*>(ps + H.off_ring);
  const int n_ins = H.n_ins, n_regs = H.n_regs;
  float (*regs)[CK_C] = reinterpret_cast<float (*)[CK_C]>(ps + prog_bytes);
  float (*carry)[CK_NS] = reinterpret_cast<float (*)[CK_NS]>(
      ps + prog_bytes + n_regs * CK_C * (int)sizeof(float));
  const long long row = blockIdx.x;
  const int K = T / CK_C;
  const long long base = row * (long long)T;

  for (int r = 0; r < n_regs; ++r) regs[r][c] = P.reg0[r][row * CK_C + c];
  if (c < CK_NS) {
    for (int k = 0; k < H.n_casc; ++k)
      carry[k][c] = P.casc[k].s0[row * CK_NS + c];
  }
  __syncthreads();

  for (int b = 0; b < K; ++b) {
    const long long t = (long long)b * CK_C + c;   // time within the render
    const long long off = base + t;
    float flow = 0.0f;
    for (int i = 0; i < n_ins; ++i) {
      const CyIns I = load_ins(P.ins + i);
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
          const CyCasc& Q = P.casc[I.idx];
          float* cr = carry[I.idx];
          if (b == K - 1) {
            Q.xlast_out[row * CK_C + c] = flow;
            if (c < CK_NS) Q.carry_out[row * CK_NS + c] = cr[c];
          }
          flow = cascade_step(flow, I.n, cr, Q.ltg, Q.w, Q.ecb, Q.act, sh);
          break;
        }
        case CY_COMB: {
          const int RL = ((I.n + CK_C - 1) / CK_C) * CK_C;
          flow = comb_step(flow, P.ring[I.idx] + row * RL, RL, I.n, I.p[0],
                           t);
          break;
        }
        case CY_EW: {
          float v[1] = {flow};
          apply_ew<1>(I.idx, I.p, v, CtaMax{sh.redm});
          flow = v[0];
          break;
        }
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
  for (int r = 0; r < n_regs; ++r) P.reg_out[r][row * CK_C + c] = regs[r][c];
}

// Struct sizes for the wrapper's layout check: header, instruction and
// cascade records, one byte each.
extern "C" int cycle_kernel_abi(void) {
  return (int)sizeof(CyHeader) | (int)sizeof(CyIns) << 8
      | (int)sizeof(CyCasc) << 16;
}

// Launch B CTAs on `stream` (the caller's current PyTorch stream) over the
// packed program `prog` of prog_bytes (a multiple of 16) in device memory;
// returns the cudaGetLastError() code of the launch, 0 on success, or
// cudaErrorInvalidValue when the program, registers and carries exceed
// the card's shared memory per block.
extern "C" int cycle_kernel_launch(const void* prog, int prog_bytes,
                                   int n_regs, int n_casc, int B, int T,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (prog_bytes % 16) return (int)cudaErrorInvalidValue;
  const int smem = prog_bytes + (n_regs * CK_C + n_casc * CK_NS)
      * (int)sizeof(float);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  if (smem + (int)sizeof(StageScratch) > optin)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(cycle_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cycle_kernel<<<B, CK_C, smem, (cudaStream_t)stream>>>(
      (const char*)prog, prog_bytes, T);
  return (int)cudaGetLastError();
}
