// envelope_kernel.cu -- the peak envelope follower
//     env' = d + g * (env - d),  d = |x|,  g = attack if env < d else release
// over [B, T] rows, as P chunks of `chunk` samples per row, in one launch.
//
// Replaces two TPU kernels of the JAX package:
//   dsp_stuff_tpu/ops/pallas_envelope.py:peak_envelope_pallas_chunked
//     (the two-pass chunk-parallel follower, _chunk_pass), and
//   dsp_stuff_tpu/ops/pallas_envelope.py:peak_envelope_pallas
//     (the strictly sequential follower): the same code with one chunk of
//     length T.
// The plain PyTorch versions are ops/envelope.py:_chunked_batched and
// _seq_scan; the wrapper is ops/envelope_kernel.py.
//
// The schedule.  One lane per (row, chunk p).  The lane of chunk p >= 1
// first runs chunk p - 1 from a zero start (from env0 when p - 1 = 0) and
// keeps only its final, which is the plain version's pass 1; it then runs
// chunk p from that final and writes the envelope, which is its pass 2.
// Chunk 0 runs once, from env0.  These are the very operations, in the
// same order, of the two passes of _chunked_batched, so the results are
// bitwise the same, in one launch and with no finals between launches.
// With one chunk (the sequential follower) there is no first pass.  A
// lane's samples are thus one contiguous window of its row, [(p-1)*chunk,
// (p+1)*chunk) clipped to [0, T): 2 * chunk dependent steps.  The recurrence
// contracts the carry by max(attack, release) < 1 per sample, so a chunk
// of 32768 samples forgets its zero start to far below f32 rounding.
//
// What bounds it.  The chain of dependent updates: a subtract, a compare
// and select, a multiply and an add, each rounded (-fmad=false, explicit
// __fsub_rn/__fmul_rn/__fadd_rn), about 15-20 cycles a step, 2 x 32768
// steps on the main path.  The bytes (x read twice, y written once) are
// far below that.  So the design keeps the chain alone on a lane's path:
//
// * A CTA is two warps for 32 (row, chunk) windows: 128 rows x 15 chunks
//   make 60 CTAs on 60 SMs.  Warp 0 runs the 32 chains, a window a lane;
//   warp 1 (on another scheduler) does all the copying, so the chain is
//   alone on warp 0's path.
// * x reaches a lane through shared memory: tiles of TT = 64 steps of the
//   32 windows, [32][LD = 68] floats, NB = 4 tiles in a ring.  Warp 1
//   fills a tile two tiles ahead of the one it announces, and after warp 0
//   has written the envelope into the tile in place of x, stores it and
//   refills the buffer.  Named barriers pair them per buffer: "full" (warp
//   1 arrives, warp 0 waits) and "done" (the other way round).
// * The copies: when every window starts on a 16-byte boundary (x and y
//   aligned, T and the chunk multiples of 4: the main path) a half warp
//   moves a window's 64 steps as sixteen 16-byte cp.async pieces, so a
//   tile is 16 copy instructions and 16 stores of the warp.  Otherwise
//   (any row start, any T) each lane moves one float a step, 64 a tile.
//   Positions outside [0, T) load zeros and are not stored.
// * LD = 68 floats keeps both conflict-free: a quarter warp's 16-byte
//   accesses cover the 32 banks once, whether the lanes walk one window
//   (the copies) or eight (the chain's reads, 8 steps a lane as two
//   16-byte loads).

// The two gains, (attack, release), are read from device memory, once by
// each follower lane, as the Pallas kernels read theirs from a (1, 2) SMEM
// array: a stream's slider moves them with a copy into that memory, and a
// captured CUDA graph replays the launch unchanged.
//
// NaN compares false and takes the release gain, as torch.where does.

#include <cuda_runtime.h>
#include <stdint.h>

#define EV_TT 64                // steps of a tile
#define EV_LD (EV_TT + 4)       // row stride of a tile in shared memory
#define EV_NB 4                 // tiles in the ring

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  // no "memory" clobber: the destination is read only after a
  // cp.async.wait_group (which has one), and the clobber would pin every
  // shared-memory access around each copy
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ float step(float env, float x, float atk,
                                      float rel) {
  const float d = fabsf(x);
  const float g = env < d ? atk : rel;
  return __fadd_rn(d, __fmul_rn(g, __fsub_rn(env, d)));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" :: "r"(id) : "memory");
}

// named barriers (0 is __syncthreads'): tile in buffer i is in / is done
#define EV_FULL(i) (1 + (i))
#define EV_DONE(i) (1 + EV_NB + (i))

// A window's place: its offset in x and y, its steps inside [0, T).
struct __align__(16) EvWin {
  long long base;
  int lo, hi;
};

__global__ void __launch_bounds__(64)
envelope_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ env0,
                const float* __restrict__ gains, int B, long long T,
                int chunk, int P, int vec) {
  extern __shared__ float4 ring4[];     // [EV_NB][32][EV_LD] floats
  __shared__ EvWin win[32];
  float* ring = reinterpret_cast<float*>(ring4);
  const int lane = threadIdx.x & 31;
  const bool copier = threadIdx.x >= 32;
  const long long id = (long long)blockIdx.x * 32 + lane;
  const bool live = id < (long long)B * P;
  const int pre = P > 1 ? chunk : 0;    // steps of the first pass
  const long long len = P > 1 ? chunk : T;
  const long long S = pre + len;        // steps of every window
  const long long row = live ? id / P : 0;
  const int p = live ? (int)(id % P) : 0;
  const long long w0 = (long long)p * chunk - pre;
  const int n_tiles = (int)((S + EV_TT - 1) / EV_TT);
  auto tile = [&](int k) { return ring + (k % EV_NB) * 32 * EV_LD; };

  if (copier) {
    win[lane] = EvWin{row * T + w0, live ? (int)(w0 < 0 ? -w0 : 0) : 0,
                      live ? (int)(T - w0 < S ? T - w0 : S) : 0};
    __syncwarp();
    // 16-byte pieces: window 2t + lane / 16, steps 4 (lane % 16) + 0..3;
    // single floats: window t / 2, step lane + 32 (t % 2)
    auto load = [&](int k) {
      float* b = tile(k);
      if (vec) {
#pragma unroll 4
        for (int t = 0; t < EV_TT / 4; ++t) {
          const int j = 2 * t + (lane >> 4), e = 4 * (lane & 15);
          const EvWin w = win[j];
          const int s = k * EV_TT + e;
          const bool ok = s >= w.lo && s < w.hi;
          cp_async16(b + j * EV_LD + e, x + (ok ? w.base + s : 0),
                     ok ? 16 : 0);
        }
      } else {
#pragma unroll 8
        for (int t = 0; t < EV_TT; ++t) {
          const int j = t >> 1, e = lane + 32 * (t & 1);
          const EvWin w = win[j];
          const int s = k * EV_TT + e;
          const bool ok = s >= w.lo && s < w.hi;
          cp_async4(b + j * EV_LD + e, x + (ok ? w.base + s : 0),
                    ok ? 4 : 0);
        }
      }
    };
    auto store = [&](int k) {
      const float* b = tile(k);
      if (vec) {
#pragma unroll 4
        for (int t = 0; t < EV_TT / 4; ++t) {
          const int j = 2 * t + (lane >> 4), e = 4 * (lane & 15);
          const EvWin w = win[j];
          const int s = k * EV_TT + e;
          const float4 v = *reinterpret_cast<const float4*>(b + j * EV_LD
                                                            + e);
          if (s >= pre && s < w.hi)
            *reinterpret_cast<float4*>(y + w.base + s) = v;
        }
      } else {
#pragma unroll 8
        for (int t = 0; t < EV_TT; ++t) {
          const int j = t >> 1, e = lane + 32 * (t & 1);
          const EvWin w = win[j];
          const int s = k * EV_TT + e;
          const float v = b[j * EV_LD + e];
          if (s >= pre && s < w.hi) y[w.base + s] = v;
        }
      }
    };
    // tile k in, two tiles behind the copies in flight; a buffer is
    // refilled once its envelope is out
    for (int k = 0; k < n_tiles + 2; ++k) {
      if (k < n_tiles) {
        if (k >= EV_NB) {
          bar_sync(EV_DONE(k % EV_NB));
          store(k - EV_NB);
        }
        load(k);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (k >= 2) {
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
        __threadfence_block();
        bar_arrive(EV_FULL((k - 2) % EV_NB));
      }
    }
    for (int k = n_tiles > EV_NB ? n_tiles - EV_NB : 0; k < n_tiles; ++k) {
      bar_sync(EV_DONE(k % EV_NB));
      store(k);
    }
    return;
  }

  // the chain: lane `lane` runs window `lane`, eight steps' x at once
  const float atk = gains[0], rel = gains[1];
  const float e0 = live ? env0[row] : 0.0f;
  float env = pre == 0 ? e0 : (p == 1 ? e0 : 0.0f);
  for (int k = 0; k < n_tiles; ++k) {
    bar_sync(EV_FULL(k % EV_NB));
    float* cur = tile(k) + lane * EV_LD;
    const int rs = pre - k * EV_TT;     // the step where chunk 0 starts
    for (int g = 0; g < EV_TT; g += 8) {
      const float4 q0 = *reinterpret_cast<const float4*>(cur + g);
      const float4 q1 = *reinterpret_cast<const float4*>(cur + g + 4);
      float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      if (rs >= g && rs < g + 8) {      // this group holds it
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (p == 0 && u == rs - g) env = e0;
          env = step(env, v[u], atk, rel);
          v[u] = env;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          env = step(env, v[u], atk, rel);
          v[u] = env;
        }
      }
      *reinterpret_cast<float4*>(cur + g) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      *reinterpret_cast<float4*>(cur + g + 4) = make_float4(v[4], v[5], v[6],
                                                            v[7]);
    }
    __threadfence_block();              // the envelope is in the tile
    bar_arrive(EV_DONE(k % EV_NB));
  }
}

static const int SMEM_BYTES = EV_NB * 32 * EV_LD * (int)sizeof(float);

// The envelope of x [B, T] into y [B, T] on `stream`, from env0 [B] with
// gains [2] = (attack, release) in device memory: P chunks of `chunk`
// samples a row (P = 1: one chunk of T, the sequential follower).  The
// 16-byte copies are taken when every window's start is 16-byte aligned.
// Returns the cudaGetLastError() code of the launch, 0 on success.
extern "C" int envelope_kernel_launch(const float* x, float* y,
                                      const float* env0, const float* gains,
                                      int B, long long T, int chunk, int P,
                                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B < 1 || T < 1 || P < 1 || (P > 1 && (long long)chunk * (P - 1) >= T)
      || (P == 1 && T > (1LL << 30)) || chunk > (1 << 29))
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(envelope_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0
      && T % 4 == 0 && (P == 1 || chunk % 4 == 0);
  const long long n = (long long)B * P;
  envelope_kernel<<<(unsigned)((n + 31) / 32), 64, SMEM_BYTES,
                    (cudaStream_t)stream>>>(x, y, env0, gains, B, T, chunk,
                                            P, vec);
  return (int)cudaGetLastError();
}
