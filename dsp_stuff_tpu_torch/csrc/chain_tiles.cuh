// chain_tiles.cuh -- what the chain kernel (chain_kernel.cu) and its
// reverse (chain_reverse_kernel.cu) share: the tile geometry, the packed
// program's header and stage records (mirrored by ops/chain_kernel.py:
// HEADER, STAGE), the 3xTF32 mma.sync products and the tile loads.  Both
// walk a row in tiles of CK_M consecutive 128-sample blocks, a tile
// [CK_M, 128] f32 in shared memory with M-row m holding the tile's block
// m.

#pragma once

#include <stdint.h>

#include "stages.cuh"

#define CK_M 64             // M-rows of a tile: its blocks
#define CK_NT 256           // threads of a CTA
#define CK_NW (CK_NT / 32)  // warps
#define CK_MT (CK_M / 16)   // m-tiles of a tile
#define CK_P (CK_NW / CK_MT)  // warps sharing an m-tile, splitting its n-tiles
#define CK_NQ (CK_M / CK_NW)  // M-rows a warp holds in the elementwise pass
#define CK_LD 132           // row stride of a tile in shared memory
#define CK_CLD 12           // row stride of the carry buffers
#define CK_HP 136           // padded Toeplitz row: 8 zeros, h[0..127]

// stage kinds
#define CK_CASCADE 0
#define CK_SCALE 1
#define CK_EW 2
#define CK_TAP 3
#define CK_COMB 4
#define CK_MTAP 5

// The packed program's header and stage records, mirrored by
// ops/chain_kernel.py (HEADER, STAGE); each kernel's *_abi() lets its
// wrapper check the sizes.
typedef struct {
  int n_stages, n_casc, n_ring, n_tap;
  long long off_stage, off_casc, off_ring, off_tap;   // bytes from the base
  long long off_rec, pad_;   // the ew stages' record pointers (the chain
} CkHeader;                  // kernel's record build; the reverse's read)

typedef struct {
  int kind;     // CK_*
  int idx;      // cascade / ew op / tap / ring index
  int n;        // cascade: carry lanes N; comb: delay D; mtap: NH
  int rec;      // ew: its ordinal among the ew stages (its record)
  float p[4];   // scale factor, shaper params, comb decay or mtap mix
} CkStage;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, each part a TF32 value
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32; b0/b1 hold the hi parts, c0/c1 the lo parts of B
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1, float c0, float c1) {
  mma_tf32(d, al, __float_as_uint(b0), __float_as_uint(b1));
  mma_tf32(d, ah, __float_as_uint(c0), __float_as_uint(c1));
  mma_tf32(d, ah, __float_as_uint(b0), __float_as_uint(b1));
}

// The A fragment of rows m0 + gid (+8), columns k0 + tig (+4) of a
// row-major buffer with stride ld, split into TF32 hi and lo parts.
__device__ __forceinline__ void load_a(const float* base, int ld, int m0,
                                       int k0, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* p = base + (m0 + gid) * ld + k0 + tig;
  split_tf32(p[0], ah[0], al[0]);
  split_tf32(p[8 * ld], ah[1], al[1]);
  split_tf32(p[4], ah[2], al[2]);
  split_tf32(p[8 * ld + 4], ah[3], al[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

struct Tile {
  int row, K, T;               // the CTA's row of x, its blocks and samples
  int b0, KTv;                 // first block of the tile, blocks present
  __device__ bool valid(int m) const { return m < KTv; }
  __device__ long long off(int m) const {     // global offset of M-row m
    return (long long)row * T + (long long)(b0 + m) * CK_C;
  }
};

// Start the copy of x's tile at block b0 into F: 16 bytes a thread and
// chunk, zeros where the tile runs past the render.  Thread (warp w,
// lane l) copies the columns 4l..4l+3 of M-rows w, w + 8, ..., the chunks
// it later stores.
__device__ __forceinline__ void load_tile(float* F,
                                          const float* __restrict__ x, Tile t,
                                          int b0) {
  t.b0 = b0;
  t.KTv = min(CK_M, t.K - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < CK_M; m += CK_NW) {
    const bool ok = t.valid(m);
    const float* src = ok ? x + t.off(m) + 4 * lane : x;
    cp_async16(F + m * CK_LD + 4 * lane, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

