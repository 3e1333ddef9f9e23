// first_order_kernel.cu -- the first-order linear recurrence
//     y[t] = a[t] * y[t-1] + b[t],   y[-1] = y0
// over [R, T] rows, forward in time or (``reverse``) backward:
//     y[t] = a[t] * y[t+1] + b[t],   y[T] = y0.
// ``a`` is one scalar read from device memory (so a coefficient that lives
// on the card costs no host sync) or a per-sample [R, T] array.
//
// Replaces the TPU kernel dsp_stuff_tpu/ops/pallas_scan.py:first_order_pallas
// (its _kernel and _tap_matrices), which the JAX package runs for a traced
// scalar coefficient; the per-sample form is the JAX package's associative
// scan (ops/scan.py:_first_order_jit), which the envelope's backward runs.
// The reverse form is the adjoint of the forward one, so the same kernel
// runs the backward of ops/scan.py:FirstOrderAffine.  The plain PyTorch
// versions are ops/scan.py:_first_order_blocked (scalar a) and
// _first_order_scan (per-sample a); the wrapper is ops/first_order_kernel.py.
//
// Design.  Rows are cut into tiles of TILE = THREADS * SPAN samples; one
// block takes one (tile, row), so a single row fills the card too.  Each
// thread owns SPAN consecutive samples of its tile.
//   pass 1 (fo_tile_maps): every thread scans its span from a zero state,
//     which gives the affine map (P, E) of the span (P = the product of its
//     a, E = its value at the span's end); the block scans those maps and
//     writes the tile's map.
//   pass 2 (fo_carries): one thread per row walks the tile maps, seeded by
//     y0, and writes each tile's carry-in.
//   pass 3 (fo_apply): like pass 1, then each thread composes its
//     exclusive prefix map with the tile's carry-in, rescans its span from
//     that carry and writes y.
// A row of one tile skips passes 1 and 2.  Tiles are loaded into shared
// memory with neighbouring threads on neighbouring samples (coalesced, in
// either direction), padded by one word per SPAN so that the per-thread
// span walks are free of bank conflicts.
//
// What bounds it.  Memory: b (and a per-sample a) is read twice and y is
// written once, 12 bytes per sample with a scalar a; the arithmetic is two
// sequential SPAN-step walks per thread.  The TPU kernel's single pass
// (a Toeplitz product on the MXU with a scalar carry across its sequential
// grid) has no counterpart here: blocks run in no order, so the carry
// crosses tiles through pass 2.
//
// Arithmetic: the build passes -fmad=false, so a * y + b rounds twice, as
// in the plain version's sequential form.  a = 0 and a = 1 are ordinary
// maps; NaN propagates.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SPAN = 16;
constexpr int TILE = THREADS * SPAN;          // 4096 samples per block
constexpr int SMEM_N = TILE + TILE / SPAN;    // one pad word per span

__device__ __forceinline__ int pad(int j) { return j + j / SPAN; }

struct Map {                                  // y -> p * y + e
  float p, e;
};

// m1 first, then m2
__device__ __forceinline__ Map compose(Map m1, Map m2) {
  return {m2.p * m1.p, m2.p * m1.e + m2.e};
}

// Loads tile `tile` of row `row` (logical time s = tile * TILE + j, j the
// slot) into sb (and sa for a per-sample a).
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* dst, long long row_off,
                                          long long T, long long s0,
                                          int reverse) {
  for (int k = 0; k < SPAN; ++k) {
    const int j = k * THREADS + threadIdx.x;
    const long long s = s0 + j;
    if (s < T) dst[pad(j)] = src[row_off + (reverse ? T - 1 - s : s)];
  }
}

// This thread's span map from a zero state.
__device__ __forceinline__ Map span_map(const float* sb, const float* sa,
                                        float a_scalar, long long T,
                                        long long s0) {
  Map m = {1.0f, 0.0f};
  const int base = threadIdx.x * SPAN;
  for (int k = 0; k < SPAN; ++k) {
    const int j = base + k;
    if (s0 + j >= T) break;
    const float at = sa ? sa[pad(j)] : a_scalar;
    m.e = at * m.e + sb[pad(j)];
    m.p = m.p * at;
  }
  return m;
}

// Exclusive scan of the threads' maps across the block; *total gets the
// whole tile's map.  Every thread of the block must call it.
__device__ __forceinline__ Map block_exclusive_scan(Map m, Map* warp_maps,
                                                    Map* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map inc = m;
  for (int off = 1; off < 32; off <<= 1) {
    const float p = __shfl_up_sync(full, inc.p, off);
    const float e = __shfl_up_sync(full, inc.e, off);
    if (lane >= off) inc = compose({p, e}, inc);
  }
  if (lane == 31) warp_maps[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Map w = lane < NWARPS ? warp_maps[lane] : Map{1.0f, 0.0f};
    for (int off = 1; off < NWARPS; off <<= 1) {
      const float p = __shfl_up_sync(full, w.p, off);
      const float e = __shfl_up_sync(full, w.e, off);
      if (lane >= off) w = compose({p, e}, w);
    }
    if (lane < NWARPS) warp_maps[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  Map ex = {__shfl_up_sync(full, inc.p, 1), __shfl_up_sync(full, inc.e, 1)};
  if (lane == 0) ex = {1.0f, 0.0f};
  if (warp > 0) ex = compose(warp_maps[warp - 1], ex);
  *total = warp_maps[NWARPS - 1];
  return ex;
}

__global__ void __launch_bounds__(THREADS)
fo_tile_maps(const float* __restrict__ b, const float* __restrict__ a,
             int a_per_sample, int R, long long T, int reverse,
             float2* __restrict__ maps) {
  __shared__ float sb[SMEM_N];
  __shared__ float sa[SMEM_N];
  __shared__ Map warp_maps[NWARPS];
  const int ntiles = gridDim.x;
  const long long s0 = (long long)blockIdx.x * TILE;
  const float a_scalar = a_per_sample ? 0.0f : a[0];
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const long long off = (long long)row * T;
    load_tile(b, sb, off, T, s0, reverse);
    if (a_per_sample) load_tile(a, sa, off, T, s0, reverse);
    __syncthreads();
    const Map m = span_map(sb, a_per_sample ? sa : nullptr, a_scalar, T, s0);
    Map total;
    block_exclusive_scan(m, warp_maps, &total);
    if (threadIdx.x == 0)
      maps[(long long)row * ntiles + blockIdx.x] = make_float2(total.p,
                                                               total.e);
    __syncthreads();                    // smem is reused by the next row
  }
}

__global__ void fo_carries(const float2* __restrict__ maps,
                           const float* __restrict__ y0, int R, int ntiles,
                           float* __restrict__ carry) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float c = y0[row];
  const long long off = (long long)row * ntiles;
  for (int k = 0; k < ntiles; ++k) {
    carry[off + k] = c;
    const float2 m = maps[off + k];
    c = m.x * c + m.y;
  }
}

__global__ void __launch_bounds__(THREADS)
fo_apply(const float* __restrict__ b, const float* __restrict__ a,
         int a_per_sample, int R, long long T, int reverse,
         const float* __restrict__ carry, float* __restrict__ y) {
  __shared__ float sb[SMEM_N];
  __shared__ float sa[SMEM_N];
  __shared__ Map warp_maps[NWARPS];
  const int ntiles = gridDim.x;
  const long long s0 = (long long)blockIdx.x * TILE;
  const float a_scalar = a_per_sample ? 0.0f : a[0];
  for (int row = blockIdx.y; row < R; row += gridDim.y) {
    const long long off = (long long)row * T;
    load_tile(b, sb, off, T, s0, reverse);
    if (a_per_sample) load_tile(a, sa, off, T, s0, reverse);
    __syncthreads();
    const float* sap = a_per_sample ? sa : nullptr;
    const Map m = span_map(sb, sap, a_scalar, T, s0);
    Map total;
    const Map ex = block_exclusive_scan(m, warp_maps, &total);
    float c = ex.p * carry[(long long)row * ntiles + blockIdx.x] + ex.e;
    const int base = threadIdx.x * SPAN;
    for (int k = 0; k < SPAN; ++k) {
      const int j = base + k;
      if (s0 + j >= T) break;
      const float at = sap ? sap[pad(j)] : a_scalar;
      c = at * c + sb[pad(j)];
      sb[pad(j)] = c;                   // this thread's own slots only
    }
    __syncthreads();
    for (int k = 0; k < SPAN; ++k) {
      const int j = k * THREADS + threadIdx.x;
      const long long s = s0 + j;
      if (s < T) y[off + (reverse ? T - 1 - s : s)] = sb[pad(j)];
    }
    __syncthreads();                    // smem is reused by the next row
  }
}

}  // namespace

// Samples per tile: the wrapper sizes its scratch with it.
extern "C" int first_order_kernel_tile() { return TILE; }

// One solve on `stream`.  b, y [R, T] and (a_per_sample) a [R, T] are
// contiguous f32; otherwise a points at one f32.  y0 [R].  Scratch: maps
// [R, ntiles] float2 and carry [R, ntiles] f32, ntiles = ceil(T / TILE);
// both may be null when ntiles == 1.  Returns the first CUDA error code of
// the launches, 0 on success.
extern "C" int first_order_kernel_launch(const float* b, const float* a,
                                         int a_per_sample, const float* y0,
                                         float* y, float* maps, float* carry,
                                         int R, long long T, int reverse,
                                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (T + TILE - 1) / TILE;
  const dim3 grid((unsigned)ntiles, (unsigned)(R < 65535 ? R : 65535));
  const float* cin = y0;                // one tile: its carry-in is y0
  if (ntiles > 1) {
    fo_tile_maps<<<grid, THREADS, 0, st>>>(b, a, a_per_sample, R, T, reverse,
                                           (float2*)maps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fo_carries<<<(R + 127) / 128, 128, 0, st>>>((const float2*)maps, y0, R,
                                                (int)ntiles, carry);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    cin = carry;
  }
  fo_apply<<<grid, THREADS, 0, st>>>(b, a, a_per_sample, R, T, reverse, cin,
                                     y);
  return (int)cudaGetLastError();
}
