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
// What bounds it.  Memory: one read of b (and of a per-sample a) and one
// write of y, 8 bytes a sample with a scalar a, 12 with a per-sample one;
// the arithmetic is two SPAN-step walks a thread, far below the FP32 rate.
// So the design keeps enough bytes in flight, in coalesced 16-byte pieces,
// while tiles scan and wait for their carries.
//
// Design: one pass, with the carry chained from tile to tile, as the TPU
// kernel carries it in SMEM across its sequential grid.  Rows are cut into
// tiles of TILE = THREADS * SPAN samples.
//   1. Tickets.  A persistent CTA takes tiles by an atomic ticket, handed
//      out column-major (tile k of every row before tile k + 1 of any row),
//      and works through its tickets in the order it took them.  The
//      unfinished tile with the lowest ticket is always its CTA's current
//      tile and its predecessor (an earlier ticket) is finished, so the
//      grid never deadlocks; with R rows the tile waited on was issued R
//      tickets earlier.
//   2. Read once.  Each CTA keeps NSTAGE tiles in a ring in shared memory:
//      while it scans one tile the copies of the next NSTAGE - 1 are in
//      flight (cp.async, 16 bytes a thread, neighbouring threads on
//      neighbouring pieces, in either direction).  Pieces sit at swizzled
//      slots, so that both the copies and the span reads below are free of
//      bank conflicts.
//   3. Local scan.  Each thread walks its SPAN consecutive samples from a
//      zero state, giving the span's affine map (P = the product of its a,
//      E = its value at the span's end); a warp-shuffle block scan of those
//      maps gives each thread its exclusive prefix map and the tile's map
//      (P_k, E_k).
//   4. Chained carry.  Thread 0 waits for the inclusive carry of tile k - 1
//      of its row (its y at that tile's last sample; y0 for tile 0), then
//      publishes carry_k = P_k * carry_{k-1} + E_k: one 64-bit word {ready,
//      carry bits}, stored and read whole (see store_word).  Only
//      the carry crosses tiles (a per-sample a gives each tile its own P),
//      and every carry is composed from the same operands in the same
//      order, so the result is bitwise the same from launch to launch.
//   5. Write once.  Each thread rescans its span from its exclusive carry
//      (registers; no second read), puts y back into the tile's slots, and
//      the CTA writes the tile out in coalesced 16-byte pieces.
// The status words and the ticket counter are zeroed by one memset on the
// launch's stream.  A wait that outlasts WAIT_NS traps rather than hang.
//
// Alignment.  Row r starts 16 bytes aligned only when r * T % 4 == 0, so
// each row's tiles are laid on a virtual axis v = s + shift (s the sample
// in the row's direction of travel), shift in 0..3 chosen so that every v
// with v % 4 == 0 sits on a 16-byte boundary; the row's first tile is
// short by shift samples and a row may have one more tile.  The pieces
// that cross the row's ends are read and written a float at a time.  The
// wrapper passes b, a and y 16-byte aligned.
//
// Arithmetic: the build passes -fmad=false, so a * y + b rounds twice, as
// in the plain version's sequential form.  a = 0 and a = 1 are ordinary
// maps; NaN propagates (the ready flag is a word of its own).
//
// Build options: FO_THREADS, FO_SPAN and FO_NSTAGE set the tile and the
// ring; FO_NO_WAIT is a probe that skips the carry (wrong y) to time the
// streaming alone.  Tiles of 512 x 16 samples and a ring of two measured
// fastest at R = 128 and 512 rows of 480,000 (two CTAs an SM with a scalar
// a, one per sample); deeper rings, one CTA an SM, other tiles and claims
// of several tiles of a row were slower (tools/measure_torch_first_order.py
// --tiles --variants ..., PERF.md).

#include <cuda_runtime.h>

#ifndef FO_THREADS
#define FO_THREADS 512
#endif
#ifndef FO_SPAN
#define FO_SPAN 16
#endif
#ifndef FO_NSTAGE
#define FO_NSTAGE 2
#endif

namespace {

constexpr int THREADS = FO_THREADS;
constexpr int NWARPS = THREADS / 32;
constexpr int SPAN = FO_SPAN;
constexpr int VEC = SPAN / 4;                 // 16-byte pieces a span
constexpr int TILE = THREADS * SPAN;          // samples a tile
constexpr int PIECES = TILE / 4;              // 16-byte pieces a tile
constexpr int NSTAGE = FO_NSTAGE;             // tiles in a CTA's ring
static_assert(SPAN % 4 == 0, "a span is whole 16-byte pieces");
static_assert(THREADS % 32 == 0 && NWARPS <= 32, "one warp scans the warps");
static_assert(NSTAGE >= 2, "a ring of at least two tiles");
constexpr unsigned long long READY = 1ull << 32;
constexpr unsigned long long WAIT_NS = 10000000000ull;   // 10 s

struct Map {                                  // y -> p * y + e
  float p, e;
};

// m1 first, then m2
__device__ __forceinline__ Map compose(Map m1, Map m2) {
  return {m2.p * m1.p, m2.p * m1.e + m2.e};
}

// The carry word's accesses: single-copy atomic 64-bit accesses at GPU
// scope, so a reader sees 0 or the whole {ready, carry} word.  Nothing else
// passes between CTAs, so they need no release or acquire: a release store
// waits for the thread's earlier y stores, and measured 0.013 ms slower at
// R = 128 and 0.012 ms at R = 1 (PERF.md).
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The slot of piece c in a tile's buffer.  Thread i's span is pieces
// 4i..4i+3 (VEC = 4) and the copies move pieces c = tid + THREADS * j: in
// each quarter warp both land on eight different 16-byte bank groups.
__device__ __forceinline__ int slot(int c) { return c ^ ((c >> 3) & 3); }

// The inclusive carry that tile `word` publishes, once it is there.
__device__ __forceinline__ float wait_carry(const unsigned long long* word) {
  unsigned long long w = load_word(word);
  if (!(w & READY)) {
    const unsigned long long t0 = now_ns();
    while (!((w = load_word(word)) & READY))
      if (now_ns() - t0 > WAIT_NS) __trap();
  }
  return __uint_as_float((unsigned)w);
}

// Exclusive scan of the threads' maps across the block; *total gets the
// whole tile's map.  Every thread of the block must call it.
__device__ __forceinline__ Map block_exclusive_scan(Map m, Map* warp_maps,
                                                    Map* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map inc = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float p = __shfl_up_sync(full, inc.p, off);
    const float e = __shfl_up_sync(full, inc.e, off);
    if (lane >= off) inc = compose({p, e}, inc);
  }
  if (lane == 31) warp_maps[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Map w = lane < NWARPS ? warp_maps[lane] : Map{1.0f, 0.0f};
#pragma unroll
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

// Where a ticket's tile lies: row, tile k, the row's start in memory and
// its shift; valid v of the row are [shift, vend).
struct Tile {
  int row, k, shift;
  long long rowbase, vtile, vend;
};

template <bool REVERSE>
__device__ __forceinline__ Tile tile_of(unsigned t, int R, long long T) {
  Tile w;
  w.row = (int)(t % (unsigned)R);
  w.k = (int)(t / (unsigned)R);
  w.rowbase = (long long)w.row * T;
  w.shift = REVERSE ? (int)((4 - (w.rowbase + T) % 4) % 4)
                    : (int)(w.rowbase % 4);
  w.vend = T + w.shift;
  w.vtile = (long long)w.k * TILE;
  return w;
}

// The memory index of the piece whose first virtual sample is v: its
// lowest address (in reverse the piece holds v + 3 .. v).
template <bool REVERSE>
__device__ __forceinline__ long long piece_index(const Tile& w, long long T,
                                                 long long v) {
  return REVERSE ? w.rowbase + T + w.shift - v - 4 : w.rowbase + v - w.shift;
}

// This thread's pieces of tile w into buf (16-byte copies in flight; the
// pieces that cross the row's ends are read a float at a time).
template <bool REVERSE>
__device__ __forceinline__ void issue_piece_loads(
    const float* __restrict__ src, float4* buf, const Tile& w, long long T) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = threadIdx.x + j * THREADS;
    const long long v = w.vtile + 4ll * c;
    if (v >= w.shift && v + 4 <= w.vend) {
      cp_async16(buf + slot(c), src + piece_index<REVERSE>(w, T, v));
    } else if (v + 4 > w.shift && v < w.vend) {
      float* d = reinterpret_cast<float*>(buf + slot(c));
      const long long m = piece_index<REVERSE>(w, T, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long pv = REVERSE ? v + 3 - u : v + u;
        d[u] = (pv >= w.shift && pv < w.vend) ? src[m + u] : 0.0f;
      }
    }
  }
}

template <bool REVERSE>
__device__ __forceinline__ void store_pieces(float* __restrict__ dst,
                                             const float4* buf, const Tile& w,
                                             long long T) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = threadIdx.x + j * THREADS;
    const long long v = w.vtile + 4ll * c;
    const long long m = piece_index<REVERSE>(w, T, v);
    if (v >= w.shift && v + 4 <= w.vend) {
      __stcs(reinterpret_cast<float4*>(dst + m), buf[slot(c)]);
    } else if (v + 4 > w.shift && v < w.vend) {
      const float* s = reinterpret_cast<const float*>(buf + slot(c));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long pv = REVERSE ? v + 3 - u : v + u;
        if (pv >= w.shift && pv < w.vend) dst[m + u] = s[u];
      }
    }
  }
}

// This thread's span (pieces VEC i .. VEC i + VEC - 1) from buf, in
// virtual order.
template <bool REVERSE>
__device__ __forceinline__ void read_span(const float4* buf,
                                          float (&v)[SPAN]) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const float4 p = buf[slot(threadIdx.x * VEC + q)];
    v[4 * q] = REVERSE ? p.w : p.x;
    v[4 * q + 1] = REVERSE ? p.z : p.y;
    v[4 * q + 2] = REVERSE ? p.y : p.z;
    v[4 * q + 3] = REVERSE ? p.x : p.w;
  }
}

template <bool REVERSE>
__device__ __forceinline__ void write_span(float4* buf,
                                           const float (&v)[SPAN]) {
#pragma unroll
  for (int q = 0; q < VEC; ++q)
    buf[slot(threadIdx.x * VEC + q)] =
        REVERSE ? make_float4(v[4 * q + 3], v[4 * q + 2], v[4 * q + 1],
                              v[4 * q])
                : make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]);
}

// Persistent CTAs.  status: [R, ntiles] words, then the ticket counter;
// all zero at launch.  Dynamic shared memory: NSTAGE tile buffers of b
// (and, per sample, NSTAGE of a after them).
template <bool PER_SAMPLE, bool REVERSE>
__global__ void __launch_bounds__(THREADS)
fo_chained(const float* __restrict__ b, const float* __restrict__ a,
           const float* __restrict__ y0, float* __restrict__ y,
           unsigned long long* __restrict__ status, int R, long long T,
           int ntiles) {
  extern __shared__ float4 ring[];
  __shared__ Map warp_maps[NWARPS];
  __shared__ unsigned s_ticket[NSTAGE];
  __shared__ float s_carry;
  const unsigned total = (unsigned)R * (unsigned)ntiles;
  unsigned* counter =
      reinterpret_cast<unsigned*>(status + (long long)R * ntiles);
  float4* ring_a = ring + NSTAGE * PIECES;
  const float a_s = PER_SAMPLE ? 0.0f : __ldg(a);

  auto issue = [&](int stage) {
    const unsigned t = s_ticket[stage];
    if (t >= total) return;
    const Tile w = tile_of<REVERSE>(t, R, T);
    if (w.vtile >= w.vend) return;            // the row has fewer tiles
    issue_piece_loads<REVERSE>(b, ring + stage * PIECES, w, T);
    if constexpr (PER_SAMPLE)
      issue_piece_loads<REVERSE>(a, ring_a + stage * PIECES, w, T);
  };

  if (threadIdx.x == 0)
    for (int s = 0; s < NSTAGE; ++s) s_ticket[s] = atomicAdd(counter, 1u);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  for (int i = 0;; ++i) {
    const int st = i % NSTAGE;
    const unsigned t = s_ticket[st];
    if (t >= total) break;                    // tickets only grow
    unsigned next = 0;                        // the ticket of tile i + NSTAGE
    if (threadIdx.x == 0) next = atomicAdd(counter, 1u);
    issue((i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();              // tile i's own copies are in
    __syncthreads();                          // ... and everyone's

    const Tile w = tile_of<REVERSE>(t, R, T);
    if (w.vtile < w.vend) {
      float4* buf = ring + st * PIECES;
      const long long v0 = w.vtile + (long long)threadIdx.x * SPAN;
      const int lo = v0 < w.shift ? (int)(w.shift - v0) : 0;
      const long long left = w.vend - v0;
      const int hi = left < SPAN ? (int)(left > 0 ? left : 0) : SPAN;
      const bool full = lo == 0 && hi == SPAN;
      float bv[SPAN];
      float av[SPAN];                         // per-sample a only
      read_span<REVERSE>(buf, bv);
      if constexpr (PER_SAMPLE) read_span<REVERSE>(ring_a + st * PIECES, av);

      // the span's map from a zero state
      Map m = {1.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < SPAN; ++j) {
        if (full || (j >= lo && j < hi)) {
          const float at = PER_SAMPLE ? av[j] : a_s;
          m.e = at * m.e + bv[j];
          m.p = m.p * at;
        }
      }
      Map tmap;
      const Map ex = block_exclusive_scan(m, warp_maps, &tmap);

      if (threadIdx.x == 0) {
        unsigned long long* words = status + (long long)w.row * ntiles;
#ifdef FO_NO_WAIT
        const float cin = y0[w.row];
#else
        const float cin = w.k == 0 ? y0[w.row] : wait_carry(words + w.k - 1);
#endif
        if (w.vtile + TILE < w.vend)          // a tile follows
          store_word(words + w.k,
                        READY | __float_as_uint(tmap.p * cin + tmap.e));
        s_carry = cin;
      }
      __syncthreads();

      float c = ex.p * s_carry + ex.e;
#pragma unroll
      for (int j = 0; j < SPAN; ++j) {
        if (full || (j >= lo && j < hi)) {
          const float at = PER_SAMPLE ? av[j] : a_s;
          c = at * c + bv[j];
          bv[j] = c;
        }
      }
      write_span<REVERSE>(buf, bv);
      __syncthreads();
      store_pieces<REVERSE>(y, buf, w, T);
    }
    if (threadIdx.x == 0) s_ticket[st] = next;
    __syncthreads();                          // the buffer and slot are free
  }
  cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;

// The resident CTAs of fo_chained<PER_SAMPLE, REVERSE> on `device` (its
// shared memory set up on first use; later calls read the cache).
template <bool PER_SAMPLE, bool REVERSE>
cudaError_t resident_ctas(int device, int smem, long long* ctas) {
  static long long cache[MAX_DEVICES];
  if (device >= 0 && device < MAX_DEVICES && cache[device] > 0) {
    *ctas = cache[device];
    return cudaSuccess;
  }
  auto kernel = fo_chained<PER_SAMPLE, REVERSE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, n_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *ctas = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  if (device >= 0 && device < MAX_DEVICES) cache[device] = *ctas;
  return cudaSuccess;
}

template <bool PER_SAMPLE, bool REVERSE>
cudaError_t launch(const float* b, const float* a, const float* y0, float* y,
                   unsigned long long* status, int R, long long T, int ntiles,
                   int device, cudaStream_t st) {
  const int smem = NSTAGE * (PER_SAMPLE ? 2 : 1) * TILE * (int)sizeof(float);
  long long grid = 0;
  const cudaError_t e =
      resident_ctas<PER_SAMPLE, REVERSE>(device, smem, &grid);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)R * ntiles;
  if (grid > tiles) grid = tiles;
  fo_chained<PER_SAMPLE, REVERSE><<<(unsigned)grid, THREADS, smem, st>>>(
      b, a, y0, y, status, R, T, ntiles);
  return cudaGetLastError();
}

}  // namespace

// Samples a tile: the wrapper sizes the scratch with it.
extern "C" int first_order_kernel_tile() { return TILE; }

// One solve on `stream`: a memset of the scratch and one grid launch.
// b, y [R, T] and (a_per_sample) a [R, T] are contiguous f32 with 16-byte
// aligned starts; otherwise a points at one f32.  y0 [R].  scratch holds
// R * ntiles + 1 64-bit words, ntiles = ceil((T + (T % 4 ? 3 : 0)) / TILE).
// Returns the first CUDA error code, 0 on success.
extern "C" int first_order_kernel_launch(const float* b, const float* a,
                                         int a_per_sample, const float* y0,
                                         float* y, void* scratch, int R,
                                         long long T, int ntiles, int reverse,
                                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long need = (T + (T % 4 ? 3 : 0) + TILE - 1) / TILE;
  const long long tiles = (long long)R * ntiles;
  if (R < 1 || T < 1 || ntiles < need || tiles >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, st);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* status = (unsigned long long*)scratch;
  if (a_per_sample)
    e = reverse ? launch<true, true>(b, a, y0, y, status, R, T, ntiles,
                                     device, st)
                : launch<true, false>(b, a, y0, y, status, R, T, ntiles,
                                      device, st);
  else
    e = reverse ? launch<false, true>(b, a, y0, y, status, R, T, ntiles,
                                      device, st)
                : launch<false, false>(b, a, y0, y, status, R, T, ntiles,
                                       device, st);
  return (int)e;
}
