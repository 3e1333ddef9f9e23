// envelope_kernel.cu -- the peak envelope follower
//     env' = d + g * (env - d),  d = |x|,  g = attack if env < d else release
// over [B, T] rows, as P chunks of `chunk` samples per row.
//
// Replaces two TPU kernels of the JAX package:
//   dsp_stuff_tpu/ops/pallas_envelope.py:peak_envelope_pallas_chunked
//     (the two-pass chunk-parallel follower, _chunk_pass), and
//   dsp_stuff_tpu/ops/pallas_envelope.py:peak_envelope_pallas
//     (the strictly sequential follower): the same code with one chunk of
//     length T and one pass.
// The plain PyTorch versions are ops/envelope.py:_chunked_batched and
// _seq_scan; the wrapper is ops/envelope_kernel.py.
//
// Design.  One thread per (row, chunk) runs the recurrence over its chunk
// from a start value: pass 1 from zero starts (chunk 0 from env0) keeps
// only each chunk's final value; pass 2 reruns every chunk from its
// predecessor's pass-1 final and writes the envelope.  The recurrence
// contracts the carry by max(attack, release) < 1 per sample, so a chunk
// of 32768 samples forgets its start to far below f32 rounding.
//
// What bounds it.  The chain of dependent updates: `chunk` steps of a
// subtract, a compare, a multiply and an add per thread and pass.  The
// layout is the signal's own [B, T] row-major: neighbouring threads read
// addresses a chunk (or a row) apart, so a warp's loads are not
// coalesced, but each thread walks its own addresses in order and the
// cache lines it touches serve its next 31 steps.  With B = 128 rows and
// P = 15 chunks only 1,920 threads run, a small share of the card; the
// loads do not depend on the carry, so the compiler can issue them ahead.
//
// Arithmetic: the build passes -fmad=false, so g * (env - d) + d rounds
// twice, like the eager PyTorch version.  NaN compares false and takes the
// release gain, as torch.where does.

#include <cuda_runtime.h>

__global__ void envelope_pass(const float* __restrict__ x, int B, long long T,
                              int chunk, int P, float atk, float rel,
                              const float* __restrict__ starts,
                              float* __restrict__ finals,
                              float* __restrict__ y) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)B * P) return;
  const long long row = id / P;
  const int p = (int)(id % P);
  const long long t0 = (long long)p * chunk;
  long long t1 = t0 + chunk;
  if (t1 > T) t1 = T;
  const float* __restrict__ xr = x + row * T;
  float env = starts[id];
  for (long long t = t0; t < t1; ++t) {
    const float d = fabsf(xr[t]);
    const float g = env < d ? atk : rel;
    env = d + g * (env - d);
    if (y) y[row * T + t] = env;
  }
  finals[id] = env;                    // the envelope at the chunk's end
}

// One pass over all (row, chunk) pairs on `stream`; y may be null (pass 1).
// Returns the cudaGetLastError() code of the launch, 0 on success.
extern "C" int envelope_kernel_launch(const float* x, int B, long long T,
                                      int chunk, int P, float atk, float rel,
                                      const float* starts, float* finals,
                                      float* y, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * P;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  envelope_pass<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, B, T, chunk, P, atk, rel, starts, finals, y);
  return (int)cudaGetLastError();
}
