// Latencies that bound a chain of dependent field operations on one
// thread: a Montgomery product, a modular sum (csrc/fp381.cuh) and a
// block's barrier. Not part of the package: scripts/scan_red_probe.py
// builds it with nvcc for sm_90a and times each chain with CUDA events,
// to set scan-red's and scan-horner's latency floors (their dependent
// product layers times one product's latency) beside their times.
#include "fp381.cuh"

namespace {

// mode 0: x <- x y, n times; mode 1: x <- x + y, n times; one thread.
__global__ void field_chain(int mode, int n, const unsigned* seed, unsigned* out) {
  f381::Fp x, y;
#pragma unroll
  for (int k = 0; k < f381::NW; ++k) {
    x.w[k] = seed[k];
    y.w[k] = seed[f381::NW + k];
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (mode == 0) f381::mont_mul(x, y, x);
    else f381::add(x, y, x);
  }
#pragma unroll
  for (int k = 0; k < f381::NW; ++k) out[k] = x.w[k];
}

// n barriers of one block, each after a shared-memory store that the next
// step reads (a phase of the team programs with no work in it).
__global__ void barrier_chain(int n, unsigned* out) {
  __shared__ unsigned s[256];
  unsigned v = threadIdx.x;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    s[threadIdx.x] = v;
    __syncthreads();
    v += s[(threadIdx.x + 1) % blockDim.x];
  }
  out[threadIdx.x] = v;
}

}  // namespace

// mode 0 or 1: field_chain on one thread (seed: x then y, canonical words;
// out 12 words); mode 2: barrier_chain on a block of `threads` (at most
// 256; out `threads` words). Returns cudaGetLastError() after the launch.
extern "C" int chain_latency(int mode, int n, int threads, const unsigned* seed, unsigned* out,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0 || mode == 1)
    field_chain<<<1, 1, 0, s>>>(mode, n, seed, out);
  else if (mode == 2 && threads >= 1 && threads <= 256)
    barrier_chain<<<1, threads, 0, s>>>(n, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
