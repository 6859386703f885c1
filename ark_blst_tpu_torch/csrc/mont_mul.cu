// K1: elementwise lazy radix-13 Montgomery product on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:mont_mul_stacked
// (body _mul_kernel), which runs lazy13.mont_mul on (30, 8, 128) VMEM
// blocks. Here: (30, N) int32 x (30, N) int32 -> (30, N) int32, digit axis
// first, out = a * b / 2^390 bit-equal to the Python engine's mont_mul.
//
// What bounds it: operations, narrowly. Per element it issues ~3.7K int32
// instructions (900 column multiply-adds, 465 + 900 for the reduction's
// constant products, the rest folds) against 360 bytes of traffic, i.e.
// ~10.4 ops per byte, just above the card's issue-to-HBM ratio
// (33.5e12 instructions/s over 3.35e12 B/s = 10 ops per byte).
//
// Design: one thread per element with its digits in registers, the
// 30 x 30 columns fully unrolled into straight-line IMADs, the constant
// digits of p and -p^-1 read as constant-bank operands. Loads and stores
// are coalesced: neighbouring threads read neighbouring elements of each
// digit row. No shared memory, no tensor cores: a 381-bit product has no
// shape the tensor cores take without splitting digits below 8 bits.
#include "lazy13.cuh"

namespace {

__global__ void __launch_bounds__(128) mont_mul_kernel(const int* __restrict__ a,
                                                        const int* __restrict__ b,
                                                        int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x[lz::ELEM], y[lz::ELEM], r[lz::ELEM];
#pragma unroll
  for (int k = 0; k < lz::ELEM; ++k) {
    x[k] = a[k * n + i];
    y[k] = b[k * n + i];
  }
  lz::mont_mul(x, y, r);
#pragma unroll
  for (int k = 0; k < lz::ELEM; ++k) out[k * n + i] = r[k];
}

}  // namespace

// a, b, out: (30, n) int32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lz_mont_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
