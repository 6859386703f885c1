// K12: the sparse line product of the Miller loop on Hopper (sm_90a).
//
// Replaces the mul_by_014 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("mul_by_014")). Here: F
// (12, 30, N) and the scaled line C (6, 30, N), rows c0[0], c0[1], c1[0],
// c1[1], c4[0], c4[1] -> out (12, 30, N) = f * ((c0 + c1 v) + (c4 v) w),
// bit-equal to a single-item tower_lazy.fp12_mul_by_014_many
// (ops/fp12_mul_by_014.py:fp12_mul_by_014_plain). The unfused Miller loop
// calls it at each of its 68 events.
//
// What bounds it: operations. 15 fp2 products (45 Montgomery products of
// ~3.7K int32 instructions each) and ~70 folded sums per element, against
// (12 + 6 + 12) x 120 bytes read and written once.
//
// Design (first version), as K11: one thread per element, the tower13.cuh
// body (the 15 Fp2 products that K6 runs on 32-bit words after its
// square), one out-of-line copy of each tower operation; coalesced loads
// and stores; 32 threads a block.
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) fp12_mul_by_014_kernel(const int* __restrict__ f,
                                                             const int* __restrict__ c,
                                                             int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::fp12_mul_by_014_elem(f, c, out, n, i);
}

}  // namespace

// f: (12, 30, n), c: (6, 30, n), out: (12, 30, n); int32, contiguous, on
// the device of `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tower_fp12_mul_by_014(const int* f, const int* c, int* out, long long n,
                                     void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  fp12_mul_by_014_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(f, c, out, n);
  return static_cast<int>(cudaGetLastError());
}
