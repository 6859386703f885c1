// K4: the fp12 product of two batches on Hopper (sm_90a).
//
// Replaces the mul12 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("mul12")). Here: a, b
// (12, 30, N) int32 -> out (12, 30, N), bit-equal to
// tower_lazy.fp12_mul_many([(a, b)]) (ops/fp12_mul.py:fp12_mul_plain).
//
// What bounds it: operations. 54 Montgomery products (~3.7K int32
// instructions each) and ~150 folded sums per element, against 3 x 1,440
// bytes read and written once.
//
// Design (first version): one thread per element, the Karatsuba tree of
// tower13.cuh (fp6_mul -> fp2_mul -> fp_mul, each one out-of-line copy)
// with the operands in registers and local memory; coalesced loads and
// stores; 32 threads a block.
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) fp12_mul_kernel(const int* __restrict__ a,
                                                      const int* __restrict__ b,
                                                      int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::fp12_mul_elem(a, b, out, n, i);
}

}  // namespace

// a, b, out: (12, 30, n) int32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_fp12_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  fp12_mul_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
