// K11: the fp12 square of a batch on Hopper (sm_90a).
//
// Replaces the sqr12 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("sqr12")). Here: a (12, 30, N)
// int32 -> out (12, 30, N), bit-equal to tower_lazy.fp12_sqr
// (ops/fp12_sqr.py:fp12_sqr_plain). The unfused Miller loop calls it at
// each of its 63 doubling events.
//
// What bounds it: operations. The complex square is 2 fp6 products (36
// Montgomery products of ~3.7K int32 instructions each) and ~50 folded
// sums per element, against 2 x 1,440 bytes read and written once.
//
// Design (first version), as K4: one thread per element, the Karatsuba
// tree of tower13.cuh (fp6_mul -> fp2_mul -> fp_mul, each one out-of-line
// copy) with the operand in registers and local memory; coalesced loads
// and stores; 32 threads a block (the out-of-line bodies take 11-19 KB of
// stack per thread).
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) fp12_sqr_kernel(const int* __restrict__ a,
                                                      int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::fp12_sqr_elem(a, out, n, i);
}

}  // namespace

// a, out: (12, 30, n) int32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_fp12_sqr(const int* a, int* out, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  fp12_sqr_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}
