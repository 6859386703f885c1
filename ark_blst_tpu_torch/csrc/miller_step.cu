// K6: one Miller-loop event of the pairing on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_miller_step(with_sqr).
// Here: F (12, 30, N), C (6, 30, N), PXY (2, 30, N) int32 -> out
// (12, 30, N): f^2 (when with_sqr), the line C scaled by P (_ell_legs),
// then the sparse product fp12_mul_by_014; bit-equal to
// curves/pairing_steps.py:miller_step_plain.
//
// What bounds it: operations. 36 + 4 + 45 = 85 Montgomery products with
// the square (49 without), each ~3.7K int32 instructions, against
// 32 x 120 bytes per element read and written once.
//
// Design (first version): one thread per element, f held by the thread
// through the square and the line product; one out-of-line copy of each
// tower operation (tower13.cuh); coalesced loads and stores; 32 threads a
// block.
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) miller_step_kernel(const int* __restrict__ f,
                                                         const int* __restrict__ c,
                                                         const int* __restrict__ pxy,
                                                         int* __restrict__ out, long long n,
                                                         int with_sqr) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::miller_step_elem(f, c, pxy, out, n, i, with_sqr);
}

}  // namespace

// f: (12, 30, n), c: (6, 30, n), pxy: (2, 30, n), out: (12, 30, n); int32,
// contiguous, on the device of `stream`. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int pairing_miller_step(const int* f, const int* c, const int* pxy, int* out,
                                   long long n, int with_sqr, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  miller_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(f, c, pxy, out, n, with_sqr);
  return static_cast<int>(cudaGetLastError());
}
