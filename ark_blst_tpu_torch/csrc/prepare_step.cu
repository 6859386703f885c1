// K5: one G2 prepare event of the pairing on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_prepare_step(is_dbl).
// Here: R (6, 30, N) [+ Q (4, 30, N)] int32 -> out (12, 30, N): the
// Jacobian doubling of R (or the mixed addition of the affine Q) in rows
// 0-5 and its line coefficients c0, c1, c2 in rows 6-11, bit-equal to
// curves/pairing_steps.py:prepare_step_plain.
//
// What bounds it: operations. A doubling is 25 Montgomery products, an
// addition 37, each ~3.7K int32 instructions, plus the folded glue,
// against at most 22 x 120 bytes per element read and written once.
//
// Design (first version): one thread per element; the step functions of
// tower13.cuh with one out-of-line copy of each fp2 operation and of the
// product; coalesced loads and stores; 32 threads a block.
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) prepare_step_kernel(const int* __restrict__ r,
                                                          const int* __restrict__ q,
                                                          int* __restrict__ out, long long n,
                                                          int is_add) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::prepare_step_elem(r, q, out, n, i, is_add);
}

}  // namespace

// r: (6, 30, n), q: (4, 30, n) (read only when is_add), out: (12, 30, n);
// int32, contiguous, on the device of `stream`. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pairing_prepare_step(const int* r, const int* q, int* out, long long n, int is_add,
                                    void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  prepare_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(r, q, out, n, is_add);
  return static_cast<int>(cudaGetLastError());
}
