// K3: n cyclotomic squarings of an fp12 batch on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:cyc_sqr_stacked
// (body _cyc_sqr_n_kernel). Here: x (12, 30, N) int32 -> out (12, 30, N),
// out = n times tower_lazy._cyc_sqr_core(x), bit-equal to the port's plain
// version (ops/cyc_sqr.py:cyc_sqr_plain).
//
// What bounds it: operations. One square is 18 Montgomery products (~3.7K
// int32 instructions each) plus ~2.5K of contraction and folds, against
// 2 x 1,440 bytes per element read and written once for all n squares.
//
// Design (first version): one thread per element, the value held by the
// thread between the n squarings (registers and local memory), so a run of
// the exponent ladder (n up to 32) never leaves the thread. One copy of the
// product body (tw::fp_mul, out of line) serves all 18 products; loads and
// stores are coalesced across a warp (neighbouring threads, neighbouring
// elements of each digit row). 32 threads a block spread the N = 8192 of a
// pairing batch over all 132 SMs.
#include "tower13.cuh"

namespace {

__global__ void __launch_bounds__(32) cyc_sqr_kernel(const int* __restrict__ x,
                                                     int* __restrict__ out, long long n,
                                                     int nsq) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tw::cyc_sqr_elem(x, out, n, i, nsq);
}

}  // namespace

// x, out: (12, 30, n) int32, contiguous, on the device of `stream`; nsq >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_cyc_sqr(const int* x, int* out, long long n, int nsq, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 32;
  const long long blocks = (n + threads - 1) / threads;
  cyc_sqr_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n, nsq);
  return static_cast<int>(cudaGetLastError());
}
