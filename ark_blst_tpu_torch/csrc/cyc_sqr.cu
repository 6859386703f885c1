// K3: n cyclotomic squarings of an fp12 batch on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:cyc_sqr_stacked
// (body _cyc_sqr_n_kernel). Here: x (12, 30, N) int32 digits -> out
// (12, 30, N), n times the Granger-Scott square of tower_lazy._cyc_sqr_core,
// equal to the port's plain version (ops/cyc_sqr.py:cyc_sqr_plain) by
// canonical value, its digits within 4096.
//
// What bounds it: operations. One square is 18 Montgomery products of 12
// x 32-bit words (CIOS, ~0.9K instructions each) and ~60 modular sums,
// against 2 x 1,440 bytes per element read and written once for all n
// squares, and the two conversions (digits to words and back, a product
// each per Fp component) once per launch.
//
// Design (tower381.cuh): each element's 12 Fp components live in shared
// memory as canonical Montgomery words for all n squares; a block holds E
// elements, and its threads split each square into two phases of
// independent jobs: the nine Fp2 squares (two products each), then the six
// 3t +- 2z recombinations, with a barrier after each. A job holds a few
// Fp2 values in registers (95 registers, no spills), so ~17 warps share
// an SM at N = 8192 to hide the latency of the products' carry chains (the
// first version, one thread an element at 255 registers and 11-19 KB of
// stack, kept ~2 warps an SM). The digit stacks are read and written once a launch,
// neighbouring threads on neighbouring elements. Tensor cores do not apply:
// a 384-bit modular product has no wgmma form here; the IMAD pipe carries
// the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads: one thread a
// square's job (9 x 32), so each of its phases takes one round, and two
// blocks an SM at the compiled registers. The other shapes that
// scripts/tower_probe.py times ran slower (PERF.md).
constexpr int kElems = 32;
constexpr int kThreads = 288;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads) cyc_sqr_kernel(const int* __restrict__ x,
                                                              int* __restrict__ out,
                                                              long long n, int nsq, int E) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  const int phases = t381::cyc_sqr_phases(nsq);
  for (int ph = 0; ph < phases; ++ph) {
    const int jobs = t381::cyc_sqr_jobs(ph, nsq) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::cyc_sqr_job(b, x, out, nsq, ph, j / E, j % E);
    __syncthreads();
  }
}

}  // namespace

// cyc_sqr at a given shape: E elements and `threads` threads a block
// (threads <= 512). Returns cudaGetLastError() after the launch.
extern "C" int tower_cyc_sqr_shaped(const int* x, int* out, long long n, int nsq, int E,
                                    int threads, void* stream) {
  if (n <= 0) return 0;
  const int smem = E * t381::CYC_SLOTS * t381::SLOT * 4;
  cudaError_t err = cudaFuncSetAttribute(cyc_sqr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  cyc_sqr_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n, nsq, E);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (12, 30, n) int32, contiguous, on the device of `stream`; nsq >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_cyc_sqr(const int* x, int* out, long long n, int nsq, void* stream) {
  return tower_cyc_sqr_shaped(x, out, n, nsq, kElems, kThreads, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// compiled registers and the shape's shared memory): on entry, elems and
// threads > 0 name the shape, 0 the default, which they then hold. Returns
// the CUDA error of the query (0 on success).
extern "C" int tower_cyc_sqr_shape(int* elems, int* threads, int* smem_bytes,
                                   int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem_bytes = *elems * t381::CYC_SLOTS * t381::SLOT * 4;
  cudaError_t err = cudaFuncSetAttribute(cyc_sqr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cyc_sqr_kernel, *threads, *smem_bytes));
}
