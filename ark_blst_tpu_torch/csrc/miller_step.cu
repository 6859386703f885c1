// K6: one Miller-loop event of the pairing on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_miller_step(with_sqr).
// Here: F (12, 30, N), C (6, 30, N), PXY (2, 30, N) int32 digits -> out
// (12, 30, N): f^2 (when with_sqr), the line C scaled by P (_ell_legs),
// then the sparse product fp12_mul_by_014; equal to
// curves/pairing_steps.py:miller_step_plain by canonical value, its digits
// within 4096.
//
// What bounds it: operations. 36 + 4 + 45 = 85 Montgomery products of 12 x
// 32-bit words with the square (49 without), ~0.9K instructions each, ~150
// modular sums, and the conversions of 20 Fp components in and 12 out (a
// product each, and the reduction of the digits' sum), against 32 x 120
// bytes per element read and written once.
//
// Design (tower381.cuh): each element's state lives in shared memory as
// canonical Montgomery words, 30 Fp2 slots (2,880 bytes); a block holds E
// elements, and its threads run the event as phases of independent jobs
// with a barrier between: the conversions in (20 jobs an element), the
// square's 12 Fp2 Karatsuba legs with the two line scalings (14), t and m
// (6), g (6), the sparse product's 15 Fp2 products (15), their combination
// (6), the conversions out (12). A job holds a few Fp2 values in
// registers (128 registers, a few spilled words), so ~16 warps share an
// SM at N = 8192 to hide the latency of the products' carry chains (the
// first version, one thread an element at 255 registers and 11-19 KB of
// stack, kept ~2 warps an SM).
// The digit stacks are read and written once, neighbouring threads on
// neighbouring elements. Tensor cores do not apply: a 384-bit modular
// product has no wgmma form here; the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (eight an
// element): two blocks an SM, by shared memory and registers. The other
// shapes that scripts/tower_probe.py times ran no faster (PERF.md).
constexpr int kElems = 32;
constexpr int kThreads = 256;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads) miller_step_kernel(
    const int* __restrict__ f, const int* __restrict__ c, const int* __restrict__ pxy,
    int* __restrict__ out, long long n, int with_sqr, int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  const int phases = t381::miller_phases(with_sqr);
  for (int ph = 0; ph < phases; ++ph) {
    if (edges_only && ph != 0 && ph != phases - 1) continue;
    const int jobs = t381::miller_jobs(ph, with_sqr) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::miller_job(b, f, c, pxy, out, with_sqr, ph, j / E, j % E);
    __syncthreads();
  }
}

}  // namespace

// miller_step at a given shape: E elements and `threads` threads a block
// (threads <= 512); with edges_only, the conversions alone (out = f, the
// cost of the kernel's edges, for scripts/tower_probe.py). Returns
// cudaGetLastError() after the launch.
extern "C" int pairing_miller_step_shaped(const int* f, const int* c, const int* pxy, int* out,
                                          long long n, int with_sqr, int E, int threads,
                                          int edges_only, void* stream) {
  if (n <= 0) return 0;
  const int smem = E * t381::MILLER_SLOTS * t381::SLOT * 4;
  cudaError_t err = cudaFuncSetAttribute(miller_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  miller_step_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(f, c, pxy, out, n, with_sqr, E,
                                                                   edges_only);
  return static_cast<int>(cudaGetLastError());
}

// f: (12, 30, n), c: (6, 30, n), pxy: (2, 30, n), out: (12, 30, n); int32,
// contiguous, on the device of `stream`. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int pairing_miller_step(const int* f, const int* c, const int* pxy, int* out,
                                   long long n, int with_sqr, void* stream) {
  return pairing_miller_step_shaped(f, c, pxy, out, n, with_sqr, kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// compiled registers and the shape's shared memory): on entry, elems and
// threads > 0 name the shape, 0 the default, which they then hold. Returns
// the CUDA error of the query (0 on success).
extern "C" int pairing_miller_step_shape(int* elems, int* threads, int* smem_bytes,
                                         int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem_bytes = *elems * t381::MILLER_SLOTS * t381::SLOT * 4;
  cudaError_t err = cudaFuncSetAttribute(miller_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, miller_step_kernel, *threads, *smem_bytes));
}
