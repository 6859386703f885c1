// K11: the fp12 square of a batch on Hopper (sm_90a).
//
// Replaces the sqr12 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("sqr12")). Here: a (12, 30, N)
// int32 digits -> out (12, 30, N): a^2, equal to tower_lazy.fp12_sqr
// (ops/fp12_sqr.py:fp12_sqr_plain) by canonical value, its digits within
// 4096. The unfused Miller loop calls it at each of its 63 doubling events.
//
// What bounds it: operations. The complex square's two fp6 products are
// 36 Montgomery products of 12 x 32-bit words (~0.9K instructions each)
// and ~160 modular sums, and the conversions of 12 Fp components in and
// 12 out (a product each, and the reduction of the digits' sum) are nearly
// half the work, against 24 x 120 bytes per element read and written once.
//
// Design (tower381.cuh): K6's square on its tables. Each element's state
// lives in shared memory as canonical Montgomery words, 30 Fp2 slots
// (2,880 bytes); a block holds E elements, and its threads run the square
// as phases of independent jobs with a barrier between: the conversions
// in (12 jobs an element), the 12 Fp2 Karatsuba legs of t = f0 f1 and
// m = (f0 + f1)(f0 + v f1), the leg sums taken in the job (12), t and m
// from their legs (6), the square (m - t - v t, 2 t) (6), the conversions
// out (12). A job holds a few Fp2 values in registers, so many warps share
// an SM to hide the latency of the products' carry chains. The digit
// stacks are read and written once, neighbouring threads on neighbouring
// elements. Tensor cores do not apply: a 384-bit modular product has no
// wgmma form here; the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (six an element:
// the 12 legs in two rounds), and the kernel bounded by it: kMinBlocks
// blocks an SM (as many as shared memory holds), hence at most 168
// registers a thread. scripts/tower_probe.py builds the kernel at other
// bounds (K11_THREADS, K11_MIN_BLOCKS) and times it at their shapes
// (PERF.md).
#ifndef K11_THREADS
#define K11_THREADS 192
#endif
#ifndef K11_MIN_BLOCKS
#define K11_MIN_BLOCKS 2
#endif
constexpr int kElems = 32;
constexpr int kThreads = K11_THREADS;
constexpr int kMinBlocks = K11_MIN_BLOCKS;

__global__ void __launch_bounds__(kThreads, kMinBlocks) fp12_sqr_kernel(
    const int* __restrict__ a, int* __restrict__ out, long long n, int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block blk{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  for (int ph = 0; ph < t381::FP12_SQR_PHASES; ++ph) {
    if (edges_only && ph != t381::S12_LOAD && ph != t381::S12_STORE) continue;
    const int jobs = t381::fp12_sqr_jobs(ph) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::fp12_sqr_job(blk, a, out, ph, j / E, j % E);
    __syncthreads();
  }
}

int smem_bytes(int E) { return E * t381::FP12_SQR_SLOTS * t381::SLOT * 4; }

}  // namespace

// fp12_sqr at a given shape: E elements and `threads` threads a block
// (threads <= kThreads); with edges_only, the conversions alone (out = a,
// the cost of the kernel's edges, for scripts/tower_probe.py). Returns
// cudaGetLastError() after the launch.
extern "C" int tower_fp12_sqr_shaped(const int* a, int* out, long long n, int E, int threads,
                                     int edges_only, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fp12_sqr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  fp12_sqr_kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
                    static_cast<cudaStream_t>(stream)>>>(a, out, n, E, edges_only);
  return static_cast<int>(cudaGetLastError());
}

// a, out: (12, 30, n) int32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_fp12_sqr(const int* a, int* out, long long n, void* stream) {
  return tower_fp12_sqr_shaped(a, out, n, kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// compiled registers and the shape's shared memory): on entry, elems and
// threads > 0 name the shape, 0 the default, which they then hold. Returns
// the CUDA error of the query (0 on success).
extern "C" int tower_fp12_sqr_shape(int* elems, int* threads, int* smem, int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err = cudaFuncSetAttribute(fp12_sqr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fp12_sqr_kernel, *threads, *smem));
}
