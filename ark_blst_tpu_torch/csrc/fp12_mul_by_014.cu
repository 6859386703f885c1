// K12: the sparse line product of the Miller loop on Hopper (sm_90a).
//
// Replaces the mul_by_014 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("mul_by_014")). Here: F
// (12, 30, N) and the scaled line C (6, 30, N), rows c0[0], c0[1], c1[0],
// c1[1], c4[0], c4[1], int32 digits -> out (12, 30, N) = f * ((c0 + c1 v) +
// (c4 v) w), equal to a single-item tower_lazy.fp12_mul_by_014_many
// (ops/fp12_mul_by_014.py:fp12_mul_by_014_plain) by canonical value, its
// digits within 4096. The unfused Miller loop calls it at each of its 68
// events.
//
// What bounds it: operations. 15 Fp2 products (45 Montgomery products of
// 12 x 32-bit words, ~0.9K instructions each) and ~120 modular sums, and
// the conversions of 18 Fp components in and 12 out (a product each, and
// the reduction of the digits' sum), nearly half the work, against
// (12 + 6 + 12) x 120 bytes per element read and written once.
//
// Design (tower381.cuh): K6's sparse product on its tables. Each element's
// state lives in shared memory as canonical Montgomery words, 27 Fp2
// slots (2,592 bytes); a block holds E elements, and its threads run the
// product as phases of independent jobs with a barrier between: the
// conversions in (18 jobs an element, the line into the slots where K6's
// line scaling leaves it), the 15 Fp2 products, the operand sums taken in
// the job (15), their combination (6), the conversions out (12). A job
// holds a few Fp2 values in registers, so many warps share an SM to hide
// the latency of the products' carry chains. The digit stacks are read
// and written once, neighbouring threads on neighbouring elements. Tensor
// cores do not apply: a 384-bit modular product has no wgmma form here;
// the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (eight an
// element: the 15 products in two rounds), and the kernel bounded by it:
// kMinBlocks blocks an SM (as many as shared memory holds), hence at most
// 128 registers a thread. scripts/tower_probe.py builds the kernel at
// other bounds (K12_THREADS, K12_MIN_BLOCKS) and times it at their shapes
// (PERF.md).
#ifndef K12_THREADS
#define K12_THREADS 256
#endif
#ifndef K12_MIN_BLOCKS
#define K12_MIN_BLOCKS 2
#endif
constexpr int kElems = 32;
constexpr int kThreads = K12_THREADS;
constexpr int kMinBlocks = K12_MIN_BLOCKS;

__global__ void __launch_bounds__(kThreads, kMinBlocks) fp12_mul_by_014_kernel(
    const int* __restrict__ f, const int* __restrict__ c, int* __restrict__ out, long long n,
    int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block blk{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  for (int ph = 0; ph < t381::MUL_BY_014_PHASES; ++ph) {
    if (edges_only && ph != t381::B014_LOAD && ph != t381::B014_STORE) continue;
    const int jobs = t381::mul_by_014_jobs(ph) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::mul_by_014_job(blk, f, c, out, ph, j / E, j % E);
    __syncthreads();
  }
}

int smem_bytes(int E) { return E * t381::MUL_BY_014_SLOTS * t381::SLOT * 4; }

}  // namespace

// fp12_mul_by_014 at a given shape: E elements and `threads` threads a
// block (threads <= kThreads); with edges_only, the conversions alone
// (out = f, the cost of the kernel's edges, for scripts/tower_probe.py).
// Returns cudaGetLastError() after the launch.
extern "C" int tower_fp12_mul_by_014_shaped(const int* f, const int* c, int* out, long long n,
                                            int E, int threads, int edges_only, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fp12_mul_by_014_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  fp12_mul_by_014_kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
                           static_cast<cudaStream_t>(stream)>>>(f, c, out, n, E, edges_only);
  return static_cast<int>(cudaGetLastError());
}

// f: (12, 30, n), c: (6, 30, n), out: (12, 30, n); int32, contiguous, on
// the device of `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tower_fp12_mul_by_014(const int* f, const int* c, int* out, long long n,
                                     void* stream) {
  return tower_fp12_mul_by_014_shaped(f, c, out, n, kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// compiled registers and the shape's shared memory): on entry, elems and
// threads > 0 name the shape, 0 the default, which they then hold. Returns
// the CUDA error of the query (0 on success).
extern "C" int tower_fp12_mul_by_014_shape(int* elems, int* threads, int* smem,
                                           int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err = cudaFuncSetAttribute(fp12_mul_by_014_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fp12_mul_by_014_kernel, *threads, *smem));
}
