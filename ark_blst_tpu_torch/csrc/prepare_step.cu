// K5: one G2 prepare event of the pairing on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_prepare_step(is_dbl).
// Here: R (6, 30, N) [+ Q (4, 30, N)] int32 digits -> out (12, 30, N): the
// Jacobian doubling of R (or the mixed addition of the affine Q) in rows
// 0-5 and its line coefficients c0, c1, c2 in rows 6-11, equal to
// curves/pairing_steps.py:prepare_step_plain by canonical value, its digits
// within 4096.
//
// What bounds it: operations. A doubling is 25 Montgomery products of 12 x
// 32-bit words (~0.9K instructions each) and ~90 modular sums, an
// addition 37 and ~110, plus the conversions of 6 (10) Fp components in
// and 12 out, about as much work again as the doubling's products and
// sums; against at most 22 x 120 bytes per element read and written once.
// The event is a short chain of dependent products (three phases for the
// doubling, five for the addition), and some phases are narrow: one
// product an element in the doubling's last.
//
// Design (tower381.cuh): each element's state lives in shared memory as
// canonical Montgomery words, 26 Fp2 slots (2,496 bytes); a block holds E
// elements, and its threads run the event as phases of independent jobs
// with a barrier between: the conversions in (one job an Fp component),
// the product phases (the plain code's linear steps folded into the
// products' operand sums), one phase of sums for the new point and the
// line, the conversions out (12). The form is chosen by is_add, uniform
// per launch. A job holds a few Fp2 values in registers, so many warps
// share an SM to hide the products' carry chains, and the block's many
// elements fill the narrow phases (the first version, one thread an
// element on radix-13 digits at ~255 registers and 11-17 KB of stack,
// kept ~2 warps an SM). The digit stacks are read and written once,
// neighbouring threads on neighbouring elements. Tensor cores do not
// apply: a 384-bit modular product has no wgmma form here; the IMAD pipe
// carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (six an
// element: the widest product phase), and the kernel bounded by it:
// kMinBlocks blocks an SM (as many as shared memory holds), hence at most
// 168 registers a thread, no spills. scripts/tower_probe.py builds the
// kernel at other bounds (K5_THREADS, K5_MIN_BLOCKS) and times it at their
// shapes (PERF.md).
#ifndef K5_THREADS
#define K5_THREADS 192
#endif
#ifndef K5_MIN_BLOCKS
#define K5_MIN_BLOCKS 2
#endif
constexpr int kElems = 32;
constexpr int kThreads = K5_THREADS;
constexpr int kMinBlocks = K5_MIN_BLOCKS;

__global__ void __launch_bounds__(kThreads, kMinBlocks) prepare_step_kernel(
    const int* __restrict__ r, const int* __restrict__ q, int* __restrict__ out, long long n,
    int is_add, int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  const int phases = t381::prepare_phases(is_add);
  for (int ph = 0; ph < phases; ++ph) {
    if (edges_only && ph != 0 && ph != phases - 1) continue;
    const int jobs = t381::prepare_jobs(ph, is_add) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::prepare_job(b, r, q, out, is_add, edges_only, ph, j / E, j % E);
    __syncthreads();
  }
}

int smem_bytes(int E) { return E * t381::PREPARE_SLOTS * t381::SLOT * 4; }

}  // namespace

// prepare_step at a given shape: E elements and `threads` threads a block
// (threads <= kThreads); with edges_only, the conversions alone (out row c
// = input component c mod 6, R repeated, or c mod 10 for the addition, R
// and Q: the cost of the kernel's edges, for scripts/tower_probe.py).
// Returns cudaGetLastError() after the launch.
extern "C" int pairing_prepare_step_shaped(const int* r, const int* q, int* out, long long n,
                                           int is_add, int E, int threads, int edges_only,
                                           void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(prepare_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  prepare_step_kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
                        static_cast<cudaStream_t>(stream)>>>(r, q, out, n, is_add, E,
                                                                  edges_only);
  return static_cast<int>(cudaGetLastError());
}

// r: (6, 30, n), q: (4, 30, n) (read only when is_add), out: (12, 30, n);
// int32, contiguous, on the device of `stream`. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pairing_prepare_step(const int* r, const int* q, int* out, long long n, int is_add,
                                    void* stream) {
  return pairing_prepare_step_shaped(r, q, out, n, is_add, kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// compiled registers and the shape's shared memory, the same for both
// forms): on entry, elems and threads > 0 name the shape, 0 the default,
// which they then hold. Returns the CUDA error of the query (0 on success).
extern "C" int pairing_prepare_step_shape(int* elems, int* threads, int* smem,
                                          int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err = cudaFuncSetAttribute(prepare_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, prepare_step_kernel, *threads, *smem));
}
