// K4: the fp12 product of two batches on Hopper (sm_90a).
//
// Replaces the mul12 instance of the TPU kernel
// ark_blst_tpu/ops/pallas_lazy.py:tower_fused (built by
// ark_blst_tpu/ops/tower_lazy.py:_fused_op("mul12")), and, on strict
// limbs, the strict tower's fp12 product (ops/pallas_field.py:66
// _block_call, K7-K10) in the strict multi-pairings' product fold
// (ark_blst_tpu/curves/pairing.py:470 _fold_mul). Here: a, b -> out =
// a * b, in one of four layouts of the edges (tower381.cuh EdgeFormat,
// an instantiation each):
//   digits -> digits  a, b, out (12, 30, N) int32 digits, the unfused
//                     path's; equal to tower_lazy.fp12_mul_many([(a, b)])
//                     (ops/fp12_mul.py:fp12_mul_plain) by canonical value,
//                     its digits within 4096;
//   words -> words    a, b, out (12, 12, N) canonical 32-bit words, the
//                     multi-pairings' product fold on K6-chain's conj(f);
//                     the conversions are row copies;
//   words -> limbs    out the strict (12, 24, N) limbs, the fold's last
//                     level in multi_miller_loop: the Miller product
//                     leaves as a 16-bit split of its words;
//   limbs -> limbs    a, b, out the strict (12, 24, N) limbs, the strict
//                     engine's fused multi-pairings' fold on K6-chain's
//                     conj(f): a load is a repack (reduced below p), a
//                     store a split.
// Words and limbs are canonical: equal to the plain version's word for
// word and limb for limb (on limbs, the strict tower's fp12_mul's).
//
// What bounds it: operations. 54 Montgomery products of 12 x 32-bit words
// (~0.9K instructions each) and ~220 modular sums; on digits also the
// conversions of 24 Fp components in and 12 out (a product each, and the
// reduction of the digits' sum), which are nearly half the work, against
// 36 x 120 bytes per element read and written once (36 x 48 on words).
//
// Design (tower381.cuh): each element's state lives in shared memory as
// canonical Montgomery words, 30 Fp2 slots (2,880 bytes); a block holds E
// elements, and its threads run the product as phases of independent jobs
// with a barrier between: the loads (24 jobs an element), the 18 Fp2
// Karatsuba legs of the three fp6 products t0 = a0 b0, t1 = a1 b1 and t2 =
// (a0 + a1)(b0 + b1), the leg sums taken in the job (18), their three fp6
// interpolations (9), the result c0 = t0 + v t1, c1 = t2 - t0 - t1 (6),
// the stores (12). A job holds a few Fp2 values in registers, so many
// warps share an SM to hide the latency of the products' carry chains (the
// first version, one thread an element on radix-13 digits at ~255
// registers and 11-17 KB of stack, kept ~2 warps an SM). The stacks are
// read and written once, neighbouring threads on neighbouring elements.
// Tensor cores do not apply: a 384-bit modular product has no wgmma form
// here; the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (six an element:
// the 18 products in three rounds), and every instantiation bounded by
// it: kMinBlocks blocks an SM (as many as shared memory holds), hence at
// most 168 registers a thread, no spills. scripts/tower_probe.py builds
// the kernel at other bounds (K4_THREADS, K4_MIN_BLOCKS) and times each
// layout at their shapes (PERF.md): 256 threads, capped at 128 registers,
// spill and run no faster.
#ifndef K4_THREADS
#define K4_THREADS 192
#endif
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 2
#endif
constexpr int kElems = 32;
constexpr int kThreads = K4_THREADS;
constexpr int kMinBlocks = K4_MIN_BLOCKS;

template <int IN_FMT, int OUT_FMT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fp12_mul_kernel(
    const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out, long long n,
    int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block blk{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  for (int ph = 0; ph < t381::FP12_MUL_PHASES; ++ph) {
    if (edges_only && ph != t381::M12_LOAD && ph != t381::M12_STORE) continue;
    const int jobs = t381::fp12_mul_jobs(ph) * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x)
      t381::fp12_mul_job<IN_FMT, OUT_FMT>(blk, a, b, out, edges_only, ph, j / E, j % E);
    __syncthreads();
  }
}

// The layouts (in, out): the unfused path's digits, the fold's words, its
// last level's words in and strict limbs out, and the strict engine's
// fold on strict limbs.
using Kernel = void (*)(const int*, const int*, int*, long long, int, int);
const Kernel kDigits = fp12_mul_kernel<t381::DIGIT_ROWS, t381::DIGIT_ROWS>;
const Kernel kWords = fp12_mul_kernel<t381::WORD_ROWS, t381::WORD_ROWS>;
const Kernel kLimbs = fp12_mul_kernel<t381::WORD_ROWS, t381::LIMB_ROWS>;
const Kernel kLimbsLimbs = fp12_mul_kernel<t381::LIMB_ROWS, t381::LIMB_ROWS>;

Kernel kernel_for(int in_fmt, int out_fmt) {
  if (in_fmt == t381::DIGIT_ROWS) return out_fmt == t381::DIGIT_ROWS ? kDigits : nullptr;
  if (in_fmt == t381::LIMB_ROWS) return out_fmt == t381::LIMB_ROWS ? kLimbsLimbs : nullptr;
  if (in_fmt != t381::WORD_ROWS) return nullptr;
  return out_fmt == t381::WORD_ROWS ? kWords : out_fmt == t381::LIMB_ROWS ? kLimbs : nullptr;
}

int smem_bytes(int E) { return E * t381::FP12_MUL_SLOTS * t381::SLOT * 4; }

}  // namespace

// fp12_mul at a given shape: a and b of format in_fmt, out of format
// out_fmt (t381::EdgeFormat: digits and digits, words and words, words
// and limbs, or limbs and limbs), E elements and `threads` threads a block (threads <=
// kThreads); with edges_only, the loads and stores alone (out = a, the
// cost of the kernel's edges, for scripts/tower_probe.py). Returns
// cudaGetLastError() after the launch.
extern "C" int tower_fp12_mul_shaped(const int* a, const int* b, int* out, long long n,
                                     int in_fmt, int out_fmt, int E, int threads,
                                     int edges_only, void* stream) {
  const Kernel kernel = kernel_for(in_fmt, out_fmt);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
           static_cast<cudaStream_t>(stream)>>>(a, b, out, n, E, edges_only);
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: (12, 30, n) int32 digits, contiguous, on the device of
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tower_fp12_mul(const int* a, const int* b, int* out, long long n, void* stream) {
  return tower_fp12_mul_shaped(a, b, out, n, t381::DIGIT_ROWS, t381::DIGIT_ROWS, kElems,
                               kThreads, 0, stream);
}

// a, b: (12, K, n) of format in_fmt, out: (12, K', n) of format out_fmt
// (digits and digits, words and words, words and strict limbs, or strict
// limbs and strict limbs); int32,
// contiguous, on the device of `stream`. Returns cudaGetLastError() after
// the launch (0 on success; cudaErrorInvalidValue for another layout).
extern "C" int tower_fp12_mul_formats(const int* a, const int* b, int* out, long long n,
                                      int in_fmt, int out_fmt, void* stream) {
  return tower_fp12_mul_shaped(a, b, out, n, in_fmt, out_fmt, kElems, kThreads, 0, stream);
}

// A launch shape of the layout (in_fmt, out_fmt) and the blocks an SM
// holds at it (the occupancy API at the instantiation's registers and the
// shape's shared memory): on entry, elems and threads > 0 name the shape,
// 0 the default, which they then hold. Returns the CUDA error of the query
// (0 on success).
extern "C" int tower_fp12_mul_formats_shape(int in_fmt, int out_fmt, int* elems, int* threads,
                                            int* smem, int* blocks_per_sm) {
  const Kernel kernel = kernel_for(in_fmt, out_fmt);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, *threads, *smem));
}

// The digits' launch shape (tower_fp12_mul_formats_shape of digits and
// digits).
extern "C" int tower_fp12_mul_shape(int* elems, int* threads, int* smem, int* blocks_per_sm) {
  return tower_fp12_mul_formats_shape(t381::DIGIT_ROWS, t381::DIGIT_ROWS, elems, threads, smem,
                                      blocks_per_sm);
}
