// K5: the G2 prepare of the pairing on Hopper (sm_90a), its events in one
// launch (K5-chain).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:63 tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_prepare_step(is_dbl) and
// run under the lax.scan of curves/pairing.py:242 (the doublings) with the
// additions between (:245). Here: Q (4, K, N) int32 [+ R (6, K, N)] and a
// schedule of events (a doubling of R, or the mixed addition of the affine
// Q) -> each event's line coefficients c0, c1, c2 into row e of the stack
// (events, 6, K', N) [+ R after the last event (6, K', N)], equal to the
// loop of curves/pairing_steps.py:prepare_step_plain by canonical value.
// The edges' formats (tower381.cuh): the fused pipeline gives Q as the
// strict (24, N) limbs it holds, forms R = (Q, 1) in the kernel, and takes
// the lines as canonical 32-bit words (K' = 12), which K6-chain loads as
// they are (pairing_steps.prepare_lines); the strict engine's prepare
// (curves/pairing.py:262, its lax.scan over the strict tower's ops, each a
// pallas_field.py:66 _block_call) takes them as canonical strict limbs (K'
// = 24), its own lines' layout; the digit entries give and take
// radix-13 digits (K = K' = 30, digits within 4096). One event is the
// chain of one (pairing_steps.prepare_step).
//
// What bounds it: operations. A doubling is 25 Montgomery products of 12 x
// 32-bit words (~0.9K instructions each) and ~90 modular sums, an addition
// 37 and ~110; against 6 x 48 bytes an element an event (the line written
// as words) and Q read once. Launched once an event, the edges (10 Fp
// components in and 12 out, a conversion between digits and words each)
// were about as much work again as the doubling's products. The chain
// keeps R, and Q, in shared memory as words across the events; with the
// strict and word edges no conversion is left but the limbs' packing.
//
// Design (tower381.cuh, prepare_chain): each element's state lives in
// shared memory as canonical Montgomery words, 26 Fp2 slots (2,496 bytes);
// a block holds E elements, and its threads run each event as phases of
// independent jobs with a barrier between: the product phases (the plain
// code's linear steps folded into the products' operand sums), one phase
// of sums for the new point and the line, and one that stores the line
// and moves R' into R's slots. The events' forms come from the schedule,
// and the edges' formats from the launch, both uniform per launch. A job
// holds a few Fp2 values in registers, so many warps share an SM to hide
// the products' carry chains, and the block's many elements fill the
// narrow phases. Tensor cores do not apply: a 384-bit modular product has
// no wgmma form here; the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, six threads an element (the
// widest product phase), and the kernel bounded by the default shape:
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

// One instantiation for each layout of the edges a caller uses: the
// formats are constants of the program, so each keeps only its own
// conversions (and the registers they need).
template <int IN_FMT, int OUT_FMT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) prepare_chain_kernel(
    const int* __restrict__ r, const int* __restrict__ q, int* __restrict__ coeffs,
    int* __restrict__ r_out, long long n, t381::Schedule s, int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  const t381::PrepareChain c{r, q, coeffs, r_out, s, edges_only};
  t381::prepare_chain<IN_FMT, OUT_FMT>(b, c, t381::BlockPhases{E});
}

// The layouts: the digit entries' (digits in and out), the fused
// pipeline's (strict limbs in, words out) and the strict engine's (strict
// limbs in and out: its (events, 6, 24, N) lines, canonical).
using Kernel = void (*)(const int*, const int*, int*, int*, long long, t381::Schedule, int, int);
const Kernel kDigits = prepare_chain_kernel<t381::DIGIT_ROWS, t381::DIGIT_ROWS>;
const Kernel kFused = prepare_chain_kernel<t381::LIMB_ROWS, t381::WORD_ROWS>;
const Kernel kStrict = prepare_chain_kernel<t381::LIMB_ROWS, t381::LIMB_ROWS>;

Kernel kernel_for(int in_fmt, int out_fmt) {
  if (in_fmt == t381::DIGIT_ROWS && out_fmt == t381::DIGIT_ROWS) return kDigits;
  if (in_fmt == t381::LIMB_ROWS && out_fmt == t381::WORD_ROWS) return kFused;
  if (in_fmt == t381::LIMB_ROWS && out_fmt == t381::LIMB_ROWS) return kStrict;
  return nullptr;
}

int smem_bytes(int E) { return E * t381::PREPARE_SLOTS * t381::SLOT * 4; }

}  // namespace

// The chain at a given shape: E elements and `threads` threads a block
// (threads <= kThreads); dbl[i] != 0 where event i is a doubling, for
// 1 <= events <= 128; r and q of format in_fmt, coeffs and r_out of format
// out_fmt (t381::EdgeFormat: digits and digits, limbs and words, or limbs
// and limbs). r may be null (R = (Q, 1) formed in the
// kernel), q when r is given and no event is an addition, r_out when R is
// not wanted. With edges_only, the conversions alone (every line row c
// holds R's component c, r_out R: the cost of the kernel's edges, for
// scripts/tower_probe.py). Returns cudaGetLastError() after the launch.
extern "C" int pairing_prepare_chain_shaped(const int* r, const int* q, int* coeffs, int* r_out,
                                            long long n, int events, const unsigned char* dbl,
                                            int in_fmt, int out_fmt, int E, int threads,
                                            int edges_only, void* stream) {
  t381::Schedule s;
  const Kernel kernel = kernel_for(in_fmt, out_fmt);
  if (!t381::make_schedule(events, dbl, s) || !kernel || (!r && !q))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < events && !q; ++i)
    if (!dbl[i]) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
           static_cast<cudaStream_t>(stream)>>>(r, q, coeffs, r_out, n, s, E, edges_only);
  return static_cast<int>(cudaGetLastError());
}

// r: (6, K, n) or null, q: (4, K, n) or null, of format in_fmt; coeffs:
// (events, 6, K', n), r_out: (6, K', n) or null, of format out_fmt; int32,
// contiguous, on the device of `stream`. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int pairing_prepare_chain(const int* r, const int* q, int* coeffs, int* r_out,
                                     long long n, int events, const unsigned char* dbl,
                                     int in_fmt, int out_fmt, void* stream) {
  return pairing_prepare_chain_shaped(r, q, coeffs, r_out, n, events, dbl, in_fmt, out_fmt,
                                      kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// fused pipeline's build's registers and the shape's shared memory): on
// entry, elems and
// threads > 0 name the shape, 0 the default, which they then hold. Returns
// the CUDA error of the query (0 on success).
extern "C" int pairing_prepare_chain_shape(int* elems, int* threads, int* smem,
                                           int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err =
      cudaFuncSetAttribute(kFused, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kFused, *threads, *smem));
}
