// K6: the Miller loop of the pairing on Hopper (sm_90a), its events in one
// launch (K6-chain).
//
// Replaces the TPU kernel ark_blst_tpu/ops/pallas_lazy.py:63 tower_fused as
// built by ark_blst_tpu/curves/pairing.py:_fused_miller_step(with_sqr) and
// run under the lax.scan of curves/pairing.py:342 (the doubling events)
// with the addition events between (:345). Here: [F (12, 30, N) digits,]
// the line stack C (events, 6, K, N), PXY (2, K', N) int32 and a schedule
// -> out: for each event f^2 (at a doubling), the line C[e] scaled by P
// (_ell_legs), then the sparse product fp12_mul_by_014; equal to the loop
// of curves/pairing_steps.py:miller_step_plain by canonical value. The
// edges' formats (tower381.cuh): the fused pipeline gives the lines as
// K5-chain's words (K = 12) or as digits (K = 30, a prepare made unfused),
// P as the strict (24, N) limbs it holds, and forms f = one in the kernel
// (pairing_steps.miller_lines); the digit entries give f, C and P as
// digits. f leaves as (12, 30, N) digits within 4096, or, for the fused
// pairing on word lines, as conj(f) in (12, 12, N) canonical words, the
// form FE-easy loads. The strict engine's Miller loop (curves/pairing.py:
// 359, its lax.scan over the strict tower's ops, each a pallas_field.py:66
// _block_call) gives its lines (K = 24) and P as strict limbs and takes
// conj(f) as canonical (12, 24, N) strict limbs. One event is the chain of
// one (pairing_steps.miller_step).
//
// What bounds it: operations. 36 + 4 + 45 = 85 Montgomery products of 12 x
// 32-bit words with the square (49 without), ~0.9K instructions each, and
// ~150 modular sums an event, against 6 x 48 bytes an element an event
// (the line read as words) and P read and f written once. Launched once
// an event, the edges (20 Fp components in and 12 out, a conversion
// between digits and words each) were ~48K instructions an event against
// ~78K for the products. The chain keeps f and P in shared memory as words
// across the events: what is left at the edges is the line, 6 components
// an event, loaded as they are beside the previous event's last phase, and
// f's 12 stored once.
//
// Design (tower381.cuh, miller_chain): each element's state lives in
// shared memory as canonical Montgomery words, 30 Fp2 slots (2,880 bytes);
// a block holds E elements, and its threads run each event as phases of
// independent jobs with a barrier between: the square's 12 Fp2 Karatsuba
// legs with the two line scalings (14 jobs an element), t and m (6), g
// (6), the sparse product's 15 Fp2 products (15), their combination with
// the next line's loads (12). A job holds a few Fp2 values in registers,
// so ~16 warps share an SM at N = 8192 to hide the latency of the
// products' carry chains. Tensor cores do not apply: a 384-bit modular
// product has no wgmma form here; the IMAD pipe carries the products.
#include "tower381.cuh"

namespace {

// The launch shape: E elements a block, kThreads threads (eight an
// element): two blocks an SM, by shared memory and registers. The other
// shapes that scripts/tower_probe.py times ran no faster (PERF.md).
constexpr int kElems = 32;
constexpr int kThreads = 256;
constexpr int kMaxThreads = 512;

// One instantiation for each layout of the edges a caller uses: the
// formats are constants of the program, so each keeps only its own
// conversions (and the registers they need).
template <int LINE_FMT, int P_FMT, int F_FMT>
__global__ void __launch_bounds__(kMaxThreads) miller_chain_kernel(
    const int* __restrict__ f, const int* __restrict__ coeffs, const int* __restrict__ pxy,
    int* __restrict__ out, long long n, t381::Schedule s, int E, int edges_only) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  const t381::MillerChain c{f, coeffs, pxy, out, s, edges_only};
  t381::miller_chain<LINE_FMT, P_FMT, F_FMT>(b, c, t381::BlockPhases{E});
}

// The layouts (lines, P, f out): the digit entries' (digits throughout),
// the fused pairing's (word lines, strict P, conj(f) as words), the fused
// Miller loop's as the public miller_loop and the multi-pairings' product
// fold take it (word lines, strict P, f as digits), an unfused
// prepare's lines paired fused (digit lines, strict P, f as digits) and the
// strict engine's (strict lines and P, conj(f) as canonical strict limbs).
using Kernel = void (*)(const int*, const int*, const int*, int*, long long, t381::Schedule,
                        int, int);
const Kernel kDigits = miller_chain_kernel<t381::DIGIT_ROWS, t381::DIGIT_ROWS, t381::DIGIT_ROWS>;
const Kernel kPairing = miller_chain_kernel<t381::WORD_ROWS, t381::LIMB_ROWS, t381::WORD_ROWS>;
const Kernel kFused = miller_chain_kernel<t381::WORD_ROWS, t381::LIMB_ROWS, t381::DIGIT_ROWS>;
const Kernel kDigitLines =
    miller_chain_kernel<t381::DIGIT_ROWS, t381::LIMB_ROWS, t381::DIGIT_ROWS>;
const Kernel kStrict = miller_chain_kernel<t381::LIMB_ROWS, t381::LIMB_ROWS, t381::LIMB_ROWS>;

Kernel kernel_for(int line_fmt, int p_fmt, int f_fmt) {
  if (f_fmt == t381::WORD_ROWS)
    return line_fmt == t381::WORD_ROWS && p_fmt == t381::LIMB_ROWS ? kPairing : nullptr;
  if (f_fmt == t381::LIMB_ROWS)
    return line_fmt == t381::LIMB_ROWS && p_fmt == t381::LIMB_ROWS ? kStrict : nullptr;
  if (f_fmt != t381::DIGIT_ROWS) return nullptr;
  if (line_fmt == t381::DIGIT_ROWS && p_fmt == t381::DIGIT_ROWS) return kDigits;
  if (line_fmt == t381::WORD_ROWS && p_fmt == t381::LIMB_ROWS) return kFused;
  if (line_fmt == t381::DIGIT_ROWS && p_fmt == t381::LIMB_ROWS) return kDigitLines;
  return nullptr;
}

int smem_bytes(int E) { return E * t381::MILLER_SLOTS * t381::SLOT * 4; }

}  // namespace

// The chain at a given shape: E elements and `threads` threads a block
// (threads <= 512); dbl[i] != 0 where event i squares f, for 1 <= events
// <= 128; coeffs of format line_fmt, pxy of format p_fmt
// (t381::EdgeFormat: digits and digits, words and limbs, digits and limbs,
// or limbs and limbs); out of format f_fmt (digits: f; words: conj(f), with
// word lines and strict P only; strict limbs: conj(f), with strict lines
// and P only); f may be null (f = one formed in the kernel). With
// edges_only, the conversions alone (f, P and every line in, out = f: the
// cost of the kernel's edges, for scripts/tower_probe.py). Returns
// cudaGetLastError() after the launch.
extern "C" int pairing_miller_chain_shaped(const int* f, const int* coeffs, const int* pxy,
                                           int* out, long long n, int events,
                                           const unsigned char* dbl, int line_fmt, int p_fmt,
                                           int f_fmt, int E, int threads, int edges_only,
                                           void* stream) {
  t381::Schedule s;
  const Kernel kernel = kernel_for(line_fmt, p_fmt, f_fmt);
  if (!t381::make_schedule(events, dbl, s) || !kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(E));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + E - 1) / E;
  kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes(E),
           static_cast<cudaStream_t>(stream)>>>(f, coeffs, pxy, out, n, s, E, edges_only);
  return static_cast<int>(cudaGetLastError());
}

// f: (12, 30, n) digits or null, coeffs: (events, 6, K, n) of format
// line_fmt, pxy: (2, K', n) of format p_fmt, out: (12, 30, n) digits of f,
// (12, 12, n) words or (12, 24, n) strict limbs of conj(f) by f_fmt; int32, contiguous, on the
// device of `stream`. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int pairing_miller_chain(const int* f, const int* coeffs, const int* pxy, int* out,
                                    long long n, int events, const unsigned char* dbl,
                                    int line_fmt, int p_fmt, int f_fmt, void* stream) {
  return pairing_miller_chain_shaped(f, coeffs, pxy, out, n, events, dbl, line_fmt, p_fmt,
                                     f_fmt, kElems, kThreads, 0, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// fused pairing's build's registers and the shape's shared memory): on
// entry, elems and threads > 0 name the shape, 0 the default, which they
// then hold. Returns the CUDA error of the query (0 on success).
extern "C" int pairing_miller_chain_shape(int* elems, int* threads, int* smem,
                                          int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = kElems;
    *threads = kThreads;
  }
  *smem = smem_bytes(*elems);
  cudaError_t err =
      cudaFuncSetAttribute(kPairing, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kPairing, *threads, *smem));
}
