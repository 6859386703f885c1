// FE-easy and FE-hard: the fused final exponentiation of the pairing on
// Hopper (sm_90a), each part in one launch.
//
// Replace the final exponentiation that the TPU runs inside one compiled
// program (ark_blst_tpu/curves/pairing.py:388-467, cyclotomic_exp_x_conj
// and final_exp with fuse=True), where its Pallas kernels
// ark_blst_tpu/ops/pallas_lazy.py:149 cyc_sqr_stacked (the ladders' runs of
// cyclotomic squares), :63 tower_fused as mul12 (the fp12 products) and :41
// mont_mul_stacked (the inverse's Fermat ladder and the Frobenius maps'
// products, through the lazy tower) run between XLA's own ops. The port had
// launched each of those once (32 K3, 37 K4, 36 K1 and one K1-inv a batch)
// with ~2,700 launches of eager radix-13 glue between them; here:
//   FE-easy  f (12, 30, N) digits, (12, 12, N) words as the fused
//            pairing's K6-chain stores them, or (12, 24, N) strict limbs as
//            the strict engine's K6-chain stores them -> t2 = (conj(f)
//            f^-1)^(p^2 + 1) as (12, 12, N) words;
//   FE-hard  t2 (words) -> the hard part as (12, 30, N) digits within
//            4096, or as the strict (12, 24, N) limbs the pairing returns
//            (so the lazy egress, ~900 eager launches, does not run): five
//            ladders of x (63 squares and 5 products each), two lone
//            squares, ten products, three Frobenius maps.
// The outputs equal the plain versions (ops/final_exp.py: easy_plain,
// hard_plain, the same chain over K3's and K4's plain versions on digits)
// by canonical value; the limbs are canonical, so equal them limb for limb.
// The strict engine's final exponentiation (curves/pairing.py:422-467 with
// engine="strict": the x-ladders' fori_loops and the chain over the strict
// tower, every op a pallas_field.py:66 _block_call) is the same pair of
// launches on its strict limbs: FE-easy loading them, FE-hard storing them.
//
// What bounds them: operations. FE-hard makes 317 cyclotomic squares (18
// Montgomery products of 12 x 32-bit words and ~107 modular sums each) and
// 35 fp12 products (54 and ~224) an element against ~1 KB of digits in and
// out; its values t0-t6 stay as words in an L2-resident scratch stack
// (576 bytes an element a value). FE-easy makes ~250 products and one
// inversion of an Fp norm, one job an element: at the pairing's widths
// that job's latency bounds it.
//
// Design (final_exp.cuh on tower381.cuh): each element's state lives in
// shared memory as canonical Montgomery words; a block holds E elements,
// and its threads run each step as phases of independent jobs with a
// barrier between. FE-easy: K4's 30 Fp2 slots (2,880 bytes), Fp2 jobs on
// K4's product tables, the norm inverted by the binary GCD of fp_inv.cuh
// (finv::inverse, as K1-inv and K7-inv: ~56K instructions where the Fermat
// ladder ran 608 dependent products). FE-hard walks a host-built program of
// the hard part (ops/final_exp.py: HARD_PROGRAM), the list its plain
// version walks on digits, in 72 Fp slots (3,456 bytes), each job one Fp
// value: a square's 18 Fp products (the nine Fp2 squares' components) in
// one phase and its 12 components' recombination (3 T -+ 2 a as T + 2 (T
// -+ a)) in the next; an fp12 product's 54 Karatsuba legs in two phases
// (36 and 18, the second writing over the halves of A and B the first
// finished with), t0-t2 from the legs, the result, a move into A; the
// Frobenius maps an Fp component a job. K3's and K4's Fp2 jobs ran two or
// three products a job and recombined in chains of up to 22 Fp sums; here a
// block's phase costs the issue of its products when the block is full, and
// one product and its operand sums when it holds one element
// (scripts/fe_hard_probe.py splits the time by phase kind; PERF.md). So
// the block holds as many elements as spread the batch over the SMs, and
// runs jobs for those in the batch alone. Tensor cores do not apply: a
// 384-bit modular product has no wgmma form here; the IMAD pipe carries
// the products.
#include "final_exp.cuh"

namespace {

// The launch shapes: E elements a block. FE-easy's threads are K4's (six an
// element: its phases are products of up to 18 jobs an element), bounded
// for two blocks an SM, as many as shared memory holds at E = 32; FE-hard's
// follow the batch (final_exp.cuh hard_elems: E up to 32, 18 E threads),
// bounded for FE_HARD_THREADS threads and FE_HARD_MIN_BLOCKS blocks an SM
// (scripts/tower_probe.py --fe builds it at other bounds and times it).
// Each kernel is instantiated for the edge formats its callers use
// (tower381.cuh EdgeFormat): FE-easy's input digits, words or strict
// limbs, FE-hard's output digits or strict limbs.
constexpr int kEasyThreads = 192;
constexpr int kEasyMinBlocks = 2;
constexpr int kEasyElems = 32;

template <int IN_FMT>
__global__ void __launch_bounds__(kEasyThreads, kEasyMinBlocks) easy_kernel(
    const int* __restrict__ f, int* __restrict__ out, const int* __restrict__ frob, long long n,
    int E) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  fexp::easy_chain<IN_FMT>(b, fexp::EasyChain{f, out, frob}, t381::BlockPhases{E});
}

// FE-hard: the phases' jobs of the block's elements in the batch alone
// (BlockPhases numbers the jobs over them; the slots keep the stride E).
template <int OUT_FMT>
__global__ void __launch_bounds__(FE_HARD_THREADS, FE_HARD_MIN_BLOCKS) hard_kernel(
    fexp::HardChain c, long long n, int E) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  fexp::hard_chain<OUT_FMT>(b, c, t381::BlockPhases{fexp::active_elems(b)});
}

using EasyKernel = void (*)(const int*, int*, const int*, long long, int);
using HardKernel = void (*)(fexp::HardChain, long long, int);
const EasyKernel kEasyDigits = easy_kernel<t381::DIGIT_ROWS>;
const EasyKernel kEasyWords = easy_kernel<t381::WORD_ROWS>;
const EasyKernel kEasyLimbs = easy_kernel<t381::LIMB_ROWS>;
const HardKernel kHardDigits = hard_kernel<t381::DIGIT_ROWS>;
const HardKernel kHardLimbs = hard_kernel<t381::LIMB_ROWS>;

EasyKernel easy_for(int in_fmt) {
  return in_fmt == t381::DIGIT_ROWS ? kEasyDigits
         : in_fmt == t381::WORD_ROWS ? kEasyWords
         : in_fmt == t381::LIMB_ROWS ? kEasyLimbs
                                     : nullptr;
}

HardKernel hard_for(int out_fmt) {
  return out_fmt == t381::DIGIT_ROWS ? kHardDigits
         : out_fmt == t381::LIMB_ROWS ? kHardLimbs
                                      : nullptr;
}

int easy_smem_bytes(int E) { return E * fexp::SLOTS * t381::SLOT * 4; }

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename Kernel>
int shape_of(Kernel kernel, int default_elems, int default_threads, int (*smem_of)(int),
             int* elems, int* threads, int* smem, int* blocks_per_sm) {
  if (*elems <= 0 || *threads <= 0) {
    *elems = default_elems;
    *threads = default_threads;
  }
  *smem = smem_of(*elems);
  const int err = prepare(kernel, *smem);
  if (err) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, *threads, *smem));
}

}  // namespace

// FE-easy: f of format in_fmt ((12, 30, n) digits, (12, 12, n) words or
// (12, 24, n) strict limbs; t381::EdgeFormat), out: (12, 12, n) words, frob: (3, 6, 2, 12) words
// (ops/final_exp.py:FROB_WORDS); int32, contiguous, on the device of
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int final_exp_easy(const int* f, int* out, const int* frob, long long n,
                              int in_fmt, void* stream) {
  const EasyKernel kernel = easy_for(in_fmt);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int err = prepare(kernel, easy_smem_bytes(kEasyElems));
  if (err) return err;
  kernel<<<static_cast<unsigned>((n + kEasyElems - 1) / kEasyElems), kEasyThreads,
           easy_smem_bytes(kEasyElems), static_cast<cudaStream_t>(stream)>>>(f, out, frob, n,
                                                                         kEasyElems);
  return static_cast<int>(cudaGetLastError());
}

// FE-hard at a given shape (threads <= FE_HARD_THREADS). in: value 0, the
// (12, 12, n) words of FE-easy; scratch: (values - 1, 12, 12, n) words;
// out: (12, 30, n) digits or (12, 24, n) strict limbs by out_fmt
// (t381::EdgeFormat); prog: nops ops of four int32
// (ops/final_exp.py:HARD_PROGRAM); frob as for FE-easy. Returns
// cudaGetLastError() after the launch.
extern "C" int final_exp_hard_shaped(const int* in, int* scratch, int* out,
                                     long long n, const int* prog, int nops, const int* frob,
                                     int out_fmt, int E, int threads, void* stream) {
  const HardKernel kernel = hard_for(out_fmt);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int err = prepare(kernel, fexp::hard_smem_bytes(E));
  if (err) return err;
  const fexp::HardChain c{in, scratch, out, prog, nops, frob};
  kernel<<<static_cast<unsigned>((n + E - 1) / E), threads, fexp::hard_smem_bytes(E),
           static_cast<cudaStream_t>(stream)>>>(c, n, E);
  return static_cast<int>(cudaGetLastError());
}

static int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// FE-hard at the shape for n elements (fexp::hard_elems on this card's SMs).
extern "C" int final_exp_hard(const int* in, int* scratch, int* out, long long n,
                              const int* prog, int nops, const int* frob, int out_fmt,
                              void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaGetLastError());
  const int E = fexp::hard_elems(n, sms);
  return final_exp_hard_shaped(in, scratch, out, n, prog, nops, frob, out_fmt, E,
                               fexp::HARD_THREADS_PER_ELEM * E, stream);
}

// A launch shape and the blocks an SM holds at it (the occupancy API at the
// fused pairing's builds' registers, FE-easy on words and FE-hard to limbs,
// and the shape's shared memory): on entry, elems and threads > 0 name the
// shape, 0 the default, which they then hold (FE-hard's for n elements,
// final_exp_hard's). Return the CUDA error of the query (0 on success).
extern "C" int final_exp_easy_shape(int* elems, int* threads, int* smem, int* blocks_per_sm) {
  return shape_of(kEasyWords, kEasyElems, kEasyThreads, easy_smem_bytes, elems, threads, smem,
                  blocks_per_sm);
}

extern "C" int final_exp_hard_shape(int n, int* elems, int* threads, int* smem,
                                    int* blocks_per_sm) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaGetLastError());
  const int E = fexp::hard_elems(n, sms);
  return shape_of(kHardLimbs, E, fexp::HARD_THREADS_PER_ELEM * E, fexp::hard_smem_bytes, elems,
                  threads, smem, blocks_per_sm);
}
