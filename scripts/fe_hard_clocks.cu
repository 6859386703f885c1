// FE-hard (final_exp.cuh hard_chain) with each phase timed: the same body
// as ark_blst_tpu_torch/csrc/final_exp.cu launches, at the same launch
// bound, under a phase runner that records, in block 0, the SM clocks from
// the end of one barrier to the end of the next (clock64 on thread 0) and
// sums them by the phase's kind (fexp::HardKind, which hard_chain names
// before each phase). Not part of the package: scripts/fe_hard_probe.py
// builds it with nvcc for sm_90a and prints the split.
#include "final_exp.cuh"

namespace {

// t381::BlockPhases over the block's E elements in the batch, each phase
// clocked into acc (block 0's; null in the other blocks): acc[k] the
// clocks of kind k, acc[HK_KINDS + k] its phases.
struct ClockPhases {
  int E;
  long long* acc;
  mutable int k;
  mutable long long t;
  __device__ __forceinline__ void kind(int kk) const { k = kk; }
  template <class Job>
  __device__ __forceinline__ void operator()(int ops, const Job& job) const {
    const int jobs = ops * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x) job(j / E, j % E);
    __syncthreads();
    if (acc && threadIdx.x == 0) {
      const long long now = clock64();
      acc[k] += now - t;
      acc[fexp::HK_KINDS + k] += 1;
      t = now;
    }
  }
};

// acc: 2 HK_KINDS + 1 counters, zeroed by the caller; the last one the
// walk's clocks from its first phase's start to its last barrier.
template <int OUT_FMT>
__global__ void __launch_bounds__(FE_HARD_THREADS, FE_HARD_MIN_BLOCKS)
    hard_clocks(fexp::HardChain c, long long n, int E, long long* acc) {
  extern __shared__ t381::u32 smem[];
  const t381::Block b{smem, E, static_cast<long long>(blockIdx.x) * E, n};
  __syncthreads();
  const long long t0 = clock64();
  const ClockPhases ph{fexp::active_elems(b), blockIdx.x == 0 ? acc : nullptr, 0, t0};
  fexp::hard_chain<OUT_FMT>(b, c, ph);
  if (blockIdx.x == 0 && threadIdx.x == 0) acc[2 * fexp::HK_KINDS] = clock64() - t0;
}

}  // namespace

// FE-hard's entry (final_exp_hard: the library's shape for n elements on
// `sms` SMs) with block 0's clocks by phase kind into acc; out_fmt 0
// digits, 1 strict limbs.
extern "C" int fe_hard_clocks(const int* in, int* scratch, int* out, long long n, const int* prog,
                              int nops, const int* frob, int out_fmt, int sms, long long* acc,
                              void* stream) {
  if (n <= 0 || sms <= 0 || (out_fmt != t381::DIGIT_ROWS && out_fmt != t381::LIMB_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int E = fexp::hard_elems(n, sms);
  const int smem = fexp::hard_smem_bytes(E);
  const fexp::HardChain c{in, scratch, out, prog, nops, frob};
  const auto kernel = out_fmt == t381::LIMB_ROWS ? hard_clocks<t381::LIMB_ROWS>
                                                 : hard_clocks<t381::DIGIT_ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>((n + E - 1) / E), fexp::HARD_THREADS_PER_ELEM * E, smem,
           static_cast<cudaStream_t>(stream)>>>(c, n, E, acc);
  return static_cast<int>(cudaGetLastError());
}
