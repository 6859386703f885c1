// scan-red's and scan-horner's team walks (scan_msm.cuh reduce_team,
// horner_team) with each phase timed: the same bodies as
// ark_blst_tpu_torch/csrc/scan_msm.cu launches, under a team that records,
// in block 0, the SM clocks from a phase's start to the end of its barrier
// (clock64 on thread 0). Not part of the package:
// scripts/scan_red_probe.py builds it with nvcc for sm_90a and splits each
// walk's time over its phases (products, sums, the column's refills).
#include "scan_msm.cuh"

namespace {

// scan_msm.cu's BlockTeam (products on threads 0 .. size - 1, sums spread
// over the block's warps), each phase clocked.
struct ClockTeam {
  int rank, size;
  long long* clocks;  // block 0's phase clocks, or null
  int cap, n;
  __device__ __forceinline__ void done(long long t0) {
    __syncthreads();
    if (clocks && threadIdx.x == 0 && n < cap) clocks[n] = clock64() - t0;
    ++n;
  }
  template <class Job>
  __device__ __forceinline__ void phase(int jobs, Job job) {
    const long long t0 = clock64();
    if (rank < size)
      for (int j = rank; j < jobs; j += size) job(j);
    done(t0);
  }
  template <class Job>
  __device__ __forceinline__ void spread(int jobs, int ways, Job job) {
    const long long t0 = clock64();
    const int warps = blockDim.x / 32, w = threadIdx.x / 32;
    const int lanes = warps > 0 ? 32 : static_cast<int>(blockDim.x);
    if (ways > (warps > 0 ? warps : 1)) ways = warps > 0 ? warps : 1;
    if (w < ways)
      for (int j = w + ways * static_cast<int>(threadIdx.x % 32); j < jobs; j += lanes * ways)
        job(j);
    done(t0);
  }
};

template <class F>
__global__ void red_clocks(const int* __restrict__ bk, int* __restrict__ out, int W, int B,
                           int team, int column, long long* clocks, int cap) {
  extern __shared__ f381::u32 smem[];
  ClockTeam tm{static_cast<int>(threadIdx.x), team, blockIdx.x == 0 ? clocks : nullptr, cap, 0};
  const smsm::TeamMem m{smem, 1};
  smsm::reduce_team<F>(tm, m, smem + smsm::RED_SLOTS<F> * f381::NW, column, bk, out, W, B,
                       blockIdx.x);
}

template <class F>
__global__ void horner_clocks(const int* __restrict__ sums, int* __restrict__ out, int W, int c,
                              int team, long long* clocks, int cap) {
  extern __shared__ f381::u32 smem[];
  ClockTeam tm{static_cast<int>(threadIdx.x), team, clocks, cap, 0};
  const smsm::TeamMem m{smem, 1};
  smsm::horner_team<F>(tm, m, smem + smsm::HORNER_SLOTS<F> * f381::NW, sums, out, W, c);
}

template <class Kernel>
cudaError_t allow(Kernel kernel, long long smem) {
  return smem <= 48 * 1024 ? cudaSuccess
                           : cudaFuncSetAttribute(kernel,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(smem));
}

template <class F>
cudaError_t run(int which, const int* in, int* out, int W, int n, int team, int block,
                int column, long long* clocks, int cap, cudaStream_t s) {
  if (which == 0) {
    const long long smem = 4LL * (smsm::RED_SLOTS<F> * f381::NW +
                                  static_cast<long long>(column) * smsm::PW<F>);
    cudaError_t err = allow(red_clocks<F>, smem);
    if (err != cudaSuccess) return err;
    red_clocks<F><<<W, block, smem, s>>>(in, out, W, n, team, column, clocks, cap);
  } else {
    const long long smem =
        4LL * (smsm::HORNER_SLOTS<F> * f381::NW + static_cast<long long>(W) * smsm::PW<F>);
    cudaError_t err = allow(horner_clocks<F>, smem);
    if (err != cudaSuccess) return err;
    horner_clocks<F><<<1, block, smem, s>>>(in, out, W, n, team, clocks, cap);
  }
  return cudaGetLastError();
}

}  // namespace

// which 0: scan-red on (3 nc, 24, W, n) buckets, a block of `block`
// threads a window (products on `team` of them), a column of `column`
// buckets; which 1: scan-horner on (3 nc, 24, W) sums at c = n, one block.
// clocks: the first `cap` phases of block 0.
extern "C" int scan_chain_clocks(int which, const int* in, int* out, int W, int n, int nc,
                                 int team, int block, int column, long long* clocks, int cap,
                                 void* stream) {
  if ((nc != 1 && nc != 2) || team < 1 || block < team || block > 1024 || column < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nc == 1 ? run<f381::Fp>(which, in, out, W, n, team, block, column, clocks, cap, s)
              : run<f381::Fp2>(which, in, out, W, n, team, block, column, clocks, cap, s);
  return static_cast<int>(err);
}
