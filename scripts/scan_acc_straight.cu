// scan-acc's walk with one thread a stream and the complete addition
// written straight through (group381.cuh complete_add, inline, one call
// site), on the same word records as the team walk of
// ark_blst_tpu_torch/csrc/scan_msm.cu: the yardstick that tells the team
// walk's job interpreter (its job tables, shared-memory slots and
// barriers) from the addition's own arithmetic. Not part of the package:
// scripts/scan_acc_probe.py builds it with nvcc for sm_90a and times it
// beside the team shapes; its records must equal the team walk's.
#include "scan_msm.cuh"

namespace {

__device__ __forceinline__ void load_rec(const int* r, f381::Fp& x) {
#pragma unroll
  for (int v = 0; v < f381::NW / 4; ++v) {
    f381::u32 q[4];
    smsm::load4(r + 4 * v, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) x.w[4 * v + k] = q[k];
  }
}

__device__ __forceinline__ void load_rec(const int* r, f381::Fp2& x) {
  load_rec(r, x.c0);
  load_rec(r + f381::NW, x.c1);
}

__device__ __forceinline__ void store_rec(const f381::Fp& x, int* r) { smsm::store_words4(x, r); }

__device__ __forceinline__ void store_rec(const f381::Fp2& x, int* r) {
  smsm::store_words4(x.c0, r);
  smsm::store_words4(x.c1, r + f381::NW);
}

// The team walk's identity stores (a block's threads on one stream's
// records at a time), then a thread a stream: load the bucket and the
// point, complete_add, store the bucket.
template <class F>
__global__ void __launch_bounds__(128) straight_kernel(const int* __restrict__ pw,
                                                       const int* __restrict__ digs, int* bk,
                                                       long long n, int lanes, int W, int B) {
  constexpr int C = g381::NC<F> * f381::NW;  // words of a coordinate
  const long long streams = static_cast<long long>(lanes) * W;
  for (int k = 0; k < static_cast<int>(blockDim.x); ++k) {
    const long long sk = static_cast<long long>(blockIdx.x) * blockDim.x + k;
    if (sk >= streams) break;
    int* base = smsm::stream_buckets<F>(bk, W, B, static_cast<int>(sk % lanes),
                                        static_cast<int>(sk / lanes));
    for (int j = threadIdx.x; j < B * smsm::PV<F>; j += blockDim.x)
      smsm::init_job<F>(base, j);
  }
  __syncthreads();
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  const int l = static_cast<int>(s % lanes), w = static_cast<int>(s / lanes);
  int* base = smsm::stream_buckets<F>(bk, W, B, l, w);
  const int* dig_row = digs + static_cast<long long>(w) * n;
  const long long steps = n / lanes;
#pragma unroll 1
  for (long long t = 0; t < steps; ++t) {
    const long long p = t * lanes + l;
    int* bucket = base + static_cast<long long>(dig_row[p] & (B - 1)) * smsm::PW<F>;
    const int* point = pw + p * smsm::PW<F>;
    F X1, Y1, Z1, X2, Y2, Z2;
    load_rec(bucket, X1);
    load_rec(bucket + C, Y1);
    load_rec(bucket + 2 * C, Z1);
    load_rec(point, X2);
    load_rec(point + C, Y2);
    load_rec(point + 2 * C, Z2);
    g381::complete_add(X1, Y1, Z1, X2, Y2, Z2);
    store_rec(X1, bucket);
    store_rec(Y1, bucket + C);
    store_rec(Z1, bucket + 2 * C);
  }
}

}  // namespace

// The arguments of scan_msm_accumulate, `block` threads a block (a
// stream each, at most 128). Returns cudaGetLastError() after the launch.
extern "C" int scan_acc_straight(const int* pw, const int* digs, int* bk, long long n, int lanes,
                                 int W, int B, int nc, int block, void* stream) {
  if ((nc != 1 && nc != 2) || block < 1 || block > 128 || B < 1 || (B & (B - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>((static_cast<long long>(lanes) * W + block - 1) / block);
  if (nc == 1)
    straight_kernel<f381::Fp><<<grid, block, 0, s>>>(pw, digs, bk, n, lanes, W, B);
  else
    straight_kernel<f381::Fp2><<<grid, block, 0, s>>>(pw, digs, bk, n, lanes, W, B);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `block` threads an SM holds (the occupancy API).
extern "C" int scan_acc_straight_occupancy(int nc, int block, int* blocks_per_sm) {
  const cudaError_t err =
      nc == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, straight_kernel<f381::Fp>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, straight_kernel<f381::Fp2>, block, 0);
  return static_cast<int>(err);
}
