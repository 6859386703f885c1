// scan-acc, scan-red, scan-horner: the strict engine's scan Pippenger MSM
// (curves/msm.py:msm) on Hopper (sm_90a), each of its three scans in one
// launch.
//
// Replace, on the TPU, the lax.scans of ark_blst_tpu/curves/msm.py:138
// _scan over ark_blst_tpu/ops/pallas_field.py:66 _block_call (K7-K10),
// which run inside one compiled program there:
//   scan-acc     :155 _bucket_accumulate, one complete RCB15 addition a
//                step over the whole (lanes x windows) front;
//   scan-red     :199 _bucket_reduce (its scan at :223), the running and
//                total sums over the buckets, highest first;
//   scan-horner  :227 _horner (its fori_loop at :241), c doublings and one
//                addition a window, most significant first.
// The port ran each step as a batch of K7-K10 launches (~30 an addition):
// 76,804 device kernels for the accumulation of a 2^20-point G1 MSM at
// c = 8 over 1,024 lanes. Inputs and outputs are the strict engine's
// (24, ...) limb stacks, canonical, equal to the plain loops
// (ops/scan_msm.py) limb for limb.
//
// What bounds them: operations. A complete addition is 12 Montgomery
// products of 12 x 32-bit words (~0.9K instructions each) and ~20 modular
// sums on G1, 36 products on G2. scan-acc makes one addition per point and
// window (2^20 x 32 on G1 at c = 8: ~11 ms at the card's instruction rate)
// against a bucket read and written per addition (~9.7 GB as words on
// G1). scan-red's window walks 2 (2^c - 1) and scan-horner's W (c + 1)
// dependent group operations: the latency of one chain, milliseconds at
// any width.
//
// Design (scan_msm.cuh): one thread a chain -- a (lane, window) stream in
// scan-acc, a window in scan-red, the whole walk in scan-horner -- the
// running points in registers as canonical words. scan-acc keeps the
// buckets in its output, in words in the first 12 of each component's 24
// limb rows, indexed directly by the digit, and splits them into limbs in
// place at the end, as K2 keeps its buckets in its dump; neighbouring
// threads take neighbouring lanes, so the point and digit loads coalesce.
// At 32,768 streams (G1) and 8,192 (G2) the card holds a few warps an SM:
// latency-bound, far from the bound; a team of threads a stream is the
// later lever.
#include "scan_msm.cuh"

namespace {

constexpr int kThreads = 64;

template <class F>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(const int* __restrict__ pts,
                                                              const int* __restrict__ digs,
                                                              int* __restrict__ out, long long n,
                                                              int lanes, int W, int B) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(lanes) * W) return;
  smsm::accumulate_stream<F>(pts, digs, out, n, lanes, W, B, static_cast<int>(idx % lanes),
                             static_cast<int>(idx / lanes));
}

template <class F>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const int* __restrict__ bk,
                                                          int* __restrict__ out, int W, int B) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < W) smsm::reduce_window<F>(bk, out, W, B, w);
}

template <class F>
__global__ void __launch_bounds__(32) horner_kernel(const int* __restrict__ sums,
                                                    int* __restrict__ out, int W, int c) {
  if (blockIdx.x == 0 && threadIdx.x == 0) smsm::horner_walk<F>(sums, out, W, c);
}

int blocks(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, 0);
}

}  // namespace

// pts (3 nc, 24, n) strict limbs of the points (nc = 1 on G1, 2 on G2),
// digs (W, n) window digits below B, out (3 nc, 24, lanes, W, B): the
// buckets as strict limbs. n must be a multiple of lanes. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int scan_msm_accumulate(const int* pts, const int* digs, int* out, long long n,
                                   int lanes, int W, int B, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0 || W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks(static_cast<long long>(lanes) * W);
  if (nc == 1)
    accumulate_kernel<f381::Fp><<<grid, kThreads, 0, s>>>(pts, digs, out, n, lanes, W, B);
  else
    accumulate_kernel<f381::Fp2><<<grid, kThreads, 0, s>>>(pts, digs, out, n, lanes, W, B);
  return static_cast<int>(cudaGetLastError());
}

// bk (3 nc, 24, W, B) strict limbs -> out (3 nc, 24, W), the window sums.
extern "C" int scan_msm_reduce(const int* bk, int* out, int W, int B, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 1)
    reduce_kernel<f381::Fp><<<blocks(W), kThreads, 0, s>>>(bk, out, W, B);
  else
    reduce_kernel<f381::Fp2><<<blocks(W), kThreads, 0, s>>>(bk, out, W, B);
  return static_cast<int>(cudaGetLastError());
}

// sums (3 nc, 24, W) strict limbs -> out (3 nc, 24, 1), Horner at window c.
extern "C" int scan_msm_horner(const int* sums, int* out, int W, int c, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 1)
    horner_kernel<f381::Fp><<<1, 32, 0, s>>>(sums, out, W, c);
  else
    horner_kernel<f381::Fp2><<<1, 32, 0, s>>>(sums, out, W, c);
  return static_cast<int>(cudaGetLastError());
}

// A chain's launch shape: kind 0 scan-acc, 1 scan-red, 2 scan-horner, on
// G1 (nc = 1) or G2 (nc = 2): its threads a block and the blocks an SM
// holds at its registers and stack (the occupancy API). Returns the CUDA
// error of the query (0 on success).
extern "C" int scan_msm_shape(int kind, int nc, int* threads, int* blocks_per_sm) {
  if ((nc != 1 && nc != 2) || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  *threads = kind == 2 ? 32 : kThreads;
  cudaError_t err;
  if (kind == 0)
    err = nc == 1 ? occupancy(accumulate_kernel<f381::Fp>, *threads, blocks_per_sm)
                  : occupancy(accumulate_kernel<f381::Fp2>, *threads, blocks_per_sm);
  else if (kind == 1)
    err = nc == 1 ? occupancy(reduce_kernel<f381::Fp>, *threads, blocks_per_sm)
                  : occupancy(reduce_kernel<f381::Fp2>, *threads, blocks_per_sm);
  else
    err = nc == 1 ? occupancy(horner_kernel<f381::Fp>, *threads, blocks_per_sm)
                  : occupancy(horner_kernel<f381::Fp2>, *threads, blocks_per_sm);
  return static_cast<int>(err);
}
