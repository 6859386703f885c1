// K2: MSM signed-bucket accumulation for G1 on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/curves/msm_pallas2.py:_accumulate2
// (body _make_kernel2.kernel), G1 instance (KC2_G1). Semantics, per window
// w and stream s (point n belongs to stream n mod S, S = 1024):
//   buckets[w, 0..B) <- identity (0 : one : 0)
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 negated if sign
//     buckets[w, mag] <- mixed_add(buckets[w, mag], (x2, y2))
//   dump[w, b, :, s] = packed buckets (45 rows: x, y, z, 15 words of
//   balanced radix-13 digits in the R13 domain each)
// The dump equals the plain version's (and the TPU kernel's) by value,
// coordinate by coordinate; its redundant digits differ.
//
// What bounds it: operations. One complete mixed addition is 11 Montgomery
// products of 12 x 32-bit words (~0.9K instructions each) and 21 modular
// sums, ~11.4K instructions, against 96 bytes of point, 4 bytes of digit
// and 288 bytes of bucket traffic.
//
// Design: K2-G2's (bucket_accumulate_g2.cu), on the same group code
// (group381.cuh, instantiated over Fp): one thread per (window, stream)
// looping over the stream's points. On the TPU the tile axis of the grid
// runs in order and the buckets persist in VMEM across it; on the card
// blocks run in no order, so that axis is a loop, and the buckets live in
// global memory, indexed directly by the digit: the TPU's one-hot gather
// is not needed. The field is the 32-bit Montgomery layer of fp381.cuh, not
// the radix-13 digits: an Fp value is 12 registers instead of 30 and a
// product ~0.9K instructions instead of ~3.7K. A first small kernel
// (msm_g1_point_words, one thread per component) converts the points to
// canonical R16 words once; the buckets live in the thread's own column of
// the dump in that form (36 of its 45 rows), and the thread converts them
// to the dump's digits in place at the end.
#include "group381.cuh"

namespace {

// Threads per block and the blocks per SM the register budget is cut for.
// The grid is small: the 2^22-point, c = 7 G1 MSM has 37 x 1024 threads,
// 592 blocks of 64, which one wave of 132 SMs holds at 5 blocks an SM
// (660 slots, <= 204 registers a thread): no need to squeeze the addition
// into 128 registers as K2-G2 must.
constexpr int kThreads = 64;
constexpr int kMinBlocks = 5;

// The points' packed lazy rows -> canonical R16 words, one thread per
// (component, point): 2 n threads.
__global__ void __launch_bounds__(256) point_words_kernel(const int* __restrict__ pts,
                                                          int* __restrict__ words, long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  const long long comp = idx / n, i = idx % n;
  g381::rows_to_words(pts + comp * g381::FP_ROWS * n + i, n, words + comp * f381::NW * n + i,
                      n);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) bucket_accumulate_kernel(
    const int* __restrict__ words, const int* __restrict__ digs, int* __restrict__ dump,
    long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  g381::accumulate_stream<f381::Fp>(words, digs, dump, n, B, S, static_cast<int>(idx / S),
                                    static_cast<int>(idx % S));
}

}  // namespace

// pts (30, n) packed affine rows (x, y; 15 words each, the plain version's
// input) -> words (24, n), their canonical R16 words. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int msm_g1_point_words(const int* pts, int* words, long long n, void* stream) {
  if (n <= 0) return 0;
  point_words_kernel<<<static_cast<unsigned>((2 * n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(pts, words, n);
  return static_cast<int>(cudaGetLastError());
}

// words (24, n) from msm_g1_point_words; digs (W, n) signed digits; dump
// (W, B, 45, S) output. n must be a multiple of S. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int msm_bucket_accumulate(const int* words, const int* digs, int* dump, long long n,
                                     int W, int B, int S, void* stream) {
  if (W <= 0 || S <= 0) return 0;
  const long long total = static_cast<long long>(W) * S;
  const long long blocks = (total + kThreads - 1) / kThreads;
  bucket_accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(words, digs, dump, n, W, B,
                                                                  S);
  return static_cast<int>(cudaGetLastError());
}

// The bucket kernel's launch shape: its threads per block and the blocks an
// SM holds at its register and stack use (the occupancy API). Returns the
// CUDA error of the query (0 on success).
extern "C" int msm_bucket_accumulate_shape(int* threads, int* blocks_per_sm) {
  *threads = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bucket_accumulate_kernel, kThreads, 0));
}
