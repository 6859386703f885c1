// K2-G2: MSM signed-bucket accumulation for G2 on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/curves/msm_pallas2.py:_accumulate2
// (body _make_kernel2.kernel), G2 instance (KC2_G2). Semantics, per window
// w and stream s (point n belongs to stream n mod S, S = 1024):
//   buckets[w, 0..B) <- identity (0 : one : 0) over Fp2
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 negated if sign
//     buckets[w, mag] <- mixed_add(buckets[w, mag], (x2, y2))
//   dump[w, b, :, s] = packed buckets (90 rows: x, y, z, each re then im,
//   15 words of balanced radix-13 digits in the R13 domain a component)
// The dump equals the plain version's (and the TPU kernel's) by value,
// coordinate by coordinate; its redundant digits differ.
//
// What bounds it: operations. One complete mixed addition over Fp2 is 33
// Montgomery products of 12 x 32-bit words (~0.9K instructions each) and
// ~100 modular sums, ~36K instructions, against 192 bytes of point, 4 bytes
// of digit and 576 bytes of bucket traffic.
//
// Design: one thread per (window, stream) looping over the stream's points,
// as the G1 kernel (bucket_accumulate.cu), on the same group code. The field is the 32-bit
// Montgomery layer of fp381.cuh, not the radix-13 digits: an Fp2 value is
// 24 registers instead of 60 and a product ~0.9K instructions instead of
// ~3.7K, so the whole addition is inlined (the compiler still spills part
// of its round-2 state: six Fp2 values live across 128 registers). A first
// small kernel (msm_g2_point_words, one thread per component) converts the
// points to canonical R16 words once; the buckets live in the thread's own
// column of the dump in that form, and the thread converts them to the
// dump's digits in place at the end (group381.cuh).
#include "group381.cuh"

namespace {

// Threads per block and the blocks per SM the register budget is cut for:
// 64 x 8 = 512 threads per SM (<= 128 registers): the 832 blocks of the
// 2^20-point, c = 5 G2 MSM (52 x 1024 threads) take one wave of the 1,056
// block slots of 132 SMs. At 168 or 255 registers (6 or 4 blocks an SM) the
// grid needs 1.05 or 1.58 waves and the kernel ran slower
// (scripts/k2_probe.py --curve g2).
constexpr int kThreads = 64;
constexpr int kMinBlocks = 8;

// The points' packed lazy rows -> canonical R16 words, one thread per
// (component, point): 4 n threads.
__global__ void __launch_bounds__(256) point_words_kernel(const int* __restrict__ pts,
                                                          int* __restrict__ words, long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 4 * n) return;
  const long long comp = idx / n, i = idx % n;
  g381::rows_to_words(pts + comp * g381::FP_ROWS * n + i, n, words + comp * f381::NW * n + i,
                      n);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) bucket_accumulate_g2_kernel(
    const int* __restrict__ words, const int* __restrict__ digs, int* __restrict__ dump,
    long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  g381::accumulate_stream<f381::Fp2>(words, digs, dump, n, B, S, static_cast<int>(idx / S),
                                     static_cast<int>(idx % S));
}

}  // namespace

// pts (60, n) packed affine rows (x re, x im, y re, y im; 15 words each, the
// plain version's input) -> words (48, n), their canonical R16 words.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msm_g2_point_words(const int* pts, int* words, long long n, void* stream) {
  if (n <= 0) return 0;
  point_words_kernel<<<static_cast<unsigned>((4 * n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(pts, words, n);
  return static_cast<int>(cudaGetLastError());
}

// words (48, n) from msm_g2_point_words; digs (W, n) signed digits; dump
// (W, B, 90, S) output. n must be a multiple of S. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int msm_bucket_accumulate_g2(const int* words, const int* digs, int* dump,
                                        long long n, int W, int B, int S, void* stream) {
  if (W <= 0 || S <= 0) return 0;
  const long long total = static_cast<long long>(W) * S;
  const long long blocks = (total + kThreads - 1) / kThreads;
  bucket_accumulate_g2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(words, digs, dump, n, W,
                                                                     B, S);
  return static_cast<int>(cudaGetLastError());
}

// The bucket kernel's launch shape: its threads per block and the blocks an
// SM holds at its register and stack use (the occupancy API). Returns the
// CUDA error of the query (0 on success).
extern "C" int msm_bucket_accumulate_g2_shape(int* threads, int* blocks_per_sm) {
  *threads = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bucket_accumulate_g2_kernel, kThreads, 0));
}
