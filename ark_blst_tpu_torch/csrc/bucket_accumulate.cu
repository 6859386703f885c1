// K2: MSM signed-bucket accumulation for G1 on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/curves/msm_pallas2.py:_accumulate2
// (body _make_kernel2.kernel), G1 instance. Semantics, per window w and
// stream s (point n belongs to stream n mod S, S = 1024):
//   buckets[w, 0..B) <- identity (0 : one : 0)
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 negated if sign
//     buckets[w, mag] <- store30(mixed_add(buckets[w, mag], (x2, y2)))
//   dump[w, b, :, s] = packed buckets (45 rows: x, y, z of 15 words each)
//
// What bounds it: operations. One complete mixed addition is 11 Montgomery
// products with 8 reductions, ~37K int32 instructions, against 120 bytes of
// point, 4 bytes of digit and 360 bytes of bucket traffic.
//
// Design: one thread per (window, stream), looping over the stream's
// points INSIDE the thread. On the TPU the tile axis of the grid runs in
// order and the buckets persist in VMEM across it; on the card blocks run
// in no order, so that axis is a loop, and the buckets live in global
// memory (the output dump itself), indexed directly by the digit: the
// TPU's one-hot gather is not needed. Point and digit reads are coalesced
// across a warp (neighbouring streams); bucket reads and writes are
// scattered by digit. The mixed addition keeps its operands in registers
// and spills the rest to local memory. The per-thread body and the
// addition are in group13.cuh.
#include "group13.cuh"

namespace {

__global__ void __launch_bounds__(64) bucket_accumulate_kernel(
    const int* __restrict__ pts, const int* __restrict__ digs, const int* __restrict__ ident,
    int* __restrict__ dump, long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  gp::accumulate_stream(pts, digs, ident, dump, n, B, S, static_cast<int>(idx / S),
                           static_cast<int>(idx % S));
}

}  // namespace

// pts (30, n) packed affine rows; digs (W, n) signed digits; ident (45,)
// packed identity rows; dump (W, B, 45, S) output. n must be a multiple
// of S. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msm_bucket_accumulate(const int* pts, const int* digs, const int* ident,
                                     int* dump, long long n, int W, int B, int S,
                                     void* stream) {
  if (W <= 0 || S <= 0) return 0;
  constexpr int threads = 64;
  const long long total = static_cast<long long>(W) * S;
  const long long blocks = (total + threads - 1) / threads;
  bucket_accumulate_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(pts, digs, ident, dump, n,
                                                                  W, B, S);
  return static_cast<int>(cudaGetLastError());
}
