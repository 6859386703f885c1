// K2 over Fp2: MSM signed-bucket accumulation for G2 on Hopper (sm_90a).
//
// Replaces the TPU kernel ark_blst_tpu/curves/msm_pallas2.py:_accumulate2
// (body _make_kernel2.kernel), G2 instance (KC2_G2). Semantics, per window
// w and stream s (point n belongs to stream n mod S, S = 1024):
//   buckets[w, 0..B) <- identity (0 : one : 0) over Fp2
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, both components of y2 negated if sign
//     buckets[w, mag] <- store30(mixed_add(buckets[w, mag], (x2, y2)))
//   dump[w, b, :, s] = packed buckets (90 rows: x, y, z, each re then im,
//   15 words a component)
//
// What bounds it: operations. One complete mixed addition over Fp2 is 33
// products (11 Karatsuba triples) with 16 reductions, ~90K int32
// instructions, against 240 bytes of point, 4 bytes of digit and 720 bytes
// of bucket traffic.
//
// Design: the G1 kernel's (bucket_accumulate.cu), one thread per (window,
// stream) looping over the stream's points, buckets in the dump indexed by
// the digit. The addition calls one out-of-line product and one
// out-of-line reduction through the Fp2 helpers of group13.cuh, so the
// library holds one copy of each instead of 33 and 16; the thread's
// operands live in local memory between the calls.
#include "group13.cuh"

namespace {

__global__ void __launch_bounds__(64) bucket_accumulate_g2_kernel(
    const int* __restrict__ pts, const int* __restrict__ digs, const int* __restrict__ ident,
    int* __restrict__ dump, long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  gp::accumulate_stream<2>(pts, digs, ident, dump, n, B, S, static_cast<int>(idx / S),
                           static_cast<int>(idx % S));
}

}  // namespace

// pts (60, n) packed affine rows; digs (W, n) signed digits; ident (90,)
// packed identity rows; dump (W, B, 90, S) output. n must be a multiple
// of S. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int msm_bucket_accumulate_g2(const int* pts, const int* digs, const int* ident,
                                        int* dump, long long n, int W, int B, int S,
                                        void* stream) {
  if (W <= 0 || S <= 0) return 0;
  constexpr int threads = 64;
  const long long total = static_cast<long long>(W) * S;
  const long long blocks = (total + threads - 1) / threads;
  bucket_accumulate_g2_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(pts, digs, ident, dump,
                                                                     n, W, B, S);
  return static_cast<int>(cudaGetLastError());
}
