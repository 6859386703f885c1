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
// and spills the rest to local memory.
#include "lazy13.cuh"

namespace {

constexpr int PT_ROWS = 45;  // packed rows of a projective bucket (x, y, z)

// Complete mixed addition P1 (projective) + P2 (affine), RCB15 Algorithm 7
// with Z2 = 1, lazily reduced: ark_blst_tpu_torch/curves/lazy_group.py:mixed_add.
__device__ __forceinline__ void mixed_add(const int* X1, const int* Y1, const int* Z1,
                                          const int* X2, const int* Y2, int* X3, int* Y3,
                                          int* Z3) {
  using namespace lz;
  int t0[ELEM], t1[ELEM], u1[ELEM], u2[ELEM], m3[ELEM];
  int s1[ELEM], s2[ELEM], tmp[ELEM];
  mont_mul(X1, X2, t0);
  mont_mul(Y1, Y2, t1);
  mont_mul(Y2, Z1, u1);
  mont_mul(X2, Z1, u2);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = X1[k] + Y1[k];
  fold_sum(tmp, s1);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = X2[k] + Y2[k];
  fold_sum(tmp, s2);
  mont_mul(s1, s2, m3);

  int t3[ELEM], t4[ELEM], t0t[ELEM], t2b[ELEM], z3[ELEM], t1m[ELEM], tyb[ELEM];
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = m3[k] - t0[k] - t1[k];
  fold_sum(tmp, t3);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = 3 * t0[k];
  fold_sum(tmp, t0t);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = 12 * Z1[k];
  fold_sum(tmp, t2b);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = t1[k] + t2b[k];
  fold_sum(tmp, z3);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = t1[k] - t2b[k];
  fold_sum(tmp, t1m);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = Y1[k] + u1[k];
  fold_sum(tmp, t4);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = 12 * (X1[k] + u2[k]);
  fold_sum(tmp, tyb);

  // X3 = red(b - a), Y3 = red(d + c), Z3 = red(g + e) with
  // a = t4*tyb, b = t3*t1m, c = tyb*t0t, d = t1m*z3, e = t0t*t3, g = z3*t4
  int w[WIDE], v[WIDE];
  mul_prered(t3, t1m, w);
  mul_prered(t4, tyb, v);
#pragma unroll
  for (int k = 0; k < COLS + 2; ++k) w[k] -= v[k];
  reduce_wide(w, X3);
  mul_prered(t1m, z3, w);
  mul_prered(tyb, t0t, v);
#pragma unroll
  for (int k = 0; k < COLS + 2; ++k) w[k] += v[k];
  reduce_wide(w, Y3);
  mul_prered(z3, t4, w);
  mul_prered(t0t, t3, v);
#pragma unroll
  for (int k = 0; k < COLS + 2; ++k) w[k] += v[k];
  reduce_wide(w, Z3);
}

__global__ void __launch_bounds__(64) bucket_accumulate_kernel(
    const int* __restrict__ pts, const int* __restrict__ digs, const int* __restrict__ ident,
    int* __restrict__ dump, long long n, int W, int B, int S) {
  using namespace lz;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  const int w = static_cast<int>(idx / S);
  const int s = static_cast<int>(idx % S);
  int* base = dump + static_cast<long long>(w) * B * PT_ROWS * S + s;
  for (int b = 0; b < B; ++b)
    for (int r = 0; r < PT_ROWS; ++r) base[(static_cast<long long>(b) * PT_ROWS + r) * S] = ident[r];

  const long long T = n / S;
  const int* dig_row = digs + static_cast<long long>(w) * n;
  for (long long t = 0; t < T; ++t) {
    const long long p = t * S + s;
    const int dig = dig_row[p];
    const int mag = dig & 0x7FFF;
    if (mag == 0) continue;
    int X2[ELEM], Y2[ELEM];
    unpack15(pts + p, n, X2);
    unpack15(pts + (ELEM / 2) * n + p, n, Y2);
    if ((dig >> 15) & 1) {
#pragma unroll
      for (int k = 0; k < ELEM; ++k) Y2[k] = -Y2[k];
    }
    int* bk = base + static_cast<long long>(mag) * PT_ROWS * S;
    int X1[ELEM], Y1[ELEM], Z1[ELEM];
    unpack15(bk, S, X1);
    unpack15(bk + (ELEM / 2) * S, S, Y1);
    unpack15(bk + ELEM * S, S, Z1);
    int X3[ELEM], Y3[ELEM], Z3[ELEM], st[ELEM];
    mixed_add(X1, Y1, Z1, X2, Y2, X3, Y3, Z3);
    store30(X3, st);
    pack30(st, bk, S);
    store30(Y3, st);
    pack30(st, bk + (ELEM / 2) * S, S);
    store30(Z3, st);
    pack30(st, bk + ELEM * S, S);
  }
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
