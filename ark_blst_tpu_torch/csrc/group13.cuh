// Device functions of the G1 MSM bucket kernel (K2): the complete mixed
// addition of RCB15 over Fp and the per-thread body, the accumulation of
// one (window, stream). (The G2 kernel runs on the 32-bit layer of
// group381.cuh.)
//
// Every function mirrors ark_blst_tpu_torch/curves/lazy_group.py:mixed_add
// with FP_LAZY and curves/msm_bucket.py:accumulate_plain, digit for digit:
// the same products, the same linear combinations before each reduction
// and the same folds. The order in which independent products are computed
// does not matter (the columns are exact integer sums); where each fold and
// each reduction falls does.
//
// Integer discipline (no signed int32 operation overflows, so the C++ has
// no undefined behaviour and gives PyTorch's int32 digits):
// * inputs have |digit| <= 8191 (a stored bucket or point has |d| <= 4129,
//   the host check also feeds canonical 8191s); fold_sum outputs have
//   |d| <= 4096 + 36, reductions |d| <= 4129 (lazy13.cuh);
// * every product operand is such a digit, so columns stay <= 30 * 8191^2
//   = 2.01e9 < 2^31 and prered digits within 4129 + 1;
// * a round-2 output adds two prered wides, so reduce_wide takes
//   |d| <= 2 * 4130, and its first fold brings that back to 4096 + 4 before
//   any product by a constant digit (<= 30 * 4100 * 8191 = 1.01e9);
// * the mul_b3 sum 12 * (X1 + u2) <= 12 * 12,320 = 147,840; the glue
//   between the rounds stays below 3 * 8191.
#pragma once

#include "lazy13.cuh"

namespace gp {

using lz::ELEM;
using lz::fold_sum;

constexpr int FP_ROWS = ELEM / 2;  // packed rows of one Fp component

// A component's digits -> its 15 packed rows, stored as store30 leaves them.
__device__ __forceinline__ void store(const int* x, int* dst, long long stride) {
  int st[ELEM];
  lz::store30(x, st);
  lz::pack30(st, dst, stride);
}

// Complete mixed addition P1 (projective) + P2 (affine), RCB15 Algorithm 7
// with Z2 = 1, lazily reduced.
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

// --- the kernels' per-thread body -------------------------------------------

// Accumulate window w, stream s (point p belongs to stream p mod S):
//   buckets[w, 0..B) <- identity (0 : one : 0)
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 negated if sign
//     buckets[w, mag] <- store30(mixed_add(buckets[w, mag], (x2, y2)))
// pts (30, n) packed affine rows; digs (W, n); ident (45,) packed identity
// rows; dump (W, B, 45, S), 15 rows a coordinate. The buckets live in the
// dump, indexed by the digit.
__device__ __forceinline__ void accumulate_stream(const int* __restrict__ pts,
                                                  const int* __restrict__ digs,
                                                  const int* __restrict__ ident,
                                                  int* __restrict__ dump, long long n, int B,
                                                  int S, int w, int s) {
  constexpr int PT_ROWS = 3 * FP_ROWS;
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
    lz::unpack15(pts + p, n, X2);
    lz::unpack15(pts + FP_ROWS * n + p, n, Y2);
    if ((dig >> 15) & 1) {
#pragma unroll
      for (int k = 0; k < ELEM; ++k) Y2[k] = -Y2[k];
    }
    int* bk = base + static_cast<long long>(mag) * PT_ROWS * S;
    int X1[ELEM], Y1[ELEM], Z1[ELEM], X3[ELEM], Y3[ELEM], Z3[ELEM];
    lz::unpack15(bk, S, X1);
    lz::unpack15(bk + FP_ROWS * S, S, Y1);
    lz::unpack15(bk + 2 * FP_ROWS * S, S, Z1);
    mixed_add(X1, Y1, Z1, X2, Y2, X3, Y3, Z3);
    store(X3, bk, S);
    store(Y3, bk + FP_ROWS * S, S);
    store(Z3, bk + 2 * FP_ROWS * S, S);
  }
}

}  // namespace gp
