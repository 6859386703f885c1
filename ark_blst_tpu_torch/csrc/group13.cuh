// Device functions of the MSM bucket kernels (K2): the complete mixed
// addition of RCB15 over Fp (G1) and Fp2 (G2), and the per-thread body both
// kernels run, the accumulation of one (window, stream).
//
// Every function mirrors ark_blst_tpu_torch/curves/lazy_group.py:mixed_add
// with FP_LAZY (G1) or FP2_LAZY (G2), and curves/msm_bucket.py:
// accumulate_plain, digit for digit: the same products, the same linear
// combinations before each reduction and the same folds. The order in which
// independent products are computed does not matter (the columns are exact
// integer sums); where each fold and each reduction falls does.
//
// Integer discipline (no signed int32 operation overflows, so the C++ has
// no undefined behaviour and gives PyTorch's int32 digits):
// * inputs have |digit| <= 8191 (a stored bucket or point has |d| <= 4129,
//   the host check also feeds canonical 8191s); fold_sum outputs have
//   |d| <= 4096 + 36, reductions |d| <= 4129 (lazy13.cuh);
// * every product operand is such a digit, so columns stay <= 30 * 8191^2
//   = 2.01e9 < 2^31 and prered digits within 4129 + 1;
// * Fp2 Karatsuba: the leg a0 + a1 is folded before its product; the
//   prered combinations are re = m0 - m1 (2 wides) and im = m2 - m0 - m1
//   (3 wides); a round-2 output adds two of them, so reduce_wide takes at
//   most 6 prered wides, |d| <= 6 * 4130 = 24,780 (G1: 2 wides), and its
//   first fold brings that back to 4096 + 4 before any product by a
//   constant digit (<= 30 * 4100 * 8191 = 1.01e9);
// * mul_b3 sums: G1 12 * (X1 + u2) <= 12 * 12,320 = 147,840; G2
//   12 * ((a0 - a1) or (a0 + a1)) with a = X1 + u2: <= 295,680, with a = Z1:
//   <= 196,584; the glue between the rounds stays below 3 * 8191.
#pragma once

#include "lazy13.cuh"

namespace gp {

using lz::ELEM;
using lz::fold_sum;

constexpr int FP_ROWS = ELEM / 2;  // packed rows of one Fp component

// One coordinate: NC Fp components (1 on G1, 2 on G2: re, im).
template <int NC>
struct Coord {
  int c[NC][ELEM];
};

// --- G1: fully inlined --------------------------------------------------------

// Complete mixed addition P1 (projective) + P2 (affine), RCB15 Algorithm 7
// with Z2 = 1, lazily reduced.
__device__ __forceinline__ void g1_mixed_add(const int* X1, const int* Y1, const int* Z1,
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

__device__ __forceinline__ void mixed_add(const Coord<1>& X1, const Coord<1>& Y1,
                                          const Coord<1>& Z1, const Coord<1>& X2,
                                          const Coord<1>& Y2, Coord<1>& X3, Coord<1>& Y3,
                                          Coord<1>& Z3) {
  g1_mixed_add(X1.c[0], Y1.c[0], Z1.c[0], X2.c[0], Y2.c[0], X3.c[0], Y3.c[0], Z3.c[0]);
}

// --- G2: Fp2 = Fp[u]/(u^2 + 1), out of line ------------------------------------
//
// A fully inlined G2 addition would be 33 copies of the ~3K-instruction
// product; one out-of-line product and reduction, called through the Fp2
// helpers below, keep the kernel small at the price of local-memory
// traffic between the calls.

using Fp2 = Coord<2>;

struct Wide2 {
  int re[lz::WIDE];
  int im[lz::WIDE];
};

LZ_NOINLINE void prered_nl(const int* a, const int* b, int* w) { lz::mul_prered(a, b, w); }

LZ_NOINLINE void reduce_nl(int* t, int* out) { lz::reduce_wide(t, out); }

// fold_sum of each component of a + b (b scaled by sb): the mul-ready sum.
__device__ __forceinline__ void fold_sum2(const Fp2& a, const Fp2& b, int sb, Fp2& out) {
  int tmp[ELEM];
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int k = 0; k < ELEM; ++k) tmp[k] = a.c[j][k] + sb * b.c[j][k];
    fold_sum(tmp, out.c[j]);
  }
}

// lazy13.fp2_mul_prered: m0 = a0 b0, m1 = a1 b1, m2 = (a0 + a1)(b0 + b1),
// each prered; re = m0 - m1, im = m2 - (m0 + m1).
LZ_NOINLINE void fp2_mul_prered(const Fp2& a, const Fp2& b, Wide2& w) {
  int sa[ELEM], sb[ELEM], tmp[ELEM], m2[lz::WIDE];
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = a.c[0][k] + a.c[1][k];
  fold_sum(tmp, sa);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = b.c[0][k] + b.c[1][k];
  fold_sum(tmp, sb);
  prered_nl(a.c[0], b.c[0], w.re);  // m0
  prered_nl(a.c[1], b.c[1], w.im);  // m1
  prered_nl(sa, sb, m2);
#pragma unroll
  for (int k = 0; k < lz::COLS + 2; ++k) {
    const int m0 = w.re[k], m1 = w.im[k];
    w.re[k] = m0 - m1;
    w.im[k] = m2[k] - (m0 + m1);
  }
}

// One round-1 product: red of each component of a * b.
LZ_NOINLINE void fp2_mont_mul(const Fp2& a, const Fp2& b, Fp2& out) {
  Wide2 w;
  fp2_mul_prered(a, b, w);
  reduce_nl(w.re, out.c[0]);
  reduce_nl(w.im, out.c[1]);
}

// One round-2 output: red of each component of a * b + sign * (c * d).
LZ_NOINLINE void fp2_mul2_reduce(const Fp2& a, const Fp2& b, const Fp2& c, const Fp2& d,
                                 int sign, Fp2& out) {
  Wide2 w, v;
  fp2_mul_prered(a, b, w);
  fp2_mul_prered(c, d, v);
#pragma unroll
  for (int k = 0; k < lz::COLS + 2; ++k) {
    w.re[k] += sign * v.re[k];
    w.im[k] += sign * v.im[k];
  }
  reduce_nl(w.re, out.c[0]);
  reduce_nl(w.im, out.c[1]);
}

// fold_sum(mul_b3(a)) with mul_b3 = 12 (1 + u): (12 (a0 - a1), 12 (a0 + a1)).
__device__ __forceinline__ void fold_mul_b3(const Fp2& a, Fp2& out) {
  int tmp[ELEM];
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = 12 * (a.c[0][k] - a.c[1][k]);
  fold_sum(tmp, out.c[0]);
#pragma unroll
  for (int k = 0; k < ELEM; ++k) tmp[k] = 12 * (a.c[0][k] + a.c[1][k]);
  fold_sum(tmp, out.c[1]);
}

// The same complete mixed addition over Fp2: 33 products (11 Karatsuba
// triples), 16 reductions.
LZ_NOINLINE void mixed_add(const Fp2& X1, const Fp2& Y1, const Fp2& Z1, const Fp2& X2,
                           const Fp2& Y2, Fp2& X3, Fp2& Y3, Fp2& Z3) {
  Fp2 t0, t1, u1, u2, m3, s1, s2;
  fp2_mont_mul(X1, X2, t0);
  fp2_mont_mul(Y1, Y2, t1);
  fp2_mont_mul(Y2, Z1, u1);
  fp2_mont_mul(X2, Z1, u2);
  fold_sum2(X1, Y1, 1, s1);
  fold_sum2(X2, Y2, 1, s2);
  fp2_mont_mul(s1, s2, m3);

  Fp2 t3, t4, t0t, t2b, z3, t1m, tyb, ty;
  int tmp[ELEM];
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int k = 0; k < ELEM; ++k) tmp[k] = m3.c[j][k] - t0.c[j][k] - t1.c[j][k];
    fold_sum(tmp, t3.c[j]);
#pragma unroll
    for (int k = 0; k < ELEM; ++k) tmp[k] = 3 * t0.c[j][k];
    fold_sum(tmp, t0t.c[j]);
#pragma unroll
    for (int k = 0; k < ELEM; ++k) ty.c[j][k] = X1.c[j][k] + u2.c[j][k];  // 2F, unfolded
  }
  fold_mul_b3(Z1, t2b);
  fold_sum2(t1, t2b, 1, z3);
  fold_sum2(t1, t2b, -1, t1m);
  fold_sum2(Y1, u1, 1, t4);
  fold_mul_b3(ty, tyb);

  // X3 = red(b - a), Y3 = red(d + c), Z3 = red(g + e) with
  // a = t4*tyb, b = t3*t1m, c = tyb*t0t, d = t1m*z3, e = t0t*t3, g = z3*t4
  fp2_mul2_reduce(t3, t1m, t4, tyb, -1, X3);
  fp2_mul2_reduce(t1m, z3, tyb, t0t, 1, Y3);
  fp2_mul2_reduce(z3, t4, t0t, t3, 1, Z3);
}

// --- the kernels' per-thread body -------------------------------------------

// Coordinate rows -> digits: component j at rows [15 j, 15 j + 15).
template <int NC>
__device__ __forceinline__ void load_coord(const int* src, long long stride, Coord<NC>& x) {
#pragma unroll
  for (int j = 0; j < NC; ++j) lz::unpack15(src + j * FP_ROWS * stride, stride, x.c[j]);
}

template <int NC>
__device__ __forceinline__ void store_coord(const Coord<NC>& x, int* dst, long long stride) {
  int st[ELEM];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    lz::store30(x.c[j], st);
    lz::pack30(st, dst + j * FP_ROWS * stride, stride);
  }
}

// Accumulate window w, stream s (point p belongs to stream p mod S):
//   buckets[w, 0..B) <- identity (0 : one : 0)
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 negated if sign
//     buckets[w, mag] <- store30(mixed_add(buckets[w, mag], (x2, y2)))
// pts (2 * CR, n) packed affine rows; digs (W, n); ident (3 * CR,) packed
// identity rows; dump (W, B, 3 * CR, S), CR = 15 NC rows a coordinate. The
// buckets live in the dump, indexed by the digit.
template <int NC>
__device__ __forceinline__ void accumulate_stream(const int* __restrict__ pts,
                                                  const int* __restrict__ digs,
                                                  const int* __restrict__ ident,
                                                  int* __restrict__ dump, long long n, int B,
                                                  int S, int w, int s) {
  constexpr int CR = FP_ROWS * NC;  // packed rows of a coordinate
  constexpr int PT_ROWS = 3 * CR;
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
    Coord<NC> X2, Y2;
    load_coord(pts + p, n, X2);
    load_coord(pts + CR * n + p, n, Y2);
    if ((dig >> 15) & 1) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int k = 0; k < ELEM; ++k) Y2.c[j][k] = -Y2.c[j][k];
    }
    int* bk = base + static_cast<long long>(mag) * PT_ROWS * S;
    Coord<NC> X1, Y1, Z1, X3, Y3, Z3;
    load_coord(bk, S, X1);
    load_coord(bk + CR * S, S, Y1);
    load_coord(bk + 2 * CR * S, S, Z1);
    mixed_add(X1, Y1, Z1, X2, Y2, X3, Y3, Z3);
    store_coord(X3, bk, S);
    store_coord(Y3, bk + CR * S, S);
    store_coord(Z3, bk + 2 * CR * S, S);
  }
}

}  // namespace gp
