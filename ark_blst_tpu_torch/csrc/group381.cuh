// Device functions of the bucket kernels K2 (G1) and K2-G2 on the 32-bit
// Montgomery layer of fp381.cuh, generic over the coordinate field F (Fp
// for G1, Fp2 for G2): the complete mixed addition of RCB15, the points'
// conversion to words, the per-thread body, the accumulation of one
// (window, stream), and the conversion of its buckets into the dump's
// packed radix-13 digits. Beside them the complete projective addition
// and doubling of RCB15 (`complete_add`, `complete_dbl`), the group law of
// the scan MSM's chains (scan_msm.cuh).
//
// Value parity: the addition computes the same algebraic expressions as
// ark_blst_tpu_torch/curves/lazy_group.py:mixed_add over FP_LAZY or
// FP2_LAZY (and the JAX package's), in exact field arithmetic, and each
// stream visits its points in the same order. So every bucket coordinate
// equals the plain version's (curves/msm_bucket.py:accumulate_plain) as a
// field element; only the redundant digits of the dump differ.
// MB.dump_values compares them.
//
// Compiles as host C++ too (fp381.cuh, lazy13.cuh): tests/
// test_torch_fp381_host.py and tests/test_torch_tower_host.py run it on the
// CPU under -fsanitize=undefined.
#pragma once

#include "fp381.cuh"
#include "lazy13.cuh"

namespace g381 {

using f381::Fp;
using f381::Fp2;
using f381::NW;

constexpr int FP_ROWS = lz::ELEM / 2;  // packed dump rows of one Fp component
// Fp components of a coordinate in F: 1 for G1 (Fp), 2 for G2 (Fp2, re, im)
template <class F>
constexpr int NC = sizeof(F) / sizeof(Fp);
template <class F>
constexpr int PT_ROWS = 3 * NC<F> * FP_ROWS;  // dump rows of one bucket (x, y, z)
template <class F>
constexpr int PT_WORDS = 3 * NC<F> * NW;  // rows of a bucket in the internal form

// Word rows <-> elements: row j of a component at src[j * stride].
__device__ __forceinline__ void load(const int* src, long long stride, Fp& x) {
#pragma unroll
  for (int j = 0; j < NW; ++j) x.w[j] = static_cast<uint32_t>(src[j * stride]);
}

__device__ __forceinline__ void store(const Fp& x, int* dst, long long stride) {
#pragma unroll
  for (int j = 0; j < NW; ++j) dst[j * stride] = static_cast<int>(x.w[j]);
}

__device__ __forceinline__ void load(const int* src, long long stride, Fp2& x) {
  load(src, stride, x.c0);
  load(src + NW * stride, stride, x.c1);
}

__device__ __forceinline__ void store(const Fp2& x, int* dst, long long stride) {
  store(x.c0, dst, stride);
  store(x.c1, dst + NW * stride, stride);
}

// Complete mixed addition (X : Y : Z) += (X2, Y2) (affine), RCB15 Algorithm 7
// with Z2 = 1 and b3 = 3b (12 on G1, 12 (1 + u) on G2: f381::mul_b3), in
// place:
//   t0 = X1 X2, t1 = Y1 Y2, u1 = Y2 Z1, u2 = X2 Z1, m3 = (X1 + Y1)(X2 + Y2)
//   t3 = m3 - t0 - t1, t0t = 3 t0, t2b = b3 Z1, z3 = t1 + t2b,
//   t1m = t1 - t2b, t4 = Y1 + u1, tyb = b3 (X1 + u2)
//   X3 = t3 t1m - t4 tyb, Y3 = t1m z3 + tyb t0t, Z3 = z3 t4 + t0t t3
// 11 products in F (33 Fp products on G2). Ordered so that each input dies
// early: after the first round six values of F are live (t3, tyb, t4, z3,
// t1m, t0t).
template <class F>
__device__ __forceinline__ void mixed_add(F& X, F& Y, F& Z, const F& X2, const F& Y2) {
  using namespace f381;
  F t0, t1, t3, tyb, t4, s;
  mul(X, X2, t0);
  mul(Y, Y2, t1);
  add(X, Y, t3);
  add(X2, Y2, s);
  mul(t3, s, t3);  // m3
  sub(t3, t0, t3);
  sub(t3, t1, t3);
  mul(X2, Z, tyb);  // u2
  add(X, tyb, tyb);
  mul_b3(tyb, tyb);
  mul(Y2, Z, t4);  // u1
  add(Y, t4, t4);
  F t2b, z3, t1m, t0t;
  mul_b3(Z, t2b);
  add(t1, t2b, z3);
  sub(t1, t2b, t1m);
  mul_small<3>(t0, t0t);
  F a;
  mul(t3, t1m, a);
  mul(t4, tyb, s);
  sub(a, s, X);
  mul(t1m, z3, a);
  mul(tyb, t0t, s);
  add(a, s, Y);
  mul(z3, t4, a);
  mul(t0t, t3, s);
  add(a, s, Z);
}

// Complete projective addition (X1 : Y1 : Z1) += (X2 : Y2 : Z2), RCB15
// Algorithm 7 with a = 0 and b3 = 3b (f381::mul_b3), in place, right for
// every pair of points (the identity, a doubling, inverses):
//   t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
//   t3 = (X1 + Y1)(X2 + Y2) - (t0 + t1), t4 = (Y1 + Z1)(Y2 + Z2) - (t1 + t2),
//   ty = (X1 + Z1)(X2 + Z2) - (t0 + t2), t0' = 3 t0, t2' = b3 t2,
//   z3 = t1 + t2', t1' = t1 - t2', ty' = b3 ty,
//   X3 = t3 t1' - t4 ty', Y3 = t1' z3 + ty' t0', Z3 = z3 t4 + t0' t3
// 12 products in F. These are the expressions of
// ark_blst_tpu_torch/curves/group.py:CurveOps.add; every value is
// canonical and every operation exact, so the result equals the plain
// version's limb for limb as projective coordinates (not only as a point).
// The second point must not alias the first.
template <class F>
__device__ __forceinline__ void complete_add(F& X1, F& Y1, F& Z1, const F& X2, const F& Y2,
                                             const F& Z2) {
  using namespace f381;
  F t0, t1, t2, t3, t4, ty, s;
  mul(X1, X2, t0);
  mul(Y1, Y2, t1);
  mul(Z1, Z2, t2);
  add(X1, Y1, t3);
  add(X2, Y2, s);
  mul(t3, s, t3);
  add(t0, t1, s);
  sub(t3, s, t3);
  add(Y1, Z1, t4);
  add(Y2, Z2, s);
  mul(t4, s, t4);
  add(t1, t2, s);
  sub(t4, s, t4);
  add(X1, Z1, ty);
  add(X2, Z2, s);
  mul(ty, s, ty);
  add(t0, t2, s);
  sub(ty, s, ty);
  F t0t, z3, a;
  mul_small<3>(t0, t0t);
  mul_b3(t2, t2);
  add(t1, t2, z3);
  sub(t1, t2, t1);
  mul_b3(ty, ty);
  mul(t3, t1, a);
  mul(t4, ty, s);
  sub(a, s, X1);
  mul(t1, z3, a);
  mul(ty, t0t, s);
  add(a, s, Y1);
  mul(z3, t4, a);
  mul(t0t, t3, s);
  add(a, s, Z1);
}

// Complete projective doubling of (X : Y : Z), RCB15 Algorithm 9 with
// a = 0, in place: the expressions of curves/group.py:CurveOps.double,
//   t0 = Y^2, tyz = Y Z, t2 = b3 Z^2, txy = X Y, y8 = 8 t0,
//   tdiff = t0 - 3 t2,
//   X3 = 2 tdiff txy, Y3 = t2 y8 + tdiff (t0 + t2), Z3 = tyz y8
// 8 products in F; equal to the plain version's limb for limb.
template <class F>
__device__ __forceinline__ void complete_dbl(F& X, F& Y, F& Z) {
  using namespace f381;
  F t0, t2, y8, s, a;
  mul(Y, Y, t0);
  mul(X, Y, X);  // txy
  mul(Y, Z, Y);  // tyz
  mul(Z, Z, Z);
  mul_b3(Z, t2);
  mul_small<8>(t0, y8);
  add(t0, t2, s);  // Y^2 + b3 Z^2
  mul_small<3>(t2, a);
  sub(t0, a, t0);  // tdiff
  mul(t0, X, X);
  add(X, X, X);
  mul(t2, y8, a);
  mul(Y, y8, Z);
  mul(t0, s, s);
  add(a, s, Y);
}

// 15 packed rows of one lazy component (balanced radix-13 digits, biased
// by 4129, R13 domain, any value the 30 digits can hold) -> its canonical
// R16 words, as the wrapper's plain version (curves/msm_bucket.py:
// point_words_plain) gives them. W = (the biased digits' sum) + DIGIT_BIAS_FIX
// is nonnegative, has the value's residue and is below 2^11 p; subtracting
// 2^k p for k = 10 .. 0 where it fits leaves W mod p, and a Montgomery
// product by 2^378 takes it from x 2^390 to x 2^384.
__device__ __forceinline__ void rows_to_words(const int* src, long long stride, int* dst,
                                              long long dst_stride) {
  constexpr int TW = NW + 1;  // W < 2^391: 13 words
  unsigned long long acc[TW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = f381::DIGIT_BIAS_FIX[j];
  acc[NW] = 0;
#pragma unroll
  for (int r = 0; r < FP_ROWS; ++r) {
    const uint32_t packed = static_cast<uint32_t>(src[r * stride]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bit = lz::RADIX * (2 * r + h), j = bit / 32;
      const unsigned long long e = (packed >> (16 * h)) & 0xFFFF;  // d + 4129 < 2^14
      const unsigned long long v = e << (bit % 32);                 // < 2^45
      acc[j] += v & 0xFFFFFFFF;
      acc[j + 1] += v >> 32;
    }
  }
  uint32_t t[TW];
  unsigned long long carry = 0;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    carry += acc[j];
    t[j] = static_cast<uint32_t>(carry);
    carry >>= 32;
  }
#pragma unroll
  for (int k = 10; k >= 0; --k) {  // t -= 2^k p where t >= 2^k p
    uint32_t d[TW];
    unsigned long long borrow = 0;
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const uint32_t lo = j < NW ? f381::P[j] << k : 0;
      const uint32_t hi = (k > 0 && j > 0) ? f381::P[j - 1] >> (32 - k) : 0;
      const unsigned long long s = static_cast<unsigned long long>(t[j]) - (lo | hi) - borrow;
      d[j] = static_cast<uint32_t>(s);
      borrow = (s >> 32) & 1;
    }
#pragma unroll
    for (int j = 0; j < TW; ++j) t[j] = borrow ? t[j] : d[j];
  }
  Fp x, c, r;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x.w[j] = t[j];
    c.w[j] = f381::R378_MOD_P[j];
  }
  f381::mont_mul(x, c, r);
  store(r, dst, dst_stride);
}

// One component (canonical, R16 domain) -> 15 packed dump rows: times
// 2^390 mod p by a Montgomery product (the R13 domain), cut into 30
// radix-13 digits, one balanced fold (|d| <= 4096; the carry out is 0 for a
// value below p), packed as lz::pack30 packs.
__device__ __forceinline__ void store_r13(const Fp& x, int* dst, long long stride) {
  Fp c, v;
#pragma unroll
  for (int j = 0; j < NW; ++j) c.w[j] = f381::R390_MOD_P[j];
  f381::mont_mul(x, c, v);
  int d[lz::ELEM + 1];
#pragma unroll
  for (int k = 0; k < lz::ELEM; ++k) {
    const int bit = lz::RADIX * k, j = bit / 32, sh = bit % 32;
    uint32_t u = v.w[j] >> sh;
    if (sh > 32 - lz::RADIX && j + 1 < NW) u |= v.w[j + 1] << (32 - sh);
    d[k] = static_cast<int>(u & lz::DMASK);
  }
  lz::fold<lz::ELEM>(d);
  lz::pack30(d, dst, stride);
}

// The B buckets of one (window, stream), from their column's first word
// `base` (bucket b at base + b * PT_ROWS S, 45 rows on G1, 90 on G2): each
// <- (0 : R mod p : 0) in the internal form, component k (x, y, z; re
// before im on G2) at rows [12 k, 12 k + 12) of the bucket's PT_ROWS. R
// mod p goes into y's first component, component NC: rows [12, 24) on G1,
// [24, 36) on G2.
template <class F>
__device__ __forceinline__ void init_buckets(int* base, int B, int S) {
  for (int b = 0; b < B; ++b) {
    int* bk = base + static_cast<long long>(b) * PT_ROWS<F> * S;
#pragma unroll 1
    for (int r = 0; r < PT_WORDS<F>; ++r) bk[r * S] = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      bk[(NC<F> * NW + j) * S] = static_cast<int>(f381::R_MOD_P[j]);
  }
}

// The same buckets, internal form -> the dump's packed R13 digits in place:
// component k to rows [15 k, 15 k + 15), highest k first, so that it never
// overwrites a component it has still to read (component k reads rows
// [12 k, 12 k + 12) whole before it writes; the rows it writes start at
// 15 k >= 12 k, above every lower component's).
template <class F>
__device__ __forceinline__ void buckets_to_dump(int* base, int B, int S) {
  for (int b = 0; b < B; ++b) {
    int* bk = base + static_cast<long long>(b) * PT_ROWS<F> * S;
#pragma unroll 1
    for (int k = 3 * NC<F> - 1; k >= 0; --k) {
      Fp x;
      load(bk + k * NW * S, S, x);
      store_r13(x, bk + k * FP_ROWS * S, S);
    }
  }
}

// Accumulate window w, stream s (point p belongs to stream p mod S):
//   buckets[w, 0..B) <- (0 : R mod p : 0)
//   for the stream's points in order:
//     digit = mag | sign << 15;  if mag == 0: skip (bucket 0 is dropped)
//     (x2, y2) <- the affine point, y2 <- p - y2 (or 0) if sign
//     buckets[w, mag] <- mixed_add(buckets[w, mag], (x2, y2))
//   then every bucket to the dump's packed R13 digits, in place.
// words (2 NC NW, n): the points' canonical R16 words (x, y; re before im
// on G2), 24 rows on G1, 48 on G2; digs (W, n); dump (W, B, PT_ROWS, S).
// The buckets live in the thread's own column dump[w, :, :, s], in the
// internal form until the end.
template <class F>
__device__ __forceinline__ void accumulate_stream(const int* __restrict__ words,
                                                  const int* __restrict__ digs,
                                                  int* __restrict__ dump, long long n, int B,
                                                  int S, int w, int s) {
  constexpr int CW = NC<F> * NW;  // rows of one coordinate
  int* base = dump + static_cast<long long>(w) * B * PT_ROWS<F> * S + s;
  const long long bstride = static_cast<long long>(PT_ROWS<F>) * S;
  init_buckets<F>(base, B, S);

  const long long T = n / S;
  const int* dig_row = digs + static_cast<long long>(w) * n;
  for (long long t = 0; t < T; ++t) {
    const long long p = t * S + s;
    const int dig = dig_row[p];
    const int mag = dig & 0x7FFF;
    if (mag == 0) continue;
    F X2, Y2;
    load(words + p, n, X2);
    load(words + CW * n + p, n, Y2);
    if ((dig >> 15) & 1) f381::neg(Y2, Y2);
    int* bk = base + mag * bstride;
    F X, Y, Z;
    load(bk, S, X);
    load(bk + CW * S, S, Y);
    load(bk + 2 * CW * S, S, Z);
    mixed_add(X, Y, Z, X2, Y2);
    store(X, bk, S);
    store(Y, bk + CW * S, S);
    store(Z, bk + 2 * CW * S, S);
  }

  buckets_to_dump<F>(base, B, S);
}

}  // namespace g381
