// Device functions of the lazy Fp2/Fp6/Fp12 tower on radix-13 digits, for
// K11 (fp12_sqr.cu) and K12 (fp12_mul_by_014.cu), the unfused Miller loop's
// kernels. (K3-K6 run on the 32-bit Montgomery words of tower381.cuh.)
//
// Every function mirrors the function of the same name in
// ark_blst_tpu_torch/ops/tower_lazy.py digit for digit: the same products
// and the same folds on the same operands. The digits depend on where each fold falls, so this code
// follows the Python's dataflow, not the algebra; the order in which
// independent products are computed does not matter. An element is one
// struct of its 30 digits per Fp component, held by one thread (in
// registers and local memory).
//
// Integer discipline (no signed int32 operation overflows, so the C++ has
// no undefined behaviour and gives PyTorch's int32 digits):
// * kernel inputs have |digit| <= 8191 (mul-ready |d| <= 4129, or
//   canonical); every fold30 output has |digit| <= 4105 and every mont_mul
//   output |digit| <= 4129 (lazy13.cuh);
// * so every product operand has |digit| <= 8191 and every product column
//   is <= 30 * 8191^2 = 2.01e9 < 2^31 (lazy13.cuh);
// * sums fed to fold30 are at most 2 * 8191 (a sum of two operands;
//   m2 - m0 - m1 <= 3 * 4129).
// fold30 drops the top carry on purpose (exact for |value| < 0.49 * 2^390,
// which every value of the tower satisfies).
#pragma once

#include "lazy13.cuh"

namespace tw {

using lz::ELEM;

struct Fp {
  int d[ELEM];
};
struct Fp2 {
  Fp c[2];
};
struct Fp6 {
  Fp2 c[3];
};
struct Fp12 {
  Fp6 c[2];
};

// --- Fp -------------------------------------------------------------------

// One balanced carry-release pass, truncated to 30 digits (top carry dropped).
__device__ __forceinline__ Fp fold30(const Fp& t) {
  Fp out;
  int carry = 0;
#pragma unroll
  for (int k = 0; k < ELEM; ++k) {
    const int u = t.d[k] + lz::HALF;
    out.d[k] = ((u & lz::DMASK) - lz::HALF) + carry;
    carry = u >> lz::RADIX;
  }
  return out;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp t;
#pragma unroll
  for (int k = 0; k < ELEM; ++k) t.d[k] = a.d[k] + b.d[k];
  return fold30(t);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp t;
#pragma unroll
  for (int k = 0; k < ELEM; ++k) t.d[k] = a.d[k] - b.d[k];
  return fold30(t);
}

// The one Montgomery product, out of line: every product of the tower calls
// this single copy of the ~3K-instruction body.
LZ_NOINLINE Fp fp_mul(const Fp& a, const Fp& b) {
  Fp r;
  lz::mont_mul(a.d, b.d, r.d);
  return r;
}

// --- Fp2 ------------------------------------------------------------------

__device__ __forceinline__ Fp2 make2(const Fp& c0, const Fp& c1) {
  Fp2 r;
  r.c[0] = c0;
  r.c[1] = c1;
  return r;
}

LZ_NOINLINE Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return make2(fp_add(a.c[0], b.c[0]), fp_add(a.c[1], b.c[1]));
}

LZ_NOINLINE Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return make2(fp_sub(a.c[0], b.c[0]), fp_sub(a.c[1], b.c[1]));
}

// xi = 1 + u: (c0 - c1, c0 + c1)
LZ_NOINLINE Fp2 fp2_mul_by_nonresidue(const Fp2& a) {
  return make2(fp_sub(a.c[0], a.c[1]), fp_add(a.c[0], a.c[1]));
}

// Karatsuba: m0 = a0 b0, m1 = a1 b1, m2 = (a0 + a1)(b0 + b1).
LZ_NOINLINE Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  const Fp m0 = fp_mul(a.c[0], b.c[0]);
  const Fp m1 = fp_mul(a.c[1], b.c[1]);
  const Fp m2 = fp_mul(fp_add(a.c[0], a.c[1]), fp_add(b.c[0], b.c[1]));
  Fp t;
#pragma unroll
  for (int k = 0; k < ELEM; ++k) t.d[k] = m2.d[k] - m0.d[k] - m1.d[k];
  return make2(fp_sub(m0, m1), fold30(t));
}

// --- Fp6 ------------------------------------------------------------------

__device__ __forceinline__ Fp6 make6(const Fp2& a0, const Fp2& a1, const Fp2& a2) {
  Fp6 r;
  r.c[0] = a0;
  r.c[1] = a1;
  r.c[2] = a2;
  return r;
}

LZ_NOINLINE Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  return make6(fp2_add(a.c[0], b.c[0]), fp2_add(a.c[1], b.c[1]), fp2_add(a.c[2], b.c[2]));
}

LZ_NOINLINE Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  return make6(fp2_sub(a.c[0], b.c[0]), fp2_sub(a.c[1], b.c[1]), fp2_sub(a.c[2], b.c[2]));
}

// v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
__device__ __forceinline__ Fp6 fp6_mul_by_nonresidue(const Fp6& a) {
  return make6(fp2_mul_by_nonresidue(a.c[2]), a.c[0], a.c[1]);
}

// tower_lazy.fp6_mul_many for one pair: 6 fp2 products.
LZ_NOINLINE Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  const Fp2 v0 = fp2_mul(a.c[0], b.c[0]);
  const Fp2 v1 = fp2_mul(a.c[1], b.c[1]);
  const Fp2 v2 = fp2_mul(a.c[2], b.c[2]);
  const Fp2 m12 = fp2_mul(fp2_add(a.c[1], a.c[2]), fp2_add(b.c[1], b.c[2]));
  const Fp2 m01 = fp2_mul(fp2_add(a.c[0], a.c[1]), fp2_add(b.c[0], b.c[1]));
  const Fp2 m02 = fp2_mul(fp2_add(a.c[0], a.c[2]), fp2_add(b.c[0], b.c[2]));
  const Fp2 c0 = fp2_add(v0, fp2_mul_by_nonresidue(fp2_sub(fp2_sub(m12, v1), v2)));
  const Fp2 c1 = fp2_add(fp2_sub(fp2_sub(m01, v0), v1), fp2_mul_by_nonresidue(v2));
  const Fp2 c2 = fp2_add(fp2_sub(fp2_sub(m02, v0), v2), v1);
  return make6(c0, c1, c2);
}

// --- Fp12 -----------------------------------------------------------------

__device__ __forceinline__ Fp12 make12(const Fp6& b0, const Fp6& b1) {
  Fp12 r;
  r.c[0] = b0;
  r.c[1] = b1;
  return r;
}

// Complex squaring: 2 fp6 products.
LZ_NOINLINE Fp12 fp12_sqr(const Fp12& a) {
  const Fp6 t = fp6_mul(a.c[0], a.c[1]);
  const Fp6 m = fp6_mul(fp6_add(a.c[0], a.c[1]),
                        fp6_add(a.c[0], fp6_mul_by_nonresidue(a.c[1])));
  return make12(fp6_sub(fp6_sub(m, t), fp6_mul_by_nonresidue(t)), fp6_add(t, t));
}

// tower_lazy.fp12_mul_by_014_many for one item: f * ((c0 + c1 v) + (c4 v) w).
LZ_NOINLINE Fp12 fp12_mul_by_014(const Fp12& f, const Fp2& c0, const Fp2& c1, const Fp2& c4) {
  const Fp6& fa = f.c[0];
  const Fp6& fb = f.c[1];
  const Fp2 t00 = fp2_mul(fa.c[0], c0), t10 = fp2_mul(fa.c[1], c0), t20 = fp2_mul(fa.c[2], c0);
  const Fp2 t21 = fp2_mul(fa.c[2], c1), t01 = fp2_mul(fa.c[0], c1), t11 = fp2_mul(fa.c[1], c1);
  const Fp2 m2 = fp2_mul(fb.c[2], c4), m0 = fp2_mul(fb.c[0], c4), m1 = fp2_mul(fb.c[1], c4);
  const Fp6 s = fp6_add(fa, fb);
  const Fp2 c14 = fp2_add(c1, c4);
  const Fp2 u00 = fp2_mul(s.c[0], c0), u10 = fp2_mul(s.c[1], c0), u20 = fp2_mul(s.c[2], c0);
  const Fp2 u21 = fp2_mul(s.c[2], c14), u01 = fp2_mul(s.c[0], c14), u11 = fp2_mul(s.c[1], c14);
  const Fp6 aa = make6(fp2_add(t00, fp2_mul_by_nonresidue(t21)), fp2_add(t01, t10),
                       fp2_add(t11, t20));
  const Fp6 bb = make6(fp2_mul_by_nonresidue(m2), m0, m1);
  const Fp6 mid = make6(fp2_add(u00, fp2_mul_by_nonresidue(u21)), fp2_add(u01, u10),
                        fp2_add(u11, u20));
  return make12(fp6_add(fp6_mul_by_nonresidue(bb), aa), fp6_sub(fp6_sub(mid, aa), bb));
}

// --- element I/O: a stack (k, 30, n), element i, component-major ----------

__device__ __forceinline__ Fp load_fp(const int* __restrict__ src, long long n, long long i) {
  Fp r;
#pragma unroll
  for (int k = 0; k < ELEM; ++k) r.d[k] = src[k * n + i];
  return r;
}

__device__ __forceinline__ void store_fp(const Fp& a, int* __restrict__ dst, long long n,
                                         long long i) {
#pragma unroll
  for (int k = 0; k < ELEM; ++k) dst[k * n + i] = a.d[k];
}

// component c of a stack starts at c * 30 * n
__device__ __forceinline__ Fp2 load_fp2(const int* src, int c, long long n, long long i) {
  return make2(load_fp(src + c * ELEM * n, n, i), load_fp(src + (c + 1) * ELEM * n, n, i));
}

__device__ __forceinline__ void store_fp2(const Fp2& a, int* dst, int c, long long n, long long i) {
  store_fp(a.c[0], dst + c * ELEM * n, n, i);
  store_fp(a.c[1], dst + (c + 1) * ELEM * n, n, i);
}

__device__ __forceinline__ Fp12 load_fp12(const int* src, long long n, long long i) {
  Fp12 r;
#pragma unroll 1
  for (int b = 0; b < 2; ++b)
#pragma unroll 1
    for (int j = 0; j < 3; ++j) r.c[b].c[j] = load_fp2(src, 6 * b + 2 * j, n, i);
  return r;
}

__device__ __forceinline__ void store_fp12(const Fp12& a, int* dst, long long n, long long i) {
#pragma unroll 1
  for (int b = 0; b < 2; ++b)
#pragma unroll 1
    for (int j = 0; j < 3; ++j) store_fp2(a.c[b].c[j], dst, 6 * b + 2 * j, n, i);
}

// --- the kernels' per-element bodies ---------------------------------------

// K11: a^2, (12, 30, n) -> out.
__device__ __forceinline__ void fp12_sqr_elem(const int* a, int* out, long long n, long long i) {
  store_fp12(fp12_sqr(load_fp12(a, n, i)), out, n, i);
}

// K12: F (12, 30, n) times the sparse line C (6, 30, n), rows c0, c1, c4
// (two Fp rows each) -> out (12, 30, n).
__device__ __forceinline__ void fp12_mul_by_014_elem(const int* f, const int* c, int* out,
                                                     long long n, long long i) {
  const Fp2 c0 = load_fp2(c, 0, n, i), c1 = load_fp2(c, 2, n, i), c4 = load_fp2(c, 4, n, i);
  store_fp12(fp12_mul_by_014(load_fp12(f, n, i), c0, c1, c4), out, n, i);
}

}  // namespace tw
