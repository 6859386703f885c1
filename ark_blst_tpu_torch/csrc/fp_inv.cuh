// Device bodies of K1-inv, K1-scan and K7-inv (fp_inv.cu): the lazy
// engine's two inversion chains and the strict engine's Fermat ladder on
// the 32-bit Montgomery layer of fp381.cuh, one thread an element (the
// Fermat ladder, on digits or on strict limbs) or a column (the blocked
// batch inversion's up and down passes), every link of a chain in
// registers.
//
// Domains: the digit stacks are the lazy engine's (balanced radix-13
// digits, |d| <= 8191, of a value x R13 with R13 = 2^390).
// t381::digits_to_words takes an element to canonical words x R (R =
// 2^384), where f381::mont_mul is a b / R; t381::words_to_digits takes a
// result back to canonical, mul-ready digits (|d| <= 4096). A chain of
// products on words holds the same field elements as the same chain of
// lazy products on digits (ops/fp_inv.py, the plain versions), each in its
// own Montgomery form, so the outputs agree by value, not digit for digit.
// The strict limbs (R = 2^384, canonical) are the words' own number, so
// K7-inv's ladder equals the strict engine's loop of products
// (ops/dispatch.py fp_pow) limb for limb.
//
// No operation has undefined behaviour (unsigned arithmetic, as in
// fp381.cuh); the header compiles as host C++ too, so
// tests/test_torch_fp_inv_host.py runs each body on the CPU.
#pragma once

#include "tower381.cuh"

namespace finv {

using f381::Fp;
using f381::NW;
using f381::u32;

// p - 2, little-endian words: the Fermat exponent. Its top bit is bit 380,
// and 229 of its bits are set, so the ladder below makes 380 squarings and
// 228 products (pinned against Python ints by
// tests/test_torch_fp_inv_host.py).
__constant__ u32 P_MINUS_2[NW] = {0xffffaaa9, 0xb9feffff, 0xb153ffff, 0x1eabfffe,
                                  0xf6b0f624, 0x6730d2a0, 0xf38512bf, 0x64774b84,
                                  0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
constexpr int EXP_TOP = 380;

// r = x^(p-2) for canonical words x = v R: v^-1 R, and 0 for v = 0.
// MSB-first square-and-multiply over the exponent's bits; the bit is the
// same for every thread, so the branch never diverges. r must not alias x:
// x is read again on every set bit.
__device__ __forceinline__ void fermat(const Fp& x, Fp& r) {
  r = x;
#pragma unroll 1
  for (int i = EXP_TOP - 1; i >= 0; --i) {
    f381::mont_mul(r, r, r);
    if ((P_MINUS_2[i / 32] >> (i % 32)) & 1) f381::mont_mul(r, x, r);
  }
}

// One element's inverse on the edge format FMT (tower381.cuh EdgeFormat),
// the entries at x[k * stride] and out[k * stride]:
//   DIGIT_ROWS  K1-inv: 30 digits of X = v R13 -> 30 digits of v^-1 R13 =
//               R13^2 X^-1 mod p;
//   LIMB_ROWS   K7-inv, the strict engine's: 24 limbs of X = v R (any
//               value below 2^384, reduced on the load) -> the 24 canonical
//               limbs of v^-1 R = R^2 X^-1 mod p, the words' own number;
// 0 for X = 0 mod p.
template <int FMT = t381::DIGIT_ROWS>
__device__ __forceinline__ void inv_elem(const int* x, int* out, long long stride) {
  Fp v, r;
  t381::read_row(x, stride, FMT, v);
  fermat(v, r);
  t381::write_row(r, out, stride, FMT);
}

// K1-scan, the up pass of one column j of a (30, g m) digit stack z, read
// as g rows of m columns (element k m + j in row k): the exclusive prefix
// products pre[k] = prod_{i<k} z[i m + j] as words (word w of element e at
// pre[w g m + e], the kernel's own scratch), and the column's product as
// digits at total[k' m + j] (a (30, m) stack).
__device__ __forceinline__ void scan_up_col(const int* z, u32* pre, int* total, int g,
                                            long long m, long long j) {
  const long long n = g * m;
  Fp c, x;
#pragma unroll
  for (int w = 0; w < NW; ++w) c.w[w] = f381::R_MOD_P[w];  // one, x R
#pragma unroll 1
  for (int k = 0; k < g; ++k) {
    const long long e = k * m + j;
#pragma unroll
    for (int w = 0; w < NW; ++w) pre[w * n + e] = c.w[w];
    t381::digits_to_words(z + e, n, x);
    f381::mont_mul(c, x, c);
  }
  t381::words_to_digits(c, total + j, m);
}

// K1-scan, the down pass of column j, given the up pass's pre and the
// column product's inverse at inv_total[k' m + j] (a (30, m) stack): for k
// = g-1 .. 0, inv[k m + j] = T pre[k], then T = T z[k m + j], T starting
// at the inverse of the column's product; inv as digits.
__device__ __forceinline__ void scan_down_col(const int* z, const u32* pre, const int* inv_total,
                                              int* inv, int g, long long m, long long j) {
  const long long n = g * m;
  Fp t, x, r;
  t381::digits_to_words(inv_total + j, m, t);
#pragma unroll 1
  for (int k = g - 1; k >= 0; --k) {
    const long long e = k * m + j;
#pragma unroll
    for (int w = 0; w < NW; ++w) x.w[w] = pre[w * n + e];
    f381::mont_mul(t, x, r);
    t381::words_to_digits(r, inv + e, n);
    if (k > 0) {
      t381::digits_to_words(z + e, n, x);
      f381::mont_mul(t, x, t);
    }
  }
}

}  // namespace finv
