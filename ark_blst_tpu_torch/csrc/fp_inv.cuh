// Device bodies of K1-inv, K1-scan and K7-inv (fp_inv.cu): the lazy
// engine's two inversion chains and the strict engine's inversion on the
// 32-bit Montgomery layer of fp381.cuh, one thread an element (the
// inversion, on digits or on strict limbs) or a column (the blocked batch
// inversion's up and down passes), every link of a chain in registers.
//
// The inversion is a constant-time binary GCD (Pornin, "Optimized Binary
// GCD for Modular Inversion", IACR eprint 2020/972; `inverse` below), not
// the Fermat ladder x^(p-2): its chain is 780 cheap steps on 64-bit
// approximations, 26 linear updates of 12-word values and one Montgomery
// product, where the ladder's is 608 dependent products. Both give the
// same canonical words, so the outputs did not change. FE-easy's norm
// inversion (final_exp.cuh) runs it too. The ladder (`fermat`) stays as
// the differential reference of tests/test_torch_fp_inv_host.py and
// scripts/fp_inv_probe.py; no kernel of the package runs it.
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
// K7-inv equals the strict engine's loop of products (ops/dispatch.py
// fp_pow) limb for limb.
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

// r = x^(p-2) for canonical words x = v R: v^-1 R, and 0 for v = 0: the
// Fermat ladder, MSB-first square-and-multiply over the exponent's bits;
// the bit is the same for every thread, so the branch never diverges. r
// must not alias x: x is read again on every set bit. The reference of the
// tests and the probe; `inverse` below computes the same words.
__device__ __forceinline__ void fermat(const Fp& x, Fp& r) {
  r = x;
#pragma unroll 1
  for (int i = EXP_TOP - 1; i >= 0; --i) {
    f381::mont_mul(r, r, r);
    if ((P_MINUS_2[i / 32] >> (i % 32)) & 1) f381::mont_mul(r, x, r);
  }
}

// --- the binary-GCD inversion ------------------------------------------------
//
// For canonical words x (a number X < p), r = R^2 X^-1 mod p (v^-1 R for
// X = v R), and 0 for X = 0: the same words as fermat(x).
//
// a = X, b = p, u = 1, v = 0; then GCD_BATCHES batches, each of
// GCD_STEPS binary-GCD steps on 64-bit approximations of a and b (their
// low 30 bits exact and their top 34 bits, from the leading bit of a | b
// down: gcd_approx), which yield a matrix of signed factors, |f0| + |g0|
// <= 2^30 and |f1| + |g1| <= 2^30 (gcd_steps; a step: if a is odd, swap
// a and b when a < b, then a -= b; then a /= 2). The matrix is applied to
// the full values, (a, b) <- ((a f0 + b g0), (a f1 + b g1)) / 2^30, exact,
// each made nonnegative with its row of factors (gcd_lin), and to u and v
// mod p with one Montgomery division by 2^32 (gcd_mod). This keeps
// a = u X s and b = v X s mod p, s = 2^(2 i) after batch i. Every batch
// shortens a and b by 30 bits of their 761 (2 len(p) - 1, the exact
// algorithm's bound, which the approximations keep: Pornin, section 3),
// so after 26 batches (780 steps) a = 0, b = gcd(X, p) = 1 and X^-1 = v s:
// one product by INV_FIX = R^3 2^52 mod p gives R^2 X^-1. X = 0 leaves
// b = p and v = 0: r = 0.
//
// Constant time: the counts of batches and steps are fixed, and no branch
// or memory index depends on the value (masks and selects), as the
// reference's blst inverts; neighbouring elements take different GCD paths
// with a warp's lanes converged. 30 steps a batch, not Pornin's 31: a
// factor can reach 2^31 after 31 steps, which a signed 32-bit word does not
// hold. Factors are two's-complement u32 throughout.
constexpr int GCD_STEPS = 30;
constexpr int GCD_BATCHES = 26;  // 780 steps >= 2 * 381 - 1
__constant__ u32 INV_FIX[NW] = {0x8c5d1a2e, 0x42957fa8, 0x24cc85b1, 0xa6507a62,
                                0x39990a58, 0xd8ca1b85, 0xac2f63fc, 0xe65a054f,
                                0xe1f35417, 0x4ca0897a, 0xa0365c54, 0x032748cb};

using f381::u64;

// Leading zeros of a word, 32 for 0.
__device__ __forceinline__ u32 clz32(u32 x) {
#ifdef __CUDA_ARCH__
  return static_cast<u32>(__clz(static_cast<int>(x)));
#else
  u32 n = 0;
  for (u32 m = 0x80000000u; m != 0 && (x & m) == 0; m >>= 1) ++n;
  return n;
#endif
}

// The approximations of a and b: with n = max(len(a | b), 64), the bits
// [n - 34, n) of each above its low 30 bits; a itself when a, b < 2^64.
// The top word of a | b among words 2-11 moves into hi by masked shifts
// (words hi, mid, lo of each), then the 96 bits shift up by its leading
// zeros.
__device__ __forceinline__ void gcd_approx(const Fp& a, const Fp& b, u64& ab, u64& bb) {
  u32 ah = a.w[NW - 1], am = a.w[NW - 2], al = a.w[NW - 3];
  u32 bh = b.w[NW - 1], bm = b.w[NW - 2], bl = b.w[NW - 3];
#pragma unroll
  for (int i = NW - 4; i >= 0; --i) {
    const u32 z = 0u - static_cast<u32>((ah | bh) == 0);  // all ones: shift down a word
    ah = (am & z) | (ah & ~z);
    am = (al & z) | (am & ~z);
    al = (a.w[i] & z) | (al & ~z);
    bh = (bm & z) | (bh & ~z);
    bm = (bl & z) | (bm & ~z);
    bl = (b.w[i] & z) | (bl & ~z);
  }
  const u32 s = clz32(ah | bh);  // 0 .. 32; ah, bh have at least s leading zeros
  const u64 ta = (((static_cast<u64>(ah) << 32) | am) << s) | (static_cast<u64>(al) >> (32 - s));
  const u64 tb = (((static_cast<u64>(bh) << 32) | bm) << s) | (static_cast<u64>(bl) >> (32 - s));
  const u64 low = (1ull << GCD_STEPS) - 1;
  ab = (ta & ~low) | (a.w[0] & low);
  bb = (tb & ~low) | (b.w[0] & low);
}

// One batch's factors: GCD_STEPS steps on the approximations.
struct GcdFactors {
  u32 f0, g0, f1, g1;
};

__device__ __forceinline__ GcdFactors gcd_steps(u64 ab, u64 bb) {
  u32 f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
  for (int j = 0; j < GCD_STEPS; ++j) {
    const u64 odd = 0ull - (ab & 1);
    const u64 sw = odd & (0ull - static_cast<u64>(ab < bb));  // swap: odd and a < b
    const u64 t = (ab ^ bb) & sw;
    ab ^= t;
    bb ^= t;
    const u32 sw32 = static_cast<u32>(sw), odd32 = static_cast<u32>(odd);
    const u32 tf = (f0 ^ f1) & sw32, tg = (g0 ^ g1) & sw32;
    f0 ^= tf;
    f1 ^= tf;
    g0 ^= tg;
    g1 ^= tg;
    ab -= bb & odd;
    f0 -= f1 & odd32;
    g0 -= g1 & odd32;
    ab >>= 1;
    f1 <<= 1;
    g1 <<= 1;
  }
  return {f0, g0, f1, g1};
}

// acc <- x f, 13 words of two's complement, for |f| <= 2^30: x |f| with
// its words complemented and one added where f < 0.
__device__ __forceinline__ void gcd_mul_signed(const Fp& x, u32 f, u32 (&acc)[NW + 1]) {
  const u32 sf = 0u - (f >> 31);
  const u32 af = (f ^ sf) - sf;
  u64 carry = 0, c = sf & 1;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u64 p = static_cast<u64>(x.w[k]) * af + carry;
    carry = p >> 32;
    const u64 s = static_cast<u64>(static_cast<u32>(p) ^ sf) + c;
    acc[k] = static_cast<u32>(s);
    c = s >> 32;
  }
  acc[NW] = (static_cast<u32>(carry) ^ sf) + static_cast<u32>(c);
}

// acc <- x f + y g (mod 2^416; the value lies within 2^30 max(x, y)).
__device__ __forceinline__ void gcd_mul_pair(const Fp& x, const Fp& y, u32 f, u32 g,
                                             u32 (&acc)[NW + 1]) {
  u32 t[NW + 1];
  gcd_mul_signed(x, f, acc);
  gcd_mul_signed(y, g, t);
  u64 c = 0;
#pragma unroll
  for (int k = 0; k <= NW; ++k) {
    const u64 s = static_cast<u64>(acc[k]) + t[k] + c;
    acc[k] = static_cast<u32>(s);
    c = s >> 32;
  }
}

// r <- |x f + y g| / 2^30 for a, b of the GCD (the low 30 bits are 0);
// returns all ones where the value was negative (the row's factors then
// change sign with it), else 0.
__device__ __forceinline__ u32 gcd_lin(const Fp& x, const Fp& y, u32 f, u32 g, Fp& r) {
  u32 acc[NW + 1];
  gcd_mul_pair(x, y, f, g, acc);
  const u32 neg = 0u - (acc[NW] >> 31);
  u64 c = neg & 1;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u32 w = (acc[k] >> GCD_STEPS) | (acc[k + 1] << (32 - GCD_STEPS));
    const u64 s = static_cast<u64>(w ^ neg) + c;
    r.w[k] = static_cast<u32>(s);
    c = s >> 32;
  }
  return neg;
}

// r <- (x f + y g) / 2^32 mod p for x, y in [0, p), |f| + |g| <= 2^30:
// one Montgomery division (m p added, m = acc_0 (-p^-1) mod 2^32), the
// quotient in (-p/4, 5p/4), p added where negative, then reduced once.
__device__ __forceinline__ void gcd_mod(const Fp& x, const Fp& y, u32 f, u32 g, Fp& r) {
  u32 acc[NW + 1];
  gcd_mul_pair(x, y, f, g, acc);
  const u64 m = static_cast<u32>(acc[0] * f381::NINV);
  u64 carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u64 s = m * f381::P[k] + acc[k] + carry;
    acc[k] = static_cast<u32>(s);  // acc[0] becomes 0
    carry = s >> 32;
  }
  acc[NW] += static_cast<u32>(carry);
  const u32 neg = 0u - (acc[NW] >> 31);
  u32 t[NW];
  carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u64 s = static_cast<u64>(acc[k + 1]) + (f381::P[k] & neg) + carry;
    t[k] = static_cast<u32>(s);
    carry = s >> 32;
  }
  f381::reduce_once(t, r.w);
}

// Negates a factor under the mask neg (all ones or 0).
__device__ __forceinline__ u32 cond_neg(u32 f, u32 neg) { return (f ^ neg) - neg; }

// A batch's update of a, b, u, v by its factors; where a row's value came
// out negative, its factors change sign with it before u and v take them.
__device__ __forceinline__ void gcd_update(GcdFactors m, Fp& a, Fp& b, Fp& u, Fp& v) {
  Fp na, nb, nu, nv;
  const u32 sa = gcd_lin(a, b, m.f0, m.g0, na);
  const u32 sb = gcd_lin(a, b, m.f1, m.g1, nb);
  m.f0 = cond_neg(m.f0, sa);
  m.g0 = cond_neg(m.g0, sa);
  m.f1 = cond_neg(m.f1, sb);
  m.g1 = cond_neg(m.g1, sb);
  gcd_mod(u, v, m.f0, m.g0, nu);
  gcd_mod(u, v, m.f1, m.g1, nv);
  a = na;
  b = nb;
  u = nu;
  v = nv;
}

// One batch: the approximations, the steps, the update.
__device__ __forceinline__ void gcd_batch(Fp& a, Fp& b, Fp& u, Fp& v) {
  u64 ab, bb;
  gcd_approx(a, b, ab, bb);
  gcd_update(gcd_steps(ab, bb), a, b, u, v);
}

// r = R^2 X^-1 mod p for canonical words x (0 for X = 0). r may alias x.
__device__ __forceinline__ void inverse(const Fp& x, Fp& r) {
  Fp a = x, b, u, v, fix;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    b.w[k] = f381::P[k];
    u.w[k] = k == 0 ? 1u : 0u;
    v.w[k] = 0;
    fix.w[k] = INV_FIX[k];
  }
#pragma unroll 1
  for (int i = 0; i < GCD_BATCHES; ++i) gcd_batch(a, b, u, v);
  f381::mont_mul(v, fix, r);
}

// One element's inverse on the edge format FMT (tower381.cuh EdgeFormat),
// the entries at x[k * stride] and out[k * stride]:
//   DIGIT_ROWS  K1-inv: 30 digits of X = v R13 -> 30 digits of v^-1 R13 =
//               R13^2 X^-1 mod p;
//   LIMB_ROWS   K7-inv, the strict engine's: 24 limbs of X = v R (any
//               value below 2^384, reduced on the load) -> the 24 canonical
//               limbs of v^-1 R = R^2 X^-1 mod p, the words' own number;
// 0 for X = 0 mod p; by the binary GCD (`inverse`).
template <int FMT = t381::DIGIT_ROWS>
__device__ __forceinline__ void inv_elem(const int* x, int* out, long long stride) {
  Fp v, r;
  t381::read_row(x, stride, FMT, v);
  inverse(v, r);
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
