// Device functions of the Fp12 tower on the 32-bit Montgomery layer of
// fp381.cuh, for the kernels that split each element's work over a block's
// threads: K3 (n cyclotomic squares, cyc_sqr.cu), K4 (the fp12 product,
// fp12_mul.cu), K5 (the G2 prepare's events in one launch, prepare_step.cu),
// K6 (the Miller loop's events in one launch, miller_step.cu), K11 (the
// fp12 square, fp12_sqr.cu) and K12 (the sparse line product,
// fp12_mul_by_014.cu).
//
// The tower: Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u,
// an fp12 (a0 + a1 v + a2 v^2) + (b0 + b1 v + b2 v^2) w held as six Fp2
// values in the component order of ops/tower_lazy.py:stack12: a0, a1, a2,
// b0, b1, b2, each re then im.
//
// Value parity: every kernel computes the same field elements as its plain
// version (tower_lazy._cyc_sqr_core, tower_lazy.fp12_mul_many,
// pairing_steps.prepare_step_plain, pairing_steps.miller_step_plain,
// tower_lazy.fp12_sqr, tower_lazy.fp12_mul_by_014_many) from
// the same algebra -- the Granger-Scott square pairing the Fp2 components as
// (a0, b1), (b0, a2), (a1, b2) with xi on r1 into nb0; the Karatsuba
// product over fp6 of fp12_mul_many with the 6-leg Karatsuba of
// fp6_mul_many in each of its three fp6 products; the complex square of
// tower_lazy.fp12_sqr; the 15 Fp2 products of fp12_mul_by_014_many; the
// line scaled by P as pairing_steps._ell_legs; the Jacobian doubling and
// mixed addition of pairing_steps._doubling_step / _addition_step -- in
// exact field arithmetic on canonical words, so only the redundant digits
// differ. (The plain versions are field operations on the values the tower
// produces, |value| far below 2^390; their folds truncate larger values.)
//
// The block's program: an element's state lives in shared memory as Fp2
// "slots" of 24 words, word-major with the block's E elements interleaved
// (word k of slot s of element e at smem[(24 s + k) E + e]), so that the
// threads of a warp, on neighbouring elements, hit neighbouring banks. A
// kernel is a fixed sequence of phases; each phase is a list of independent
// operations on one element's slots (`LinOp`: a signed sum of small
// multiples of slots, some times xi; `MulOp`: one Fp2 product, square or
// scaling by an Fp, of two such sums). No operation reads a slot that
// another operation of its phase writes. The block's threads take the
// phase's (operation, element) jobs in turn, operation-major, and a
// barrier ends the phase. Each job is one thread's and holds a few Fp2
// values in registers, where the first versions held a whole fp12 and its
// intermediates a thread. The conversions at the kernel's edges are
// phases too, one job an Fp component.
//
// Compiles as host C++ too (no __CUDACC__, unsigned arithmetic only):
// tests/test_torch_tower_host.py runs each kernel's phases in order, job by
// job, under -fsanitize=undefined (K5's and K6's through their chain
// programs, on a phase runner of its own).
#pragma once

#include "fp381.cuh"
#include "lazy13.cuh"

namespace t381 {

using f381::Fp;
using f381::Fp2;
using f381::NW;
using f381::u32;
using f381::u64;

constexpr int SLOT = 2 * NW;  // words of one Fp2 slot
constexpr int DIGITS = lz::ELEM;

// (-8192 (2^390 - 1) / 8191) mod p, little-endian words: added to
// sum_k (d_k + 8192) 2^(13 k) it gives a nonnegative number of the same
// residue as the digits' value sum_k d_k 2^(13 k), for any |d_k| <= 8191
// (pinned against Python ints by tests/test_torch_tower_host.py).
__constant__ u32 DIGIT8192_FIX[NW] = {0xfb2d8b7d, 0x7378ff7f, 0x0e0bbf51, 0x99d3fbc7,
                                      0xfe2e3303, 0x591728bf, 0x1d0035bf, 0xa18b20b4,
                                      0x9f8506d8, 0x202a5a3f, 0x3a3d662f, 0x16a31853};

// --- the conversions at the kernel's edges -------------------------------------

// t mod p for t < 2^(KMAX + 1) p in TW words: 2^k p subtracted for k = KMAX
// .. 0 where it fits.
template <int TW, int KMAX>
__device__ __forceinline__ void sub_p_multiples(u32 (&t)[TW]) {
#pragma unroll
  for (int k = KMAX; k >= 0; --k) {
    u32 d[TW];
    u64 borrow = 0;
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const u32 lo = j < NW ? f381::P[j] << k : 0;
      const u32 hi = (k > 0 && j > 0) ? f381::P[j - 1] >> (32 - k) : 0;
      const u64 s = static_cast<u64>(t[j]) - (lo | hi) - borrow;
      d[j] = static_cast<u32>(s);
      borrow = (s >> 32) & 1;
    }
#pragma unroll
    for (int j = 0; j < TW; ++j) t[j] = borrow ? t[j] : d[j];
  }
}

// 30 balanced digits at src[k * stride], |d| <= 8191, R13 domain (x 2^390,
// any value the digits hold) -> canonical R16 words (x 2^384). W = sum of the
// digits biased by 8192 (each in [1, 16383]) + DIGIT8192_FIX has the value's
// residue and lies in [0, 2^391 + p) < 2^12 p; subtracting 2^k p for
// k = 11 .. 0 where it fits leaves W mod p, and a Montgomery product by
// 2^378 takes it from x 2^390 to x 2^384.
__device__ __forceinline__ void digits_to_words(const int* src, long long stride, Fp& r) {
  constexpr int TW = NW + 1;  // W < 2^392: 13 words
  u64 acc[TW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = DIGIT8192_FIX[j];
  acc[NW] = 0;
#pragma unroll
  for (int k = 0; k < DIGITS; ++k) {
    const int bit = lz::RADIX * k, j = bit / 32;
    const u64 e = static_cast<u32>(src[k * stride] + 8192);  // in [1, 16383]
    const u64 v = e << (bit % 32);                             // < 2^46
    acc[j] += v & 0xFFFFFFFF;
    acc[j + 1] += v >> 32;
  }
  u32 t[TW];
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    carry += acc[j];
    t[j] = static_cast<u32>(carry);
    carry >>= 32;
  }
  sub_p_multiples<TW, 11>(t);
  Fp x, c;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x.w[j] = t[j];
    c.w[j] = f381::R378_MOD_P[j];
  }
  f381::mont_mul(x, c, r);
}

// Canonical R16 words -> 30 balanced digits at dst[k * stride], R13 domain:
// times 2^390 mod p by a Montgomery product, cut into radix-13 digits, one
// balanced fold (|d| <= 4096; the carry out is 0 for a value below p). The
// digits are mul-ready for K3, K4, K6 and the tower's plain code.
__device__ __forceinline__ void words_to_digits(const Fp& x, int* dst, long long stride) {
  Fp c, v;
#pragma unroll
  for (int j = 0; j < NW; ++j) c.w[j] = f381::R390_MOD_P[j];
  f381::mont_mul(x, c, v);
  int d[DIGITS + 1];
#pragma unroll
  for (int k = 0; k < DIGITS; ++k) {
    const int bit = lz::RADIX * k, j = bit / 32, sh = bit % 32;
    u32 u = v.w[j] >> sh;
    if (sh > 32 - lz::RADIX && j + 1 < NW) u |= v.w[j + 1] << (32 - sh);
    d[k] = static_cast<int>(u & lz::DMASK);
  }
  lz::fold<DIGITS>(d);
#pragma unroll
  for (int k = 0; k < DIGITS; ++k) dst[k * stride] = d[k];
}

// --- the edge formats ----------------------------------------------------------
//
// A stack row holds one Fp component of its n elements, entry k of element
// i at row[k * n + i], in one of three formats:
//   DIGIT_ROWS  30 balanced radix-13 digits, R13 domain (x 2^390), the lazy
//               tower's: in by digits_to_words, out by words_to_digits;
//   LIMB_ROWS   24 strict 16-bit limbs, R16 domain (x 2^384), the strict
//               engine's (ops/convert.py fp_to_dev): word k = limb 2k | limb
//               2k + 1 << 16, the same number as the words, so no product;
//   WORD_ROWS   12 canonical words, R16 domain, the chains' own (held in
//               int32, as the word stacks of final_exp.cuh).
enum EdgeFormat : int { DIGIT_ROWS = 0, LIMB_ROWS = 1, WORD_ROWS = 2 };

// Entries of one row of a format.
__device__ __forceinline__ int row_entries(int fmt) {
  return fmt == LIMB_ROWS ? 2 * NW : fmt == WORD_ROWS ? NW : DIGITS;
}

// 24 limbs at src[k * stride] (each taken mod 2^16; any value below 2^384)
// -> canonical words: packed two to a word, then reduced by sub_p_multiples
// (2^384 < 16 p), so that a value in [p, 2^384) loads as its residue.
__device__ __forceinline__ void limbs_to_words(const int* src, long long stride, Fp& r) {
  u32 t[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
    t[k] = (static_cast<u32>(src[2 * k * stride]) & 0xFFFF) |
           (static_cast<u32>(src[(2 * k + 1) * stride]) << 16);
  sub_p_multiples<NW, 3>(t);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
}

// Canonical words -> 24 limbs at dst[k * stride].
__device__ __forceinline__ void words_to_limbs(const Fp& x, int* dst, long long stride) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    dst[2 * k * stride] = static_cast<int>(x.w[k] & 0xFFFF);
    dst[(2 * k + 1) * stride] = static_cast<int>(x.w[k] >> 16);
  }
}

// One row entry set of format fmt at src[k * stride] -> canonical words.
__device__ __forceinline__ void read_row(const int* src, long long stride, int fmt, Fp& x) {
  if (fmt == WORD_ROWS) {
#pragma unroll
    for (int k = 0; k < NW; ++k) x.w[k] = static_cast<u32>(src[k * stride]);
  } else if (fmt == LIMB_ROWS) {
    limbs_to_words(src, stride, x);
  } else {
    digits_to_words(src, stride, x);
  }
}

// Canonical words -> format fmt at dst[k * stride].
__device__ __forceinline__ void write_row(const Fp& x, int* dst, long long stride, int fmt) {
  if (fmt == WORD_ROWS) {
#pragma unroll
    for (int k = 0; k < NW; ++k) dst[k * stride] = static_cast<int>(x.w[k]);
  } else if (fmt == LIMB_ROWS) {
    words_to_limbs(x, dst, stride);
  } else {
    words_to_digits(x, dst, stride);
  }
}

// --- Fp2 operations beyond fp381.cuh -----------------------------------------

// xi a = (1 + u) a = (a0 - a1) + (a0 + a1) u. r may alias a.
__device__ __forceinline__ void mul_by_xi(const Fp2& a, Fp2& r) {
  Fp d;
  f381::sub(a.c0, a.c1, d);
  f381::add(a.c0, a.c1, r.c1);
  r.c0 = d;
}

// a^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u.
__device__ __forceinline__ void sqr(const Fp2& a, Fp2& r) {
  Fp s, d, m;
  f381::add(a.c0, a.c1, s);
  f381::sub(a.c0, a.c1, d);
  f381::mont_mul(a.c0, a.c1, m);
  f381::mont_mul(s, d, r.c0);
  f381::add(m, m, r.c1);
}

// --- one element's slots in shared memory -----------------------------------

struct Elem {
  u32* s;  // word k of slot q at s[(SLOT q + k) E]
  int E;
};

__device__ __forceinline__ void load(const Elem& m, int q, Fp2& v) {
  const u32* p = m.s + static_cast<long long>(q) * SLOT * m.E;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    v.c0.w[k] = p[k * m.E];
    v.c1.w[k] = p[(NW + k) * m.E];
  }
}

__device__ __forceinline__ void store(const Elem& m, int q, const Fp2& v) {
  u32* p = m.s + static_cast<long long>(q) * SLOT * m.E;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[k * m.E] = v.c0.w[k];
    p[(NW + k) * m.E] = v.c1.w[k];
  }
}

// Fp component h (0 re, 1 im) of slot q.
__device__ __forceinline__ void load_fp(const Elem& m, int q, int h, Fp& v) {
  const u32* p = m.s + (static_cast<long long>(q) * SLOT + h * NW) * m.E;
#pragma unroll
  for (int k = 0; k < NW; ++k) v.w[k] = p[k * m.E];
}

__device__ __forceinline__ void store_fp(const Elem& m, int q, int h, const Fp& v) {
  u32* p = m.s + (static_cast<long long>(q) * SLOT + h * NW) * m.E;
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k * m.E] = v.w[k];
}

// --- the program's operations --------------------------------------------------

// coef * (xi if xi else 1) * slot; coef 0 ends a term list.
struct Term {
  signed char slot, coef, xi;
};

constexpr int LIN_TERMS = 5;
constexpr int MUL_TERMS = 4;

// dst <- sum of the terms.
struct LinOp {
  signed char dst;
  Term t[LIN_TERMS];
};

enum MulKind : signed char { MUL = 0, SQR = 1, SCALE_RE = 2, SCALE_IM = 3 };

// dst <- X Y (MUL), X^2 (SQR, run_sqr: K3's and K5's squares), or X times the re /
// im Fp component of Y's first slot (SCALE_RE / SCALE_IM); X and Y sums of
// terms.
struct MulOp {
  signed char dst, kind;
  Term x[MUL_TERMS], y[MUL_TERMS];
};

// acc <- sum of up to n terms.
__device__ __forceinline__ void sum_terms(const Elem& m, const Term* t, int n, Fp2& acc) {
#pragma unroll
  for (int k = 0; k < NW; ++k) acc.c0.w[k] = acc.c1.w[k] = 0;
#pragma unroll 1
  for (int i = 0; i < n && t[i].coef != 0; ++i) {
    Fp2 v;
    load(m, t[i].slot, v);
    if (t[i].xi) mul_by_xi(v, v);
    const int c = t[i].coef;
#pragma unroll 1
    for (int k = c < 0 ? -c : c; k > 0; --k) {
      if (c > 0) f381::add(acc, v, acc);
      else f381::sub(acc, v, acc);
    }
  }
}

__device__ __forceinline__ void run(const Elem& m, const LinOp& op) {
  Fp2 acc;
  sum_terms(m, op.t, LIN_TERMS, acc);
  store(m, op.dst, acc);
}

__device__ __forceinline__ void run_sqr(const Elem& m, const MulOp& op) {
  Fp2 x, r;
  sum_terms(m, op.x, MUL_TERMS, x);
  sqr(x, r);
  store(m, op.dst, r);
}

// A MUL op alone (K4's and K5's products): with no scaling path compiled
// in, K5 runs ~10% faster than on run() at the same launch bound, and K4
// 2-4% (scripts/tower_probe.py, PERF.md).
__device__ __forceinline__ void run_mul(const Elem& m, const MulOp& op) {
  Fp2 x, y, r;
  sum_terms(m, op.x, MUL_TERMS, x);
  sum_terms(m, op.y, MUL_TERMS, y);
  f381::mul(x, y, r);
  store(m, op.dst, r);
}

// A MUL or SCALE op (K6's line scalings).
__device__ __forceinline__ void run(const Elem& m, const MulOp& op) {
  Fp2 x, r;
  sum_terms(m, op.x, MUL_TERMS, x);
  if (op.kind == MUL) {
    Fp2 y;
    sum_terms(m, op.y, MUL_TERMS, y);
    f381::mul(x, y, r);
  } else {
    Fp y;
    load_fp(m, op.y[0].slot, op.kind == SCALE_IM, y);
    f381::mont_mul(x.c0, y, r.c0);
    f381::mont_mul(x.c1, y, r.c1);
  }
  store(m, op.dst, r);
}

// --- K3: the cyclotomic square (tower_lazy._cyc_sqr_core) ------------------------
//
// Slots: 0-5 the element (a0, a1, a2, b0, b1, b2), 6-14 the nine Fp2
// squares p0 .. p8 of the Fp4 pairs (a0, b1), (b0, a2), (a1, b2): c0^2,
// c1^2, (c0 + c1)^2 each. Then in place: even coefficients 3t - 2z, odd
// 3t + 2z, with t0 = p0 + xi p1, t1 = p2 - p0 - p1 (and s, r likewise) and
// nb0 = 3 xi r1 + 2 b0. Each output reads only its own slot of the
// element, so the recombination writes over it.

constexpr int CYC_SLOTS = 15;

__constant__ MulOp CYC_SQUARES[9] = {
    {6, SQR, {{0, 1, 0}}, {}},              // p0 = a0^2
    {7, SQR, {{4, 1, 0}}, {}},              // p1 = b1^2
    {8, SQR, {{0, 1, 0}, {4, 1, 0}}, {}},   // p2 = (a0 + b1)^2
    {9, SQR, {{3, 1, 0}}, {}},              // p3 = b0^2
    {10, SQR, {{2, 1, 0}}, {}},             // p4 = a2^2
    {11, SQR, {{3, 1, 0}, {2, 1, 0}}, {}},  // p5 = (b0 + a2)^2
    {12, SQR, {{1, 1, 0}}, {}},             // p6 = a1^2
    {13, SQR, {{5, 1, 0}}, {}},             // p7 = b2^2
    {14, SQR, {{1, 1, 0}, {5, 1, 0}}, {}},  // p8 = (a1 + b2)^2
};

__constant__ LinOp CYC_RECOMBINE[6] = {
    {0, {{6, 3, 0}, {7, 3, 1}, {0, -2, 0}}},                // na0 = 3 t0 - 2 a0
    {4, {{8, 3, 0}, {6, -3, 0}, {7, -3, 0}, {4, 2, 0}}},    // nb1 = 3 t1 + 2 b1
    {1, {{9, 3, 0}, {10, 3, 1}, {1, -2, 0}}},               // na1 = 3 s0 - 2 a1
    {5, {{11, 3, 0}, {9, -3, 0}, {10, -3, 0}, {5, 2, 0}}},  // nb2 = 3 s1 + 2 b2
    {2, {{12, 3, 0}, {13, 3, 1}, {2, -2, 0}}},              // na2 = 3 r0 - 2 a2
    {3, {{14, 3, 1}, {12, -3, 1}, {13, -3, 1}, {3, 2, 0}}}, // nb0 = 3 xi r1 + 2 b0
};

// --- K6: the Miller events (pairing_steps.miller_step_plain) ----------------------
//
// Slots: 0-5 f (then g = f^2, then the result), 6-8 the line c0, c1, c2,
// 9 P (px re, py im), 10 c1 px and 11 c0 py (_ell_legs' a1 and a4; a0 is
// c2), 12-29 products and sums. With the square:
//   MILLER_SQR_PRODUCTS  the 12 Fp2 products of fp12_sqr's two fp6_mul
//                        (t = f0 f1 and m = (f0 + f1)(f0 + v f1), six
//                        Karatsuba legs each, the leg sums taken in the
//                        job) and the two line scalings (4 Fp products)
//   MILLER_SQR_FP6       t and m from their legs
//   MILLER_SQR_RESULT    g = (m - t - v t, 2 t) into slots 0-5
// then, and alone without the square (after MILLER_LEGS):
//   MILLER_014_PRODUCTS  the 15 Fp2 products of fp12_mul_by_014(g, c2,
//                        c1 px, c0 py)
//   MILLER_014_RESULT    their combination into slots 0-5.
// No phase writes slot 9 or reads slots 6-8 after MILLER_014_PRODUCTS, so a
// chain loads P once and the next event's line beside MILLER_014_RESULT.

constexpr int MILLER_SLOTS = 30;
constexpr int MILLER_INPUTS = 20;  // Fp components: f 12, the line 6, P 2

__constant__ MulOp MILLER_LEGS[2] = {
    {10, SCALE_RE, {{7, 1, 0}}, {{9, 1, 0}}},  // a1 = c1 px
    {11, SCALE_IM, {{6, 1, 0}}, {{9, 1, 0}}},  // a4 = c0 py
};

// f0 = (a0, a1, a2) in slots 0-2, f1 = (b0, b1, b2) in 3-5; A = f0 + f1,
// B = f0 + v f1 = (a0 + xi b2, a1 + b0, a2 + b1).
__constant__ MulOp MILLER_SQR_PRODUCTS[14] = {
    {12, MUL, {{0, 1, 0}}, {{3, 1, 0}}},                          // v0 = a0 b0
    {13, MUL, {{1, 1, 0}}, {{4, 1, 0}}},                          // v1 = a1 b1
    {14, MUL, {{2, 1, 0}}, {{5, 1, 0}}},                          // v2 = a2 b2
    {15, MUL, {{1, 1, 0}, {2, 1, 0}}, {{4, 1, 0}, {5, 1, 0}}},    // m12
    {16, MUL, {{0, 1, 0}, {1, 1, 0}}, {{3, 1, 0}, {4, 1, 0}}},    // m01
    {17, MUL, {{0, 1, 0}, {2, 1, 0}}, {{3, 1, 0}, {5, 1, 0}}},    // m02
    {18, MUL, {{0, 1, 0}, {3, 1, 0}}, {{0, 1, 0}, {5, 1, 1}}},    // V0 = A0 B0
    {19, MUL, {{1, 1, 0}, {4, 1, 0}}, {{1, 1, 0}, {3, 1, 0}}},    // V1 = A1 B1
    {20, MUL, {{2, 1, 0}, {5, 1, 0}}, {{2, 1, 0}, {4, 1, 0}}},    // V2 = A2 B2
    {21, MUL, {{1, 1, 0}, {4, 1, 0}, {2, 1, 0}, {5, 1, 0}},       // M12 = (A1 + A2)
     {{1, 1, 0}, {3, 1, 0}, {2, 1, 0}, {4, 1, 0}}},               //       (B1 + B2)
    {22, MUL, {{0, 1, 0}, {3, 1, 0}, {1, 1, 0}, {4, 1, 0}},       // M01 = (A0 + A1)
     {{0, 1, 0}, {5, 1, 1}, {1, 1, 0}, {3, 1, 0}}},               //       (B0 + B1)
    {23, MUL, {{0, 1, 0}, {3, 1, 0}, {2, 1, 0}, {5, 1, 0}},       // M02 = (A0 + A2)
     {{0, 1, 0}, {5, 1, 1}, {2, 1, 0}, {4, 1, 0}}},               //       (B0 + B2)
    {10, SCALE_RE, {{7, 1, 0}}, {{9, 1, 0}}},                     // a1 = c1 px
    {11, SCALE_IM, {{6, 1, 0}}, {{9, 1, 0}}},                     // a4 = c0 py
};

// fp6_mul's interpolation: c0 = v0 + xi (m12 - v1 - v2), c1 = m01 - v0 -
// v1 + xi v2, c2 = m02 - v0 - v2 + v1; t into 24-26, m into 27-29.
__constant__ LinOp MILLER_SQR_FP6[6] = {
    {24, {{12, 1, 0}, {15, 1, 1}, {13, -1, 1}, {14, -1, 1}}},
    {25, {{16, 1, 0}, {12, -1, 0}, {13, -1, 0}, {14, 1, 1}}},
    {26, {{17, 1, 0}, {12, -1, 0}, {14, -1, 0}, {13, 1, 0}}},
    {27, {{18, 1, 0}, {21, 1, 1}, {19, -1, 1}, {20, -1, 1}}},
    {28, {{22, 1, 0}, {18, -1, 0}, {19, -1, 0}, {20, 1, 1}}},
    {29, {{23, 1, 0}, {18, -1, 0}, {20, -1, 0}, {19, 1, 0}}},
};

// g0 = m - t - v t = (m0 - t0 - xi t2, m1 - t1 - t0, m2 - t2 - t1), g1 = 2 t.
__constant__ LinOp MILLER_SQR_RESULT[6] = {
    {0, {{27, 1, 0}, {24, -1, 0}, {26, -1, 1}}},
    {1, {{28, 1, 0}, {25, -1, 0}, {24, -1, 0}}},
    {2, {{29, 1, 0}, {26, -1, 0}, {25, -1, 0}}},
    {3, {{24, 2, 0}}},
    {4, {{25, 2, 0}}},
    {5, {{26, 2, 0}}},
};

// fp12_mul_by_014(g, c0 = c2 (slot 8), c1 = a1 (10), c4 = a4 (11)), s = g0 + g1,
// c14 = a1 + a4: t00 .. t11 into 12-17, m2, m0, m1 into 18-20, u00 .. u11
// into 21-26.
__constant__ MulOp MILLER_014_PRODUCTS[15] = {
    {12, MUL, {{0, 1, 0}}, {{8, 1, 0}}},                        // t00 = g0_0 c0
    {13, MUL, {{1, 1, 0}}, {{8, 1, 0}}},                        // t10 = g0_1 c0
    {14, MUL, {{2, 1, 0}}, {{8, 1, 0}}},                        // t20 = g0_2 c0
    {15, MUL, {{2, 1, 0}}, {{10, 1, 0}}},                       // t21 = g0_2 c1
    {16, MUL, {{0, 1, 0}}, {{10, 1, 0}}},                       // t01 = g0_0 c1
    {17, MUL, {{1, 1, 0}}, {{10, 1, 0}}},                       // t11 = g0_1 c1
    {18, MUL, {{5, 1, 0}}, {{11, 1, 0}}},                       // m2 = g1_2 c4
    {19, MUL, {{3, 1, 0}}, {{11, 1, 0}}},                       // m0 = g1_0 c4
    {20, MUL, {{4, 1, 0}}, {{11, 1, 0}}},                       // m1 = g1_1 c4
    {21, MUL, {{0, 1, 0}, {3, 1, 0}}, {{8, 1, 0}}},             // u00 = s0 c0
    {22, MUL, {{1, 1, 0}, {4, 1, 0}}, {{8, 1, 0}}},             // u10 = s1 c0
    {23, MUL, {{2, 1, 0}, {5, 1, 0}}, {{8, 1, 0}}},             // u20 = s2 c0
    {24, MUL, {{2, 1, 0}, {5, 1, 0}}, {{10, 1, 0}, {11, 1, 0}}},  // u21 = s2 c14
    {25, MUL, {{0, 1, 0}, {3, 1, 0}}, {{10, 1, 0}, {11, 1, 0}}},  // u01 = s0 c14
    {26, MUL, {{1, 1, 0}, {4, 1, 0}}, {{10, 1, 0}, {11, 1, 0}}},  // u11 = s1 c14
};

// aa = (t00 + xi t21, t01 + t10, t11 + t20), bb = (xi m2, m0, m1), mid = (u00
// + xi u21, u01 + u10, u11 + u20): f0 = v bb + aa, f1 = mid - aa - bb.
__constant__ LinOp MILLER_014_RESULT[6] = {
    {0, {{12, 1, 0}, {15, 1, 1}, {20, 1, 1}}},
    {1, {{16, 1, 0}, {13, 1, 0}, {18, 1, 1}}},
    {2, {{17, 1, 0}, {14, 1, 0}, {19, 1, 0}}},
    {3, {{21, 1, 0}, {24, 1, 1}, {12, -1, 0}, {15, -1, 1}, {18, -1, 1}}},
    {4, {{25, 1, 0}, {22, 1, 0}, {16, -1, 0}, {13, -1, 0}, {19, -1, 0}}},
    {5, {{26, 1, 0}, {23, 1, 0}, {17, -1, 0}, {14, -1, 0}, {20, -1, 0}}},
};

// --- K4: the fp12 product (tower_lazy.fp12_mul_many) -----------------------------
//
// Slots: 0-5 a = (a0, a1), 6-11 b = (b0, b1), 12-29 the 18 Fp2 products:
// fp6_mul's six Karatsuba legs (v0, v1, v2, m12, m01, m02) of t0 = a0 b0
// into 12-17, of t1 = a1 b1 into 18-23 and of t2 = (a0 + a1)(b0 + b1) into
// 24-29 (its leg operands sums of up to four slots). Then t0, t1, t2 from
// their legs into the dead slots 0-8, and the result c0 = t0 + v t1, c1 =
// t2 - t0 - t1 into 12-17, whence the store.

constexpr int FP12_MUL_SLOTS = 30;
constexpr int FP12_MUL_OUT = 12;  // the result's first slot

__constant__ MulOp FP12_MUL_PRODUCTS[18] = {
    {12, MUL, {{0, 1, 0}}, {{6, 1, 0}}},                        // t0: v0 = a00 b00
    {13, MUL, {{1, 1, 0}}, {{7, 1, 0}}},                        //     v1 = a01 b01
    {14, MUL, {{2, 1, 0}}, {{8, 1, 0}}},                        //     v2 = a02 b02
    {15, MUL, {{1, 1, 0}, {2, 1, 0}}, {{7, 1, 0}, {8, 1, 0}}},  //     m12
    {16, MUL, {{0, 1, 0}, {1, 1, 0}}, {{6, 1, 0}, {7, 1, 0}}},  //     m01
    {17, MUL, {{0, 1, 0}, {2, 1, 0}}, {{6, 1, 0}, {8, 1, 0}}},  //     m02
    {18, MUL, {{3, 1, 0}}, {{9, 1, 0}}},                        // t1: v0 = a10 b10
    {19, MUL, {{4, 1, 0}}, {{10, 1, 0}}},                       //     v1
    {20, MUL, {{5, 1, 0}}, {{11, 1, 0}}},                       //     v2
    {21, MUL, {{4, 1, 0}, {5, 1, 0}}, {{10, 1, 0}, {11, 1, 0}}},  //   m12
    {22, MUL, {{3, 1, 0}, {4, 1, 0}}, {{9, 1, 0}, {10, 1, 0}}},   //   m01
    {23, MUL, {{3, 1, 0}, {5, 1, 0}}, {{9, 1, 0}, {11, 1, 0}}},   //   m02
    {24, MUL, {{0, 1, 0}, {3, 1, 0}}, {{6, 1, 0}, {9, 1, 0}}},    // t2 on A = a0 + a1,
    {25, MUL, {{1, 1, 0}, {4, 1, 0}}, {{7, 1, 0}, {10, 1, 0}}},   //    B = b0 + b1: v0,
    {26, MUL, {{2, 1, 0}, {5, 1, 0}}, {{8, 1, 0}, {11, 1, 0}}},   //    v1, v2,
    {27, MUL, {{1, 1, 0}, {4, 1, 0}, {2, 1, 0}, {5, 1, 0}},       //    m12 = (A1 + A2)
     {{7, 1, 0}, {10, 1, 0}, {8, 1, 0}, {11, 1, 0}}},             //          (B1 + B2),
    {28, MUL, {{0, 1, 0}, {3, 1, 0}, {1, 1, 0}, {4, 1, 0}},       //    m01,
     {{6, 1, 0}, {9, 1, 0}, {7, 1, 0}, {10, 1, 0}}},
    {29, MUL, {{0, 1, 0}, {3, 1, 0}, {2, 1, 0}, {5, 1, 0}},       //    m02
     {{6, 1, 0}, {9, 1, 0}, {8, 1, 0}, {11, 1, 0}}},
};

// fp6_mul's interpolation of each product's legs (v0 .. m02 at l .. l + 5):
// c0 = v0 + xi (m12 - v1 - v2), c1 = m01 - v0 - v1 + xi v2, c2 = m02 - v0 -
// v2 + v1; t0 into 0-2, t1 into 3-5, t2 into 6-8.
__constant__ LinOp FP12_MUL_FP6[9] = {
    {0, {{12, 1, 0}, {15, 1, 1}, {13, -1, 1}, {14, -1, 1}}},
    {1, {{16, 1, 0}, {12, -1, 0}, {13, -1, 0}, {14, 1, 1}}},
    {2, {{17, 1, 0}, {12, -1, 0}, {14, -1, 0}, {13, 1, 0}}},
    {3, {{18, 1, 0}, {21, 1, 1}, {19, -1, 1}, {20, -1, 1}}},
    {4, {{22, 1, 0}, {18, -1, 0}, {19, -1, 0}, {20, 1, 1}}},
    {5, {{23, 1, 0}, {18, -1, 0}, {20, -1, 0}, {19, 1, 0}}},
    {6, {{24, 1, 0}, {27, 1, 1}, {25, -1, 1}, {26, -1, 1}}},
    {7, {{28, 1, 0}, {24, -1, 0}, {25, -1, 0}, {26, 1, 1}}},
    {8, {{29, 1, 0}, {24, -1, 0}, {26, -1, 0}, {25, 1, 0}}},
};

// c0 = t0 + v t1 = (t0_0 + xi t1_2, t0_1 + t1_0, t0_2 + t1_1), c1 = t2 - t0 - t1.
__constant__ LinOp FP12_MUL_RESULT[6] = {
    {12, {{0, 1, 0}, {5, 1, 1}}},
    {13, {{1, 1, 0}, {3, 1, 0}}},
    {14, {{2, 1, 0}, {4, 1, 0}}},
    {15, {{6, 1, 0}, {0, -1, 0}, {3, -1, 0}}},
    {16, {{7, 1, 0}, {1, -1, 0}, {4, -1, 0}}},
    {17, {{8, 1, 0}, {2, -1, 0}, {5, -1, 0}}},
};

// --- K5: the G2 prepare events (pairing_steps._doubling_step, _addition_step) ---
//
// Slots: 0-2 R = (x, y, z), 3-4 Q = (qx, qy), then the event's squares and
// products, and the output, (nx, ny, nz, c0, c1, c2), in 20-25. Neither
// form writes slots 0-4, so Q, loaded once, serves every addition of a
// chain. The plain code's linear steps are folded into the operand sums of
// the products that read them and into the last phase's sums.
//
// The doubling, 25 Fp products in three phases: t0 = x^2 (5), t1 = y^2 (6),
// zsq = z^2 (7), w = (z + y)^2 (8); t2 = t1^2 (9), s = (t1 + x)^2 (10), t5 =
// (3 t0)^2 (11), u = (x + 3 t0)^2 = t6^2 (12), m1 = nz zsq (13) with nz = w -
// t1 - zsq, m2 = 3 t0 zsq (14); m0 = (t3 - nx) 3 t0 (15), where t3 = 2 (s -
// t0 - t2) and nx = t5 - 2 t3, so t3 - nx = 6 s - 6 t0 - 6 t2 - t5.

constexpr int PREPARE_SLOTS = 26;
constexpr int PREPARE_OUT = 20;  // nx, ny, nz, c0, c1, c2 in 20-25
constexpr int PREPARE_INPUTS = 10;  // Fp components: R 6, Q 4

__constant__ MulOp PREPARE_DBL_PRODUCTS[11] = {
    {5, SQR, {{0, 1, 0}}, {}},                                          // t0 = x^2
    {6, SQR, {{1, 1, 0}}, {}},                                          // t1 = y^2
    {7, SQR, {{2, 1, 0}}, {}},                                          // zsq = z^2
    {8, SQR, {{2, 1, 0}, {1, 1, 0}}, {}},                               // w = (z + y)^2
    {9, SQR, {{6, 1, 0}}, {}},                                          // t2 = t1^2
    {10, SQR, {{6, 1, 0}, {0, 1, 0}}, {}},                              // s = (t1 + x)^2
    {11, SQR, {{5, 3, 0}}, {}},                                         // t5 = t4^2
    {12, SQR, {{0, 1, 0}, {5, 3, 0}}, {}},                              // u = t6^2
    {13, MUL, {{8, 1, 0}, {6, -1, 0}, {7, -1, 0}}, {{7, 1, 0}}},        // m1 = nz zsq
    {14, MUL, {{5, 3, 0}}, {{7, 1, 0}}},                                // m2 = t4 zsq
    {15, MUL, {{10, 6, 0}, {5, -6, 0}, {9, -6, 0}, {11, -1, 0}}, {{5, 3, 0}}},  // m0
};

// nx = t5 - 2 t3, ny = m0 - 8 t2, nz = w - t1 - zsq, c0 = 2 m1, c1 = -2 m2,
// c2 = t6^2 - t0 - t5 - 4 t1.
__constant__ LinOp PREPARE_DBL_RESULT[6] = {
    {20, {{11, 1, 0}, {10, -4, 0}, {5, 4, 0}, {9, 4, 0}}},
    {21, {{15, 1, 0}, {9, -8, 0}}},
    {22, {{8, 1, 0}, {6, -1, 0}, {7, -1, 0}}},
    {23, {{13, 2, 0}}},
    {24, {{14, -2, 0}}},
    {25, {{12, 1, 0}, {5, -1, 0}, {11, -1, 0}, {6, -4, 0}}},
};

// The mixed addition, 37 Fp products in five phases: zsq = z^2 (5), ysq =
// qy^2 (6), w = (qy + z)^2 (7); t0 = zsq qx (8), t1 = (w - ysq - zsq) zsq
// (9); with t2 = t0 - x and t6 = t1 - 2 y: t3 = t2^2 (10), h = (z + t2)^2
// (11), t6^2 (12), t9 = t6 qx (13); with t4 = 4 t3 and nz = h - zsq - t3:
// t5 = t4 t2 (14), t7 = t4 x (15), g = (qy + nz)^2 (16), nz^2 (17); t8 =
// (t7 - nx) t6 (18) with nx = t6^2 - t5 - 2 t7, so t7 - nx = 3 t7 - t6^2 +
// t5, and m2 = y t5 (19).
__constant__ MulOp PREPARE_ADD_PRODUCTS[15] = {
    {5, SQR, {{2, 1, 0}}, {}},                                          // zsq
    {6, SQR, {{4, 1, 0}}, {}},                                          // ysq
    {7, SQR, {{4, 1, 0}, {2, 1, 0}}, {}},                               // w
    {8, MUL, {{5, 1, 0}}, {{3, 1, 0}}},                                 // t0
    {9, MUL, {{7, 1, 0}, {6, -1, 0}, {5, -1, 0}}, {{5, 1, 0}}},         // t1
    {10, SQR, {{8, 1, 0}, {0, -1, 0}}, {}},                             // t3
    {11, SQR, {{2, 1, 0}, {8, 1, 0}, {0, -1, 0}}, {}},                  // h
    {12, SQR, {{9, 1, 0}, {1, -2, 0}}, {}},                             // t6^2
    {13, MUL, {{9, 1, 0}, {1, -2, 0}}, {{3, 1, 0}}},                    // t9
    {14, MUL, {{10, 4, 0}}, {{8, 1, 0}, {0, -1, 0}}},                   // t5
    {15, MUL, {{10, 4, 0}}, {{0, 1, 0}}},                               // t7
    {16, SQR, {{4, 1, 0}, {11, 1, 0}, {5, -1, 0}, {10, -1, 0}}, {}},    // g
    {17, SQR, {{11, 1, 0}, {5, -1, 0}, {10, -1, 0}}, {}},               // nz^2
    {18, MUL, {{15, 3, 0}, {12, -1, 0}, {14, 1, 0}}, {{9, 1, 0}, {1, -2, 0}}},  // t8
    {19, MUL, {{1, 1, 0}}, {{14, 1, 0}}},                               // m2
};

// nx = t6^2 - t5 - 2 t7, ny = t8 - 2 m2, nz = h - zsq - t3, c0 = 2 nz, c1 =
// -2 t6, c2 = 2 t9 - (g - ysq - nz^2).
__constant__ LinOp PREPARE_ADD_RESULT[6] = {
    {20, {{12, 1, 0}, {14, -1, 0}, {15, -2, 0}}},
    {21, {{18, 1, 0}, {19, -2, 0}}},
    {22, {{11, 1, 0}, {5, -1, 0}, {10, -1, 0}}},
    {23, {{11, 2, 0}, {5, -2, 0}, {10, -2, 0}}},
    {24, {{9, -2, 0}, {1, 4, 0}}},
    {25, {{13, 2, 0}, {16, -1, 0}, {6, 1, 0}, {17, 1, 0}}},
};

// The product phases of each form: PREPARE_*_PRODUCTS[first[k] .. first[k + 1]).
__constant__ signed char PREPARE_DBL_FIRST[4] = {0, 4, 10, 11};
__constant__ signed char PREPARE_ADD_FIRST[6] = {0, 3, 5, 9, 13, 15};

// --- K11 and K12: K6's two halves on its tables --------------------------------
//
// K11, the fp12 square (tower_lazy.fp12_sqr): f in slots 0-5, the first
// FP12_SQR_LEGS ops of MILLER_SQR_PRODUCTS (the Karatsuba legs of t and m
// into 12-23; the last two, the line's scalings, read slots 6, 7 and 9,
// which K11 never loads), MILLER_SQR_FP6 (t and m into 24-29),
// MILLER_SQR_RESULT (the square into 0-5). K12, f times the sparse line
// (tower_lazy.fp12_mul_by_014_many): f in slots 0-5 and the line's rows c0,
// c1, c4 in slots 8, 10 and 11, where K6's LEGS leave c2, c1 px and c0 py;
// MILLER_014_PRODUCTS (12-26), MILLER_014_RESULT (the product into 0-5).
// Both run the phases in K6's order and store slots 0-5.

constexpr int FP12_SQR_SLOTS = MILLER_SLOTS;
constexpr int FP12_SQR_LEGS = 12;
constexpr int MUL_BY_014_SLOTS = 27;

// --- the kernels' phases ---------------------------------------------------------
//
// A block holds elements [i0, i0 + E) of the batch, n elements in all; the
// stacks are (rows, K, n) in one of the edge formats (K = 30 digits unless
// a chain's edge names another), Fp component c of element i at
// src[c K n + i] (entry k at + k n). A phase's jobs are (op, e), numbered
// op E + e, so that neighbouring threads take neighbouring elements of one
// operation: the loads and stores of a digit row coalesce. Jobs of an
// element outside the batch load zeros and store nothing.

struct Block {
  u32* smem;  // E elements' slots, E * slots * SLOT words
  int E;
  long long i0, n;
  __device__ __forceinline__ Elem elem(int e) const { return Elem{smem + e, E}; }
};

// Row `row` of the stack src, of format fmt -> Fp component c (slot c / 2,
// half c % 2).
__device__ __forceinline__ void load_component(const Block& b, const int* src, int row, int c,
                                               int e, int fmt = DIGIT_ROWS) {
  const long long i = b.i0 + e;
  Fp x;
  if (i < b.n) {
    read_row(src + static_cast<long long>(row) * row_entries(fmt) * b.n + i, b.n, fmt, x);
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) x.w[k] = 0;
  }
  store_fp(b.elem(e), c / 2, c % 2, x);
}

// Fp component c <- one (R mod p) or zero: the chains' starting values.
__device__ __forceinline__ void set_component(const Block& b, int c, bool one, int e) {
  Fp x;
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = one ? f381::R_MOD_P[k] : 0;
  store_fp(b.elem(e), c / 2, c % 2, x);
}

// Fp component `from` (slot from / 2, half from % 2) -> row c of the stack
// dst, of format fmt; negated first when asked (p - x, 0 for 0).
__device__ __forceinline__ void store_component(const Block& b, int* dst, int c, int from,
                                                int e, int fmt = DIGIT_ROWS,
                                                bool negate = false) {
  const long long i = b.i0 + e;
  if (i >= b.n) return;
  Fp x;
  load_fp(b.elem(e), from / 2, from % 2, x);
  if (negate) f381::neg(x, x);
  write_row(x, dst + static_cast<long long>(c) * row_entries(fmt) * b.n + i, b.n, fmt);
}

// K3: phase 0 loads x, phases 1 + 2 s and 2 + 2 s are square s's nine
// squares and recombination, phase 1 + 2 nsq stores.
__device__ __forceinline__ int cyc_sqr_phases(int nsq) { return 2 * nsq + 2; }

__device__ __forceinline__ int cyc_sqr_jobs(int ph, int nsq) {
  if (ph == 0 || ph == 2 * nsq + 1) return 12;
  return ph % 2 ? 9 : 6;
}

__device__ __forceinline__ void cyc_sqr_job(const Block& b, const int* x, int* out, int nsq,
                                            int ph, int op, int e) {
  if (ph == 0) load_component(b, x, op, op, e);
  else if (ph == 2 * nsq + 1) store_component(b, out, op, op, e);
  else if (ph % 2) run_sqr(b.elem(e), CYC_SQUARES[op]);
  else run(b.elem(e), CYC_RECOMBINE[op]);
}

// K4: LOAD (a into components 0-11, b into 12-23), PRODUCTS, FP6, RESULT,
// STORE from slot FP12_MUL_OUT (or, when the kernel runs its edges alone,
// a from slot 0). The edges' formats are template parameters, as the
// chains': a and b of format IN_FMT, out of format OUT_FMT (the unfused
// path's digits throughout; the multi-pairings' fold words in, words or
// strict limbs out). The product is the same field element in any layout:
// no conjugation at the edges.
enum Fp12MulStep { M12_LOAD, M12_PRODUCTS, M12_FP6, M12_RESULT, M12_STORE };

constexpr int FP12_MUL_PHASES = 5;

__device__ __forceinline__ int fp12_mul_jobs(int ph) {
  switch (ph) {
    case M12_LOAD: return 24;
    case M12_PRODUCTS: return 18;
    case M12_FP6: return 9;
    case M12_RESULT: return 6;
    default: return 12;
  }
}

template <int IN_FMT = DIGIT_ROWS, int OUT_FMT = DIGIT_ROWS>
__device__ __forceinline__ void fp12_mul_job(const Block& b, const int* x, const int* y, int* out,
                                             int edges_only, int ph, int op, int e) {
  switch (ph) {
    case M12_LOAD:
      if (op < 12) load_component(b, x, op, op, e, IN_FMT);
      else load_component(b, y, op - 12, op, e, IN_FMT);
      break;
    case M12_PRODUCTS: run_mul(b.elem(e), FP12_MUL_PRODUCTS[op]); break;
    case M12_FP6: run(b.elem(e), FP12_MUL_FP6[op]); break;
    case M12_RESULT: run(b.elem(e), FP12_MUL_RESULT[op]); break;
    default:
      store_component(b, out, op, edges_only ? op : 2 * FP12_MUL_OUT + op, e, OUT_FMT);
      break;
  }
}

// K11: LOAD (f into components 0-11), PRODUCTS, FP6, RESULT, STORE (slots
// 0-5; when the kernel runs its edges alone, out = f).
enum Fp12SqrStep { S12_LOAD, S12_PRODUCTS, S12_FP6, S12_RESULT, S12_STORE };

constexpr int FP12_SQR_PHASES = 5;

__device__ __forceinline__ int fp12_sqr_jobs(int ph) {
  switch (ph) {
    case S12_PRODUCTS: return FP12_SQR_LEGS;
    case S12_FP6:
    case S12_RESULT: return 6;
    default: return 12;
  }
}

__device__ __forceinline__ void fp12_sqr_job(const Block& b, const int* x, int* out, int ph,
                                             int op, int e) {
  switch (ph) {
    case S12_LOAD: load_component(b, x, op, op, e); break;
    case S12_PRODUCTS: run_mul(b.elem(e), MILLER_SQR_PRODUCTS[op]); break;
    case S12_FP6: run(b.elem(e), MILLER_SQR_FP6[op]); break;
    case S12_RESULT: run(b.elem(e), MILLER_SQR_RESULT[op]); break;
    default: store_component(b, out, op, op, e); break;
  }
}

// K12: LOAD (f into components 0-11; the line's rows c0[0], c0[1] into 16-17,
// c1[0], c1[1] into 20-21, c4[0], c4[1] into 22-23), PRODUCTS, RESULT, STORE
// (slots 0-5; when the kernel runs its edges alone, out = f).
enum MulBy014Step { B014_LOAD, B014_PRODUCTS, B014_RESULT, B014_STORE };

constexpr int MUL_BY_014_PHASES = 4;

__device__ __forceinline__ int mul_by_014_jobs(int ph) {
  switch (ph) {
    case B014_LOAD: return 18;
    case B014_PRODUCTS: return 15;
    case B014_RESULT: return 6;
    default: return 12;
  }
}

__device__ __forceinline__ void mul_by_014_job(const Block& b, const int* f, const int* c,
                                               int* out, int ph, int op, int e) {
  switch (ph) {
    case B014_LOAD:
      if (op < 12) load_component(b, f, op, op, e);
      else load_component(b, c, op - 12, op < 14 ? op + 4 : op + 6, e);
      break;
    case B014_PRODUCTS: run_mul(b.elem(e), MILLER_014_PRODUCTS[op]); break;
    case B014_RESULT: run(b.elem(e), MILLER_014_RESULT[op]); break;
    default: store_component(b, out, op, op, e); break;
  }
}

// --- K5 and K6 as chains: a whole scan of the fused pairing in one launch ----------
//
// The JAX package runs the prepare's 68 events and the Miller loop's 68 as
// lax.scans of one tower_fused kernel each (curves/pairing.py:242, :342).
// Here each scan is one block program: the element's state (R, or f and P)
// stays in the slots as canonical words from the first event to the last,
// and only the lines cross the stacks, one row (6 Fp components) an event.
// A chain is written once, over a phase runner `phase(ops, job)` that runs
// job(op, e) for op < ops and every element e of the block, then a barrier
// (BlockPhases on the card; tests/test_torch_tower_host.py runs the jobs in
// order or reversed). A single event is the chain of one.

constexpr int MAX_EVENTS = 128;

// n events, bit i of dbl set where event i is a doubling (the prepare's
// doubling step; the Miller loop's square and line), clear where it is an
// addition (the mixed addition of Q; the line alone).
struct Schedule {
  int n;
  u32 dbl[MAX_EVENTS / 32];
  __device__ __forceinline__ bool is_dbl(int i) const { return (dbl[i / 32] >> (i % 32)) & 1u; }
};

// Event ev's line in a coefficient stack (events, 6, K, n) of format fmt.
__device__ __forceinline__ long long line_offset(const Block& b, int ev, int fmt) {
  return static_cast<long long>(ev) * 6 * row_entries(fmt) * b.n;
}

// K5-chain: R (6, K, n) and Q (4, K, n) in, of format IN_FMT; without R
// (r null), R = (Q, 1) formed at LOAD, z = R mod p; without Q (q null), no
// event may be an addition. Each event's line into row ev of coeffs
// (events, 6, K', n), after the last event R into r_out (6, K', n) when it
// is given, of format OUT_FMT. With edges_only, the conversions alone:
// each line holds R's components, and r_out R. The formats are template
// parameters of the chain: each instantiation keeps its own conversions.
struct PrepareChain {
  const int* r;
  const int* q;
  int* coeffs;
  int* r_out;
  Schedule s;
  int edges_only;
};

__device__ __forceinline__ void prepare_product(const Block& b, bool is_add, int k, int e) {
  const MulOp& m = is_add ? PREPARE_ADD_PRODUCTS[k] : PREPARE_DBL_PRODUCTS[k];
  if (m.kind == SQR) run_sqr(b.elem(e), m);
  else run_mul(b.elem(e), m);
}

// The phases: LOAD (R into components 0-5, Q into 6-9), then for each event
// its product phases (3 for a doubling, 5 for an addition), RESULT (the new
// point and the line into slots 20-25) and NEXT (the line stored; R' copied
// into slots 0-2, or, after the last event, stored). RESULT cannot write R'
// into slots 0-2 itself: the addition's c1 reads y.
template <int IN_FMT = DIGIT_ROWS, int OUT_FMT = DIGIT_ROWS, class Phase>
__device__ __forceinline__ void prepare_chain(const Block& b, const PrepareChain& c,
                                              const Phase& phase) {
  phase(c.q ? PREPARE_INPUTS : 6, [&](int op, int e) {
    if (op >= 6) load_component(b, c.q, op - 6, op, e, IN_FMT);
    else if (c.r) load_component(b, c.r, op, op, e, IN_FMT);
    else if (op < 4) load_component(b, c.q, op, op, e, IN_FMT);
    else set_component(b, op, op == 4, e);
  });
  for (int ev = 0; ev < c.s.n; ++ev) {
    const bool is_add = !c.s.is_dbl(ev);
    if (!c.edges_only) {
      const signed char* first = is_add ? PREPARE_ADD_FIRST : PREPARE_DBL_FIRST;
      const int np = is_add ? 5 : 3;
      for (int k = 0; k < np; ++k)
        phase(first[k + 1] - first[k],
              [&](int op, int e) { prepare_product(b, is_add, first[k] + op, e); });
      phase(6, [&](int op, int e) {
        run(b.elem(e), is_add ? PREPARE_ADD_RESULT[op] : PREPARE_DBL_RESULT[op]);
      });
    }
    const bool last = ev + 1 == c.s.n;
    const int r_from = c.edges_only ? 0 : 2 * PREPARE_OUT;  // R's first component
    int* line = c.coeffs + line_offset(b, ev, OUT_FMT);
    const int tail = last ? (c.r_out ? 6 : 0) : (c.edges_only ? 0 : 3);
    phase(6 + tail, [&](int op, int e) {
      if (op < 6) {
        store_component(b, line, op, c.edges_only ? op : 2 * (PREPARE_OUT + 3) + op, e,
                        OUT_FMT);
      } else if (last) {
        store_component(b, c.r_out, op - 6, r_from + op - 6, e, OUT_FMT);
      } else {
        Fp2 v;
        load(b.elem(e), PREPARE_OUT + op - 6, v);
        store(b.elem(e), op - 6, v);
      }
    });
  }
}

// K6-chain: f (12, 30, n) digits, the lines coeffs (events, 6, K, n) of
// format LINE_FMT and P (2, K', n) of format P_FMT in (template parameters,
// as K5-chain's); without f (f null), f = one formed at LOAD. After the
// events, out of format F_FMT: DIGIT_ROWS f as (12, 30, n) digits;
// WORD_ROWS conj(f) as (12, 12, n) words (the fused pairing's hand-over to
// FE-easy) or LIMB_ROWS conj(f) as (12, 24, n) canonical strict limbs (the
// strict engine's Miller loop), components 6-11 negated in the store (x <
// 0 conjugates the Miller loop; the negation of 0 is 0). With edges_only,
// the conversions alone: f, P and every line in, out = f (conj(f) in the
// store's format).
struct MillerChain {
  const int* f;
  const int* coeffs;
  const int* pxy;
  int* out;
  Schedule s;
  int edges_only;
};

// The phases: LOAD (f into components 0-11, the first line into 12-17, P
// into 18-19), then for each event SQR_PRODUCTS (with MILLER_LEGS), SQR_FP6,
// SQR_RESULT at a doubling or LEGS alone at an addition, P014, then R014
// beside the next event's line; STORE (slots 0-5). The products without a
// scaling run on run_mul, as K11's and K12's.
template <int LINE_FMT = DIGIT_ROWS, int P_FMT = DIGIT_ROWS, int F_FMT = DIGIT_ROWS,
          class Phase>
__device__ __forceinline__ void miller_chain(const Block& b, const MillerChain& c,
                                             const Phase& phase) {
  phase(MILLER_INPUTS, [&](int op, int e) {
    if (op >= 18) load_component(b, c.pxy, op - 18, op, e, P_FMT);
    else if (op >= 12) load_component(b, c.coeffs, op - 12, op, e, LINE_FMT);
    else if (c.f) load_component(b, c.f, op, op, e);
    else set_component(b, op, op == 0, e);
  });
  for (int ev = 0; ev < c.s.n; ++ev) {
    const bool next = ev + 1 < c.s.n;
    const int* line = next ? c.coeffs + line_offset(b, ev + 1, LINE_FMT) : nullptr;
    const auto load_line = [&](int op, int e) {
      load_component(b, line, op, 12 + op, e, LINE_FMT);
    };
    if (c.edges_only) {
      if (next) phase(6, load_line);
      continue;
    }
    if (c.s.is_dbl(ev)) {
      phase(14, [&](int op, int e) {
        if (op < FP12_SQR_LEGS) run_mul(b.elem(e), MILLER_SQR_PRODUCTS[op]);
        else run(b.elem(e), MILLER_SQR_PRODUCTS[op]);
      });
      phase(6, [&](int op, int e) { run(b.elem(e), MILLER_SQR_FP6[op]); });
      phase(6, [&](int op, int e) { run(b.elem(e), MILLER_SQR_RESULT[op]); });
    } else {
      phase(2, [&](int op, int e) { run(b.elem(e), MILLER_LEGS[op]); });
    }
    phase(15, [&](int op, int e) { run_mul(b.elem(e), MILLER_014_PRODUCTS[op]); });
    phase(next ? 12 : 6, [&](int op, int e) {
      if (op < 6) run(b.elem(e), MILLER_014_RESULT[op]);
      else load_line(op - 6, e);
    });
  }
  phase(12, [&](int op, int e) {
    store_component(b, c.out, op, op, e, F_FMT, F_FMT != DIGIT_ROWS && op >= 6);
  });
}

#ifdef __CUDACC__
// The card's phase runner: the block's threads take the phase's ops E jobs
// in turn, operation-major, then a barrier.
struct BlockPhases {
  int E;
  template <class Job>
  __device__ __forceinline__ void operator()(int ops, const Job& job) const {
    const int jobs = ops * E;
    for (int j = threadIdx.x; j < jobs; j += blockDim.x) job(j / E, j % E);
    __syncthreads();
  }
};
#endif

// A host array of n doubling flags -> a Schedule; false for n outside
// [1, MAX_EVENTS] (a chain has an event).
inline bool make_schedule(int n, const unsigned char* dbl, Schedule& s) {
  if (n < 1 || n > MAX_EVENTS) return false;
  s.n = n;
  for (int k = 0; k < MAX_EVENTS / 32; ++k) s.dbl[k] = 0;
  for (int i = 0; i < n; ++i)
    if (dbl[i]) s.dbl[i / 32] |= 1u << (i % 32);
  return true;
}

}  // namespace t381
