// Device functions of the fused final exponentiation on the 32-bit tower of
// tower381.cuh, for the two chain kernels of final_exp.cu: FE-easy (the easy
// part, f^((p^6 - 1)(p^2 + 1))) and FE-hard (the hard part, the BLS12-381
// cyclotomic addition chain of oracle/pairing.py:final_exp).
//
// Both run on the block program of tower381.cuh: each element's state lives
// in shared memory as canonical Montgomery words (R = 2^384), and a block's
// threads run phases of independent jobs with a barrier between: FE-easy
// in K4's 30 Fp2 slots on Fp2 jobs, FE-hard in 72 Fp slots on jobs of one
// Fp value each (see "FE-hard" below). Nothing crosses the stacks as
// digits between FE-easy's load of f and FE-hard's store of the result:
// FE-easy writes its output as words, FE-hard reads them and keeps its
// values t0-t6 as words in a scratch stack between uses. The outer edges
// take the formats of tower381.cuh (template parameters, an instantiation
// each): FE-easy loads f as digits, as words (the fused pairing's K6-chain
// stores conj(f) as words, and the identity mask selects on them) or as
// strict limbs (the strict engine's fp12, as its K6-chain stores conj(f)),
// FE-hard stores its result as digits or as the strict (24, n) limbs the
// pairing returns.
//
// FE-easy is a fixed program: f into slots 0-5; the inverse of
// tower_lazy.fp12_inv -> fp6_inv -> fp2_inv as phases of Fp2 products and
// sums (the norm inverted by the binary GCD finv::inverse, one job an
// element); conj(f) f^-1 on K4's product phases; its Frobenius square
// times itself, again on K4's phases; the result stored as words.
//
// FE-hard interprets a program of the hard part that the host builds
// (ops/final_exp.py: HARD_PROGRAM), the same list its plain version walks on
// digits: an accumulator A in Fp slots 0-11, an operand B in 12-23, and
// ops
//   LOAD a, b, flags   A <- value a, B <- value b (either may be -1: kept);
//                      flags bit 0 conjugates A, bit 1 B
//   SQR n              A <- A^(2^n), n Granger-Scott squares
//   MUL                A <- A B
//   CONJ               A <- conj(A)
//   FROB p             A <- A^(p^power), p = 1, 2, 3
//   STORE v            value v <- A
//   OUT                the output <- A (digits or strict limbs)
// Value 0 is the input, FE-easy's words; values 1 .. V-1 live in the
// scratch stack as words.
//
// The Frobenius maps take products by host constants (ops/final_exp.py:
// FROB_WORDS), composed as tower_lazy.fp12_frobenius composes them but in
// the words' Montgomery form: the constant of Fp2 slot k = 3 i + j of the
// fp12 (i the w half, j the v power) is gamma_j(power) times gamma_w(power)
// when i = 1; the odd powers conjugate each Fp2 first.
//
// Compiles as host C++ too (no __CUDACC__, unsigned arithmetic only):
// tests/test_torch_tower_host.py runs both programs job by job, in order and
// reversed, under -fsanitize=undefined.
#pragma once

#include "fp_inv.cuh"

namespace fexp {

using f381::Fp;
using f381::Fp2;
using f381::NW;
using f381::u32;
using t381::Block;
using t381::Elem;
using t381::LinOp;
using t381::MUL;
using t381::MulOp;
using t381::SQR;

constexpr int SLOTS = t381::FP12_MUL_SLOTS;  // FE-easy's: K4's 30 Fp2 slots
constexpr int FP12_FP = 12;                  // Fp components of an fp12
constexpr int FROB_POWERS = 3;               // FROB_WORDS holds the powers 1, 2, 3

// --- words in global memory ----------------------------------------------------
//
// A word stack (rows, 12, n): word k of row c of element i at src[(12 c + k) n + i].

__device__ __forceinline__ void fp_from_words(const Block& b, const int* src, int row, int e,
                                              Fp& x) {
  const long long i = b.i0 + e;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    x.w[k] = i < b.n ? static_cast<u32>(src[(static_cast<long long>(row) * NW + k) * b.n + i]) : 0;
}

__device__ __forceinline__ void fp_to_words(const Block& b, int* dst, int row, const Fp& x,
                                            int e) {
  const long long i = b.i0 + e;
  if (i >= b.n) return;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    dst[(static_cast<long long>(row) * NW + k) * b.n + i] = static_cast<int>(x.w[k]);
}

// Fp component `from` (slot from / 2, half from % 2) -> row c of a word stack.
__device__ __forceinline__ void store_words(const Block& b, int* dst, int c, int from, int e) {
  Fp x;
  t381::load_fp(b.elem(e), from / 2, from % 2, x);
  fp_to_words(b, dst, c, x, e);
}

// --- jobs beyond tower381.cuh ------------------------------------------------------

// A MulOp of either kind (FE-easy's inverse mixes squares and products).
__device__ __forceinline__ void run_product(const Elem& m, const MulOp& op) {
  if (op.kind == SQR) t381::run_sqr(m, op);
  else t381::run_mul(m, op);
}

// Slot dst + k <- the Frobenius map of power p of Fp2 slot src + k of an fp12:
// conjugated for an odd power, times the constant of slot k (1 for k = 0).
// frob: (FROB_POWERS, 6, 2, 12) words, ops/final_exp.py:FROB_WORDS.
__device__ __forceinline__ void frob_job(const Elem& m, const int* frob, int power, int src,
                                         int dst, int k) {
  Fp2 v;
  t381::load(m, src + k, v);
  if (power & 1) f381::neg(v.c1, v.c1);
  if (k) {
    const int* w = frob + ((power - 1) * 6 + k) * 2 * NW;
    Fp2 c;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c.c0.w[j] = static_cast<u32>(w[j]);
      c.c1.w[j] = static_cast<u32>(w[NW + j]);
    }
    f381::mul(v, c, v);
  }
  t381::store(m, dst + k, v);
}

// Slot dst <- sign * slot src (a copy, or a negation).
__device__ __forceinline__ void move_job(const Elem& m, int src, int dst, bool negate) {
  Fp2 v;
  t381::load(m, src, v);
  if (negate) f381::neg(v, v);
  t381::store(m, dst, v);
}

// K4's product phases: slots 0-5 times 6-11 into 12-17 (tower381.cuh).
template <class Phase>
__device__ __forceinline__ void fp12_mul_phases(const Block& b, const Phase& phase) {
  phase(18, [&](int op, int e) { t381::run_mul(b.elem(e), t381::FP12_MUL_PRODUCTS[op]); });
  phase(9, [&](int op, int e) { t381::run(b.elem(e), t381::FP12_MUL_FP6[op]); });
  phase(6, [&](int op, int e) { t381::run(b.elem(e), t381::FP12_MUL_RESULT[op]); });
}

// --- FE-easy: conj(f) f^-1, then its Frobenius square times itself ---------------
//
// Slots: f = (a0, a1) in 0-5. fp12_inv: s0 = a0^2 and s1 = a1^2 as fp6
// products (six Karatsuba legs each, squares here: 12-23; interpolated into
// 24-29), t = s0 - v s1 (6-8). fp6_inv(t): the squares and products of its
// cofactors (9-14), c0 = s0 - xi m12, c1 = xi s1 - m01, c2 = s2 - m02 (15-17),
// t0 c0, t2 c1, t1 c2 (18-20), their norm t0 c0 + xi (t2 c1 + t1 c2) (21),
// its Fp2 inverse by the binary GCD (22), r = c / norm (23-25). Then
// a0 r and a1 r as fp6 products (legs 6-17), f^-1 = (a0 r, -a1 r) (18-23).
// Then a = conj(f) into 0-5 (b negated in place) and b = f^-1 into 6-11,
// K4's phases (12-17); the Frobenius square of that into 0-5 and a copy into
// 6-11, K4's phases again: the result in 12-17.

__constant__ MulOp EASY_SQUARES[12] = {
    {12, SQR, {{0, 1, 0}}, {}},             // a0: v0
    {13, SQR, {{1, 1, 0}}, {}},             //     v1
    {14, SQR, {{2, 1, 0}}, {}},             //     v2
    {15, SQR, {{1, 1, 0}, {2, 1, 0}}, {}},  //     m12
    {16, SQR, {{0, 1, 0}, {1, 1, 0}}, {}},  //     m01
    {17, SQR, {{0, 1, 0}, {2, 1, 0}}, {}},  //     m02
    {18, SQR, {{3, 1, 0}}, {}},             // a1: v0
    {19, SQR, {{4, 1, 0}}, {}},             //     v1
    {20, SQR, {{5, 1, 0}}, {}},             //     v2
    {21, SQR, {{4, 1, 0}, {5, 1, 0}}, {}},  //     m12
    {22, SQR, {{3, 1, 0}, {4, 1, 0}}, {}},  //     m01
    {23, SQR, {{3, 1, 0}, {5, 1, 0}}, {}},  //     m02
};

// fp6_mul's interpolation (as FP12_MUL_FP6): s0 into 24-26, s1 into 27-29.
__constant__ LinOp EASY_SQUARES_FP6[6] = {
    {24, {{12, 1, 0}, {15, 1, 1}, {13, -1, 1}, {14, -1, 1}}},
    {25, {{16, 1, 0}, {12, -1, 0}, {13, -1, 0}, {14, 1, 1}}},
    {26, {{17, 1, 0}, {12, -1, 0}, {14, -1, 0}, {13, 1, 0}}},
    {27, {{18, 1, 0}, {21, 1, 1}, {19, -1, 1}, {20, -1, 1}}},
    {28, {{22, 1, 0}, {18, -1, 0}, {19, -1, 0}, {20, 1, 1}}},
    {29, {{23, 1, 0}, {18, -1, 0}, {20, -1, 0}, {19, 1, 0}}},
};

// t = s0 - v s1 = (s0_0 - xi s1_2, s0_1 - s1_0, s0_2 - s1_1).
__constant__ LinOp EASY_T[3] = {
    {6, {{24, 1, 0}, {29, -1, 1}}},
    {7, {{25, 1, 0}, {27, -1, 0}}},
    {8, {{26, 1, 0}, {28, -1, 0}}},
};

// fp6_inv(t), t = (t0, t1, t2) in 6-8: s0 = t0^2, s1 = t2^2, s2 = t1^2, m01,
// m12, m02.
__constant__ MulOp EASY_INV6_PRODUCTS[6] = {
    {9, SQR, {{6, 1, 0}}, {}},
    {10, SQR, {{8, 1, 0}}, {}},
    {11, SQR, {{7, 1, 0}}, {}},
    {12, MUL, {{6, 1, 0}}, {{7, 1, 0}}},
    {13, MUL, {{7, 1, 0}}, {{8, 1, 0}}},
    {14, MUL, {{6, 1, 0}}, {{8, 1, 0}}},
};

__constant__ LinOp EASY_INV6_COFACTORS[3] = {
    {15, {{9, 1, 0}, {13, -1, 1}}},   // c0 = s0 - xi m12
    {16, {{10, 1, 1}, {12, -1, 0}}},  // c1 = xi s1 - m01
    {17, {{11, 1, 0}, {14, -1, 0}}},  // c2 = s2 - m02
};

__constant__ MulOp EASY_INV6_NORM_LEGS[3] = {
    {18, MUL, {{6, 1, 0}}, {{15, 1, 0}}},  // t0 c0
    {19, MUL, {{8, 1, 0}}, {{16, 1, 0}}},  // t2 c1
    {20, MUL, {{7, 1, 0}}, {{17, 1, 0}}},  // t1 c2
};

__constant__ LinOp EASY_INV6_NORM = {21, {{18, 1, 0}, {19, 1, 1}, {20, 1, 1}}};

__constant__ MulOp EASY_INV6_RESULT[3] = {
    {23, MUL, {{15, 1, 0}}, {{22, 1, 0}}},
    {24, MUL, {{16, 1, 0}}, {{22, 1, 0}}},
    {25, MUL, {{17, 1, 0}}, {{22, 1, 0}}},
};

// a0 r (legs into 6-11) and a1 r (12-17), r = (r0, r1, r2) in 23-25.
__constant__ MulOp EASY_INV12_PRODUCTS[12] = {
    {6, MUL, {{0, 1, 0}}, {{23, 1, 0}}},
    {7, MUL, {{1, 1, 0}}, {{24, 1, 0}}},
    {8, MUL, {{2, 1, 0}}, {{25, 1, 0}}},
    {9, MUL, {{1, 1, 0}, {2, 1, 0}}, {{24, 1, 0}, {25, 1, 0}}},
    {10, MUL, {{0, 1, 0}, {1, 1, 0}}, {{23, 1, 0}, {24, 1, 0}}},
    {11, MUL, {{0, 1, 0}, {2, 1, 0}}, {{23, 1, 0}, {25, 1, 0}}},
    {12, MUL, {{3, 1, 0}}, {{23, 1, 0}}},
    {13, MUL, {{4, 1, 0}}, {{24, 1, 0}}},
    {14, MUL, {{5, 1, 0}}, {{25, 1, 0}}},
    {15, MUL, {{4, 1, 0}, {5, 1, 0}}, {{24, 1, 0}, {25, 1, 0}}},
    {16, MUL, {{3, 1, 0}, {4, 1, 0}}, {{23, 1, 0}, {24, 1, 0}}},
    {17, MUL, {{3, 1, 0}, {5, 1, 0}}, {{23, 1, 0}, {25, 1, 0}}},
};

// f^-1 = (a0 r, -a1 r) into 18-23: the interpolations, the second negated.
__constant__ LinOp EASY_INV12_FP6[6] = {
    {18, {{6, 1, 0}, {9, 1, 1}, {7, -1, 1}, {8, -1, 1}}},
    {19, {{10, 1, 0}, {6, -1, 0}, {7, -1, 0}, {8, 1, 1}}},
    {20, {{11, 1, 0}, {6, -1, 0}, {8, -1, 0}, {7, 1, 0}}},
    {21, {{12, -1, 0}, {15, -1, 1}, {13, 1, 1}, {14, 1, 1}}},
    {22, {{16, -1, 0}, {12, 1, 0}, {13, 1, 0}, {14, -1, 1}}},
    {23, {{17, -1, 0}, {12, 1, 0}, {14, 1, 0}, {13, -1, 0}}},
};

// f = (re, im) in slot `src` -> its inverse (re, -im) / (re^2 + im^2) in
// `dst`: the norm's inverse by the binary GCD of fp_inv.cuh (finv::inverse:
// the words of x^(p-2), 0 for 0), all in one job.
__device__ __forceinline__ void fp2_inv_job(const Elem& m, int src, int dst) {
  Fp2 a, r;
  Fp n, t, inv;
  t381::load(m, src, a);
  f381::mont_mul(a.c0, a.c0, n);
  f381::mont_mul(a.c1, a.c1, t);
  f381::add(n, t, n);
  finv::inverse(n, inv);
  f381::mont_mul(a.c0, inv, r.c0);
  f381::mont_mul(a.c1, inv, t);
  f381::neg(t, r.c1);
  t381::store(m, dst, r);
}

// FE-easy: f of format IN_FMT in ((12, 30, n) digits, (12, 12, n) words or
// (12, 24, n) strict limbs), the easy part (12, 12, n) words out.
struct EasyChain {
  const int* f;
  int* out;
  const int* frob;
};

template <int IN_FMT = t381::DIGIT_ROWS, class Phase>
__device__ __forceinline__ void easy_chain(const Block& b, const EasyChain& c,
                                           const Phase& phase) {
  phase(FP12_FP, [&](int op, int e) { t381::load_component(b, c.f, op, op, e, IN_FMT); });
  phase(12, [&](int op, int e) { t381::run_sqr(b.elem(e), EASY_SQUARES[op]); });
  phase(6, [&](int op, int e) { t381::run(b.elem(e), EASY_SQUARES_FP6[op]); });
  phase(3, [&](int op, int e) { t381::run(b.elem(e), EASY_T[op]); });
  phase(6, [&](int op, int e) { run_product(b.elem(e), EASY_INV6_PRODUCTS[op]); });
  phase(3, [&](int op, int e) { t381::run(b.elem(e), EASY_INV6_COFACTORS[op]); });
  phase(3, [&](int op, int e) { t381::run_mul(b.elem(e), EASY_INV6_NORM_LEGS[op]); });
  phase(1, [&](int, int e) {
    t381::run(b.elem(e), EASY_INV6_NORM);
    fp2_inv_job(b.elem(e), 21, 22);
  });
  phase(3, [&](int op, int e) { t381::run_mul(b.elem(e), EASY_INV6_RESULT[op]); });
  phase(12, [&](int op, int e) { t381::run_mul(b.elem(e), EASY_INV12_PRODUCTS[op]); });
  phase(6, [&](int op, int e) { t381::run(b.elem(e), EASY_INV12_FP6[op]); });
  // a = conj(f) (b negated in place), b = f^-1
  phase(9, [&](int op, int e) {
    if (op < 6) move_job(b.elem(e), 18 + op, 6 + op, false);
    else move_job(b.elem(e), op - 3, op - 3, true);
  });
  fp12_mul_phases(b, phase);
  // a = its Frobenius square, b = itself
  phase(12, [&](int op, int e) {
    if (op < 6) frob_job(b.elem(e), c.frob, 2, t381::FP12_MUL_OUT, 0, op);
    else move_job(b.elem(e), t381::FP12_MUL_OUT + op - 6, op, false);
  });
  fp12_mul_phases(b, phase);
  phase(FP12_FP, [&](int op, int e) { store_words(b, c.out, op, 2 * t381::FP12_MUL_OUT + op, e); });
}

// --- FE-hard: the program of the hard part ---------------------------------------
//
// FE-hard keeps each element in Fp slots of its own (HARD_SLOTS of them,
// word k of slot c of element e at smem[(12 c + k) E + e], the layout of
// tower381.cuh's Fp2 slots read an Fp at a time: Fp2 slot q is Fp slots
// 2 q and 2 q + 1), and every job of its phases computes one Fp value: a
// product job one Montgomery product of two sums of slots (MulJob), a sum
// job one signed sum (SumJob), one job a thread in turn. Slots:
//   0-11   A, the accumulator (components in tower_lazy.stack12's order);
//   12-23  B, the operand of MUL;
//   24-71  the values of the steps below.
// A Granger-Scott square (the algebra of tower381.cuh's K3):
//   SQR_PRODUCTS   18 products: the nine Fp2 squares p0 .. p8 (x^2 =
//                  (x0 + x1)(x0 - x1) + 2 x0 x1 u), one an Fp component,
//                  into 24-41;
//   SQR_RECOMBINE  12 sums: each of A's components 3 T - 2 a or 3 T + 2 a
//                  as T + 2 (T -+ a), in place (a job reads its own
//                  component of A and the squares).
// A product A <- A B (tower_lazy.fp12_mul_many's Karatsuba over fp6,
// fp6_mul's six legs each, as K4's tables; t0 = a0 b0, t1 = a1 b1, t2 =
// (a0 + a1)(b0 + b1)), the 18 Fp2 products as their 54 Karatsuba legs
// x0 y0, x1 y1, (x0 + x1)(y0 + y1):
//   MUL_P1      36 products: t1's and t2's legs into 24-59;
//   MUL_P2      18 products: t0's legs, which read only a0 and b0 (0-5,
//               12-17), into the dead a1 and b1 (6-11, 18-23) and 60-65;
//   MUL_FP6     18 sums: t0, t1, t2 from their legs (fp6_mul's
//               interpolation with each Fp2 product's re = x0 - x1, im =
//               x2 - x0 - x1, xi times it 2 x0 - x2 + (x2 - 2 x1) u) into
//               0-5, 12-17, 66-71;
//   MUL_RESULT  12 sums: c0 = t0 + v t1, c1 = t2 - t0 - t1 into 24-35;
//   MUL_MOVE    12 sums: 24-35 into A.
// A Frobenius map: FROB (12 jobs of two products: component h of the
// conjugated or not Fp2 component times its constant) into 24-35, then
// MUL_MOVE. A conjugation negates A's components 6-11 in place; LOAD,
// STORE and OUT move one Fp component a job. No job reads a slot that
// another job of its phase writes. Every value is canonical and every
// operation exact, so the result is the same field element as K3's and
// K4's programs give, in the same canonical words.

enum HardCode { H_LOAD = 1, H_SQR = 2, H_MUL = 3, H_CONJ = 4, H_FROB = 5, H_STORE = 6, H_OUT = 7 };

// The kinds of FE-hard's phases. hard_chain names each phase's kind to its
// runner before the phase when the runner has a member kind(int)
// (scripts/fe_hard_clocks.cu times the phases by kind); the card's and the
// host harness's runners have none, and the call compiles to nothing.
enum HardKind {
  HK_LOAD, HK_SQR_PRODUCTS, HK_SQR_RECOMBINE, HK_MUL_P1, HK_MUL_P2, HK_MUL_FP6, HK_MUL_RESULT,
  HK_MUL_MOVE, HK_CONJ, HK_FROB, HK_FROB_MOVE, HK_STORE, HK_OUT, HK_KINDS
};

template <class Phase>
__device__ __forceinline__ auto mark(const Phase& phase, int kind, int)
    -> decltype(phase.kind(kind), void()) {
  phase.kind(kind);
}

template <class Phase>
__device__ __forceinline__ void mark(const Phase&, int, long) {}

constexpr int HARD_SLOTS = 72;  // Fp slots an element
constexpr int HARD_B = 12;      // B's first slot
constexpr int HARD_TMP = 24;    // MUL_RESULT's and FROB's output, 12 slots

// FE-hard's launch shape: E elements and HARD_THREADS_PER_ELEM E threads a
// block (a square's 18 products in one round), E at most HARD_ELEMS; the
// build bounded for FE_HARD_THREADS threads and FE_HARD_MIN_BLOCKS blocks
// an SM (scripts/tower_probe.py --fe builds it at other bounds).
#ifndef FE_HARD_THREADS
#define FE_HARD_THREADS 576
#endif
#ifndef FE_HARD_MIN_BLOCKS
#define FE_HARD_MIN_BLOCKS 2
#endif
constexpr int HARD_ELEMS = 32;
constexpr int HARD_THREADS_PER_ELEM = 18;

// FE-hard's shared memory a block of E elements.
inline constexpr int hard_smem_bytes(int E) { return E * HARD_SLOTS * NW * 4; }

// The elements a block for n elements on `sms` SMs: the smallest power of
// two that spreads them over the SMs, at most HARD_ELEMS. A block's phases
// cost its SM's issue slots for every element it holds, so a batch too
// small to fill the card runs best at one small block an SM.
inline int hard_elems(long long n, int sms) {
  int E = 1;
  while (E < HARD_ELEMS && static_cast<long long>(E) * sms < n) E *= 2;
  return E;
}

// The elements of block b that lie in the batch: its phases run jobs for
// these alone.
__device__ __forceinline__ int active_elems(const Block& b) {
  return b.n - b.i0 < b.E ? static_cast<int>(b.n - b.i0) : b.E;
}

// A signed Fp slot of a sum (coef +1 or -1); coef 0 ends a list.
struct FpTerm {
  signed char slot, coef;
};

constexpr int MUL_TERMS = 8;  // a leg of t2's m products sums 8 components
constexpr int SUM_TERMS = 12;
constexpr int SUM_TWICE = 3;

// dst <- (sum of x)(sum of y), doubled when dbl: one Montgomery product.
struct MulJob {
  signed char dst, dbl;
  FpTerm x[MUL_TERMS], y[MUL_TERMS];
};

// dst <- U + 2 S, or 3 U + 2 S when triple (as U + 2 (U + S)), U and S
// the sums of u and s.
struct SumJob {
  signed char dst, triple;
  FpTerm u[SUM_TERMS], s[SUM_TWICE];
};

// The products: SQR_PRODUCTS, then MUL_P1 and MUL_P2 (offsets HM_*).
constexpr int HM_SQR = 0, HM_P1 = 18, HM_P2 = 54;
__device__ const MulJob HARD_MULS[72] = {
    // SQR_PRODUCTS: square k of the Fp2 sum x of A's components, re
    // (x0 + x1)(x0 - x1) and im 2 x0 x1
    {24, 0, {{0, 1}, {1, 1}}, {{0, 1}, {1, -1}}},  // p0 re
    {25, 1, {{0, 1}}, {{1, 1}}},  // p0 im
    {26, 0, {{8, 1}, {9, 1}}, {{8, 1}, {9, -1}}},  // p1 re
    {27, 1, {{8, 1}}, {{9, 1}}},  // p1 im
    {28, 0, {{0, 1}, {1, 1}, {8, 1}, {9, 1}}, {{0, 1}, {8, 1}, {1, -1}, {9, -1}}},  // p2 re
    {29, 1, {{0, 1}, {8, 1}}, {{1, 1}, {9, 1}}},  // p2 im
    {30, 0, {{6, 1}, {7, 1}}, {{6, 1}, {7, -1}}},  // p3 re
    {31, 1, {{6, 1}}, {{7, 1}}},  // p3 im
    {32, 0, {{4, 1}, {5, 1}}, {{4, 1}, {5, -1}}},  // p4 re
    {33, 1, {{4, 1}}, {{5, 1}}},  // p4 im
    {34, 0, {{6, 1}, {7, 1}, {4, 1}, {5, 1}}, {{6, 1}, {4, 1}, {7, -1}, {5, -1}}},  // p5 re
    {35, 1, {{6, 1}, {4, 1}}, {{7, 1}, {5, 1}}},  // p5 im
    {36, 0, {{2, 1}, {3, 1}}, {{2, 1}, {3, -1}}},  // p6 re
    {37, 1, {{2, 1}}, {{3, 1}}},  // p6 im
    {38, 0, {{10, 1}, {11, 1}}, {{10, 1}, {11, -1}}},  // p7 re
    {39, 1, {{10, 1}}, {{11, 1}}},  // p7 im
    {40, 0, {{2, 1}, {3, 1}, {10, 1}, {11, 1}}, {{2, 1}, {10, 1}, {3, -1}, {11, -1}}},  // p8 re
    {41, 1, {{2, 1}, {10, 1}}, {{3, 1}, {11, 1}}},  // p8 im
    // MUL_P1: the legs of t1 = a1 b1, then of t2 = (a0 + a1)(b0 + b1)
    {24, 0, {{6, 1}}, {{18, 1}}},  // t1 v0 leg 0
    {25, 0, {{7, 1}}, {{19, 1}}},  // t1 v0 leg 1
    {26, 0, {{6, 1}, {7, 1}}, {{18, 1}, {19, 1}}},  // t1 v0 leg 2
    {27, 0, {{8, 1}}, {{20, 1}}},  // t1 v1 leg 0
    {28, 0, {{9, 1}}, {{21, 1}}},  // t1 v1 leg 1
    {29, 0, {{8, 1}, {9, 1}}, {{20, 1}, {21, 1}}},  // t1 v1 leg 2
    {30, 0, {{10, 1}}, {{22, 1}}},  // t1 v2 leg 0
    {31, 0, {{11, 1}}, {{23, 1}}},  // t1 v2 leg 1
    {32, 0, {{10, 1}, {11, 1}}, {{22, 1}, {23, 1}}},  // t1 v2 leg 2
    {33, 0, {{8, 1}, {10, 1}}, {{20, 1}, {22, 1}}},  // t1 m12 leg 0
    {34, 0, {{9, 1}, {11, 1}}, {{21, 1}, {23, 1}}},  // t1 m12 leg 1
    {35, 0, {{8, 1}, {9, 1}, {10, 1}, {11, 1}}, {{20, 1}, {21, 1}, {22, 1}, {23, 1}}},  // t1 m12 leg 2
    {36, 0, {{6, 1}, {8, 1}}, {{18, 1}, {20, 1}}},  // t1 m01 leg 0
    {37, 0, {{7, 1}, {9, 1}}, {{19, 1}, {21, 1}}},  // t1 m01 leg 1
    {38, 0, {{6, 1}, {7, 1}, {8, 1}, {9, 1}}, {{18, 1}, {19, 1}, {20, 1}, {21, 1}}},  // t1 m01 leg 2
    {39, 0, {{6, 1}, {10, 1}}, {{18, 1}, {22, 1}}},  // t1 m02 leg 0
    {40, 0, {{7, 1}, {11, 1}}, {{19, 1}, {23, 1}}},  // t1 m02 leg 1
    {41, 0, {{6, 1}, {7, 1}, {10, 1}, {11, 1}}, {{18, 1}, {19, 1}, {22, 1}, {23, 1}}},  // t1 m02 leg 2
    {42, 0, {{0, 1}, {6, 1}}, {{12, 1}, {18, 1}}},  // t2 v0 leg 0
    {43, 0, {{1, 1}, {7, 1}}, {{13, 1}, {19, 1}}},  // t2 v0 leg 1
    {44, 0, {{0, 1}, {1, 1}, {6, 1}, {7, 1}}, {{12, 1}, {13, 1}, {18, 1}, {19, 1}}},  // t2 v0 leg 2
    {45, 0, {{2, 1}, {8, 1}}, {{14, 1}, {20, 1}}},  // t2 v1 leg 0
    {46, 0, {{3, 1}, {9, 1}}, {{15, 1}, {21, 1}}},  // t2 v1 leg 1
    {47, 0, {{2, 1}, {3, 1}, {8, 1}, {9, 1}}, {{14, 1}, {15, 1}, {20, 1}, {21, 1}}},  // t2 v1 leg 2
    {48, 0, {{4, 1}, {10, 1}}, {{16, 1}, {22, 1}}},  // t2 v2 leg 0
    {49, 0, {{5, 1}, {11, 1}}, {{17, 1}, {23, 1}}},  // t2 v2 leg 1
    {50, 0, {{4, 1}, {5, 1}, {10, 1}, {11, 1}}, {{16, 1}, {17, 1}, {22, 1}, {23, 1}}},  // t2 v2 leg 2
    {51, 0, {{2, 1}, {8, 1}, {4, 1}, {10, 1}}, {{14, 1}, {20, 1}, {16, 1}, {22, 1}}},  // t2 m12 leg 0
    {52, 0, {{3, 1}, {9, 1}, {5, 1}, {11, 1}}, {{15, 1}, {21, 1}, {17, 1}, {23, 1}}},  // t2 m12 leg 1
    {53, 0, {{2, 1}, {3, 1}, {8, 1}, {9, 1}, {4, 1}, {5, 1}, {10, 1}, {11, 1}}, {{14, 1}, {15, 1}, {20, 1}, {21, 1}, {16, 1}, {17, 1}, {22, 1}, {23, 1}}},  // t2 m12 leg 2
    {54, 0, {{0, 1}, {6, 1}, {2, 1}, {8, 1}}, {{12, 1}, {18, 1}, {14, 1}, {20, 1}}},  // t2 m01 leg 0
    {55, 0, {{1, 1}, {7, 1}, {3, 1}, {9, 1}}, {{13, 1}, {19, 1}, {15, 1}, {21, 1}}},  // t2 m01 leg 1
    {56, 0, {{0, 1}, {1, 1}, {6, 1}, {7, 1}, {2, 1}, {3, 1}, {8, 1}, {9, 1}}, {{12, 1}, {13, 1}, {18, 1}, {19, 1}, {14, 1}, {15, 1}, {20, 1}, {21, 1}}},  // t2 m01 leg 2
    {57, 0, {{0, 1}, {6, 1}, {4, 1}, {10, 1}}, {{12, 1}, {18, 1}, {16, 1}, {22, 1}}},  // t2 m02 leg 0
    {58, 0, {{1, 1}, {7, 1}, {5, 1}, {11, 1}}, {{13, 1}, {19, 1}, {17, 1}, {23, 1}}},  // t2 m02 leg 1
    {59, 0, {{0, 1}, {1, 1}, {6, 1}, {7, 1}, {4, 1}, {5, 1}, {10, 1}, {11, 1}}, {{12, 1}, {13, 1}, {18, 1}, {19, 1}, {16, 1}, {17, 1}, {22, 1}, {23, 1}}},  // t2 m02 leg 2
    // MUL_P2: the legs of t0 = a0 b0
    {6, 0, {{0, 1}}, {{12, 1}}},  // t0 v0 leg 0
    {7, 0, {{1, 1}}, {{13, 1}}},  // t0 v0 leg 1
    {8, 0, {{0, 1}, {1, 1}}, {{12, 1}, {13, 1}}},  // t0 v0 leg 2
    {9, 0, {{2, 1}}, {{14, 1}}},  // t0 v1 leg 0
    {10, 0, {{3, 1}}, {{15, 1}}},  // t0 v1 leg 1
    {11, 0, {{2, 1}, {3, 1}}, {{14, 1}, {15, 1}}},  // t0 v1 leg 2
    {18, 0, {{4, 1}}, {{16, 1}}},  // t0 v2 leg 0
    {19, 0, {{5, 1}}, {{17, 1}}},  // t0 v2 leg 1
    {20, 0, {{4, 1}, {5, 1}}, {{16, 1}, {17, 1}}},  // t0 v2 leg 2
    {21, 0, {{2, 1}, {4, 1}}, {{14, 1}, {16, 1}}},  // t0 m12 leg 0
    {22, 0, {{3, 1}, {5, 1}}, {{15, 1}, {17, 1}}},  // t0 m12 leg 1
    {23, 0, {{2, 1}, {3, 1}, {4, 1}, {5, 1}}, {{14, 1}, {15, 1}, {16, 1}, {17, 1}}},  // t0 m12 leg 2
    {60, 0, {{0, 1}, {2, 1}}, {{12, 1}, {14, 1}}},  // t0 m01 leg 0
    {61, 0, {{1, 1}, {3, 1}}, {{13, 1}, {15, 1}}},  // t0 m01 leg 1
    {62, 0, {{0, 1}, {1, 1}, {2, 1}, {3, 1}}, {{12, 1}, {13, 1}, {14, 1}, {15, 1}}},  // t0 m01 leg 2
    {63, 0, {{0, 1}, {4, 1}}, {{12, 1}, {16, 1}}},  // t0 m02 leg 0
    {64, 0, {{1, 1}, {5, 1}}, {{13, 1}, {17, 1}}},  // t0 m02 leg 1
    {65, 0, {{0, 1}, {1, 1}, {4, 1}, {5, 1}}, {{12, 1}, {13, 1}, {16, 1}, {17, 1}}},  // t0 m02 leg 2
};

// The sums: SQR_RECOMBINE, MUL_FP6, MUL_RESULT, MUL_MOVE, CONJ (offsets
// HS_*).
constexpr int HS_RECOMBINE = 0, HS_FP6 = 12, HS_RESULT = 30, HS_MOVE = 42, HS_CONJ = 54;
__device__ const SumJob HARD_SUMS[60] = {
    // SQR_RECOMBINE: t0 = p0 + xi p1, t1 = p2 - p0 - p1 (s, r likewise on
    // p3 .. p5, p6 .. p8)
    {0, 1, {{24, 1}, {26, 1}, {27, -1}}, {{0, -1}}},  // na0 = 3 t0 - 2 a0 re
    {1, 1, {{25, 1}, {26, 1}, {27, 1}}, {{1, -1}}},  // na0 = 3 t0 - 2 a0 im
    {8, 1, {{28, 1}, {24, -1}, {26, -1}}, {{8, 1}}},  // nb1 = 3 t1 + 2 b1 re
    {9, 1, {{29, 1}, {25, -1}, {27, -1}}, {{9, 1}}},  // nb1 = 3 t1 + 2 b1 im
    {2, 1, {{30, 1}, {32, 1}, {33, -1}}, {{2, -1}}},  // na1 = 3 s0 - 2 a1 re
    {3, 1, {{31, 1}, {32, 1}, {33, 1}}, {{3, -1}}},  // na1 = 3 s0 - 2 a1 im
    {10, 1, {{34, 1}, {30, -1}, {32, -1}}, {{10, 1}}},  // nb2 = 3 s1 + 2 b2 re
    {11, 1, {{35, 1}, {31, -1}, {33, -1}}, {{11, 1}}},  // nb2 = 3 s1 + 2 b2 im
    {4, 1, {{36, 1}, {38, 1}, {39, -1}}, {{4, -1}}},  // na2 = 3 r0 - 2 a2 re
    {5, 1, {{37, 1}, {38, 1}, {39, 1}}, {{5, -1}}},  // na2 = 3 r0 - 2 a2 im
    {6, 1, {{37, 1}, {39, 1}, {40, 1}, {36, -1}, {38, -1}, {41, -1}}, {{6, 1}}},  // nb0 = 3 xi r1 + 2 b0 re
    {7, 1, {{40, 1}, {41, 1}, {36, -1}, {37, -1}, {38, -1}, {39, -1}}, {{7, 1}}},  // nb0 = 3 xi r1 + 2 b0 im
    // MUL_FP6: t0, t1, t2 from their legs
    {0, 0, {{6, 1}, {11, 1}, {20, 1}, {7, -1}, {23, -1}}, {{21, 1}, {9, -1}, {18, -1}}},  // t0 c0 re
    {1, 0, {{8, 1}, {23, 1}, {6, -1}, {7, -1}, {11, -1}, {20, -1}}, {{10, 1}, {19, 1}, {22, -1}}},  // t0 c0 im
    {2, 0, {{7, 1}, {10, 1}, {60, 1}, {6, -1}, {9, -1}, {20, -1}, {61, -1}}, {{18, 1}}},  // t0 c1 re
    {3, 0, {{6, 1}, {7, 1}, {9, 1}, {10, 1}, {20, 1}, {62, 1}, {8, -1}, {11, -1}, {60, -1}, {61, -1}}, {{19, -1}}},  // t0 c1 im
    {4, 0, {{7, 1}, {9, 1}, {19, 1}, {63, 1}, {6, -1}, {10, -1}, {18, -1}, {64, -1}}, {}},  // t0 c2 re
    {5, 0, {{6, 1}, {7, 1}, {11, 1}, {18, 1}, {19, 1}, {65, 1}, {8, -1}, {9, -1}, {10, -1}, {20, -1}, {63, -1}, {64, -1}}, {}},  // t0 c2 im
    {12, 0, {{24, 1}, {29, 1}, {32, 1}, {25, -1}, {35, -1}}, {{33, 1}, {27, -1}, {30, -1}}},  // t1 c0 re
    {13, 0, {{26, 1}, {35, 1}, {24, -1}, {25, -1}, {29, -1}, {32, -1}}, {{28, 1}, {31, 1}, {34, -1}}},  // t1 c0 im
    {14, 0, {{25, 1}, {28, 1}, {36, 1}, {24, -1}, {27, -1}, {32, -1}, {37, -1}}, {{30, 1}}},  // t1 c1 re
    {15, 0, {{24, 1}, {25, 1}, {27, 1}, {28, 1}, {32, 1}, {38, 1}, {26, -1}, {29, -1}, {36, -1}, {37, -1}}, {{31, -1}}},  // t1 c1 im
    {16, 0, {{25, 1}, {27, 1}, {31, 1}, {39, 1}, {24, -1}, {28, -1}, {30, -1}, {40, -1}}, {}},  // t1 c2 re
    {17, 0, {{24, 1}, {25, 1}, {29, 1}, {30, 1}, {31, 1}, {41, 1}, {26, -1}, {27, -1}, {28, -1}, {32, -1}, {39, -1}, {40, -1}}, {}},  // t1 c2 im
    {66, 0, {{42, 1}, {47, 1}, {50, 1}, {43, -1}, {53, -1}}, {{51, 1}, {45, -1}, {48, -1}}},  // t2 c0 re
    {67, 0, {{44, 1}, {53, 1}, {42, -1}, {43, -1}, {47, -1}, {50, -1}}, {{46, 1}, {49, 1}, {52, -1}}},  // t2 c0 im
    {68, 0, {{43, 1}, {46, 1}, {54, 1}, {42, -1}, {45, -1}, {50, -1}, {55, -1}}, {{48, 1}}},  // t2 c1 re
    {69, 0, {{42, 1}, {43, 1}, {45, 1}, {46, 1}, {50, 1}, {56, 1}, {44, -1}, {47, -1}, {54, -1}, {55, -1}}, {{49, -1}}},  // t2 c1 im
    {70, 0, {{43, 1}, {45, 1}, {49, 1}, {57, 1}, {42, -1}, {46, -1}, {48, -1}, {58, -1}}, {}},  // t2 c2 re
    {71, 0, {{42, 1}, {43, 1}, {47, 1}, {48, 1}, {49, 1}, {59, 1}, {44, -1}, {45, -1}, {46, -1}, {50, -1}, {57, -1}, {58, -1}}, {}},  // t2 c2 im
    // MUL_RESULT: c0 = t0 + v t1, c1 = t2 - t0 - t1
    {24, 0, {{0, 1}, {16, 1}, {17, -1}}, {}},  // c comp 0
    {25, 0, {{1, 1}, {16, 1}, {17, 1}}, {}},  // c comp 1
    {26, 0, {{2, 1}, {12, 1}}, {}},  // c comp 2
    {27, 0, {{3, 1}, {13, 1}}, {}},  // c comp 3
    {28, 0, {{4, 1}, {14, 1}}, {}},  // c comp 4
    {29, 0, {{5, 1}, {15, 1}}, {}},  // c comp 5
    {30, 0, {{66, 1}, {0, -1}, {12, -1}}, {}},  // c comp 6
    {31, 0, {{67, 1}, {1, -1}, {13, -1}}, {}},  // c comp 7
    {32, 0, {{68, 1}, {2, -1}, {14, -1}}, {}},  // c comp 8
    {33, 0, {{69, 1}, {3, -1}, {15, -1}}, {}},  // c comp 9
    {34, 0, {{70, 1}, {4, -1}, {16, -1}}, {}},  // c comp 10
    {35, 0, {{71, 1}, {5, -1}, {17, -1}}, {}},  // c comp 11
    // MUL_MOVE
    {0, 0, {{24, 1}}, {}},  {1, 0, {{25, 1}}, {}},  {2, 0, {{26, 1}}, {}},
    {3, 0, {{27, 1}}, {}},  {4, 0, {{28, 1}}, {}},  {5, 0, {{29, 1}}, {}},
    {6, 0, {{30, 1}}, {}},  {7, 0, {{31, 1}}, {}},  {8, 0, {{32, 1}}, {}},
    {9, 0, {{33, 1}}, {}},  {10, 0, {{34, 1}}, {}}, {11, 0, {{35, 1}}, {}},
    // CONJ: A's w half negated
    {6, 0, {{6, -1}}, {}},  {7, 0, {{7, -1}}, {}},  {8, 0, {{8, -1}}, {}},
    {9, 0, {{9, -1}}, {}},  {10, 0, {{10, -1}}, {}}, {11, 0, {{11, -1}}, {}},
};

__device__ __forceinline__ void load_slot(const Elem& m, int c, Fp& x) {
  t381::load_fp(m, c / 2, c % 2, x);
}

__device__ __forceinline__ void store_slot(const Elem& m, int c, const Fp& x) {
  t381::store_fp(m, c / 2, c % 2, x);
}

// acc <- the sum of up to n terms (the first taken as it is when positive).
__device__ __forceinline__ void sum_fp(const Elem& m, const FpTerm* t, int n, Fp& acc) {
  int i = 0;
  if (t[0].coef > 0) {
    load_slot(m, t[0].slot, acc);
    i = 1;
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) acc.w[k] = 0;
  }
#pragma unroll 1
  for (; i < n && t[i].coef != 0; ++i) {
    Fp v;
    load_slot(m, t[i].slot, v);
    if (t[i].coef > 0) f381::add(acc, v, acc);
    else f381::sub(acc, v, acc);
  }
}

__device__ __forceinline__ void run_mul_job(const Elem& m, const MulJob& op) {
  Fp x, y, r;
  sum_fp(m, op.x, MUL_TERMS, x);
  sum_fp(m, op.y, MUL_TERMS, y);
  f381::mont_mul(x, y, r);
  if (op.dbl) f381::add(r, r, r);
  store_slot(m, op.dst, r);
}

__device__ __forceinline__ void run_sum_job(const Elem& m, const SumJob& op) {
  Fp u, s;
  sum_fp(m, op.u, SUM_TERMS, u);
  if (op.s[0].coef != 0) {
    sum_fp(m, op.s, SUM_TWICE, s);
    if (op.triple) f381::add(u, s, s);
    f381::add(s, s, s);
    f381::add(u, s, u);
  }
  store_slot(m, op.dst, u);
}

// FROB job j: component h = j % 2 of Fp2 component k = j / 2 of A's
// Frobenius map of power p into HARD_TMP + j: (v0 + v1 u) conjugated for
// an odd p, times the constant c of k (frob: (FROB_POWERS, 6, 2, 12)
// words, ops/final_exp.py:FROB_WORDS; c = 1 at k = 0): re v0 c0 -+ v1 c1,
// im v0 c1 +- v1 c0, the sign flipped for an odd p.
__device__ __forceinline__ void frob_fp_job(const Elem& m, const int* frob, int power, int j) {
  const int k = j / 2, h = j % 2;
  const int* w = frob + ((power - 1) * 6 + k) * 2 * NW;
  Fp v, c, r, s;
  load_slot(m, 2 * k, v);
#pragma unroll
  for (int i = 0; i < NW; ++i) c.w[i] = static_cast<u32>(w[h * NW + i]);
  f381::mont_mul(v, c, r);
  load_slot(m, 2 * k + 1, v);
#pragma unroll
  for (int i = 0; i < NW; ++i) c.w[i] = static_cast<u32>(w[(1 - h) * NW + i]);
  f381::mont_mul(v, c, s);
  if ((h == 0) != ((power & 1) != 0)) f381::sub(r, s, r);
  else f381::add(r, s, r);
  store_slot(m, HARD_TMP + j, r);
}

constexpr int HARD_OP_INTS = 4;  // code, a, b, flags

// in: value 0, a (12, 12, n) word stack; scratch: values 1 .. V-1, (V - 1,
// 12, 12, n) words; out: (12, 30, n) digits or (12, 24, n) strict limbs, by
// the chain's OUT_FMT; prog: nops ops of HARD_OP_INTS int32 each.
struct HardChain {
  const int* in;
  int* scratch;
  int* out;
  const int* prog;
  int nops;
  const int* frob;
};

// Fp component `row` of value v -> slot `comp`, negated if asked.
__device__ __forceinline__ void load_value(const Block& b, const HardChain& c, int v, int row,
                                           int comp, bool negate, int e) {
  Fp x;
  fp_from_words(b, v > 0 ? c.scratch + static_cast<long long>(v - 1) * FP12_FP * NW * b.n : c.in,
                row, e, x);
  if (negate) f381::neg(x, x);
  store_slot(b.elem(e), comp, x);
}

template <int OUT_FMT = t381::DIGIT_ROWS, class Phase>
__device__ __forceinline__ void hard_chain(const Block& b, const HardChain& c,
                                           const Phase& phase) {
  const auto sums = [&](int kind, int at, int jobs) {
    mark(phase, kind, 0);
    phase(jobs, [&](int k, int e) { run_sum_job(b.elem(e), HARD_SUMS[at + k]); });
  };
  const auto muls = [&](int kind, int at, int jobs) {
    mark(phase, kind, 0);
    phase(jobs, [&](int k, int e) { run_mul_job(b.elem(e), HARD_MULS[at + k]); });
  };
#pragma unroll 1
  for (int pc = 0; pc < c.nops; ++pc) {
    const int* op = c.prog + HARD_OP_INTS * pc;
    const int code = op[0], x = op[1], y = op[2], flags = op[3];
    switch (code) {
      case H_LOAD: {
        const int na = x >= 0 ? FP12_FP : 0, nb = y >= 0 ? FP12_FP : 0;
        mark(phase, HK_LOAD, 0);
        phase(na + nb, [&](int j, int e) {
          if (j < na) load_value(b, c, x, j, j, (flags & 1) && j >= 6, e);
          else load_value(b, c, y, j - na, HARD_B + j - na, (flags & 2) && j - na >= 6, e);
        });
        break;
      }
      case H_SQR:
#pragma unroll 1
        for (int s = 0; s < x; ++s) {
          muls(HK_SQR_PRODUCTS, HM_SQR, 18);
          sums(HK_SQR_RECOMBINE, HS_RECOMBINE, 12);
        }
        break;
      case H_MUL:
        muls(HK_MUL_P1, HM_P1, 36);
        muls(HK_MUL_P2, HM_P2, 18);
        sums(HK_MUL_FP6, HS_FP6, 18);
        sums(HK_MUL_RESULT, HS_RESULT, 12);
        sums(HK_MUL_MOVE, HS_MOVE, 12);
        break;
      case H_CONJ:
        sums(HK_CONJ, HS_CONJ, 6);
        break;
      case H_FROB:
        mark(phase, HK_FROB, 0);
        phase(FP12_FP, [&](int j, int e) { frob_fp_job(b.elem(e), c.frob, x, j); });
        sums(HK_FROB_MOVE, HS_MOVE, 12);
        break;
      case H_STORE:
        mark(phase, HK_STORE, 0);
        phase(FP12_FP, [&](int k, int e) {
          store_words(b, c.scratch + static_cast<long long>(x - 1) * FP12_FP * NW * b.n, k, k,
                      e);
        });
        break;
      default:  // H_OUT
        mark(phase, HK_OUT, 0);
        phase(FP12_FP,
              [&](int k, int e) { t381::store_component(b, c.out, k, k, e, OUT_FMT); });
        break;
    }
  }
}

}  // namespace fexp
