// Device functions of the fused final exponentiation on the 32-bit tower of
// tower381.cuh, for the two chain kernels of final_exp.cu: FE-easy (the easy
// part, f^((p^6 - 1)(p^2 + 1))) and FE-hard (the hard part, the BLS12-381
// cyclotomic addition chain of oracle/pairing.py:final_exp).
//
// Both run on the block program of tower381.cuh: each element's state lives
// in shared memory as canonical Montgomery words (R = 2^384) in K4's 30 Fp2
// slots, and a block's threads run phases of independent jobs with a
// barrier between. Nothing crosses the stacks as digits between FE-easy's
// load of f and FE-hard's store of the result: FE-easy writes its output as
// words, FE-hard reads them and keeps its values t0-t6 as words in a scratch
// stack between uses. The outer edges take the formats of tower381.cuh
// (template parameters, an instantiation each): FE-easy loads f as digits,
// as words (the fused pairing's K6-chain stores conj(f) as words, and the
// identity mask selects on them) or as strict limbs (the strict engine's
// fp12, as its K6-chain stores conj(f)), FE-hard stores its result as
// digits or as the strict (24, n) limbs the pairing returns.
//
// FE-easy is a fixed program: f into slots 0-5; the inverse of
// tower_lazy.fp12_inv -> fp6_inv -> fp2_inv as phases of Fp2 products and
// sums (the norm inverted by finv::fermat, one job an element); conj(f) f^-1
// on K4's product phases; its Frobenius square times itself, again on K4's
// phases; the result stored as words.
//
// FE-hard interprets a program of the hard part that the host builds
// (ops/final_exp.py: HARD_PROGRAM), the same list its plain version walks on
// digits: an accumulator A in slots 0-5, an operand B in slots 6-11, and
// ops
//   LOAD a, b, flags   A <- value a, B <- value b (either may be -1: kept);
//                      flags bit 0 conjugates A, bit 1 B
//   SQR n              A <- A^(2^n), n Granger-Scott squares (K3's phases)
//   MUL                A <- A B (K4's phases, the result moved to 0-5)
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

constexpr int SLOTS = t381::FP12_MUL_SLOTS;  // K4's 30 Fp2 slots
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
// its Fp2 inverse by the Fermat ladder (22), r = c / norm (23-25). Then
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
// `dst`: the norm's inverse by the Fermat ladder of fp_inv.cuh (x^(p-2), 0
// for 0), all in one job.
__device__ __forceinline__ void fp2_inv_job(const Elem& m, int src, int dst) {
  Fp2 a, r;
  Fp n, t, inv;
  t381::load(m, src, a);
  f381::mont_mul(a.c0, a.c0, n);
  f381::mont_mul(a.c1, a.c1, t);
  f381::add(n, t, n);
  finv::fermat(n, inv);
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

enum HardCode { H_LOAD = 1, H_SQR = 2, H_MUL = 3, H_CONJ = 4, H_FROB = 5, H_STORE = 6, H_OUT = 7 };

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

// Fp component `row` of value v -> component `comp` of the slots, negated if
// asked.
__device__ __forceinline__ void load_value(const Block& b, const HardChain& c, int v, int row,
                                           int comp, bool negate, int e) {
  Fp x;
  fp_from_words(b, v > 0 ? c.scratch + static_cast<long long>(v - 1) * FP12_FP * NW * b.n : c.in,
                row, e, x);
  if (negate) f381::neg(x, x);
  t381::store_fp(b.elem(e), comp / 2, comp % 2, x);
}

template <int OUT_FMT = t381::DIGIT_ROWS, class Phase>
__device__ __forceinline__ void hard_chain(const Block& b, const HardChain& c,
                                           const Phase& phase) {
#pragma unroll 1
  for (int pc = 0; pc < c.nops; ++pc) {
    const int* op = c.prog + HARD_OP_INTS * pc;
    const int code = op[0], x = op[1], y = op[2], flags = op[3];
    switch (code) {
      case H_LOAD: {
        const int na = x >= 0 ? FP12_FP : 0, nb = y >= 0 ? FP12_FP : 0;
        phase(na + nb, [&](int j, int e) {
          if (j < na) load_value(b, c, x, j, j, (flags & 1) && j >= 6, e);
          else load_value(b, c, y, j - na, j - na + FP12_FP, (flags & 2) && j - na >= 6, e);
        });
        break;
      }
      case H_SQR:
#pragma unroll 1
        for (int s = 0; s < x; ++s) {
          phase(9, [&](int k, int e) { t381::run_sqr(b.elem(e), t381::CYC_SQUARES[k]); });
          phase(6, [&](int k, int e) { t381::run(b.elem(e), t381::CYC_RECOMBINE[k]); });
        }
        break;
      case H_MUL:
        fp12_mul_phases(b, phase);
        phase(6, [&](int k, int e) { move_job(b.elem(e), t381::FP12_MUL_OUT + k, k, false); });
        break;
      case H_CONJ:
        phase(3, [&](int k, int e) { move_job(b.elem(e), 3 + k, 3 + k, true); });
        break;
      case H_FROB:
        phase(6, [&](int k, int e) { frob_job(b.elem(e), c.frob, x, 0, 0, k); });
        break;
      case H_STORE:
        phase(FP12_FP, [&](int k, int e) {
          store_words(b, c.scratch + static_cast<long long>(x - 1) * FP12_FP * NW * b.n, k, k,
                      e);
        });
        break;
      default:  // H_OUT
        phase(FP12_FP,
              [&](int k, int e) { t381::store_component(b, c.out, k, k, e, OUT_FMT); });
        break;
    }
  }
}

}  // namespace fexp
