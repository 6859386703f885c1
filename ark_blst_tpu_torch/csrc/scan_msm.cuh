// Device bodies of the scan MSM's chains (scan_msm.cu), generic over the
// coordinate field F (Fp for G1, Fp2 for G2), on the complete RCB15
// addition and doubling of group381.cuh: scan-acc's three passes (the
// points to words, the walk of each (lane, window) stream by a team of
// threads, the buckets' split into strict limbs), the running/total walk
// of one window's buckets (scan-red) and the Horner walk over the window
// sums (scan-horner).
//
// Layouts: a point batch is a stack of its 3 NC Fp components (x, y, z;
// re before im on G2), each 24 strict 16-bit limbs (R = 2^384, the strict
// engine's, ops/convert.py), component q's limb j of element i at
// [(24 q + j) n + i] for n elements. Strict limbs are the words' own number
// (t381::read_row / write_row with LIMB_ROWS: a repack, the load reduced
// below p), so every chain computes on canonical words and stores
// canonical limbs: its outputs equal the plain loops' (ops/scan_msm.py)
// limb for limb. Between its passes scan-acc keeps points and buckets as
// records of 3 NC 12 canonical words (see "scan-acc" below).
//
// Compiles as host C++ too (group381.cuh, tower381.cuh):
// tests/test_torch_scan_msm_host.py runs each body on the CPU under
// -fsanitize=undefined, the walk's phases job by job.
#pragma once

#include "group381.cuh"
#include "tower381.cuh"

namespace smsm {

using f381::Fp;
using f381::Fp2;
using f381::NW;
using f381::u32;

constexpr int LIMBS = 2 * NW;  // strict limbs of an Fp component

// An element of F from strict limbs at src[k * s], its im component cs
// further on (G2) -> canonical words; and back.
__device__ __forceinline__ void read_limbs(const int* src, long long s, long long, Fp& x) {
  t381::read_row(src, s, t381::LIMB_ROWS, x);
}

__device__ __forceinline__ void read_limbs(const int* src, long long s, long long cs, Fp2& x) {
  t381::read_row(src, s, t381::LIMB_ROWS, x.c0);
  t381::read_row(src + cs, s, t381::LIMB_ROWS, x.c1);
}

__device__ __forceinline__ void write_limbs(const Fp& x, int* dst, long long s, long long) {
  t381::write_row(x, dst, s, t381::LIMB_ROWS);
}

__device__ __forceinline__ void write_limbs(const Fp2& x, int* dst, long long s, long long cs) {
  t381::write_row(x.c0, dst, s, t381::LIMB_ROWS);
  t381::write_row(x.c1, dst + cs, s, t381::LIMB_ROWS);
}

// The same element as 12 words at src[k * s] (a bucket held in the first
// 12 of its component's 24 limb rows).
__device__ __forceinline__ void load_words(const int* src, long long s, long long, Fp& x) {
  g381::load(src, s, x);
}

__device__ __forceinline__ void load_words(const int* src, long long s, long long cs, Fp2& x) {
  g381::load(src, s, x.c0);
  g381::load(src + cs, s, x.c1);
}

__device__ __forceinline__ void store_words(const Fp& x, int* dst, long long s, long long) {
  g381::store(x, dst, s);
}

__device__ __forceinline__ void store_words(const Fp2& x, int* dst, long long s, long long cs) {
  g381::store(x.c0, dst, s);
  g381::store(x.c1, dst + cs, s);
}

// A point (X, Y, Z) of a stack whose Fp components lie cs apart, element
// stride s: coordinate c at component c NC.
template <class F>
__device__ __forceinline__ void read_point(const int* src, long long s, long long cs, F& X,
                                           F& Y, F& Z) {
  constexpr int NC = g381::NC<F>;
  read_limbs(src, s, cs, X);
  read_limbs(src + NC * cs, s, cs, Y);
  read_limbs(src + 2 * NC * cs, s, cs, Z);
}

template <class F>
__device__ __forceinline__ void write_point(const F& X, const F& Y, const F& Z, int* dst,
                                            long long s, long long cs) {
  constexpr int NC = g381::NC<F>;
  write_limbs(X, dst, s, cs);
  write_limbs(Y, dst + NC * cs, s, cs);
  write_limbs(Z, dst + 2 * NC * cs, s, cs);
}

// The identity (0 : 1 : 0), one = R mod p (im 0 on G2).
__device__ __forceinline__ void set_zero(Fp& x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = 0;
}

__device__ __forceinline__ void set_zero(Fp2& x) {
  set_zero(x.c0);
  set_zero(x.c1);
}

__device__ __forceinline__ void set_one(Fp& x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = f381::R_MOD_P[k];
}

__device__ __forceinline__ void set_one(Fp2& x) {
  set_one(x.c0);
  set_zero(x.c1);
}

template <class F>
__device__ __forceinline__ void set_identity(F& X, F& Y, F& Z) {
  set_zero(X);
  set_one(Y);
  set_zero(Z);
}

// The group law the walks call, one out-of-line copy of each over each
// field on the card (a call, its operands by reference), so that a kernel
// holds one body however many call sites it has (scan-red two additions,
// scan-horner an addition and a doubling). Inlined, two call sites of the
// G1 addition (or an addition and a doubling) in one walk crash nvcc 12.9's
// device front end (cicc, a segmentation fault), one does not; over Fp2 the
// bodies are 36 and 24 Fp products, fully unrolled.
#ifdef __CUDACC__
#define SMSM_CALL __device__ __noinline__
#else
#define SMSM_CALL inline
#endif

SMSM_CALL void add(Fp& X, Fp& Y, Fp& Z, const Fp& X2, const Fp& Y2, const Fp& Z2) {
  g381::complete_add(X, Y, Z, X2, Y2, Z2);
}

SMSM_CALL void add(Fp2& X, Fp2& Y, Fp2& Z, const Fp2& X2, const Fp2& Y2, const Fp2& Z2) {
  g381::complete_add(X, Y, Z, X2, Y2, Z2);
}

SMSM_CALL void dbl(Fp& X, Fp& Y, Fp& Z) { g381::complete_dbl(X, Y, Z); }

SMSM_CALL void dbl(Fp2& X, Fp2& Y, Fp2& Z) { g381::complete_dbl(X, Y, Z); }

// --- scan-acc: the bucket accumulation in three passes ---------------------------
//
// scan-acc computes, for every stream (lane l of `lanes`, window w of W;
// step t of the stream takes point t lanes + l, n a multiple of lanes):
//   bucket[l, w, b] <- (0 : 1 : 0) for b < B
//   for each step t: d = digits[w, t lanes + l] mod B (digit 0 adds into
//     bucket 0, as the plain loop does),
//     bucket[l, w, d] <- complete_add(bucket[l, w, d], point)
// in three launches:
//   words  points (3 NC, 24, n) strict limbs -> pw (n, PW) canonical
//          words, point-major (point_to_words: each point converted once);
//   walk   pw and digits (W, n) -> bk (lanes W B, PW) canonical words: the
//          identity into every bucket first (init_job, a block's threads
//          on one stream's records at a time), then a team of threads a
//          stream (walk_stream);
//   split  bk -> out (3 NC, 24, lanes, W, B) strict limbs, the plain loop's
//          leaves stacked (split_load / split_store).
// PW = 3 NC 12 words a point or bucket (x, y, z; re before im on G2;
// component q at words [12 q, 12 q + 12)): 36 on G1, 72 on G2, 144 / 288
// bytes, so every record is 16-byte aligned and moves as 9 / 18 vectors of
// four words. Bucket b of stream (l, w) is record (l W + w) B + b of bk:
// a bucket's words lie together and a stream's buckets too, and bk's
// records are out's elements in order.
//
// The walk's team: the complete addition's 12 products in F run as jobs
// in phases over the team's operands in shared memory (TeamMem), as the
// block programs of tower381.cuh run K3-K6:
//   G1 (12 Fp slots: 0-5 bucket X1 Y1 Z1, point X2 Y2 Z2; 6-11 products)
//     P1 6 products  t0 t1 t2 m3 m4 m5 -> 6-11
//     L1 6 sums      t3 t4 ty' t0t z3 t1m -> 0-5
//     P2 6 products  t3 t1m, t4 ty', t1m z3, ty' t0t, z3 t4, t0t t3 -> 6-11
//     L2 3 sums      X3 Y3 Z3 -> the bucket in device memory
//   G2 (30 Fp slots: 0-11 the six Fp2 operands, re then im; 12-29 legs)
//     P1 18 Fp products: each of P1's six Fp2 products as its three
//        Karatsuba legs a0 b0, a1 b1, (a0 + a1)(b0 + b1) -> 12-29
//     L0 12 sums     the six products from their legs -> 0-11
//     L1 12 sums     the Fp components of L1's six values -> 12-23
//     P2 18 Fp products, the legs of P2's six -> 0-11 and 24-29
//     L2 6 sums      X3 Y3 Z3 from their legs -> the bucket
// with t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, ty' = b3 (m5 - t0 - t2),
// t0t = 3 t0, z3 = t1 + b3 t2, t1m = t1 - b3 t2, X3 = t3 t1m - t4 ty',
// Y3 = t1m z3 + ty' t0t, Z3 = z3 t4 + t0t t3: the expressions of
// group381.cuh complete_add (and curves/group.py CurveOps.add), b3 = 12
// on G1 and 12 (1 + u) on G2, with 12 (a + b u) (1 + u) = 12 (a - b) +
// 12 (a + b) u. Every value is canonical and every operation exact, so
// the buckets equal the plain loop's limb for limb. No phase writes a slot
// another job of its phase reads. Each step loads the bucket and the point
// (one phase of vector jobs) and ends with L2's stores, so the next step
// reads what this one wrote, in stream order.

// Four words at p, 16-byte aligned: one vector access on the card.
__device__ __forceinline__ void load4(const int* p, u32 (&v)[4]) {
#ifdef __CUDACC__
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = static_cast<u32>(q.x);
  v[1] = static_cast<u32>(q.y);
  v[2] = static_cast<u32>(q.z);
  v[3] = static_cast<u32>(q.w);
#else
  for (int m = 0; m < 4; ++m) v[m] = static_cast<u32>(p[m]);
#endif
}

__device__ __forceinline__ void store4(int* p, u32 a, u32 b, u32 c, u32 d) {
#ifdef __CUDACC__
  *reinterpret_cast<int4*>(p) = make_int4(static_cast<int>(a), static_cast<int>(b),
                                          static_cast<int>(c), static_cast<int>(d));
#else
  p[0] = static_cast<int>(a);
  p[1] = static_cast<int>(b);
  p[2] = static_cast<int>(c);
  p[3] = static_cast<int>(d);
#endif
}

__device__ __forceinline__ void store_words4(const Fp& x, int* dst) {
#pragma unroll
  for (int v = 0; v < NW / 4; ++v)
    store4(dst + 4 * v, x.w[4 * v], x.w[4 * v + 1], x.w[4 * v + 2], x.w[4 * v + 3]);
}

template <class F>
constexpr int PW = g381::PT_WORDS<F>;  // words of a point or bucket record
template <class F>
constexpr int PV = PW<F> / 4;  // its vectors

// words: point i's 3 NC components, strict limbs at pts[(24 q + j) n + i]
// (reduced below p), -> canonical words at pw[i PW + 12 q ..].
template <class F>
__device__ __forceinline__ void point_to_words(const int* __restrict__ pts, int* __restrict__ pw,
                                               long long n, long long i) {
#pragma unroll 1
  for (int q = 0; q < 3 * g381::NC<F>; ++q) {
    Fp x;
    t381::limbs_to_words(pts + static_cast<long long>(q) * LIMBS * n + i, n, x);
    store_words4(x, pw + i * PW<F> + q * NW);
  }
}

// A team's operands: word k of slot q at s[(12 q + k) st] (the teams of a
// block interleaved, st apart).
struct TeamMem {
  u32* s;
  int st;
};

__device__ __forceinline__ void load_slot(const TeamMem& m, int q, Fp& x) {
  const u32* p = m.s + static_cast<long long>(q) * NW * m.st;
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = p[k * m.st];
}

__device__ __forceinline__ void store_slot(const TeamMem& m, int q, const Fp& x) {
  u32* p = m.s + static_cast<long long>(q) * NW * m.st;
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k * m.st] = x.w[k];
}

// A signed slot of a sum (coef +1 or -1); coef 0 ends the list.
struct Term {
  signed char slot, coef;
};

constexpr int MUL_TERMS = 4;
constexpr int LIN_TERMS = 6;

// dst <- (sum of a) (sum of b), one Fp product.
struct MulJob {
  signed char dst;
  Term a[MUL_TERMS], b[MUL_TERMS];
};

// dst <- (sum of u) + scale (sum of s), scale 1, 3 or 12; L2's dst is the
// bucket's component.
struct LinJob {
  signed char dst, scale;
  Term u[LIN_TERMS], s[LIN_TERMS];
};

// acc <- the sum of up to n terms.
__device__ __forceinline__ void sum_terms(const TeamMem& m, const Term* t, int n, Fp& acc) {
  int i = 0;
  if (t[0].coef == 1) {
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

__device__ __forceinline__ void run_mul(const TeamMem& m, const MulJob& op) {
  Fp a, b, r;
  sum_terms(m, op.a, MUL_TERMS, a);
  sum_terms(m, op.b, MUL_TERMS, b);
  f381::mont_mul(a, b, r);
  store_slot(m, op.dst, r);
}

__device__ __forceinline__ void lin_value(const TeamMem& m, const LinJob& op, Fp& r) {
  Fp s, k;
  sum_terms(m, op.u, LIN_TERMS, r);
  if (op.s[0].coef == 0) return;
  sum_terms(m, op.s, LIN_TERMS, s);
  if (op.scale == 12) f381::mul_small<12>(s, k);
  else if (op.scale == 3) f381::mul_small<3>(s, k);
  else k = s;
  f381::add(r, k, r);
}

__device__ __forceinline__ void run_lin(const TeamMem& m, const LinJob& op) {
  Fp r;
  lin_value(m, op, r);
  store_slot(m, op.dst, r);
}

// L2: component op.dst of the sum into the bucket record.
__device__ __forceinline__ void store_lin(const TeamMem& m, const LinJob& op, int* bucket) {
  Fp r;
  lin_value(m, op, r);
  store_words4(r, bucket + op.dst * NW);
}

// G1's program (slots: 0 X1, 1 Y1, 2 Z1, 3 X2, 4 Y2, 5 Z2; P1: 6 t0, 7 t1,
// 8 t2, 9 m3, 10 m4, 11 m5; L1: 0 t3, 1 t4, 2 ty', 3 t0t, 4 z3, 5 t1m; P2:
// 6 t3 t1m, 7 t4 ty', 8 t1m z3, 9 ty' t0t, 10 z3 t4, 11 t0t t3).
__constant__ MulJob ACC1_P1[6] = {
    {6, {{0, 1}}, {{3, 1}}},                  // t0 = X1 X2
    {7, {{1, 1}}, {{4, 1}}},                  // t1 = Y1 Y2
    {8, {{2, 1}}, {{5, 1}}},                  // t2 = Z1 Z2
    {9, {{0, 1}, {1, 1}}, {{3, 1}, {4, 1}}},  // m3 = (X1 + Y1)(X2 + Y2)
    {10, {{1, 1}, {2, 1}}, {{4, 1}, {5, 1}}}, // m4 = (Y1 + Z1)(Y2 + Z2)
    {11, {{0, 1}, {2, 1}}, {{3, 1}, {5, 1}}}, // m5 = (X1 + Z1)(X2 + Z2)
};

__constant__ LinJob ACC1_L1[6] = {
    {0, 1, {{9, 1}, {6, -1}, {7, -1}}, {}},     // t3 = m3 - t0 - t1
    {1, 1, {{10, 1}, {7, -1}, {8, -1}}, {}},    // t4 = m4 - t1 - t2
    {2, 12, {}, {{11, 1}, {6, -1}, {8, -1}}},   // ty' = 12 (m5 - t0 - t2)
    {3, 3, {}, {{6, 1}}},                       // t0t = 3 t0
    {4, 12, {{7, 1}}, {{8, 1}}},                // z3 = t1 + 12 t2
    {5, 12, {{7, 1}}, {{8, -1}}},               // t1m = t1 - 12 t2
};

__constant__ MulJob ACC1_P2[6] = {
    {6, {{0, 1}}, {{5, 1}}},  // t3 t1m
    {7, {{1, 1}}, {{2, 1}}},  // t4 ty'
    {8, {{5, 1}}, {{4, 1}}},  // t1m z3
    {9, {{2, 1}}, {{3, 1}}},  // ty' t0t
    {10, {{4, 1}}, {{1, 1}}}, // z3 t4
    {11, {{3, 1}}, {{0, 1}}}, // t0t t3
};

__constant__ LinJob ACC1_L2[3] = {
    {0, 1, {{6, 1}, {7, -1}}, {}},  // X3
    {1, 1, {{8, 1}, {9, 1}}, {}},   // Y3
    {2, 1, {{10, 1}, {11, 1}}, {}}, // Z3
};

// G2's program. Slots 0-11 the Fp components of the six Fp2 operands (0
// X1 re, 1 X1 im, 2 Y1, 4 Z1, 6 X2, 8 Y2, 10 Z2); P1's product k (t0 t1
// t2 m3 m4 m5) leg h at 12 + 3 k + h; L0 product k at 2 k, 2 k + 1; L1's
// values (t3 t4 ty' t0t z3 t1m) at 12 + 2 i, 13 + 2 i; P2's product k leg
// h at 3 k + h for k < 4, 12 + 3 k + h after (0-11, then 24-29).
__constant__ MulJob ACC2_P1[18] = {
    {12, {{0, 1}}, {{6, 1}}},  // t0 = X1 X2: a0 b0
    {13, {{1, 1}}, {{7, 1}}},  // t0 = X1 X2: a1 b1
    {14, {{0, 1}, {1, 1}}, {{6, 1}, {7, 1}}},  // t0 = X1 X2: (a0 + a1)(b0 + b1)
    {15, {{2, 1}}, {{8, 1}}},  // t1 = Y1 Y2: a0 b0
    {16, {{3, 1}}, {{9, 1}}},  // t1 = Y1 Y2: a1 b1
    {17, {{2, 1}, {3, 1}}, {{8, 1}, {9, 1}}},  // t1 = Y1 Y2: (a0 + a1)(b0 + b1)
    {18, {{4, 1}}, {{10, 1}}},  // t2 = Z1 Z2: a0 b0
    {19, {{5, 1}}, {{11, 1}}},  // t2 = Z1 Z2: a1 b1
    {20, {{4, 1}, {5, 1}}, {{10, 1}, {11, 1}}},  // t2 = Z1 Z2: (a0 + a1)(b0 + b1)
    {21, {{0, 1}, {2, 1}}, {{6, 1}, {8, 1}}},  // m3 = (X1 + Y1)(X2 + Y2): a0 b0
    {22, {{1, 1}, {3, 1}}, {{7, 1}, {9, 1}}},  // m3 = (X1 + Y1)(X2 + Y2): a1 b1
    {23, {{0, 1}, {1, 1}, {2, 1}, {3, 1}}, {{6, 1}, {7, 1}, {8, 1}, {9, 1}}},  // m3 leg 2
    {24, {{2, 1}, {4, 1}}, {{8, 1}, {10, 1}}},  // m4 = (Y1 + Z1)(Y2 + Z2): a0 b0
    {25, {{3, 1}, {5, 1}}, {{9, 1}, {11, 1}}},  // m4 = (Y1 + Z1)(Y2 + Z2): a1 b1
    {26, {{2, 1}, {3, 1}, {4, 1}, {5, 1}}, {{8, 1}, {9, 1}, {10, 1}, {11, 1}}},  // m4 leg 2
    {27, {{0, 1}, {4, 1}}, {{6, 1}, {10, 1}}},  // m5 = (X1 + Z1)(X2 + Z2): a0 b0
    {28, {{1, 1}, {5, 1}}, {{7, 1}, {11, 1}}},  // m5 = (X1 + Z1)(X2 + Z2): a1 b1
    {29, {{0, 1}, {1, 1}, {4, 1}, {5, 1}}, {{6, 1}, {7, 1}, {10, 1}, {11, 1}}},  // m5 leg 2
};

__constant__ LinJob ACC2_L0[12] = {
    {0, 1, {{12, 1}, {13, -1}}, {}},  // t0 re = a0 b0 - a1 b1
    {1, 1, {{14, 1}, {12, -1}, {13, -1}}, {}},  // t0 im = leg 2 - a0 b0 - a1 b1
    {2, 1, {{15, 1}, {16, -1}}, {}},  // t1 re = a0 b0 - a1 b1
    {3, 1, {{17, 1}, {15, -1}, {16, -1}}, {}},  // t1 im = leg 2 - a0 b0 - a1 b1
    {4, 1, {{18, 1}, {19, -1}}, {}},  // t2 re = a0 b0 - a1 b1
    {5, 1, {{20, 1}, {18, -1}, {19, -1}}, {}},  // t2 im = leg 2 - a0 b0 - a1 b1
    {6, 1, {{21, 1}, {22, -1}}, {}},  // m3 re = a0 b0 - a1 b1
    {7, 1, {{23, 1}, {21, -1}, {22, -1}}, {}},  // m3 im = leg 2 - a0 b0 - a1 b1
    {8, 1, {{24, 1}, {25, -1}}, {}},  // m4 re = a0 b0 - a1 b1
    {9, 1, {{26, 1}, {24, -1}, {25, -1}}, {}},  // m4 im = leg 2 - a0 b0 - a1 b1
    {10, 1, {{27, 1}, {28, -1}}, {}},  // m5 re = a0 b0 - a1 b1
    {11, 1, {{29, 1}, {27, -1}, {28, -1}}, {}},  // m5 im = leg 2 - a0 b0 - a1 b1
};

__constant__ LinJob ACC2_L1[12] = {
    {12, 1, {{6, 1}, {0, -1}, {2, -1}}, {}},  // t3 re = m3 - t0 - t1
    {13, 1, {{7, 1}, {1, -1}, {3, -1}}, {}},  // t3 im
    {14, 1, {{8, 1}, {2, -1}, {4, -1}}, {}},  // t4 re = m4 - t1 - t2
    {15, 1, {{9, 1}, {3, -1}, {5, -1}}, {}},  // t4 im
    {16, 12, {}, {{10, 1}, {0, -1}, {4, -1}, {11, -1}, {1, 1}, {5, 1}}},  // ty' re = 12 (ty re - ty im)
    {17, 12, {}, {{10, 1}, {0, -1}, {4, -1}, {11, 1}, {1, -1}, {5, -1}}},  // ty' im = 12 (ty re + ty im)
    {18, 3, {}, {{0, 1}}},  // t0t re = 3 t0
    {19, 3, {}, {{1, 1}}},  // t0t im
    {20, 12, {{2, 1}}, {{4, 1}, {5, -1}}},  // z3 re = t1 + 12 (t2 re - t2 im)
    {21, 12, {{3, 1}}, {{4, 1}, {5, 1}}},  // z3 im = t1 + 12 (t2 re + t2 im)
    {22, 12, {{2, 1}}, {{4, -1}, {5, 1}}},  // t1m re = t1 - 12 (t2 re - t2 im)
    {23, 12, {{3, 1}}, {{4, -1}, {5, -1}}},  // t1m im = t1 - 12 (t2 re + t2 im)
};

__constant__ MulJob ACC2_P2[18] = {
    {0, {{12, 1}}, {{22, 1}}},  // t3 t1m: a0 b0
    {1, {{13, 1}}, {{23, 1}}},  // t3 t1m: a1 b1
    {2, {{12, 1}, {13, 1}}, {{22, 1}, {23, 1}}},  // t3 t1m: (a0 + a1)(b0 + b1)
    {3, {{14, 1}}, {{16, 1}}},  // t4 ty': a0 b0
    {4, {{15, 1}}, {{17, 1}}},  // t4 ty': a1 b1
    {5, {{14, 1}, {15, 1}}, {{16, 1}, {17, 1}}},  // t4 ty': (a0 + a1)(b0 + b1)
    {6, {{22, 1}}, {{20, 1}}},  // t1m z3: a0 b0
    {7, {{23, 1}}, {{21, 1}}},  // t1m z3: a1 b1
    {8, {{22, 1}, {23, 1}}, {{20, 1}, {21, 1}}},  // t1m z3: (a0 + a1)(b0 + b1)
    {9, {{16, 1}}, {{18, 1}}},  // ty' t0t: a0 b0
    {10, {{17, 1}}, {{19, 1}}},  // ty' t0t: a1 b1
    {11, {{16, 1}, {17, 1}}, {{18, 1}, {19, 1}}},  // ty' t0t: (a0 + a1)(b0 + b1)
    {24, {{20, 1}}, {{14, 1}}},  // z3 t4: a0 b0
    {25, {{21, 1}}, {{15, 1}}},  // z3 t4: a1 b1
    {26, {{20, 1}, {21, 1}}, {{14, 1}, {15, 1}}},  // z3 t4: (a0 + a1)(b0 + b1)
    {27, {{18, 1}}, {{12, 1}}},  // t0t t3: a0 b0
    {28, {{19, 1}}, {{13, 1}}},  // t0t t3: a1 b1
    {29, {{18, 1}, {19, 1}}, {{12, 1}, {13, 1}}},  // t0t t3: (a0 + a1)(b0 + b1)
};

__constant__ LinJob ACC2_L2[6] = {
    {0, 1, {{0, 1}, {1, -1}, {3, -1}, {4, 1}}, {}},  // X3 re = t3 t1m re - t4 ty' re
    {1, 1, {{2, 1}, {0, -1}, {1, -1}, {5, -1}, {3, 1}, {4, 1}}, {}},  // X3 im
    {2, 1, {{6, 1}, {7, -1}, {9, 1}, {10, -1}}, {}},  // Y3 re = t1m z3 re + ty' t0t re
    {3, 1, {{8, 1}, {6, -1}, {7, -1}, {11, 1}, {9, -1}, {10, -1}}, {}},  // Y3 im
    {4, 1, {{24, 1}, {25, -1}, {27, 1}, {28, -1}}, {}},  // Z3 re = z3 t4 re + t0t t3 re
    {5, 1, {{26, 1}, {24, -1}, {25, -1}, {29, 1}, {27, -1}, {28, -1}}, {}},  // Z3 im
};


// The identity's word k of a record: (0 : R mod p : 0), R mod p in y's
// first component.
template <class F>
__device__ __forceinline__ u32 identity_word(int k) {
  const int y0 = g381::NC<F> * NW;
  return k >= y0 && k < y0 + NW ? f381::R_MOD_P[k - y0] : 0u;
}

// Stream (l, w)'s first bucket record in bk.
template <class F>
__device__ __forceinline__ int* stream_buckets(int* bk, int W, int B, int l, int w) {
  return bk + (static_cast<long long>(l) * W + w) * B * PW<F>;
}

// Init job j < B PV of a stream's buckets at base: vector j % PV of record
// j / PV <- the identity's (neighbouring jobs on neighbouring vectors).
template <class F>
__device__ __forceinline__ void init_job(int* base, int j) {
  const int v = j % PV<F>;
  store4(base + static_cast<long long>(j / PV<F>) * PW<F> + 4 * v, identity_word<F>(4 * v),
         identity_word<F>(4 * v + 1), identity_word<F>(4 * v + 2), identity_word<F>(4 * v + 3));
}

// Load job j < 2 PV: vector j of the bucket (j < PV) or of the point into
// the team's slots 0 .. 6 NC - 1 (record word r at slot row r).
template <class F>
__device__ __forceinline__ void load_job(const TeamMem& m, const int* bucket,
                                         const int* __restrict__ point, int j) {
  u32 v[4];
  load4(j < PV<F> ? bucket + 4 * j : point + 4 * (j - PV<F>), v);
#pragma unroll
  for (int k = 0; k < 4; ++k) m.s[static_cast<long long>(4 * j + k) * m.st] = v[k];
}

// One addition on the loaded operands, bucket <- bucket + point, as the
// team's phases; the last stores the bucket.
template <class F, class Team>
__device__ __forceinline__ void add_program(Team& team, const TeamMem& m, int* bucket) {
  if constexpr (g381::NC<F> == 1) {
    team.phase(6, [&](int j) { run_mul(m, ACC1_P1[j]); });
    team.phase(6, [&](int j) { run_lin(m, ACC1_L1[j]); });
    team.phase(6, [&](int j) { run_mul(m, ACC1_P2[j]); });
    team.phase(3, [&](int j) { store_lin(m, ACC1_L2[j], bucket); });
  } else {
    team.phase(18, [&](int j) { run_mul(m, ACC2_P1[j]); });
    team.phase(12, [&](int j) { run_lin(m, ACC2_L0[j]); });
    team.phase(12, [&](int j) { run_lin(m, ACC2_L1[j]); });
    team.phase(18, [&](int j) { run_mul(m, ACC2_P2[j]); });
    team.phase(6, [&](int j) { store_lin(m, ACC2_L2[j], bucket); });
  }
}

// Slots of a team's operands: 12 on G1, 30 on G2.
template <class F>
constexpr int ACC_SLOTS = g381::NC<F> == 1 ? 12 : 30;

// walk: the team of stream (l, w), its operands at m, its buckets already
// the identity (init_job). Team::phase(jobs, job) runs the team's share of
// the phase's jobs and ends with the team's barrier (on the card the
// block's, one job a thread in turn; in the host harness every job in
// order). pw (n, PW) the points' words, digs (W, n), bk (lanes W B, PW)
// the buckets.
template <class F, class Team>
__device__ __forceinline__ void walk_stream(Team& team, const TeamMem& m,
                                            const int* __restrict__ pw,
                                            const int* __restrict__ digs, int* bk, long long n,
                                            int lanes, int W, int B, int l, int w) {
  int* base = stream_buckets<F>(bk, W, B, l, w);
  const long long steps = n / lanes;
  const int* dig_row = digs + static_cast<long long>(w) * n;
#pragma unroll 1
  for (long long t = 0; t < steps; ++t) {
    const long long p = t * lanes + l;
    int* bucket = base + static_cast<long long>(dig_row[p] & (B - 1)) * PW<F>;
    const int* point = pw + p * PW<F>;
    team.phase(2 * PV<F>, [&](int j) { load_job<F>(m, bucket, point, j); });
    add_program<F>(team, m, bucket);
  }
}

// split: records [e0, e0 + count) of bk through a block's shared memory
// sm (word r of record e at sm[r (SPLIT_ELEMS + 1) + e - e0]) into out's
// rows (3 NC 24 of E elements). split_load job j < count PV: vector j % PV
// of record e0 + j / PV (neighbouring jobs on neighbouring vectors);
// split_store job e < count: record e0 + e's 3 NC 24 limbs, one a row
// (neighbouring jobs on neighbouring elements of a row).
constexpr int SPLIT_ELEMS = 128;

template <class F>
__device__ __forceinline__ void split_load(const int* __restrict__ bk, u32* sm, long long e0,
                                           int j) {
  const int e = j / PV<F>, v = j % PV<F>;
  u32 x[4];
  load4(bk + (e0 + e) * PW<F> + 4 * v, x);
#pragma unroll
  for (int k = 0; k < 4; ++k) sm[(4 * v + k) * (SPLIT_ELEMS + 1) + e] = x[k];
}

template <class F>
__device__ __forceinline__ void split_store(const u32* sm, int* __restrict__ out, long long E,
                                            long long e0, int e) {
#pragma unroll 4
  for (int r = 0; r < PW<F>; ++r) {
    const u32 x = sm[r * (SPLIT_ELEMS + 1) + e];
    int* dst = out + (static_cast<long long>(r / NW) * LIMBS + 2 * (r % NW)) * E + e0 + e;
    dst[0] = static_cast<int>(x & 0xFFFF);
    dst[E] = static_cast<int>(x >> 16);
  }
}

// scan-red, one window w of W: running/total suffix sums over its buckets
// B - 1 down to 1 (bucket 0 dropped), from the identity:
//   running <- complete_add(running, bucket[w, b]); total <- complete_add(total, running)
// bk (3 NC, 24, W, B) strict limbs (the buckets after the fold across
// lanes), out (3 NC, 24, W): total, the window's sum sum_b b bucket[w, b].
template <class F>
__device__ __forceinline__ void reduce_window(const int* __restrict__ bk, int* __restrict__ out,
                                              int W, int B, int w) {
  const long long E = static_cast<long long>(W) * B;
  F rX, rY, rZ, tX, tY, tZ;
  set_identity(rX, rY, rZ);
  set_identity(tX, tY, tZ);
  for (int b = B - 1; b >= 1; --b) {
    F X, Y, Z;
    read_point(bk + static_cast<long long>(w) * B + b, E, LIMBS * E, X, Y, Z);
    add(rX, rY, rZ, X, Y, Z);
    add(tX, tY, tZ, rX, rY, rZ);
  }
  write_point(tX, tY, tZ, out + w, W, static_cast<long long>(LIMBS) * W);
}

// scan-horner: the window sums (3 NC, 24, W), most significant window
// first, from the identity: acc <- c doublings of acc, then
// complete_add(acc, sum[w]); out (3 NC, 24, 1), sum_w sum[w] 2^(c w).
template <class F>
__device__ __forceinline__ void horner_walk(const int* __restrict__ sums, int* __restrict__ out,
                                            int W, int c) {
  F X, Y, Z;
  set_identity(X, Y, Z);
  for (int w = W - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) dbl(X, Y, Z);
    F X2, Y2, Z2;
    read_point(sums + w, W, static_cast<long long>(LIMBS) * W, X2, Y2, Z2);
    add(X, Y, Z, X2, Y2, Z2);
  }
  write_point(X, Y, Z, out, 1, LIMBS);
}

}  // namespace smsm
