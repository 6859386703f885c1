// Device bodies of the scan MSM's chains (scan_msm.cu), generic over the
// coordinate field F (Fp for G1, Fp2 for G2), on the complete RCB15
// addition and doubling of group381.cuh: scan-acc's three passes (the
// points to words, the walk of each (lane, window) stream by a team of
// threads, the buckets' split into strict limbs), the running/total walk
// of one window's buckets (scan-red) and the Horner walk over the window
// sums (scan-horner), both by a team of threads a chain; and the
// double-and-add ladder of CurveOps.scalar_mul (scan-mul), a team of
// threads an element.
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
// -fsanitize=undefined, the team walks' phases job by job.
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

// dst <- (sum of u) + scale (sum of s), scale 1, 3, 8 or 12; L2's dst is
// the result's component.
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
  else if (op.scale == 8) f381::mul_small<8>(s, k);
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
// G1's tables: products in MUL1, sums in LIN1, a phase's jobs at its
// offset (scan-acc's addition ACC1_*, the chains' doubling DBL1_*).
constexpr int ACC1_P1 = 0, ACC1_P2 = 6, DBL1_P1 = 12, DBL1_P2 = 16;
constexpr int ACC1_L1 = 0, ACC1_L2 = 6, DBL1_L1 = 9, DBL1_L2 = 13;
__device__ const MulJob MUL1[20] = {
    // ACC1_P1
    {6, {{0, 1}}, {{3, 1}}},                  // t0 = X1 X2
    {7, {{1, 1}}, {{4, 1}}},                  // t1 = Y1 Y2
    {8, {{2, 1}}, {{5, 1}}},                  // t2 = Z1 Z2
    {9, {{0, 1}, {1, 1}}, {{3, 1}, {4, 1}}},  // m3 = (X1 + Y1)(X2 + Y2)
    {10, {{1, 1}, {2, 1}}, {{4, 1}, {5, 1}}}, // m4 = (Y1 + Z1)(Y2 + Z2)
    {11, {{0, 1}, {2, 1}}, {{3, 1}, {5, 1}}}, // m5 = (X1 + Z1)(X2 + Z2)
    // ACC1_P2
    {6, {{0, 1}}, {{5, 1}}},  // t3 t1m
    {7, {{1, 1}}, {{2, 1}}},  // t4 ty'
    {8, {{5, 1}}, {{4, 1}}},  // t1m z3
    {9, {{2, 1}}, {{3, 1}}},  // ty' t0t
    {10, {{4, 1}}, {{1, 1}}}, // z3 t4
    {11, {{3, 1}}, {{0, 1}}}, // t0t t3
    // DBL1_P1
    {6, {{1, 1}}, {{1, 1}}},  // t0 = Y^2
    {7, {{0, 1}}, {{1, 1}}},  // txy = X Y
    {8, {{1, 1}}, {{2, 1}}},  // tyz = Y Z
    {9, {{2, 1}}, {{2, 1}}},  // zz = Z^2
    // DBL1_P2
    {14, {{13, 1}}, {{7, 1}}},   // tdiff txy
    {15, {{10, 1}}, {{11, 1}}},  // t2 y8
    {16, {{8, 1}}, {{11, 1}}},   // tyz y8
    {17, {{13, 1}}, {{12, 1}}},  // tdiff s
};

__device__ const LinJob LIN1[16] = {
    // ACC1_L1
    {0, 1, {{9, 1}, {6, -1}, {7, -1}}, {}},     // t3 = m3 - t0 - t1
    {1, 1, {{10, 1}, {7, -1}, {8, -1}}, {}},    // t4 = m4 - t1 - t2
    {2, 12, {}, {{11, 1}, {6, -1}, {8, -1}}},   // ty' = 12 (m5 - t0 - t2)
    {3, 3, {}, {{6, 1}}},                       // t0t = 3 t0
    {4, 12, {{7, 1}}, {{8, 1}}},                // z3 = t1 + 12 t2
    {5, 12, {{7, 1}}, {{8, -1}}},               // t1m = t1 - 12 t2
    // ACC1_L2
    {0, 1, {{6, 1}, {7, -1}}, {}},  // X3
    {1, 1, {{8, 1}, {9, 1}}, {}},   // Y3
    {2, 1, {{10, 1}, {11, 1}}, {}}, // Z3
    // DBL1_L1
    {10, 12, {}, {{9, 1}}},                         // t2 = 12 zz
    {11, 8, {}, {{6, 1}}},                          // y8 = 8 t0
    {12, 12, {{6, 1}}, {{9, 1}}},                   // s = t0 + 12 zz
    {13, 12, {{6, 1}}, {{9, -1}, {9, -1}, {9, -1}}},  // tdiff = t0 - 36 zz
    // DBL1_L2
    {0, 1, {{14, 1}, {14, 1}}, {}},  // X3 = 2 tdiff txy
    {1, 1, {{15, 1}, {17, 1}}, {}},  // Y3 = t2 y8 + tdiff s
    {2, 1, {{16, 1}}, {}},           // Z3 = tyz y8
};

// G2's program. Slots 0-11 the Fp components of the six Fp2 operands (0
// X1 re, 1 X1 im, 2 Y1, 4 Z1, 6 X2, 8 Y2, 10 Z2); P1's product k (t0 t1
// t2 m3 m4 m5) leg h at 12 + 3 k + h; L0 product k at 2 k, 2 k + 1; L1's
// values (t3 t4 ty' t0t z3 t1m) at 12 + 2 i, 13 + 2 i; P2's product k leg
// h at 3 k + h for k < 4, 12 + 3 k + h after (0-11, then 24-29).
// The chains' G2 addition (CHAIN2_P2, CHAIN2_L2): ACC2_P2 with its legs
// at 24 + 3 k + h (product k, leg h), and ACC2_L2 reading them there.
// The chains' G2 doubling (DBL2_*): P1's products t0 = Y Y, txy = X Y,
// tyz = Y Z, zz = Z Z, leg h of product k at 12 + 3 k + h; L0's at 24 + 2
// k (re), 25 + 2 k (im); L1's t2, y8, s, tdiff at 12 + 2 i, 13 + 2 i; P2's
// tdiff txy, t2 y8, tyz y8, tdiff s, leg h of product k at 32 + 3 k + h.
// G2's tables: products in MUL2, sums in LIN2 (scan-acc's addition
// ACC2_*, the chains' addition's P2 and L2 CHAIN2_*, their doubling
// DBL2_*).
constexpr int ACC2_P1 = 0, ACC2_P2 = 18, CHAIN2_P2 = 36, DBL2_P1 = 54, DBL2_P2 = 66;
constexpr int ACC2_L0 = 0, ACC2_L1 = 12, ACC2_L2 = 24, CHAIN2_L2 = 30, DBL2_L0 = 36,
              DBL2_L1 = 44, DBL2_L2 = 52;
__device__ const MulJob MUL2[78] = {
    // ACC2_P1
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
    // ACC2_P2
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
    // CHAIN2_P2
    {24, {{12, 1}}, {{22, 1}}},  // t3 t1m: a0 b0
    {25, {{13, 1}}, {{23, 1}}},  // t3 t1m: a1 b1
    {26, {{12, 1}, {13, 1}}, {{22, 1}, {23, 1}}},  // t3 t1m: (a0 + a1)(b0 + b1)
    {27, {{14, 1}}, {{16, 1}}},  // t4 ty': a0 b0
    {28, {{15, 1}}, {{17, 1}}},  // t4 ty': a1 b1
    {29, {{14, 1}, {15, 1}}, {{16, 1}, {17, 1}}},  // t4 ty': (a0 + a1)(b0 + b1)
    {30, {{22, 1}}, {{20, 1}}},  // t1m z3: a0 b0
    {31, {{23, 1}}, {{21, 1}}},  // t1m z3: a1 b1
    {32, {{22, 1}, {23, 1}}, {{20, 1}, {21, 1}}},  // t1m z3: (a0 + a1)(b0 + b1)
    {33, {{16, 1}}, {{18, 1}}},  // ty' t0t: a0 b0
    {34, {{17, 1}}, {{19, 1}}},  // ty' t0t: a1 b1
    {35, {{16, 1}, {17, 1}}, {{18, 1}, {19, 1}}},  // ty' t0t: (a0 + a1)(b0 + b1)
    {36, {{20, 1}}, {{14, 1}}},  // z3 t4: a0 b0
    {37, {{21, 1}}, {{15, 1}}},  // z3 t4: a1 b1
    {38, {{20, 1}, {21, 1}}, {{14, 1}, {15, 1}}},  // z3 t4: (a0 + a1)(b0 + b1)
    {39, {{18, 1}}, {{12, 1}}},  // t0t t3: a0 b0
    {40, {{19, 1}}, {{13, 1}}},  // t0t t3: a1 b1
    {41, {{18, 1}, {19, 1}}, {{12, 1}, {13, 1}}},  // t0t t3: (a0 + a1)(b0 + b1)
    // DBL2_P1
    {12, {{2, 1}}, {{2, 1}}},  // t0 = Y Y: a0 b0
    {13, {{3, 1}}, {{3, 1}}},  // t0: a1 b1
    {14, {{2, 1}, {3, 1}}, {{2, 1}, {3, 1}}},  // t0: (a0 + a1)(b0 + b1)
    {15, {{0, 1}}, {{2, 1}}},  // txy = X Y: a0 b0
    {16, {{1, 1}}, {{3, 1}}},  // txy: a1 b1
    {17, {{0, 1}, {1, 1}}, {{2, 1}, {3, 1}}},  // txy: (a0 + a1)(b0 + b1)
    {18, {{2, 1}}, {{4, 1}}},  // tyz = Y Z: a0 b0
    {19, {{3, 1}}, {{5, 1}}},  // tyz: a1 b1
    {20, {{2, 1}, {3, 1}}, {{4, 1}, {5, 1}}},  // tyz: (a0 + a1)(b0 + b1)
    {21, {{4, 1}}, {{4, 1}}},  // zz = Z Z: a0 b0
    {22, {{5, 1}}, {{5, 1}}},  // zz: a1 b1
    {23, {{4, 1}, {5, 1}}, {{4, 1}, {5, 1}}},  // zz: (a0 + a1)(b0 + b1)
    // DBL2_P2
    {32, {{18, 1}}, {{26, 1}}},  // tdiff txy: a0 b0
    {33, {{19, 1}}, {{27, 1}}},  // tdiff txy: a1 b1
    {34, {{18, 1}, {19, 1}}, {{26, 1}, {27, 1}}},  // tdiff txy: (a0 + a1)(b0 + b1)
    {35, {{12, 1}}, {{14, 1}}},  // t2 y8: a0 b0
    {36, {{13, 1}}, {{15, 1}}},  // t2 y8: a1 b1
    {37, {{12, 1}, {13, 1}}, {{14, 1}, {15, 1}}},  // t2 y8: (a0 + a1)(b0 + b1)
    {38, {{28, 1}}, {{14, 1}}},  // tyz y8: a0 b0
    {39, {{29, 1}}, {{15, 1}}},  // tyz y8: a1 b1
    {40, {{28, 1}, {29, 1}}, {{14, 1}, {15, 1}}},  // tyz y8: (a0 + a1)(b0 + b1)
    {41, {{18, 1}}, {{16, 1}}},  // tdiff s: a0 b0
    {42, {{19, 1}}, {{17, 1}}},  // tdiff s: a1 b1
    {43, {{18, 1}, {19, 1}}, {{16, 1}, {17, 1}}},  // tdiff s: (a0 + a1)(b0 + b1)
};

__device__ const LinJob LIN2[58] = {
    // ACC2_L0
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
    // ACC2_L1
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
    // ACC2_L2
    {0, 1, {{0, 1}, {1, -1}, {3, -1}, {4, 1}}, {}},  // X3 re = t3 t1m re - t4 ty' re
    {1, 1, {{2, 1}, {0, -1}, {1, -1}, {5, -1}, {3, 1}, {4, 1}}, {}},  // X3 im
    {2, 1, {{6, 1}, {7, -1}, {9, 1}, {10, -1}}, {}},  // Y3 re = t1m z3 re + ty' t0t re
    {3, 1, {{8, 1}, {6, -1}, {7, -1}, {11, 1}, {9, -1}, {10, -1}}, {}},  // Y3 im
    {4, 1, {{24, 1}, {25, -1}, {27, 1}, {28, -1}}, {}},  // Z3 re = z3 t4 re + t0t t3 re
    {5, 1, {{26, 1}, {24, -1}, {25, -1}, {29, 1}, {27, -1}, {28, -1}}, {}},  // Z3 im
    // CHAIN2_L2
    {0, 1, {{24, 1}, {25, -1}, {27, -1}, {28, 1}}, {}},  // X3 re = t3 t1m re - t4 ty' re
    {1, 1, {{26, 1}, {24, -1}, {25, -1}, {29, -1}, {27, 1}, {28, 1}}, {}},  // X3 im
    {2, 1, {{30, 1}, {31, -1}, {33, 1}, {34, -1}}, {}},  // Y3 re = t1m z3 re + ty' t0t re
    {3, 1, {{32, 1}, {30, -1}, {31, -1}, {35, 1}, {33, -1}, {34, -1}}, {}},  // Y3 im
    {4, 1, {{36, 1}, {37, -1}, {39, 1}, {40, -1}}, {}},  // Z3 re = z3 t4 re + t0t t3 re
    {5, 1, {{38, 1}, {36, -1}, {37, -1}, {41, 1}, {39, -1}, {40, -1}}, {}},  // Z3 im
    // DBL2_L0
    {24, 1, {{12, 1}, {13, -1}}, {}},           // t0 re = a0 b0 - a1 b1
    {25, 1, {{14, 1}, {12, -1}, {13, -1}}, {}},  // t0 im = leg 2 - a0 b0 - a1 b1
    {26, 1, {{15, 1}, {16, -1}}, {}},           // txy re
    {27, 1, {{17, 1}, {15, -1}, {16, -1}}, {}},  // txy im
    {28, 1, {{18, 1}, {19, -1}}, {}},           // tyz re
    {29, 1, {{20, 1}, {18, -1}, {19, -1}}, {}},  // tyz im
    {30, 1, {{21, 1}, {22, -1}}, {}},           // zz re
    {31, 1, {{23, 1}, {21, -1}, {22, -1}}, {}},  // zz im
    // DBL2_L1
    {12, 12, {}, {{30, 1}, {31, -1}}},  // t2 re = 12 (zz re - zz im)
    {13, 12, {}, {{30, 1}, {31, 1}}},   // t2 im = 12 (zz re + zz im)
    {14, 8, {}, {{24, 1}}},             // y8 re = 8 t0 re
    {15, 8, {}, {{25, 1}}},             // y8 im
    {16, 12, {{24, 1}}, {{30, 1}, {31, -1}}},  // s re = t0 re + t2 re
    {17, 12, {{25, 1}}, {{30, 1}, {31, 1}}},   // s im
    {18, 12, {{24, 1}}, {{30, -1}, {30, -1}, {30, -1}, {31, 1}, {31, 1}, {31, 1}}},  // tdiff re = t0 re - 3 t2 re
    {19, 12, {{25, 1}}, {{30, -1}, {30, -1}, {30, -1}, {31, -1}, {31, -1}, {31, -1}}},  // tdiff im
    // DBL2_L2
    {0, 1, {{32, 1}, {32, 1}, {33, -1}, {33, -1}}, {}},  // X3 re = 2 tdiff txy re
    {1, 1, {{34, 1}, {34, 1}, {32, -1}, {32, -1}, {33, -1}, {33, -1}}, {}},  // X3 im
    {2, 1, {{35, 1}, {36, -1}, {41, 1}, {42, -1}}, {}},  // Y3 re = t2 y8 re + tdiff s re
    {3, 1, {{37, 1}, {35, -1}, {36, -1}, {43, 1}, {41, -1}, {42, -1}}, {}},  // Y3 im
    {4, 1, {{38, 1}, {39, -1}}, {}},  // Z3 re = tyz y8 re
    {5, 1, {{40, 1}, {38, -1}, {39, -1}}, {}},  // Z3 im
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
    team.phase(6, [&](int j) { run_mul(m, MUL1[ACC1_P1 + j]); });
    team.phase(6, [&](int j) { run_lin(m, LIN1[ACC1_L1 + j]); });
    team.phase(6, [&](int j) { run_mul(m, MUL1[ACC1_P2 + j]); });
    team.phase(3, [&](int j) { store_lin(m, LIN1[ACC1_L2 + j], bucket); });
  } else {
    team.phase(18, [&](int j) { run_mul(m, MUL2[ACC2_P1 + j]); });
    team.phase(12, [&](int j) { run_lin(m, LIN2[ACC2_L0 + j]); });
    team.phase(12, [&](int j) { run_lin(m, LIN2[ACC2_L1 + j]); });
    team.phase(18, [&](int j) { run_mul(m, MUL2[ACC2_P2 + j]); });
    team.phase(6, [&](int j) { store_lin(m, LIN2[ACC2_L2 + j], bucket); });
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

// --- scan-red and scan-horner: chains of group operations as team programs -------
//
// Both are chains of dependent group operations: scan-red 2 (B - 1)
// additions a window, scan-horner W (c doublings and an addition). A
// chain's latency is their time, so one team of threads walks each chain
// and runs each operation's independent Fp products as jobs in phases on
// operands in shared memory (TeamMem), as scan-acc's walk runs its
// additions; each operation's result stays in the slots the next one
// reads, and only the chain's inputs and its result cross device memory.
// A chain's team is a block: Team::phase runs the product phases (one
// product a thread, the threads in lockstep), Team::spread(jobs, ways,
// job) the sum phases and the conversions, job j on warp j % ways (on the
// card; in the host harness every job in order), so that sums whose code
// paths differ do not share a warp.
//
// The addition in a chain (CHAIN_SLOTS: 12 on G1, 42 on G2) is scan-acc's
// program, its L2 storing X3 Y3 Z3 into the slots 0 .. 3 NC - 1 of the
// first operand (ACC1_L2 reads only 6-11 there). On G2 its P2 legs move
// to slots 24-41 (CHAIN2_P2, CHAIN2_L2), so that L2 reads none of the
// operand slots 0-11 that the chain writes in L2: X3 Y3 Z3 and the next
// second operand. The doubling (DBL1_*, DBL2_*; DBL_SLOTS: 18 on G1, 44
// on G2) reads and writes slots 0 .. 3 NC - 1 and leaves the second
// operand's slots 3 NC .. 6 NC - 1 alone:
//   G1 (0 X, 1 Y, 2 Z; 6-17 its own)
//     P1 4 products  t0 = Y^2, txy = X Y, tyz = Y Z, zz = Z^2 -> 6-9
//     L1 4 sums      t2 = 12 zz, y8 = 8 t0, s = t0 + t2,
//                    tdiff = t0 - 3 t2 = t0 - 12 (3 zz) -> 10-13
//     P2 4 products  tdiff txy, t2 y8, tyz y8, tdiff s -> 14-17
//     L2 3 sums      X3 = 2 tdiff txy, Y3 = t2 y8 + tdiff s, Z3 = tyz y8 -> 0-2
//   G2 (0-5 X Y Z, re then im; 12-43 its own)
//     P1 12 Fp products, the Karatsuba legs of P1's four -> 12-23
//     L0 8 sums      the four products from their legs -> 24-31
//     L1 8 sums      t2 = 12 (1 + u) zz, y8, s, tdiff -> 12-19
//     P2 12 Fp products, the legs of P2's four -> 32-43
//     L2 6 sums      X3 Y3 Z3 -> 0-5
// the expressions of group381.cuh complete_dbl. As in scan-acc's walk,
// every value is canonical and every operation exact, so both chains equal
// the plain loops (ops/scan_msm.py) limb for limb, and no phase writes a
// slot another job of its phase reads.

template <class F>
constexpr int CHAIN_SLOTS = g381::NC<F> == 1 ? 12 : 42;
template <class F>
constexpr int DBL_SLOTS = g381::NC<F> == 1 ? 18 : 44;
// Phases of the chain's addition and of its doubling: 4 on G1, 5 on G2.
template <class F>
constexpr int CHAIN_PHASES = g381::NC<F> == 1 ? 4 : 5;

// One phase of a program: its jobs, products (MUL1 / MUL2) or sums (LIN1
// / LIN2) from offset `at` of the curve's table. Every job is read by
// direct index from its __constant__ table, and each program runs one
// product and one sum body (run_job).
struct PhaseOps {
  bool mul;
  int at, jobs;
};

// Sum k of the curve's table into r; returns its destination slot.
template <class F>
__device__ __forceinline__ int lin_at(const TeamMem& m, int k, Fp& r) {
  if constexpr (g381::NC<F> == 1) {
    lin_value(m, LIN1[k], r);
    return LIN1[k].dst;
  } else {
    lin_value(m, LIN2[k], r);
    return LIN2[k].dst;
  }
}

template <class F>
__device__ __forceinline__ void run_job(const TeamMem& m, const PhaseOps& ph, int j) {
  const int k = ph.at + j;
  if (ph.mul) {
    if constexpr (g381::NC<F> == 1) run_mul(m, MUL1[k]);
    else run_mul(m, MUL2[k]);
  } else {
    Fp r;
    const int dst = lin_at<F>(m, k, r);
    store_slot(m, dst, r);
  }
}

// Phase i of the chain's addition; its last (L2) has one job a component.
template <class F>
__device__ __forceinline__ PhaseOps add_phase(int i) {
  if constexpr (g381::NC<F> == 1) {
    if (i == 0) return {true, ACC1_P1, 6};
    if (i == 1) return {false, ACC1_L1, 6};
    if (i == 2) return {true, ACC1_P2, 6};
    return {false, ACC1_L2, 3};
  } else {
    if (i == 0) return {true, ACC2_P1, 18};
    if (i == 1) return {false, ACC2_L0, 12};
    if (i == 2) return {false, ACC2_L1, 12};
    if (i == 3) return {true, CHAIN2_P2, 18};
    return {false, CHAIN2_L2, 6};
  }
}

// Phase i of the chain's doubling.
template <class F>
__device__ __forceinline__ PhaseOps dbl_phase(int i) {
  if constexpr (g381::NC<F> == 1) {
    if (i == 0) return {true, DBL1_P1, 4};
    if (i == 1) return {false, DBL1_L1, 4};
    if (i == 2) return {true, DBL1_P2, 4};
    return {false, DBL1_L2, 3};
  } else {
    if (i == 0) return {true, DBL2_P1, 12};
    if (i == 1) return {false, DBL2_L0, 8};
    if (i == 2) return {false, DBL2_L1, 8};
    if (i == 3) return {true, DBL2_P2, 12};
    return {false, DBL2_L2, 6};
  }
}

// Component q of the identity (0 : 1 : 0) into slot q (one = R mod p in
// y's first component, slot NC).
template <class F>
__device__ __forceinline__ void identity_slot(const TeamMem& m, int q) {
  Fp x;
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = q == g381::NC<F> ? f381::R_MOD_P[k] : 0u;
  store_slot(m, q, x);
}

// A column record's component (12 words at p) and back.
__device__ __forceinline__ void load_words(const u32* p, Fp& x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) x.w[k] = p[k];
}

__device__ __forceinline__ void store_words(const Fp& x, u32* p) {
#pragma unroll
  for (int k = 0; k < NW; ++k) p[k] = x.w[k];
}

// scan-red: window w's running/total suffix sums over its buckets B - 1
// down to 1 (bucket 0 dropped), from the identity:
//   running <- complete_add(running, bucket[w, b]); total <- complete_add(total, running)
// bk (3 NC, 24, W, B) strict limbs (the buckets after the fold across
// lanes), out (3 NC, 24, W): total, the window's sum sum_b b bucket[w, b].
//
// Step k of B: addition A, running += bucket[B - 1 - k] (not in the last
// step), and addition B, total += the running sum of step k - 1 (not in
// the first), in the same phases: both read the same running sum and
// neither needs the other's result, so the 2 (B - 1) additions take B
// steps and every addition has the plain loop's operands. A's operands at
// slots mA (X1 running, X2 the bucket), B's at mB (X1 total, X2 running);
// A's L2 stores running into both. The buckets convert from limbs off the
// chain, `column` (at least 1) at a time into the team's column of word
// records (col, a phase every `column` steps), and each step's L2 copies
// the next step's bucket, record k % column, into A's X2. RED_SLOTS: mA,
// mB.
template <class F>
constexpr int RED_SLOTS = 2 * CHAIN_SLOTS<F>;

template <class F, class Team>
__device__ __forceinline__ void reduce_team(Team& team, const TeamMem& m, u32* col, int column,
                                            const int* __restrict__ bk, int* __restrict__ out,
                                            int W, int B, int w) {
  constexpr int K = 3 * g381::NC<F>;
  const long long slot = static_cast<long long>(NW) * m.st;  // words a slot
  const TeamMem mA = m, mB{m.s + CHAIN_SLOTS<F> * slot, m.st};
  const long long E = static_cast<long long>(W) * B;
  const int* win = bk + static_cast<long long>(w) * B;
  const auto read = [&](int b, int q, Fp& x) {  // bucket b's component q
    t381::limbs_to_words(win + static_cast<long long>(q) * LIMBS * E + b, E, x);
  };
  const PhaseOps l2 = add_phase<F>(CHAIN_PHASES<F> - 1);
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const bool first = k == 0, last = k == B - 1;
    const int next = B - 2 - k;  // the bucket of step k + 1 (none below 1)
    if (k % column == 0) {
      // first: the identity into running and total, bucket B - 1 into A's
      // X2; then the column's records k .. k + recs - 1, record r bucket
      // next - r (neighbouring jobs on neighbouring buckets)
      const int init = first ? (B > 1 ? 3 * K : 2 * K) : 0;
      const int recs = next > 0 ? (next < column ? next : column) : 0;
      team.spread(init + recs * K, 32, [&](int j) {
        Fp x;
        if (j < init && j < 2 * K) {
          identity_slot<F>(TeamMem{j < K ? mA.s : mB.s, m.st}, j % K);
        } else if (j < init) {
          read(B - 1, j - 2 * K, x);
          store_slot(mA, K + j - 2 * K, x);
        } else {
          const int r = (j - init) % recs, q = (j - init) / recs;
          read(next - r, q, x);
          store_words(x, col + (r * K + q) * NW);
        }
      });
    }
    const int nA = last ? 0 : 1, nB = first ? 0 : 1;  // additions in this step
#pragma unroll 1
    for (int i = 0; i < CHAIN_PHASES<F> - 1; ++i) {
      const PhaseOps ph = add_phase<F>(i);
      const int a = nA * ph.jobs, ab = a + nB * ph.jobs;
      const auto job = [&](int j) {
        run_job<F>(TeamMem{j < a ? mA.s : mB.s, m.st}, ph, j < a ? j : j - a);
      };
      if (ph.mul) team.phase(ab, job);
      else team.spread(ab, ph.jobs, job);
    }
    const int a = nA * K, ab = a + nB * K, copy = next > 0 ? K : 0;
    team.spread(ab + copy, K, [&](int j) {
      Fp x;
      if (j < ab) {
        const TeamMem mm{j < a ? mA.s : mB.s, m.st};
        const int dst = lin_at<F>(mm, l2.at + (j < a ? j : j - a), x);
        store_slot(mm, dst, x);
        if (j < a) store_slot(mB, K + dst, x);
      } else {
        const int q = j - ab;
        load_words(col + ((k % column) * K + q) * NW, x);
        store_slot(mA, K + q, x);
      }
    });
  }
  team.spread(K, K, [&](int q) {
    Fp x;
    load_slot(mB, q, x);
    t381::words_to_limbs(x, out + static_cast<long long>(q) * LIMBS * W + w, W);
  });
}

// scan-horner: the window sums (3 NC, 24, W), most significant window
// first, from the identity: acc <- c doublings of acc, then
// complete_add(acc, sum[w]); out (3 NC, 24, 1), sum_w sum[w] 2^(c w).
// One team: the W sums convert to word records in the column col (W
// records) in one phase before the walk, with the identity into acc
// (slots 0 .. 3 NC - 1) and sum[W - 1] into X2 (3 NC .. 6 NC - 1); each
// addition's L2 copies the next window's sum into X2, which the doublings
// leave alone. HORNER_SLOTS: the larger program's.
template <class F>
constexpr int HORNER_SLOTS = CHAIN_SLOTS<F> > DBL_SLOTS<F> ? CHAIN_SLOTS<F> : DBL_SLOTS<F>;

template <class F, class Team>
__device__ __forceinline__ void horner_team(Team& team, const TeamMem& m, u32* col,
                                            const int* __restrict__ sums, int* __restrict__ out,
                                            int W, int c) {
  constexpr int K = 3 * g381::NC<F>;
  const auto read = [&](int w, int q, Fp& x) {  // sum[w]'s component q
    t381::limbs_to_words(sums + static_cast<long long>(q) * LIMBS * W + w, W, x);
  };
  const int recs = W * K, init = recs + (W > 0 ? 2 * K : K);
  team.spread(init, 32, [&](int j) {
    Fp x;
    if (j < recs) {
      const int w = j % W, q = j / W;
      read(w, q, x);
      store_words(x, col + (w * K + q) * NW);
    } else if (j < recs + K) {
      identity_slot<F>(m, j - recs);
    } else {
      read(W - 1, j - recs - K, x);
      store_slot(m, j - recs, x);
    }
  });
#pragma unroll 1
  for (int w = W - 1; w >= 0; --w) {
#pragma unroll 1
    for (int d = 0; d <= c; ++d) {
#pragma unroll 1
      for (int i = 0; i < CHAIN_PHASES<F>; ++i) {
        const PhaseOps ph = d == c ? add_phase<F>(i) : dbl_phase<F>(i);
        const int copy = d == c && i == CHAIN_PHASES<F> - 1 && w > 0 ? K : 0;
        const auto job = [&](int j) {
          if (j < ph.jobs) {
            run_job<F>(m, ph, j);
          } else {
            Fp x;
            load_words(col + ((w - 1) * K + j - ph.jobs) * NW, x);
            store_slot(m, K + j - ph.jobs, x);
          }
        };
        if (ph.mul) team.phase(ph.jobs, job);
        else team.spread(ph.jobs + copy, ph.jobs, job);
      }
    }
  }
  team.spread(K, K, [&](int q) {
    Fp x;
    load_slot(m, q, x);
    t381::words_to_limbs(x, out + static_cast<long long>(q) * LIMBS, 1);
  });
}

// --- scan-mul: the double-and-add ladder, a team of threads an element -----------
//
// CurveOps.scalar_mul (curves/group.py) for element i: acc <- (0 : 1 : 0);
// for bit j = num_bits - 1 .. 0: acc <- complete_dbl(acc), then acc <-
// complete_add(acc, P) if bit j of the scalar is set, else the doubled acc;
// pts (3 NC, 24, n) strict limbs, scalars (16, n) plain Fr limbs of 16
// bits (bits above 16 ignored, as the plain loop's shifts do), out
// (3 NC, 24, n) strict limbs. Every value is canonical and both operations
// exact, and the chain addition takes acc as its first operand and P as its
// second, as the loop's `add(acc, pt)` does: the result equals the loop
// (ops/scan_msm.py scalar_mul_plain) limb for limb.
//
// One team walks an element on the chains' programs: the doubling's phases
// (dbl_phase: DBL1_* / DBL2_*) on acc in slots 0 .. K - 1, then the chain
// addition's (add_phase) of acc and P in X2 (K .. 2K - 1). P stays in the
// team's MUL_SAVE_P slots for the whole walk, and the doubling's L2 copies
// it into X2 (the addition's L1 on G1 and its L0 on G2 overwrite slots
// 0 .. 2K - 1). The doubling's L2 also stores the doubled acc at
// MUL_SAVE_D, and the addition's L2 takes X3 or that copy into acc by a
// mask of the bit: no branch or index depends on the scalar, and teams
// that share a warp stay converged. The scalar's limbs are read once, into
// the team's MUL_SCALAR slot as 8 words. K = 3 NC; MUL_SLOTS: the larger
// program's, the two saves and the scalar.
template <class F>
constexpr int MUL_SAVE_D = HORNER_SLOTS<F>;
template <class F>
constexpr int MUL_SAVE_P = MUL_SAVE_D<F> + 3 * g381::NC<F>;
template <class F>
constexpr int MUL_SCALAR = MUL_SAVE_P<F> + 3 * g381::NC<F>;
template <class F>
constexpr int MUL_SLOTS = MUL_SCALAR<F> + 1;
constexpr int SCALAR_LIMBS = 16;  // 16-bit limbs of a scalar

template <class F, class Team>
__device__ __forceinline__ void mul_team(Team& team, const TeamMem& m, const int* __restrict__ pts,
                                         const int* __restrict__ scalars, int* __restrict__ out,
                                         long long n, long long i, int num_bits) {
  constexpr int K = 3 * g381::NC<F>;
  const long long cs = static_cast<long long>(LIMBS) * n;  // a component's rows
  // the identity into acc, P's components into MUL_SAVE_P, the scalar's
  // limbs into MUL_SCALAR
  team.phase(2 * K + 1, [&](int j) {
    Fp x;
    if (j < K) {
      identity_slot<F>(m, j);
    } else if (j < 2 * K) {
      t381::limbs_to_words(pts + (j - K) * cs + i, n, x);
      store_slot(m, MUL_SAVE_P<F> + j - K, x);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x.w[k] = 0;
        if (2 * k + 1 < SCALAR_LIMBS)
          x.w[k] = (static_cast<u32>(scalars[2 * k * n + i]) & 0xFFFFu) |
                   ((static_cast<u32>(scalars[(2 * k + 1) * n + i]) & 0xFFFFu) << 16);
      }
      store_slot(m, MUL_SCALAR<F>, x);
    }
  });
  const u32* scalar = m.s + static_cast<long long>(MUL_SCALAR<F>) * NW * m.st;
#pragma unroll 1
  for (int b = num_bits - 1; b >= 0; --b) {
#pragma unroll 1
    for (int d = 0; d < 2; ++d) {  // the doubling, then the addition
#pragma unroll 1
      for (int i2 = 0; i2 < CHAIN_PHASES<F>; ++i2) {
        const PhaseOps ph = d == 0 ? dbl_phase<F>(i2) : add_phase<F>(i2);
        const bool l2 = i2 == CHAIN_PHASES<F> - 1;
        team.phase(ph.jobs + (d == 0 && l2 ? K : 0), [&](int j) {
          Fp x;
          if (j >= ph.jobs) {  // P into X2
            load_slot(m, MUL_SAVE_P<F> + j - ph.jobs, x);
            store_slot(m, K + j - ph.jobs, x);
          } else if (!l2) {
            run_job<F>(m, ph, j);
          } else {
            const int dst = lin_at<F>(m, ph.at + j, x);
            if (d == 0) {
              store_slot(m, MUL_SAVE_D<F> + dst, x);
            } else {
              Fp dbl;
              load_slot(m, MUL_SAVE_D<F> + dst, dbl);
              const u32 set = 0u - ((scalar[(b / 32) * m.st] >> (b % 32)) & 1u);
#pragma unroll
              for (int k = 0; k < NW; ++k) x.w[k] = (x.w[k] & set) | (dbl.w[k] & ~set);
            }
            store_slot(m, dst, x);
          }
        });
      }
    }
  }
  team.phase(K, [&](int q) {
    Fp x;
    load_slot(m, q, x);
    t381::words_to_limbs(x, out + q * cs + i, n);
  });
}

}  // namespace smsm
