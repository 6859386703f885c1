// Device bodies of the scan MSM's chains (scan_msm.cu), generic over the
// coordinate field F (Fp for G1, Fp2 for G2), on the complete RCB15
// addition and doubling of group381.cuh: the accumulation of one (lane,
// window) stream into its buckets (scan-acc), the running/total walk of one
// window's buckets (scan-red) and the Horner walk over the window sums
// (scan-horner).
//
// Layouts: a point batch is a stack of its 3 NC Fp components (x, y, z;
// re before im on G2), each 24 strict 16-bit limbs (R = 2^384, the strict
// engine's, ops/convert.py), component q's limb j of element i at
// [(24 q + j) n + i] for n elements. Strict limbs are the words' own number
// (t381::read_row / write_row with LIMB_ROWS: a repack, the load reduced
// below p), so every chain computes on canonical words and stores
// canonical limbs: its outputs equal the plain loops' (ops/scan_msm.py)
// limb for limb.
//
// Compiles as host C++ too (group381.cuh, tower381.cuh):
// tests/test_torch_scan_msm_host.py runs each body on the CPU under
// -fsanitize=undefined.
#pragma once

#include "group381.cuh"
#include "tower381.cuh"

namespace smsm {

using f381::Fp;
using f381::Fp2;
using f381::NW;

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

// scan-acc, one stream: lane l of `lanes`, window w of W, over n points
// (n a multiple of lanes; point i belongs to lane i mod lanes, so step t
// of the stream takes point t lanes + l):
//   bucket[l, w, b] <- (0 : 1 : 0) for b < B
//   for each step t: d = digits[w, t lanes + l] (taken mod B; digit 0 adds
//     into bucket 0, as the plain loop does),
//     bucket[l, w, d] <- complete_add(bucket[l, w, d], point)
// pts (3 NC, 24, n) strict limbs, digs (W, n) unsigned window digits,
// out (3 NC, 24, lanes, W, B): the buckets as strict limbs, the plain
// loop's leaves stacked. The buckets live in out while the stream runs, as
// canonical words in the first 12 limb rows of each component (the
// thread's own elements, bucket b of (l, w) at element (l W + w) B + b),
// and each is split into its 24 limbs in place at the end (a component's
// 12 words are in registers before any of its limbs is written).
template <class F>
__device__ __forceinline__ void accumulate_stream(const int* __restrict__ pts,
                                                  const int* __restrict__ digs,
                                                  int* __restrict__ out, long long n, int lanes,
                                                  int W, int B, int l, int w) {
  const long long E = static_cast<long long>(lanes) * W * B;  // elements of an out row
  const long long cs = LIMBS * E;                              // component stride in out
  int* base = out + (static_cast<long long>(l) * W + w) * B;
  F X, Y, Z;
  set_identity(X, Y, Z);
  for (int b = 0; b < B; ++b) {
    store_words(X, base + b, E, cs);
    store_words(Y, base + b + g381::NC<F> * cs, E, cs);
    store_words(Z, base + b + 2 * g381::NC<F> * cs, E, cs);
  }
  const long long steps = n / lanes;
  const int* dig_row = digs + static_cast<long long>(w) * n;
  for (long long t = 0; t < steps; ++t) {
    const long long p = t * lanes + l;
    const int d = dig_row[p] & (B - 1);
    F X2, Y2, Z2;
    read_point(pts + p, n, LIMBS * n, X2, Y2, Z2);
    int* bk = base + d;
    load_words(bk, E, cs, X);
    load_words(bk + g381::NC<F> * cs, E, cs, Y);
    load_words(bk + 2 * g381::NC<F> * cs, E, cs, Z);
    add(X, Y, Z, X2, Y2, Z2);
    store_words(X, bk, E, cs);
    store_words(Y, bk + g381::NC<F> * cs, E, cs);
    store_words(Z, bk + 2 * g381::NC<F> * cs, E, cs);
  }
  for (int b = 0; b < B; ++b) {
#pragma unroll 1
    for (int q = 0; q < 3 * g381::NC<F>; ++q) {
      Fp x;
      g381::load(base + b + q * cs, E, x);
      t381::write_row(x, base + b + q * cs, E, t381::LIMB_ROWS);
    }
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
