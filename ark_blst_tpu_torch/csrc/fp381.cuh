// Device functions of the 32-bit Montgomery field layer: Fp of BLS12-381 in
// 12 little-endian uint32_t words, Montgomery form with R = 2^384 (the R16
// domain of the strict engine, ops/fieldops.py), every value kept in
// [0, p); Fp2 = Fp[u]/(u^2 + 1) on top.
//
// The product is CIOS Montgomery multiplication with 32 x 32 -> 64-bit
// partial products (`unsigned long long`), which compile to IMAD.WIDE.U32 on
// the card and to plain C++ on the host. p's top word is below 2^31 - 1, so
// each outer step's running sum fits 12 words once its two top carries are
// added (the "no-carry" form of CIOS, no 13th word); one conditional
// subtraction then brings the result into [0, p).
//
// No operation has undefined behaviour: all arithmetic is on unsigned
// types. The header also compiles as plain host C++ (no __CUDACC__), as
// lazy13.cuh does, so tests/test_torch_fp381_host.py runs it on the CPU.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#endif

namespace f381 {

constexpr int NW = 12;  // 32-bit words per element

using u32 = uint32_t;
using u64 = unsigned long long;

// p, R mod p and 2^390 mod p (the R13 domain's factor over R),
// little-endian words, and -p^-1 mod 2^32 (all constants are pinned against
// Python ints by tests/test_torch_fp381_host.py).
__constant__ u32 P[NW] = {0xffffaaab, 0xb9feffff, 0xb153ffff, 0x1eabfffe,
                          0xf6b0f624, 0x6730d2a0, 0xf38512bf, 0x64774b84,
                          0x434bacd7, 0x4b1ba7b6, 0x397fe69a, 0x1a0111ea};
__constant__ u32 R_MOD_P[NW] = {0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b,
                                0x53c758ba, 0x5f489857, 0x70525745, 0x77ce5853,
                                0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
__constant__ u32 R390_MOD_P[NW] = {0x00d1ff2e, 0x46760000, 0x9b4800ac, 0x84b80337,
                                   0xe882431c, 0x0dd9a7e0, 0xb683dcf8, 0xc26c26d0,
                                   0x63c4a5ee, 0x29f14576, 0x7f3e804b, 0x015de996};
// The packed radix-13 rows' constants (K2-G2's point conversion): 2^378
// mod p, the Montgomery factor from the R13 domain (x 2^390) to R16
// (x 2^384); and 318 p - 4129 (2^390 - 1) / (2^13 - 1), in [0, p), which
// added to the sum of the biased digits gives a nonnegative number of the
// same residue.
__constant__ u32 R378_MOD_P[NW] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0x04000000};
__constant__ u32 DIGIT_BIAS_FIX[NW] = {0x7991d049, 0x08a9ef3f, 0x3a4f9f66, 0x1577dcdf,
                                       0x57c10058, 0x264560f0, 0x4f2bc8b6, 0xbb6f4922,
                                       0x37bdb176, 0x2ad9485f, 0xac5a6f79, 0x0a5228e2};
constexpr u32 NINV = 0xfffcfffd;

struct Fp {
  u32 w[NW];
};

struct Fp2 {
  Fp c0, c1;  // c0 + c1 u
};

// r = t - p if t >= p, else t (t < 2p, so one subtraction suffices).
__device__ __forceinline__ void reduce_once(const u32* t, u32* r) {
  u32 d[NW];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const u64 s = static_cast<u64>(t[j]) - P[j] - borrow;
    d[j] = static_cast<u32>(s);
    borrow = (s >> 32) & 1;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = borrow ? t[j] : d[j];
}

// a * b / R mod p for a, b in [0, p): CIOS with 64-bit partial products.
__device__ __forceinline__ void mont_mul(const Fp& a, const Fp& b, Fp& r) {
  u32 t[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const u64 bi = b.w[i];
    u64 s = a.w[0] * bi + t[0];
    u64 hi_a = s >> 32;  // carry of the a * b_i row
    t[0] = static_cast<u32>(s);
    const u64 m = static_cast<u32>(t[0] * NINV);
    s = m * P[0] + t[0];
    u64 hi_m = s >> 32;  // carry of the m * p row
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = a.w[j] * bi + t[j] + hi_a;
      hi_a = s >> 32;
      s = m * P[j] + static_cast<u32>(s) + hi_m;
      hi_m = s >> 32;
      t[j - 1] = static_cast<u32>(s);
    }
    t[NW - 1] = static_cast<u32>(hi_a + hi_m);
  }
  reduce_once(t, r.w);
}

// The coordinate field's product under one name for both curves' group code.
__device__ __forceinline__ void mul(const Fp& a, const Fp& b, Fp& r) { mont_mul(a, b, r); }

__device__ __forceinline__ void add(const Fp& a, const Fp& b, Fp& r) {
  u32 t[NW];
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const u64 s = static_cast<u64>(a.w[j]) + b.w[j] + carry;
    t[j] = static_cast<u32>(s);
    carry = s >> 32;
  }
  reduce_once(t, r.w);  // a + b < 2p < 2^382: no carry out of the top word
}

__device__ __forceinline__ void sub(const Fp& a, const Fp& b, Fp& r) {
  u32 t[NW];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const u64 s = static_cast<u64>(a.w[j]) - b.w[j] - borrow;
    t[j] = static_cast<u32>(s);
    borrow = (s >> 32) & 1;
  }
  const u32 mask = 0u - static_cast<u32>(borrow);  // add p back on a borrow
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const u64 s = static_cast<u64>(t[j]) + (P[j] & mask) + carry;
    r.w[j] = static_cast<u32>(s);
    carry = s >> 32;
  }
}

// p - a, and 0 for a = 0.
__device__ __forceinline__ void neg(const Fp& a, Fp& r) {
  u32 nz = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) nz |= a.w[j];
  const u32 mask = nz ? ~0u : 0u;
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const u64 s = static_cast<u64>(P[j]) - a.w[j] - borrow;
    r.w[j] = static_cast<u32>(s) & mask;
    borrow = (s >> 32) & 1;
  }
}

// k * a for a small constant k >= 1, by doubling and adding over k's bits.
template <u32 K>
__device__ __forceinline__ void mul_small(const Fp& a, Fp& r) {
  static_assert(K >= 1, "mul_small takes k >= 1");
  if constexpr (K == 1) {
    r = a;
  } else {
    Fp h;
    mul_small<K / 2>(a, h);
    add(h, h, r);
    if constexpr (K % 2 == 1) add(r, a, r);
  }
}

// b3 * a with b3 = 12, G1's 3b (b = 4).
__device__ __forceinline__ void mul_b3(const Fp& a, Fp& r) { mul_small<12>(a, r); }

// --- Fp2 = Fp[u]/(u^2 + 1) -----------------------------------------------------

__device__ __forceinline__ void add(const Fp2& a, const Fp2& b, Fp2& r) {
  add(a.c0, b.c0, r.c0);
  add(a.c1, b.c1, r.c1);
}

__device__ __forceinline__ void sub(const Fp2& a, const Fp2& b, Fp2& r) {
  sub(a.c0, b.c0, r.c0);
  sub(a.c1, b.c1, r.c1);
}

__device__ __forceinline__ void neg(const Fp2& a, Fp2& r) {
  neg(a.c0, r.c0);
  neg(a.c1, r.c1);
}

template <u32 K>
__device__ __forceinline__ void mul_small(const Fp2& a, Fp2& r) {
  mul_small<K>(a.c0, r.c0);
  mul_small<K>(a.c1, r.c1);
}

// Karatsuba: m0 = a0 b0, m1 = a1 b1, m2 = (a0 + a1)(b0 + b1);
// r = (m0 - m1) + (m2 - m0 - m1) u. r may alias a or b.
__device__ __forceinline__ void mul(const Fp2& a, const Fp2& b, Fp2& r) {
  Fp sa, sb, m0, m1, m2;
  add(a.c0, a.c1, sa);
  add(b.c0, b.c1, sb);
  mont_mul(a.c0, b.c0, m0);
  mont_mul(a.c1, b.c1, m1);
  mont_mul(sa, sb, m2);
  sub(m0, m1, r.c0);
  sub(m2, m0, m2);
  sub(m2, m1, r.c1);
}

// b3 * a with b3 = 12 (1 + u), G2's 3b: 12 (a0 - a1) + 12 (a0 + a1) u.
__device__ __forceinline__ void mul_b3(const Fp2& a, Fp2& r) {
  Fp d, s;
  sub(a.c0, a.c1, d);
  add(a.c0, a.c1, s);
  mul_small<12>(d, r.c0);
  mul_small<12>(s, r.c1);
}

}  // namespace f381
