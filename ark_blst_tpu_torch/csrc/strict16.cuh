// Device functions of the strict radix-16 Montgomery engine (K7-K10).
//
// A field element is L little-endian 16-bit limbs (L = 24 for Fp, 16 for
// Fr), stored limb-major as int32. In registers each pair of limbs is packed
// into one 32-bit word, W = L/2 words, and the arithmetic runs on words with
// 64-bit products and carries. Since R = 2^(16 L) = 2^(32 W), the word form
// computes exactly the values of ark_blst_tpu_torch/ops/fieldops.py (the
// plain versions), which mirror ark_blst_tpu/ops/fieldops.py:
//
//   mont_mul  t = a*b; m = (t mod R) * (-p^-1) mod R; u = (t + m*p) mod R^2;
//             u / R, minus p if that is >= p           (_mont_mul_list)
//   add       (a + b) mod R, minus p if >= p            (add)
//   sub       (a - b + p) mod R, minus p if >= p        (sub)
//   neg       (p - a) mod R, minus p if >= p            (neg)
//
// The carries out of the top word are dropped where the plain versions
// truncate, so the two agree bit for bit for every input of 16-bit limbs,
// canonical or not; on canonical inputs (< p) the results are canonical.
//
// All arithmetic is on unsigned words. The header also compiles as plain
// host C++ (no __CUDACC__), so the tests can run these functions on the CPU
// under -fsanitize=undefined (tests/test_torch_strict_host.py).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#elif !defined(__device__)
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#endif

namespace sf {

// p and -p^-1 mod R in 32-bit words, least significant first (held against
// the FieldSpecs of ops/limbs.py by tests/test_torch_csrc.py).
__constant__ uint32_t FP_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t FP_NINV[12] = {
    0xfffcfffdu, 0x89f3fffcu, 0xd9d113e8u, 0x286adb92u, 0xc8e30b48u, 0x16ef2ef0u,
    0x8eb2db4cu, 0x19ecca0eu, 0xe268cf58u, 0x68b316feu, 0xfeaafc94u, 0xceb06106u};
__constant__ uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
__constant__ uint32_t FR_NINV[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfdu, 0x53ba5bffu,
    0x0004ec06u, 0x181b2c17u, 0xd7bf2839u, 0x3d443ab0u};

template <int L>
struct Field;

template <>
struct Field<24> {
  static constexpr int W = 12;
  static __device__ __forceinline__ uint32_t p(int k) { return FP_P[k]; }
  static __device__ __forceinline__ uint32_t ninv(int k) { return FP_NINV[k]; }
};

template <>
struct Field<16> {
  static constexpr int W = 8;
  static __device__ __forceinline__ uint32_t p(int k) { return FR_P[k]; }
  static __device__ __forceinline__ uint32_t ninv(int k) { return FR_NINV[k]; }
};

// Limb-major int32 limbs (limb k of element i at x[k * n + i]) -> words.
template <int W>
__device__ __forceinline__ void load(const int* x, long long n, long long i, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < W; ++k)
    w[k] = static_cast<uint32_t>(x[(2 * k) * n + i]) |
           (static_cast<uint32_t>(x[(2 * k + 1) * n + i]) << 16);
}

template <int W>
__device__ __forceinline__ void store(int* out, long long n, long long i, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    out[(2 * k) * n + i] = static_cast<int>(w[k] & 0xFFFFu);
    out[(2 * k + 1) * n + i] = static_cast<int>(w[k] >> 16);
  }
}

// s -> s - p if s >= p, else s (one conditional subtraction, _cond_sub_list).
template <int L>
__device__ __forceinline__ void reduce_once(uint32_t* s) {
  constexpr int W = Field<L>::W;
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t v = static_cast<uint64_t>(s[k]) - Field<L>::p(k) - borrow;
    d[k] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);  // the difference wrapped below 0
  }
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = borrow ? s[k] : d[k];
}

template <int L>
__device__ __forceinline__ void add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < Field<L>::W; ++k) {
    const uint64_t v = static_cast<uint64_t>(a[k]) + b[k] + carry;
    r[k] = static_cast<uint32_t>(v);
    carry = static_cast<uint32_t>(v >> 32);
  }
  reduce_once<L>(r);
}

// r = (x - y) mod R; x is a word array, or p itself when x is null.
template <int L>
__device__ __forceinline__ void sub_words(const uint32_t* x, const uint32_t* y, uint32_t* r) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < Field<L>::W; ++k) {
    const uint32_t xk = x ? x[k] : Field<L>::p(k);
    const uint64_t v = static_cast<uint64_t>(xk) - y[k] - borrow;
    r[k] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
}

template <int L>
__device__ __forceinline__ void sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  sub_words<L>(a, b, r);
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < Field<L>::W; ++k) {  // + p, mod R
    const uint64_t v = static_cast<uint64_t>(r[k]) + Field<L>::p(k) + carry;
    r[k] = static_cast<uint32_t>(v);
    carry = static_cast<uint32_t>(v >> 32);
  }
  reduce_once<L>(r);
}

template <int L>
__device__ __forceinline__ void neg(const uint32_t* a, uint32_t* r) {
  sub_words<L>(nullptr, a, r);
  reduce_once<L>(r);
}

// Montgomery product by separated operand scanning: the full product, the
// low product by -p^-1, then t + m*p, whose low W words are zero.
template <int L>
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  constexpr int W = Field<L>::W;
  uint32_t t[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {  // t = a * b
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t v = static_cast<uint64_t>(a[i]) * b[j] + t[i + j] + carry;
      t[i + j] = static_cast<uint32_t>(v);
      carry = static_cast<uint32_t>(v >> 32);
    }
    t[i + W] = carry;
  }
  uint32_t m[W];
#pragma unroll
  for (int k = 0; k < W; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {  // m = (t mod R) * ninv mod R
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < W - i; ++j) {
      const uint64_t v = static_cast<uint64_t>(t[i]) * Field<L>::ninv(j) + m[i + j] + carry;
      m[i + j] = static_cast<uint32_t>(v);
      carry = static_cast<uint32_t>(v >> 32);
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {  // t += m * p, mod R^2
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t v = static_cast<uint64_t>(m[i]) * Field<L>::p(j) + t[i + j] + carry;
      t[i + j] = static_cast<uint32_t>(v);
      carry = static_cast<uint32_t>(v >> 32);
    }
#pragma unroll
    for (int k = i + W; k < 2 * W; ++k) {  // the carry out of t[2W-1] is dropped
      const uint64_t v = static_cast<uint64_t>(t[k]) + carry;
      t[k] = static_cast<uint32_t>(v);
      carry = static_cast<uint32_t>(v >> 32);
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = t[W + k];
  reduce_once<L>(r);
}

enum Op { MONT_MUL = 0, ADD = 1, SUB = 2, NEG = 3 };

// One element of op OP: limb-major operands a (and b, unless NEG), out.
template <int L, int OP>
__device__ __forceinline__ void field_elem(const int* a, const int* b, int* out, long long n,
                                           long long i) {
  constexpr int W = Field<L>::W;
  uint32_t x[W], y[W], r[W];
  load<W>(a, n, i, x);
  if constexpr (OP == NEG) {
    neg<L>(x, r);
  } else {
    load<W>(b, n, i, y);
    if constexpr (OP == MONT_MUL) mont_mul<L>(x, y, r);
    if constexpr (OP == ADD) add<L>(x, y, r);
    if constexpr (OP == SUB) sub<L>(x, y, r);
  }
  store<W>(out, n, i, r);
}

}  // namespace sf
