// Device functions of the signed lazy radix-13 Montgomery engine.
//
// One field element per thread, its 30 signed int32 digits (radix 2^13,
// Montgomery domain R13 = 2^390) in registers. Every function mirrors the
// function of the same name in ark_blst_tpu_torch/ops/lazy13.py digit for
// digit, which in turn mirrors ark_blst_tpu/ops/lazy13.py.
//
// Integer discipline: all digit and column values stay inside int32 by the
// engine's bound ledger (columns of a mul-ready x mul-ready product are
// <= 30*4129^2 = 5.1e8, of a canonical x canonical one <= 2.01e9), so no
// signed operation below overflows. Folds rely on two's-complement `&` and
// arithmetic `>>` of signed int32, which CUDA guarantees for `int`.
//
// The header also compiles as plain host C++ (no __CUDACC__): the CUDA
// qualifiers then vanish, so the tests can run the same device functions on
// the CPU (tests/test_torch_tower_host.py).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LZ_NOINLINE static __device__ __noinline__
#else
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define LZ_NOINLINE static __attribute__((noinline))
#endif

namespace lz {

constexpr int ELEM = 30;    // digits per element
constexpr int RADIX = 13;
constexpr int DMASK = 8191;
constexpr int HALF = 4096;
constexpr int COLS = 59;    // columns of a 30 x 30 product
constexpr int WIDE = 64;    // scratch digits for a product on its way to reduction
constexpr int BIAS = 4129;  // packed-word digit bias

// p and -p^-1 mod R13 in canonical radix-13 digits (held against the Python
// engine's P_DIGITS / NINV_DIGITS by tests/test_torch_csrc.py).
__constant__ int P_DIGITS[ELEM] = {
    2731, 8189, 8191, 7679, 7071, 8191, 1359, 8150, 3071, 245,
    7561, 3425, 2575, 6249, 7580, 599,  4997, 7207, 7634, 3784,
    6861, 421,  7897, 884,  6731, 7988, 3679, 980,  17,   13};
__constant__ int NINV_DIGITS[ELEM] = {
    8189, 8167, 7999, 2047, 2207, 2548, 1860, 4699, 2779, 323,
    722,  4550, 3852, 6039, 4187, 7017, 3762, 4212, 6962, 4147,
    3317, 4404, 7163, 5730, 5224, 6116, 8106, 525,  2822, 4199};

// One balanced carry-release pass in place: t[0..N) -> t[0..N], N+1 digits.
template <int N>
__device__ __forceinline__ void fold(int* t) {
  int carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int u = t[k] + HALF;
    const int lo = (u & DMASK) - HALF;
    t[k] = lo + carry;
    carry = u >> RADIX;
  }
  t[N] = carry;
}

// Schoolbook product columns c[0..59) = a * b (the true convolution).
__device__ __forceinline__ void mul_cols(const int* a, const int* b, int* c) {
#pragma unroll
  for (int k = 0; k < COLS; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < ELEM; ++i) {
#pragma unroll
    for (int j = 0; j < ELEM; ++j) c[i + j] += a[i] * b[j];
  }
}

// prered: product columns folded twice, w[0..61) of a WIDE scratch.
__device__ __forceinline__ void mul_prered(const int* a, const int* b, int* w) {
  mul_cols(a, b, w);
  fold<COLS>(w);
  fold<COLS + 1>(w);
}

// reduce_wide: t holds a linear combination of prered wides in t[0..61);
// t is used as scratch (WIDE digits). out = (t / R13) mod p, mul-ready.
__device__ __forceinline__ void reduce_wide(int* t, int* out) {
  fold<COLS + 2>(t);  // 62 digits
  int m[ELEM + 2];
#pragma unroll
  for (int k = 0; k < ELEM; ++k) {
    int acc = 0;
#pragma unroll
    for (int i = 0; i <= k; ++i) acc += t[i] * NINV_DIGITS[k - i];
    m[k] = acc;
  }
  fold<ELEM>(m);
  fold<ELEM + 1>(m);  // only m[0..30) is kept: m matters mod R13
#pragma unroll
  for (int i = 0; i < ELEM; ++i) {
#pragma unroll
    for (int j = 0; j < ELEM; ++j) t[i + j] += m[i] * P_DIGITS[j];
  }
  fold<COLS + 3>(t);  // 63 digits
  fold<COLS + 4>(t);  // 64 digits; the low 30 are exactly zero-valued
#pragma unroll
  for (int k = 0; k < ELEM; ++k) out[k] = t[ELEM + k];
}

// mont_mul: a * b / R13 mod p for mul-ready (or canonical) operands.
__device__ __forceinline__ void mont_mul(const int* a, const int* b, int* out) {
  int w[WIDE];
  mul_prered(a, b, w);
  reduce_wide(w, out);
}

// Packed words: two balanced digits per int32, biased into [0, 8257].
__device__ __forceinline__ void pack30(const int* d, int* dst, long long stride) {
#pragma unroll
  for (int r = 0; r < ELEM / 2; ++r)
    dst[r * stride] = (d[2 * r] + BIAS) | ((d[2 * r + 1] + BIAS) << 16);
}

}  // namespace lz

#ifdef __CUDACC__
extern "C" const char* ark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
