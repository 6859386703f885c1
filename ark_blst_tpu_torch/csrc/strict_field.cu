// K7-K10: the strict engine's field ops on Hopper (sm_90a).
//
// Replace the TPU kernel ark_blst_tpu/ops/pallas_field.py:_block_call with
// its four bodies: K7 sf_mont_mul (_mul_body, the Montgomery product), K8
// sf_add, K9 sf_sub and K10 sf_neg (_add_body, _sub_body, _neg_body), each
// over (L, n) int32 limb-major operands of 16-bit limbs, L = 24 (Fp) or 16
// (Fr). Bit-equal to ark_blst_tpu_torch/ops/fieldops.py (csrc/strict16.cuh
// says why).
//
// What bounds them: bytes. Each element moves 4 L bytes per operand (an
// int32 per 16-bit limb). K7 issues ~1.3K int32 instructions per Fp element
// against 288 bytes, ~4.5 per byte, below the card's ~10 instructions per
// HBM byte; K8-K10 issue a few dozen. The TPU kernels ran the same
// per-limb dataflow on (L, 16, 128) VMEM blocks.
//
// Design: one thread per element, its limbs packed two to a 32-bit word in
// registers, the word loops fully unrolled (IMAD.WIDE.U32 products, carries
// in 64-bit sums), the constants of p and -p^-1 in the constant bank. Loads
// and stores are coalesced: neighbouring threads read neighbouring elements
// of each limb row. No shared memory: nothing is reused across elements.
#include "strict16.cuh"

namespace {

template <int L, int OP>
__global__ void __launch_bounds__(128) field_kernel(const int* __restrict__ a,
                                                     const int* __restrict__ b,
                                                     int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sf::field_elem<L, OP>(a, b, out, n, i);
}

template <int OP>
int launch(const int* a, const int* b, int* out, long long n, int limbs, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limbs == 24) {
    field_kernel<24, OP><<<blocks, threads, 0, s>>>(a, b, out, n);
  } else if (limbs == 16) {
    field_kernel<16, OP><<<blocks, threads, 0, s>>>(a, b, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: (limbs, n) int32, contiguous, on the device of `stream`;
// limbs is 24 or 16. Each returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sf_mont_mul(const int* a, const int* b, int* out, long long n, int limbs,
                           void* stream) {
  return launch<sf::MONT_MUL>(a, b, out, n, limbs, stream);
}

extern "C" int sf_add(const int* a, const int* b, int* out, long long n, int limbs, void* stream) {
  return launch<sf::ADD>(a, b, out, n, limbs, stream);
}

extern "C" int sf_sub(const int* a, const int* b, int* out, long long n, int limbs, void* stream) {
  return launch<sf::SUB>(a, b, out, n, limbs, stream);
}

extern "C" int sf_neg(const int* a, int* out, long long n, int limbs, void* stream) {
  return launch<sf::NEG>(a, nullptr, out, n, limbs, stream);
}

extern "C" const char* ark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
