// The inversion body of K7-inv and K1-inv (ark_blst_tpu_torch/csrc/fp_inv.cuh
// `inverse`, the constant-time binary GCD) beside the Fermat ladder it
// replaced (`fermat`), and the latencies of the GCD's parts on one thread:
// a batch of its steps, a batch's update, the whole inversion, and one
// dependent 32-bit operation. Not part of the package: scripts/fp_inv_probe.py
// (and chip_smoke.py's phase k7_inv) build it with the package's nvcc flags
// and time each with CUDA events.
#include "fp_inv.cuh"

namespace {

using f381::Fp;
using f381::u32;
using f381::u64;

// BODY 0 the binary GCD, 1 the Fermat ladder, on (24, n) strict limbs (the
// load reduced below p), a thread an element in 128-thread blocks, as
// fp_inv.cu's K7-inv.
template <int BODY>
__global__ void __launch_bounds__(128) inv_kernel(const int* __restrict__ x,
                                                  int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp v, r;
  t381::read_row(x + i, n, t381::LIMB_ROWS, v);
  if (BODY == 0) finv::inverse(v, r);
  else finv::fermat(v, r);
  t381::write_row(r, out + i, n, t381::LIMB_ROWS);
}

__device__ __forceinline__ void load_fp(const unsigned* s, Fp& x) {
#pragma unroll
  for (int k = 0; k < f381::NW; ++k) x.w[k] = s[k];
}

__device__ __forceinline__ void store_fp(const Fp& x, unsigned* s) {
#pragma unroll
  for (int k = 0; k < f381::NW; ++k) s[k] = x.w[k];
}

// One thread, n links of a dependent chain:
//   mode 2: a batch of GCD_STEPS steps (gcd_steps), the next batch's
//           approximations a few operations of this one's factors;
//   mode 3: a batch's update (gcd_update: gcd_lin twice, gcd_mod twice)
//           of a, b, u, v with the seed's factors;
//   mode 4: the whole inversion (`inverse`), x <- its result;
//   mode 5: two dependent 32-bit operations, x <- (x ^ y) + z.
// seed: a, b, u, v as canonical words (48 words), then the factors (4).
__global__ void chain_kernel(int mode, long long n, const unsigned* seed, unsigned* out) {
  Fp a, b, u, v;
  load_fp(seed, a);
  load_fp(seed + 12, b);
  load_fp(seed + 24, u);
  load_fp(seed + 36, v);
  if (mode == 2) {
    u64 ab = (static_cast<u64>(a.w[1]) << 32) | a.w[0], bb = (static_cast<u64>(b.w[1]) << 32) | b.w[0];
#pragma unroll 1
    for (long long i = 0; i < n; ++i) {
      const finv::GcdFactors m = finv::gcd_steps(ab, bb);
      ab ^= (static_cast<u64>(m.f0) << 32) | m.g0;
      bb ^= (static_cast<u64>(m.f1) << 32) | m.g1;
    }
    out[0] = static_cast<u32>(ab);
    out[1] = static_cast<u32>(bb);
  } else if (mode == 3) {
    const finv::GcdFactors m{seed[48], seed[49], seed[50], seed[51]};
#pragma unroll 1
    for (long long i = 0; i < n; ++i) finv::gcd_update(m, a, b, u, v);
    store_fp(u, out);
    store_fp(v, out + 12);
  } else if (mode == 4) {
#pragma unroll 1
    for (long long i = 0; i < n; ++i) finv::inverse(a, a);
    store_fp(a, out);
  } else {
    u32 x = a.w[0];
    const u32 y = b.w[0], z = u.w[0];
#pragma unroll 1
    for (long long i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < 16; ++k) x = (x ^ y) + z;  // 32 dependent operations
    }
    out[0] = x;
  }
}

}  // namespace

// mode 0 / 1: the GCD body / the Fermat body on x (24, n) -> out (24, n);
// modes 2-5: the one-thread chains above, n links (mode 5: n x 32
// operations), seed 52 words, out 24 words. Returns cudaGetLastError()
// after the launch.
extern "C" int fp_inv_probe(int mode, long long n, const int* x, int* out, const unsigned* seed,
                            unsigned* sout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + 127) / 128);
  if (mode == 0)
    inv_kernel<0><<<grid, 128, 0, s>>>(x, out, n);
  else if (mode == 1)
    inv_kernel<1><<<grid, 128, 0, s>>>(x, out, n);
  else if (mode >= 2 && mode <= 5)
    chain_kernel<<<1, 1, 0, s>>>(mode, n, seed, sout);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
