// K2-G2 probes: the G2 bucket kernel's per-thread body (ark_blst_tpu_torch/
// csrc/group381.cuh) at other launch shapes, and cut-down versions of it
// that bound where its time goes. scripts/k2g2_probe.py builds this file
// once per probe, with
//   -DPROBE_THREADS=T -DPROBE_MIN_BLOCKS=M   the launch bounds, and
//   -DPROBE_VARIANT=
//     0  the kernel's own body, g381::accumulate_stream: its dump equals
//        the kernel's bit for bit;
//     1  no global bucket traffic: each thread's additions go into one
//        bucket in shared memory (nvcc crashed with a segmentation fault
//        on the same loop with the bucket in registers);
//     2  no scatter: every nonzero digit adds into bucket 1, so the bucket
//        loads and stores of a warp stay coalesced;
//     3  the products alone: the addition replaced by 11 Fp2 products
//        (33 Fp products, three chains), bucket traffic and scatter kept.
// Every probe initializes the buckets and converts them to the dump's
// digits as the kernel does. Variants 1-3 compute no MSM: their dumps are
// not results.
#include "group381.cuh"

namespace {

using f381::Fp2;
using f381::NW;

__device__ __forceinline__ void probe_stream(const int* __restrict__ words,
                                             const int* __restrict__ digs,
                                             int* __restrict__ dump, long long n, int B, int S,
                                             int w, int s) {
#if PROBE_VARIANT == 0
  g381::accumulate_stream(words, digs, dump, n, B, S, w, s);
#else
  using g381::load;
  using g381::store;
  int* base = dump + static_cast<long long>(w) * B * g381::PT_ROWS * S + s;
  const long long bstride = static_cast<long long>(g381::PT_ROWS) * S;
  g381::init_buckets(base, B, S);
  const long long T = n / S;
  const int* dig_row = digs + static_cast<long long>(w) * n;
#if PROBE_VARIANT == 1
  __shared__ int shared_bucket[g381::PT_WORDS * PROBE_THREADS];
  int* sb = shared_bucket + threadIdx.x;
  for (int r = 0; r < g381::PT_WORDS; ++r) sb[r * PROBE_THREADS] = base[bstride + r * S];
#endif
#pragma unroll 1
  for (long long t = 0; t < T; ++t) {
    const long long p = t * S + s;
    const int dig = dig_row[p];
    const int mag = dig & 0x7FFF;
    if (mag == 0) continue;
    Fp2 X2, Y2;
    load(words + p, n, X2);
    load(words + 2 * NW * n + p, n, Y2);
    if ((dig >> 15) & 1) f381::neg(Y2, Y2);
#if PROBE_VARIANT == 1
    int* bk = sb;
    const long long bs = PROBE_THREADS;
#else
    int* bk = base + (PROBE_VARIANT == 2 ? 1 : mag) * bstride;
    const long long bs = S;
#endif
    Fp2 X, Y, Z;
    load(bk, bs, X);
    load(bk + 2 * NW * bs, bs, Y);
    load(bk + 4 * NW * bs, bs, Z);
#if PROBE_VARIANT != 3
    g381::mixed_add(X, Y, Z, X2, Y2);
#else
#pragma unroll
    for (int k = 0; k < 4; ++k) f381::mul(X, X2, X);
#pragma unroll
    for (int k = 0; k < 4; ++k) f381::mul(Y, Y2, Y);
#pragma unroll
    for (int k = 0; k < 3; ++k) f381::mul(Z, X2, Z);
#endif
    store(X, bk, bs);
    store(Y, bk + 2 * NW * bs, bs);
    store(Z, bk + 4 * NW * bs, bs);
  }
#if PROBE_VARIANT == 1
  for (int r = 0; r < g381::PT_WORDS; ++r) base[bstride + r * S] = sb[r * PROBE_THREADS];
#endif
  g381::buckets_to_dump(base, B, S);
#endif
}

__global__ void __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS) probe_kernel(
    const int* __restrict__ words, const int* __restrict__ digs, int* __restrict__ dump,
    long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  probe_stream(words, digs, dump, n, B, S, static_cast<int>(idx / S),
               static_cast<int>(idx % S));
}

}  // namespace

// As msm_bucket_accumulate_g2 (csrc/bucket_accumulate_g2.cu).
extern "C" int probe_launch(const int* words, const int* digs, int* dump, long long n, int W,
                            int B, int S, void* stream) {
  const long long blocks = (static_cast<long long>(W) * S + PROBE_THREADS - 1) / PROBE_THREADS;
  probe_kernel<<<static_cast<unsigned>(blocks), PROBE_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(words, digs, dump, n, W, B, S);
  return static_cast<int>(cudaGetLastError());
}

// The blocks an SM holds at the probe's registers and stack.
extern "C" int probe_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, probe_kernel, PROBE_THREADS, 0));
}
