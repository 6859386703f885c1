// Bucket kernel probes: the per-thread body of K2 (G1) or K2-G2
// (ark_blst_tpu_torch/csrc/group381.cuh) at other launch shapes, and
// cut-down versions of it that bound where its time goes.
// scripts/k2_probe.py builds this file once per probe, with
//   -DPROBE_G2=0|1                           the curve: G1 (Fp) or G2 (Fp2),
//   -DPROBE_THREADS=T -DPROBE_MIN_BLOCKS=M   the launch bounds, and
//   -DPROBE_VARIANT=
//     0  the kernel's own body, g381::accumulate_stream: its dump equals
//        the kernel's bit for bit;
//     1  no global bucket traffic: each thread's additions go into one
//        bucket in shared memory (nvcc crashed with a segmentation fault
//        on the same loop with the bucket in registers);
//     2  no scatter: every nonzero digit adds into bucket 1, so the bucket
//        loads and stores of a warp stay coalesced;
//     3  the products alone: the addition replaced by its 11 products in
//        the coordinate field (three chains), bucket traffic and scatter
//        kept;
//     4  contiguous buckets: the kernel's computation with each thread's
//        buckets in a scratch buffer set by probe_set_scratch, bucket b of
//        thread t = w S + s at words [(t B + b) PT_WORDS, + PT_WORDS), read
//        and written in 16-byte vectors (a bucket touches ~5 sectors of 32
//        bytes instead of one per word), then converted into the dump's
//        column at the end: its dump equals the kernel's bit for bit.
// Every probe initializes the buckets and converts them to the dump's
// digits as the kernel does. Variants 1-3 compute no MSM: their dumps are
// not results.
#include "group381.cuh"

namespace {

#if PROBE_G2
using F = f381::Fp2;
#else
using F = f381::Fp;
#endif
constexpr int CW = g381::NC<F> * f381::NW;  // rows of one coordinate

int* g_scratch = nullptr;  // variant 4's buckets

__device__ __forceinline__ f381::Fp& comp(f381::Fp& x, int) { return x; }
__device__ __forceinline__ f381::Fp& comp(f381::Fp2& x, int k) { return k ? x.c1 : x.c0; }

// A coordinate from / to CW contiguous words, 16-byte aligned.
__device__ __forceinline__ void load_vec(const int* src, F& x) {
#pragma unroll
  for (int k = 0; k < g381::NC<F>; ++k)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int4 v = reinterpret_cast<const int4*>(src + k * f381::NW)[q];
      uint32_t* w = comp(x, k).w + 4 * q;
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
}

__device__ __forceinline__ void store_vec(F& x, int* dst) {
#pragma unroll
  for (int k = 0; k < g381::NC<F>; ++k)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint32_t* w = comp(x, k).w + 4 * q;
      reinterpret_cast<int4*>(dst + k * f381::NW)[q] = make_int4(
          static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
          static_cast<int>(w[3]));
    }
}

// Variant 4: the kernel's body with the buckets contiguous in scratch.
__device__ __forceinline__ void contiguous_stream(const int* __restrict__ words,
                                                  const int* __restrict__ digs,
                                                  int* __restrict__ scratch,
                                                  int* __restrict__ dump, long long n, int B,
                                                  int S, int w, int s) {
  constexpr int PW = g381::PT_WORDS<F>;
  int* mine = scratch + (static_cast<long long>(w) * S + s) * B * PW;
  for (int i = 0; i < B * PW; ++i) mine[i] = 0;
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int j = 0; j < f381::NW; ++j)
      mine[b * PW + CW + j] = static_cast<int>(f381::R_MOD_P[j]);
  const long long T = n / S;
  const int* dig_row = digs + static_cast<long long>(w) * n;
#pragma unroll 1
  for (long long t = 0; t < T; ++t) {
    const long long p = t * S + s;
    const int dig = dig_row[p];
    const int mag = dig & 0x7FFF;
    if (mag == 0) continue;
    F X2, Y2;
    g381::load(words + p, n, X2);
    g381::load(words + CW * n + p, n, Y2);
    if ((dig >> 15) & 1) f381::neg(Y2, Y2);
    int* bk = mine + mag * PW;
    F X, Y, Z;
    load_vec(bk, X);
    load_vec(bk + CW, Y);
    load_vec(bk + 2 * CW, Z);
    g381::mixed_add(X, Y, Z, X2, Y2);
    store_vec(X, bk);
    store_vec(Y, bk + CW);
    store_vec(Z, bk + 2 * CW);
  }
  int* col = dump + static_cast<long long>(w) * B * g381::PT_ROWS<F> * S + s;
  for (int b = 0; b < B; ++b)
#pragma unroll 1
    for (int k = 0; k < 3 * g381::NC<F>; ++k) {
      f381::Fp x;
      g381::load(mine + b * PW + k * f381::NW, 1, x);
      g381::store_r13(x, col + (static_cast<long long>(b) * g381::PT_ROWS<F> +
                                k * g381::FP_ROWS) * S, S);
    }
}

__device__ __forceinline__ void probe_stream(const int* __restrict__ words,
                                             const int* __restrict__ digs,
                                             int* __restrict__ scratch,
                                             int* __restrict__ dump, long long n, int B, int S,
                                             int w, int s) {
#if PROBE_VARIANT == 0
  g381::accumulate_stream<F>(words, digs, dump, n, B, S, w, s);
#elif PROBE_VARIANT == 4
  contiguous_stream(words, digs, scratch, dump, n, B, S, w, s);
#else
  using g381::load;
  using g381::store;
  int* base = dump + static_cast<long long>(w) * B * g381::PT_ROWS<F> * S + s;
  const long long bstride = static_cast<long long>(g381::PT_ROWS<F>) * S;
  g381::init_buckets<F>(base, B, S);
  const long long T = n / S;
  const int* dig_row = digs + static_cast<long long>(w) * n;
#if PROBE_VARIANT == 1
  __shared__ int shared_bucket[g381::PT_WORDS<F> * PROBE_THREADS];
  int* sb = shared_bucket + threadIdx.x;
  for (int r = 0; r < g381::PT_WORDS<F>; ++r) sb[r * PROBE_THREADS] = base[bstride + r * S];
#endif
#pragma unroll 1
  for (long long t = 0; t < T; ++t) {
    const long long p = t * S + s;
    const int dig = dig_row[p];
    const int mag = dig & 0x7FFF;
    if (mag == 0) continue;
    F X2, Y2;
    load(words + p, n, X2);
    load(words + CW * n + p, n, Y2);
    if ((dig >> 15) & 1) f381::neg(Y2, Y2);
#if PROBE_VARIANT == 1
    int* bk = sb;
    const long long bs = PROBE_THREADS;
#else
    int* bk = base + (PROBE_VARIANT == 2 ? 1 : mag) * bstride;
    const long long bs = S;
#endif
    F X, Y, Z;
    load(bk, bs, X);
    load(bk + CW * bs, bs, Y);
    load(bk + 2 * CW * bs, bs, Z);
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
    store(Y, bk + CW * bs, bs);
    store(Z, bk + 2 * CW * bs, bs);
  }
#if PROBE_VARIANT == 1
  for (int r = 0; r < g381::PT_WORDS<F>; ++r) base[bstride + r * S] = sb[r * PROBE_THREADS];
#endif
  g381::buckets_to_dump<F>(base, B, S);
#endif
}

__global__ void __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS) probe_kernel(
    const int* __restrict__ words, const int* __restrict__ digs, int* __restrict__ scratch,
    int* __restrict__ dump, long long n, int W, int B, int S) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(W) * S) return;
  probe_stream(words, digs, scratch, dump, n, B, S, static_cast<int>(idx / S),
               static_cast<int>(idx % S));
}

}  // namespace

// As msm_bucket_accumulate (csrc/bucket_accumulate.cu) or
// msm_bucket_accumulate_g2 (csrc/bucket_accumulate_g2.cu).
extern "C" int probe_launch(const int* words, const int* digs, int* dump, long long n, int W,
                            int B, int S, void* stream) {
  const long long blocks = (static_cast<long long>(W) * S + PROBE_THREADS - 1) / PROBE_THREADS;
  probe_kernel<<<static_cast<unsigned>(blocks), PROBE_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(words, digs, g_scratch, dump, n, W, B,
                                                      S);
  return static_cast<int>(cudaGetLastError());
}

// Variant 4's scratch: W S B PT_WORDS ints of the card's memory.
extern "C" void probe_set_scratch(int* scratch) { g_scratch = scratch; }

// The blocks an SM holds at the probe's registers and stack.
extern "C" int probe_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, probe_kernel, PROBE_THREADS, 0));
}
