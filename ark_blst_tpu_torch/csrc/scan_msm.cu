// scan-acc, scan-red, scan-horner: the strict engine's scan Pippenger MSM
// (curves/msm.py:msm) on Hopper (sm_90a), each of its three scans as
// hand-written launches (scan-acc three: its points to words, its walk,
// its split).
//
// Replace, on the TPU, the lax.scans of ark_blst_tpu/curves/msm.py:138
// _scan over ark_blst_tpu/ops/pallas_field.py:66 _block_call (K7-K10),
// which run inside one compiled program there:
//   scan-acc     :155 _bucket_accumulate, one complete RCB15 addition a
//                step over the whole (lanes x windows) front;
//   scan-red     :199 _bucket_reduce (its scan at :223), the running and
//                total sums over the buckets, highest first;
//   scan-horner  :227 _horner (its fori_loop at :241), c doublings and one
//                addition a window, most significant first.
// Inputs and outputs are the strict engine's (24, ...) limb stacks,
// canonical, equal to the plain loops (ops/scan_msm.py) limb for limb.
//
// What bounds them: operations. A complete addition is 12 Montgomery
// products of 12 x 32-bit words (~0.9K instructions each) and ~20 modular
// sums on G1, 36 products on G2. scan-acc makes one addition per point and
// window (2^20 x 32 on G1 at c = 8: ~12.6 ms at the card's instruction
// rate) against a bucket read and written per addition (~9.7 GB as words on
// G1, ~3 ms at the memory rate). scan-red's window walks 2 (B - 1) and
// scan-horner's W (c + 1) dependent group operations: the latency of one
// chain, milliseconds at any width.
//
// scan-acc's design (scan_msm.cuh). A thread a stream, with each bucket
// word in a limb row of the output (one 32-byte sector an access, rows
// 33.5 MB apart), a point's conversion from limbs at every step and the
// addition out of line at 255 registers, ran 24.5x (G1) and 49x (G2) its
// bound, with ~2 warps a scheduler and G2's 8,192 streams in 0.24 of a
// wave. Now:
//   - the points convert to word records once (scan_msm_point_words);
//   - the buckets are word records in a scratch, a bucket's 144 / 288
//     bytes together and a stream's buckets together, moved as 16-byte
//     vectors: 5 / 9 sectors an access;
//   - a team of threads walks each stream, the addition's independent
//     products spread over it as jobs in phases on operands in shared
//     memory (6 Fp products a phase on G1, 18 on G2), inline, no stack;
//     the team's steps stay in stream order (each ends with its bucket's
//     store and a barrier);
//   - the split to limbs is a pass of its own (scan_msm_split), records
//     in as vectors, limb rows out coalesced through shared memory.
// The team and block sizes are launch arguments (ops/scan_msm.py ACC_SHAPE,
// timed by scripts/scan_acc_probe.py on the card). On an H100 80GB HBM3 at
// 700 W the walk takes the same time with every digit 0 (each stream on
// one cached bucket) as with the MSM's digits, so bucket traffic does not
// bound it (~3.8x its operations bound on G1, ~6.5x on G2). Taking the job
// interpreter (the job tables, shared-memory slots and barriers) out does
// not help either: one thread a stream with the addition written straight
// through (scripts/scan_acc_straight.cu) runs slower than the interpreted
// team of one, 62.8 against 48.9 ms on G1 (200 registers against 71), and
// 164.9 against 103.8 on G2 (255 registers, 968 B of stack). What the
// interpreted walk's time splits into (the products' issue rate, their
// latency, the interpreter's loads and barriers) is not measured.
#include "scan_msm.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxAccBlock = 288;  // threads a block of the walk, at most

// A team's share of a phase: jobs rank, rank + size, ...; then the block's
// barrier (every team of the block runs the same phases: each stream has
// n / lanes steps).
struct BlockTeam {
  int rank, size;
  bool active;
  template <class Job>
  __device__ __forceinline__ void phase(int jobs, Job job) const {
    if (active)
      for (int j = rank; j < jobs; j += size) job(j);
    __syncthreads();
  }
};

template <class F>
__global__ void __launch_bounds__(128) words_kernel(const int* __restrict__ pts,
                                                    int* __restrict__ pw, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) smsm::point_to_words<F>(pts, pw, n, i);
}

// Teams of `team` threads, blockDim.x / team streams a block (stream s =
// w lanes + l: neighbouring teams on neighbouring lanes, so the point and
// digit loads coalesce), their operands interleaved in shared memory at a
// stride of (teams a block) | 1.
template <class F>
__global__ void __launch_bounds__(kMaxAccBlock) walk_kernel(const int* __restrict__ pw,
                                                            const int* __restrict__ digs,
                                                            int* bk, long long n, int lanes,
                                                            int W, int B, int team) {
  extern __shared__ f381::u32 smem[];
  const int tpb = blockDim.x / team, g = threadIdx.x / team;
  const long long s = static_cast<long long>(blockIdx.x) * tpb + g;
  const bool active = s < static_cast<long long>(lanes) * W;
  const BlockTeam tm{static_cast<int>(threadIdx.x % team), team, active};
  const smsm::TeamMem m{smem + g, tpb | 1};
  // the identity into the block's streams' buckets, all the block's
  // threads on one stream's records at a time (its B records lie together)
  for (int k = 0; k < tpb; ++k) {
    const long long sk = static_cast<long long>(blockIdx.x) * tpb + k;
    if (sk >= static_cast<long long>(lanes) * W) break;
    int* base = smsm::stream_buckets<F>(bk, W, B, static_cast<int>(sk % lanes),
                                        static_cast<int>(sk / lanes));
    for (int j = threadIdx.x; j < B * smsm::PV<F>; j += blockDim.x) smsm::init_job<F>(base, j);
  }
  __syncthreads();
  smsm::walk_stream<F>(tm, m, pw, digs, bk, n, lanes, W, B,
                       active ? static_cast<int>(s % lanes) : 0,
                       active ? static_cast<int>(s / lanes) : 0);
}

template <class F>
__global__ void __launch_bounds__(smsm::SPLIT_ELEMS) split_kernel(const int* __restrict__ bk,
                                                                  int* __restrict__ out,
                                                                  long long E) {
  __shared__ f381::u32 sm[smsm::PW<F> * (smsm::SPLIT_ELEMS + 1)];
  const long long e0 = static_cast<long long>(blockIdx.x) * smsm::SPLIT_ELEMS;
  const int count = static_cast<int>(E - e0 < smsm::SPLIT_ELEMS ? E - e0 : smsm::SPLIT_ELEMS);
  for (int j = threadIdx.x; j < count * smsm::PV<F>; j += blockDim.x)
    smsm::split_load<F>(bk, sm, e0, j);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < count) smsm::split_store<F>(sm, out, E, e0, threadIdx.x);
}

template <class F>
int walk_smem(int team, int block) {
  return smsm::ACC_SLOTS<F> * f381::NW * ((block / team) | 1) * 4;
}

template <class F>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const int* __restrict__ bk,
                                                          int* __restrict__ out, int W, int B) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < W) smsm::reduce_window<F>(bk, out, W, B, w);
}

template <class F>
__global__ void __launch_bounds__(32) horner_kernel(const int* __restrict__ sums,
                                                    int* __restrict__ out, int W, int c) {
  if (blockIdx.x == 0 && threadIdx.x == 0) smsm::horner_walk<F>(sums, out, W, c);
}

int blocks(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

}  // namespace

// pts (3 nc, 24, n) strict limbs of the points (nc = 1 on G1, 2 on G2)
// -> pw (n, 36 nc) canonical words, point-major. Returns
// cudaGetLastError() after the launch (0 on success), as every entry.
extern "C" int scan_msm_point_words(const int* pts, int* pw, long long n, int nc,
                                    void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>((n + 127) / 128);
  if (nc == 1)
    words_kernel<f381::Fp><<<grid, 128, 0, s>>>(pts, pw, n);
  else
    words_kernel<f381::Fp2><<<grid, 128, 0, s>>>(pts, pw, n);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
cudaError_t launch_walk(const int* pw, const int* digs, int* bk, long long n, int lanes, int W,
                        int B, int team, int block, cudaStream_t s) {
  const int smem = walk_smem<F>(team, block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long streams = static_cast<long long>(lanes) * W, tpb = block / team;
  const int grid = static_cast<int>((streams + tpb - 1) / tpb);
  walk_kernel<F><<<grid, block, smem, s>>>(pw, digs, bk, n, lanes, W, B, team);
  return cudaGetLastError();
}

// pw (n, 36 nc) point words, digs (W, n) window digits (taken mod B, a
// power of two), bk (lanes W B, 36 nc): every (lane, window) stream's
// buckets as word records, bucket b of (l, w) at record (l W + w) B + b,
// walked by a team of `team` threads, `block` threads a block (a multiple
// of team, at most kMaxAccBlock). n must be a multiple of lanes.
extern "C" int scan_msm_accumulate(const int* pw, const int* digs, int* bk, long long n,
                                   int lanes, int W, int B, int nc, int team, int block,
                                   void* stream) {
  if ((nc != 1 && nc != 2) || team < 1 || block < team || block % team != 0 ||
      block > kMaxAccBlock || B < 1 || (B & (B - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0 || W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nc == 1 ? launch_walk<f381::Fp>(pw, digs, bk, n, lanes, W, B, team, block, s)
              : launch_walk<f381::Fp2>(pw, digs, bk, n, lanes, W, B, team, block, s);
  return static_cast<int>(err);
}

// bk (E, 36 nc) word records -> out (3 nc, 24, E) strict limbs.
extern "C" int scan_msm_split(const int* bk, int* out, long long E, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>((E + smsm::SPLIT_ELEMS - 1) / smsm::SPLIT_ELEMS);
  if (nc == 1)
    split_kernel<f381::Fp><<<grid, smsm::SPLIT_ELEMS, 0, s>>>(bk, out, E);
  else
    split_kernel<f381::Fp2><<<grid, smsm::SPLIT_ELEMS, 0, s>>>(bk, out, E);
  return static_cast<int>(cudaGetLastError());
}

// bk (3 nc, 24, W, B) strict limbs -> out (3 nc, 24, W), the window sums.
extern "C" int scan_msm_reduce(const int* bk, int* out, int W, int B, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 1)
    reduce_kernel<f381::Fp><<<blocks(W), kThreads, 0, s>>>(bk, out, W, B);
  else
    reduce_kernel<f381::Fp2><<<blocks(W), kThreads, 0, s>>>(bk, out, W, B);
  return static_cast<int>(cudaGetLastError());
}

// sums (3 nc, 24, W) strict limbs -> out (3 nc, 24, 1), Horner at window c.
extern "C" int scan_msm_horner(const int* sums, int* out, int W, int c, int nc, void* stream) {
  if (nc != 1 && nc != 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 1)
    horner_kernel<f381::Fp><<<1, 32, 0, s>>>(sums, out, W, c);
  else
    horner_kernel<f381::Fp2><<<1, 32, 0, s>>>(sums, out, W, c);
  return static_cast<int>(cudaGetLastError());
}

// A launch's shape: kind 0 scan-acc's walk (at `team` and `block`), 1
// scan-red, 2 scan-horner, 3 scan-acc's point words, 4 its split, on G1
// (nc = 1) or G2 (nc = 2): its threads a block and the blocks an SM holds
// at its registers, stack and shared memory (the occupancy API). Returns
// the CUDA error of the query (0 on success).
extern "C" int scan_msm_shape(int kind, int nc, int team, int block, int* threads,
                              int* blocks_per_sm) {
  if ((nc != 1 && nc != 2) || kind < 0 || kind > 4 ||
      (kind == 0 && (team < 1 || block < team || block % team != 0 || block > kMaxAccBlock)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool g1 = nc == 1;
  cudaError_t err = cudaSuccess;
  if (kind == 0) {
    *threads = block;
    const int smem = g1 ? walk_smem<f381::Fp>(team, block) : walk_smem<f381::Fp2>(team, block);
    if (smem > 48 * 1024)
      err = g1 ? cudaFuncSetAttribute(walk_kernel<f381::Fp>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
               : cudaFuncSetAttribute(walk_kernel<f381::Fp2>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = g1 ? occupancy(walk_kernel<f381::Fp>, block, smem, blocks_per_sm)
               : occupancy(walk_kernel<f381::Fp2>, block, smem, blocks_per_sm);
  } else if (kind == 1) {
    *threads = kThreads;
    err = g1 ? occupancy(reduce_kernel<f381::Fp>, kThreads, 0, blocks_per_sm)
             : occupancy(reduce_kernel<f381::Fp2>, kThreads, 0, blocks_per_sm);
  } else if (kind == 2) {
    *threads = 32;
    err = g1 ? occupancy(horner_kernel<f381::Fp>, 32, 0, blocks_per_sm)
             : occupancy(horner_kernel<f381::Fp2>, 32, 0, blocks_per_sm);
  } else if (kind == 3) {
    *threads = 128;
    err = g1 ? occupancy(words_kernel<f381::Fp>, 128, 0, blocks_per_sm)
             : occupancy(words_kernel<f381::Fp2>, 128, 0, blocks_per_sm);
  } else {
    *threads = smsm::SPLIT_ELEMS;
    err = g1 ? occupancy(split_kernel<f381::Fp>, smsm::SPLIT_ELEMS, 0, blocks_per_sm)
             : occupancy(split_kernel<f381::Fp2>, smsm::SPLIT_ELEMS, 0, blocks_per_sm);
  }
  return static_cast<int>(err);
}
