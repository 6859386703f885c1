// scan-acc, scan-red, scan-horner: the strict engine's scan Pippenger MSM
// (curves/msm.py:msm) on Hopper (sm_90a), each of its three scans as
// hand-written launches (scan-acc three: its points to words, its walk,
// its split); scan-mul: the strict group's double-and-add ladder
// (curves/group.py CurveOps.scalar_mul, msm_naive's) as one launch.
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
//   scan-mul     ark_blst_tpu/curves/group.py:257 scalar_mul (its
//                lax.scan at :276), a doubling, an addition and a select
//                a bit, per element.
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
//
// scan-red's and scan-horner's design (scan_msm.cuh reduce_team,
// horner_team). W = 32 windows at c = 8 are too few chains to fill the
// card, so a chain's latency is their time: one thread a chain, the group
// law out of line at 255 registers with stack, each bucket converted from
// limbs inside the chain, ran 46 us (G1) and 161 us (G2) a dependent
// addition. Now one block a chain runs the additions' and doublings' Fp
// products and sums as jobs in phases on operands in shared memory (the
// job tables of scan-acc's walk, and a doubling's): the products one a
// thread on its first threads, in lockstep, the sums, whose code paths
// differ from job to job, one or two a warp (a warp running several would
// take them in turn); scan-red's running and total additions of
// neighbouring steps in the same phases (B steps for 2 (B - 1) additions),
// the buckets converted off the chain (a column of word records in shared
// memory, refilled every `column` steps); scan-horner's window sums
// converted into shared memory before its walk. What is left is the chain
// of products: on an H100 80GB HBM3 at 700 W a step of scan-red runs ~2x
// its two products' latency. The shapes are launch arguments
// (ops/scan_msm.py RED_SHAPE, HORNER_SHAPE, timed by
// scripts/scan_red_probe.py beside one product's latency on the card).
//
// scan-mul's design (scan_msm.cuh mul_team). Each element's ladder is a
// chain of 2 num_bits dependent group operations (512 at 256 bits), and the
// elements are independent: a team of threads an element walks it on the
// chains' doubling and addition programs, as scan-horner walks its one
// chain, the bit taken by a mask in the addition's last phase. Many teams
// a block, interleaved: thread t is rank t / E of team t % E (E teams a
// block), so a warp runs one job of 32 teams, the same code path on every
// lane (sum jobs, whose paths differ, never share a warp), and each team's
// operand words lie E | 1 apart in shared memory, a warp's accesses on
// neighbouring banks. At msm_naive's 2^12 elements the teams fill about a
// wave (a block an SM): the ladder's latency is its time, as scan-horner's
// chain's is. The team and block are launch arguments (ops/scan_msm.py
// MUL_SHAPE; chip_smoke.py times others through this entry).
#include "scan_msm.cuh"

namespace {

constexpr int kMaxAccBlock = 288;    // threads a block of the walk, at most
constexpr int kMaxChainBlock = 256;  // of scan-red and scan-horner
constexpr int kMaxMulBlock = 576;    // of scan-mul: 32 teams of 18
constexpr long long kMaxSmem = 232448;  // shared bytes a block can have

// A team's share of a phase: jobs rank, rank + size, ...; then the block's
// barrier (every team of a block runs the same phases: each of scan-acc's
// streams has n / lanes steps).
struct BlockTeam {
  int rank, size;
  bool active;
  template <class Job>
  __device__ __forceinline__ void phase(int jobs, Job job) const {
    if (active && rank < size)
      for (int j = rank; j < jobs; j += size) job(j);
    __syncthreads();
  }
  // A block that is one team (scan-red, scan-horner): job j on lane
  // j / ways of warp j % ways (ways at most the block's whole warps), so
  // that a sum phase's jobs, whose code paths differ, run in warps of their
  // own (job i and job i + ways, scan-red's two additions' job i, share a
  // warp and a path); a block of less than a warp is one such warp. Then
  // the barrier.
  template <class Job>
  __device__ __forceinline__ void spread(int jobs, int ways, Job job) const {
    const int warps = blockDim.x / 32, w = threadIdx.x / 32;
    const int lanes = warps > 0 ? 32 : static_cast<int>(blockDim.x);
    if (ways > (warps > 0 ? warps : 1)) ways = warps > 0 ? warps : 1;
    if (active && w < ways)
      for (int j = w + ways * static_cast<int>(threadIdx.x % 32); j < jobs; j += lanes * ways)
        job(j);
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

// scan-red: a block a window, its products on threads 0 .. team - 1, its
// sums spread over its warps; its slots, then its column of `column` word
// records, in shared memory.
template <class F>
__global__ void __launch_bounds__(kMaxChainBlock) reduce_kernel(const int* __restrict__ bk,
                                                                int* __restrict__ out, int W,
                                                                int B, int team, int column) {
  extern __shared__ f381::u32 smem[];
  const BlockTeam tm{static_cast<int>(threadIdx.x), team, true};
  const smsm::TeamMem m{smem, 1};
  smsm::reduce_team<F>(tm, m, smem + smsm::RED_SLOTS<F> * f381::NW, column, bk, out, W, B,
                       blockIdx.x);
}

// scan-horner: one block, as a window of scan-red's; the column of W
// records after the slots.
template <class F>
__global__ void __launch_bounds__(kMaxChainBlock) horner_kernel(const int* __restrict__ sums,
                                                                int* __restrict__ out, int W,
                                                                int c, int team) {
  extern __shared__ f381::u32 smem[];
  const BlockTeam tm{static_cast<int>(threadIdx.x), team, true};
  const smsm::TeamMem m{smem, 1};
  smsm::horner_team<F>(tm, m, smem + smsm::HORNER_SLOTS<F> * f381::NW, sums, out, W, c);
}

// scan-mul: blockDim.x / team elements a block, thread t rank t / E of
// team t % E (E = blockDim.x / team), the teams' slots interleaved E | 1
// apart.
template <class F>
__global__ void __launch_bounds__(kMaxMulBlock) mul_kernel(const int* __restrict__ pts,
                                                           const int* __restrict__ scalars,
                                                           int* __restrict__ out, long long n,
                                                           int num_bits, int team) {
  extern __shared__ f381::u32 smem[];
  const int tpb = blockDim.x / team, g = threadIdx.x % tpb;
  const long long i = static_cast<long long>(blockIdx.x) * tpb + g;
  const BlockTeam tm{static_cast<int>(threadIdx.x / tpb), team, i < n};
  const smsm::TeamMem m{smem + g, tpb | 1};
  smsm::mul_team<F>(tm, m, pts, scalars, out, n, i < n ? i : 0, num_bits);
}

template <class F>
long long mul_smem(int team, int block) {
  return 4LL * smsm::MUL_SLOTS<F> * f381::NW * ((block / team) | 1);
}

// Shared bytes of a scan-red block (a column of `column` records) and of
// scan-horner's (W records).
template <class F>
long long red_smem(int column) {
  return 4LL * (smsm::RED_SLOTS<F> * f381::NW + static_cast<long long>(column) * smsm::PW<F>);
}

template <class F>
long long horner_smem(int W) {
  return 4LL * (smsm::HORNER_SLOTS<F> * f381::NW + static_cast<long long>(W) * smsm::PW<F>);
}

// Allows `kernel` `smem` bytes of dynamic shared memory (above the 48 KB
// default), or refuses what a block cannot have.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, long long smem, int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                       static_cast<size_t>(smem));
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
  const cudaError_t err = allow_smem(walk_kernel<F>, smem);
  if (err != cudaSuccess) return err;
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

template <class F>
cudaError_t launch_reduce(const int* bk, int* out, int W, int B, int team, int block, int column,
                          cudaStream_t s) {
  const long long smem = red_smem<F>(column);
  const cudaError_t err = allow_smem(reduce_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  reduce_kernel<F><<<W, block, smem, s>>>(bk, out, W, B, team, column);
  return cudaGetLastError();
}

// bk (3 nc, 24, W, B) strict limbs -> out (3 nc, 24, W), the window sums:
// a block of `block` threads a window (at most kMaxChainBlock), its
// products one a thread on `team` of them, its sums spread over its
// warps, converting `column` buckets at a time into its column in shared
// memory.
extern "C" int scan_msm_reduce(const int* bk, int* out, int W, int B, int nc, int team,
                               int block, int column, void* stream) {
  if ((nc != 1 && nc != 2) || team < 1 || block < team || block > kMaxChainBlock ||
      column < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nc == 1 ? launch_reduce<f381::Fp>(bk, out, W, B, team, block, column, s)
              : launch_reduce<f381::Fp2>(bk, out, W, B, team, block, column, s);
  return static_cast<int>(err);
}

template <class F>
cudaError_t launch_horner(const int* sums, int* out, int W, int c, int team, int block,
                          cudaStream_t s) {
  const long long smem = horner_smem<F>(W);
  const cudaError_t err = allow_smem(horner_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  horner_kernel<F><<<1, block, smem, s>>>(sums, out, W, c, team);
  return cudaGetLastError();
}

// sums (3 nc, 24, W) strict limbs -> out (3 nc, 24, 1), Horner at window c,
// walked by one block of `block` threads (at most kMaxChainBlock), its
// products one a thread on `team` of them, its sums spread over its warps.
extern "C" int scan_msm_horner(const int* sums, int* out, int W, int c, int nc, int team,
                               int block, void* stream) {
  if ((nc != 1 && nc != 2) || team < 1 || block < team || block > kMaxChainBlock || W < 0 ||
      c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = nc == 1 ? launch_horner<f381::Fp>(sums, out, W, c, team, block, s)
                                  : launch_horner<f381::Fp2>(sums, out, W, c, team, block, s);
  return static_cast<int>(err);
}

template <class F>
cudaError_t launch_mul(const int* pts, const int* scalars, int* out, long long n, int num_bits,
                       int team, int block, cudaStream_t s) {
  const long long smem = mul_smem<F>(team, block);
  const cudaError_t err = allow_smem(mul_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  const long long tpb = block / team;
  const int grid = static_cast<int>((n + tpb - 1) / tpb);
  mul_kernel<F><<<grid, block, smem, s>>>(pts, scalars, out, n, num_bits, team);
  return cudaGetLastError();
}

// pts (3 nc, 24, n) strict limbs, scalars (16, n) plain Fr limbs -> out
// (3 nc, 24, n), each point times the low num_bits (<= 256) bits of its
// scalar by the double-and-add ladder: block / team elements a block of
// `block` threads (a multiple of team, at most kMaxMulBlock), each walked
// by `team` threads.
extern "C" int scan_msm_scalar_mul(const int* pts, const int* scalars, int* out, long long n,
                                   int num_bits, int nc, int team, int block, void* stream) {
  if ((nc != 1 && nc != 2) || team < 1 || block < team || block % team != 0 ||
      block > kMaxMulBlock || num_bits < 0 || num_bits > 16 * smsm::SCALAR_LIMBS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nc == 1 ? launch_mul<f381::Fp>(pts, scalars, out, n, num_bits, team, block, s)
              : launch_mul<f381::Fp2>(pts, scalars, out, n, num_bits, team, block, s);
  return static_cast<int>(err);
}

// A launch's shape: kind 0 scan-acc's walk (at `team` and `block`), 1
// scan-red (at `block` and a column of `records` buckets), 2 scan-horner
// (at `block`, `records` = W window sums), 3
// scan-acc's point words, 4 its split, 5 scan-mul (at `team` and `block`),
// on G1 (nc = 1) or G2 (nc = 2): its
// threads a block and the blocks an SM holds at its registers, stack and
// shared memory (the occupancy API). Returns the CUDA error of the query
// (0 on success).
extern "C" int scan_msm_shape(int kind, int nc, int team, int block, int records, int* threads,
                              int* blocks_per_sm) {
  const bool teams = kind <= 2 || kind == 5;
  const int max_block = kind == 0 ? kMaxAccBlock : kind == 5 ? kMaxMulBlock : kMaxChainBlock;
  const bool bad = teams && (team < 1 || block < team || block > max_block ||
                             ((kind == 0 || kind == 5) && block % team != 0));
  if ((nc != 1 && nc != 2) || kind < 0 || kind > 5 || bad || records < 0 ||
      (kind == 1 && records < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool g1 = nc == 1;
  cudaError_t err = cudaSuccess;
  if (kind == 0) {
    *threads = block;
    const int smem = g1 ? walk_smem<f381::Fp>(team, block) : walk_smem<f381::Fp2>(team, block);
    err = g1 ? allow_smem(walk_kernel<f381::Fp>, smem) : allow_smem(walk_kernel<f381::Fp2>, smem);
    if (err == cudaSuccess)
      err = g1 ? occupancy(walk_kernel<f381::Fp>, block, smem, blocks_per_sm)
               : occupancy(walk_kernel<f381::Fp2>, block, smem, blocks_per_sm);
  } else if (kind == 1) {
    *threads = block;
    const long long smem = g1 ? red_smem<f381::Fp>(records) : red_smem<f381::Fp2>(records);
    err = g1 ? allow_smem(reduce_kernel<f381::Fp>, smem)
             : allow_smem(reduce_kernel<f381::Fp2>, smem);
    if (err == cudaSuccess)
      err = g1 ? occupancy(reduce_kernel<f381::Fp>, block, smem, blocks_per_sm)
               : occupancy(reduce_kernel<f381::Fp2>, block, smem, blocks_per_sm);
  } else if (kind == 2) {
    *threads = block;
    const long long smem = g1 ? horner_smem<f381::Fp>(records) : horner_smem<f381::Fp2>(records);
    err = g1 ? allow_smem(horner_kernel<f381::Fp>, smem)
             : allow_smem(horner_kernel<f381::Fp2>, smem);
    if (err == cudaSuccess)
      err = g1 ? occupancy(horner_kernel<f381::Fp>, block, smem, blocks_per_sm)
               : occupancy(horner_kernel<f381::Fp2>, block, smem, blocks_per_sm);
  } else if (kind == 5) {
    *threads = block;
    const long long smem = g1 ? mul_smem<f381::Fp>(team, block) : mul_smem<f381::Fp2>(team, block);
    err = g1 ? allow_smem(mul_kernel<f381::Fp>, smem) : allow_smem(mul_kernel<f381::Fp2>, smem);
    if (err == cudaSuccess)
      err = g1 ? occupancy(mul_kernel<f381::Fp>, block, smem, blocks_per_sm)
               : occupancy(mul_kernel<f381::Fp2>, block, smem, blocks_per_sm);
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
