// K1-inv and K1-scan: the lazy engine's inversion chains on Hopper
// (sm_90a), each chain in one launch; K7-inv: the strict engine's
// inversion, the same body on strict limbs.
//
// Replace, on the TPU, the lax.scans of ark_blst_tpu/ops/pallas_lazy.py:41
// mont_mul_stacked (K1) that run inside one compiled program:
//   K1-inv   the Fermat ladder x^(p-2): ops/tower_lazy.py:264 fp_inv
//            (fuse=True) and curves/msm_pallas2.py:394 _fermat_inv;
//   K1-scan  the up and down scans of one level of the blocked batch
//            inversion, curves/msm_pallas2.py:434 _batch_inverse.
//   K7-inv   the Fermat ladder a^(p-2) of the strict engine,
//            ops/dispatch.py:143 fp_inv: the lax.scan of :139 fp_pow over
//            ops/pallas_field.py:66 _block_call (K7), reached from
//            ops/tower.py fp2_inv and the strict group's to_affine.
// The port had turned every step of each scan into a K1 launch (608 for a
// ladder, 3 g for a level of g rows) or a K7 launch (610 for the strict
// ladder: 381 squares and 229 products); here a chain is one launch.
// K1's input and output are the lazy engine's (30, n) int32 digit stacks;
// the outputs equal the plain versions (ops/fp_inv.py) by canonical value,
// their digits canonical and within 4096. K7-inv's are the strict (24, n)
// limbs, canonical, equal to its plain version limb for limb.
//
// What bounds them: operations. The ladder made 608 dependent 12-word
// CIOS products per element (~912 instructions each) against 240 bytes
// of traffic; K1-inv and K7-inv now invert by a constant-time binary GCD
// (fp_inv.cuh `inverse`: 780 steps on 64-bit approximations, 26 updates
// of 12-word values, one product; ~56K instructions, where the shortest
// window chain for p - 2 needs ~420K), the same canonical result. K1-scan
// makes 3 products and 3 digit conversions per element against ~2 x 120
// bytes. At the widths the paths give the inversion (n <= 8192: the
// pairing's batch, the MSM's root at 1,024 or 256, 1 for a multi-pairing
// or a to_affine root) the card holds at most a block an SM, one warp a
// scheduler: a thread's instructions issue one after another, so its
// instruction count and dependent chain are the time, not the card's rate.
//
// Design (fp_inv.cuh): one thread an element (K1-inv, K7-inv) or a column
// (K1-scan) in 128-thread blocks, no shared memory; the chain's values
// stay in registers as 12 words, converted from digits once at the start
// and back once at the end (the scan: each element's digits once a pass).
// The scan reads the stack in place as g rows x m columns, neighbouring
// threads on neighbouring columns, so every load and store is coalesced;
// the up pass's prefix products stay in words in a scratch buffer for the
// down pass.
#include "fp_inv.cuh"

namespace {

constexpr int kThreads = 128;

// The inversion on the edge format FMT: digits (K1-inv) or strict limbs
// (K7-inv).
template <int FMT>
__global__ void __launch_bounds__(kThreads) fp_inv_kernel(const int* __restrict__ x,
                                                          int* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) finv::inv_elem<FMT>(x + i, out + i, n);
}

__global__ void __launch_bounds__(kThreads) scan_up_kernel(const int* __restrict__ z,
                                                           f381::u32* __restrict__ pre,
                                                           int* __restrict__ total, int g,
                                                           long long m) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < m) finv::scan_up_col(z, pre, total, g, m, j);
}

__global__ void __launch_bounds__(kThreads) scan_down_kernel(const int* __restrict__ z,
                                                             const f381::u32* __restrict__ pre,
                                                             const int* __restrict__ inv_total,
                                                             int* __restrict__ inv, int g,
                                                             long long m) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < m) finv::scan_down_col(z, pre, inv_total, inv, g, m, j);
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename Kernel>
int shape_of(Kernel kernel, int* threads, int* blocks_per_sm) {
  *threads = kThreads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0));
}

template <int FMT>
int launch_inv(const int* x, int* out, long long n, void* stream) {
  if (n <= 0) return 0;
  fp_inv_kernel<FMT><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out,
                                                                                      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (30, n) int32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lz_fp_inv(const int* x, int* out, long long n, void* stream) {
  return launch_inv<t381::DIGIT_ROWS>(x, out, n, stream);
}

// K7-inv. x, out: (24, n) int32 strict limbs, contiguous, on the device of
// `stream`. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sf_fp_inv(const int* x, int* out, long long n, void* stream) {
  return launch_inv<t381::LIMB_ROWS>(x, out, n, stream);
}

// z: (30, g m) int32; pre: (12, g m) int32 scratch; total: (30, m) int32.
extern "C" int lz_scan_up(const int* z, int* pre, int* total, int g, long long m, void* stream) {
  if (m <= 0 || g <= 0) return 0;
  scan_up_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, reinterpret_cast<f381::u32*>(pre), total, g, m);
  return static_cast<int>(cudaGetLastError());
}

// z, inv: (30, g m) int32; pre: (12, g m) from lz_scan_up; inv_total: (30, m).
extern "C" int lz_scan_down(const int* z, const int* pre, const int* inv_total, int* inv, int g,
                            long long m, void* stream) {
  if (m <= 0 || g <= 0) return 0;
  scan_down_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, reinterpret_cast<const f381::u32*>(pre), inv_total, inv, g, m);
  return static_cast<int>(cudaGetLastError());
}

// Each kernel's block size and the blocks an SM holds (the occupancy API at
// the compiled registers). Return the CUDA error of the query (0 on success).
extern "C" int lz_fp_inv_shape(int* threads, int* blocks_per_sm) {
  return shape_of(fp_inv_kernel<t381::DIGIT_ROWS>, threads, blocks_per_sm);
}

extern "C" int sf_fp_inv_shape(int* threads, int* blocks_per_sm) {
  return shape_of(fp_inv_kernel<t381::LIMB_ROWS>, threads, blocks_per_sm);
}

extern "C" int lz_scan_up_shape(int* threads, int* blocks_per_sm) {
  return shape_of(scan_up_kernel, threads, blocks_per_sm);
}

extern "C" int lz_scan_down_shape(int* threads, int* blocks_per_sm) {
  return shape_of(scan_down_kernel, threads, blocks_per_sm);
}
