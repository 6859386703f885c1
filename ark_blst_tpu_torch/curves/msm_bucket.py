"""G1 and G2 MSM on the card: lazy radix-13 prepare, K2 bucket kernel,
reduce, finish.

Counterpart of `ark_blst_tpu/curves/msm_pallas2.py`. One pipeline serves both
curves through a `KernelCurve2` (`KC2_G1`, `KC2_G2`, the JAX names): its
row counts, codecs, field adapter and bucket kernel. Stages per chunk of
points:

1. `_prepare_inputs`: strict Montgomery-R16 projective limbs -> packed
   affine points `(aff_rows, n)` and signed window digits `(W, n)`. The
   affine conversion is a blocked batch inversion (`ops/fp_inv.py`: K1-scan
   for each level's two passes, K1-inv for the ladder at its root), the
   other products run through K1 (`ops/mont_mul.py`); G2 inverts the norm
   z0^2 + z1^2 in Fp.
   The R16 factors cancel in x/z and y/z, so the affine coordinates land
   in the lazy R13 domain with no conversion multiply. Identity points
   (z = 0) get digit 0, i.e. the dropped bucket 0.
2. `accumulate` (K2: `csrc/bucket_accumulate.cu` for G1,
   `csrc/bucket_accumulate_g2.cu` for G2, both on `csrc/group381.cuh`):
   each of the S = 1024 streams (point n belongs to stream n mod S) adds
   its points into its own B = 2^(c-1)+1 signed buckets per window ->
   packed dump `(W, B, pt_rows, S)`. Both kernels compute on 32-bit
   Montgomery words (`point_words` converts the points first, on
   `KERNEL_G1_WORDS` or `KERNEL_G2_WORDS`) and write the same values as
   the plain version in other redundant digits.
3. `_reduce_dump`: fold the S streams (a sequential pass over 64 groups,
   then a tree over 16), then the bucket suffix sums -> lazy window sums.
4. `_finish_host`: window sums to canonical ints, Horner on the host.

`msm_sharded2` runs stages 1-3 on every rank of a `torch.distributed` mesh
over its shard, gathers the ranks' window sums, folds them
(`_fold_device_wsums`) and finishes once.

Layouts (int32 throughout, every word < 2^31), G1 / G2:
  points  (30 / 60, n)          packed affine x, y: 15 words per Fp
                                component, two balanced digits per word,
                                biased by 4129
  digits  (W, n)                magnitude | sign << 15
  dump    (W, B, 45 / 90, S)    packed projective x, y, z per bucket and
                                stream
  wsums   (90 / 180, W)         stacked lazy window sums
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..cuda import CudaKernel
from ..oracle import curve as OC
from ..oracle.field import P
from ..ops import convert as CV
from ..ops import fieldops as FO
from ..ops import fp_inv as FI
from ..ops import lazy13 as LZ
from ..ops import mont_mul as MM
from ..ops.limbs import FP
from . import msm as M
from .group import g1_identity, g2_identity
from .lazy_group import FP2_LAZY, FP_LAZY, full_add, mixed_add

STREAMS = 1024  # point streams per window (the TPU kernel's 8 x 128 tile)
SCAN_CHUNK = 64  # sequential steps of the stream fold (the JAX TPU path's)

BIAS = 4129  # balanced digits in [-4129, 4128] -> packed [0, 8257]
FP_ROWS = LZ.ELEM // 2  # packed rows of one Fp component
SIGN_BIT = 15
MAG_MASK = (1 << SIGN_BIT) - 1

R16_MOD_P = (1 << (16 * FP.num_limbs)) % P
R16_DIGITS = [int(v) for v in LZ.int_to_digits(R16_MOD_P)]


def int_to_digits_balanced(x: int) -> np.ndarray:
    """Host: value in [0, p) -> 30 balanced digits (|d| <= 4096)."""
    out = []
    carry = 0
    for v in LZ.int_to_digits(x):
        v = int(v) + carry
        carry = 0
        if v >= 4096:
            v -= 8192
            carry = 1
        out.append(v)
    if carry:
        raise ValueError("value must be < 0.49 * 2^390")
    return np.array(out, np.int32)


# --- packing -----------------------------------------------------------------

def pack30(d30: torch.Tensor) -> torch.Tensor:
    """(30, *batch) balanced digits -> (15, *batch) packed words."""
    return (d30[0::2] + BIAS) | ((d30[1::2] + BIAS) << 16)


def unpack15(words: torch.Tensor) -> torch.Tensor:
    """(15, *batch) packed words -> (30, *batch) balanced digits."""
    lo = (words & 0xFFFF) - BIAS
    hi = (words >> 16) - BIAS
    return torch.stack([lo, hi], dim=1).reshape((LZ.ELEM,) + tuple(words.shape[1:]))


def _num_buckets(c: int) -> int:
    return (1 << (c - 1)) + 1  # signed windows


def _num_windows(c: int) -> int:
    return (256 + c - 1) // c  # no carry window (window_digits_signed)


def _tree_map(fn, pt):
    """Apply fn to every tensor of a lazy or strict point (nested tuples)."""
    if isinstance(pt, tuple):
        return tuple(_tree_map(fn, x) for x in pt)
    return fn(pt)


# --- K2: the bucket kernels ---------------------------------------------------

_SIZES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_WORDS_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
KERNEL = CudaKernel("bucket_accumulate.cu", "msm_bucket_accumulate",
                    [ctypes.c_void_p] * 3 + _SIZES)
KERNEL_G2 = CudaKernel("bucket_accumulate_g2.cu", "msm_bucket_accumulate_g2",
                       [ctypes.c_void_p] * 3 + _SIZES)
# each bucket kernel's first step, in its library: the points to 32-bit words
KERNEL_G1_WORDS = CudaKernel("bucket_accumulate.cu", "msm_g1_point_words", _WORDS_ARGS)
KERNEL_G2_WORDS = CudaKernel("bucket_accumulate_g2.cu", "msm_g2_point_words", _WORDS_ARGS)


# --- per-curve kernel layout (the JAX package's KernelCurve2) -----------------

@dataclass(frozen=True)
class KernelCurve2:
    """Per-curve kernel layout and codecs. A coordinate is one Fp element
    (G1) or an Fp2 pair (G2, re then im); each Fp component is 15 packed
    rows."""

    name: str
    c_default: int

    @property
    def is_g2(self) -> bool:
        return self.name == "g2"

    @property
    def f(self):
        return FP2_LAZY if self.is_g2 else FP_LAZY

    @property
    def coord_rows(self) -> int:  # packed rows per field coordinate
        return 30 if self.is_g2 else 15

    @property
    def pt_rows(self) -> int:  # projective bucket point (x, y, z)
        return 3 * self.coord_rows

    @property
    def aff_rows(self) -> int:  # affine streamed point (x, y)
        return 2 * self.coord_rows

    @property
    def n_fp(self) -> int:  # Fp components per point (3 coords x ext degree)
        return 6 if self.is_g2 else 3

    @property
    def kernel(self) -> CudaKernel:
        return KERNEL_G2 if self.is_g2 else KERNEL

    @property
    def words_kernel(self) -> CudaKernel:
        return KERNEL_G2_WORDS if self.is_g2 else KERNEL_G1_WORDS

    @property
    def word_rows(self) -> int:  # affine point as 32-bit words, 12 per Fp component
        return 48 if self.is_g2 else 24

    def _coord_from_rows(self, rows):
        if self.is_g2:
            return (unpack15(rows[:15]), unpack15(rows[15:]))
        return unpack15(rows)

    def _coord_to_rows(self, coord) -> torch.Tensor:
        stored = self.f.store30(coord)
        comps = stored if self.is_g2 else (stored,)
        return torch.cat([pack30(comp) for comp in comps])

    def rows_to_point(self, rows):
        """(pt_rows, *batch) packed rows -> lazy projective point."""
        return tuple(self._coord_from_rows(r) for r in rows.split(self.coord_rows))

    def rows_to_affine(self, rows):
        """(aff_rows, *batch) packed rows -> lazy affine point (x, y)."""
        return self.rows_to_point(rows)

    def point_to_rows(self, pt) -> torch.Tensor:
        """Lazy point (projective or affine) -> packed rows of its stored
        digits."""
        return torch.cat([self._coord_to_rows(coord) for coord in pt])

    def components(self, pt) -> list:
        """A point's n_fp Fp components in order (x, y, z; re before im)."""
        return [comp for coord in pt for comp in (coord if self.is_g2 else (coord,))]

    def stack_point(self, pt) -> torch.Tensor:
        """Lazy projective point -> one (n_fp*30, *batch) tensor."""
        return torch.cat(self.components(pt))

    def nest(self, comps):
        """The inverse of `components`: n_fp Fp components -> a point."""
        if self.is_g2:
            return tuple(tuple(comps[2 * i : 2 * i + 2]) for i in range(3))
        return tuple(comps)

    def unstack_point(self, arr):
        return self.nest(arr.split(LZ.ELEM))

    def identity_rows(self) -> np.ndarray:
        """Host: packed rows of the projective identity (0 : one : 0)."""
        zero = np.full(15, BIAS | (BIAS << 16), np.int32)
        oneb = int_to_digits_balanced(LZ.R13_MOD_P).astype(np.int64) + BIAS
        onep = (oneb[0::2] | (oneb[1::2] << 16)).astype(np.int32)
        coords = [zero, zero, onep, zero, zero, zero] if self.is_g2 else [zero, onep, zero]
        return np.concatenate(coords)

    def identity(self, n: int, device):
        """Strict projective identity, batch (n,)."""
        return g2_identity(n, device) if self.is_g2 else g1_identity(n, device)


KC2_G1 = KernelCurve2("g1", 7)
KC2_G2 = KernelCurve2("g2", 5)


def _check_accumulate_args(kc: KernelCurve2, pts, digs):
    if pts.dtype != torch.int32 or digs.dtype != torch.int32:
        raise ValueError("accumulate wants int32 points and digits")
    if pts.dim() != 2 or pts.shape[0] != kc.aff_rows or digs.dim() != 2:
        raise ValueError(f"accumulate wants ({kc.aff_rows}, n) points and (W, n) digits")
    n = pts.shape[1]
    if digs.shape[1] != n or n % STREAMS:
        raise ValueError(f"point count {n} must match the digits and be a multiple of {STREAMS}")


def accumulate_plain(kc: KernelCurve2, pts: torch.Tensor, digs: torch.Tensor,
                     c: int) -> torch.Tensor:
    """The kernels' plain PyTorch version: a loop over the tiles of S points,
    each a batched mixed addition over all (window, stream) pairs, with the
    addressed bucket gathered and scattered back. Bucket 0 is left at the
    identity, as the kernels leave it."""
    _check_accumulate_args(kc, pts, digs)
    W, n = digs.shape
    S, B, rows, f = STREAMS, _num_buckets(c), kc.pt_rows, kc.f
    ident = torch.from_numpy(kc.identity_rows()).to(pts.device)
    dump = ident[None, None, :, None].expand(W, B, rows, S).clone()
    for t in range(n // S):
        dig = digs[:, t * S : (t + 1) * S]
        mag = dig & MAG_MASK
        sign = (dig >> SIGN_BIT) != 0
        idx = mag.long()[:, None, None, :].expand(W, 1, rows, S)
        cur_rows = dump.gather(1, idx)[:, 0].transpose(0, 1)  # (rows, W, S)
        x2, y2 = _tree_map(lambda a: a[:, None, :].expand(-1, W, -1),
                           kc.rows_to_affine(pts[:, t * S : (t + 1) * S]))
        y2 = f.select(sign, f.neg(y2), y2)
        new = mixed_add(f, kc.rows_to_point(cur_rows), (x2, y2))
        new_rows = torch.where(mag == 0, cur_rows, kc.point_to_rows(new))
        dump.scatter_(1, idx, new_rows.transpose(0, 1)[:, None])
    return dump


def _words32(limbs16: torch.Tensor) -> torch.Tensor:
    """(..., 24, n) 16-bit limbs -> (..., 12, n) 32-bit words (limb pairs),
    as int32 with the same bits."""
    w = limbs16[..., 0::2, :].long() | (limbs16[..., 1::2, :].long() << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def point_words_plain(kc: KernelCurve2, pts: torch.Tensor) -> torch.Tensor:
    """(aff_rows, n) packed lazy affine rows -> (word_rows, n) int32 words:
    each Fp component (x, y; re before im on G2) as the 12 words of its
    canonical Montgomery-R16 value (`_to_strict_stacked`'s limbs, pairs
    packed). The plain version of the curve's `words_kernel`."""
    strict = _to_strict_stacked(kc, kc.rows_to_affine(pts))
    return _words32(strict).reshape(kc.word_rows, pts.shape[1])


def point_words(kc: KernelCurve2, pts: torch.Tensor) -> torch.Tensor:
    """The bucket kernel's first step, (aff_rows, n) packed rows ->
    (word_rows, n) words: `KERNEL_G1_WORDS` or `KERNEL_G2_WORDS`
    (csrc/group381.cuh:rows_to_words) for a CUDA tensor, the plain version
    for a CPU tensor. Canonical words are unique, so both give the same
    bits."""
    if pts.dtype != torch.int32 or pts.dim() != 2 or pts.shape[0] != kc.aff_rows:
        raise ValueError(f"point_words wants ({kc.aff_rows}, n) int32 rows for {kc.name}")
    if pts.device.type == "cpu":
        return point_words_plain(kc, pts)
    if not (pts.is_cuda and pts.is_contiguous()):
        raise ValueError(f"point_words wants contiguous CUDA or CPU rows, got {pts.device}")
    n = pts.shape[1]
    words = torch.empty((kc.word_rows, n), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        kc.words_kernel.launch(pts.data_ptr(), words.data_ptr(), n,
                               torch.cuda.current_stream(pts.device).cuda_stream)
    return words


def accumulate(kc: KernelCurve2, pts: torch.Tensor, digs: torch.Tensor, c: int) -> torch.Tensor:
    """pts (aff_rows, n) packed affine points, digs (W, n) signed digits ->
    dump (W, B, pt_rows, S): the curve's CUDA kernels for CUDA tensors, the
    plain version for CPU tensors. Both bucket kernels run on the points'
    32-bit words (`point_words`) and give the plain version's values in
    other redundant digits (compare with `dump_values`)."""
    _check_accumulate_args(kc, pts, digs)
    if pts.device.type == "cpu" and digs.device.type == "cpu":
        return accumulate_plain(kc, pts, digs, c)
    if not (pts.is_cuda and pts.device == digs.device):
        raise ValueError(f"accumulate operands on {pts.device} and {digs.device}")
    if not (pts.is_contiguous() and digs.is_contiguous()):
        raise ValueError("accumulate wants contiguous operands")
    W, n = digs.shape
    B = _num_buckets(c)
    dump = torch.empty((W, B, kc.pt_rows, STREAMS), dtype=torch.int32, device=pts.device)
    words = point_words(kc, pts)
    with torch.cuda.device(pts.device):
        kc.kernel.launch(words.data_ptr(), digs.data_ptr(), dump.data_ptr(), n, W, B, STREAMS,
                         torch.cuda.current_stream(pts.device).cuda_stream)
    return dump


def max_dump_digit(dump: torch.Tensor) -> int:
    """The largest |digit| in a packed dump (two biased digits a word)."""
    return int(max(((dump & 0xFFFF) - BIAS).abs().max(), ((dump >> 16) - BIAS).abs().max()))


def dump_values(kc: KernelCurve2, dump: torch.Tensor) -> torch.Tensor:
    """(W, B, pt_rows, S) packed dump -> (n_fp, 30, W, B, S) canonical R13
    digits of every bucket component: equal for two dumps that hold the same
    field elements, whatever their redundant digits."""
    comps = dump.permute(2, 0, 1, 3).split(FP_ROWS)
    return torch.stack([LZ.canonicalize(unpack15(rows)) for rows in comps])


# --- prepare: strict projective points -> kernel layout ----------------------

def _mul(a, b):
    """Lazy Montgomery product of the prepare stage, through K1."""
    return MM.mont_mul(a.contiguous(), b.contiguous())


def _spliced_f(arr):
    """Strict (24, n) coord -> mul-ready digits of the RAW value v*R16 (one
    balanced fold of the canonical splice; value < 2^384, so the 30-digit
    clamp is exact)."""
    return LZ.fold(LZ.from_limbs16(arr))[: LZ.ELEM]


def _fp2_mul(a, b):
    """Fp2 product from three K1 products (Karatsuba): linear combinations of
    full Montgomery products are exact, so this equals LZ.fp2_mont_mul's
    value at one more reduction."""
    sa = LZ.fold_sum(LZ.add(a[0], a[1]))
    sb = LZ.fold_sum(LZ.add(b[0], b[1]))
    m0, m1, m2 = _mul(a[0], b[0]), _mul(a[1], b[1]), _mul(sa, sb)
    return (LZ.fold_sum(LZ.sub(m0, m1)), LZ.fold_sum(LZ.sub(m2, LZ.add(m0, m1))))


def _prepare_inputs(kc: KernelCurve2, points, scalars, c: int):
    """points: strict Montgomery-R16 projective (x, y, z), each (24, n) (a
    pair of them per G2 coordinate); scalars: (16, n) plain Fr limbs, each
    < 2^255. Returns (pts (aff_rows, n) packed affine, digs (W, n) signed
    digits)."""
    x, y, z = points
    if kc.is_g2:
        # 1/(z0 + z1 u) = (z0 - z1 u) / (z0^2 + z1^2): one Fp batch inversion
        ident = FO.is_zero(z[0]) & FO.is_zero(z[1])
        zl = (_spliced_f(z[0]), _spliced_f(z[1]))
        norm = LZ.fold_sum(LZ.add(_mul(zl[0], zl[0]), _mul(zl[1], zl[1])))
        inv_norm = FI.batch_inverse(LZ.select(ident, FP_LAZY.one(norm), norm))
        inv_z = (_mul(zl[0], inv_norm), LZ.neg(_mul(zl[1], inv_norm)))
        aff = [_fp2_mul((_spliced_f(coord[0]), _spliced_f(coord[1])), inv_z)
               for coord in (x, y)]
    else:
        ident = FO.is_zero(z)
        zl = _spliced_f(z)
        inv_z = FI.batch_inverse(LZ.select(ident, FP_LAZY.one(zl), zl))
        aff = [_mul(_spliced_f(coord), inv_z) for coord in (x, y)]
    pts = kc.point_to_rows(aff).contiguous()
    digits = M.window_digits_signed(scalars, c)
    digits = torch.where(ident, 0, digits).contiguous()  # identity -> bucket 0
    return pts, digits


# --- reduce: dump -> stacked lazy window sums --------------------------------

def _dump_to_points(kc: KernelCurve2, dump):
    """(W, B, pt_rows, S) packed dump -> lazy bucket points with batch
    (S, W*B)."""
    W, B, rows, S = dump.shape
    return kc.rows_to_point(dump.permute(2, 3, 0, 1).reshape(rows, S, W * B))


def _fold_streams(kc: KernelCurve2, pt):
    """Fold the stream axis (dim 1, size S) to one: a sequential pass over
    SCAN_CHUNK groups of S/SCAN_CHUNK streams, then a tree over the group.
    Values equal the JAX package's tree or scan folds; the redundant digits
    differ."""
    S = kc.components(pt)[0].shape[1]
    group = S // SCAN_CHUNK
    pt = _tree_map(lambda x: x.reshape((x.shape[0], SCAN_CHUNK, group) + tuple(x.shape[2:])), pt)
    acc = _tree_map(lambda x: x[:, 0], pt)
    for i in range(1, SCAN_CHUNK):
        acc = full_add(kc.f, acc, _tree_map(lambda x: x[:, i], pt))
    size = group
    while size > 1:
        half = size // 2
        acc = full_add(kc.f, _tree_map(lambda x: x[:, :half], acc),
                       _tree_map(lambda x: x[:, half:size], acc))
        size = half
    return _tree_map(lambda x: x[:, 0], acc)


def _bucket_suffix(kc: KernelCurve2, pt, B: int):
    """Suffix-accumulate buckets, highest magnitude first, bucket 0 dropped:
    window sum = sum_b b * S_b, batch (W, B) -> (W,)."""
    running = _tree_map(lambda x: x[..., B - 1], pt)
    total = running
    for b in range(B - 2, 0, -1):
        running = full_add(kc.f, running, _tree_map(lambda x: x[..., b], pt))
        total = full_add(kc.f, total, running)
    return total


def _reduce_dump(kc: KernelCurve2, dump):
    """dump (W, B, pt_rows, S) -> stacked lazy window sums (n_fp*30, W)."""
    W, B = dump.shape[0], dump.shape[1]
    folded = _fold_streams(kc, _dump_to_points(kc, dump))  # batch (W*B,)
    folded = _tree_map(lambda x: x.reshape(LZ.ELEM, W, B), folded)
    return kc.stack_point(_bucket_suffix(kc, folded, B))


def _add_wsums2(kc: KernelCurve2, a, b):
    """Accumulate stacked window sums across chunks."""
    return kc.stack_point(full_add(kc.f, kc.unstack_point(a), kc.unstack_point(b)))


# --- finish: window sums -> strict projective point --------------------------

def _to_strict_stacked(kc: KernelCurve2, pt) -> torch.Tensor:
    """Lazy R13 projective point -> strict canonical R16 limbs
    (n_fp, 24, batch)."""
    return torch.stack([
        LZ.to_limbs16_strict(LZ.canonicalize(LZ.mont_mul_const(x, R16_DIGITS)))
        for x in kc.components(pt)
    ])


def _finish_host(kc: KernelCurve2, ws_stacked, c: int):
    """Horner over the W window sums on host ints: one egress of the
    (n_fp, 24, W) canonical limbs, then W*c doublings and W additions in the
    oracle. Returns the strict projective result, batch (1,)."""
    if kc.is_g2:
        from_dev, add, double, to_dev = CV.g2_from_dev, OC.g2_add, OC.g2_double, CV.g2_to_dev
    else:
        from_dev, add, double, to_dev = CV.g1_from_dev, OC.add, OC.double, CV.g1_to_dev
    strict = _to_strict_stacked(kc, kc.unstack_point(ws_stacked)).cpu()
    pts = from_dev(kc.nest(strict.unbind(0)))
    total = None
    for w in range(len(pts) - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = double(total)
        total = add(total, pts[w])
    return _tree_map(lambda t: t.to(ws_stacked.device), to_dev([total]))


# --- driver -------------------------------------------------------------------

def _window_sums2(kc: KernelCurve2, points, scalars, c: int, max_windows: int | None = None):
    """One chunk up to (and including) the bucket reduction. `max_windows`
    truncates the window schedule: sound ONLY when every scalar is below
    2^(c*(max_windows-1)); it keeps the CPU tests small."""
    pts, digs = _prepare_inputs(kc, points, scalars, c)
    if max_windows is not None:
        digs = digs[:max_windows].contiguous()
    return _reduce_dump(kc, accumulate(kc, pts, digs, c))


def plan_chunk2(kc: KernelCurve2, c: int, budget_bytes: int) -> int:
    """Largest power-of-two chunk (multiple of S) whose footprint fits the
    budget: input limbs + packed affine copy + inversion intermediates +
    digits per point, plus the dump and its transpose."""
    W, B = _num_windows(c), _num_buckets(c)
    fixed = 2 * W * B * kc.pt_rows * STREAMS * 4
    elem_words = LZ.ELEM * (2 if kc.is_g2 else 1)
    per_point = (kc.n_fp * FP.num_limbs + kc.aff_rows + 4 * elem_words + W + 2) * 4
    budget = budget_bytes - fixed
    if budget <= per_point * STREAMS:
        raise ValueError(f"memory budget {budget_bytes} below one tile of points")
    chunk = STREAMS
    while chunk * 2 * per_point <= budget:
        chunk *= 2
    return chunk


def _device_budget(device: torch.device) -> int:
    """Memory budget of one chunk: half the card's free memory; 2 GiB on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return 2 << 30


def _check_window(c: int, max_windows: int | None) -> None:
    if not 2 <= c <= 15:
        raise ValueError(f"MSM window c must be in [2, 15], got {c}")
    if max_windows is not None and max_windows < 1:
        raise ValueError(f"max_windows must be >= 1, got {max_windows}")


def _chunked_window_sums(kc: KernelCurve2, points, scalars, c: int, chunk: int | None,
                         budget_bytes: int, maybe_abort=None, max_windows: int | None = None):
    """Stacked lazy window sums of n >= 1 points on the device of `scalars`,
    chunk by chunk (`chunk` points each; default: planned from
    `budget_bytes`), summed across chunks."""
    n = scalars.shape[-1]
    if chunk is None:
        chunk = plan_chunk2(kc, c, budget_bytes)
    elif chunk <= 0 or chunk % STREAMS:
        raise ValueError(f"chunk must be a positive multiple of {STREAMS}, got {chunk}")
    chunk = min(chunk, -(-n // STREAMS) * STREAMS)
    points, scalars = M._pad_inputs(kc.name, points, scalars, chunk)
    n_chunks = scalars.shape[-1] // chunk
    total = None
    for i in range(n_chunks):
        if maybe_abort is not None and maybe_abort():
            raise M.MsmAborted(f"aborted before chunk {i}/{n_chunks}")
        sl = slice(i * chunk, (i + 1) * chunk)
        ws = _window_sums2(kc, _tree_map(lambda x: x[:, sl], points), scalars[:, sl], c,
                           max_windows)
        total = ws if total is None else _add_wsums2(kc, total, ws)
    return total


def msm(points, scalars, kc: KernelCurve2, c: int, chunk: int | None = None,
        maybe_abort=None, max_windows: int | None = None):
    """Chunked G1 or G2 MSM on the device of `scalars`.

    points: strict Montgomery-R16 projective (x, y, z), each (24, N) int32
    (G2: each coordinate a pair of them); scalars: (16, N) plain Fr limbs,
    each value < 2^255. Returns the strict projective result in the same
    form with batch (1,). `maybe_abort`: zero-argument callable polled
    before every chunk; a true answer raises MsmAborted. `max_windows`
    truncates the windows as in `_window_sums2`."""
    _check_window(c, max_windows)
    if scalars.shape[-1] == 0:
        return kc.identity(1, scalars.device)
    total = _chunked_window_sums(kc, points, scalars, c, chunk, _device_budget(scalars.device),
                                 maybe_abort, max_windows)
    return _finish_host(kc, total, c)


# --- multi-device: the bucket pipeline on every rank --------------------------

def _fold_device_wsums(ws: torch.Tensor, kc: KernelCurve2) -> torch.Tensor:
    """Log-depth fold of the ranks' stacked window sums (world, n_fp*30, W)
    -> (n_fp*30, W): each level adds the lower half of the ranks to the upper
    half pair by pair in one batched `full_add`, an odd last rank carried
    to the next level, as JAX
    `_fold_device_wsums_jit`. Every rank folds the same gathered tensor, so
    every rank gets the same digits."""
    while ws.shape[0] > 1:
        half = ws.shape[0] // 2
        lo = kc.unstack_point(ws[:half].movedim(0, -1))
        hi = kc.unstack_point(ws[half : 2 * half].movedim(0, -1))
        folded = kc.stack_point(full_add(kc.f, lo, hi)).movedim(-1, 0)
        ws = torch.cat([folded, ws[2 * half :]])
    return ws[0]


def msm_sharded2(points, scalars, mesh, kc: KernelCurve2 = KC2_G1, c: int | None = None,
                 axis: str = "data", max_windows: int | None = None, chunk: int | None = None):
    """Multi-device G1 or G2 MSM with the bucket kernels on every rank, a
    collective: every rank of `mesh` (`distributed.global_mesh`) calls it
    with the same global inputs, as for `msm`, and gets the same strict
    projective result, batch (1,), on its device.

    The points are padded to a multiple of S * world (JAX: TILE * ndev);
    rank r takes the r-th contiguous shard and runs prepare, K2 (or K2-G2)
    and the reduce on it through `msm`'s chunk loop, so a 2^24+ shard fits
    (`chunk` points a chunk; default: planned from the rank's share of its
    card, `_device_budget` over the ranks that share it). The ranks gather
    their (n_fp*30, W) stacked window sums, fold them in a log-depth tree
    (`_fold_device_wsums`) and finish on the host once. `max_windows` as
    in `_window_sums2`."""
    if c is None:
        c = kc.c_default
    _check_window(c, max_windows)
    world, dev = mesh.shape[axis], mesh.device
    if scalars.shape[-1] == 0:
        return kc.identity(1, dev)
    points, scalars = M._pad_inputs(kc.name, points, scalars, STREAMS * world)
    m = scalars.shape[-1] // world
    sl = slice(mesh.rank * m, (mesh.rank + 1) * m)
    pts = _tree_map(lambda x: x[:, sl].to(dev, torch.int32), points)
    ws = _chunked_window_sums(kc, pts, scalars[:, sl].to(dev, torch.int32), c, chunk,
                              _device_budget(dev) // mesh.sharing, max_windows=max_windows)
    return _finish_host(kc, _fold_device_wsums(mesh.all_gather(ws), kc), c)
