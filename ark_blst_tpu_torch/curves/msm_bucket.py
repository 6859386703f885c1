"""G1 MSM on the card: lazy radix-13 prepare, K2 bucket kernel, reduce, finish.

Counterpart of `ark_blst_tpu/curves/msm_pallas2.py` (G1 instance). Stages
per chunk of points:

1. `_prepare_inputs`: strict Montgomery-R16 projective limbs -> packed
   affine points `(30, n)` and signed window digits `(W, n)`. The affine
   conversion is a blocked batch inversion whose products run through K1
   (`ops/mont_mul.py`); the R16 factors cancel in x/z and y/z, so the
   affine coordinates land in the lazy R13 domain with no conversion
   multiply. Identity points (z = 0) get digit 0, i.e. the dropped bucket 0.
2. `accumulate` (K2, `csrc/bucket_accumulate.cu`): each of the S = 1024
   streams (point n belongs to stream n mod S) adds its points into its own
   B = 2^(c-1)+1 signed buckets per window -> packed dump `(W, B, 45, S)`.
3. `_reduce_dump`: fold the S streams (a sequential pass over 64 groups,
   then a tree over 16), then the bucket suffix sums -> lazy window sums.
4. `_finish_host`: window sums to canonical ints, Horner on the host.

Layouts (int32 throughout, every word < 2^31):
  points  (30, n)        packed affine x, y: 15 words each, two balanced
                         digits per word, biased by 4129
  digits  (W, n)         magnitude | sign << 15
  dump    (W, B, 45, S)  packed projective x, y, z per bucket and stream
  wsums   (90, W)        stacked lazy window sums (x, y, z digits)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import CudaKernel
from ..oracle import curve as OC
from ..oracle.field import P
from ..ops import convert as CV
from ..ops import fieldops as FO
from ..ops import lazy13 as LZ
from ..ops import mont_mul as MM
from ..ops.limbs import FP
from . import msm as M
from .group import g1_identity
from .lazy_group import FP_LAZY, full_add, mixed_add

STREAMS = 1024  # point streams per window (the TPU kernel's 8 x 128 tile)
SCAN_CHUNK = 64  # sequential steps of the stream fold (the JAX TPU path's)

BIAS = 4129  # balanced digits in [-4129, 4128] -> packed [0, 8257]
SIGN_BIT = 15
MAG_MASK = (1 << SIGN_BIT) - 1

R16_MOD_P = (1 << (16 * FP.num_limbs)) % P
R16_DIGITS = [int(v) for v in LZ.int_to_digits(R16_MOD_P)]

# MSB-first bits of p - 2 for the Fermat ladder at the batch-inversion root
_P_MINUS_2_BITS = [int(b) for b in bin(P - 2)[2:]]


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


# --- G1 kernel layout (the JAX package's KC2_G1 codec) ------------------------

COORD_ROWS = 15  # packed rows per Fp coordinate
AFF_ROWS = 2 * COORD_ROWS  # affine streamed point (x, y)
PT_ROWS = 3 * COORD_ROWS  # projective bucket point (x, y, z)


def rows_to_coords(rows):
    """(15k, *batch) packed rows -> k lazy coordinates, each (30, *batch)."""
    return tuple(unpack15(r) for r in rows.split(COORD_ROWS))


def point_to_rows(pt) -> torch.Tensor:
    return torch.cat([pack30(LZ.store30(coord)) for coord in pt])


def identity_rows() -> np.ndarray:
    """Host: packed rows (45,) of the projective identity (0 : one : 0)."""
    zero = np.full(COORD_ROWS, BIAS | (BIAS << 16), np.int32)
    oneb = int_to_digits_balanced(LZ.R13_MOD_P).astype(np.int64) + BIAS
    onep = (oneb[0::2] | (oneb[1::2] << 16)).astype(np.int32)
    return np.concatenate([zero, onep, zero])


def _num_buckets(c: int) -> int:
    return (1 << (c - 1)) + 1  # signed windows


def _num_windows(c: int) -> int:
    return (256 + c - 1) // c  # no carry window (window_digits_signed)


# --- K2: the bucket kernel ---------------------------------------------------

KERNEL = CudaKernel(
    "bucket_accumulate.cu",
    "msm_bucket_accumulate",
    [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def _check_accumulate_args(pts, digs):
    if pts.dtype != torch.int32 or digs.dtype != torch.int32:
        raise ValueError("accumulate wants int32 points and digits")
    if pts.dim() != 2 or pts.shape[0] != AFF_ROWS or digs.dim() != 2:
        raise ValueError(f"accumulate wants ({AFF_ROWS}, n) points and (W, n) digits")
    n = pts.shape[1]
    if digs.shape[1] != n or n % STREAMS:
        raise ValueError(f"point count {n} must match the digits and be a multiple of {STREAMS}")


def accumulate_plain(pts: torch.Tensor, digs: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: a loop over the tiles of S points,
    each a batched mixed addition over all (window, stream) pairs, with the
    addressed bucket gathered and scattered back. Bucket 0 is left at the
    identity, as the kernel leaves it."""
    _check_accumulate_args(pts, digs)
    W, n = digs.shape
    S, B, rows = STREAMS, _num_buckets(c), PT_ROWS
    ident = torch.from_numpy(identity_rows()).to(pts.device)
    dump = ident[None, None, :, None].expand(W, B, rows, S).clone()
    for t in range(n // S):
        dig = digs[:, t * S : (t + 1) * S]
        mag = dig & MAG_MASK
        sign = (dig >> SIGN_BIT) != 0
        idx = mag.long()[:, None, None, :].expand(W, 1, rows, S)
        cur_rows = dump.gather(1, idx)[:, 0].transpose(0, 1)  # (rows, W, S)
        x2, y2 = (a[:, None, :].expand(-1, W, -1)
                  for a in rows_to_coords(pts[:, t * S : (t + 1) * S]))
        y2 = FP_LAZY.select(sign, FP_LAZY.neg(y2), y2)
        new = mixed_add(FP_LAZY, rows_to_coords(cur_rows), (x2, y2))
        new_rows = torch.where(mag == 0, cur_rows, point_to_rows(new))
        dump.scatter_(1, idx, new_rows.transpose(0, 1)[:, None])
    return dump


def accumulate(pts: torch.Tensor, digs: torch.Tensor, c: int) -> torch.Tensor:
    """pts (30, n) packed affine points, digs (W, n) signed digits ->
    dump (W, B, 45, S): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_accumulate_args(pts, digs)
    if pts.device.type == "cpu" and digs.device.type == "cpu":
        return accumulate_plain(pts, digs, c)
    if not (pts.is_cuda and pts.device == digs.device):
        raise ValueError(f"accumulate operands on {pts.device} and {digs.device}")
    if not (pts.is_contiguous() and digs.is_contiguous()):
        raise ValueError("accumulate wants contiguous operands")
    W, n = digs.shape
    B = _num_buckets(c)
    ident = torch.from_numpy(identity_rows()).to(pts.device)
    dump = torch.empty((W, B, PT_ROWS, STREAMS), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        KERNEL.launch(pts.data_ptr(), digs.data_ptr(), ident.data_ptr(), dump.data_ptr(),
                      n, W, B, STREAMS, stream)
    return dump


# --- prepare: strict projective points -> kernel layout ----------------------

def _mul(a, b):
    """Lazy Montgomery product of the prepare stage, through K1."""
    return MM.mont_mul(a.contiguous(), b.contiguous())


def _fermat_inv(z):
    """Elementwise z^(p-2) (Montgomery) by square-and-multiply over the 381
    exponent bits: the root of the blocked batch inversion."""
    r = z
    for bit in _P_MINUS_2_BITS[1:]:
        r = _mul(r, r)
        if bit:
            r = _mul(r, z)
    return r


def _batch_inverse(z):
    """Blocked Montgomery batch inversion of a lazy Fp vector (30, n): ~3
    products per element in g sequential groups, a Fermat ladder at the
    recursion root. Caller substitutes nonzero values for zero entries."""
    n = z.shape[1]
    g = next((cand for cand in (64, 32, 16, 8, 4, 2) if n % cand == 0), None)
    if n <= 2048 or g is None:
        return _fermat_inv(z)
    m = n // g
    rows = z.reshape(LZ.ELEM, g, m).transpose(0, 1).contiguous()  # (g, 30, m)
    carry = FP_LAZY.one(rows[0])
    pre = torch.empty_like(rows)
    for k in range(g):  # exclusive prefix products
        pre[k] = carry
        carry = _mul(carry, rows[k])
    t = _batch_inverse(carry)
    invs = torch.empty_like(rows)
    for k in reversed(range(g)):
        invs[k] = _mul(t, pre[k])
        t = _mul(t, rows[k])
    return invs.transpose(0, 1).reshape(LZ.ELEM, n)


def _spliced_f(arr):
    """Strict (24, n) coord -> mul-ready digits of the RAW value v*R16 (one
    balanced fold of the canonical splice; value < 2^384, so the 30-digit
    clamp is exact)."""
    return LZ.fold(LZ.from_limbs16(arr))[: LZ.ELEM]


def _prepare_inputs(points, scalars, c: int):
    """points: strict Montgomery-R16 projective (x, y, z), each (24, n);
    scalars: (16, n) plain Fr limbs, each < 2^255. Returns
    (pts (30, n) packed affine, digs (W, n) signed digits)."""
    x, y, z = points
    ident = FO.is_zero(z)
    zl = _spliced_f(z)
    zsafe = LZ.select(ident, FP_LAZY.one(zl), zl)
    inv_z = _batch_inverse(zsafe)
    aff = [_mul(_spliced_f(coord), inv_z) for coord in (x, y)]
    pts = torch.cat([pack30(LZ.store30(a)) for a in aff]).contiguous()
    digits = M.window_digits_signed(scalars, c)
    digits = torch.where(ident, 0, digits).contiguous()  # identity -> bucket 0
    return pts, digits


# --- reduce: dump -> stacked lazy window sums --------------------------------

def _dump_to_points(dump):
    """(W, B, 45, S) packed dump -> lazy bucket points with batch (S, W*B)."""
    W, B, rows, S = dump.shape
    mat = dump.permute(2, 3, 0, 1).reshape(rows, S, W * B)
    return rows_to_coords(mat)


def _fold_streams(pt):
    """Fold the stream axis (dim 1, size S) to one: a sequential pass over
    SCAN_CHUNK groups of S/SCAN_CHUNK streams, then a tree over the group.
    Values equal the JAX package's tree or scan folds; the redundant digits
    differ."""
    S = pt[0].shape[1]
    group = S // SCAN_CHUNK
    pt = tuple(x.reshape((x.shape[0], SCAN_CHUNK, group) + tuple(x.shape[2:])) for x in pt)
    acc = tuple(x[:, 0] for x in pt)
    for i in range(1, SCAN_CHUNK):
        acc = full_add(FP_LAZY, acc, tuple(x[:, i] for x in pt))
    size = group
    while size > 1:
        half = size // 2
        acc = full_add(FP_LAZY, tuple(x[:, :half] for x in acc),
                       tuple(x[:, half:size] for x in acc))
        size = half
    return tuple(x[:, 0] for x in acc)


def _bucket_suffix(pt, B: int):
    """Suffix-accumulate buckets, highest magnitude first, bucket 0 dropped:
    window sum = sum_b b * S_b, batch (W, B) -> (W,)."""
    running = tuple(x[..., B - 1] for x in pt)
    total = running
    for b in range(B - 2, 0, -1):
        running = full_add(FP_LAZY, running, tuple(x[..., b] for x in pt))
        total = full_add(FP_LAZY, total, running)
    return total


def _reduce_dump(dump):
    """dump (W, B, 45, S) -> stacked lazy window sums (90, W)."""
    W, B = dump.shape[0], dump.shape[1]
    folded = _fold_streams(_dump_to_points(dump))  # batch (W*B,)
    folded = tuple(x.reshape(LZ.ELEM, W, B) for x in folded)
    return torch.cat(_bucket_suffix(folded, B))


def _add_wsums2(a, b):
    """Accumulate stacked window sums across chunks."""
    return torch.cat(full_add(FP_LAZY, a.split(LZ.ELEM), b.split(LZ.ELEM)))


# --- finish: window sums -> strict projective point --------------------------

def _to_strict_stacked(pt) -> torch.Tensor:
    """Lazy R13 projective point -> strict canonical R16 limbs (3, 24, batch)."""
    return torch.stack([
        LZ.to_limbs16_strict(LZ.canonicalize(LZ.mont_mul_const(x, R16_DIGITS)))
        for x in pt
    ])


def _finish_host(ws_stacked, c: int):
    """Horner over the W window sums on host ints: one egress of the
    (3, 24, W) canonical limbs, then W*c doublings and W additions in the
    oracle. Returns the strict projective result, batch (1,)."""
    arr = _to_strict_stacked(ws_stacked.split(LZ.ELEM))
    pts = CV.g1_from_dev((arr[0], arr[1], arr[2]))
    total = None
    for w in range(len(pts) - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = OC.double(total)
        total = OC.add(total, pts[w])
    return tuple(t.to(ws_stacked.device) for t in CV.g1_to_dev([total]))


# --- driver -------------------------------------------------------------------

def _window_sums2(points, scalars, c: int):
    """One chunk up to (and including) the bucket reduction."""
    pts, digs = _prepare_inputs(points, scalars, c)
    return _reduce_dump(accumulate(pts, digs, c))


def plan_chunk2(c: int, budget_bytes: int) -> int:
    """Largest power-of-two chunk (multiple of S) whose footprint fits the
    budget: input limbs + packed affine copy + inversion intermediates +
    digits per point, plus the dump and its transpose."""
    W, B = _num_windows(c), _num_buckets(c)
    fixed = 2 * W * B * PT_ROWS * STREAMS * 4
    per_point = (3 * FP.num_limbs + AFF_ROWS + 4 * LZ.ELEM + W + 2) * 4
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


def msm(points, scalars, c: int, chunk: int | None = None, maybe_abort=None):
    """Chunked G1 MSM on the device of `scalars`.

    points: strict Montgomery-R16 projective (x, y, z), each (24, N) int32;
    scalars: (16, N) plain Fr limbs, each value < 2^255. Returns the strict
    projective result, each coordinate (24, 1). `maybe_abort`: zero-argument
    callable polled before every chunk; a true answer raises MsmAborted."""
    if not 2 <= c <= 15:
        raise ValueError(f"MSM window c must be in [2, 15], got {c}")
    n = scalars.shape[-1]
    if n == 0:
        return g1_identity(1, scalars.device)
    if chunk is None:
        chunk = plan_chunk2(c, _device_budget(scalars.device))
    elif chunk <= 0 or chunk % STREAMS:
        raise ValueError(f"chunk must be a positive multiple of {STREAMS}, got {chunk}")
    chunk = min(chunk, -(-n // STREAMS) * STREAMS)
    points, scalars = M._pad_inputs(points, scalars, chunk)
    n_chunks = scalars.shape[-1] // chunk
    total = None
    for i in range(n_chunks):
        if maybe_abort is not None and maybe_abort():
            raise M.MsmAborted(f"aborted before chunk {i}/{n_chunks}")
        sl = slice(i * chunk, (i + 1) * chunk)
        ws = _window_sums2(tuple(x[:, sl] for x in points), scalars[:, sl], c)
        total = ws if total is None else _add_wsums2(total, ws)
    return _finish_host(total, c)
