"""scan-acc, scan-red and scan-horner: the strict engine's scan MSM's three
scans as hand-written CUDA launches; scan-mul: the strict group's
double-and-add ladder as one.

Counterpart of the `lax.scan`s of `ark_blst_tpu/curves/msm.py:138 _scan`,
which the JAX package runs inside one compiled program over
`ark_blst_tpu/ops/pallas_field.py:66 _block_call` (K7-K10):
  scan-acc     `:155 _bucket_accumulate`: every (lane, window) stream's
               points added into its buckets by the complete RCB15
               addition;
  scan-red     `:199 _bucket_reduce`: the running/total suffix sums of
               each window's buckets, highest first, bucket 0 dropped;
  scan-horner  `:227 _horner`: c doublings and one addition a window,
               most significant first;
and of the `lax.scan` of `ark_blst_tpu/curves/group.py:257 scalar_mul`
(`:276`) over the same kernels:
  scan-mul     `scalar_mul`: per element, a doubling and an addition a
               bit of the scalar, the sum taken where the bit is set
               (`msm_naive`'s ladder).
The kernels (`csrc/scan_msm.cu` on `csrc/scan_msm.cuh` and
`csrc/group381.cuh`) compute on 32-bit Montgomery words and store
canonical strict limbs. scan-acc is three launches: the points to word
records (`point_words`), the walk of each stream by a team of threads
over word-record buckets in a scratch (`accumulate_words`), and the
buckets' split into the strict limb stack (`split_buckets`); scan-red
walks each window, scan-horner the window sums, by a team of threads a
chain (`RED_SHAPE`, `HORNER_SHAPE`); scan-mul walks each element's ladder
by a team of threads (`MUL_SHAPE`). Their plain versions
(`bucket_accumulate_plain`, `bucket_reduce_plain`, `horner_plain`,
`scalar_mul_plain`) are
the loops on the strict group law (`curves/group.py`, K7-K10 a field op)
that the port ran before, step for step the JAX `fuse=False` branch: every
value is canonical and the two compute the same expressions, so the
kernels' outputs equal them limb for limb. scan-acc's passes have plain
versions of their own (`point_words_plain`, `accumulate_words_plain`,
`split_buckets_plain`), whose composition is `bucket_accumulate_plain`'s
stack.

Points are the strict engine's nested tuples (`curves/group.py`): G1
(X, Y, Z) of `(24, *batch)` limb leaves, G2 the same with fp2 pairs. A
kernel takes them stacked, `(3 nc, 24, *batch)` (`stack_point`; nc = 1 or
2 Fp components a coordinate), and returns the nested views of its output
stack (`point_of`). Each wrapper launches its kernel for CUDA tensors and
counts the launch, runs the plain version for CPU tensors, and raises for
anything else.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, cpu_operands
from . import tower as T
from . import words as WD
from .limbs import FP, FR

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL_WORDS = CudaKernel("scan_msm.cu", "scan_msm_point_words", [_P, _P, _L, _I, _P])
KERNEL_ACC = CudaKernel("scan_msm.cu", "scan_msm_accumulate",
                        [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P])
KERNEL_SPLIT = CudaKernel("scan_msm.cu", "scan_msm_split", [_P, _P, _L, _I, _P])
KERNEL_RED = CudaKernel("scan_msm.cu", "scan_msm_reduce",
                        [_P, _P, _I, _I, _I, _I, _I, _I, _P])
KERNEL_HORNER = CudaKernel("scan_msm.cu", "scan_msm_horner", [_P, _P, _I, _I, _I, _I, _I, _P])
KERNEL_MUL = CudaKernel("scan_msm.cu", "scan_msm_scalar_mul",
                        [_P, _P, _P, _L, _I, _I, _I, _I, _P])
KERNELS = {"scan_acc_words": KERNEL_WORDS, "scan_acc_walk": KERNEL_ACC,
           "scan_acc_split": KERNEL_SPLIT, "scan_red": KERNEL_RED, "scan_horner": KERNEL_HORNER,
           "scan_mul": KERNEL_MUL}

RECORD = 3 * WD.WORDS  # words of a G1 point or bucket record (x, y, z); G2's are twice as long
# scan-acc's walk: (threads a team, threads a block) by nc, timed by
# scripts/scan_acc_probe.py (an H100 80GB HBM3 at 700 W, the scan MSM's
# full widths). G1: a team of 3 takes the six products of a phase two
# each, 47.7 ms against 47.9 for teams of 2, 48.9 for one thread a stream,
# 51.4 for teams of 6 and 62.8 for one thread a stream with the addition
# written straight through (200 registers). G2: a team of 18 takes the 18
# Fp legs one each, 64.3 ms in 1.29 waves, the fastest shape measured that
# fills a wave of the card, as the walk's design asks; teams of 6 in
# 96-thread blocks run 49.9 ms in 0.43 of a wave, 9 x 288 54.5, 2 and 3
# 62.5, 1 103.8, the straight-line thread 164.9 (255 registers, 968 B of
# stack)
ACC_SHAPE = {1: (3, 96), 2: (18, 288)}
# scan-red: (threads that take the products, threads a block, buckets the
# block's column holds) by nc, timed by scripts/scan_red_probe.py (an H100
# 80GB HBM3 at 700 W, W = 32 windows of B = 256): a block walks a window,
# both additions of a step one Fp product a thread (12 on G1, 36 Karatsuba
# legs on G2), each sum job on a warp with its twin of the other addition.
# G1 12 x 192 x 128 1.488 ms (column 256 1.486; the sums on the products'
# warp, 12 x 12, 1.778; products two a thread, 6 x 192, 2.331); G2 36 x
# 192 x 128 2.425 ms (36 x 256 2.651, 36 x 36 2.840, 18 x 192 3.543)
RED_SHAPE = {1: (12, 192, 128), 2: (36, 192, 128)}
# scan-horner: (threads that take the products, threads a block) by nc, an
# addition's products one a thread, its sums one a warp: G1 6 x 192 1.545
# ms (6 x 6 1.686, 4 x 192 1.649), G2 18 x 256 2.560 ms (18 x 192 2.608,
# 18 x 18 2.861, 12 x 256 2.706)
HORNER_SHAPE = {1: (6, 192), 2: (18, 256)}
# scan-mul: (threads a team, threads a block) by nc: a team takes a phase's
# products one a thread (6 on G1, the 18 Karatsuba legs on G2), 32 teams a
# block, so that each warp runs one job of 32 elements
MUL_SHAPE = {1: (6, 192), 2: (18, 576)}
SCALAR_BITS = 16 * FR.num_limbs  # the most bits a (16, *batch) scalar stack holds


def _nc(stack: torch.Tensor) -> int:
    """Fp components of a coordinate, read from a `(3 nc, 24, *batch)`
    stack: 1 on G1, 2 on G2."""
    if stack.shape[0] not in (3, 6):
        raise ValueError(f"a point stack has 3 or 6 leaves, got {stack.shape[0]}")
    return stack.shape[0] // 3


def stack_point(pt) -> torch.Tensor:
    """A strict point batch (nested tuples of `(24, *batch)` leaves) -> one
    `(3 nc, 24, *batch)` stack, its leaves in order (x, y, z; re before
    im)."""
    leaves = [x for c in pt for x in (c if isinstance(c, tuple) else (c,))]
    return torch.stack(leaves)


def point_of(stack: torch.Tensor):
    """A `(3 nc, 24, *batch)` stack -> the nested point (fp2 pairs where nc
    = 2), views of the stack."""
    if _nc(stack) == 1:
        return (stack[0], stack[1], stack[2])
    return tuple((stack[2 * k], stack[2 * k + 1]) for k in range(3))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- scan-acc: the bucket accumulation ------------------------------------------

def _tree_get(pt, idx: torch.Tensor):
    """Gather along the trailing bucket axis of every coordinate leaf;
    idx (*batch[:-1], 1) int64."""
    return T.tree_map(lambda x: torch.gather(x, -1, idx[None].expand(x.shape[:-1] + (1,))), pt)


def _tree_put(pt, idx: torch.Tensor, val) -> None:
    """Scatter `val` back along the trailing bucket axis, in place: the
    indices are unique per (lane, window) row, so nothing collides."""
    def put(x, v):
        x.scatter_(-1, idx[None].expand(x.shape[:-1] + (1,)), v.expand(x.shape[:-1] + (1,)))

    T.tree_map(put, pt, val)


def _steps(digits: torch.Tensor, lanes: int) -> int:
    n = digits.shape[-1]
    steps = n // max(lanes, 1)
    if lanes < 1 or steps * lanes != n:
        raise ValueError(f"{n} points do not split into {lanes} lanes")
    return steps


def bucket_accumulate_plain(curve, points, digits: torch.Tensor, lanes: int, c: int):
    """scan-acc's plain version: the per-lane loop accumulating points into
    (lanes, W, B) buckets, B = 2^c.

    points: projective batch, coordinate leaves (24, N); digits: (W, N)
    window digits below B. N must equal lanes * steps; point i belongs to
    lane i mod lanes. Each step gathers the addressed bucket of every
    (lane, window), adds the point to it (bucket first) in ONE batched
    complete addition over the whole front, and scatters the result back;
    a zero digit adds into bucket 0. Returns buckets with batch (lanes, W,
    B)."""
    W = digits.shape[0]
    B = 1 << c
    steps = _steps(digits, lanes)
    dev = digits.device
    # (L, N) -> (steps, L, lanes): step j holds points j*lanes .. j*lanes+lanes-1
    pts = T.tree_map(lambda x: x.reshape(x.shape[0], steps, lanes).movedim(1, 0), points)
    digs = digits.reshape(W, steps, lanes).movedim(1, 0)  # (steps, W, lanes)
    buckets = T.tree_map(lambda x: x.contiguous(), curve.identity((lanes, W, B), dev))
    for j in range(steps):
        idx = digs[j].movedim(0, 1)[..., None].to(torch.int64)  # (lanes, W, 1)
        cur = _tree_get(buckets, idx)  # batch (lanes, W, 1)
        ptb = T.tree_map(lambda x: x[j][..., None, None], pts)  # (L, lanes, 1, 1)
        _tree_put(buckets, idx, curve.add(cur, ptb))
    return buckets


def _int32(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _records(words: torch.Tensor) -> torch.Tensor:
    """(3 nc, 12, n) words -> (n, 36 nc) records, point-major."""
    return words.permute(2, 0, 1).reshape(words.shape[2], -1).contiguous()


def _words_of(records: torch.Tensor) -> torch.Tensor:
    """(n, 36 nc) records -> (3 nc, 12, n) words."""
    return records.reshape(records.shape[0], -1, WD.WORDS).permute(1, 2, 0)


def _nc_of_records(records: torch.Tensor) -> int:
    if records.dim() != 2 or records.shape[1] not in (RECORD, 2 * RECORD):
        raise ValueError(f"word records are (n, {RECORD}) or (n, {2 * RECORD}), "
                         f"got {tuple(records.shape)}")
    return records.shape[1] // RECORD


def point_words_plain(pts: torch.Tensor) -> torch.Tensor:
    """scan-acc's first pass, plain: a `(3 nc, 24, n)` strict limb stack (any
    number below 2^384, taken mod p) -> `(n, 36 nc)` canonical word records,
    point-major (component q at words [12 q, 12 q + 12))."""
    return _records(WD.digits_to_words_plain(WD.limbs_to_digits_plain(pts)))


def point_words(pts: torch.Tensor) -> torch.Tensor:
    """The records of `point_words_plain`: one launch of scan-acc's point
    conversion for CUDA tensors, the plain version for CPU tensors."""
    if pts.dim() != 3 or pts.shape[1] != FP.num_limbs:
        raise ValueError(f"point_words wants a (3 nc, 24, n) stack, got {tuple(pts.shape)}")
    nc = _nc(pts)
    if cpu_operands("point_words", [pts]):
        return point_words_plain(pts)
    n = pts.shape[2]
    pw = torch.empty((n, nc * RECORD), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        KERNEL_WORDS.launch(pts.data_ptr(), pw.data_ptr(), n, nc, _stream(pts))
    return pw


def accumulate_words_plain(curve, pw: torch.Tensor, digits: torch.Tensor, lanes: int, c: int):
    """scan-acc's walk, plain: the `(lanes W B, 36 nc)` word records of the
    buckets of `bucket_accumulate_plain` (the digits taken mod B = 2^c),
    bucket b of (lane l, window w) at record (l W + w) B + b, from the
    points' records `pw` (`point_words`)."""
    _nc_of_records(pw)
    pts = point_of(WD.words_to_limbs_plain(_words_of(pw)))
    bk = bucket_accumulate_plain(curve, pts, digits & ((1 << c) - 1), lanes, c)
    limbs = stack_point(bk).long()  # (3 nc, 24, lanes, W, B)
    words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
    return _records(_int32(words.reshape(words.shape[0], WD.WORDS, -1)))


def accumulate_words(curve, pw: torch.Tensor, digits: torch.Tensor, lanes: int,
                     c: int) -> torch.Tensor:
    """The records of `accumulate_words_plain`: one launch of scan-acc's walk
    for CUDA tensors (a team of threads a (lane, window) stream, at the
    curve's `ACC_SHAPE`; the digits taken mod 2^c), the plain version for
    CPU tensors."""
    nc = _nc_of_records(pw)
    _steps(digits, lanes)
    n, W = pw.shape[0], digits.shape[0]
    if digits.dim() != 2 or digits.shape[1] != n:
        raise ValueError(f"accumulate_words wants (W, {n}) digits, got {tuple(digits.shape)}")
    if not 1 <= c <= 16:
        raise ValueError(f"window c must be in [1, 16], got {c}")
    if cpu_operands("accumulate_words", [pw, digits]):
        return accumulate_words_plain(curve, pw, digits, lanes, c)
    team, block = ACC_SHAPE[nc]
    B = 1 << c
    bk = torch.empty((lanes * W * B, nc * RECORD), dtype=torch.int32, device=pw.device)
    with torch.cuda.device(pw.device):
        KERNEL_ACC.launch(pw.data_ptr(), digits.data_ptr(), bk.data_ptr(), n, lanes, W, B, nc,
                          team, block, _stream(pw))
    return bk


def split_buckets_plain(bk: torch.Tensor, lanes: int, W: int, B: int) -> torch.Tensor:
    """scan-acc's last pass, plain: `(lanes W B, 36 nc)` word records ->
    the `(3 nc, 24, lanes, W, B)` strict limb stack."""
    limbs = WD.words_to_limbs_plain(_words_of(bk))  # (3 nc, 24, E)
    return limbs.reshape(limbs.shape[0], FP.num_limbs, lanes, W, B).contiguous()


def split_buckets(bk: torch.Tensor, lanes: int, W: int, B: int) -> torch.Tensor:
    """The stack of `split_buckets_plain`: one launch of scan-acc's split
    for CUDA tensors, the plain version for CPU tensors."""
    nc = _nc_of_records(bk)
    if bk.shape[0] != lanes * W * B:
        raise ValueError(f"{bk.shape[0]} records are not {lanes} x {W} x {B} buckets")
    if cpu_operands("split_buckets", [bk]):
        return split_buckets_plain(bk, lanes, W, B)
    out = torch.empty((3 * nc, FP.num_limbs, lanes, W, B), dtype=torch.int32,
                      device=bk.device)
    with torch.cuda.device(bk.device):
        KERNEL_SPLIT.launch(bk.data_ptr(), out.data_ptr(), bk.shape[0], nc, _stream(bk))
    return out


def bucket_accumulate(curve, points, digits: torch.Tensor, lanes: int, c: int):
    """The (lanes, W, 2^c) buckets of `bucket_accumulate_plain`: for CUDA
    tensors scan-acc's three launches (`point_words`, `accumulate_words`,
    `split_buckets`; the digits taken mod 2^c), for CPU tensors the plain
    loop."""
    _steps(digits, lanes)
    if not 1 <= c <= 16:
        raise ValueError(f"window c must be in [1, 16], got {c}")
    pts = stack_point(points)
    n, W = digits.shape[-1], digits.shape[0]
    if pts.dim() != 3 or pts.shape[1:] != (FP.num_limbs, n) or digits.dim() != 2:
        raise ValueError(f"bucket_accumulate wants (24, {n}) point leaves and (W, {n}) digits, "
                         f"got {tuple(pts.shape)} and {tuple(digits.shape)}")
    if cpu_operands("bucket_accumulate", [pts, digits]):
        return bucket_accumulate_plain(curve, points, digits, lanes, c)
    bk = accumulate_words(curve, point_words(pts), digits, lanes, c)
    return point_of(split_buckets(bk, lanes, W, 1 << c))


# --- scan-red: the bucket reduction ----------------------------------------------

def bucket_reduce_plain(curve, buckets):
    """scan-red's plain version: (W, B) buckets -> (W,) window sums,
    sum_b b * bucket[b], by the running/total suffix accumulation, highest
    digit first: `running += bucket[b]; total += running`, batched across
    all windows. Bucket 0 is dropped (a zero digit contributes nothing)."""
    leaf = buckets[0][0] if isinstance(buckets[0], tuple) else buckets[0]
    W, B = leaf.shape[1:]
    dev = leaf.device
    # leaves (L, W, B) -> (B-1, L, W), highest digit first
    seq = T.tree_map(lambda x: x[..., 1:].movedim(-1, 0).flip(0), buckets)
    running, total = curve.identity((W,), dev), curve.identity((W,), dev)
    for b in range(B - 1):
        running = curve.add(running, T.tree_map(lambda x: x[b], seq))
        total = curve.add(total, running)
    return total  # batch (W,)


def bucket_reduce(curve, buckets):
    """The (W,) window sums of `bucket_reduce_plain`: one scan-red launch for
    CUDA tensors (a block of threads a window, at the curve's `RED_SHAPE`),
    the plain loop for CPU tensors."""
    bk = stack_point(buckets)
    if bk.dim() != 4 or bk.shape[1] != FP.num_limbs:
        raise ValueError(f"bucket_reduce wants (24, W, B) leaves, got {tuple(bk.shape)}")
    if cpu_operands("bucket_reduce", [bk]):
        return bucket_reduce_plain(curve, buckets)
    W, B = bk.shape[2:]
    nc = _nc(bk)
    out = torch.empty(bk.shape[:3], dtype=torch.int32, device=bk.device)
    with torch.cuda.device(bk.device):
        KERNEL_RED.launch(bk.data_ptr(), out.data_ptr(), W, B, nc, *RED_SHAPE[nc], _stream(bk))
    return point_of(out)


# --- scan-horner: the window reduction ------------------------------------------

def horner_plain(curve, window_sums, c: int):
    """scan-horner's plain version: (W,) window sums -> the result point,
    batch (1,): res = sum_w S_w << (c*w), MSB window first, c doublings
    (of the identity too, at the first window) and one addition a
    window."""
    seq = T.tree_map(lambda x: x.movedim(-1, 0).flip(0)[..., None], window_sums)  # (W, L, 1)
    leaf = seq[0][0] if isinstance(seq[0], tuple) else seq[0]
    acc = curve.identity((1,), leaf.device)
    for w in range(leaf.shape[0]):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, T.tree_map(lambda x: x[w], seq))
    return acc


def horner(curve, window_sums, c: int):
    """The result point of `horner_plain`, batch (1,): one scan-horner launch
    (one block, `HORNER_SHAPE`) for CUDA tensors, the plain loop for CPU
    tensors."""
    sums = stack_point(window_sums)
    if sums.dim() != 3 or sums.shape[1] != FP.num_limbs:
        raise ValueError(f"horner wants (24, W) leaves, got {tuple(sums.shape)}")
    if cpu_operands("horner", [sums]):
        return horner_plain(curve, window_sums, c)
    out = torch.empty((sums.shape[0], FP.num_limbs, 1), dtype=torch.int32, device=sums.device)
    with torch.cuda.device(sums.device):
        KERNEL_HORNER.launch(sums.data_ptr(), out.data_ptr(), sums.shape[2], c, _nc(sums),
                             *HORNER_SHAPE[_nc(sums)], _stream(sums))
    return point_of(out)


# --- scan-mul: the double-and-add ladder ------------------------------------------

def scalar_mul_plain(curve, pt, scalar_limbs, num_bits: int = 255):
    """scan-mul's plain version: per-element double-and-add over batch
    scalars (plain Fr limbs, stacked (16, *batch)), MSB first, branch-free:
    every step doubles, adds and selects (the JAX `lax.scan` as a Python
    loop)."""
    f = curve.f
    acc = curve.identity(f.batch_shape(pt[0]), f.device(pt[0]))
    for j in range(num_bits - 1, -1, -1):
        bit = (scalar_limbs[j // 16] >> (j % 16)) & 1
        acc = curve.double(acc)
        acc = T.select(bit == 1, curve.add(acc, pt), acc)
    return acc


def scalar_mul(curve, pt, scalar_limbs: torch.Tensor, num_bits: int = 255):
    """The points of `scalar_mul_plain`: one scan-mul launch for CUDA tensors
    (a team of threads an element, the curve's `MUL_SHAPE`; point and
    scalar batches broadcast), the plain loop for CPU tensors."""
    leaves = [x for c in pt for x in (c if isinstance(c, tuple) else (c,))]
    if leaves[0].dim() < 2 or leaves[0].shape[0] != FP.num_limbs:
        raise ValueError(f"scalar_mul wants (24, *batch) leaves, got {tuple(leaves[0].shape)}")
    if scalar_limbs.dim() < 2 or scalar_limbs.shape[0] != FR.num_limbs:
        raise ValueError(f"scalar_mul wants (16, *batch) scalar limbs, got "
                         f"{tuple(scalar_limbs.shape)}")
    if not 0 <= num_bits <= SCALAR_BITS:
        raise ValueError(f"num_bits must be in [0, {SCALAR_BITS}], got {num_bits}")
    if all(t.device.type == "cpu" for t in (*leaves, scalar_limbs)):
        cpu_operands("scalar_mul", [*leaves, scalar_limbs])  # int32 only
        return scalar_mul_plain(curve, pt, scalar_limbs, num_bits)
    pts = torch.stack(leaves)
    batch = torch.broadcast_shapes(pts.shape[2:], scalar_limbs.shape[1:])
    x = pts.expand(pts.shape[:2] + batch).reshape(pts.shape[0], FP.num_limbs, -1).contiguous()
    sc = scalar_limbs.expand(scalar_limbs.shape[:1] + batch).reshape(FR.num_limbs, -1)
    sc = sc.contiguous()
    cpu_operands("scalar_mul", [x, sc])  # raises unless both lie on one card
    nc = _nc(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL_MUL.launch(x.data_ptr(), sc.data_ptr(), out.data_ptr(), x.shape[2], num_bits, nc,
                          *MUL_SHAPE[nc], _stream(x))
    return point_of(out.reshape(x.shape[:2] + batch))
