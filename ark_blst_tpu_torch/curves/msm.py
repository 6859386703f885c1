"""The strict engine's scan Pippenger MSM, and the MSM helpers shared by the
drivers (window digits, padding, cancellation).

Counterpart of `ark_blst_tpu/curves/msm.py`: `window_digits`,
`window_digits_signed`, `_pad_inputs`, `MsmAborted`, and the single-device
scan pipeline `msm` with `msm_naive`, on the RCB15 group law of
`curves/group.py` (every field op K7-K10 on the card):

* bucket accumulation: a loop over per-lane point streams; each step
  gathers the addressed bucket of every (lane, window), does ONE batched
  complete addition over the whole (lanes x windows) front, and scatters
  the result back;
* lane reduction: log2(lanes) halving rounds of batched additions;
* bucket reduction: running/total suffix sums over the 2^c - 1 nonzero
  buckets, batched across windows;
* window reduction: Horner (c doublings and one addition per window) on a
  batch of one.

The JAX `use_jit`/`fuse` switch collapses to the eager branch of its
`_scan`: PyTorch runs eagerly, one launch per field op. `msm_sharded`,
`msm_auto` and its planner are not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import tower as T
from ..ops.limbs import FR, LIMB_BITS
from .group import G1, CurveOps, g1_identity, g2_identity

SCALAR_BITS = FR.num_limbs * LIMB_BITS  # 256


class MsmAborted(RuntimeError):
    """Raised when a `maybe_abort` callback requests cancellation between
    chunks."""


def window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(16, N) plain Fr limbs (int32) -> (W, N) window digits, W = ceil(256/c).
    Digit j spans bits [j*c, j*c + c), possibly straddling a limb boundary
    (the high limb is then shifted by at most 14 bits: < 2^30, int32-safe)."""
    if not 1 <= c <= LIMB_BITS:
        raise ValueError(f"window c must be in [1, 16], got {c}")
    W = (SCALAR_BITS + c - 1) // c
    mask = (1 << c) - 1
    digs = []
    for j in range(W):
        k, off = divmod(j * c, LIMB_BITS)
        d = scalars[k] >> off
        if off + c > LIMB_BITS and k + 1 < FR.num_limbs:
            d = d | (scalars[k + 1] << (LIMB_BITS - off))
        digs.append(d & mask)
    return torch.stack(digs)


def window_digits_signed(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(16, N) plain Fr limbs -> (W, N) SIGNED window digits packed as
    `magnitude | (sign << 15)`, magnitude in [0, 2^(c-1)], W = ceil(256/c).

    raw_j + k_j = d_j + 2^c * k_{j+1} with d_j in [-2^(c-1), 2^(c-1)], the
    point conditionally negated instead of a second half of buckets.

    PRECONDITION: scalars < 2^255 (any scalar reduced mod r qualifies): the
    top raw digit plus its carry then stays <= 2^(c-1), so the final carry
    is provably zero and no carry window is needed."""
    if not 2 <= c <= LIMB_BITS - 1:
        raise ValueError(f"signed window c must be in [2, 15], got {c}")
    raw = window_digits(scalars, c)
    half, full = 1 << (c - 1), 1 << c
    digs = []
    carry = torch.zeros_like(raw[0])
    for j in range(raw.shape[0]):
        d = raw[j] + carry  # <= 2^c
        neg = d > half  # use the negative digit d - 2^c
        mag = torch.where(neg, full - d, d)
        carry = neg.to(torch.int32)
        digs.append(mag | (carry << 15))
    return torch.stack(digs)


def _cat_points(a, b):
    """Concatenate two strict point batches (nested tuples of limb tensors)
    along the batch axis."""
    if isinstance(a, tuple):
        return tuple(_cat_points(x, y) for x, y in zip(a, b))
    return torch.cat([a, b], dim=-1)


def _pad_inputs(curve: str, points, scalars: torch.Tensor, multiple: int):
    """Pad the point axis to a multiple with (identity, scalar 0) pairs of
    the curve ("g1" or "g2"): zero digits land in the dropped bucket 0."""
    n = scalars.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return points, scalars
    identity = {"g1": g1_identity, "g2": g2_identity}[curve]
    points = _cat_points(points, identity(pad, scalars.device))
    scalars = torch.nn.functional.pad(scalars, (0, pad))
    return points, scalars


# --- the scan pipeline ---------------------------------------------------------

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


def _bucket_accumulate(curve: CurveOps, points, digits: torch.Tensor, lanes: int, c: int):
    """Per-lane loop accumulating points into (lanes, W, B) buckets.

    points: projective batch, coordinate leaves (L, N); digits: (W, N). N
    must equal lanes * steps; point i belongs to lane i mod lanes. Returns
    buckets with batch (lanes, W, B), B = 2^c."""
    W = digits.shape[0]
    B = 1 << c
    n = digits.shape[-1]
    steps = n // lanes
    if steps * lanes != n:
        raise ValueError(f"{n} points do not split into {lanes} lanes")
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


def _fold_axis(curve: CurveOps, pt, axis_size: int):
    """Log-depth tree reduction of the leading batch axis (size a power of 2)."""
    if axis_size & (axis_size - 1):
        raise ValueError(f"axis size {axis_size} is not a power of two")
    while axis_size > 1:
        half = axis_size // 2
        lo = T.tree_map(lambda x: x[:, :half], pt)
        hi = T.tree_map(lambda x: x[:, half:], pt)
        pt = curve.add(lo, hi)
        axis_size = half
    return T.tree_map(lambda x: x[:, 0], pt)


def _bucket_reduce(curve: CurveOps, buckets):
    """(W, B) buckets -> (W,) window sums: sum_b b * bucket[b].

    Running/total suffix accumulation, highest digit first:
    `running += bucket[b]; total += running`, batched across all windows.
    Bucket 0 is dropped (a zero digit contributes nothing)."""
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


def _horner(curve: CurveOps, window_sums, c: int):
    """(W,) window sums -> the result point, batch (1,):
    res = sum_w S_w << (c*w), MSB window first."""
    seq = T.tree_map(lambda x: x.movedim(-1, 0).flip(0)[..., None], window_sums)  # (W, L, 1)
    leaf = seq[0][0] if isinstance(seq[0], tuple) else seq[0]
    acc = curve.identity((1,), leaf.device)
    for w in range(leaf.shape[0]):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, T.tree_map(lambda x: x[w], seq))
    return acc


def _msm_local(curve: CurveOps, points, scalars: torch.Tensor, c: int, lanes: int):
    """Single-device MSM up to the window sums: returns (W,)-batched partials."""
    lanes = min(lanes, max(1, scalars.shape[-1]))
    lanes = 1 << (lanes.bit_length() - 1)  # round down to a power of two
    points, scalars = _pad_inputs(curve.name, points, scalars, lanes)
    digits = window_digits(scalars, c)
    buckets = _bucket_accumulate(curve, points, digits, lanes, c)
    buckets = _fold_axis(curve, buckets, lanes)  # batch (W, B)
    return _bucket_reduce(curve, buckets)  # batch (W,)


def _to_device(points, scalars, device):
    dev = resolve_device(device)
    return T.tree_map(lambda x: x.to(dev, torch.int32), points), scalars.to(dev, torch.int32)


def msm(points, scalars, curve: CurveOps = G1, c: int = 8, lanes: int = 1024, *,
        device="cuda"):
    """Single-device scan Pippenger MSM on the strict engine.

    points: strict projective batch (coordinate leaves (24, N); identity
    points allowed); scalars: (16, N) plain (non-Montgomery) Fr limbs.
    Returns the strict projective result with batch shape (1,), on
    `device`. c = 8 is the JAX package's default. lanes defaults to 1024,
    not the JAX package's 128 (a TPU tile): the accumulation takes N/lanes
    sequential steps of launch-bound batched additions, so wider lanes
    shorten it at the price of (lanes, W, 2^c) buckets in memory."""
    points, scalars = _to_device(points, scalars, device)
    return _horner(curve, _msm_local(curve, points, scalars, c, lanes), c)


def msm_naive(points, scalars, curve: CurveOps = G1, *, device="cuda"):
    """Differential baseline: per-point `scalar_mul`, then a log fold."""
    points, scalars = _to_device(points, scalars, device)
    n = scalars.shape[-1]
    prods = curve.scalar_mul(points, scalars, num_bits=SCALAR_BITS)
    size = 1 << (n - 1).bit_length()
    if size != n:
        prods = _cat_points(prods, curve.identity((size - n,), scalars.device))
    while size > 1:
        half = size // 2
        lo = T.tree_map(lambda x: x[..., :half], prods)
        hi = T.tree_map(lambda x: x[..., half:], prods)
        prods = curve.add(lo, hi)
        size = half
    return prods  # batch (1,)
