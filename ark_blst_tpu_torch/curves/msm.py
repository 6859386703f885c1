"""MSM helpers shared by the drivers: window digits, padding, cancellation.

Counterparts of `window_digits`, `window_digits_signed`, `_pad_inputs` and
`MsmAborted` in `ark_blst_tpu/curves/msm.py`.
"""

from __future__ import annotations

import torch

from ..ops.limbs import FR, LIMB_BITS
from .group import g1_identity, g2_identity

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
