"""Strict-engine helpers over stacked limb tensors `(L, *batch)`.

Only the subset the lazy engine's `canonicalize` and the MSM prepare stage
need: exact carry normalization and the zero test.
"""

from __future__ import annotations

import torch

from .limbs import LIMB_BITS, MASK


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Move every row d places up the leading axis, zero-filling the bottom."""
    out = torch.zeros_like(x)
    out[d:] = x[:-d]
    return out


def normalize_list(t: torch.Tensor, out_len: int) -> torch.Tensor:
    """Relaxed nonnegative digits (values < 2^31), stacked `(n, *batch)` int32
    -> strict 16-bit digits `(out_len, *batch)` of the same value, truncated
    mod 2^(16*out_len).

    One digit fold (a < 2^16 plus b < 2^15 per digit), then a Kogge-Stone
    carry lookahead: log2(width) rounds of whole-tensor ops, no ripple.
    """
    n = t.shape[0]
    width = max(n + 1, out_len)
    batch = t.shape[1:]
    s = torch.zeros((width,) + batch, dtype=torch.int32, device=t.device)
    s[:n] = t & MASK
    s[1 : n + 1] += t >> LIMB_BITS  # digit sums < 2^16 + 2^15
    g = s >> LIMB_BITS  # generate: 0 or 1
    p = (s & MASK) == MASK  # propagate
    d = 1
    while d < width:
        g = g | torch.where(p, _shift_up(g, d), 0)
        p = p & _shift_up(p, d)
        d *= 2
    return (s[:out_len] + _shift_up(g, 1)[:out_len]) & MASK


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """`(L, *batch)` limbs -> `batch`-shaped bool: every limb is zero."""
    return (a == 0).all(dim=0)
