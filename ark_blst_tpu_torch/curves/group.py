"""G1 points in the strict radix-16 layout: the projective identity."""

from __future__ import annotations

import torch

from ..ops.limbs import FP, int_to_limbs


def g1_identity(n: int, device="cpu"):
    """Strict projective identity (0 : 1 : 0) in Montgomery-R16 form, batch
    (n,): three `(24, n)` int32 limb tensors."""
    zero = torch.zeros((FP.num_limbs, n), dtype=torch.int32, device=device)
    one = torch.from_numpy(int_to_limbs(FP.mont_r, FP.num_limbs)).to(device)
    return (zero, one[:, None].expand(-1, n).contiguous(), zero.clone())
