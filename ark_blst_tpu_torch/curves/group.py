"""G1 and G2 points in the strict radix-16 layout: the projective identities."""

from __future__ import annotations

import torch

from ..ops.limbs import FP, int_to_limbs


def _zero_one(n: int, device):
    zero = torch.zeros((FP.num_limbs, n), dtype=torch.int32, device=device)
    one = torch.from_numpy(int_to_limbs(FP.mont_r, FP.num_limbs)).to(device)
    return zero, one[:, None].expand(-1, n).contiguous()


def g1_identity(n: int, device="cpu"):
    """Strict projective identity (0 : 1 : 0) in Montgomery-R16 form, batch
    (n,): three `(24, n)` int32 limb tensors."""
    zero, one = _zero_one(n, device)
    return (zero, one, zero.clone())


def g2_identity(n: int, device="cpu"):
    """Strict projective identity over Fp2, batch (n,): x = (0, 0),
    y = (R16 mod p, 0), z = (0, 0), each component a `(24, n)` int32 limb
    tensor."""
    zero, one = _zero_one(n, device)
    return ((zero, zero.clone()), (one, zero.clone()), (zero.clone(), zero.clone()))
