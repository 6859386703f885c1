"""Strict radix-16 limb layout: field parameters and host int <-> limb codecs.

A strict field element is stored as little-endian 16-bit limbs, limb axis
first: `(L, *batch)` with L = 24 for Fp and 16 for Fr. The port keeps them
as int32 tensors (every limb is < 2^16), since PyTorch supports few ops on
uint32.

The JAX package's array-layout engine (`ark_blst_tpu/ops/limbs.py`
`normalize` .. `inv_mod`) is not ported: it exists there only to keep
XLA:CPU compiles short. The port's strict engine is `fieldops.py`, whose
functions are also the plain versions of the strict kernels
(`strict_field.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..oracle.field import P as _P, R as _R

LIMB_BITS = 16
MASK = 0xFFFF


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Host: int -> little-endian 16-bit limbs (int32)."""
    if not 0 <= x < 1 << (LIMB_BITS * num_limbs):
        raise ValueError(f"{x} does not fit in {num_limbs} limbs")
    return np.array(
        [(x >> (LIMB_BITS * i)) & MASK for i in range(num_limbs)], dtype=np.int32
    )


def limbs_to_int(a) -> int:
    """Host: little-endian 16-bit limbs -> int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a.reshape(-1)))


def ints_to_limbs(xs, num_limbs: int) -> np.ndarray:
    """Host: iterable of ints -> (N, L) int32 limb matrix."""
    xs = list(xs)
    if not xs:
        return np.zeros((0, num_limbs), np.int32)
    return np.stack([int_to_limbs(int(x), num_limbs) for x in xs])


def limbs_to_ints(a) -> list:
    """Host: (N, L) limb matrix -> list of ints."""
    a = np.asarray(a)
    return [limbs_to_int(row) for row in a.reshape(-1, a.shape[-1])]


@dataclass(frozen=True)
class FieldSpec:
    """Montgomery parameters of one prime field in the strict layout."""

    name: str
    modulus: int
    num_limbs: int
    mont_r: int = field(init=False)
    mont_r2: int = field(init=False)
    ninv: int = field(init=False)  # (-modulus^-1) mod R, full width

    def __post_init__(self):
        r_mod = 1 << (LIMB_BITS * self.num_limbs)
        if not self.modulus < r_mod // 2:
            raise ValueError("need headroom: 2p < R")
        object.__setattr__(self, "mont_r", r_mod % self.modulus)
        object.__setattr__(self, "mont_r2", self.mont_r**2 % self.modulus)
        object.__setattr__(self, "ninv", (-pow(self.modulus, -1, r_mod)) % r_mod)


FP = FieldSpec("fp", _P, 24)  # 384 bits of limbs for the 381-bit field
FR = FieldSpec("fr", _R, 16)  # 256 bits of limbs for the 255-bit field
