"""A G1 MSM instance with a known answer, built on the device.

n = 2^log_n DISTINCT bases A_i + B_j from two sets of 2^(log_n/2) points
with known discrete logs (a_i, b_j in arithmetic progressions), added with
the port's `full_add` on the device; the expected result
gen * sum_ij r_ij (a_i + b_j) needs only row and column sums of the scalar
matrix, O(sqrt(n)) host work. The construction of the JAX package's
`bench.py:_random_msm_instance`. Point 5 is the identity and scalar 7 is
zero, so both edge cases ride in every instance.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..ops import lazy13 as LZ
from ..oracle import curve as OC
from ..oracle.field import G1_GEN, P, R
from . import lazy_group as LG
from . import msm_bucket as MB
from .group import g1_identity

IDENTITY_AT = 5
ZERO_SCALAR_AT = 7


def _progression(rng: random.Random, count: int):
    """count points k*G for k = k0, k0 + dk, ...: (dlogs, affine points)."""
    k0, dk = rng.randrange(1, R), rng.randrange(1, R)
    p, dp = OC.scalar_mul(G1_GEN, k0), OC.scalar_mul(G1_GEN, dk)
    ks, pts = [], []
    for i in range(count):
        ks.append((k0 + i * dk) % R)
        pts.append(p)
        p = OC.add(p, dp)
    return ks, pts


def _lazy_affine(pts, device):
    """Affine points -> lazy projective (x, y, 1), balanced R13 digits."""
    def enc(vals):
        mat = np.stack([MB.int_to_digits_balanced(v * LZ.R13 % P) for v in vals]).T
        return torch.from_numpy(np.ascontiguousarray(mat)).to(device)

    return (enc([p[0] for p in pts]), enc([p[1] for p in pts]), enc([1] * len(pts)))


def distinct_bases(log_n: int, seed: int, device):
    """Returns (points, scalars, expected): strict Montgomery-R16 projective
    coordinates (24, n) each and (16, n) scalar limbs (< 2^254) on `device`,
    and the expected affine result."""
    n = 1 << log_n
    nA, nB = 1 << (log_n // 2), 1 << (log_n - log_n // 2)
    rng = random.Random(seed)
    a, A = _progression(rng, nA)
    b, B = _progression(rng, nB)
    A, B = _lazy_affine(A, device), _lazy_affine(B, device)
    coords = [torch.empty((24, n), dtype=torch.int32, device=device) for _ in range(3)]
    rows = max(1, (1 << 20) // nB)  # ~2^20 additions per device batch
    for lo in range(0, nA, rows):
        hi = min(nA, lo + rows)
        Ar = tuple(x[:, lo:hi].repeat_interleave(nB, dim=1) for x in A)
        Bt = tuple(x.repeat(1, hi - lo) for x in B)
        strict = MB._to_strict_stacked(LG.full_add(LG.FP_LAZY, Ar, Bt))
        for k in range(3):
            coords[k][:, lo * nB : hi * nB] = strict[k]
    ident = g1_identity(1, device)
    for k in range(3):
        coords[k][:, IDENTITY_AT : IDENTITY_AT + 1] = ident[k]

    scs = np.random.default_rng(seed).integers(0, 1 << 16, (16, n), dtype=np.int64)
    scs[15] &= 0x3FFF  # < 2^254 < r
    scs[:, ZERO_SCALAR_AT] = 0
    weight = scs.reshape(16, nA, nB).copy()
    weight[:, IDENTITY_AT // nB, IDENTITY_AT % nB] = 0  # the identity adds nothing
    rsum, csum = weight.sum(axis=2), weight.sum(axis=1)
    total = 0
    for i in range(nA):
        total += a[i] * sum(int(rsum[k, i]) << (16 * k) for k in range(16))
    for j in range(nB):
        total += b[j] * sum(int(csum[k, j]) << (16 * k) for k in range(16))
    expected = OC.scalar_mul(G1_GEN, total % R)
    scalars = torch.from_numpy(scs.astype(np.int32)).to(device)
    return tuple(coords), scalars, expected
