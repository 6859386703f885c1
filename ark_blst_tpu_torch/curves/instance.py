"""G1 and G2 MSM instances with a known answer, built on the device.

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
from ..oracle.field import G1_GEN, G2_GEN, P, R
from . import lazy_group as LG
from . import msm_bucket as MB

IDENTITY_AT = 5
ZERO_SCALAR_AT = 7

# per curve: generator, oracle add and scalar multiple, lazy field adapter,
# kernel layout, and the pairwise additions per device batch (a G2 addition
# holds ~3x the wide products of a G1 one: 2^18 keeps its largest
# intermediate near 1 GB)
_CURVES = {
    "g1": (G1_GEN, OC.add, OC.scalar_mul, LG.FP_LAZY, MB.KC2_G1, 1 << 20),
    "g2": (G2_GEN, OC.g2_add, OC.g2_mul, LG.FP2_LAZY, MB.KC2_G2, 1 << 18),
}


def _progression(rng: random.Random, count: int, gen, add, mul):
    """count points k*gen for k = k0, k0 + dk, ...: (dlogs, affine points)."""
    k0, dk = rng.randrange(1, R), rng.randrange(1, R)
    p, dp = mul(gen, k0), mul(gen, dk)
    ks, pts = [], []
    for i in range(count):
        ks.append((k0 + i * dk) % R)
        pts.append(p)
        p = add(p, dp)
    return ks, pts


def _enc(vals, device):
    """ints mod p -> balanced R13 digits (30, n) on `device`."""
    mat = np.stack([MB.int_to_digits_balanced(v * LZ.R13 % P) for v in vals]).T
    return torch.from_numpy(np.ascontiguousarray(mat)).to(device)


def _lazy_affine(pts, g2: bool, device):
    """Affine points -> lazy projective (x, y, 1), balanced R13 digits."""
    if not g2:
        return (_enc([p[0] for p in pts], device), _enc([p[1] for p in pts], device),
                _enc([1] * len(pts), device))

    def enc2(vals):
        return (_enc([v[0] for v in vals], device), _enc([v[1] for v in vals], device))

    return (enc2([p[0] for p in pts]), enc2([p[1] for p in pts]), enc2([(1, 0)] * len(pts)))


def distinct_bases(log_n: int, seed: int, device, curve: str = "g1"):
    """Returns (points, scalars, expected): strict Montgomery-R16 projective
    coordinates (24, n) each (G2: a pair per coordinate) and (16, n) scalar
    limbs (< 2^254) on `device`, and the expected affine result."""
    gen, add, mul, f, kc, batch = _CURVES[curve]
    n = 1 << log_n
    nA, nB = 1 << (log_n // 2), 1 << (log_n - log_n // 2)
    rng = random.Random(seed)
    a, A = _progression(rng, nA, gen, add, mul)
    b, B = _progression(rng, nB, gen, add, mul)
    A, B = _lazy_affine(A, kc.is_g2, device), _lazy_affine(B, kc.is_g2, device)
    comps = [torch.empty((24, n), dtype=torch.int32, device=device) for _ in range(kc.n_fp)]
    rows = max(1, batch // nB)
    for lo in range(0, nA, rows):
        hi = min(nA, lo + rows)
        Ar = MB._tree_map(lambda x: x[:, lo:hi].repeat_interleave(nB, dim=1), A)
        Bt = MB._tree_map(lambda x: x.repeat(1, hi - lo), B)
        strict = MB._to_strict_stacked(kc, LG.full_add(f, Ar, Bt))
        for k in range(kc.n_fp):
            comps[k][:, lo * nB : hi * nB] = strict[k]
    for comp, ident in zip(comps, kc.components(kc.identity(1, device))):
        comp[:, IDENTITY_AT : IDENTITY_AT + 1] = ident
    points = kc.nest(comps)

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
    expected = mul(gen, total % R)
    scalars = torch.from_numpy(scs.astype(np.int32)).to(device)
    return points, scalars, expected
