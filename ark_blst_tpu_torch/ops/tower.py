"""The strict engine's Fp and Fp2 layer (batched, Montgomery form).

Counterpart of `ark_blst_tpu/ops/tower.py:38-152`: an fp batch is a stacked
`(24, *batch)` int32 limb tensor, an fp2 batch a pair of them (c0, c1) for
c0 + c1 u, u^2 = -1. Every fp2 product gathers its base-field products into
one K7 launch (`fp_mul_many`). This is what the G2 group law needs; the
fp6/fp12 levels, Frobenius and the cyclotomic square come with the strict
pairing that uses them.
"""

from __future__ import annotations

import torch

from ..oracle import field as OF
from . import dispatch as D
from . import fieldops as FO
from .limbs import FP

_P = OF.P
_MONT_R = FP.mont_r


# --- constants ---------------------------------------------------------------

def fp_const(value: int, batch_shape, device):
    """Plain integer constant -> Montgomery stacked batch (a broadcast view)."""
    return FO.consts(value * _MONT_R % _P, batch_shape, FP, device)


def fp2_const(c, batch_shape, device):
    return (fp_const(c[0], batch_shape, device), fp_const(c[1], batch_shape, device))


# --- fp helpers (thin wrappers over dispatch) --------------------------------

fp_add = D.fp_add
fp_sub = D.fp_sub
fp_neg = D.fp_neg
fp_mul = D.fp_mul
fp_mul_many = D.fp_mul_many
fp_mul_small = D.fp_mul_small


# --- fp2 ---------------------------------------------------------------------

def fp2_add(a, b):
    return (fp_add(a[0], b[0]), fp_add(a[1], b[1]))


def fp2_sub(a, b):
    return (fp_sub(a[0], b[0]), fp_sub(a[1], b[1]))


def fp2_neg(a):
    return (fp_neg(a[0]), fp_neg(a[1]))


def fp2_conj(a):
    return (a[0], fp_neg(a[1]))


def fp2_mul_small(a, k: int):
    return (fp_mul_small(a[0], k), fp_mul_small(a[1], k))


def fp2_mul_by_nonresidue(a):
    """xi = 1 + u:  (c0 - c1, c0 + c1)."""
    return (fp_sub(a[0], a[1]), fp_add(a[0], a[1]))


def fp2_mul_many(pairs):
    """Karatsuba: 3 base products per fp2 product, all in one K7 launch."""
    legs = []
    for a, b in pairs:
        legs += [
            (a[0], b[0]),
            (a[1], b[1]),
            (fp_add(a[0], a[1]), fp_add(b[0], b[1])),
        ]
    prods = fp_mul_many(legs)
    out = []
    for i in range(len(pairs)):
        m0, m1, m2 = prods[3 * i : 3 * i + 3]
        out.append((fp_sub(m0, m1), fp_sub(fp_sub(m2, m0), m1)))
    return out


def fp2_mul(a, b):
    return fp2_mul_many([(a, b)])[0]


def fp2_sqr_many(items):
    """(a0+a1)(a0-a1), a0*a1 -> 2 base products per square."""
    legs = []
    for a in items:
        legs += [(fp_add(a[0], a[1]), fp_sub(a[0], a[1])), (a[0], a[1])]
    prods = fp_mul_many(legs)
    out = []
    for i in range(len(items)):
        s0, s1 = prods[2 * i : 2 * i + 2]
        out.append((s0, fp_add(s1, s1)))
    return out


def fp2_sqr(a):
    return fp2_sqr_many([a])[0]


def fp2_inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2); one batched Fermat inversion."""
    n0, n1 = fp_mul_many([(a[0], a[0]), (a[1], a[1])])
    norm = fp_add(n0, n1)
    inv = D.fp_inv(norm, FP)
    c0, c1 = fp_mul_many([(a[0], inv), (a[1], inv)])
    return (c0, fp_neg(c1))


def fp2_eq(a, b):
    return FO.eq(a[0], b[0]) & FO.eq(a[1], b[1])


def fp2_is_zero(a):
    return FO.is_zero(a[0]) & FO.is_zero(a[1])


# --- pytree helpers ------------------------------------------------------------

def tree_map(fn, *trees):
    """Apply fn leafwise over equally nested tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def select(mask: torch.Tensor, a, b):
    """Elementwise select over any tower pytree; mask is batch-shaped."""
    return tree_map(lambda x, y: FO.select(mask, x, y), a, b)
