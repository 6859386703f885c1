"""The strict engine's Fp2/Fp6/Fp12 tower (batched, Montgomery form).

Counterpart of `ark_blst_tpu/ops/tower.py`, op for op: an fp batch is a
stacked `(24, *batch)` int32 limb tensor, and
  fp2  = (c0, c1)        of fp batches, c0 + c1 u, u^2 = -1
  fp6  = (a0, a1, a2)    of fp2, over v, v^3 = xi = 1 + u
  fp12 = (b0, b1)        of fp6, over w, w^2 = v
Every value is canonical, so every output equals the JAX tower's limb for
limb. Every product gathers its base-field products into one K7 launch
(`fp_mul_many`); every add, sub and negation is one K8, K9 or K10 launch
(`ops/dispatch.py`). The G2 group law uses the fp2 level, the strict
pairing (`curves/pairing.py`, `engine="strict"`) all of it.
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


# --- fp6 ---------------------------------------------------------------------

def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul_by_nonresidue(a):
    """v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_mul_many(pairs):
    """6 fp2 products per product (Karatsuba/Toom interpolation)."""
    legs = []
    for a, b in pairs:
        a0, a1, a2 = a
        b0, b1, b2 = b
        legs += [
            (a0, b0),
            (a1, b1),
            (a2, b2),
            (fp2_add(a1, a2), fp2_add(b1, b2)),
            (fp2_add(a0, a1), fp2_add(b0, b1)),
            (fp2_add(a0, a2), fp2_add(b0, b2)),
        ]
    prods = fp2_mul_many(legs)
    out = []
    for i in range(len(pairs)):
        v0, v1, v2, m12, m01, m02 = prods[6 * i : 6 * i + 6]
        c0 = fp2_add(v0, fp2_mul_by_nonresidue(fp2_sub(fp2_sub(m12, v1), v2)))
        c1 = fp2_add(fp2_sub(fp2_sub(m01, v0), v1), fp2_mul_by_nonresidue(v2))
        c2 = fp2_add(fp2_sub(fp2_sub(m02, v0), v2), v1)
        out.append((c0, c1, c2))
    return out


def fp6_mul(a, b):
    return fp6_mul_many([(a, b)])[0]


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_01_many(items):
    """[(a, b0, b1)] -> a * (b0 + b1 v), sparse: six fp2 products (the JAX
    docstring says five; its code forms six, and so does this)."""
    legs = []
    for a, b0, b1 in items:
        a0, a1, a2 = a
        legs += [(a0, b0), (a1, b0), (a2, b0), (a2, b1), (a0, b1), (a1, b1)]
    prods = fp2_mul_many(legs)
    out = []
    for i in range(len(items)):
        t00, t10, t20, t21, t01, t11 = prods[6 * i : 6 * i + 6]
        out.append((
            fp2_add(t00, fp2_mul_by_nonresidue(t21)),
            fp2_add(t01, t10),
            fp2_add(t11, t20),
        ))
    return out


def fp6_mul_by_1_many(items):
    """[(a, b1)] -> a * (b1 v), sparse: 3 fp2 products."""
    legs = []
    for a, b1 in items:
        legs += [(a[2], b1), (a[0], b1), (a[1], b1)]
    prods = fp2_mul_many(legs)
    out = []
    for i in range(len(items)):
        t2, t0, t1 = prods[3 * i : 3 * i + 3]
        out.append((fp2_mul_by_nonresidue(t2), t0, t1))
    return out


def fp6_inv(a):
    a0, a1, a2 = a
    s0, s1, s2 = fp2_sqr_many([a0, a2, a1])  # a0^2, a2^2, a1^2
    m01, m12, m02 = fp2_mul_many([(a0, a1), (a1, a2), (a0, a2)])
    c0 = fp2_sub(s0, fp2_mul_by_nonresidue(m12))
    c1 = fp2_sub(fp2_mul_by_nonresidue(s1), m01)
    c2 = fp2_sub(s2, m02)
    t0, t1, t2 = fp2_mul_many([(a0, c0), (a2, c1), (a1, c2)])
    t = fp2_add(t0, fp2_mul_by_nonresidue(fp2_add(t1, t2)))
    tinv = fp2_inv(t)
    r0, r1, r2 = fp2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)])
    return (r0, r1, r2)


def fp6_eq(a, b):
    return fp2_eq(a[0], b[0]) & fp2_eq(a[1], b[1]) & fp2_eq(a[2], b[2])


# --- fp12 --------------------------------------------------------------------

def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_conj(a):
    """Conjugation = the inverse on the cyclotomic subgroup."""
    return (a[0], fp6_neg(a[1]))


def fp12_mul_many(pairs):
    """Karatsuba: 3 fp6 products = 18 fp2 products = 54 base products, one
    K7 launch."""
    legs = []
    for a, b in pairs:
        legs += [
            (a[0], b[0]),
            (a[1], b[1]),
            (fp6_add(a[0], a[1]), fp6_add(b[0], b[1])),
        ]
    prods = fp6_mul_many(legs)
    out = []
    for i in range(len(pairs)):
        t0, t1, t2 = prods[3 * i : 3 * i + 3]
        c0 = fp6_add(t0, fp6_mul_by_nonresidue(t1))
        c1 = fp6_sub(fp6_sub(t2, t0), t1)
        out.append((c0, c1))
    return out


def fp12_mul(a, b):
    return fp12_mul_many([(a, b)])[0]


def fp12_sqr(a):
    """Complex squaring: 2 fp6 products."""
    t, m = fp6_mul_many(
        [(a[0], a[1]), (fp6_add(a[0], a[1]), fp6_add(a[0], fp6_mul_by_nonresidue(a[1])))]
    )
    c0 = fp6_sub(fp6_sub(m, t), fp6_mul_by_nonresidue(t))
    c1 = fp6_add(t, t)
    return (c0, c1)


def fp12_inv(a):
    s0, s1 = fp6_mul_many([(a[0], a[0]), (a[1], a[1])])
    t = fp6_sub(s0, fp6_mul_by_nonresidue(s1))
    tinv = fp6_inv(t)
    c0, c1 = fp6_mul_many([(a[0], tinv), (a[1], tinv)])
    return (c0, fp6_neg(c1))


def fp12_mul_by_014_many(items):
    """[(f, c0, c1, c4)] -> f * ((c0 + c1 v) + (c4 v) w): the sparse line
    product of the Miller loop, from the sparse fp6 products."""
    aa = fp6_mul_by_01_many([(f[0], c0, c1) for f, c0, c1, c4 in items])
    bb = fp6_mul_by_1_many([(f[1], c4) for f, c0, c1, c4 in items])
    mid = fp6_mul_by_01_many(
        [(fp6_add(f[0], f[1]), c0, fp2_add(c1, c4)) for f, c0, c1, c4 in items]
    )
    out = []
    for i in range(len(items)):
        nf1 = fp6_sub(fp6_sub(mid[i], aa[i]), bb[i])
        nf0 = fp6_add(fp6_mul_by_nonresidue(bb[i]), aa[i])
        out.append((nf0, nf1))
    return out


def fp12_eq(a, b):
    return fp6_eq(a[0], b[0]) & fp6_eq(a[1], b[1])


def fp12_one(batch_shape, device):
    """fp12 one: the one is a broadcast view (`fp_const`), the zeros a
    tensor; neither may be written in place."""
    one = fp_const(1, batch_shape, device)
    zero = FO.zeros(batch_shape, FP, device)
    z2 = (zero, zero)
    return (((one, zero), z2, z2), (z2, z2, z2))


# --- Frobenius ---------------------------------------------------------------

def fp2_frobenius(a, power: int):
    return a if power % 2 == 0 else fp2_conj(a)


def fp6_frobenius(a, power: int):
    """frobenius^power with host-composed coefficient constants (the
    oracle's first-principles table `_G1J`)."""
    shape, dev = a[0][0].shape[1:], a[0][0].device
    c1 = OF.FP2_ONE
    c2 = OF.FP2_ONE
    for _ in range(power % 6):
        c1 = OF.fp2_mul(OF.fp2_conj(c1), OF._G1J[2])
        c2 = OF.fp2_mul(OF.fp2_conj(c2), OF._G1J[4])
    a0, a1, a2 = (fp2_frobenius(x, power) for x in a)
    if c1 != OF.FP2_ONE:
        a1 = fp2_mul(a1, fp2_const(c1, shape, dev))
    if c2 != OF.FP2_ONE:
        a2 = fp2_mul(a2, fp2_const(c2, shape, dev))
    return (a0, a1, a2)


def fp12_frobenius(a, power: int):
    shape, dev = a[0][0][0].shape[1:], a[0][0][0].device
    c = OF.FP2_ONE
    for _ in range(power % 12):
        c = OF.fp2_mul(OF.fp2_conj(c), OF._G1J[1])
    b0 = fp6_frobenius(a[0], power)
    b1 = fp6_frobenius(a[1], power)
    if c != OF.FP2_ONE:
        cc = fp2_const(c, shape, dev)
        b1 = tuple(fp2_mul(x, cc) for x in b1)
    return (b0, b1)


# --- cyclotomic ops ----------------------------------------------------------

def fp12_cyclotomic_sqr(a):
    """Granger-Scott squaring in the cyclotomic subgroup: 9 fp2 products
    (27 base products, one K7 launch)."""
    (a0, a1, a2), (b0, b1, b2) = a

    def fp4_sqr_legs(c0, c1):
        return [(c0, c0), (c1, c1), (fp2_add(c0, c1), fp2_add(c0, c1))]

    legs = fp4_sqr_legs(a0, b1) + fp4_sqr_legs(b0, a2) + fp4_sqr_legs(a1, b2)
    prods = fp2_mul_many(legs)

    def fp4_out(i):
        s0, s1, sboth = prods[3 * i : 3 * i + 3]
        r0 = fp2_add(fp2_mul_by_nonresidue(s1), s0)
        r1 = fp2_sub(fp2_sub(sboth, s0), s1)
        return r0, r1

    t0, t1 = fp4_out(0)
    s0, s1 = fp4_out(1)
    r0, r1 = fp4_out(2)

    def even(t, z):  # 3t - 2z
        return fp2_sub(fp2_mul_small(t, 3), fp2_mul_small(z, 2))

    def odd(t, z):  # 3t + 2z
        return fp2_add(fp2_mul_small(t, 3), fp2_mul_small(z, 2))

    na0 = even(t0, a0)
    nb1 = odd(t1, b1)
    na1 = even(s0, a1)
    nb2 = odd(s1, b2)
    na2 = even(r0, a2)
    nb0 = odd(fp2_mul_by_nonresidue(r1), b0)
    return ((na0, na1, na2), (nb0, nb1, nb2))
