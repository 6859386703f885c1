"""Pure-Python G1 and G2 affine group law on host ints.

Affine points are `None` (infinity) or `(x, y)` tuples of Fp ints (G1) or
Fp2 tuples (G2). Used by the host Horner finish of the MSM, by the pairing
instances, and by tests as the trusted reference.
"""

from __future__ import annotations

from . import field as F


class _Ops:
    """The field operations one curve's group law needs."""

    def __init__(self, sub, mul, neg, inv, is_zero, scale):
        self.sub, self.mul, self.neg, self.inv = sub, mul, neg, inv
        self.is_zero, self.scale = is_zero, scale


_FP = _Ops(F.fp_sub, F.fp_mul, F.fp_neg, F.fp_inv, lambda a: a == 0,
           lambda a, k: a * k % F.P)
_FP2 = _Ops(F.fp2_sub, F.fp2_mul, F.fp2_neg, F.fp2_inv, F.fp2_is_zero, F.fp2_scalar)


def _neg(ops, pt):
    return None if pt is None else (pt[0], ops.neg(pt[1]))


def _add(ops, p1, p2):
    """Complete affine addition (chord/tangent with all edge cases)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or ops.is_zero(y1):
            return None  # p2 == -p1
        lam = ops.mul(ops.scale(ops.mul(x1, x1), 3), ops.inv(ops.scale(y1, 2)))
    else:
        lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.mul(lam, lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _scalar_mul(ops, pt, k: int):
    """Double-and-add."""
    if k < 0:
        return _scalar_mul(ops, _neg(ops, pt), -k)
    out = None
    acc = pt
    while k > 0:
        if k & 1:
            out = _add(ops, out, acc)
        acc = _add(ops, acc, acc)
        k >>= 1
    return out


# --- G1 ----------------------------------------------------------------------

def neg(pt):
    return _neg(_FP, pt)


def add(p1, p2):
    return _add(_FP, p1, p2)


def double(pt):
    return add(pt, pt)


def scalar_mul(pt, k: int):
    return _scalar_mul(_FP, pt, k)


def msm(points, scalars):
    """Naive MSM fold: the differential oracle of the device MSM."""
    out = None
    for pt, s in zip(points, scalars):
        out = add(out, scalar_mul(pt, s % F.R))
    return out


# --- G2 ----------------------------------------------------------------------

def g2_neg(pt):
    return _neg(_FP2, pt)


def g2_add(p1, p2):
    return _add(_FP2, p1, p2)


def g2_double(pt):
    return g2_add(pt, pt)


def g2_mul(pt, k: int):
    return _scalar_mul(_FP2, pt, k)


def g2_msm(points, scalars):
    """Naive G2 MSM fold: the differential oracle of the device G2 MSM."""
    out = None
    for pt, s in zip(points, scalars):
        out = g2_add(out, g2_mul(pt, s % F.R))
    return out
