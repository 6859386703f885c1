"""Pure-Python G1 affine group law on host ints.

Affine points are `None` (infinity) or `(x, y)` tuples of Fp ints. Used by
the host Horner finish of the MSM and by tests as the trusted reference.
"""

from __future__ import annotations

from . import field as F


def neg(pt):
    if pt is None:
        return None
    return (pt[0], F.fp_neg(pt[1]))


def add(p1, p2):
    """Complete affine addition (chord/tangent with all edge cases)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or y1 == 0:
            return None  # p2 == -p1
        lam = F.fp_mul(3 * x1 * x1, F.fp_inv(2 * y1 % F.P))
    else:
        lam = F.fp_mul(F.fp_sub(y2, y1), F.fp_inv(F.fp_sub(x2, x1)))
    x3 = F.fp_sub(F.fp_sub(lam * lam, x1), x2)
    y3 = F.fp_sub(F.fp_mul(lam, F.fp_sub(x1, x3)), y1)
    return (x3, y3)


def double(pt):
    return add(pt, pt)


def scalar_mul(pt, k: int):
    """Double-and-add."""
    if k < 0:
        return scalar_mul(neg(pt), -k)
    out = None
    acc = pt
    while k > 0:
        if k & 1:
            out = add(out, acc)
        acc = double(acc)
        k >>= 1
    return out


def msm(points, scalars):
    """Naive MSM fold: the differential oracle of the device MSM."""
    out = None
    for pt, s in zip(points, scalars):
        out = add(out, scalar_mul(pt, s % F.R))
    return out
