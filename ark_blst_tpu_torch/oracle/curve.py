"""Pure-Python G1 and G2 affine group law on host ints.

Affine points are `None` (infinity) or `(x, y)` tuples of Fp ints (G1) or
Fp2 tuples (G2). One implementation serves both curves through a field-op
bundle (`FP_OPS`, `FP2_OPS`): the generic `group_*` functions, validation
(`is_on_curve`, `is_in_subgroup`) and the windowed host MSM
(`msm_pippenger`) take the bundle; `add`, `scalar_mul`, `msm` and their
`g2_*` twins fix it. Used by the host Horner finish of the MSM, by the
pairing instances, by the API's group classes (`groups.py`) and their
codecs (`oracle/serialize.py`), and by tests as the trusted reference.
"""

from __future__ import annotations

from . import field as F


class _Ops:
    """The field operations and constants of one curve's group law: the
    coordinate field's operations, its zero and one, the curve's b."""

    def __init__(self, add, sub, mul, sqr, neg, inv, is_zero, scale, zero, one, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.is_zero, self.scale = neg, inv, is_zero, scale
        self.zero, self.one, self.b = zero, one, b


FP_OPS = _Ops(F.fp_add, F.fp_sub, F.fp_mul, lambda a: a * a % F.P, F.fp_neg, F.fp_inv,
              lambda a: a == 0, lambda a, k: a * k % F.P, 0, 1, F.B_G1)
FP2_OPS = _Ops(F.fp2_add, F.fp2_sub, F.fp2_mul, F.fp2_sqr, F.fp2_neg, F.fp2_inv,
               F.fp2_is_zero, F.fp2_scalar, F.FP2_ZERO, F.FP2_ONE, F.B_G2)


def is_on_curve(ops, pt):
    """y^2 == x^3 + b (affine); infinity is on the curve."""
    if pt is None:
        return True
    x, y = pt
    return ops.sqr(y) == ops.add(ops.mul(ops.sqr(x), x), ops.b)


def group_neg(ops, pt):
    return None if pt is None else (pt[0], ops.neg(pt[1]))


def group_add(ops, p1, p2):
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
        lam = ops.mul(ops.scale(ops.sqr(x1), 3), ops.inv(ops.scale(y1, 2)))
    else:
        lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sqr(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def group_double(ops, pt):
    return group_add(ops, pt, pt)


def group_mul(ops, pt, k: int):
    """Double-and-add; a negative k multiplies the negation."""
    if k < 0:
        return group_mul(ops, group_neg(ops, pt), -k)
    out = None
    acc = pt
    while k > 0:
        if k & 1:
            out = group_add(ops, out, acc)
        acc = group_add(ops, acc, acc)
        k >>= 1
    return out


def is_in_subgroup(ops, pt):
    """Torsion-free check: r * pt == infinity."""
    return group_mul(ops, pt, F.R) is None


def clear_cofactor(ops, pt, cofactor):
    return group_mul(ops, pt, cofactor)


def group_msm(ops, points, scalars):
    """Naive MSM fold: the differential oracle of the device MSMs."""
    out = None
    for pt, s in zip(points, scalars):
        out = group_add(ops, out, group_mul(ops, pt, s % F.R))
    return out


def msm_pippenger(ops, points, scalars, c: int | None = None):
    """Windowed bucket-method MSM on host ints: O(n + 2^c) group additions
    per window instead of the naive fold's O(n * 255) doublings. The API's
    host route (`groups.py`), held against `group_msm` in the tests."""
    n = len(points)
    if n == 0:
        return None
    if c is None:
        # c ~ log2(n) - log2(log2(n)) minimizes (255 / c) * (n + 2^c)
        logn = max(1, n.bit_length() - 1)
        c = max(2, min(16, logn - logn.bit_length() + 2))
    num_windows = (255 + c - 1) // c
    mask = (1 << c) - 1
    ss = [s % F.R for s in scalars]
    total = None
    for w in range(num_windows - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = group_double(ops, total)
        buckets = [None] * (1 << c)
        for pt, s in zip(points, ss):
            d = (s >> (c * w)) & mask
            if d:
                buckets[d] = group_add(ops, buckets[d], pt)
        running = None
        window_sum = None
        for b in range(len(buckets) - 1, 0, -1):
            if buckets[b] is not None:
                running = group_add(ops, running, buckets[b])
            if running is not None:
                window_sum = group_add(ops, window_sum, running)
        total = group_add(ops, total, window_sum)
    return total


# --- G1 ----------------------------------------------------------------------

def neg(pt):
    return group_neg(FP_OPS, pt)


def add(p1, p2):
    return group_add(FP_OPS, p1, p2)


def double(pt):
    return add(pt, pt)


def scalar_mul(pt, k: int):
    return group_mul(FP_OPS, pt, k)


def msm(points, scalars):
    """Naive G1 MSM fold: the differential oracle of the device MSM."""
    return group_msm(FP_OPS, points, scalars)


# --- G2 ----------------------------------------------------------------------

def g2_neg(pt):
    return group_neg(FP2_OPS, pt)


def g2_add(p1, p2):
    return group_add(FP2_OPS, p1, p2)


def g2_double(pt):
    return g2_add(pt, pt)


def g2_mul(pt, k: int):
    return group_mul(FP2_OPS, pt, k)


def g2_msm(points, scalars):
    """Naive G2 MSM fold: the differential oracle of the device G2 MSM."""
    return group_msm(FP2_OPS, points, scalars)
