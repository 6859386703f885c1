"""Pure-Python BLS12-381 optimal-ate pairing (host ints): the trusted
reference that the port's batched pairing is checked against.

The port's own copy of the JAX package oracle's fast path, the algorithm the
device pipeline mirrors: Jacobian line coefficients over Fp2 (Beuchat et
al., eprint 2010/354, Algorithms 26/27), sparse Fp12 multiplication, and
the cyclotomic final-exponentiation addition chain. `X_BITS` is also the
device Miller loop's event schedule (`curves/pairing.py:MILLER_EVENTS`).
"""

from __future__ import annotations

from . import field as F
from .field import (
    FP12_ONE, fp2_add, fp2_mul, fp2_mul_by_nonresidue, fp2_neg, fp2_scalar,
    fp2_sqr, fp2_sub, fp6_add, fp6_mul_by_nonresidue, fp6_sub, fp12_conj,
    fp12_cyclotomic_sqr, fp12_frobenius, fp12_inv, fp12_mul, fp12_sqr,
)

# Bits of |x| below the leading one, MSB-first: the Miller loop schedule.
X_ABS = -F.BLS_X
X_BITS = [int(b) for b in bin(X_ABS)[3:]]
assert len(X_BITS) == 63


def _doubling_step(r):
    """One Miller doubling step on Jacobian (X, Y, Z) over Fp2; returns
    (new_r, (c0, c1, c2)) line coefficients."""
    x, y, z = r
    t0 = fp2_sqr(x)
    t1 = fp2_sqr(y)
    t2 = fp2_sqr(t1)
    t3 = fp2_sub(fp2_sub(fp2_sqr(fp2_add(t1, x)), t0), t2)
    t3 = fp2_scalar(t3, 2)
    t4 = fp2_scalar(t0, 3)
    t6 = fp2_add(x, t4)
    t5 = fp2_sqr(t4)
    zsq = fp2_sqr(z)
    nx = fp2_sub(t5, fp2_scalar(t3, 2))
    nz = fp2_sub(fp2_sub(fp2_sqr(fp2_add(z, y)), t1), zsq)
    ny = fp2_sub(fp2_mul(fp2_sub(t3, nx), t4), fp2_scalar(t2, 8))
    c1 = fp2_neg(fp2_scalar(fp2_mul(t4, zsq), 2))
    c2 = fp2_sub(fp2_sub(fp2_sub(fp2_sqr(t6), t0), t5), fp2_scalar(t1, 4))
    c0 = fp2_scalar(fp2_mul(nz, zsq), 2)
    return (nx, ny, nz), (c0, c1, c2)


def _addition_step(r, q):
    """Mixed addition step (Jacobian r += affine q) with line coefficients."""
    x, y, z = r
    qx, qy = q
    zsq = fp2_sqr(z)
    ysq = fp2_sqr(qy)
    t0 = fp2_mul(zsq, qx)
    t1 = fp2_mul(fp2_sub(fp2_sub(fp2_sqr(fp2_add(qy, z)), ysq), zsq), zsq)
    t2 = fp2_sub(t0, x)
    t3 = fp2_sqr(t2)
    t4 = fp2_scalar(t3, 4)
    t5 = fp2_mul(t4, t2)
    t6 = fp2_sub(t1, fp2_scalar(y, 2))
    t9 = fp2_mul(t6, qx)
    t7 = fp2_mul(t4, x)
    nx = fp2_sub(fp2_sub(fp2_sqr(t6), t5), fp2_scalar(t7, 2))
    nz = fp2_sub(fp2_sub(fp2_sqr(fp2_add(z, t2)), zsq), t3)
    t10 = fp2_add(qy, nz)
    t8 = fp2_mul(fp2_sub(t7, nx), t6)
    t0 = fp2_scalar(fp2_mul(y, t5), 2)
    ny = fp2_sub(t8, t0)
    t10 = fp2_sub(fp2_sub(fp2_sqr(t10), ysq), fp2_sqr(nz))
    t9 = fp2_sub(fp2_scalar(t9, 2), t10)
    c0 = fp2_scalar(nz, 2)
    c1 = fp2_scalar(fp2_neg(t6), 2)
    return (nx, ny, nz), (c0, c1, t9)


def prepare_g2(q):
    """G2 line-coefficient precomputation: the coefficient list in Miller-loop
    order, one triple per doubling and one per addition (68 in all)."""
    if q is None:
        return None  # identity: its Miller contribution is one
    coeffs = []
    r = (q[0], q[1], F.FP2_ONE)
    for bit in X_BITS:
        r, c = _doubling_step(r)
        coeffs.append(c)
        if bit:
            r, c = _addition_step(r, q)
            coeffs.append(c)
    return coeffs


def fp6_mul_by_01(a, b0, b1):
    """a * (b0 + b1 v), sparse."""
    a0, a1, a2 = a
    return (
        fp2_add(fp2_mul(a0, b0), fp2_mul_by_nonresidue(fp2_mul(a2, b1))),
        fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0)),
        fp2_add(fp2_mul(a1, b1), fp2_mul(a2, b0)),
    )


def fp6_mul_by_1(a, b1):
    """a * (b1 v), sparse."""
    a0, a1, a2 = a
    return (fp2_mul_by_nonresidue(fp2_mul(a2, b1)), fp2_mul(a0, b1), fp2_mul(a1, b1))


def fp12_mul_by_014(f, c0, c1, c4):
    """f * ((c0 + c1 v) + (c4 v) w): the sparse shape of a line value."""
    f0, f1 = f
    aa = fp6_mul_by_01(f0, c0, c1)
    bb = fp6_mul_by_1(f1, c4)
    o = fp2_add(c1, c4)
    nf1 = fp6_sub(fp6_sub(fp6_mul_by_01(fp6_add(f0, f1), c0, o), aa), bb)
    nf0 = fp6_add(fp6_mul_by_nonresidue(bb), aa)
    return (nf0, nf1)


def ell(f, coeffs, p):
    """Fold one line into the accumulator: c0 scaled by y_P, c1 by x_P."""
    c0, c1, c2 = coeffs
    px, py = p
    c0 = (c0[0] * py % F.P, c0[1] * py % F.P)
    c1 = (c1[0] * px % F.P, c1[1] * px % F.P)
    return fp12_mul_by_014(f, c2, c1, c0)


def miller_loop(p, q_or_coeffs):
    """Single Miller loop; `q_or_coeffs` is an affine G2 point or a prepared
    coefficient list. Conjugated at the end, since x < 0."""
    coeffs = q_or_coeffs if isinstance(q_or_coeffs, list) else prepare_g2(q_or_coeffs)
    if p is None or coeffs is None:
        return FP12_ONE
    f = FP12_ONE
    idx = 0
    for bit in X_BITS:
        f = fp12_sqr(f)
        f = ell(f, coeffs[idx], p)
        idx += 1
        if bit:
            f = ell(f, coeffs[idx], p)
            idx += 1
    return fp12_conj(f)


def multi_miller_loop(pairs):
    """Product of Miller loops; pairs holding an identity contribute one."""
    f = FP12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = fp12_mul(f, miller_loop(p, q))
    return f


def final_exp(f):
    """Easy part, then the standard BLS12-381 cyclotomic addition chain (which
    computes f^(3(p^12-1)/r), the value blst-compatible libraries output)."""
    t0 = fp12_conj(f)
    t1 = fp12_inv(f)
    t2 = fp12_mul(t0, t1)
    t1 = t2
    t2 = fp12_frobenius(t2, 2)
    t2 = fp12_mul(t2, t1)
    ex = F.fp12_cyclotomic_exp_bls_x
    t1 = fp12_conj(fp12_cyclotomic_sqr(t2))
    t3 = ex(t2)
    t4 = fp12_cyclotomic_sqr(t3)
    t5 = fp12_mul(t1, t3)
    t1 = ex(t5)
    t0 = ex(t1)
    t6 = ex(t0)
    t6 = fp12_mul(t6, t4)
    t4 = ex(t6)
    t5 = fp12_conj(t5)
    t4 = fp12_mul(fp12_mul(t4, t5), t2)
    t5 = fp12_conj(t2)
    t1 = fp12_mul(t1, t2)
    t1 = fp12_frobenius(t1, 3)
    t6 = fp12_mul(t6, t5)
    t6 = fp12_frobenius(t6, 1)
    t3 = fp12_mul(t3, t0)
    t3 = fp12_frobenius(t3, 2)
    t3 = fp12_mul(t3, t1)
    t3 = fp12_mul(t3, t6)
    return fp12_mul(t3, t4)


def pairing(p, q):
    """e(P, Q); identity inputs yield one."""
    if p is None or q is None:
        return FP12_ONE
    return final_exp(miller_loop(p, q))
