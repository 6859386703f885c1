"""Pure-Python BLS12-381 field oracle: Fp and the Fp2/Fp6/Fp12 tower (host ints).

The port's own copy of what it needs from the JAX package's field oracle:
the moduli, generators and curve constants, the Fp operations of the MSM's
host finish and the codecs, the tower that the pairing's oracle
(`oracle/pairing.py`) and the lazy tower's Frobenius constants
(`ops/tower_lazy.py`) use, and the square roots, Legendre symbols, sign
rule and Frobenius maps of the API's value classes (`fields.py`,
`oracle/serialize.py`).

Representation (plain Python ints, no Montgomery form):
  Fp   : int in [0, P)
  Fp2  : (c0, c1)              c0 + c1*u,          u^2 = -1
  Fp6  : (a0, a1, a2) of Fp2   a0 + a1*v + a2*v^2, v^3 = XI = u + 1
  Fp12 : (b0, b1)     of Fp6   b0 + b1*w,          w^2 = v
"""

from __future__ import annotations

# Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus r (255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative, low Hamming weight).
BLS_X = -0xD201000000010000

# E/Fp: y^2 = x^3 + 4;  the twist E'/Fp2: y^2 = x^3 + 4(u + 1).
B_G1 = 4
XI = (1, 1)  # the Fp6/Fp2 non-residue u + 1
B_G2 = (4, 4)

assert R == BLS_X**4 - BLS_X**2 + 1
assert P == (BLS_X - 1) ** 2 // 3 * R + BLS_X

# Cofactors and their inverses mod r.
H_G1 = (BLS_X - 1) ** 2 // 3
assert H_G1 == 0x396C8C005555E1568C00AAAB0000AAAB
H_G2 = (
    BLS_X**8 - 4 * BLS_X**7 + 5 * BLS_X**6 - 4 * BLS_X**4 + 6 * BLS_X**3
    - 4 * BLS_X**2 - 4 * BLS_X + 13
) // 9
H_G1_INV_MOD_R = pow(H_G1, -1, R)
H_G2_INV_MOD_R = pow(H_G2, -1, R)

# The scalar field's FFT constants: r - 1 = q * 2^32 with q odd.
FR_TWO_ADICITY = 32
assert (R - 1) % (1 << FR_TWO_ADICITY) == 0 and (R - 1) % (1 << 33) != 0
FR_GENERATOR = 7
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# Generator of G1: y^2 = x^3 + 4 over Fp.
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
# Generator of G2 over Fp2.
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# --- Fp ----------------------------------------------------------------------

def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_neg(a):
    return (-a) % P


def fp_inv(a):
    if a == 0:
        raise ZeroDivisionError("fp inverse of zero")
    return pow(a, -1, P)


def fp_sqrt(a):
    """Square root in Fp (p = 3 mod 4); None if a is not a square."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


def fp_legendre(a):
    if a == 0:
        return 0
    return 1 if pow(a, (P - 1) // 2, P) == 1 else -1


# --- Fp2 ---------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def fp2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    inv = fp_inv((a0 * a0 + a1 * a1) % P)
    return (a0 * inv % P, -a1 * inv % P)


def fp2_mul_by_nonresidue(a):
    """Multiply by xi = u + 1:  (c0 - c1) + (c0 + c1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp2_pow(a, e):
    result, base = FP2_ONE, a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fp2_lexicographically_largest(a):
    """The ZCash sign rule: c1 > (p-1)/2, or c1 == 0 and c0 > (p-1)/2."""
    half = (P - 1) // 2
    return a[1] > half or (a[1] == 0 and a[0] > half)


def fp2_sqrt(a):
    """Square root in Fp2 for p = 3 mod 4 (the Adj-Rodriguez-Henriquez
    method); None when a is not a square."""
    if fp2_is_zero(a):
        return (0, 0)
    a1 = fp2_pow(a, (P - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    if alpha == (P - 1, 0):  # alpha == -1
        x = fp2_mul((0, 1), x0)
    else:
        b = fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2)
        x = fp2_mul(b, x0)
    return x if fp2_sqr(x) == a else None


# --- Fp6 ---------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_add(fp2_mul(a1, b2), fp2_mul(a2, b1))
    t2 = fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0))
    t3 = fp2_mul(a2, b2)
    t4 = fp2_add(fp2_add(fp2_mul(a0, b2), fp2_mul(a1, b1)), fp2_mul(a2, b0))
    return (
        fp2_add(t0, fp2_mul_by_nonresidue(t1)),
        fp2_add(t2, fp2_mul_by_nonresidue(t3)),
        t4,
    )


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_nonresidue(a):
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fp2_mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_by_nonresidue(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_nonresidue(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul(a0, c0),
        fp2_mul_by_nonresidue(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
    )
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# --- Fp12 --------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_neg(a):
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    return (
        fp6_add(t0, fp6_mul_by_nonresidue(t1)),
        fp6_add(fp6_mul(a0, b1), fp6_mul(a1, b0)),
    )


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation = Frobenius^6, the inverse on the cyclotomic subgroup."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_by_nonresidue(fp6_sqr(a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


# --- Frobenius ---------------------------------------------------------------
# gamma_1[j] = xi^(j*(p-1)/6), j = 0..5: the Fp12/Fp6 Frobenius coefficients,
# computed from first principles.

_G1J = [fp2_pow(XI, j * (P - 1) // 6) for j in range(6)]


def fp2_frobenius(a, power=1):
    return a if power % 2 == 0 else fp2_conj(a)


def fp6_frobenius(a, power=1):
    out = a
    for _ in range(power % 6):
        a0, a1, a2 = out
        out = (
            fp2_conj(a0),
            fp2_mul(fp2_conj(a1), _G1J[2]),
            fp2_mul(fp2_conj(a2), _G1J[4]),
        )
    return out


def fp12_frobenius(a, power=1):
    out = a
    for _ in range(power % 12):
        c0 = fp6_frobenius(out[0], 1)
        c1 = tuple(fp2_mul(x, _G1J[1]) for x in fp6_frobenius(out[1], 1))
        out = (c0, c1)
    return out


# --- Cyclotomic subgroup -------------------------------------------------------

def fp12_cyclotomic_sqr(a):
    """Granger-Scott squaring (valid only in the cyclotomic subgroup)."""
    (a0, a1, a2), (b0, b1, b2) = a

    # Fp4 = Fp2[t]/(t^2 - xi), t = w^3; the Fp4 pairs are (a0, b1), (b0, a2), (a1, b2)
    def fp4_sqr(c0, c1):
        s0 = fp2_sqr(c0)
        s1 = fp2_sqr(c1)
        r0 = fp2_add(fp2_mul_by_nonresidue(s1), s0)
        r1 = fp2_sub(fp2_sub(fp2_sqr(fp2_add(c0, c1)), s0), s1)
        return r0, r1

    t0, t1 = fp4_sqr(a0, b1)
    s0, s1 = fp4_sqr(b0, a2)
    r0, r1 = fp4_sqr(a1, b2)
    # even coefficients: 3T - 2z; odd: 3T + 2z
    na0 = fp2_sub(fp2_scalar(t0, 3), fp2_scalar(a0, 2))
    nb1 = fp2_add(fp2_scalar(t1, 3), fp2_scalar(b1, 2))
    na1 = fp2_sub(fp2_scalar(s0, 3), fp2_scalar(a1, 2))
    nb2 = fp2_add(fp2_scalar(s1, 3), fp2_scalar(b2, 2))
    na2 = fp2_sub(fp2_scalar(r0, 3), fp2_scalar(a2, 2))
    nb0 = fp2_add(fp2_scalar(fp2_mul_by_nonresidue(r1), 3), fp2_scalar(b0, 2))
    return ((na0, na1, na2), (nb0, nb1, nb2))


def fp12_cyclotomic_exp_bls_x(a):
    """a^BLS_X (x < 0): a^|x| by square-and-multiply with cyclotomic squarings,
    then conjugate. The input must lie in the cyclotomic subgroup."""
    result = FP12_ONE
    found = False
    for bit in bin(-BLS_X)[2:]:
        if found:
            result = fp12_cyclotomic_sqr(result)
        if bit == "1":
            if found:
                result = fp12_mul(result, a)
            else:
                result = a
                found = True
    return fp12_conj(result)
