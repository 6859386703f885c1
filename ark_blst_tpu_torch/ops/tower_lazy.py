"""Batched Fp2/Fp6/Fp12 tower on the lazy radix-13 engine (stacked tensors).

Counterpart of `ark_blst_tpu/ops/tower_lazy.py`, digit for digit: the same
functions in the same order of operations, so every output equals the JAX
tower's digits (tests/test_torch_tower_lazy.py). The pairing pipeline
(`curves/pairing.py`) runs on it.

Representation: an Fp element is ONE stacked `(30, *batch)` int32 tensor of
balanced radix-13 digits in the lazy Montgomery domain R13 = 2^390;
  fp2  = (c0, c1)        of Fp elements
  fp6  = (a0, a1, a2)    of fp2
  fp12 = (b0, b1)        of fp6
and a stacked fp12 is the `(12, 30, *batch)` tensor of its components in
(i, j, k) order (`stack12` / `unstack12`), the operand form of the kernels.

INVARIANT (as in the JAX tower): every element a function here returns is
mul-ready (|digit| <= F_BOUND, or a negation of such): adds, subs and small
scales fold their outputs, so any two outputs multiply with no bound
bookkeeping.

Where the work goes: every Montgomery product is `_mul`, the K1 wrapper
(`ops/mont_mul.py`), which runs its plain version on CPU tensors; the
inverse of `fp_inv` is one K1-inv launch (`ops/fp_inv.py`). The tower
kernels K3-K6, K11 (`fp12_sqr`) and K12 (`fp12_mul_by_014_many` of one
item) take stacked operands and are called by the pairing
(`curves/pairing.py`, `curves/pairing_steps.py`); their plain versions are
the unfused functions here.
"""

from __future__ import annotations

import torch

from ..oracle import field as OF
from . import fp_inv as FI
from . import lazy13 as LZ
from . import mont_mul as MM
from .limbs import FP

_P = OF.P

R16_MOD_P = (1 << (16 * FP.num_limbs)) % _P
R16_TO_R13 = LZ.R13_MOD_P * LZ.R13_MOD_P % _P * pow(R16_MOD_P, -1, _P) % _P
_R16_TO_R13_DIGITS = [int(v) for v in LZ.int_to_digits(R16_TO_R13)]
_R16_DIGITS = [int(v) for v in LZ.int_to_digits(R16_MOD_P)]


# --- stacked-digit primitives -------------------------------------------------

def fold30(t):
    """One balanced carry-release pass on a stacked (30, ...) value, truncated
    back to 30 digits (the top carry is dropped): exact whenever
    |value| < 0.49 * 2^390."""
    u = t + LZ.HALF
    out = (u & LZ.DMASK) - LZ.HALF
    out[1:] += (u >> LZ.RADIX)[:-1]
    return out


def _mul(a, b):
    """Full lazy Montgomery product of mul-legal operands, through K1."""
    return MM.mont_mul(a.contiguous(), b.contiguous())


# --- ingest / egress (strict radix-16 <-> lazy radix-13) ---------------------

def fp_ingest(arr):
    """Strict (24, *batch) Montgomery-R16 limbs -> lazy element."""
    return LZ.mont_mul_const(LZ.from_limbs16(arr), _R16_TO_R13_DIGITS)


def fp_egress(a):
    """Lazy element -> strict (24, *batch) Montgomery-R16 limbs."""
    y = LZ.mont_mul_const(a, _R16_DIGITS)  # v*R13 -> v*R16
    return LZ.to_limbs16_strict(LZ.canonicalize(y))


def _ingest_many(arrs):
    """Concatenate components along the batch axis and ingest once."""
    if len(arrs) == 1:
        return [fp_ingest(arrs[0])]
    out = fp_ingest(torch.cat(arrs, dim=1))
    return list(out.split(arrs[0].shape[1], dim=1))


def _egress_many(elems):
    if len(elems) == 1:
        return [fp_egress(elems[0])]
    out = fp_egress(torch.cat(elems, dim=1))
    return list(out.split(elems[0].shape[1], dim=1))


def fp2_ingest(a):
    o = _ingest_many([a[0], a[1]])
    return (o[0], o[1])


def fp2_egress(a):
    o = _egress_many([a[0], a[1]])
    return (o[0], o[1])


def fp6_ingest(a):
    o = _ingest_many([a[i][j] for i in range(3) for j in range(2)])
    return tuple((o[2 * i], o[2 * i + 1]) for i in range(3))


def fp6_egress(a):
    o = _egress_many([a[i][j] for i in range(3) for j in range(2)])
    return tuple((o[2 * i], o[2 * i + 1]) for i in range(3))


def fp12_ingest(a):
    return _pack12(_ingest_many(_flat12(a)))


def fp12_egress(a):
    return _pack12(_egress_many(_flat12(a)))


# --- constants ----------------------------------------------------------------

def _const_digits(value: int):
    """Host: plain int -> balanced mul-ready digits of value*R13 mod p."""
    v = value % _P * LZ.R13_MOD_P % _P
    out, carry = [], 0
    for x in LZ.int_to_digits(v):
        t = int(x) + carry
        carry = 1 if t >= 4096 else 0
        out.append(t - 8192 if t >= 4096 else t)
    assert carry == 0
    return out


def _const_col(value: int, like):
    """(30, 1, ...) constant column that broadcasts against `like`."""
    return LZ.const(_const_digits(value), like)


def fp_const(value: int, like):
    """The constant as a full (30, *batch) element shaped like `like`."""
    out = torch.empty(like.shape, dtype=torch.int32, device=like.device)
    return out.copy_(_const_col(value, like))


def fp_zero(like):
    return torch.zeros_like(like)


def fp2_const(c, like):
    return (fp_const(c[0], like), fp_const(c[1], like))


# --- fp -----------------------------------------------------------------------

def fp_add(a, b):
    return fold30(a + b)


def fp_sub(a, b):
    return fold30(a - b)


def fp_neg(a):
    return -a


def fp_mul_small(a, k: int):
    return fold30(a * k)


def fp_mul_many(pairs):
    """Products of several pairs as ONE concatenated multiply (one K1
    launch on the card), split back along the batch axis."""
    if len(pairs) == 1:
        return [_mul(a, b) for a, b in pairs]
    out = _mul(torch.cat([a for a, _ in pairs], dim=1), torch.cat([b for _, b in pairs], dim=1))
    return list(out.split(pairs[0][0].shape[1], dim=1))


def fp_mul(a, b):
    return _mul(a, b)


def fp_inv(a):
    """Fermat inversion a^(p-2) (Montgomery): the ladder of 380 squarings
    and 228 products as one K1-inv launch over the whole batch
    (`ops/fp_inv.py`; on CPU tensors its plain version, the unrolled
    ladder)."""
    return FI.fp_inv(a.contiguous())


def fp_inv_batch(a):
    """Invert every lane of a (30, *batch) element through a log-depth
    product tree over the flat batch: pairwise products of the halves up to
    one root, one Fermat ladder (`fp_inv`) on the width-1 root, then the
    sibling products back down. ~3 full-batch products plus a width-1
    ladder, against the 608 full-batch products of `fp_inv`. Each level is
    one K1 launch at its own width (the TPU's 1024-multiple reshape of the
    JAX `_mul_flat` is a tile of that chip and is not kept).

    An eager primitive: nothing on the pairing path calls it (the JAX
    docstring records that it lost inside the fused pairing on the TPU).

    PRECONDITION: every lane is nonzero mod p; a zero lane poisons the root
    and so every lane, where `fp_inv` returns 0 for that lane alone."""
    sh = a.shape
    flat = a.reshape(LZ.L13, -1)
    n = flat.shape[1]
    m = 1 << max(0, n - 1).bit_length()
    if m != n:  # pad to a power of two with rep(1) lanes (self-inverse)
        one = _const_col(1, flat).expand(LZ.L13, m - n)
        flat = torch.cat([flat, one], dim=1)
    levels = [flat]
    w = m
    while w > 1:
        w //= 2
        cur = levels[-1]
        levels.append(_mul(cur[:, :w], cur[:, w:]))
    v = fp_inv(levels[-1])  # the width-1 root
    for u in levels[-2::-1]:
        w = u.shape[1] // 2
        # inv(lo) = inv(parent) * hi, inv(hi) = inv(parent) * lo: one product
        # at this level's full width
        v = _mul(torch.cat([v, v], dim=1), torch.cat([u[:, w:], u[:, :w]], dim=1))
    return v[:, :n].reshape(sh)


# --- fp2 ----------------------------------------------------------------------

def fp2_add(a, b):
    return (fp_add(a[0], b[0]), fp_add(a[1], b[1]))


def fp2_sub(a, b):
    return (fp_sub(a[0], b[0]), fp_sub(a[1], b[1]))


def fp2_neg(a):
    return (-a[0], -a[1])


def fp2_conj(a):
    return (a[0], -a[1])


def fp2_mul_small(a, k: int):
    return (fp_mul_small(a[0], k), fp_mul_small(a[1], k))


def fp2_mul_by_nonresidue(a):
    """xi = 1 + u:  (c0 - c1, c0 + c1)."""
    return (fp_sub(a[0], a[1]), fp_add(a[0], a[1]))


def fp2_mul_many(pairs):
    """Karatsuba from three full Montgomery products per pair, all pairs in
    one concatenated multiply."""
    legs = []
    for a, b in pairs:
        legs += [(a[0], b[0]), (a[1], b[1]), (fp_add(a[0], a[1]), fp_add(b[0], b[1]))]
    prods = fp_mul_many(legs)
    out = []
    for i in range(len(pairs)):
        m0, m1, m2 = prods[3 * i : 3 * i + 3]
        out.append((fp_sub(m0, m1), fold30(m2 - m0 - m1)))
    return out


def fp2_mul(a, b):
    return fp2_mul_many([(a, b)])[0]


def fp2_sqr_many(items):
    """(a0+a1)(a0-a1), a0*a1: 2 base products per square."""
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
    """(a0 - a1 u) / (a0^2 + a1^2): one norm inversion by the Fermat ladder."""
    n0, n1 = fp_mul_many([(a[0], a[0]), (a[1], a[1])])
    inv = fp_inv(fp_add(n0, n1))
    c0, c1 = fp_mul_many([(a[0], inv), (a[1], inv)])
    return (c0, -c1)


# --- pytree helpers -----------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def select(mask, a, b):
    """Elementwise select over any tower value; mask is batch-shaped."""
    return _tree_map(lambda x, y: torch.where(mask, x, y), a, b)


# --- fp6 ----------------------------------------------------------------------

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
    """[(a, b0, b1)] -> a * (b0 + b1 v), sparse: 6 fp2 products in one
    concatenated multiply."""
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


# --- fp12 ---------------------------------------------------------------------

_IDX12 = [(i, j, k) for i in range(2) for j in range(3) for k in range(2)]


def _flat12(a):
    return [a[i][j][k] for i, j, k in _IDX12]


def _pack12(comps):
    it = iter(comps)
    return tuple(tuple((next(it), next(it)) for _ in range(3)) for _ in range(2))


def stack12(a) -> torch.Tensor:
    """fp12 value -> its stacked (12, 30, *batch) form."""
    return torch.stack(_flat12(a))


def unstack12(x: torch.Tensor):
    """Stacked (12, 30, *batch) -> fp12 value (views of x). Any stack of 12
    component rows nests so: FE-hard's strict (12, 24, N) limbs become the
    strict fp12 in `fp12_egress`'s leaf order."""
    return _pack12([x[c] for c in range(12)])


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_conj(a):
    """Conjugation = the inverse on the cyclotomic subgroup."""
    return (a[0], fp6_neg(a[1]))


def fp12_mul_many(pairs):
    """Karatsuba: 3 fp6 products = 54 base products, one concatenated
    multiply."""
    legs = []
    for a, b in pairs:
        legs += [(a[0], b[0]), (a[1], b[1]), (fp6_add(a[0], a[1]), fp6_add(b[0], b[1]))]
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
    product of the Miller loop, 15 fp2 products per item in one
    concatenated multiply."""
    legs = []
    for f, c0, c1, c4 in items:
        a0, a1, a2 = f[0]
        legs += [(a0, c0), (a1, c0), (a2, c0), (a2, c1), (a0, c1), (a1, c1)]
        b0, b1, b2 = f[1]
        legs += [(b2, c4), (b0, c4), (b1, c4)]
        s0, s1, s2 = fp6_add(f[0], f[1])
        c14 = fp2_add(c1, c4)
        legs += [(s0, c0), (s1, c0), (s2, c0), (s2, c14), (s0, c14), (s1, c14)]
    prods = fp2_mul_many(legs)
    out = []
    for i in range(len(items)):
        t = prods[15 * i : 15 * i + 15]
        t00, t10, t20, t21, t01, t11 = t[0:6]
        aa = (
            fp2_add(t00, fp2_mul_by_nonresidue(t21)),
            fp2_add(t01, t10),
            fp2_add(t11, t20),
        )
        m2, m0, m1 = t[6:9]
        bb = (fp2_mul_by_nonresidue(m2), m0, m1)
        u00, u10, u20, u21, u01, u11 = t[9:15]
        mid = (
            fp2_add(u00, fp2_mul_by_nonresidue(u21)),
            fp2_add(u01, u10),
            fp2_add(u11, u20),
        )
        nf1 = fp6_sub(fp6_sub(mid, aa), bb)
        nf0 = fp6_add(fp6_mul_by_nonresidue(bb), aa)
        out.append((nf0, nf1))
    return out


def fp12_one(like):
    """fp12 one, each component shaped like the Fp element `like`."""
    one, zero = fp_const(1, like), fp_zero(like)
    z2 = (zero, zero)
    return (((one, zero), z2, z2), (z2, z2, z2))


# --- Frobenius ----------------------------------------------------------------

def fp2_frobenius(a, power: int):
    return a if power % 2 == 0 else fp2_conj(a)


def _const_mul_fp2(a, c):
    """Multiply an fp2 batch by a host fp2 constant, expanded to a full
    Montgomery operand of the batch's shape."""
    return fp2_mul(a, fp2_const(c, a[0]))


def fp6_frobenius(a, power: int):
    """frobenius^power with host-composed coefficient constants (the
    oracle's first-principles table)."""
    c1 = OF.FP2_ONE
    c2 = OF.FP2_ONE
    for _ in range(power % 6):
        c1 = OF.fp2_mul(OF.fp2_conj(c1), OF._G1J[2])
        c2 = OF.fp2_mul(OF.fp2_conj(c2), OF._G1J[4])
    a0, a1, a2 = (fp2_frobenius(x, power) for x in a)
    if c1 != OF.FP2_ONE:
        a1 = _const_mul_fp2(a1, c1)
    if c2 != OF.FP2_ONE:
        a2 = _const_mul_fp2(a2, c2)
    return (a0, a1, a2)


def fp12_frobenius(a, power: int):
    c = OF.FP2_ONE
    for _ in range(power % 12):
        c = OF.fp2_mul(OF.fp2_conj(c), OF._G1J[1])
    b0 = fp6_frobenius(a[0], power)
    b1 = fp6_frobenius(a[1], power)
    if c != OF.FP2_ONE:
        b1 = tuple(_const_mul_fp2(x, c) for x in b1)
    return (b0, b1)


# --- cyclotomic ops -----------------------------------------------------------

# Barrett constants of the digit-level value contraction: q ~= value/p from
# the top digit alone, K = round(2^(13*29+S) / p) with S = 16, so that
# |value - q*p| <= 0.58p (shift rounding 0.5, K quantization 0.032, ignored
# low digits 0.039).
_BARRETT_S = 16
_BARRETT_K = (2 ** (13 * 29 + _BARRETT_S) + _P // 2) // _P  # 5040
_BARRETT_HALF = 1 << (_BARRETT_S - 1)


def _contract_many(elems):
    """Digit-level Barrett value contraction x - round(x/p)*p: the same
    residue for any quotient estimate, magnitude pulled into (-0.58p, 0.58p).
    Folds bound digits, not values; the 3t +- 2z of the cyclotomic square
    feeds its input back additively, so without this the value would double
    every square until the fold30 truncation bound breaks."""
    out = []
    for x in elems:
        q = (x[29] * _BARRETT_K + _BARRETT_HALF) >> _BARRETT_S
        out.append(fold30(fold30(x - q * LZ.const(LZ.P_DIGITS, x))))
    return out


def fp12_cyclotomic_sqr(a):
    """Granger-Scott squaring in the cyclotomic subgroup."""
    return _cyc_sqr_core(a)


def _cyc_sqr_core(a):
    """The squaring math: contraction of the input, 18 base products (all
    nine fp2 squares in one concatenated multiply), the 3t +- 2z
    recombination."""
    a = _pack12(_contract_many(_flat12(a)))
    (a0, a1, a2), (b0, b1, b2) = a

    def fp4_sqr_items(c0, c1):
        return [c0, c1, fp2_add(c0, c1)]

    items = fp4_sqr_items(a0, b1) + fp4_sqr_items(b0, a2) + fp4_sqr_items(a1, b2)
    prods = fp2_sqr_many(items)

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
