"""RCB15 group formulas over the stacked lazy radix-13 engine (G1 and G2).

Counterpart of `ark_blst_tpu/curves/lazy_group.py`, digit for digit:
complete projective addition/doubling and the Z2=1 mixed variant
(Renes-Costello-Batina 2015, Algorithms 7 and 9, a = 0), where each output
coordinate pays ONE Montgomery reduction for its two-product linear
combination. One body of each formula serves both fields; the field
adapter (`FP_LAZY` for G1, `FP2_LAZY` for G2) holds what differs.

An Fp element is a `(30, *batch)` int32 tensor with at least one batch
axis, an Fp2 element a pair `(c0, c1)` of them; `mulp` and `red` batch a
round's products by concatenating along the first batch axis (dim 1), as
the JAX code concatenates along axis 0 of each digit array.
"""

from __future__ import annotations

import torch

from ..ops import lazy13 as LZ


def _split(val: torch.Tensor, parts: int):
    return list(torch.chunk(val, parts, dim=1))


class LazyOps:
    """Field adapter over the stacked lazy engine: Fp."""

    add = staticmethod(LZ.add)
    sub = staticmethod(LZ.sub)
    neg = staticmethod(LZ.neg)
    scale = staticmethod(LZ.scale)
    fold_sum = staticmethod(LZ.fold_sum)
    select = staticmethod(LZ.select)
    wadd = staticmethod(LZ.add)
    wsub = staticmethod(LZ.sub)
    store30 = staticmethod(LZ.store30)

    @staticmethod
    def mul_b3(a):
        """3b = 12 on G1. Returns the UNFOLDED product (bound 24F)."""
        return LZ.scale(a, 12)

    @staticmethod
    def mulp(pairs):
        """Batched product round: pairs of MUL-READY operands -> prered wides."""
        a = torch.cat([p[0] for p in pairs], dim=1)
        b = torch.cat([p[1] for p in pairs], dim=1)
        return _split(LZ.prered(LZ.mul_wide(a, b)), len(pairs))

    @staticmethod
    def red(wides):
        """Batched reduction of prered combinations -> elements."""
        return _split(LZ.reduce_wide(torch.cat(list(wides), dim=1)), len(wides))

    @staticmethod
    def zero(like):
        return torch.zeros_like(like[: LZ.ELEM])

    @staticmethod
    def one(like):
        return (LZ.const(LZ.ONE13, like) + torch.zeros_like(like[: LZ.ELEM])).contiguous()


class Fp2LazyOps:
    """Field adapter over the stacked lazy engine: Fp2 = Fp[u]/(u^2+1)."""

    add = staticmethod(LZ.fp2_add)
    sub = staticmethod(LZ.fp2_sub)
    neg = staticmethod(LZ.fp2_neg)
    scale = staticmethod(LZ.fp2_scale)
    fold_sum = staticmethod(LZ.fp2_fold_sum)
    select = staticmethod(LZ.fp2_select)
    wadd = staticmethod(LZ.fp2_add)
    wsub = staticmethod(LZ.fp2_sub)

    @staticmethod
    def store30(a):
        return (LZ.store30(a[0]), LZ.store30(a[1]))

    @staticmethod
    def mul_b3(a):
        """3b = 12 (1 + u) on G2 (b = 4 (1 + u)): (a0 - a1, a0 + a1) * 12.
        Returns the UNFOLDED sums (bound 24F)."""
        return (LZ.scale(LZ.sub(a[0], a[1]), 12), LZ.scale(LZ.add(a[0], a[1]), 12))

    @staticmethod
    def mulp(pairs):
        """Batched product round, Karatsuba at the leg level: the three legs
        of every pair go through ONE wide product; returns prered pairs
        (m0 - m1, m2 - (m0 + m1))."""
        legs_a, legs_b = [], []
        for a, b in pairs:
            legs_a += [a[0], a[1], LZ.fold_sum(LZ.add(a[0], a[1]))]
            legs_b += [b[0], b[1], LZ.fold_sum(LZ.add(b[0], b[1]))]
        outs = _split(LZ.prered(LZ.mul_wide(torch.cat(legs_a, dim=1), torch.cat(legs_b, dim=1))),
                      3 * len(pairs))
        return [(LZ.sub(m0, m1), LZ.sub(m2, LZ.add(m0, m1)))
                for m0, m1, m2 in zip(outs[0::3], outs[1::3], outs[2::3])]

    @staticmethod
    def red(wides):
        """Batched reduction: all re parts, then all im parts, in one
        concatenated reduction."""
        n = len(wides)
        flat = [w[0] for w in wides] + [w[1] for w in wides]
        outs = _split(LZ.reduce_wide(torch.cat(flat, dim=1)), 2 * n)
        return [(outs[i], outs[n + i]) for i in range(n)]

    @staticmethod
    def zero(like):
        z = torch.zeros_like(like[0][: LZ.ELEM])
        return (z, z.clone())

    @staticmethod
    def one(like):
        return (LazyOps.one(like[0]), torch.zeros_like(like[0][: LZ.ELEM]))


FP_LAZY = LazyOps()
FP2_LAZY = Fp2LazyOps()


def mixed_add(f: LazyOps | Fp2LazyOps, p1, p2):
    """Complete addition P1 (projective) + P2 (affine, Z2=1): 11 field muls
    in two batched rounds, 8 reductions."""
    X1, Y1, Z1 = p1  # elements: F
    X2, Y2 = p2  # elements: F
    t0, t1, u1, u2, m3 = f.red(f.mulp([
        (X1, X2),
        (Y1, Y2),
        (Y2, Z1),
        (X2, Z1),
        (f.fold_sum(f.add(X1, Y1)), f.fold_sum(f.add(X2, Y2))),
    ]))
    t3 = f.fold_sum(f.sub(f.sub(m3, t0), t1))  # 3F -> F
    t4 = f.add(Y1, u1)  # Y1 + Y2 Z1: 2F
    ty = f.add(X1, u2)  # X1 + X2 Z1: 2F
    t0t = f.fold_sum(f.scale(t0, 3))
    t2b = f.fold_sum(f.mul_b3(Z1))
    z3 = f.fold_sum(f.add(t1, t2b))
    t1m = f.fold_sum(f.sub(t1, t2b))
    t4 = f.fold_sum(t4)
    tyb = f.fold_sum(f.mul_b3(ty))
    a, b, c, d, e, g = f.mulp([
        (t4, tyb), (t3, t1m), (tyb, t0t), (t1m, z3), (t0t, t3), (z3, t4),
    ])
    X3, Y3, Z3 = f.red([f.wsub(b, a), f.wadd(d, c), f.wadd(g, e)])
    return (X3, Y3, Z3)


def full_add(f: LazyOps | Fp2LazyOps, p1, p2):
    """Complete projective + projective addition: 12 muls, 9 reductions."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0, t1, t2, m3, m4, m5 = f.red(f.mulp([
        (X1, X2),
        (Y1, Y2),
        (Z1, Z2),
        (f.fold_sum(f.add(X1, Y1)), f.fold_sum(f.add(X2, Y2))),
        (f.fold_sum(f.add(Y1, Z1)), f.fold_sum(f.add(Y2, Z2))),
        (f.fold_sum(f.add(X1, Z1)), f.fold_sum(f.add(X2, Z2))),
    ]))
    t3 = f.fold_sum(f.sub(f.sub(m3, t0), t1))  # X1Y2 + X2Y1
    t4 = f.fold_sum(f.sub(f.sub(m4, t1), t2))  # Y1Z2 + Y2Z1
    ty = f.fold_sum(f.sub(f.sub(m5, t0), t2))  # X1Z2 + X2Z1
    t0t = f.fold_sum(f.scale(t0, 3))
    t2b = f.fold_sum(f.mul_b3(t2))
    z3 = f.fold_sum(f.add(t1, t2b))
    t1m = f.fold_sum(f.sub(t1, t2b))
    tyb = f.fold_sum(f.mul_b3(ty))
    a, b, c, d, e, g = f.mulp([
        (t4, tyb), (t3, t1m), (tyb, t0t), (t1m, z3), (t0t, t3), (z3, t4),
    ])
    X3, Y3, Z3 = f.red([f.wsub(b, a), f.wadd(d, c), f.wadd(g, e)])
    return (X3, Y3, Z3)


def double(f: LazyOps | Fp2LazyOps, p):
    """Complete doubling (RCB15 Alg 9, a=0), lazily reduced: 8 muls."""
    X, Y, Z = p
    t0, tyz, tzz, txy = f.red(f.mulp([(Y, Y), (Y, Z), (Z, Z), (X, Y)]))
    y8 = f.fold_sum(f.scale(t0, 8))
    t2 = f.fold_sum(f.mul_b3(tzz))
    ysum = f.fold_sum(f.add(t0, t2))  # 2F -> F
    tdiff = f.fold_sum(f.sub(t0, f.scale(t2, 3)))  # 4F -> F
    x3m, Z3, aa, bb = f.mulp([(t2, y8), (tyz, y8), (tdiff, ysum), (tdiff, txy)])
    X3, Y3, Z3 = f.red([f.wadd(bb, bb), f.wadd(x3m, aa), Z3])
    return (X3, Y3, Z3)
