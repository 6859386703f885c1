"""G1 and G2 in the strict radix-16 layout: the projective identities and the
complete group law of the strict engine.

Counterpart of `ark_blst_tpu/curves/group.py`: the Renes-Costello-Batina
complete formulas for a=0 short-Weierstrass curves (eprint 2015/1060,
Algorithms 7 and 9), one branch-free formula that is right for every input
pair (identity, doubling, inverses). A point batch is a tuple (X, Y, Z) of
field batches: stacked `(24, *batch)` limb tensors for G1, fp2 pairs of
them for G2; homogeneous projective in Montgomery form, identity
(0 : 1 : 0). One `CurveOps` per curve binds a `FieldAdapter`, so G1 and G2
share all code. Every field op runs through `ops/dispatch.py`, i.e. K7-K10
for CUDA tensors; the scan MSM's chains and the scalar multiplication's
ladder (`ops/scan_msm.py`) run the same additions and doublings in one
launch each, with these as their plain versions.

Constructors take the torch device where the JAX package's arrays had none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops import dispatch as D
from ..ops import fieldops as FO
from ..ops import scan_msm as SM
from ..ops import tower as T
from ..ops.limbs import FP, int_to_limbs

_B3_G1 = 12  # 3 * b for y^2 = x^3 + 4


def _zero_one(n: int, device):
    zero = torch.zeros((FP.num_limbs, n), dtype=torch.int32, device=device)
    one = torch.from_numpy(int_to_limbs(FP.mont_r, FP.num_limbs)).to(device)
    return zero, one[:, None].expand(-1, n).contiguous()


def g1_identity(n: int, device="cpu"):
    """Strict projective identity (0 : 1 : 0) in Montgomery-R16 form, batch
    (n,): three `(24, n)` int32 limb tensors."""
    zero, one = _zero_one(n, device)
    return (zero, one, zero.clone())


def g2_identity(n: int, device="cpu"):
    """Strict projective identity over Fp2, batch (n,): x = (0, 0),
    y = (R16 mod p, 0), z = (0, 0), each component a `(24, n)` int32 limb
    tensor."""
    zero, one = _zero_one(n, device)
    return ((zero, zero.clone()), (one, zero.clone()), (zero.clone(), zero.clone()))


# --- field adapters ----------------------------------------------------------

@dataclass(frozen=True)
class FieldAdapter:
    """Uniform field interface so one curve implementation serves Fp and Fp2."""

    name: str
    add: Callable
    sub: Callable
    neg: Callable
    mul_many: Callable
    mul_b3: Callable  # multiply by 3*b of the curve
    inv: Callable
    sqr_many: Callable
    eq: Callable
    is_zero: Callable
    zero: Callable  # (batch_shape, device) -> element
    one: Callable  # (batch_shape, device) -> element (Montgomery one)
    batch_shape: Callable
    device: Callable


FP_ADAPTER = FieldAdapter(
    name="fp",
    add=D.fp_add,
    sub=D.fp_sub,
    neg=D.fp_neg,
    mul_many=D.fp_mul_many,
    mul_b3=lambda a: D.fp_mul_small(a, _B3_G1),
    inv=D.fp_inv,
    sqr_many=lambda xs: D.fp_mul_many([(x, x) for x in xs]),
    eq=FO.eq,
    is_zero=FO.is_zero,
    zero=lambda shape, device: FO.zeros(shape, FP, device),
    one=lambda shape, device: T.fp_const(1, shape, device),
    batch_shape=lambda a: a.shape[1:],
    device=lambda a: a.device,
)

FP2_ADAPTER = FieldAdapter(
    name="fp2",
    add=T.fp2_add,
    sub=T.fp2_sub,
    neg=T.fp2_neg,
    mul_many=T.fp2_mul_many,
    # b3 = 12*(1+u) = 12*xi: the nonresidue, then the small constant
    mul_b3=lambda a: T.fp2_mul_small(T.fp2_mul_by_nonresidue(a), 12),
    inv=T.fp2_inv,
    sqr_many=T.fp2_sqr_many,
    eq=T.fp2_eq,
    is_zero=T.fp2_is_zero,
    zero=lambda shape, device: (FO.zeros(shape, FP, device), FO.zeros(shape, FP, device)),
    one=lambda shape, device: (T.fp_const(1, shape, device), FO.zeros(shape, FP, device)),
    batch_shape=lambda a: a[0].shape[1:],
    device=lambda a: a[0].device,
)


def _interleave(lo, hi):
    """Inverse of the even/odd split: leaves (..., m) + (..., m) -> (..., 2m)."""
    def ix(a, b):
        return torch.stack([a, b], dim=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],))

    return T.tree_map(ix, lo, hi)


# --- curve ops ---------------------------------------------------------------

@dataclass(frozen=True)
class CurveOps:
    name: str
    f: FieldAdapter

    # -- constructors --

    def identity(self, batch_shape, device):
        f = self.f
        return (f.zero(batch_shape, device), f.one(batch_shape, device),
                f.zero(batch_shape, device))

    def from_affine(self, x, y, inf_mask):
        """Affine (x, y) + infinity mask -> projective. Identity -> (0,1,0)."""
        sel = lambda a, b: T.select(inf_mask, a, b)
        sh, dev = self.f.batch_shape(x), self.f.device(x)
        zero, one = self.f.zero(sh, dev), self.f.one(sh, dev)
        return (sel(zero, x), sel(one, y), sel(zero, one))

    def to_affine(self, pt):
        """Projective -> (x, y, inf_mask); identity maps to (0, 0, True).
        One batch inversion over the trailing batch axis."""
        x, y, z = pt
        zinv = self.batch_inv(z)  # 0 -> 0, so the identity lands on (0, 0)
        xa, ya = self.f.mul_many([(x, zinv), (y, zinv)])
        return xa, ya, self.is_identity(pt)

    def batch_inv(self, v):
        """Batched field inversion via a log-depth Montgomery product tree:
        ~4N products and ONE Fermat inversion (at batch 1) instead of N.
        Zero maps to zero.

        Up-sweep: pairwise products to the root (zeros masked to one); the
        root inverted once; down-sweep: each child's inverse = parent
        inverse x sibling."""
        f = self.f
        shape, dev = f.batch_shape(v), f.device(v)
        if not shape:  # scalar batch: nothing to amortize
            return f.inv(v)
        n = shape[-1]
        size = 1 << max(0, (n - 1)).bit_length()
        zmask = f.is_zero(v)
        v1 = T.select(zmask, f.one(shape, dev), v)  # zeros -> 1 in the tree
        if size != n:
            pad = f.one(shape[:-1] + (size - n,), dev)
            v1 = T.tree_map(lambda a, p: torch.cat([a, p], dim=-1), v1, pad)
        levels = [v1]
        cur, m = v1, size
        while m > 1:
            lo = T.tree_map(lambda a: a[..., 0::2], cur)
            hi = T.tree_map(lambda a: a[..., 1::2], cur)
            (cur,) = f.mul_many([(lo, hi)])
            levels.append(cur)
            m //= 2
        inv = f.inv(cur)  # one Fermat inversion, batch size 1
        for lvl in reversed(levels[:-1]):
            lo = T.tree_map(lambda a: a[..., 0::2], lvl)
            hi = T.tree_map(lambda a: a[..., 1::2], lvl)
            inv_lo, inv_hi = f.mul_many([(inv, hi), (inv, lo)])
            inv = _interleave(inv_lo, inv_hi)
        if size != n:
            inv = T.tree_map(lambda a: a[..., :n], inv)
        return T.select(zmask, f.zero(shape, dev), inv)

    # -- predicates --

    def is_identity(self, pt):
        return self.f.is_zero(pt[2])

    def eq(self, p, q):
        """Projective equality: cross-multiplied coordinate comparison."""
        x1, y1, z1 = p
        x2, y2, z2 = q
        a, b, c, d = self.f.mul_many([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
        both_inf = self.f.is_zero(z1) & self.f.is_zero(z2)
        one_inf = self.f.is_zero(z1) ^ self.f.is_zero(z2)
        return (self.f.eq(a, b) & self.f.eq(c, d) & ~one_inf) | both_inf

    # -- group law --

    def neg(self, pt):
        return (pt[0], self.f.neg(pt[1]), pt[2])

    def add(self, p, q):
        """Complete projective addition (RCB15 Algorithm 7, a=0). Valid for
        every input pair; no branches. Two product rounds of six."""
        f = self.f
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        t0, t1, t2, m3, m4, m5 = f.mul_many(
            [
                (X1, X2),
                (Y1, Y2),
                (Z1, Z2),
                (f.add(X1, Y1), f.add(X2, Y2)),
                (f.add(Y1, Z1), f.add(Y2, Z2)),
                (f.add(X1, Z1), f.add(X2, Z2)),
            ]
        )
        t3 = f.sub(m3, f.add(t0, t1))  # X1Y2 + X2Y1
        t4 = f.sub(m4, f.add(t1, t2))  # Y1Z2 + Y2Z1
        ty = f.sub(m5, f.add(t0, t2))  # X1Z2 + X2Z1
        t0 = f.add(f.add(t0, t0), t0)  # 3 X1X2
        t2 = f.mul_b3(t2)              # b3 Z1Z2
        z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        ty = f.mul_b3(ty)              # b3 (X1Z2 + X2Z1)
        a, b, c, d, e, g = f.mul_many(
            [
                (t4, ty),
                (t3, t1),
                (ty, t0),
                (t1, z3),
                (t0, t3),
                (z3, t4),
            ]
        )
        X3 = f.sub(b, a)
        Y3 = f.add(d, c)
        Z3 = f.add(g, e)
        return (X3, Y3, Z3)

    def double(self, p):
        """Complete projective doubling (RCB15 Algorithm 9, a=0): 8 products
        in two batched rounds."""
        f = self.f
        X, Y, Z = p
        t0, tyz, tzz, txy = f.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        y8 = f.add(t0, t0)
        y8 = f.add(y8, y8)
        y8 = f.add(y8, y8)        # 8 Y^2
        t2 = f.mul_b3(tzz)        # b3 Z^2
        ysum = f.add(t0, t2)      # Y^2 + b3 Z^2
        tdiff = f.sub(t0, f.add(f.add(t2, t2), t2))  # Y^2 - 3 b3 Z^2
        x3m, Z3, a, b = f.mul_many(
            [(t2, y8), (tyz, y8), (tdiff, ysum), (tdiff, txy)]
        )
        X3 = f.add(b, b)
        Y3 = f.add(x3m, a)
        return (X3, Y3, Z3)

    # -- scalar multiplication --

    def scalar_mul(self, pt, scalar_limbs, num_bits: int = 255):
        """Per-element double-and-add over batch scalars (plain Fr limbs,
        stacked (16, *batch)), MSB first, branch-free: every step doubles,
        adds and selects (the JAX `lax.scan`). CUDA tensors: one scan-mul
        launch (`ops/scan_msm.py:scalar_mul`); CPU tensors: its plain loop
        on this group law (`scalar_mul_plain`)."""
        return SM.scalar_mul(self, pt, scalar_limbs, num_bits)


G1 = CurveOps("g1", FP_ADAPTER)
G2 = CurveOps("g2", FP2_ADAPTER)
