"""Batched field primitives of the strict engine, one calling convention
(stacked `(L, *batch)` int32 limbs in Montgomery form).

Counterpart of `ark_blst_tpu/ops/dispatch.py`. There is one route: the
`strict_field` wrappers, which launch K7-K10 for CUDA tensors and run their
plain versions for CPU tensors; the Fp inverse, whose Fermat ladder the
JAX package runs as one `lax.scan` of K7, is one K7-inv launch
(`fp_inv.fp_inv_limbs`). The JAX package's backend switch
(`set_backend`, `use_pallas`) and its array-engine adapters are test hooks
and XLA:CPU workarounds there, and are not ported.
"""

from __future__ import annotations

from . import fieldops as FO
from . import fp_inv as FI
from . import strict_field as SF
from .limbs import FP, FieldSpec


def fp_mul(a, b, spec: FieldSpec = FP):
    return SF.mont_mul(a, b, spec)


def fp_sqr(a, spec: FieldSpec = FP):
    return fp_mul(a, a, spec)


def fp_add(a, b, spec: FieldSpec = FP):
    return SF.add(a, b, spec)


def fp_sub(a, b, spec: FieldSpec = FP):
    return SF.sub(a, b, spec)


def fp_neg(a, spec: FieldSpec = FP):
    return SF.neg(a, spec)


def fp_mul_many(pairs, spec: FieldSpec = FP):
    """[(a, b), ...] -> [a*b, ...] in one K7 launch."""
    return SF.mul_many(pairs, spec)


def fp_mul_small(a, value: int, spec: FieldSpec = FP):
    """Multiply by a small static integer constant via an add chain."""
    if value < 1:
        raise ValueError(f"fp_mul_small wants a positive constant, got {value}")
    r = a
    for bit in bin(value)[3:]:
        r = fp_add(r, r, spec)
        if bit == "1":
            r = fp_add(r, a, spec)
    return r


def fp_pow(a, exponent: int, spec: FieldSpec = FP):
    """a^e (Montgomery in and out) for a static exponent e >= 0: MSB-first
    square-and-multiply, one launch per product (the JAX `lax.scan` over the
    bits becomes a Python loop; a multiply by `a` is issued only for a set
    bit, where the scan computed it for every bit and selected)."""
    if exponent < 0:
        raise ValueError(f"fp_pow wants a nonnegative exponent, got {exponent}")
    f = FO.consts(spec.mont_r, a.shape[1:], spec, a.device)
    for bit in bin(exponent)[2:]:
        f = fp_mul(f, f, spec)
        if bit == "1":
            f = fp_mul(f, a, spec)
    return f


def fp_inv(a, spec: FieldSpec = FP):
    """Inverse (0 -> 0), batch-parallel: over Fp one K7-inv launch (a
    binary GCD) for a CUDA tensor, its plain version (the Fermat ladder,
    this module's `fp_pow` loop on the plain product) for a CPU one; over
    another field `fp_pow`."""
    if spec == FP:
        return FI.fp_inv_limbs(a)
    return fp_pow(a, spec.modulus - 2, spec)


def fp_sqrt_candidate(a, spec: FieldSpec = FP):
    """a^((p+1)/4): the square root when one exists (p = 3 mod 4); the
    caller checks candidate^2 == a."""
    return fp_pow(a, (spec.modulus + 1) // 4, spec)
