"""Arkworks/ZCash-compatible serialization for BLS12-381 (pure Python).

The port's own copy of the JAX package's `oracle/serialize.py`, byte for
byte the same formats:

* Field elements: raw little-endian dumps; `compress` is ignored.
  Fp = 48 B, Scalar = 32 B, Fp2 = 96 B (c0 || c1), Fp6 = 288 B,
  Fp12 = 576 B.
* Group points: ZCash/blst big-endian with flag bits in the 3 MSBs of byte 0:
  0x80 = compressed, 0x40 = infinity, 0x20 = y is lexicographically largest.
  G1 compressed 48 B / uncompressed 96 B, G2 compressed 96 B / uncompressed
  192 B; G2 x encoded as c1 || c0 big-endian. Decoding rejects bad flags,
  non-canonical coordinates and (with `validate`) points off the curve or
  outside the r-torsion subgroup with ValueError.
"""

from __future__ import annotations

from . import field as F
from . import curve as C

COMPRESSED_FLAG = 0x80
INFINITY_FLAG = 0x40
SIGN_FLAG = 0x20


# --- Field elements (raw little-endian) --------------------------------------

def fp_to_bytes(a):
    return int(a).to_bytes(48, "little")


def fp_from_bytes(b):
    v = int.from_bytes(b[:48], "little")
    if v >= F.P:
        raise ValueError("fp value not canonical")
    return v


def scalar_to_bytes(a):
    return int(a).to_bytes(32, "little")


def scalar_from_bytes(b):
    v = int.from_bytes(b[:32], "little")
    if v >= F.R:
        raise ValueError("scalar value not canonical")
    return v


def fp2_to_bytes(a):
    return fp_to_bytes(a[0]) + fp_to_bytes(a[1])


def fp2_from_bytes(b):
    return (fp_from_bytes(b[0:48]), fp_from_bytes(b[48:96]))


def fp6_to_bytes(a):
    return b"".join(fp2_to_bytes(c) for c in a)


def fp6_from_bytes(b):
    return tuple(fp2_from_bytes(b[i * 96:(i + 1) * 96]) for i in range(3))


def fp12_to_bytes(a):
    return fp6_to_bytes(a[0]) + fp6_to_bytes(a[1])


def fp12_from_bytes(b):
    return (fp6_from_bytes(b[0:288]), fp6_from_bytes(b[288:576]))


# --- G1 ----------------------------------------------------------------------

def _fp_sign(y):
    return y > (F.P - 1) // 2


def g1_compress(pt):
    if pt is None:
        out = bytearray(48)
        out[0] = COMPRESSED_FLAG | INFINITY_FLAG
        return bytes(out)
    x, y = pt
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= COMPRESSED_FLAG
    if _fp_sign(y):
        out[0] |= SIGN_FLAG
    return bytes(out)


def g1_uncompressed(pt):
    if pt is None:
        out = bytearray(96)
        out[0] = INFINITY_FLAG
        return bytes(out)
    x, y = pt
    return int(x).to_bytes(48, "big") + int(y).to_bytes(48, "big")


def g1_decompress(b, validate=True):
    if len(b) < 48:
        raise ValueError("short G1 compressed input")
    flags = b[0]
    if not flags & COMPRESSED_FLAG:
        raise ValueError("compressed flag not set")
    if flags & INFINITY_FLAG:
        if any(b[1:48]) or flags & SIGN_FLAG or b[0] != (COMPRESSED_FLAG | INFINITY_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    if x >= F.P:
        raise ValueError("x not canonical")
    y2 = (x * x % F.P * x + F.B_G1) % F.P
    y = F.fp_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    if _fp_sign(y) != bool(flags & SIGN_FLAG):
        y = F.P - y
    pt = (x, y)
    if validate and not C.is_in_subgroup(C.FP_OPS, pt):
        raise ValueError("point not in subgroup")
    return pt


def g1_from_uncompressed(b, validate=True):
    if len(b) < 96:
        raise ValueError("short G1 uncompressed input")
    flags = b[0]
    if flags & COMPRESSED_FLAG:
        raise ValueError("compressed flag set on uncompressed input")
    if flags & INFINITY_FLAG:
        if any(b[1:96]) or flags != INFINITY_FLAG:
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    y = int.from_bytes(b[48:96], "big")
    if x >= F.P or y >= F.P:
        raise ValueError("coordinate not canonical")
    pt = (x, y)
    if validate:
        if not C.is_on_curve(C.FP_OPS, pt):
            raise ValueError("point not on curve")
        if not C.is_in_subgroup(C.FP_OPS, pt):
            raise ValueError("point not in subgroup")
    return pt


# --- G2 ----------------------------------------------------------------------

def g2_compress(pt):
    if pt is None:
        out = bytearray(96)
        out[0] = COMPRESSED_FLAG | INFINITY_FLAG
        return bytes(out)
    (x0, x1), y = pt
    out = bytearray(int(x1).to_bytes(48, "big") + int(x0).to_bytes(48, "big"))
    out[0] |= COMPRESSED_FLAG
    if F.fp2_lexicographically_largest(y):
        out[0] |= SIGN_FLAG
    return bytes(out)


def g2_uncompressed(pt):
    if pt is None:
        out = bytearray(192)
        out[0] = INFINITY_FLAG
        return bytes(out)
    (x0, x1), (y0, y1) = pt
    return (
        int(x1).to_bytes(48, "big") + int(x0).to_bytes(48, "big")
        + int(y1).to_bytes(48, "big") + int(y0).to_bytes(48, "big")
    )


def g2_decompress(b, validate=True):
    if len(b) < 96:
        raise ValueError("short G2 compressed input")
    flags = b[0]
    if not flags & COMPRESSED_FLAG:
        raise ValueError("compressed flag not set")
    if flags & INFINITY_FLAG:
        if any(b[1:96]) or flags != (COMPRESSED_FLAG | INFINITY_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:96], "big")
    if x0 >= F.P or x1 >= F.P:
        raise ValueError("x not canonical")
    x = (x0, x1)
    y2 = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), F.B_G2)
    y = F.fp2_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    if F.fp2_lexicographically_largest(y) != bool(flags & SIGN_FLAG):
        y = F.fp2_neg(y)
    pt = (x, y)
    if validate and not C.is_in_subgroup(C.FP2_OPS, pt):
        raise ValueError("point not in subgroup")
    return pt


def g2_from_uncompressed(b, validate=True):
    if len(b) < 192:
        raise ValueError("short G2 uncompressed input")
    flags = b[0]
    if flags & COMPRESSED_FLAG:
        raise ValueError("compressed flag set on uncompressed input")
    if flags & INFINITY_FLAG:
        if any(b[1:192]) or flags != INFINITY_FLAG:
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:96], "big")
    y1 = int.from_bytes(b[96:144], "big")
    y0 = int.from_bytes(b[144:192], "big")
    for v in (x0, x1, y0, y1):
        if v >= F.P:
            raise ValueError("coordinate not canonical")
    pt = ((x0, x1), (y0, y1))
    if validate:
        if not C.is_on_curve(C.FP2_OPS, pt):
            raise ValueError("point not on curve")
        if not C.is_in_subgroup(C.FP2_OPS, pt):
            raise ValueError("point not in subgroup")
    return pt
