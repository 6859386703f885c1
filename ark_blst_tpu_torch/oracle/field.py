"""Pure-Python BLS12-381 base-field constants and Fp ops (host ints).

The port's own copy of what it needs from the JAX package's field oracle:
the moduli, the G1 generator and the Fp operations that the host finish
of the MSM (`curves/msm_bucket._finish_host`) and the codecs use.

Representation: an Fp element is a Python int in [0, P).
"""

from __future__ import annotations

# Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus r (255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Generator of G1: y^2 = x^3 + 4 over Fp.
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)


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
