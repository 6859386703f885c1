"""The chain kernels' word stacks and their plain conversions to and from
the lazy tower's digits.

The chains (`csrc/tower381.cuh`) hold an Fp component as 12 canonical
32-bit Montgomery words, v 2^384 mod p in [0, p), kept in int32: a stack
is `(..., 12, n)`, word k of element i at `[..., k, i]`. K5-chain hands its
lines to K6-chain in that form (`curves/pairing_steps.py`), FE-easy its
result to FE-hard (`ops/final_exp.py`), and K4 its products to the next
level of the multi-pairings' fold (`ops/fp12_mul.py`). The plain versions
here turn such a stack into the lazy tower's digits and back, to hold the
words against a plain version's digits and to hand a word-taking kernel
the value of digits, and into the strict `(24, n)` limbs of
`ops/convert.py`, the same number as the words, two limbs to a word.
"""

from __future__ import annotations

import torch

from . import lazy13 as LZ
from . import tower_lazy as TL

WORDS = 12  # 32-bit words of an Fp component in the card's word stacks
LIMBS = 24  # strict 16-bit limbs of an Fp component (`ops/convert.py`)
# The formats of a kernel's edge rows (csrc/tower381.cuh EdgeFormat):
# radix-13 digits, strict 16-bit limbs, canonical words
FMT_DIGITS, FMT_LIMBS, FMT_WORDS = 0, 1, 2


def split(m: int) -> list:
    """A nonnegative int below 2^384 -> its 12 little-endian 32-bit words."""
    return [(m >> (32 * k)) & 0xFFFFFFFF for k in range(WORDS)]


def words_to_digits_plain(w: torch.Tensor) -> torch.Tensor:
    """(..., 12, n) canonical Montgomery words (v 2^384) -> (..., 30, n)
    balanced digits of the same field elements in the lazy domain (v 2^390
    = the words' value times 2^6, below 2^387): the plain version of the
    kernels' conversion out, to hold a word stack against digits."""
    u = w.long() & 0xFFFFFFFF
    cols = []
    for k in range(LZ.L13):
        start = LZ.RADIX * k - 6  # digit k of W 2^6: bits [13 k - 6, 13 k + 7) of W
        if start < 0:
            d = u[..., 0, :] << -start
        else:
            j, off = divmod(start, 32)
            d = u[..., j, :] >> off
            if off > 32 - LZ.RADIX and j + 1 < WORDS:
                d = d | (u[..., j + 1, :] << (32 - off))
        cols.append(d & LZ.DMASK)
    d = torch.stack(cols).to(torch.int32)  # (30, ..., n), digits in [0, 8191]
    return LZ.fold(d, LZ.L13).movedim(0, -2).contiguous()


def digits_to_words_plain(d: torch.Tensor) -> torch.Tensor:
    """(..., 30, n) mul-ready digits of the lazy domain (v 2^390) -> (...,
    12, n) canonical Montgomery words (v 2^384), on d's device: the lazy
    egress (`tower_lazy.fp_egress`, the strict limbs of v 2^384 mod p), two
    limbs packed to a word. The plain version of the kernels' conversion
    in, to hand a word-taking kernel the value of a plain version's
    digits."""
    limbs = TL.fp_egress(d.movedim(-2, 0).reshape(LZ.L13, -1)).long()  # (24, rows n)
    w = limbs[0::2] | (limbs[1::2] << 16)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return w.reshape(WORDS, *d.shape[:-2], d.shape[-1]).movedim(0, -2).contiguous()


def words_to_limbs_plain(w: torch.Tensor) -> torch.Tensor:
    """(..., 12, n) canonical words -> (..., 24, n) strict 16-bit limbs of
    the same number (`ops/convert.py`'s layout: word k is limb 2k | limb
    2k + 1 << 16): the plain version of the kernels' store of strict limbs,
    equal to the lazy egress (`tower_lazy.fp_egress`) of the words' digits
    limb for limb."""
    u = w.long() & 0xFFFFFFFF
    limbs = torch.stack([u & 0xFFFF, u >> 16], dim=-2)  # (..., 12, 2, n)
    return limbs.reshape(*w.shape[:-2], LIMBS, w.shape[-1]).to(torch.int32)


def limbs_to_digits_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., 24, n) strict limbs (v 2^384, any number below 2^384, taken mod
    p) -> (..., 30, n) digits of the same field elements in the lazy domain
    (`tower_lazy.fp_ingest`): the plain version of the kernels' load of
    strict limbs, to hand a plain version the value of a strict stack."""
    return TL.fp_ingest(x.movedim(-2, 0)).movedim(0, -2).contiguous()
