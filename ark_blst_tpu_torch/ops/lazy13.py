"""Signed lazy radix-13 Montgomery engine over stacked int32 tensors.

The PyTorch counterpart of `ark_blst_tpu/ops/lazy13.py`, digit for digit.
An element is a stacked `(n_digits, *batch)` int32 tensor, digit axis first,
so every step is a handful of whole-tensor ops rather than one op per digit.

Representation (unchanged from the JAX engine):

* digits are signed int32, radix 2^13; an element has ELEM = 30 digits and
  lives in the Montgomery domain R13 = 2^390;
* folds release carries lazily and leave BALANCED digits in [-4096, 4095]
  plus carry; "mul-ready" means |digit| <= F_BOUND = 4129;
* products accumulate raw digit products in int32 columns; a column of a
  mul-ready x mul-ready product is <= 30 * F^2 = 5.1e8, of a canonical x
  canonical one <= 30 * 8191^2 = 2.01e9, so no column leaves int32;
* values stay redundant in (-3p, 3p) and are canonicalized once, at egress.

Every product-column function of the JAX engine returns the TRUE convolution
(its Karatsuba forms included), so the plain schoolbook columns here give
the same digits: a loop of 30 shifted multiply-adds whose partial sums are
sums of subsets of the column's products and never leave int32.

Signed-int semantics relied on: two's-complement `&` and arithmetic `>>` on
int32 (a fold computes d = lo + 2^13 * carry exactly for negative d).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..oracle.field import P
from . import fieldops as FO

RADIX = 13
DMASK = (1 << RADIX) - 1  # 8191
L13 = 30  # digits spanning R13
ELEM = 30  # in-flight element length
R13 = 1 << (RADIX * L13)
L16 = 24  # strict engine limb count (16-bit limbs)

NINV13 = (-pow(P, -1, R13)) % R13  # -p^-1 mod R13
R13_MOD_P = R13 % P
R13_SQ = R13_MOD_P * R13_MOD_P % P

HALF = 4096
F_BOUND = 4129  # balanced fold2 digit bound: [-4096-33, 4095+33]


def int_to_digits(x: int, n: int = L13) -> np.ndarray:
    """Host: nonneg int -> n little-endian 13-bit digits (int32)."""
    if not 0 <= x < 1 << (RADIX * n):
        raise ValueError(f"{x} does not fit in {n} digits")
    return np.array([(x >> (RADIX * i)) & DMASK for i in range(n)], np.int32)


def digits_to_int(d) -> int:
    """Host: signed digit vector -> int (exact)."""
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(d).reshape(-1)))


def digits_to_ints(t: torch.Tensor) -> list:
    """Host: stacked `(n, *batch)` digits -> flat list of ints (batch order)."""
    mat = t.reshape(t.shape[0], -1).T.cpu().numpy().astype(np.int64)
    return [digits_to_int(row) for row in mat]


P_DIGITS = [int(v) for v in int_to_digits(P)]
NINV_DIGITS = [int(v) for v in int_to_digits(NINV13)]
ONE13 = [int(v) for v in int_to_digits(R13_MOD_P)]  # Montgomery one


@functools.lru_cache(maxsize=128)
def _const_col(values: tuple, device: str, ndim: int) -> torch.Tensor:
    """Host digit list -> `(n, 1, ..., 1)` int32 column on `device`."""
    t = torch.tensor(values, dtype=torch.int32, device=device)
    return t.reshape((len(values),) + (1,) * (ndim - 1))


def const(values, like: torch.Tensor) -> torch.Tensor:
    """Digits of a constant, shaped to broadcast against stacked `like`."""
    return _const_col(tuple(int(v) for v in values), str(like.device), like.dim())


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n,) + tuple(like.shape[1:]), dtype=torch.int32, device=like.device)


def _fit(t: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad the digit axis to n digits."""
    if t.shape[0] >= n:
        return t[:n]
    return torch.cat([t, _zeros(n - t.shape[0], t)])


# --- folds -------------------------------------------------------------------

def fold(t: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """One BALANCED carry-release pass:
        u = d + 4096;  lo = (u & DMASK) - 4096;  carry = u >> RADIX
        d_k <- lo_k + carry_{k-1}
    Output gains one digit unless out_len truncates (or pads with zeros)."""
    n = t.shape[0]
    u = t + HALF
    out = _zeros(n + 1, t)
    out[:n] = (u & DMASK) - HALF
    out[1:] += u >> RADIX
    return out if out_len is None else _fit(out, out_len)


def fold_nn(t: torch.Tensor) -> torch.Tensor:
    """UNbalanced fold (nonneg low parts), used only by canonicalize."""
    n = t.shape[0]
    out = _zeros(n + 1, t)
    out[:n] = t & DMASK
    out[1:] += t >> RADIX
    return out


def fold2(t: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """Two balanced folds: int32-relaxed digits -> |d| <= F_BOUND."""
    return fold(fold(t), out_len)


def fold_sum(t: torch.Tensor) -> torch.Tensor:
    """Make a sum of several elements mul-ready: one balanced fold, clamped
    to ELEM digits."""
    return fold(t)[:ELEM]


# --- add / sub / scale (free-form; caller tracks bounds) ---------------------

def _pad(a: torch.Tensor, b: torch.Tensor):
    n = max(a.shape[0], b.shape[0])
    return _fit(a, n), _fit(b, n)


def add(a, b):
    a, b = _pad(a, b)
    return a + b


def sub(a, b):
    a, b = _pad(a, b)
    return a - b


def neg(a):
    return -a


def scale(a, k: int):
    """Multiply by a small static int (|k| * digit bound must stay < 2^31)."""
    return a * k


def select(mask, a, b):
    """mask shaped like the batch: where(mask, a, b) digit-wise."""
    a, b = _pad(a, b)
    return torch.where(mask, a, b)


# --- products ----------------------------------------------------------------

def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product columns, schoolbook: `(la + lb - 1, *batch)`. Equals the
    JAX engine's `mul_wide` and `mul_wide_f` (both are the true
    convolution). Legal up to sum2 x sum2 or canonical x canonical operands."""
    la, lb = a.shape[0], b.shape[0]
    acc = _zeros(la + lb - 1, a if a.dim() >= b.dim() else b)
    for i in range(la):
        acc[i : i + lb] += a[i] * b
    return acc


def mul_const_wide(a: torch.Tensor, c_digits) -> torch.Tensor:
    """Product by a static constant (python-int digits, 0 <= c_d < 2^13).
    Equals the JAX engine's `mul_const_wide` and `mul_const_wide_f`."""
    la = a.shape[0]
    acc = _zeros(la + len(c_digits) - 1, a)
    for j, cj in enumerate(c_digits):
        if cj:
            acc[j : j + la] += a * int(cj)
    return acc


def mul_low_const(a: torch.Tensor, c_digits, out_len: int) -> torch.Tensor:
    """Low `out_len` columns of a product with a constant."""
    acc = _zeros(out_len, a)
    for j, cj in enumerate(c_digits[:out_len]):
        n = min(a.shape[0], out_len - j)
        if cj and n > 0:
            acc[j : j + n] += a[:n] * int(cj)
    return acc


# --- Montgomery reduction ----------------------------------------------------

def prered(w):
    """Wide product columns -> 'prered': fold2, so linear combinations of
    several products can share ONE reduction."""
    return fold2(w)


def reduce_wide(t: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce a linear combination of <= 12 prered wides: returns
    (value / R13) mod p as a mul-ready ELEM-digit element in (-3p, 3p).
    The low 30 digits of u = t + m*p are exactly zero-valued (balanced
    digits), so the result is u[30:60] with no carry detection."""
    t = fold(t)
    m = fold2(mul_low_const(t[:L13], NINV_DIGITS, L13), L13)
    u = fold2(add(t, mul_const_wide(m, P_DIGITS)))
    return _fit(u[L13:], ELEM)


def mont_mul(a, b):
    """Full Montgomery product for mul-ready operands: a*b/R13 mod p."""
    return reduce_wide(prered(mul_wide(a, b)))


def mont_mul_const(a, c_digits):
    return reduce_wide(prered(mul_const_wide(a, c_digits)))


# --- Fp2 layer (for G2) ------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1). Values are pairs (c0, c1) of stacked elements.

def fp2_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def fp2_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def fp2_neg(a):
    return (neg(a[0]), neg(a[1]))


def fp2_scale(a, k: int):
    return (scale(a[0], k), scale(a[1], k))


def fp2_fold_sum(a):
    return (fold_sum(a[0]), fold_sum(a[1]))


def fp2_select(mask, a, b):
    return (select(mask, a[0], b[0]), select(mask, a[1], b[1]))


def fp2_mul_prered(a, b):
    """Karatsuba -> pair of prered-combination wides (digit bounds re: 2F,
    im: 3F; safe to combine once more, up to 6F in all, before fp2_reduce)."""
    m0 = prered(mul_wide(a[0], b[0]))
    m1 = prered(mul_wide(a[1], b[1]))
    m2 = prered(mul_wide(fold_sum(add(a[0], a[1])), fold_sum(add(b[0], b[1]))))
    return (sub(m0, m1), sub(m2, add(m0, m1)))


def fp2_reduce(w):
    return (reduce_wide(w[0]), reduce_wide(w[1]))


def fp2_mont_mul(a, b):
    return fp2_reduce(fp2_mul_prered(a, b))


# --- stored (30-digit) form --------------------------------------------------

def store30(d):
    """Element (or small sum of elements, |value| <= 20p) -> 30 balanced
    digits of the same value."""
    return fold2(d, L13)


# --- representation conversion ----------------------------------------------

_F16_J = [(k * RADIX) // 16 for k in range(L13)]
_F16_OFF = [(k * RADIX) % 16 for k in range(L13)]
_F16_NEED = [off + RADIX > 16 and j + 1 < L16 for j, off in zip(_F16_J, _F16_OFF)]


def from_limbs16(a16: torch.Tensor) -> torch.Tensor:
    """Strict 16-bit limbs `(24, *batch)` (canonical, < 2^16 each) ->
    `(30, *batch)` canonical 13-bit digits of the same value. Pure bit
    splicing; the high limb is shifted by at most 12 bits, so every
    intermediate stays below 2^28."""
    lo = a16[_F16_J] >> const(_F16_OFF, a16)
    j1 = [min(j + 1, L16 - 1) for j in _F16_J]
    hi_shift = [16 - off if need else 0 for off, need in zip(_F16_OFF, _F16_NEED)]
    hi = a16[j1] << const(hi_shift, a16)
    need = const([int(v) for v in _F16_NEED], a16) != 0
    return (lo | torch.where(need, hi, 0)) & DMASK


def to_limbs16_strict(d: torch.Tensor) -> torch.Tensor:
    """STRICT nonneg 13-bit digits (30) -> 24 strict 16-bit limbs."""
    out = []
    for j in range(L16):
        k, off = divmod(j * 16, RADIX)
        v = d[k] >> off
        bits = RADIX - off
        while bits < 16 and k + 1 < L13:
            k += 1
            v = v | (d[k] << bits)
            bits += RADIX
        out.append(v & 0xFFFF)
    return torch.stack(out)


def _find_nonneg_multiple():
    """Host: smallest k in [8, 24] with all canonical digits of k*p >= 64."""
    for k in range(8, 25):
        digs = int_to_digits(k * P)
        if all(int(v) >= 64 for v in digs):
            return [int(v) for v in digs]
    raise AssertionError("no all-digits>=64 multiple of p found")


_POS_SHIFT = _find_nonneg_multiple()


def _find_pos_multiple():
    """Host: multiple of p with all canonical digits >= 1. Value <= 8p."""
    for k in range(1, 9):
        digs = int_to_digits(k * P)
        if all(int(v) >= 1 for v in digs):
            return [int(v) for v in digs]
    raise AssertionError("no all-digits>=1 multiple of p found")


_POS_SHIFT2 = _find_pos_multiple()

_N16 = 26  # relaxed repack width: value < 40p < 2^386


def canonicalize(d: torch.Tensor) -> torch.Tensor:
    """Mul-ready signed element, |value| < 8p -> STRICT canonical digits of
    (value mod p), 30 digits in [0, 2^13)."""
    x = add(d, const(_POS_SHIFT, d))  # value in (0, 32p)
    x = fold_nn(fold_nn(fold_nn(x)))  # digits in [-1, 8192]
    x = add(x, const(_POS_SHIFT2, x))
    x = fold_nn(x)  # digits in [0, 8192]
    acc = _zeros(_N16, x)
    for k in range(x.shape[0]):
        j, off = divmod(k * RADIX, 16)
        if j >= _N16:
            continue
        acc[j] += (x[k] << off) & 0xFFFF
        if off > 0 and j + 1 < _N16:
            acc[j + 1] += x[k] >> (16 - off)
    limbs = FO.normalize_list(acc, _N16)  # strict, value < 40p
    # conditional subtractions (borrow-free): x + (2^416 - k*p), keep on carry
    width = 1 << (16 * _N16)
    for k in (32, 16, 8, 4, 2, 1):
        comp = [((width - k * P) >> (16 * i)) & 0xFFFF for i in range(_N16)]
        v = FO.normalize_list(limbs + const(comp, limbs), _N16 + 1)
        limbs = torch.where(v[_N16] == 1, v[:_N16], limbs)
    return from_limbs16(limbs[:L16])[:L13]


def canonicalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Stacked (k, 30, *batch) mul-ready elements -> the canonical digits of
    each row's value mod p: equal for two stacks that hold the same field
    elements, whatever their redundant digits. A Montgomery product by one
    first brings any mul-ready value below 8p, `canonicalize`'s domain."""
    return canonicalize(mont_mul_const(x.transpose(0, 1), ONE13)).transpose(0, 1)
