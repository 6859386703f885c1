"""The strict radix-16 engine over stacked limb tensors `(L, *batch)`.

Counterpart of `ark_blst_tpu/ops/fieldops.py` (the "list engine"): a batch
of field elements is an int32 tensor whose leading axis holds the L
little-endian 16-bit limbs. Values are canonical (every op ends in
`_cond_sub_list`, so every result is < p) and in Montgomery form with
R = 2^(16 L). The functions keep the JAX names; where JAX walks Python
lists of per-limb arrays, these take the stacked tensor and do each limb
loop as one tensor op. Limb products are formed in int64: (2^16 - 1)^2
does not fit int32.

`mul`, `add`, `sub` and `neg` are the plain versions of the strict kernels
K7-K10 (`strict_field.py`, `csrc/strict_field.cu`). Every function takes
any `FieldSpec`. `normalize_list` and `is_zero` also serve the lazy
engine's `canonicalize` and the MSM prepare stage.
"""

from __future__ import annotations

import functools
import math

import torch

from .limbs import LIMB_BITS, MASK, FieldSpec, int_to_limbs


@functools.lru_cache(maxsize=None)
def const_limbs(value: int, num_limbs: int) -> tuple:
    """Python-int constant -> tuple of Python-int limbs."""
    return tuple(int(v) for v in int_to_limbs(value, num_limbs))


@functools.lru_cache(maxsize=None)
def _limb_column(limbs: tuple, ndim: int, device, dtype=torch.int64) -> torch.Tensor:
    """Python-int limbs -> a `(len, 1, ..., 1)` tensor with `ndim` dims in
    all, which broadcasts against `(len, *batch)`. Cached (a few constants
    per field and device); callers never write to it."""
    t = torch.tensor(limbs, dtype=dtype, device=device)
    return t.reshape((len(limbs),) + (1,) * (ndim - 1))


# --- normalization (exact, Kogge-Stone carry lookahead) ----------------------

def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Move every row d places up the leading axis, zero-filling the bottom."""
    out = torch.zeros_like(x)
    out[d:] = x[:-d]
    return out


def normalize_list(t: torch.Tensor, out_len: int) -> torch.Tensor:
    """Relaxed nonnegative digits (values < 2^31), stacked `(n, *batch)` int32
    -> strict 16-bit digits `(out_len, *batch)` of the same value, truncated
    mod 2^(16*out_len).

    One digit fold (a < 2^16 plus b < 2^15 per digit), then a Kogge-Stone
    carry lookahead: log2(width) rounds of whole-tensor ops, no ripple.
    """
    n = t.shape[0]
    width = max(n + 1, out_len)
    batch = t.shape[1:]
    s = torch.zeros((width,) + batch, dtype=torch.int32, device=t.device)
    s[:n] = t & MASK
    s[1 : n + 1] += t >> LIMB_BITS  # digit sums < 2^16 + 2^15
    g = s >> LIMB_BITS  # generate: 0 or 1
    p = (s & MASK) == MASK  # propagate
    d = 1
    while d < width:
        g = g | torch.where(p, _shift_up(g, d), 0)
        p = p & _shift_up(p, d)
        d *= 2
    return (s[:out_len] + _shift_up(g, 1)[:out_len]) & MASK


# --- schoolbook products -----------------------------------------------------

# the batch size from which a loop over one factor's limbs, whose working
# set is one row of products, beats one outer product of all limb pairs
_ROW_LOOP_FROM = 256


@functools.lru_cache(maxsize=None)
def _column_index(la: int, lb: int, device) -> torch.Tensor:
    """i + j for the (i, j) limb products, flattened (cached, read-only)."""
    return (torch.arange(la)[:, None] + torch.arange(lb)[None, :]).reshape(-1).to(device)


def _product_columns(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Limb stacks a (la, *batch) and b (lb, *batch), broadcastable ->
    relaxed int32 columns (out_len, *batch) of the product: limb product
    (i, j), exact in int64, adds its low 16 bits to column i+j and its high
    bits to column i+j+1; columns from out_len on are dropped. Every column
    is < 2 * min(la, lb) * 2^16. Small batches take one outer product of all
    limb pairs, large ones a loop over a's limbs: the same sums."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    la, lb = a.shape[0], b.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((la + lb + 1,) + batch, dtype=torch.int64, device=a.device)
    if math.prod(batch) < _ROW_LOOP_FROM:
        prod = (a[:, None] * b[None, :]).reshape((la * lb,) + batch)
        col = _column_index(la, lb, a.device)
        acc.index_add_(0, col, prod & MASK)
        acc.index_add_(0, col + 1, prod >> LIMB_BITS)
    else:
        for i in range(min(la, out_len)):
            prod = a[i] * b
            acc[i : i + lb] += prod & MASK
            acc[i + 1 : i + lb + 1] += prod >> LIMB_BITS
    return acc[:out_len].to(torch.int32)


def mul_wide_list(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product: strict stacks (la and lb limbs) -> relaxed (la+lb)."""
    return _product_columns(a, b, a.shape[0] + b.shape[0])


def mul_const_wide_list(a: torch.Tensor, c_limbs) -> torch.Tensor:
    """Full product by a constant given as Python-int limbs."""
    c = _limb_column(tuple(c_limbs), a.dim(), a.device)
    return _product_columns(a, c, a.shape[0] + len(c_limbs))


def mul_low_list(a: torch.Tensor, b_or_const, out_len: int, const: bool = False) -> torch.Tensor:
    """Low `out_len` digits of a product (relaxed), i.e. mod 2^(16*out_len).
    With `const`, the second factor is Python-int limbs."""
    b = _limb_column(tuple(b_or_const), a.dim(), a.device) if const else b_or_const
    return _product_columns(a[:out_len], b[:out_len], out_len)


# --- modular core --------------------------------------------------------------

def _cond_sub_list(u: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """u strict digits, value < 2p -> u mod p."""
    L = spec.num_limbs
    pc = const_limbs((1 << (LIMB_BITS * L)) - 1 - spec.modulus, L)  # R-1-p
    t = u + _limb_column(pc, u.dim(), u.device, torch.int32)
    t[0] += 1
    v = normalize_list(t, L + 1)
    ge = v[L] == 1  # u + R - p carries out iff u >= p
    return torch.where(ge, v[:L], u)


def _mont_mul_list(a: torch.Tensor, b, spec: FieldSpec, b_const=None) -> torch.Tensor:
    """Montgomery product a*b/R mod p: full product, low product by -p^-1,
    the exact division by R, one conditional subtraction. For canonical
    inputs t + m*p < 2pR, so the truncation mod R^2 below never bites."""
    L = spec.num_limbs
    if b_const is not None:
        t = normalize_list(mul_const_wide_list(a, b_const), 2 * L)
    else:
        t = normalize_list(mul_wide_list(a, b), 2 * L)
    m = normalize_list(mul_low_list(t[:L], const_limbs(spec.ninv, L), L, const=True), L)
    mp = mul_const_wide_list(m, const_limbs(spec.modulus, L))
    u = normalize_list(t + mp, 2 * L)
    return _cond_sub_list(u[L:], spec)


# --- the stacked API -----------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    t = a + b  # digits < 2^17
    return _cond_sub_list(normalize_list(t, spec.num_limbs), spec)


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    L = spec.num_limbs
    p = _limb_column(const_limbs(spec.modulus, L), max(a.dim(), b.dim()), a.device, torch.int32)
    t = a + (MASK - b) + p
    t[0] += 1  # a - b + p + R
    return _cond_sub_list(normalize_list(t, L), spec)


def neg(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    L = spec.num_limbs
    p = _limb_column(const_limbs(spec.modulus, L), a.dim(), a.device, torch.int32)
    t = (MASK - a) + p
    t[0] += 1  # p - a + R
    return _cond_sub_list(normalize_list(t, L), spec)


def mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product (both operands and the result in Montgomery form)."""
    return _mont_mul_list(a, b, spec)


def sqr(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mul(a, a, spec)


def mul_small(a: torch.Tensor, value: int, spec: FieldSpec) -> torch.Tensor:
    """Multiply by a small plain-integer constant (2, 3, 8, 12, ...) with a
    double-and-add chain of modular additions."""
    if value < 1:
        raise ValueError(f"mul_small wants a positive constant, got {value}")
    r = a
    for bit in bin(value)[3:]:
        r = add(r, r, spec)
        if bit == "1":
            r = add(r, a, spec)
    return r


def mont_from_int_array(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Canonical stacked limbs -> Montgomery form."""
    return _mont_mul_list(a, None, spec, b_const=const_limbs(spec.mont_r2, spec.num_limbs))


def mont_to_int_array(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    one = (1,) + (0,) * (spec.num_limbs - 1)
    return _mont_mul_list(a, None, spec, b_const=one)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """`(L, *batch)` limbs -> `batch`-shaped bool: every limb is zero."""
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask shaped like the batch; broadcast over the leading limb axis."""
    return torch.where(mask[None], a, b)


def zeros(batch_shape, spec: FieldSpec, device) -> torch.Tensor:
    return torch.zeros((spec.num_limbs,) + tuple(batch_shape), dtype=torch.int32, device=device)


def consts(value: int, batch_shape, spec: FieldSpec, device) -> torch.Tensor:
    """Broadcast a host int (already in the wanted form) to a stacked batch
    (a broadcast view, as the JAX package's `jnp.broadcast_to`)."""
    limbs = torch.from_numpy(int_to_limbs(value, spec.num_limbs)).to(device)
    batch_shape = tuple(batch_shape)
    return limbs.reshape((spec.num_limbs,) + (1,) * len(batch_shape)).expand(
        (spec.num_limbs,) + batch_shape)
