"""Batched optimal-ate pairing on the card: G2 line precomputation, Miller
loop, final exponentiation.

Counterpart of `ark_blst_tpu/curves/pairing.py`, lazy engine, on a flat
`(30, N)` batch (the TPU's padding to 1024 and its (S, 128) tiles are not
inherited; every result is per element). The pipeline:

1. `prepare_g2`: Q ingested strict -> lazy, then one K5 launch per event
   (63 doublings, 5 additions) -> stacked line coefficients (68, 6, 30, N).
2. `miller_loop`: P ingested, f = one, then one K6 launch per event (with
   the square at the 63 doubling events) -> conj(f).
3. Identity inputs: masked to one after the Miller loop.
4. `final_exp`: easy part (fp12_inv: the Fermat ladder on K1; Frobenius
   constant products on K1; K4 products), then the cyclotomic chain: five
   `cyclotomic_exp_x_conj` ladders of K3 runs (n from `_X_SEGMENTS`) and K4
   products, K3 at n = 1 for the two lone squares.
5. Egress lazy -> strict (24, N) limbs.

Each `lax.scan` of the TPU path is a Python loop of kernel launches here;
the kernel wrappers run their plain versions on CPU tensors, so the CPU
tests walk the exact call sequence the card runs.
"""

from __future__ import annotations

import torch

from ..ops import cyc_sqr as K3
from ..ops import fp12_mul as K4
from ..ops import tower_lazy as TL
from ..oracle import pairing as OP
from . import pairing_steps as PS

# Miller-loop event schedule: one entry per line triple. True: square f,
# then the line (a doubling event); False: the line only (an addition).
MILLER_EVENTS = []
for _bit in OP.X_BITS:
    MILLER_EVENTS.append(True)
    if _bit:
        MILLER_EVENTS.append(False)
NUM_EVENTS = len(MILLER_EVENTS)

# bits of |x| MSB-first for the cyclotomic exponentiation ladder
X_ABS_BITS = [int(b) for b in bin(OP.X_ABS)[2:]]

# The |x| square-and-multiply ladder as segments: after the leading bit, a
# set bit at gap L costs L squarings then one product; trailing zeros are
# squarings only.
_X_SEGMENTS = []
_run = 0
for _bit in X_ABS_BITS[1:]:
    _run += 1
    if _bit:
        _X_SEGMENTS.append((_run, True))
        _run = 0
if _run:
    _X_SEGMENTS.append((_run, False))
del _run, _bit


def _fp2_one_zero_like(qx):
    """fp2 (1, 0) shaped like the fp2 batch qx."""
    zero = qx[0] * 0
    return (zero + TL._const_col(1, zero), zero)


def _fp12_one_like(px):
    """fp12 one shaped like the Fp batch px."""
    zero = px * 0
    one = zero + TL._const_col(1, zero)
    z2 = (zero, zero)
    return (((one, zero), z2, z2), (z2, z2, z2))


def _conj(x):
    """Conjugation of a stacked fp12 (the inverse on the cyclotomic
    subgroup): the w part negated, as `tower_lazy.fp12_conj`."""
    return torch.cat([x[:6], -x[6:]])


def _frobenius(x, power: int):
    return TL.stack12(TL.fp12_frobenius(TL.unstack12(x), power))


def egress(x):
    """Stacked lazy fp12 (12, 30, N) -> the strict fp12 batch."""
    return TL.fp12_egress(TL.unstack12(x))


# --- G2 line-coefficient precomputation ----------------------------------------

def prepare_g2(q, events=None) -> torch.Tensor:
    """Affine G2 batch (qx, qy) of strict fp2 leaves (24, N) -> line
    coefficients (E, 6, 30, N), E = 68 (or `events`), rows c0, c1, c2 of
    each event. Identity inputs give finite garbage; the Miller loop's
    caller masks those pairs to one."""
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    z = _fp2_one_zero_like(qx)
    rs = torch.stack([qx[0], qx[1], qy[0], qy[1], z[0], z[1]])
    qs = torch.stack([qx[0], qx[1], qy[0], qy[1]])
    coeffs = torch.empty((len(ev), 6) + tuple(rs.shape[1:]), dtype=torch.int32, device=rs.device)
    for i, is_dbl in enumerate(ev):
        out = PS.prepare_step(rs, None if is_dbl else qs)
        rs, coeffs[i] = out[:6], out[6:]
    return coeffs


# --- Miller loop ------------------------------------------------------------------

def miller_loop(p, coeffs, events=None) -> torch.Tensor:
    """Batched Miller loop: p = (px, py), strict (24, N) limbs, coeffs
    (E, 6, 30, N) from `prepare_g2`. Returns the stacked lazy fp12 batch
    (12, 30, N), conjugated (x < 0)."""
    px, py = TL.fp_ingest(p[0]), TL.fp_ingest(p[1])
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    fs = TL.stack12(_fp12_one_like(px))
    pxy = torch.stack([px, py])
    for i, is_dbl in enumerate(ev):
        fs = PS.miller_step(fs, coeffs[i], pxy, is_dbl)
    return _conj(fs)


# --- final exponentiation ------------------------------------------------------

def cyclotomic_exp_x_conj(f):
    """f^(-x) = conj(f^|x|) in the cyclotomic subgroup: per segment of the
    ladder, one K3 launch of n squarings, then one K4 product."""
    x = f
    for n_sqr, do_mul in _X_SEGMENTS:
        x = K3.cyc_sqr(x, n_sqr)
        if do_mul:
            x = K4.fp12_mul(x, f)
    return _conj(x)


def final_exp(f):
    """Easy part, then the BLS12-381 cyclotomic addition chain (the chain of
    `oracle/pairing.py:final_exp`), on stacked lazy fp12 (12, 30, N): the
    products through K4, the squares through K3, the inversion and the
    Frobenius maps on the tower (K1)."""
    ex, mul = cyclotomic_exp_x_conj, K4.fp12_mul
    # easy part: f^((p^6-1)(p^2+1))
    t0 = _conj(f)
    t1 = TL.stack12(TL.fp12_inv(TL.unstack12(f)))
    t2 = mul(t0, t1)
    t1 = t2
    t2 = mul(_frobenius(t2, 2), t1)
    # hard part
    t1 = _conj(K3.cyc_sqr(t2, 1))
    t3 = ex(t2)
    t4 = K3.cyc_sqr(t3, 1)
    t5 = mul(t1, t3)
    t1 = ex(t5)
    t0 = ex(t1)
    t6 = ex(t0)
    t6 = mul(t6, t4)
    t4 = ex(t6)
    t5 = _conj(t5)
    t4 = mul(mul(t4, t5), t2)
    t5 = _conj(t2)
    t1 = mul(t1, t2)
    t1 = _frobenius(t1, 3)
    t6 = mul(t6, t5)
    t6 = _frobenius(t6, 1)
    t3 = mul(t3, t0)
    t3 = _frobenius(t3, 2)
    t3 = mul(t3, t1)
    t3 = mul(t3, t6)
    return mul(t3, t4)


# --- public pairing surface -----------------------------------------------------

def _fold_mul(f, n):
    """Tree product of a stacked fp12 batch over its batch axis -> batch 1."""
    size = 1 << max(0, n - 1).bit_length()
    if size != n:
        f = torch.cat([f, TL.stack12(TL.fp12_one(f[0][:, : size - n]))], dim=-1)
    while size > 1:
        half = size // 2
        f = K4.fp12_mul(f[..., :half].contiguous(), f[..., half:].contiguous())
        size = half
    return f


def _skip_mask(p_inf, q_inf):
    if p_inf is None:
        return q_inf
    return p_inf if q_inf is None else (p_inf | q_inf)


def _masked_miller(p, coeffs, p_inf, q_inf):
    """Miller loop, then the pairs holding an identity set to one."""
    f = miller_loop(p, coeffs)
    skip = _skip_mask(p_inf, q_inf)
    if skip is not None:
        f = torch.where(skip, TL.stack12(TL.fp12_one(f[0])), f)
    return f


def miller_product(p, q, p_inf=None, q_inf=None):
    """prod_i of the Miller loops of (P_i, Q_i), identity pairs giving one:
    a stacked lazy fp12 of batch 1."""
    f = _masked_miller(p, prepare_g2(q), p_inf, q_inf)
    return _fold_mul(f, p[0].shape[-1])


def multi_miller_loop(p, q, p_inf=None, q_inf=None):
    """p = (px, py) strict (24, N); q = (qx, qy) strict fp2; *_inf optional
    bool masks (N,). Returns the strict fp12 product of batch 1, not
    final-exponentiated."""
    return egress(miller_product(p, q, p_inf, q_inf))


def multi_pairing(p, q, p_inf=None, q_inf=None):
    """prod_i e(P_i, Q_i) for inputs as in `multi_miller_loop`: one final
    exponentiation of the Miller product, a strict fp12 of batch 1."""
    return egress(final_exp(miller_product(p, q, p_inf, q_inf)))


def pairing(p, q, p_inf=None, q_inf=None):
    """Elementwise e(P_i, Q_i) for strict inputs as in `multi_miller_loop`:
    a strict fp12 batch (24, N) leaves. Identity inputs yield one."""
    f = _masked_miller(p, prepare_g2(q), p_inf, q_inf)
    return egress(final_exp(f))


# --- prepared G2 reuse ----------------------------------------------------------

class DeviceG2Prepared:
    """Miller-loop line coefficients kept on the device as one stacked
    (68, 6, 30, N) tensor, with the identity mask of the G2 inputs: prepare
    once, pair many times."""

    __slots__ = ("stacked", "q_inf", "n")

    def __init__(self, stacked: torch.Tensor, q_inf, n: int):
        self.stacked = stacked
        self.q_inf = q_inf
        self.n = n


def prepare_g2_device(q, q_inf=None) -> DeviceG2Prepared:
    """Strict affine G2 batch -> DeviceG2Prepared."""
    return DeviceG2Prepared(prepare_g2(q), q_inf, q[0][0].shape[-1])


def pairing_prepared(p, prepared: DeviceG2Prepared, p_inf=None):
    """Elementwise pairing against precomputed line coefficients."""
    if p[0].shape[-1] != prepared.n:
        raise ValueError(f"{p[0].shape[-1]} G1 points against {prepared.n} prepared G2 points")
    f = _masked_miller(p, prepared.stacked, p_inf, prepared.q_inf)
    return egress(final_exp(f))
