"""Batched optimal-ate pairing on the card: G2 line precomputation, Miller
loop, final exponentiation.

Counterpart of `ark_blst_tpu/curves/pairing.py`, on a flat batch (the TPU's
padding to 1024 and its (S, 128) tiles are not inherited; every result is
per element). Two engines and two styles, as there:

* `engine="lazy"` (the default, the card's path): the lazy radix-13 tower,
  values as stacked `(12, 30, N)` fp12 and `(E, 6, 30, N)` line
  coefficients, ingested strict -> lazy once and egressed at the end.
  - `fuse=True` (the default): one K5 launch per prepare event, one K6
    launch per Miller event, K3 runs of n squares in the exponent ladder.
  - `fuse=False`, the JAX `fuse=False` branch as the TPU runs it: the
    prepare steps on the tower (K1 through `tower_lazy._mul`); each Miller
    event K11 (the square, at a doubling), `_ell_legs` (one K1), K12 (the
    sparse line product); the ladder one K3 square per bit and K4 at the
    set bits. Its values equal the fused path's: K6 = K11 + legs + K12,
    and a K3 run of n is n single squares. On the CPU (the plain versions)
    its digits do too; on the card the kernels on 32-bit words (K3-K6,
    K11, K12) return their own digits of the same field elements.
* `engine="strict"`: the strict radix-16 tower (`ops/tower.py`, every op a
  K7-K10 launch), f the nested fp12 tuple of `(24, N)` limb tensors,
  coefficients `(E, 6, 24, N)`; ingest and egress do nothing, and `fuse`
  has no fused kernel to choose (the JAX strict `fuse=True` is a
  `lax.scan` of the same steps).

The pipeline:
1. `prepare_g2`: Q -> line coefficients of the 68 events (63 doublings,
   5 additions).
2. `miller_loop`: P, f = one, one step per event -> conj(f).
3. Identity inputs: masked to one after the Miller loop, before the final
   exponentiation.
4. `final_exp`: easy part (`fp12_inv`, a Frobenius map, products), then
   the cyclotomic chain: five `cyclotomic_exp_x_conj` ladders, products,
   Frobenius maps, two lone cyclotomic squares.
5. `egress`: lazy -> strict (24, N) limbs.

Each `lax.scan` of the TPU path is a Python loop of kernel launches here;
the kernel wrappers run their plain versions on CPU tensors, so the CPU
tests walk the exact call sequence the card runs.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..ops import cyc_sqr as K3
from ..ops import fp12_mul as K4
from ..ops import fp12_mul_by_014 as K12
from ..ops import fp12_sqr as K11
from ..ops import tower as TS
from ..ops import tower_lazy as TL
from ..oracle import pairing as OP
from . import pairing_steps as PS

ENGINES = ("lazy", "strict")

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


def _tower(engine):
    """The tower module of an engine name."""
    if engine == "lazy":
        return TL
    if engine == "strict":
        return TS
    raise ValueError(f"engine is one of {ENGINES}, not {engine!r}")


def _fp2_one_zero_like(qx, T=TL):
    """fp2 (1, 0) shaped like the fp2 batch qx, on the tower T."""
    zero = qx[0] * 0
    if T is TL:
        return (zero + TL._const_col(1, zero), zero)
    return (zero + TS.fp_const(1, zero.shape[1:], zero.device), zero)


def _fp12_one_like(px, T=TL):
    """fp12 one shaped like the Fp batch px, on the tower T."""
    one, zero = _fp2_one_zero_like((px,), T)
    z2 = (zero, zero)
    return (((one, zero), z2, z2), (z2, z2, z2))


def _line(c):
    """Stacked line rows (6, ...) -> the fp2 triple (c0, c1, c2)."""
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def _conj(x):
    """Conjugation of a stacked fp12 (the inverse on the cyclotomic
    subgroup): the w part negated, as `tower_lazy.fp12_conj`."""
    return torch.cat([x[:6], -x[6:]])


def _frobenius(x, power: int):
    return TL.stack12(TL.fp12_frobenius(TL.unstack12(x), power))


# The fp12 operations of the final exponentiation on each engine's form of
# f: the lazy engine's products through K4 and its cyclotomic squares
# through K3, the inverse and the Frobenius maps on the tower (K1); the
# strict engine's all on its tower (K7-K10).
_FINAL_OPS = {
    "lazy": SimpleNamespace(
        conj=_conj, mul=K4.fp12_mul, frobenius=_frobenius,
        inv=lambda f: TL.stack12(TL.fp12_inv(TL.unstack12(f))),
        cyc_sqr=lambda f: K3.cyc_sqr(f, 1)),
    "strict": SimpleNamespace(
        conj=TS.fp12_conj, mul=TS.fp12_mul, frobenius=TS.fp12_frobenius,
        inv=TS.fp12_inv, cyc_sqr=TS.fp12_cyclotomic_sqr),
}


def _final_ops(engine):
    _tower(engine)  # checks the name
    return _FINAL_OPS[engine]


def egress(x, engine="lazy"):
    """An engine's fp12 batch -> the strict fp12 batch, (24, N) leaves: the
    lazy stacked (12, 30, N) is canonicalized, the strict one is already."""
    _tower(engine)
    return TL.fp12_egress(TL.unstack12(x)) if engine == "lazy" else x


# --- G2 line-coefficient precomputation ----------------------------------------

def prepare_g2(q, fuse=True, engine="lazy", events=None) -> torch.Tensor:
    """Affine G2 batch (qx, qy) of strict fp2 leaves (24, N) -> line
    coefficients (E, 6, L, N), E = 68 (or `events`), rows c0, c1, c2 of
    each event; L = 30 lazy digits or 24 strict limbs. Identity inputs give
    finite garbage; the Miller loop's caller masks those pairs to one."""
    T = _tower(engine)
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    if T is TS:
        qx, qy = q
    else:
        qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
        if fuse:
            return _prepare_fused(qx, qy, ev)
    r = (qx, qy, _fp2_one_zero_like(qx, T))
    coeffs = []
    for is_dbl in ev:
        r, c = PS._doubling_step(T, r) if is_dbl else PS._addition_step(T, r, (qx, qy))
        coeffs.append(torch.stack([x for fp2 in c for x in fp2]))
    return torch.stack(coeffs)


def _prepare_fused(qx, qy, ev) -> torch.Tensor:
    """The lazy prepare as one K5 launch per event."""
    z = _fp2_one_zero_like(qx)
    rs = torch.stack([qx[0], qx[1], qy[0], qy[1], z[0], z[1]])
    qs = torch.stack([qx[0], qx[1], qy[0], qy[1]])
    coeffs = torch.empty((len(ev), 6) + tuple(rs.shape[1:]), dtype=torch.int32, device=rs.device)
    for i, is_dbl in enumerate(ev):
        out = PS.prepare_step(rs, None if is_dbl else qs)
        rs, coeffs[i] = out[:6], out[6:]
    return coeffs


# --- Miller loop ------------------------------------------------------------------

def miller_loop(p, coeffs, fuse=True, engine="lazy", events=None):
    """Batched Miller loop: p = (px, py), strict (24, N) limbs, coeffs
    (E, 6, L, N) from `prepare_g2` of the same engine. Returns the engine's
    fp12 batch, conjugated (x < 0): lazy a stacked (12, 30, N), strict the
    nested tuple of (24, N)."""
    T = _tower(engine)
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    if T is TS:
        px, py = p
        f = _fp12_one_like(px, TS)
        for i, is_dbl in enumerate(ev):
            if is_dbl:
                f = TS.fp12_sqr(f)
            a0, a1, a4 = PS._ell_legs(TS, _line(coeffs[i]), px, py)
            f = TS.fp12_mul_by_014_many([(f, a0, a1, a4)])[0]
        return TS.fp12_conj(f)
    px, py = TL.fp_ingest(p[0]), TL.fp_ingest(p[1])
    fs = TL.stack12(_fp12_one_like(px))
    if fuse:
        pxy = torch.stack([px, py])
        for i, is_dbl in enumerate(ev):
            fs = PS.miller_step(fs, coeffs[i], pxy, is_dbl)
        return _conj(fs)
    for i, is_dbl in enumerate(ev):
        if is_dbl:
            fs = K11.fp12_sqr(fs)
        a0, a1, a4 = PS._ell_legs(TL, _line(coeffs[i]), px, py)
        fs = K12.fp12_mul_by_014(fs, torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]]))
    return _conj(fs)


# --- final exponentiation ------------------------------------------------------

def cyclotomic_exp_x_conj(f, fuse=True, engine="lazy"):
    """f^(-x) = conj(f^|x|) in the cyclotomic subgroup. Lazy fused: per
    segment of the ladder one K3 launch of n squares, then one K4 product;
    otherwise one cyclotomic square per bit and a product at each set bit."""
    E = _final_ops(engine)
    if engine == "lazy" and fuse:
        x = f
        for n_sqr, do_mul in _X_SEGMENTS:
            x = K3.cyc_sqr(x, n_sqr)
            if do_mul:
                x = K4.fp12_mul(x, f)
        return _conj(x)
    r = f
    for bit in X_ABS_BITS[1:]:
        r = E.cyc_sqr(r)
        if bit:
            r = E.mul(r, f)
    return E.conj(r)


def final_exp(f, fuse=True, engine="lazy"):
    """Easy part, then the BLS12-381 cyclotomic addition chain (the chain of
    `oracle/pairing.py:final_exp`), on the engine's fp12 batch."""
    E = _final_ops(engine)
    ex = lambda g: cyclotomic_exp_x_conj(g, fuse, engine)  # noqa: E731
    mul, conj = E.mul, E.conj
    # easy part: f^((p^6-1)(p^2+1))
    t0 = conj(f)
    t1 = E.inv(f)
    t2 = mul(t0, t1)
    t1 = t2
    t2 = mul(E.frobenius(t2, 2), t1)
    # hard part
    t1 = conj(E.cyc_sqr(t2))
    t3 = ex(t2)
    t4 = E.cyc_sqr(t3)
    t5 = mul(t1, t3)
    t1 = ex(t5)
    t0 = ex(t1)
    t6 = ex(t0)
    t6 = mul(t6, t4)
    t4 = ex(t6)
    t5 = conj(t5)
    t4 = mul(mul(t4, t5), t2)
    t5 = conj(t2)
    t1 = mul(t1, t2)
    t1 = E.frobenius(t1, 3)
    t6 = mul(t6, t5)
    t6 = E.frobenius(t6, 1)
    t3 = mul(t3, t0)
    t3 = E.frobenius(t3, 2)
    t3 = mul(t3, t1)
    t3 = mul(t3, t6)
    return mul(t3, t4)


# --- public pairing surface -----------------------------------------------------

def _fp12_ones(f, n: int, engine):
    """fp12 one, batch n, in the engine's form, on f's device."""
    if engine == "lazy":
        return TL.stack12(TL.fp12_one(torch.zeros((30, n), dtype=torch.int32, device=f.device)))
    return TS.fp12_one((n,), f[0][0][0].device)


def _fold_mul(f, n, engine="lazy"):
    """Tree product of an engine's fp12 batch over its batch axis -> batch 1."""
    mul = _final_ops(engine).mul
    if engine == "lazy":
        cat = lambda a, b: torch.cat([a, b], dim=-1)  # noqa: E731
        cut = lambda a, i, j: a[..., i:j].contiguous()  # noqa: E731
    else:
        cat = lambda a, b: TS.tree_map(lambda x, y: torch.cat([x, y], dim=-1), a, b)  # noqa: E731
        cut = lambda a, i, j: TS.tree_map(lambda x: x[..., i:j], a)  # noqa: E731
    size = 1 << max(0, n - 1).bit_length()
    if size != n:
        f = cat(f, _fp12_ones(f, size - n, engine))
    while size > 1:
        half = size // 2
        f = mul(cut(f, 0, half), cut(f, half, size))
        size = half
    return f


def _skip_mask(p_inf, q_inf):
    if p_inf is None:
        return q_inf
    return p_inf if q_inf is None else (p_inf | q_inf)


def _masked_miller(p, coeffs, p_inf, q_inf, fuse=True, engine="lazy", events=None):
    """Miller loop, then the pairs holding an identity set to one (before
    any final exponentiation sees them)."""
    f = miller_loop(p, coeffs, fuse, engine, events)
    skip = _skip_mask(p_inf, q_inf)
    if skip is None:
        return f
    if engine == "lazy":
        return torch.where(skip, TL.stack12(TL.fp12_one(f[0])), f)
    return TS.select(skip, TS.fp12_one(skip.shape, skip.device), f)


def miller_product(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """prod_i of the Miller loops of (P_i, Q_i), identity pairs giving one:
    the engine's fp12 of batch 1."""
    f = _masked_miller(p, prepare_g2(q, fuse, engine), p_inf, q_inf, fuse, engine)
    return _fold_mul(f, p[0].shape[-1], engine)


def multi_miller_loop(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """p = (px, py) strict (24, N); q = (qx, qy) strict fp2; *_inf optional
    bool masks (N,). Returns the strict fp12 product of batch 1, not
    final-exponentiated."""
    return egress(miller_product(p, q, p_inf, q_inf, fuse, engine), engine)


def multi_pairing(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """prod_i e(P_i, Q_i) for inputs as in `multi_miller_loop`: one final
    exponentiation of the Miller product, a strict fp12 of batch 1."""
    f = miller_product(p, q, p_inf, q_inf, fuse, engine)
    return egress(final_exp(f, fuse, engine), engine)


def pairing(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """Elementwise e(P_i, Q_i) for strict inputs as in `multi_miller_loop`:
    a strict fp12 batch (24, N) leaves. Identity inputs yield one."""
    f = _masked_miller(p, prepare_g2(q, fuse, engine), p_inf, q_inf, fuse, engine)
    return egress(final_exp(f, fuse, engine), engine)


# --- sharded multi-pairing -----------------------------------------------------

def _gather_fp12(mesh, f, engine):
    """One fp12 (batch 1) of the engine's form on every rank -> the world's,
    batch `world` in rank order, in one gather."""
    tree = TL.unstack12(f) if engine == "lazy" else f
    got = TS.tree_map(lambda x: x[..., 0], mesh.all_gather_tree(tree))
    return TL.stack12(got) if engine == "lazy" else got


def multi_pairing_sharded(p, q, mesh, p_inf=None, q_inf=None, axis: str = "data",
                          engine="lazy", final=True, events=None, fuse=True):
    """prod_i e(P_i, Q_i) with the batch sharded over a `torch.distributed`
    mesh (`distributed.global_mesh`), a collective: every rank calls it
    with the same global inputs, as for `multi_pairing`, and gets the same
    strict fp12 of batch 1 on its device.

    Rank r takes the r-th contiguous shard of the N pairs and runs
    `prepare_g2`, `miller_loop`, the identity mask and `_fold_mul` on it:
    one fp12 per rank. The ranks gather those, every rank multiplies them
    (`_fold_mul`) and runs one `final_exp` (if `final`) and the egress.
    `events` truncates the Miller loop to its first events, as in
    `prepare_g2`. N must be a multiple of the world (pad with identity
    pairs and masks otherwise): where the JAX package asserts, this raises
    `ValueError`."""
    _tower(engine)
    n = p[0].shape[-1]
    world, dev = mesh.shape[axis], mesh.device
    if n % world:
        raise ValueError(f"{n} pairs do not split over {world} ranks: pad the batch")
    m = n // world
    cut = lambda x: x[..., mesh.rank * m : (mesh.rank + 1) * m].to(dev)  # noqa: E731
    ps, qs = TS.tree_map(cut, p), TS.tree_map(cut, q)
    skip = _skip_mask(p_inf, q_inf)
    if skip is not None:
        skip = cut(skip)
    coeffs = prepare_g2(qs, fuse, engine, events)
    f = _masked_miller(ps, coeffs, skip, None, fuse, engine, events)
    f = _fold_mul(_gather_fp12(mesh, _fold_mul(f, m, engine), engine), world, engine)
    if final:
        f = final_exp(f, fuse, engine)
    return egress(f, engine)


# --- prepared G2 reuse ----------------------------------------------------------

class DeviceG2Prepared:
    """Miller-loop line coefficients kept on the device as one stacked
    (68, 6, L, N) tensor of the engine that made them, with the identity
    mask of the G2 inputs: prepare once, pair many times."""

    __slots__ = ("engine", "stacked", "q_inf", "n")

    def __init__(self, engine: str, stacked: torch.Tensor, q_inf, n: int):
        self.engine = engine
        self.stacked = stacked
        self.q_inf = q_inf
        self.n = n


def prepare_g2_device(q, q_inf=None, fuse=True, engine="lazy") -> DeviceG2Prepared:
    """Strict affine G2 batch -> DeviceG2Prepared."""
    return DeviceG2Prepared(engine, prepare_g2(q, fuse, engine), q_inf, q[0][0].shape[-1])


def _check_prepared(p, prepared: DeviceG2Prepared) -> None:
    if p[0].shape[-1] != prepared.n:
        raise ValueError(f"{p[0].shape[-1]} G1 points against {prepared.n} prepared G2 points")


def pairing_prepared(p, prepared: DeviceG2Prepared, p_inf=None, fuse=True):
    """Elementwise pairing against precomputed line coefficients."""
    _check_prepared(p, prepared)
    eng = prepared.engine
    f = _masked_miller(p, prepared.stacked, p_inf, prepared.q_inf, fuse, eng)
    return egress(final_exp(f, fuse, eng), eng)


def multi_miller_loop_prepared(p, prepared: DeviceG2Prepared, p_inf=None, fuse=True):
    """`multi_miller_loop` against precomputed line coefficients: the strict
    fp12 product of batch 1."""
    _check_prepared(p, prepared)
    eng = prepared.engine
    f = _masked_miller(p, prepared.stacked, p_inf, prepared.q_inf, fuse, eng)
    return egress(_fold_mul(f, prepared.n, eng), eng)
