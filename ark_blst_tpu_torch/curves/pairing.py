"""Batched optimal-ate pairing on the card: G2 line precomputation, Miller
loop, final exponentiation.

Counterpart of `ark_blst_tpu/curves/pairing.py`, on a flat batch (the TPU's
padding to 1024 and its (S, 128) tiles are not inherited; every result is
per element). Two engines and two styles, as there:

* `engine="lazy"` (the default, the card's path): the lazy radix-13 tower,
  values as stacked `(12, 30, N)` fp12, egressed at the end.
  - `fuse=True` (the default): one K5 launch for all the prepare's
    events, one K6 launch for all the Miller loop's (`prepare_lines` and
    `miller_lines` of `curves/pairing_steps.py`), one FE-easy and one
    FE-hard launch for the final exponentiation (`ops/final_exp.py`). Q
    and P enter the chains as the strict `(24, N)` limbs they are given,
    and the line coefficients are canonical 32-bit words `(E, 6, 12, N)`.
    On word lines every pairing entry keeps f in words from K6 on: K6
    stores conj(f) as `(12, 12, N)` words, the identity mask selects on
    words, and the entry returns strict `(24, N)` limbs with no egress:
    `pairing` and `pairing_prepared` through FE-easy (words in) and
    FE-hard (limbs out); the multi-pairings fold the words on K4's word
    edges (`ops/fp12_mul.py`), then `multi_pairing` runs FE-easy and
    FE-hard on the product, and `multi_miller_loop` stores it as strict
    limbs from the fold's last level. `prepare_g2`, `miller_loop` and
    `final_exp` keep their forms (words, digits, digits), the JAX
    functions' own.
  - `fuse=False`, the JAX `fuse=False` branch as the TPU runs it: the
    prepare steps on the tower (K1 through `tower_lazy._mul`), Q and P
    ingested strict -> lazy, the line coefficients digits `(E, 6, 30,
    N)`; each Miller event K11 (the square, at a doubling), `_ell_legs`
    (one K1), K12 (the sparse line product); the ladder one K3 square per
    bit and K4 at the set bits. Its values equal the fused path's: K6 =
    K11 + legs + K12, and a K3 run of n is n single squares. On the CPU
    (the plain versions) its Miller loop's digits do too, on the same
    lines; on the card the kernels on 32-bit words (K3-K6, K11, K12)
    return their own digits of the same field elements. Either Miller
    loop takes either prepare's lines.
* `engine="strict"`: the strict radix-16 engine's values, f the nested
  fp12 tuple of canonical `(24, N)` limb tensors (R = 2^384, the chains'
  words' own number), coefficients `(E, 6, 24, N)` limbs; ingest and
  egress do nothing.
  - `fuse=True` (the default): the JAX strict `fuse=True` runs the same
    steps under `lax.scan`s (the prepare, the Miller loop, the x-ladders);
    here they are the lazy fused path's chain kernels on strict-limb
    edges: one K5 launch storing the lines as strict limbs, one K6 launch
    on them storing conj(f) as `(12, 24, N)` strict limbs (the identity
    mask selects on that stack), FE-easy loading those limbs and FE-hard
    storing the result's, the nested tuple views of the stack. The
    multi-pairings keep conj(f) that stack and fold it on K4's strict-limb
    edges (limbs -> limbs, one launch a level), then FE-easy and FE-hard
    or the product's limbs as they are.
  - `fuse=False`, the JAX eager loops: the strict tower (`ops/tower.py`),
    every op a K7-K10 launch, its Fp inverse one K7-inv launch
    (`ops/dispatch.py:fp_inv`). Its limbs equal the fused route's: both are
    canonical.

The pipeline:
1. `prepare_g2`: Q -> line coefficients of the 68 events (63 doublings,
   5 additions).
2. `miller_loop`: P, f = one, one step per event -> conj(f).
3. Identity inputs: masked to one after the Miller loop, before the final
   exponentiation.
4. `final_exp`: easy part (`fp12_inv`, a Frobenius map, products), then
   the cyclotomic chain: five `cyclotomic_exp_x_conj` ladders, products,
   Frobenius maps, two lone cyclotomic squares.
5. `egress`: lazy -> strict (24, N) limbs (lazy fused: FE-hard's store,
   or for the Miller product K4's).

The `lax.scan`s of the TPU's fused path (the prepare, the Miller loop)
and its final exponentiation are one chain kernel each here; the kernel
wrappers run their plain versions on CPU tensors, so the CPU tests walk
the exact call sequence the card runs.
"""

from __future__ import annotations

from types import SimpleNamespace

import functools

import torch

from ..ops import cyc_sqr as K3
from ..ops import final_exp as FE
from ..ops import fp12_mul as K4
from ..ops import fp12_mul_by_014 as K12
from ..ops import fp12_sqr as K11
from ..ops import tower as TS
from ..ops import tower_lazy as TL
from ..ops.words import (LIMBS, WORDS, digits_to_words_plain, words_to_digits_plain,
                         words_to_limbs_plain)
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


_conj = FE.conj
_frobenius = FE.frobenius


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


def _final_strict(f, fuse=True, engine="lazy"):
    """`final_exp`, then the strict fp12 batch: fused on either engine,
    FE-easy (f as a stack of lazy digits or words or of strict limbs; a
    strict nested fp12 is stacked first) and FE-hard storing the strict
    limbs, no egress; otherwise `egress` of `final_exp`."""
    _tower(engine)
    if fuse:
        return TL.unstack12(FE.hard(FE.easy(_stacked(f)), out="limbs"))
    return egress(final_exp(f, fuse, engine), engine)


def _stacked(f) -> torch.Tensor:
    """An fp12 batch as a stack of its 12 component rows: a stack as it is,
    a nested fp12 (the strict engine's) stacked."""
    return f if isinstance(f, torch.Tensor) else TL.stack12(f)


# --- G2 line-coefficient precomputation ----------------------------------------

def prepare_g2(q, fuse=True, engine="lazy", events=None) -> torch.Tensor:
    """Affine G2 batch (qx, qy) of strict fp2 leaves (24, N) -> line
    coefficients (E, 6, L, N), E = 68 (or `events`), rows c0, c1, c2 of
    each event: L = 12 canonical words lazy fused (one K5 launch on Q as
    given), 30 digits lazy unfused, 24 canonical limbs strict (fused one
    K5 launch storing them, unfused the strict tower's steps). Identity
    inputs give finite garbage; the Miller loop's caller masks those pairs
    to one."""
    T = _tower(engine)
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    if T is TS and fuse:
        return PS.prepare_lines(q, ev, PS.FMT_LIMBS)
    if T is TS:
        qx, qy = q
    elif fuse:
        return PS.prepare_lines(q, ev)
    else:
        qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    r = (qx, qy, _fp2_one_zero_like(qx, T))
    coeffs = []
    for is_dbl in ev:
        r, c = PS._doubling_step(T, r) if is_dbl else PS._addition_step(T, r, (qx, qy))
        coeffs.append(torch.stack([x for fp2 in c for x in fp2]))
    return torch.stack(coeffs)


# --- Miller loop ------------------------------------------------------------------

def miller_loop(p, coeffs, fuse=True, engine="lazy", events=None):
    """Batched Miller loop: p = (px, py), strict (24, N) limbs, coeffs
    (E, 6, L, N) from `prepare_g2` of the same engine (lazy: words or
    digits, from either `fuse`). Returns the engine's fp12 batch,
    conjugated (x < 0): lazy a stacked (12, 30, N), strict the nested
    tuple of (24, N). Fused: one K6 launch on P and the lines as given
    (strict: conj(f) stored as strict limbs, the tuple views of that
    stack)."""
    T = _tower(engine)
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    if T is TS and fuse:
        return TL.unstack12(PS.miller_lines(coeffs, p, ev, PS.FMT_LIMBS))
    if T is TS:
        px, py = p
        f = _fp12_one_like(px, TS)
        for i, is_dbl in enumerate(ev):
            if is_dbl:
                f = TS.fp12_sqr(f)
            a0, a1, a4 = PS._ell_legs(TS, _line(coeffs[i]), px, py)
            f = TS.fp12_mul_by_014_many([(f, a0, a1, a4)])[0]
        return TS.fp12_conj(f)
    if fuse:
        return _conj(PS.miller_lines(coeffs, p, ev))
    if coeffs.shape[-2] == WORDS:  # a fused prepare's lines, once to digits
        coeffs = words_to_digits_plain(coeffs[: len(ev)])
    px, py = TL.fp_ingest(p[0]), TL.fp_ingest(p[1])
    fs = TL.stack12(_fp12_one_like(px))
    for i, is_dbl in enumerate(ev):
        if is_dbl:
            fs = K11.fp12_sqr(fs)
        a0, a1, a4 = PS._ell_legs(TL, _line(coeffs[i]), px, py)
        fs = K12.fp12_mul_by_014(fs, torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]]))
    return _conj(fs)


# --- final exponentiation ------------------------------------------------------

def cyclotomic_exp_x_conj(f, fuse=True, engine="lazy"):
    """f^(-x) = conj(f^|x|) in the cyclotomic subgroup: one cyclotomic
    square a bit of |x| and a product at each set bit, on the engine's ops
    (`ops/final_exp.py:LADDER_PROGRAM`). `fuse` is the JAX signature's and
    changes nothing: the fused pipeline runs its ladders inside FE-hard."""
    return FE.run_program(FE.LADDER_PROGRAM, f, _final_ops(engine))


def final_exp(f, fuse=True, engine="lazy"):
    """Easy part, then the BLS12-381 cyclotomic addition chain (the chain of
    `oracle/pairing.py:final_exp`), on the engine's fp12 batch. Fused: one
    FE-easy and one FE-hard launch (`ops/final_exp.py`), the easy part
    handed over as words (strict: f stacked, FE-easy loading its limbs and
    FE-hard storing the result's, the tuple views of that stack);
    otherwise the same chain (`easy_part`, then `HARD_PROGRAM`) op by op on
    the engine's ops."""
    E = _final_ops(engine)
    if engine == "lazy" and fuse:
        return FE.hard(FE.easy(f))
    if fuse:
        return _final_strict(f, fuse, engine)
    return FE.run_program(FE.HARD_PROGRAM, FE.easy_part(f, E), E)


# --- public pairing surface -----------------------------------------------------

def _fp12_ones(f, n: int, engine):
    """fp12 one, batch n, in the engine's form, on f's device."""
    if engine == "lazy":
        return TL.stack12(TL.fp12_one(torch.zeros((30, n), dtype=torch.int32, device=f.device)))
    return TS.fp12_one((n,), f[0][0][0].device)


def _fold_mul(f, n, engine="lazy"):
    """Tree product of an engine's fp12 batch over its batch axis -> batch 1
    (the lazy engine's on digits, K4 a level; the strict engine's on its
    tower, the unfused routes')."""
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
    any final exponentiation sees them); strict fused, the mask selects on
    K6-chain's stack of limbs before it is nested (`_masked_miller_stack`)."""
    skip = _skip_mask(p_inf, q_inf)
    if engine == "strict" and fuse:
        return TL.unstack12(_masked_miller_stack(p, coeffs, skip, events, PS.FMT_LIMBS))
    f = miller_loop(p, coeffs, fuse, engine, events)
    if skip is None:
        return f
    if engine == "lazy":
        return torch.where(skip, TL.stack12(TL.fp12_one(f[0])), f)
    return TS.select(skip, TS.fp12_one(skip.shape, skip.device), f)


@functools.lru_cache(maxsize=16)
def _fp12_one_words(device: str) -> torch.Tensor:
    """fp12 one as a (12, 12, 1) word stack on the device, made once: R mod
    p (one's canonical Montgomery words) in component 0, zero elsewhere."""
    one = TL.stack12(TL.fp12_one(torch.zeros((30, 1), dtype=torch.int32)))
    return digits_to_words_plain(one).to(device)


@functools.lru_cache(maxsize=16)
def _fp12_one_limbs(device: str) -> torch.Tensor:
    """fp12 one as a strict (12, 24, 1) limb stack on the device, made once."""
    return words_to_limbs_plain(_fp12_one_words("cpu")).to(device)


def _stack_format(coeffs, fuse, engine):
    """The layout of conj(f) on the fused routes that keep the Miller loop's
    f a stack up to FE-easy and through the multi-pairings' fold: words on
    the word route (the lazy engine fused on word lines), strict limbs on
    the strict engine fused; None on the others."""
    if engine == "lazy" and fuse and coeffs.shape[-2] == WORDS:
        return PS.FMT_WORDS
    return PS.FMT_LIMBS if engine == "strict" and fuse else None


def _masked_miller_stack(p, coeffs, skip, events=None, f_fmt=PS.FMT_WORDS):
    """The fused Miller loop that keeps f a stack: conj(f) from K6-chain
    (`miller_lines`) as (12, 12, N) words on word lines (the fused
    pairing's), or with f_fmt FMT_LIMBS as (12, 24, N) strict limbs on
    strict lines (the strict engine's); the pairs holding an identity set
    to one by one select on the stack."""
    ev = MILLER_EVENTS if events is None else MILLER_EVENTS[:events]
    f = PS.miller_lines(coeffs, p, ev, f_fmt)
    if skip is None:
        return f
    one = (_fp12_one_words if f_fmt == PS.FMT_WORDS else _fp12_one_limbs)(str(f.device))
    return torch.where(skip, one, f)


def _fold_stack(f, n: int, out: str | None = None):
    """Tree product of an fp12 stack over its batch axis on K4, padded with
    one -> batch 1. K6-chain's conj(f) as (12, 12, n) words (the word
    route) folds on K4's word edges to (12, 12, 1) words, or with
    out="limbs" to the strict (12, 24, 1) limbs that the last level stores
    (at n = 1, where the tree has no level, one launch against one); the
    strict engine's (12, 24, n) limbs fold limbs -> limbs (no launch at n
    = 1). conj is a ring automorphism, so the fold of the Miller loops'
    conj(f_i) is conj(prod f_i), their product as `miller_loop` gives
    it."""
    inner = "limbs" if f.shape[-2] == LIMBS else "words"
    last = out or inner
    one = (_fp12_one_limbs if inner == "limbs" else _fp12_one_words)(str(f.device))
    size = 1 << max(0, n - 1).bit_length()
    if size != n:
        f = torch.cat([f, one.expand(-1, -1, size - n)], dim=-1)
    if size == 1:
        return f if last == inner else K4.fp12_mul(f, one, out=last)
    while size > 1:
        half = size // 2
        f = K4.fp12_mul(f[..., :half].contiguous(), f[..., half:size].contiguous(),
                        out=last if half == 1 else inner)
        size = half
    return f


def _pairing(p, coeffs, p_inf, q_inf, fuse, engine):
    """Elementwise pairings on lines of any layout: lazy fused on word lines
    the word route (K6-chain's conj(f) as words, the mask on words, FE-easy
    on words, FE-hard to strict limbs), strict fused the same on strict
    limbs; otherwise the Miller loop and its mask in the engine's form;
    then `_final_strict`."""
    f_fmt = _stack_format(coeffs, fuse, engine)
    if f_fmt is not None:
        f = _masked_miller_stack(p, coeffs, _skip_mask(p_inf, q_inf), f_fmt=f_fmt)
    else:
        f = _masked_miller(p, coeffs, p_inf, q_inf, fuse, engine)
    return _final_strict(f, fuse, engine)


def _fold_strict(f, n: int, fmt, final: bool, fuse=True, engine="lazy"):
    """A batch of n Miller loops -> their product as the strict fp12 of
    batch 1, with `final` final-exponentiated. On a stack (`fmt` FMT_WORDS,
    the word route, or FMT_LIMBS, the strict engine fused): `_fold_stack`,
    then FE-easy and FE-hard, or the product's strict limbs (the word
    route's last level stores them, a strict stack is them): no egress.
    Otherwise (`fmt` None) `_fold_mul` in the engine's form, then
    `_final_strict` or `egress`."""
    if fmt is not None:
        if final:
            return _final_strict(_fold_stack(f, n), fuse, engine)
        return TL.unstack12(_fold_stack(f, n, out="limbs"))
    f = _fold_mul(f, n, engine)
    return _final_strict(f, fuse, engine) if final else egress(f, engine)


def _product(p, coeffs, skip, fuse, engine, final: bool):
    """The Miller loops of the pairs on lines of any layout, identity pairs
    one, folded to their product (`_fold_strict`): on the fused routes that
    keep f a stack (`_stack_format`: lazy on word lines, strict) K6-chain's
    conj(f), the mask on the stack and the fold on K4's edges of that
    stack; otherwise the Miller loop and its mask in the engine's form."""
    fmt = _stack_format(coeffs, fuse, engine)
    if fmt is not None:
        f = _masked_miller_stack(p, coeffs, skip, f_fmt=fmt)
    else:
        f = _masked_miller(p, coeffs, skip, None, fuse, engine)
    return _fold_strict(f, p[0].shape[-1], fmt, final, fuse, engine)


def multi_miller_loop(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """p = (px, py) strict (24, N); q = (qx, qy) strict fp2; *_inf optional
    bool masks (N,). Returns the strict fp12 product of batch 1, not
    final-exponentiated."""
    return _product(p, prepare_g2(q, fuse, engine), _skip_mask(p_inf, q_inf), fuse, engine,
                    final=False)


def multi_pairing(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """prod_i e(P_i, Q_i) for inputs as in `multi_miller_loop`: one final
    exponentiation of the Miller product, a strict fp12 of batch 1."""
    return _product(p, prepare_g2(q, fuse, engine), _skip_mask(p_inf, q_inf), fuse, engine,
                    final=True)


def pairing(p, q, p_inf=None, q_inf=None, fuse=True, engine="lazy"):
    """Elementwise e(P_i, Q_i) for strict inputs as in `multi_miller_loop`:
    a strict fp12 batch (24, N) leaves. Identity inputs yield one."""
    return _pairing(p, prepare_g2(q, fuse, engine), p_inf, q_inf, fuse, engine)


# --- sharded multi-pairing -----------------------------------------------------

def _gather_fp12(mesh, f):
    """One fp12 (batch 1) on every rank -> the world's, batch `world` in rank
    order, in one gather, in the form it has: a stack of any rows (lazy
    digits or words, strict limbs) or the strict engine's nested tuple."""
    stacked = isinstance(f, torch.Tensor)
    got = TS.tree_map(lambda x: x[..., 0],
                      mesh.all_gather_tree(TL.unstack12(f) if stacked else f))
    return TL.stack12(got) if stacked else got


def multi_pairing_sharded(p, q, mesh, p_inf=None, q_inf=None, axis: str = "data",
                          engine="lazy", final=True, events=None, fuse=True):
    """prod_i e(P_i, Q_i) with the batch sharded over a `torch.distributed`
    mesh (`distributed.global_mesh`), a collective: every rank calls it
    with the same global inputs, as for `multi_pairing`, and gets the same
    strict fp12 of batch 1 on its device.

    Rank r takes the r-th contiguous shard of the N pairs and runs
    `prepare_g2`, the Miller loop, the identity mask and the fold on it:
    one fp12 per rank. The ranks gather those in one collective, every rank
    multiplies them and runs one final exponentiation (if `final`; else
    the product alone), ending in the strict limbs (`_fold_strict`). Lazy
    fused the word route of `multi_pairing`: each rank folds K6-chain's
    words on K4's word edges, and the ranks gather the (12, 12, 1) words;
    strict fused the same on K4's strict-limb edges, the ranks gathering
    the (12, 24, 1) limbs.
    `events` truncates the Miller loop to its first events, as
    in `prepare_g2`. N must be a multiple of the world (pad with identity
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
    fmt = _stack_format(coeffs, fuse, engine)
    if fmt is not None:
        f = _fold_stack(_masked_miller_stack(ps, coeffs, skip, events, fmt), m)
    else:
        f = _fold_mul(_masked_miller(ps, coeffs, skip, None, fuse, engine, events), m, engine)
    return _fold_strict(_gather_fp12(mesh, f), world, fmt, final, fuse, engine)


# --- prepared G2 reuse ----------------------------------------------------------

# The layouts of a prepared stack (68, 6, L, N), by L
LINE_LAYOUTS = {WORDS: "words", 30: "digits", 24: "limbs"}


class DeviceG2Prepared:
    """Miller-loop line coefficients kept on the device as one stacked
    (68, 6, L, N) tensor of the engine that made them, with the identity
    mask of the G2 inputs: prepare once, pair many times. `layout` names
    L: "words" (12, the lazy fused prepare's canonical 32-bit words),
    "digits" (30, the lazy unfused prepare's) or "limbs" (24, the strict
    engine's). A lazy stack pairs under either `fuse`."""

    __slots__ = ("engine", "stacked", "q_inf", "n", "layout")

    def __init__(self, engine: str, stacked: torch.Tensor, q_inf, n: int):
        self.engine = engine
        self.stacked = stacked
        self.q_inf = q_inf
        self.n = n
        self.layout = LINE_LAYOUTS[stacked.shape[-2]]


def prepare_g2_device(q, q_inf=None, fuse=True, engine="lazy") -> DeviceG2Prepared:
    """Strict affine G2 batch -> DeviceG2Prepared: (68, 6, 12, N) words
    lazy fused, (68, 6, 30, N) digits lazy unfused, (68, 6, 24, N) limbs
    strict."""
    return DeviceG2Prepared(engine, prepare_g2(q, fuse, engine), q_inf, q[0][0].shape[-1])


def _check_prepared(p, prepared: DeviceG2Prepared) -> None:
    if p[0].shape[-1] != prepared.n:
        raise ValueError(f"{p[0].shape[-1]} G1 points against {prepared.n} prepared G2 points")


def pairing_prepared(p, prepared: DeviceG2Prepared, p_inf=None, fuse=True):
    """Elementwise pairing against precomputed line coefficients (lazy fused
    on a "words" stack: the word route of `pairing`)."""
    _check_prepared(p, prepared)
    return _pairing(p, prepared.stacked, p_inf, prepared.q_inf, fuse, prepared.engine)


def multi_miller_loop_prepared(p, prepared: DeviceG2Prepared, p_inf=None, fuse=True):
    """`multi_miller_loop` against precomputed line coefficients: the strict
    fp12 product of batch 1 (lazy fused on a "words" stack: the word route
    of `multi_miller_loop`)."""
    _check_prepared(p, prepared)
    return _product(p, prepared.stacked, _skip_mask(p_inf, prepared.q_inf), fuse,
                    prepared.engine, final=False)
