"""The port's batched pairing (curves/pairing.py, curves/pairing_steps.py,
ops/cyc_sqr.py and the tuple-level entry points of `bls12.py`) against the JAX package.

The plain versions of K3, K5 and K6 (one event and the chains of
`prepare_chain` / `miller_chain`) and the truncated unfused prepare_g2 /
miller_loop are held against the JAX lazy tower digit for digit, the
fused pipeline's entries (`prepare_lines` / `miller_lines`, word lines)
by canonical value; each prepared layout pairs under either `fuse`; the whole
pairing on the CPU is held against the JAX package's oracle by value, and
so is the port's own oracle copy. (The JAX package's own pairing tests are
all in the slow lane; these are the tier-1 guard of the port's pairing.)
"""

import os
import random

import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL
from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu.oracle import field as JOF
from ark_blst_tpu.oracle import pairing as JOP

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

RNG = random.Random(2)
PS4 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]
QS4 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _jax_p(pts):
    return (JCV.fp_to_dev([p[0] for p in pts]), JCV.fp_to_dev([p[1] for p in pts]))


def _jax_q(qs):
    return (JCV.fp2_to_dev([q[0] for q in qs]), JCV.fp2_to_dev([q[1] for q in qs]))


def _flat(r, c):
    return [x for fp2 in tuple(r) + tuple(c) for x in fp2]


def test_oracle_copy_matches_jax_oracle():
    assert OP.X_BITS == JOP.X_BITS and OF._G1J == JOF._G1J and OF.G2_GEN == JOF.G2_GEN
    assert OC.g2_mul(OF.G2_GEN, 12345) == JOC.g2_mul(JOF.G2_GEN, 12345)
    assert OP.pairing(PS4[0], QS4[0]) == JOP.pairing(PS4[0], QS4[0])
    assert OP.prepare_g2(QS4[1]) == JOP.prepare_g2(QS4[1])


def test_schedules_match():
    assert PR.MILLER_EVENTS == DP.MILLER_EVENTS and PR.NUM_EVENTS == 68
    assert FE.X_SEGMENTS == DP._X_SEGMENTS
    ladder_bits = [1] + [b for n, m in FE.X_SEGMENTS for b in [0] * (n - 1) + [int(m)]]
    assert ladder_bits == DP.X_ABS_BITS


def _jax_r_after_doubling():
    """A JAX Jacobian G2 point with z != 1 (one doubling of Q) and Q."""
    qx, qy = (JTL.fp2_ingest(c) for c in _jax_q(QS4))
    r = (qx, qy, DP._fp2_one_zero_like(JTL, qx))
    r, _ = DP._doubling_step(JTL, r)
    return r, (qx, qy)


@pytest.mark.parametrize("is_add", [False, True])
def test_k5_plain_matches_jax_step(is_add):
    r, q = _jax_r_after_doubling()
    r_stk = torch.stack(CV.tree_from_jax(tuple(x for fp2 in r for x in fp2)))
    q_stk = torch.stack(CV.tree_from_jax(tuple(x for fp2 in q for x in fp2)))
    if is_add:
        want = _flat(*DP._addition_step(JTL, r, q))
        got = PS.prepare_step(r_stk, q_stk)
    else:
        want = _flat(*DP._doubling_step(JTL, r))
        got = PS.prepare_step(r_stk)
    assert (got.numpy() == np.stack([_np(x) for x in want])).all()


@pytest.mark.parametrize("with_sqr", [True, False])
def test_k6_plain_matches_jax_event(with_sqr):
    """K6's plain version against the JAX Miller-event composition:
    fp12_sqr, _ell_legs, fp12_mul_by_014_many."""
    r, _ = _jax_r_after_doubling()
    _, line = DP._doubling_step(JTL, r)
    px, py = (JTL.fp_ingest(c) for c in _jax_p(PS4))
    vals = [JOP.miller_loop(p, q) for p, q in zip(PS4, QS4)]
    f = JTL.fp12_ingest(JCV.fp12_to_dev(vals))
    g = JTL.fp12_sqr(f) if with_sqr else f
    a0, a1, a4 = DP._ell_legs(JTL, line, px, py)
    want = JTL._flat12(JTL.fp12_mul_by_014_many([(g, a0, a1, a4)])[0])
    f_stk = torch.stack(CV.tree_from_jax(tuple(JTL._flat12(f))))
    c_stk = torch.stack(CV.tree_from_jax(tuple(x for fp2 in line for x in fp2)))
    pxy = torch.stack(CV.tree_from_jax((px, py)))
    got = PS.miller_step(f_stk, c_stk, pxy, with_sqr)
    assert (got.numpy() == np.stack([_np(x) for x in want])).all()


@pytest.mark.parametrize("n", [1, max(r for r, _ in FE.X_SEGMENTS)])
def test_k3_plain_matches_jax_core(n):
    """n iterated squarings (the contraction keeps the run exact) against n
    calls of the JAX _cyc_sqr_core, at n = 1 and at the ladder's longest
    run."""
    vals = [JOP.pairing(p, q) for p, q in zip(PS4[:2], QS4[:2])]
    f = JTL.fp12_ingest(JCV.fp12_to_dev(vals))
    x = torch.stack(CV.tree_from_jax(tuple(JTL._flat12(f))))
    for _ in range(n):
        f = JTL._cyc_sqr_core(f)
    got = K3.cyc_sqr(x, n)
    assert (got.numpy() == np.stack([_np(c) for c in JTL._flat12(f)])).all()
    # in the cyclotomic subgroup the squares are squares by value
    want = vals
    for _ in range(n):
        want = [OF.fp12_sqr(v) for v in want]
    assert CV.fp12_from_dev(TL.fp12_egress(TL.unstack12(got))) == want


TRUNCATED = 8  # events of the truncated pipeline: two additions (events 1 and 4)


@pytest.fixture(scope="module")
def jax_truncated():
    """The JAX lazy prepare and Miller loop (`fuse=False`) over the first
    TRUNCATED events of QS4 and PS4: (jq, jp, coefficients, conj(f))."""
    jq, jp = _jax_q(QS4), _jax_p(PS4)
    jc = DP.prepare_g2(jq, fuse=False, engine="lazy", events=TRUNCATED)
    return jq, jp, jc, DP.miller_loop(jp, jc, fuse=False, engine="lazy", events=TRUNCATED)


def _canonical(stack: torch.Tensor) -> list:
    """(..., 30, n) digits -> each row's canonical value mod p (host ints)."""
    return [x % OF.P for x in LZ.digits_to_ints(stack.reshape(-1, 30, stack.shape[-1])
                                                .transpose(0, 1))]


@pytest.mark.parametrize("fuse", [False, True])
def test_prepare_g2_and_miller_loop_truncated_match_jax(jax_truncated, fuse):
    """The truncated prepare and Miller loop against JAX's `fuse=False`: the
    unfused path digit for digit; the fused one by canonical value, its
    lines the canonical words of JAX's coefficients."""
    events = TRUNCATED
    jq, jp, jc, jf = jax_truncated
    got_c = PR.prepare_g2(CV.tree_from_jax(jq), fuse=fuse, events=events)
    want_c = CV.coeffs_from_jax(jc)
    if fuse:
        assert got_c.shape == (events, 6, W.WORDS, 4)
        assert torch.equal(got_c, W.digits_to_words_plain(want_c))
    else:
        assert got_c.shape == (events, 6, 30, 4)
        assert torch.equal(got_c, want_c)
    got_f = PR.miller_loop(CV.tree_from_jax(jp), got_c, fuse=fuse, events=events)
    assert got_f.shape == (12, 30, 4)
    want_f = torch.from_numpy(np.stack([_np(w) for w in JTL._flat12(jf)]).astype(np.int32))
    if fuse:
        assert _canonical(got_f) == _canonical(want_f)
    else:
        assert torch.equal(got_f, want_f)


@pytest.mark.parametrize("lines", ["words", "digits"])
def test_edge_entries_plain_match_jax_truncated(jax_truncated, lines):
    """`prepare_lines` and `miller_lines` on CPU tensors (their plain
    versions) from the strict Q and P against the JAX `fuse=False` prepare
    and Miller loop over 8 events: the lines the canonical words of JAX's
    coefficients; f from those words by canonical value, and from JAX's
    digit lines digit for digit."""
    jq, jp, jc, jf = jax_truncated
    schedule = PR.MILLER_EVENTS[:TRUNCATED]
    words = PS.prepare_lines(CV.tree_from_jax(jq), schedule)
    assert torch.equal(words, W.digits_to_words_plain(CV.coeffs_from_jax(jc)))
    c = words if lines == "words" else CV.coeffs_from_jax(jc)
    got = PR._conj(PS.miller_lines(c, CV.tree_from_jax(jp), schedule))
    want = torch.from_numpy(np.stack([_np(w) for w in JTL._flat12(jf)]).astype(np.int32))
    if lines == "words":
        assert _canonical(got) == _canonical(want)
    else:
        assert torch.equal(got, want)


def test_chains_on_cpu_match_jax_truncated(jax_truncated):
    """`prepare_chain` and `miller_chain` on CPU tensors (their plain
    versions) against the JAX `fuse=False` prepare and Miller loop over 8
    events, digit for digit."""
    jq, jp, jc, jf = jax_truncated
    schedule = PR.MILLER_EVENTS[:TRUNCATED]
    qx, qy = (TL.fp2_ingest(c) for c in CV.tree_from_jax(jq))
    coeffs = PS.prepare_chain(torch.stack([qx[0], qx[1], qy[0], qy[1]]), schedule)
    assert coeffs.shape == (TRUNCATED, 6, 30, 4)
    assert torch.equal(coeffs, CV.coeffs_from_jax(jc))
    px, py = (TL.fp_ingest(c) for c in CV.tree_from_jax(jp))
    f = TL.stack12(PR._fp12_one_like(px))
    got = PR._conj(PS.miller_chain(f, coeffs, torch.stack([px, py]), schedule))
    assert (got.numpy() == np.stack([_np(w) for w in JTL._flat12(jf)])).all()


@pytest.mark.parametrize("kernel,is_dbl", [("prepare", True), ("prepare", False),
                                           ("miller", True), ("miller", False)])
def test_chain_of_one_event_is_the_step(kernel, is_dbl):
    """A chain of one event is `prepare_step` / `miller_step`, digit for
    digit (the prepare's from R = (Q, 1)); an empty schedule, or one past
    MAX_EVENTS, is refused."""
    qx, qy = (TL.fp2_ingest(c) for c in CV.tree_from_jax(_jax_q(QS4)))
    q = torch.stack([qx[0], qx[1], qy[0], qy[1]])
    if kernel == "prepare":
        step = PS.prepare_step(PS._r_start(q), None if is_dbl else q)
        assert torch.equal(PS.prepare_chain(q, [is_dbl])[0], step[6:])
        call = lambda sched: PS.prepare_chain(q, sched)  # noqa: E731
    else:
        line = PS.prepare_chain(q, [True])
        px, py = (TL.fp_ingest(c) for c in CV.tree_from_jax(_jax_p(PS4)))
        pxy = torch.stack([px, py])
        f = TL.stack12(PR._fp12_one_like(px))
        f = PS.miller_step(f, line[0], pxy, True)  # f != 1, so the square matters
        got = PS.miller_chain(f, line, pxy, [is_dbl])
        assert torch.equal(got, PS.miller_step(f, line[0], pxy, is_dbl))
        call = lambda sched: PS.miller_chain(f, line.expand(len(sched), -1, -1, -1),  # noqa: E731
                                             pxy, sched)
    for bad in ([], [True] * (PS.MAX_EVENTS + 1)):
        with pytest.raises(ValueError):
            call(bad)


def test_pairing_batch_cpu_matches_oracle():
    ps = [PS4[0], None, PS4[2], PS4[3]]
    qs = [QS4[0], QS4[1], None, QS4[3]]
    got = B.pairing_batch(ps, qs, device="cpu")
    want = [JOP.pairing(p, q) for p, q in zip(ps, qs)]
    assert got == want
    assert got[1] == OF.FP12_ONE and got[2] == OF.FP12_ONE


@pytest.mark.parametrize("fuse", [True, False])
def test_prepared_equals_unprepared(fuse):
    """A prepared batch (words fused, digits unfused) pairs as the
    unprepared one does."""
    prep = B.prepare_g2_batch(QS4, fuse=fuse, device="cpu")
    assert prep.stacked.shape == (PR.NUM_EVENTS, 6, W.WORDS if fuse else 30, 4)
    assert prep.layout == ("words" if fuse else "digits")
    ps = [PS4[1], PS4[0], None, PS4[3]]
    got = B.pairing_batch(ps, prep, fuse=fuse, device="cpu")
    assert got == B.pairing_batch(ps, QS4, fuse=fuse, device="cpu")
    assert got[0] == JOP.pairing(PS4[1], QS4[0]) and got[2] == OF.FP12_ONE


@pytest.fixture(scope="module")
def prepared_formats():
    """Two pairs (an identity Q among them) prepared in each layout: lazy
    fused (words), lazy unfused (digits), strict (limbs)."""
    qs = [QS4[2], None]
    q, q_inf = B._g2_batch(qs, torch.device("cpu"))
    return qs, {"words": PR.prepare_g2_device(q, q_inf),
                "digits": PR.prepare_g2_device(q, q_inf, fuse=False),
                "limbs": PR.prepare_g2_device(q, q_inf, engine="strict")}


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("layout", ["words", "digits", "limbs"])
def test_prepared_formats_pair_under_either_fuse(prepared_formats, layout, fuse):
    """Each prepare layout paired under fuse=True and fuse=False: the Miller
    product (`multi_miller_loop_prepared`) against the oracle's, and for
    the lazy layouts the pairings (`pairing_prepared`) against the
    oracle's."""
    qs, preps = prepared_formats
    prep = preps[layout]
    assert prep.layout == layout
    rows = {"words": W.WORDS, "digits": 30, "limbs": 24}[layout]
    assert prep.stacked.shape == (PR.NUM_EVENTS, 6, rows, 2)
    ps = [PS4[3], PS4[1]]
    p, p_inf = B._g1_batch(ps, torch.device("cpu"))
    mml = PR.multi_miller_loop_prepared(p, prep, p_inf, fuse)
    assert CV.fp12_from_dev(mml) == [JOP.multi_miller_loop([(PS4[3], QS4[2])])]
    if layout != "limbs":
        got = CV.fp12_from_dev(PR.pairing_prepared(p, prep, p_inf, fuse))
        assert got == [JOP.pairing(PS4[3], QS4[2]), OF.FP12_ONE]


@pytest.mark.parametrize("prep_dev,pair_dev", [("cpu:0", "cpu:0"), ("cpu:0", "cpu"),
                                               ("cpu", "cpu:0")])
def test_prepared_on_an_indexed_device(prep_dev, pair_dev):
    """A prepared batch made on one spelling of a device pairs on another:
    `resolve_device` normalizes both as a tensor's `.device` reads."""
    assert T.resolve_device(prep_dev) == T.resolve_device(pair_dev) == torch.device("cpu")
    prep = B.prepare_g2_batch(QS4[:2], device=prep_dev)
    ps = [PS4[2], None]
    got = B.pairing_batch(ps, prep, device=pair_dev)
    assert got == [JOP.pairing(PS4[2], QS4[0]), OF.FP12_ONE]


def test_multi_pairing_matches_oracle_product():
    ps, qs = [PS4[0], PS4[1], None], [QS4[0], QS4[1], QS4[2]]
    want = JOP.final_exp(JOP.multi_miller_loop(list(zip(ps, qs))))
    assert B.multi_pairing(ps, qs, device="cpu") == want
    assert want == OF.fp12_mul(JOP.pairing(PS4[0], QS4[0]), JOP.pairing(PS4[1], QS4[1]))
    mml = PR.multi_miller_loop(*[CV.tree_from_jax(x) for x in (_jax_p(ps[:2]), _jax_q(qs[:2]))])
    assert CV.fp12_from_dev(mml) == [JOP.multi_miller_loop(list(zip(ps[:2], qs[:2])))]


def test_bilinearity_through_the_tensor_entry():
    """e(aP, Q) == e(P, aQ) == e(P, Q)^a, through the strict-tensor `pairing`."""
    a = random.Random(9).randrange(1, OF.R)
    ps = [OC.scalar_mul(PS4[0], a), PS4[0]]
    qs = [QS4[0], OC.g2_mul(QS4[0], a)]
    p = (CV.fp_to_dev([x[0] for x in ps]), CV.fp_to_dev([x[1] for x in ps]))
    q = (CV.fp2_to_dev([x[0] for x in qs]), CV.fp2_to_dev([x[1] for x in qs]))
    out = CV.fp12_from_dev(T.pairing(p, q, device="cpu"))
    assert out[0] == out[1] != OF.FP12_ONE
    e = JOP.pairing(PS4[0], QS4[0])
    acc, base, k = OF.FP12_ONE, e, a
    while k:
        if k & 1:
            acc = OF.fp12_mul(acc, base)
        base, k = OF.fp12_sqr(base), k >> 1
    assert out[0] == acc


def test_entry_points_reject_mismatched_batches():
    with pytest.raises(ValueError):
        B.pairing_batch([PS4[0]], QS4[:2], device="cpu")
    prep = B.prepare_g2_batch(QS4[:2], device="cpu")
    with pytest.raises(ValueError):
        B.pairing_batch([PS4[0]], prep, device="cpu")
    assert B.pairing_batch([], [], device="cpu") == []
    assert B.multi_pairing([], [], device="cpu") == OF.FP12_ONE
