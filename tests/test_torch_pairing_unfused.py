"""The port's unfused lazy pairing (`fuse=False`: K11, K12, single K3
squares) against the JAX package and against the port's fused pipeline.

* K11's and K12's plain versions against JAX `tower_lazy.fp12_sqr` and a
  single-item `fp12_mul_by_014_many`, digit for digit (exact);
* the truncated unfused prepare/Miller loop against JAX `fuse=False,
  engine="lazy"`, digit for digit (exact);
* every stage of the unfused pipeline against the fused one, digit for
  digit (exact), and `bls12.pairing_batch(..., fuse=False)` against the
  oracle by value;
* `tower_lazy.fp_inv_batch` by value against the oracle's inverses: the
  JAX `fp_inv_batch` compiles its width-1 Fermat `lax.scan` for minutes on
  XLA:CPU (278 s on one run), so it is not called here.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL
from ark_blst_tpu.oracle import pairing as JOP

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
from ark_blst_tpu_torch.ops import fp12_sqr as K11
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

RNG = random.Random(5)
PS2 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]
QS2 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]
F = LZ.F_BOUND


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


def _raw_stack(seed, rows, n=5):
    """(rows, 30, n) mul-ready digits, the extreme patterns in the first
    columns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-F, F + 1, (rows, 30, n)).astype(np.int32)
    a[:, :, 0], a[:, :, 1], a[:, :, 2] = F, -F, 8191
    a[:, :, 3] = [F if k % 2 else -F for k in range(30)]
    return a


def _fp12_values(seed, n):
    """n random fp12 values as the oracle's nested int tuples."""
    rng = np.random.default_rng(seed)
    ints = iter([int.from_bytes(rng.bytes(48), "little") % OF.P for _ in range(12 * n)])
    return [tuple(tuple((next(ints), next(ints)) for _ in range(3)) for _ in range(2))
            for _ in range(n)]


def _jax_fp12(values):
    return JTL._pack12([jnp.asarray(x) for x in values])


@pytest.mark.parametrize("source", ["raw", "ingested"])
def test_k11_plain_matches_jax_sqr(source):
    if source == "raw":
        a = _raw_stack(1, 12)
        ja = _jax_fp12(list(a))
    else:
        ja = JTL.fp12_ingest(JCV.fp12_to_dev(_fp12_values(1, 3)))
        a = np.stack([_np(x) for x in JTL._flat12(ja)]).astype(np.int32)
    got = K11.fp12_sqr(torch.from_numpy(a))
    assert (got.numpy() == np.stack([_np(x) for x in JTL._flat12(JTL.fp12_sqr(ja))])).all()


@pytest.mark.parametrize("source", ["raw", "event"])
def test_k12_plain_matches_jax_mul_by_014(source):
    """K12's rows c0, c1, c4 against a single-item JAX fp12_mul_by_014_many;
    the event case takes f and the scaled legs of a real Miller event."""
    if source == "raw":
        f, c = _raw_stack(2, 12), _raw_stack(3, 6)
    else:  # the port's pipeline is held against JAX's in the test below
        p = (CV.fp_to_dev([x[0] for x in PS2]), CV.fp_to_dev([x[1] for x in PS2]))
        q = (CV.fp2_to_dev([x[0] for x in QS2]), CV.fp2_to_dev([x[1] for x in QS2]))
        coeffs = PR.prepare_g2(q, fuse=False, events=2)
        pxy = [TL.fp_ingest(x) for x in p]
        a0, a1, a4 = PS._ell_legs(TL, PR._line(coeffs[1]), *pxy)
        f = K11.fp12_sqr(PR.miller_loop(p, coeffs, fuse=False, events=1)).numpy()
        c = torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]]).numpy()
    jf = _jax_fp12(list(f))
    jc = [jnp.asarray(x) for x in c]
    want = JTL.fp12_mul_by_014_many([(jf, (jc[0], jc[1]), (jc[2], jc[3]), (jc[4], jc[5]))])[0]
    got = K12.fp12_mul_by_014(torch.from_numpy(f), torch.from_numpy(c))
    assert (got.numpy() == np.stack([_np(x) for x in JTL._flat12(want)])).all()


def test_unfused_prepare_and_miller_truncated_match_jax():
    events = 8
    jq, jp = _jax_q(QS2), _jax_p(PS2)
    jc = DP.prepare_g2(jq, fuse=False, engine="lazy", events=events)
    got_c = PR.prepare_g2(CV.tree_from_jax(jq), fuse=False, events=events)
    assert got_c.shape == (events, 6, 30, 2)
    assert torch.equal(got_c, CV.coeffs_from_jax(jc))
    jf = DP.miller_loop(jp, jc, fuse=False, engine="lazy", events=events)
    before = (K11.KERNEL.launches, K12.KERNEL.launches)
    got_f = PR.miller_loop(CV.tree_from_jax(jp), got_c, fuse=False, events=events)
    assert (K11.KERNEL.launches, K12.KERNEL.launches) == before  # CPU: the plain versions
    for g, w in zip(got_f, JTL._flat12(jf)):
        assert (g.numpy() == _np(w)).all()


def test_unfused_pipeline_equals_fused_digit_for_digit():
    """prepare_g2 with fuse=False gives the fused path's lines by value (the
    fused ones are their canonical words); on those lines miller_loop,
    cyclotomic_exp_x_conj and final_exp with fuse=False give the fused
    path's digits: K6 = K11 + legs + K12, and a K3 run of n is n single
    squares."""
    p = (CV.fp_to_dev([x[0] for x in PS2]), CV.fp_to_dev([x[1] for x in PS2]))
    q = (CV.fp2_to_dev([x[0] for x in QS2]), CV.fp2_to_dev([x[1] for x in QS2]))
    coeffs = PR.prepare_g2(q)
    assert torch.equal(W.digits_to_words_plain(PR.prepare_g2(q, fuse=False)), coeffs)
    f = PR.miller_loop(p, coeffs)
    assert torch.equal(PR.miller_loop(p, coeffs, fuse=False), f)
    assert torch.equal(PR.cyclotomic_exp_x_conj(f, fuse=False), PR.cyclotomic_exp_x_conj(f))
    out = PR.final_exp(f, fuse=False)
    assert torch.equal(out, PR.final_exp(f))
    assert CV.fp12_from_dev(PR.egress(out)) == [JOP.pairing(a, b) for a, b in zip(PS2, QS2)]


def test_pairing_batch_unfused_matches_oracle():
    ps, qs = [PS2[0], None, PS2[1]], [QS2[1], QS2[0], QS2[0]]
    got = B.pairing_batch(ps, qs, fuse=False, device="cpu")
    assert got == [JOP.pairing(PS2[0], QS2[1]), OF.FP12_ONE, JOP.pairing(PS2[1], QS2[0])]
    prep = B.prepare_g2_batch(qs, fuse=False, device="cpu")
    assert prep.engine == "lazy" and prep.stacked.shape == (PR.NUM_EVENTS, 6, 30, 3)
    assert B.pairing_batch([None, PS2[1], PS2[0]], prep, fuse=False, device="cpu") == [
        OF.FP12_ONE, JOP.pairing(PS2[1], QS2[0]), JOP.pairing(PS2[0], QS2[0])]


@pytest.mark.parametrize("n", [5, 8])
def test_fp_inv_batch_by_value(n):
    """The log-depth batch inversion, padded (5) and a power of two (8),
    against the oracle, and against the per-lane Fermat ladder by value."""
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(48), "little") % OF.P or 1 for _ in range(n)]
    vals[0], vals[1] = 1, OF.P - 1
    a = TL.fp_ingest(CV.fp_to_dev(vals))
    got = TL.fp_inv_batch(a)
    assert got.shape == a.shape and int(got.abs().max()) <= 8191
    want = [pow(v, -1, OF.P) for v in vals]
    assert CV.fp_from_dev(TL.fp_egress(got)) == want
    assert CV.fp_from_dev(TL.fp_egress(TL.fp_inv(a))) == want
    two_d = TL.fp_inv_batch(a.reshape(30, 1, n))
    assert torch.equal(two_d.reshape(30, n), got)


def test_tower_additions_match_jax():
    """The lazy tower's fp12_add/sub, fp6_sqr and the sparse fp6 products,
    which the pairing does not call, against JAX digit for digit."""
    vals = _fp12_values(2, 3)
    ja = JTL.fp12_ingest(JCV.fp12_to_dev(vals))
    jb = JTL.fp12_ingest(JCV.fp12_to_dev(vals[::-1]))
    ta, tb = CV.tree_from_jax(ja), CV.tree_from_jax(jb)
    t0, t1 = tb[1][0], tb[1][1]
    b0, b1 = jb[1][0], jb[1][1]
    cases = [
        (TL.fp12_add(ta, tb), JTL.fp12_add(ja, jb)),
        (TL.fp12_sub(ta, tb), JTL.fp12_sub(ja, jb)),
        (TL.fp6_sqr(ta[0]), JTL.fp6_sqr(ja[0])),
        (TL.fp6_mul_by_01_many([(ta[0], t0, t1), (ta[1], t1, t0)]),
         JTL.fp6_mul_by_01_many([(ja[0], b0, b1), (ja[1], b1, b0)])),
        (TL.fp6_mul_by_1_many([(ta[0], t1)]), JTL.fp6_mul_by_1_many([(ja[0], b1)])),
    ]
    for got, want in cases:
        g, w = _leaves(got), [_np(x) for x in _leaves(want)]
        assert len(g) == len(w)
        assert all((x.numpy() == y).all() for x, y in zip(g, w))


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_launch_counters_untouched_on_cpu():
    before = (K11.KERNEL.launches, K12.KERNEL.launches, K3.KERNEL.launches)
    x = torch.from_numpy(_raw_stack(4, 12))
    K11.fp12_sqr(x)
    K12.fp12_mul_by_014(x, x[:6].contiguous())
    assert (K11.KERNEL.launches, K12.KERNEL.launches, K3.KERNEL.launches) == before
