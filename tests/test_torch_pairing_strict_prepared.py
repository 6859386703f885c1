"""The port's strict-engine prepared pairing (`prepare_g2_device`,
`pairing_prepared`, `multi_miller_loop_prepared` with `engine="strict"`)
on both routes (`fuse=True`, the chains on strict limbs; `fuse=False`, the
strict tower) against the oracle's canonical limbs and against the lazy
engine, limb for limb, at batch 2 with identity masks on both sides
(exact: the strict and the lazy engine egress canonical limbs, as JAX's
strict engine does); and the fused strict `multi_pairing` likewise."""

import os
import random

import pytest
import torch

from ark_blst_tpu.oracle import pairing as JOP

from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

RNG = random.Random(12)
PS2 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]
QS2 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]
P = (CV.fp_to_dev([x[0] for x in PS2]), CV.fp_to_dev([x[1] for x in PS2]))
Q = (CV.fp2_to_dev([x[0] for x in QS2]), CV.fp2_to_dev([x[1] for x in QS2]))


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def fuse(request):
    return request.param


@pytest.fixture(scope="module")
def prepared(fuse):
    """Q prepared once on the strict engine's route, Q_1 marked as the
    identity."""
    prep = PR.prepare_g2_device(Q, torch.tensor([False, True]), fuse=fuse, engine="strict")
    assert prep.engine == "strict" and prep.n == 2 and prep.layout == "limbs"
    assert prep.stacked.shape == (PR.NUM_EVENTS, 6, 24, 2)
    return prep


def _canonical(values) -> list:
    """Oracle fp12 values -> their canonical strict limbs, as leaves."""
    return _leaves(CV.fp12_to_dev(values))


def test_pairing_prepared_strict(prepared, fuse):
    out = PR.pairing_prepared(P, prepared, torch.tensor([False, False]), fuse=fuse)
    want = [JOP.pairing(PS2[0], QS2[0]), OF.FP12_ONE]
    assert CV.fp12_from_dev(out) == want
    assert all(torch.equal(g, w) for g, w in zip(_leaves(out), _canonical(want)))
    with pytest.raises(ValueError):
        PR.pairing_prepared((P[0][:, :1], P[1][:, :1]), prepared, fuse=fuse)


def test_multi_miller_loop_prepared_strict(prepared, fuse):
    """The strict product of the Miller loops equals the lazy engine's and
    the oracle's (the identity pair contributes one)."""
    p_inf = torch.tensor([False, False])
    got = PR.multi_miller_loop_prepared(P, prepared, p_inf, fuse=fuse)
    lazy = PR.prepare_g2_device(Q, prepared.q_inf)
    want = PR.multi_miller_loop_prepared(P, lazy, p_inf)
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got), _leaves(want)))
    assert CV.fp12_from_dev(got) == [JOP.multi_miller_loop([(PS2[0], QS2[0])])]


def test_multi_pairing_strict_fused():
    """The fused strict `multi_pairing` (the chains on strict limbs, the fold
    on the strict tower, FE-easy and FE-hard on its product) against the
    oracle's canonical limbs and the lazy engine's, limb for limb."""
    q_inf = torch.tensor([False, True])
    got = PR.multi_pairing(P, Q, None, q_inf, engine="strict")
    want = [JOP.final_exp(JOP.multi_miller_loop([(PS2[0], QS2[0])]))]
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got), _canonical(want)))
    lazy = PR.multi_pairing(P, Q, None, q_inf)
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got), _leaves(lazy)))


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]
