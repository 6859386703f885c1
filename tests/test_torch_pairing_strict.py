"""The port's strict-engine pairing steps (`curves/pairing.py`,
`engine="strict"`) against the JAX package: `prepare_g2` and `miller_loop`
over all 68 events at batch 2, on both routes (`fuse=True`: the chains on
strict limbs, on CPU tensors their plain versions; `fuse=False`: the strict
tower step by step), against JAX `prepare_g2`/`miller_loop`
(`engine="strict", fuse=False`, the same steps as its `lax.scan`s) and
against each other, limb for limb (strict values are canonical, so the
tolerance is zero), and the identity mask of the Miller product by value
against the oracle.
"""

import os
import random

import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV

from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

RNG = random.Random(11)
PS2 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]
QS2 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(2)]


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _p(pts):
    return (CV.fp_to_dev([x[0] for x in pts]), CV.fp_to_dev([x[1] for x in pts]))


def _q(qs):
    return (CV.fp2_to_dev([x[0] for x in qs]), CV.fp2_to_dev([x[1] for x in qs]))


@pytest.fixture(scope="module")
def strict_routes():
    """The port's strict coefficients and Miller loop of (PS2, QS2) on each
    route, by `fuse`."""
    before = {k: v.launches for k, v in SF.KERNELS.items()}
    out = {}
    for fuse in (True, False):
        coeffs = PR.prepare_g2(_q(QS2), fuse=fuse, engine="strict")
        out[fuse] = coeffs, PR.miller_loop(_p(PS2), coeffs, fuse=fuse, engine="strict")
    assert {k: v.launches for k, v in SF.KERNELS.items()} == before  # CPU: plain versions
    return out


@pytest.fixture(scope="module")
def jax_strict():
    """JAX's strict coefficients and Miller loop of (PS2, QS2), eager."""
    jq = (JCV.fp2_to_dev([x[0] for x in QS2]), JCV.fp2_to_dev([x[1] for x in QS2]))
    jp = (JCV.fp_to_dev([x[0] for x in PS2]), JCV.fp_to_dev([x[1] for x in PS2]))
    jc = DP.prepare_g2(jq, fuse=False, engine="strict")
    return jc, DP.miller_loop(jp, jc, fuse=False, engine="strict")


@pytest.fixture(params=[True, False], ids=["fused", "unfused"])
def fuse(request):
    return request.param


@pytest.fixture
def strict_miller(fuse, strict_routes):
    return strict_routes[fuse]


def test_schedule_has_all_events():
    assert PR.NUM_EVENTS == DP.NUM_EVENTS == 68 and sum(PR.MILLER_EVENTS) == 63


def test_prepare_and_miller_loop_match_jax(strict_miller, jax_strict):
    coeffs, f = strict_miller
    jc, jf = jax_strict
    assert coeffs.shape == (68, 6, 24, 2)
    assert torch.equal(coeffs, CV.coeffs_from_jax(jc))
    got, want = _leaves(f), _leaves(jf)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.shape == (24, 2)
        assert (g.numpy().astype(np.int64) == np.asarray(w).astype(np.int64)).all()
    assert CV.fp12_from_dev(f) == [OP.miller_loop(p, q) for p, q in zip(PS2, QS2)]


def test_identity_mask_sets_one(strict_miller, fuse):
    """The pairs that hold an identity (either mask) leave the Miller loop
    as one; the others as they were (fused: the mask on the stacked
    limbs)."""
    coeffs, f = strict_miller
    p_inf, q_inf = torch.tensor([True, False]), torch.tensor([False, False])
    got = PR._masked_miller(_p(PS2), coeffs, p_inf, q_inf, fuse=fuse, engine="strict")
    assert all(x.shape == (24, 2) for x in _leaves(got))
    assert CV.fp12_from_dev(got) == [OF.FP12_ONE, CV.fp12_from_dev(f)[1]]


def test_strict_routes_agree(strict_routes):
    """The fused route's lines and conj(f) equal the unfused route's limb for
    limb: both canonical; the fused f leaves are views of one (12, 24, N)
    stack."""
    (c1, f1), (c0, f0) = strict_routes[True], strict_routes[False]
    assert torch.equal(c1, c0)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(f1), _leaves(f0)))
    assert all(x._base is _leaves(f1)[0]._base for x in _leaves(f1))


def test_engine_names_are_checked():
    with pytest.raises(ValueError, match="engine"):
        PR.prepare_g2(_q(QS2), engine="fast")
    with pytest.raises(ValueError, match="engine"):
        PR.final_exp(None, engine="fast")
