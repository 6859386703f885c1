"""The port's scan Pippenger MSM on the strict engine (curves/msm.py `msm`,
`msm_naive`, `window_digits`) against the JAX package: the MSM at
(n, c, lanes) = (10, 4, 4) digit for digit against JAX `curves/msm.py:msm`
on the same inputs, the window digits digit for digit, and `msm_naive` and
the identity-point and zero-scalar case against the oracle.
tests/test_torch_strict_msm_cases.py and tests/test_torch_strict_msm_g2.py
hold the other cases of tests/test_msm.py."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import group as JG
from ark_blst_tpu.curves import msm as JM
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves.group import G1
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among the pytest-xdist workers while the module runs
    (one torch thread per core in every worker oversubscribes the machine)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def g1_points(rng, n):
    return [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(n)]


def to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def test_msm_matches_jax_digit_for_digit():
    rng = random.Random(1234)
    pts, scs = g1_points(rng, 10), [rng.randrange(OF.R) for _ in range(10)]
    points, scalars = CV.g1_to_dev(pts), CV.fr_to_dev(scs)
    got = M.msm(points, scalars, G1, c=4, lanes=4, device="cpu")
    want = JM.msm(to_jax(points), to_jax(scalars), curve=JG.G1, c=4, lanes=4)
    for g, w in zip(got, want):
        assert g.shape == (24, 1) and (g.numpy() == np.asarray(w).astype(np.int64)).all()
    assert CV.g1_from_dev(got) == [OC.msm(pts, scs)]


@pytest.mark.parametrize("c", [4, 8, 13])
def test_window_digits_match_jax_and_reconstruct(c):
    rng = random.Random(c)
    scs = [0, 1, OF.R - 1, (1 << 255) - 1] + [rng.randrange(OF.R) for _ in range(8)]
    scalars = CV.fr_to_dev(scs)
    digs = M.window_digits(scalars, c)
    assert (digs.numpy() == np.asarray(JM.window_digits(to_jax(scalars), c))).all()
    for i, s in enumerate(scs):
        assert sum(int(digs[w, i]) << (c * w) for w in range(digs.shape[0])) == s % OF.R


def test_msm_naive_matches_oracle():
    rng = random.Random(5)
    pts, scs = g1_points(rng, 5), [rng.randrange(OF.R) for _ in range(5)]
    out = M.msm_naive(CV.g1_to_dev(pts), CV.fr_to_dev(scs), G1, device="cpu")
    assert CV.g1_from_dev(out) == [OC.msm(pts, scs)]


def test_msm_with_identity_and_zero_scalars():
    """The case blst's Pippenger mishandles, at c = 4 (the window does not
    matter to it; c = 8 would add a 255-step bucket reduction)."""
    rng = random.Random(38)
    pts = g1_points(rng, 6) + [None, None]
    scs = [rng.randrange(OF.R) for _ in range(6)] + [rng.randrange(OF.R), 0]
    pts, scs = pts + [pts[0]], scs + [0]  # and a zero scalar on a real point
    out = M.msm(CV.g1_to_dev(pts), CV.fr_to_dev(scs), G1, c=4, lanes=4, device="cpu")
    assert CV.g1_from_dev(out) == [OC.msm(pts, scs)]
