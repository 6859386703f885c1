"""A case of tests/test_msm.py (slow-marked there) through the port's scan
MSM on the strict engine (curves/msm.py `msm`), against the oracle: G1 at
(n, c, lanes) = (37, 8, 8), the JAX package's default window, where the
bucket reduction runs 255 steps. The other cases are in
tests/test_torch_strict_msm.py and tests/test_torch_strict_msm_g2.py: on
one core each of the three files takes well under a minute."""

import os
import random

import pytest
import torch

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


def test_msm_g1_37_points_matches_oracle():
    rng = random.Random(37)
    pts, scs = g1_points(rng, 37), [rng.randrange(OF.R) for _ in range(37)]
    out = M.msm(CV.g1_to_dev(pts), CV.fr_to_dev(scs), G1, c=8, lanes=8, device="cpu")
    assert CV.g1_from_dev(out) == [OC.msm(pts, scs)]
