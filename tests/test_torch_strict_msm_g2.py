"""The G2 case of tests/test_msm.py (slow-marked there) through the port's
scan MSM on the strict engine (curves/msm.py `msm` with `G2`), against the
oracle, at (n, c, lanes) = (9, 4, 4)."""

import os
import random

import pytest
import torch

from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves.group import G2
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


def test_msm_g2_matches_oracle():
    rng = random.Random(39)
    pts = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(9)]
    scs = [rng.randrange(OF.R) for _ in range(9)]
    out = M.msm(CV.g2_to_dev(pts), CV.fr_to_dev(scs), G2, c=4, lanes=4, device="cpu")
    assert CV.g2_from_dev(out) == [OC.g2_msm(pts, scs)]
