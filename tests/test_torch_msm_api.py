"""The port's user-level entry `G1.msm` (affine int tuples in and out, the
default window c=7) against the JAX package's host oracle, with an identity
point and a zero scalar in the stream. Alone in its file: at c=7 the plain
reduce of 37 windows x 65 buckets x 1024 streams takes most of a minute on
the CPU."""

import os
import random

import pytest
import torch

from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu_torch import G1
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle.field import G1_GEN, R


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """One torch thread per core in every pytest-xdist worker oversubscribes
    the machine and slows this module's tests about tenfold: split the cores
    among the workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def test_g1_msm_default_window_matches_oracle():
    rng = random.Random(31)
    n = 16
    pts = [OC.scalar_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = [rng.randrange(R) for _ in range(n)]
    pts[3], scs[9] = None, 0
    assert G1.msm(pts, scs, device="cpu") == JOC.msm(JOC.FP_OPS, pts, scs)
    assert G1.msm([], [], device="cpu") is None
