"""The CUDA kernels on the card against their plain PyTorch versions, and the
G1 MSM on the card against the host oracle. Needs an NVIDIA Hopper card and
nvcc; skipped without a card. Imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from ark_blst_tpu_torch import G1
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

pytestmark = pytest.mark.cuda

F = LZ.F_BOUND


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def test_k1_bit_equal_to_plain(dev):
    rng = np.random.default_rng(1)
    n = 1 << 16
    a = rng.integers(-F, F + 1, (30, n)).astype(np.int32)
    b = rng.integers(-F, F + 1, (30, n)).astype(np.int32)
    a[:, 0], b[:, 0] = F, F
    a[:, 1], b[:, 1] = -F, -F
    a[:, 2], b[:, 2] = 8191, 8191  # canonical x canonical
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    before = MM.KERNEL.launches
    got = MM.mont_mul(at, bt)
    torch.cuda.synchronize()
    assert MM.KERNEL.launches == before + 1
    assert torch.equal(got, MM.mont_mul_plain(at, bt))


def test_k2_bucket_equal_to_plain(dev):
    rng = np.random.default_rng(2)
    n, c = 2048, 4
    W, B = MB._num_windows(c), MB._num_buckets(c)
    d = rng.integers(-4096, 4096, (60, n)).astype(np.int32)
    pts = torch.cat([MB.pack30(torch.from_numpy(d[:30])), MB.pack30(torch.from_numpy(d[30:]))])
    mag = rng.integers(0, B, (W, n))
    sign = rng.integers(0, 2, (W, n))
    digs = torch.from_numpy((mag | (sign << 15)).astype(np.int32))
    pts, digs = pts.to(dev).contiguous(), digs.to(dev)
    before = MB.KERNEL.launches
    got = MB.accumulate(pts, digs, c)
    torch.cuda.synchronize()
    assert MB.KERNEL.launches == before + 1
    assert torch.equal(got, MB.accumulate_plain(pts, digs, c))


def test_msm_on_card_matches_oracle(dev):
    rng = random.Random(3)
    base = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(8)]
    pts = [base[i % 8] for i in range(3000)]
    scs = [rng.randrange(OF.R) for _ in range(3000)]
    pts[10], scs[11] = None, 0
    agg = [0] * 8
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 8] += s
    want = OC.msm(base, agg)
    assert G1.msm(pts, scs, device=dev) == want
