"""K2 (curves/msm_bucket.py:accumulate): the wrapper's plain version against
the JAX package's Pallas bucket kernel `msm_pallas2._accumulate2`, run in
interpret mode at one tile of 1024 streams, one window, c=3, bucket for
bucket (1..B-1; bucket 0 is the dropped sink, which the TPU kernel fills
with garbage adds and the port leaves at the identity)."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.curves import msm_pallas2 as MP2
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.ops import convert as CV


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


def test_plain_k2_matches_pallas_interpret():
    rng = np.random.default_rng(33)
    c, W, B = 3, 1, MB._num_buckets(3)
    digits = rng.integers(-4096, 4096, (60, 1024)).astype(np.int32)
    pts = torch.cat([MB.pack30(torch.from_numpy(digits[:30])),
                     MB.pack30(torch.from_numpy(digits[30:]))])  # (30, 1024)
    mag = rng.integers(0, B, (W, 1024))
    sign = rng.integers(0, 2, (W, 1024))
    digs = torch.from_numpy((mag | (sign << 15)).astype(np.int32))
    prev = MP2.INTERPRET
    MP2.INTERPRET = True
    try:
        want = MP2._accumulate2(
            jnp.asarray(pts.numpy().astype(np.uint32).reshape(30, 1, 8, 128)),
            jnp.asarray(digs.numpy().astype(np.uint32).reshape(W, 1, 8, 128)),
            kc=MP2.KC2_G1, c=c)
    finally:
        MP2.INTERPRET = prev
    want = CV.from_jax(np.asarray(want), lead=3)  # (W, B, 45, 1024)
    before = MB.KERNEL.launches
    got = MB.accumulate(MB.KC2_G1, pts, digs, c)
    assert MB.KERNEL.launches == before  # a CPU tensor never reaches the kernel
    assert got.shape == want.shape == (W, B, 45, 1024)
    assert torch.equal(got[:, 1:], want[:, 1:])
    assert (got[:, 0] == torch.from_numpy(MB.KC2_G1.identity_rows())[:, None]).all()
