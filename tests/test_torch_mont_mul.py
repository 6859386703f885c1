"""K1 (ops/mont_mul.py): the wrapper's plain version against the JAX
package's Pallas kernel `pallas_lazy.mont_mul_stacked`, run in interpret
mode, digit for digit at its (30, 8, 128) block shape."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.ops import pallas_lazy as PLZ
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM

F = LZ.F_BOUND


def _operands():
    rng = np.random.default_rng(2024)
    a = rng.integers(-F, F + 1, (30, 8, 128)).astype(np.int32)
    b = rng.integers(-F, F + 1, (30, 8, 128)).astype(np.int32)
    a[:, 0, 0], b[:, 0, 0] = F, F  # all +F
    a[:, 0, 1], b[:, 0, 1] = -F, -F  # all -F
    a[:, 0, 2] = [F if k % 2 else -F for k in range(30)]
    b[:, 0, 3] = 0  # zero operand
    return a, b


def test_plain_k1_matches_pallas_interpret():
    a, b = _operands()
    prev = PLZ.INTERPRET
    PLZ.INTERPRET = True
    try:
        want = np.asarray(PLZ.mont_mul_stacked(jnp.asarray(a), jnp.asarray(b)))
    finally:
        PLZ.INTERPRET = prev
    before = MM.KERNEL.launches
    got = MM.mont_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (30, 8, 128) and got.dtype == torch.int32
    assert (got.numpy() == want).all()
    assert MM.KERNEL.launches == before  # a CPU tensor never reaches the kernel


@pytest.mark.parametrize("bad", ["shape", "digits", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((30, 16), dtype=torch.int32)
    b = {
        "shape": torch.zeros((30, 8), dtype=torch.int32),
        "digits": torch.zeros((24, 16), dtype=torch.int32),
        "dtype": torch.zeros((30, 16), dtype=torch.int64),
    }[bad]
    with pytest.raises(ValueError):
        MM.mont_mul(a, b)


def test_wrapper_raises_off_cpu_and_cuda():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises, never falls back."""
    a = torch.zeros((30, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        MM.mont_mul(a, a)
