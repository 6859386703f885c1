"""K1-inv's, K1-scan's and K7-inv's wrappers on the CPU (`ops/fp_inv.py`): CPU tensors
take the plain versions, which are the loops of lazy products the port ran
before, digit for digit, and agree with the JAX package: the Fermat ladder
digit for digit with JAX `tower_lazy.fp_inv(fuse=False)` (its product
jitted, which leaves its integers as they are), the blocked batch inversion
by value with JAX's exact host inversion `_batch_inverse_host`. The wrappers
reject what the kernels do not take and launch nothing for CPU tensors.
The kernels themselves run on the card (tests/test_torch_cuda.py); their
bodies run here under g++ (tests/test_torch_fp_inv_host.py).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import msm_pallas2 as JMP2
from ark_blst_tpu.ops import tower_lazy as JTL
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.oracle import field as OF

P = OF.P
KERNELS = (FI.KERNEL_INV, FI.KERNEL_UP, FI.KERNEL_DOWN, FI.KERNEL_INV_LIMBS)


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the torch threads among the pytest-xdist workers while the
    module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def digit_stack(seed: int, n: int) -> torch.Tensor:
    """Random mul-ready digits, the extreme patterns in the first columns."""
    F = LZ.F_BOUND
    rng = np.random.default_rng(seed)
    d = rng.integers(-F, F + 1, (30, n)).astype(np.int32)
    d[:, 0], d[:, 1] = F, -F
    d[:, 2] = [F if k % 2 else -F for k in range(30)]
    return torch.from_numpy(d)


def values(d: torch.Tensor) -> list:
    return [v % P for v in LZ.digits_to_ints(d)]


def inverse_value(x: int) -> int:
    return pow(x, -1, P) * LZ.R13_SQ % P if x % P else 0


def test_fp_inv_equals_jax_digit_for_digit(monkeypatch):
    """The ladder on 16 lanes, with X = 0, 1, p-1 in three of them: digit
    for digit with JAX `tower_lazy.fp_inv(fuse=False)`, the ladder of lazy
    products it replaces, by value with R13^2 X^-1 mod p; through the
    tower's `fp_inv` too."""
    x = digit_stack(1, 16)
    for col, v in enumerate((0, 1, P - 1), start=3):
        x[:, col] = torch.from_numpy(LZ.int_to_digits(v))
    monkeypatch.setattr(JTL, "_mul", jax.jit(JTL._mul))
    want = np.asarray(JTL.fp_inv(jnp.asarray(x.numpy()), fuse=False))
    got = FI.fp_inv(x)
    assert (got.numpy() == want).all()
    assert torch.equal(TL.fp_inv(x), got)
    assert values(got) == [inverse_value(v) for v in values(x)]


@pytest.mark.parametrize("n", [3000, 4096, 8192])
def test_batch_inverse_equals_the_loop_it_replaces(n):
    """One level and the ladder at the root (g = 8 at 3000, 64 at 4096 and
    8192): digit for digit with the plain version, the loop of lazy
    products it replaces, and by value with JAX's exact host inversion."""
    z = digit_stack(n, n)
    got = FI.batch_inverse(z)
    assert torch.equal(got, FI.batch_inverse_plain(z))
    want = JMP2._batch_inverse_host([jnp.asarray(z[k].numpy()) for k in range(30)])
    want = torch.from_numpy(np.stack([np.asarray(w) for w in want]).astype(np.int32))
    assert values(got) == values(want)


def test_levels():
    """The rows of each level: 64 while they divide n, the ladder at or
    below 2048 elements; the G1 MSM at 2^22 has two levels (m = 65,536,
    then 1,024), as the G2 MSM at 2^20 (16,384, then 256)."""
    def levels(n):
        out = []
        while (g := FI.block_rows(n)) is not None:
            n //= g
            out.append(n)
        return out

    assert levels(1 << 22) == [65536, 1024]
    assert levels(1 << 20) == [16384, 256]
    assert levels(8192) == [128]
    assert levels(2048) == [] and levels(2049) == [] and levels(3000) == [375]


def test_scan_passes_on_the_cpu():
    """scan_up / scan_down on CPU tensors are the plain passes: the column
    products and, given their inverses, every element's inverse."""
    g, m = 4, 8
    z = digit_stack(7, g * m)
    pre, total = FI.scan_up(z, g)
    want_pre, want_total = FI.scan_up_plain(z, g)
    assert torch.equal(pre, want_pre) and torch.equal(total, want_total)
    assert tuple(pre.shape) == (g, 30, m) and tuple(total.shape) == (30, m)
    inv = FI.scan_down(z, pre, FI.fp_inv(total), g)
    assert values(inv) == [inverse_value(v) for v in values(z)]


def test_cpu_calls_launch_nothing():
    z = digit_stack(3, 4096)
    before = [k.launches for k in KERNELS] + [MM.KERNEL.launches]
    FI.batch_inverse(z)
    FI.fp_inv(z[:, :4].contiguous())
    FI.fp_inv_limbs(torch.zeros((24, 2, 2), dtype=torch.int32))
    assert [k.launches for k in KERNELS] + [MM.KERNEL.launches] == before


@pytest.mark.parametrize("bad", ["rows", "dim", "dtype", "device", "g", "inv_total", "pre",
                                 "limb_rows", "limb_dtype", "limb_device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    z = torch.zeros((30, 16), dtype=torch.int32)
    pre, total = FI.scan_up(z, 4)
    call = {
        "rows": lambda: FI.fp_inv(torch.zeros((24, 16), dtype=torch.int32)),
        "dim": lambda: FI.batch_inverse(torch.zeros((30, 4, 4), dtype=torch.int32)),
        "dtype": lambda: FI.fp_inv(z.long()),
        "device": lambda: FI.scan_up(z.to("meta"), 4),
        "g": lambda: FI.scan_up(z, 3),
        "inv_total": lambda: FI.scan_down(z, pre, total[:, :2], 4),
        "pre": lambda: FI.scan_down(z, pre[:2], total, 4),
        "limb_rows": lambda: FI.fp_inv_limbs(z),
        "limb_dtype": lambda: FI.fp_inv_limbs(torch.zeros((24, 4), dtype=torch.int64)),
        "limb_device": lambda: FI.fp_inv_limbs(torch.zeros((24, 4), dtype=torch.int32,
                                                           device="meta")),
    }[bad]
    with pytest.raises(ValueError):
        call()


def test_kernel_path_raises_without_the_toolkit():
    """A kernel launch never falls back: without nvcc (and so without a
    card) the launch raises and counts nothing."""
    if torch.cuda.is_available() or shutil.which("nvcc"):
        pytest.skip("checks the behaviour without the CUDA toolkit")
    for k in KERNELS:
        before = k.launches
        with pytest.raises(RuntimeError, match="nvcc"):
            k.launch(*([0] * len(k.argtypes)))
        assert k.launches == before
