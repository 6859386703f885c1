"""The strict group's scalar multiplication on the CPU against the JAX
package, limb for limb: `CurveOps.scalar_mul` (on CPU tensors the plain
double-and-add loop of `ops/scan_msm.py:scalar_mul_plain`, the plain
version of scan-mul) against JAX `curves/group.py` `scalar_mul` (its
`lax.scan`) on G1 at 256 bits and on G2 at 32 bits, and
`curves/msm.py:msm_naive` (the ladder at 256 bits, then a log fold)
against JAX `msm_naive` at 8 G1 points. G2 at 256 bits would take ~3
minutes on the CPU (the port's plain G2 ladder ~0.5 s a bit, JAX's scan
~2 minutes); each of its steps is the step held here at 32 bits, and the
card holds scan-mul to this plain loop at 256 bits. The points are the
oracle's multiples of the generators and the scalars random, both drawn
from a numpy seed, with an identity point and the scalars 0, 1 and
2^256 - 1. Exact: the two compute the same expressions on canonical
values, so every limb agrees.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import group as JG
from ark_blst_tpu.curves import msm as JM
from ark_blst_tpu_torch.curves import group as G
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops.limbs import ints_to_limbs
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


# name: port curve, JAX curve, point codec, oracle scalar mul, generator
CURVES = {"g1": (G.G1, JG.G1, CV.g1_to_dev, OC.scalar_mul, OF.G1_GEN),
          "g2": (G.G2, JG.G2, CV.g2_to_dev, OC.g2_mul, OF.G2_GEN)}
EDGE_SCALARS = (0, 1, (1 << 256) - 1)  # 2^256 - 1: every limb 0xFFFF, not reduced


def instance(name: str, n: int, seed: int):
    """n points (point 1 the identity) and (16, n) scalar limbs, the first
    scalars 0, 1 and 2^256 - 1, from a numpy seed."""
    _, _, to_dev, mul, gen = CURVES[name]
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(32), "little") for _ in range(2 * n)]
    pts = [mul(gen, k % (OF.R - 1) + 1) for k in ints[:n]]
    pts[1] = None
    ks = list(EDGE_SCALARS) + ints[n + len(EDGE_SCALARS):]
    return to_dev(pts), torch.from_numpy(ints_to_limbs(ks, 16).T.copy())


def to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [np.asarray(tree).astype(np.int64)]


def assert_same(got, want) -> None:
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("name,bits", [("g1", 256), ("g2", 32)])
def test_scalar_mul_matches_jax(name, bits):
    """4 points: the port's ladder against JAX `scalar_mul` limb for limb."""
    port, jax_curve = CURVES[name][:2]
    points, scalars = instance(name, 4, 11 if name == "g1" else 12)
    got = port.scalar_mul(points, scalars, num_bits=bits)
    want = jax_curve.scalar_mul(to_jax(points), to_jax(scalars), num_bits=bits)
    assert_same(got, want)


def test_msm_naive_matches_jax():
    """8 G1 points: the port's `msm_naive` on the CPU against JAX
    `msm_naive` limb for limb, batch (1,)."""
    points, scalars = instance("g1", 8, 13)
    got = M.msm_naive(points, scalars, G.G1, device="cpu")
    want = JM.msm_naive(to_jax(points), to_jax(scalars), JG.G1)
    assert_same(got, want)
    assert got[0].shape == (24, 1)
