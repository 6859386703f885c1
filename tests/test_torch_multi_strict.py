"""The strict engine's fused multi-pairings (`curves/pairing.py`:
`multi_miller_loop`, `multi_miller_loop_prepared`, `multi_pairing`,
`multi_pairing_sharded` with `engine="strict", fuse=True`) and K4's
strict-limb edges (`ops/fp12_mul.py`, limbs -> limbs) on CPU tensors,
where every kernel wrapper runs its plain version.

K6-chain stores each pair's conj(f) as the strict (12, 24, N) limbs, the
identity mask selects on them, and the product fold runs on K4's limbs ->
limbs layout, one launch a level; the strict tower's `fp12_mul` (K7-K10
an op on the card) is not called. Strict limbs are canonical, so
everything is held exactly (tolerance: none): K4's plain version on limbs
against the strict tower's `fp12_mul` limb for limb, the fold against JAX
`_fold_mul` on the strict tower (`ark_blst_tpu/ops/tower.py`) at n = 1,
5 and 8, and the entries against the oracle's products with identity
pairs on both sides. K4 in this layout on the card:
tests/test_torch_cuda.py.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import tower as JTS

from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import tower as TS
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the torch threads among the pytest-xdist workers while the
    module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _fp12_vals(seed: int, n: int) -> list:
    """n random canonical fp12 values (numpy-seeded), one among them."""
    rng = np.random.default_rng(seed)
    ints = lambda k: [int.from_bytes(rng.bytes(48), "little") % OF.P for _ in range(k)]  # noqa: E731
    vals = [tuple(tuple(tuple(ints(2)) for _ in range(3)) for _ in range(2)) for _ in range(n)]
    vals[min(1, n - 1)] = OF.FP12_ONE
    return vals


def _limbs(vals) -> torch.Tensor:
    """fp12 values -> their strict (12, 24, n) limb stack."""
    return TL.stack12(CV.fp12_to_dev(vals))


def _to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(_to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def _jax_stack(tree) -> torch.Tensor:
    """A JAX strict fp12 (nested (24, n) leaves) -> its (12, 24, n) stack."""
    leaves = [x for c6 in tree for c2 in c6 for x in c2]
    return torch.stack([torch.from_numpy(np.asarray(x).astype(np.int64)) for x in leaves]).to(
        torch.int32)


@pytest.fixture
def k4_calls(monkeypatch):
    """Records each K4 call's operand rows and `out`."""
    calls = []
    fp12_mul = K4.fp12_mul

    def spy(a, b, out=None):
        calls.append((a.shape[1], out))
        return fp12_mul(a, b, out)

    monkeypatch.setattr(K4, "fp12_mul", spy)
    return calls


def test_k4_plain_on_limbs_matches_strict_tower():
    """K4 limbs -> limbs on CPU tensors (its plain version) against the
    strict tower's `fp12_mul` limb for limb, and the oracle's product."""
    a, b = _fp12_vals(3, 6), _fp12_vals(4, 6)
    got = K4.fp12_mul(_limbs(a), _limbs(b))
    assert got.shape == (12, 24, 6)
    assert torch.equal(got, K4.fp12_mul_plain(_limbs(a), _limbs(b), "limbs"))
    want = TL.stack12(TS.fp12_mul(CV.fp12_to_dev(a), CV.fp12_to_dev(b)))
    assert torch.equal(got, want)
    assert CV.fp12_from_dev(TL.unstack12(got)) == [OF.fp12_mul(x, y) for x, y in zip(a, b)]
    with pytest.raises(ValueError):
        K4.fp12_mul(_limbs(a), _limbs(b), out="words")


@pytest.mark.parametrize("n", [1, 5, 8])
def test_strict_fold_matches_jax_fold_mul(n, k4_calls):
    """`_fold_stack` on a strict limb stack against JAX `_fold_mul` on the
    strict tower limb for limb (padded with one at n = 5), and against the
    port's strict tower fold: ceil(log2 n) K4 launches, limbs in and out,
    none at n = 1."""
    vals = _fp12_vals(20 + n, n)
    got = PR._fold_stack(_limbs(vals), n)
    assert got.shape == (12, 24, 1)
    assert k4_calls == [(24, "limbs")] * (n - 1).bit_length()
    want = _jax_stack(DP._fold_mul(JTS, _to_jax(CV.fp12_to_dev(vals)), n))
    assert torch.equal(got, want)
    assert torch.equal(got, TL.stack12(PR._fold_mul(CV.fp12_to_dev(vals), n, "strict")))


class _WorldOfOne:
    """What `multi_pairing_sharded` reads of a mesh, one rank, its gather
    an added rank axis."""

    shape = {"data": 1}
    rank = 0
    device = torch.device("cpu")

    def __init__(self):
        self.gathers = 0

    def all_gather_tree(self, tree):
        self.gathers += 1
        return TS.tree_map(lambda x: x.unsqueeze(1), tree)


def test_strict_multi_pairings_fold_on_k4_limbs(k4_calls, monkeypatch):
    """The strict fused multi-pairings fold on K4's 24-row stacks, one call a
    level, and never reach the strict tower's `fp12_mul`: `multi_miller_loop`,
    `multi_miller_loop_prepared` and `multi_pairing` at N = 5 (an identity
    P and an identity Q) against the oracle's products, and
    `multi_pairing_sharded` in a world of one limb for limb against
    `multi_pairing`."""
    def boom(*args, **kwargs):
        raise AssertionError("the strict tower's fp12_mul ran")

    monkeypatch.setattr(TS, "fp12_mul", boom)
    monkeypatch.setattr(PR._FINAL_OPS["strict"], "mul", boom)
    rng = random.Random(21)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(5)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(5)]
    ps[1], qs[3] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(ps, "cpu"), B._g2_batch(qs, "cpu")
    want = OP.multi_miller_loop([(a, b) for a, b in zip(ps, qs) if a and b])
    levels = [(24, "limbs")] * 3
    got = PR.multi_miller_loop(p, q, p_inf, q_inf, engine="strict")
    assert CV.fp12_from_dev(got) == [want] and k4_calls == levels
    k4_calls.clear()
    prep = PR.prepare_g2_device(q, q_inf, engine="strict")
    assert prep.layout == "limbs"
    got = PR.multi_miller_loop_prepared(p, prep, p_inf)
    assert CV.fp12_from_dev(got) == [want] and k4_calls == levels
    k4_calls.clear()
    final = PR.multi_pairing(p, q, p_inf, q_inf, engine="strict")
    assert CV.fp12_from_dev(final) == [OP.final_exp(want)] and k4_calls == levels
    k4_calls.clear()
    mesh = _WorldOfOne()
    sharded = PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf,
                                       engine="strict")
    assert mesh.gathers == 1 and k4_calls == levels
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(sharded), flat(final)))
