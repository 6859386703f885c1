"""The port's complete group law on the strict engine (curves/group.py) against
the JAX package's `curves/group.py`, digit for digit, and against the oracle:
G1 and G2 `add`, `double`, `neg` and `eq` on one small batch with the edge
cases of tests/test_group.py (identity + P, P + identity, P + P, P + (-P));
`to_affine`, `batch_inv` (with a zero) and `scalar_mul` by value."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import group as JG
from ark_blst_tpu_torch.curves import group as G
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


# name: port curve, JAX curve, codecs, oracle add / double / neg / scalar mul
CURVES = {
    "g1": (G.G1, JG.G1, CV.g1_to_dev, CV.g1_from_dev, CV.fp_from_dev,
           OC.add, OC.double, OC.neg, OC.scalar_mul, OF.G1_GEN),
    "g2": (G.G2, JG.G2, CV.g2_to_dev, CV.g2_from_dev, CV.fp2_from_dev,
           OC.g2_add, OC.g2_double, OC.g2_neg, OC.g2_mul, OF.G2_GEN),
}


def to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [np.asarray(tree).astype(np.int64)]


def same(got, want) -> bool:
    g, w = leaves(got), leaves(want)
    return len(g) == len(w) and all(a.shape == b.shape and (a == b).all() for a, b in zip(g, w))


def edge_batch(curve: str, seed: int):
    """4 random points, then identity + P, P + identity, P + P, P + (-P)."""
    _, _, _, _, _, _, _, neg, mul, gen = CURVES[curve]
    rng = random.Random(seed)
    ps = [mul(gen, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [mul(gen, rng.randrange(1, OF.R)) for _ in range(4)]
    return ps + [None, ps[0], ps[1], ps[2]], qs + [qs[0], None, ps[1], neg(ps[2])]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_add_double_neg_eq_match_jax(curve):
    port, jcurve, to_dev, from_dev, _, add, double, neg, _, _ = CURVES[curve]
    ps, qs = edge_batch(curve, 1)
    dp, dq = to_dev(ps), to_dev(qs)
    jp, jq = to_jax(dp), to_jax(dq)
    got_add, got_dbl, got_neg = port.add(dp, dq), port.double(dp), port.neg(dp)
    assert same(got_add, jcurve.add(jp, jq))
    assert same(got_dbl, jcurve.double(jp))
    assert same(got_neg, jcurve.neg(jp))
    assert from_dev(got_add) == [add(p, q) for p, q in zip(ps, qs)]
    assert from_dev(got_dbl) == [double(p) for p in ps]
    assert from_dev(got_neg) == [neg(p) for p in ps]
    d1, d2 = port.add(dp, dp), got_dbl  # one point in two projective scales
    eq_same, eq_diff = port.eq(d1, d2), port.eq(dp, dq)
    assert eq_same.all() and eq_diff.tolist() == [p == q for p, q in zip(ps, qs)]
    assert (eq_same.numpy() == np.asarray(jcurve.eq(to_jax(d1), to_jax(d2)))).all()
    assert (eq_diff.numpy() == np.asarray(jcurve.eq(jp, jq))).all()
    assert port.is_identity(dp).tolist() == [p is None for p in ps]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_to_affine_and_batch_inv_match_oracle(curve):
    """One batch inversion (odd batch: padded tree) with a zero, and
    to_affine of points in a nontrivial projective scale, identity included."""
    port, _, to_dev, from_dev, comp_from_dev, _, double, _, mul, gen = CURVES[curve]
    rng = random.Random(2)
    pts = [mul(gen, rng.randrange(1, OF.R)) for _ in range(5)]
    pts[1] = None
    scaled = port.double(to_dev(pts))  # z != 1
    xa, ya, inf = port.to_affine(scaled)
    back = [None if i else (x, y) for x, y, i in
            zip(comp_from_dev(xa), comp_from_dev(ya), inf.tolist())]
    assert back == [None if p is None else double(p) for p in pts]
    if curve == "g1":
        vals = [rng.randrange(1, OF.P) for _ in range(5)]
        vals[2] = 0
        inv = CV.fp_from_dev(port.batch_inv(CV.fp_to_dev(vals)))
        assert inv == [0 if v == 0 else pow(v, -1, OF.P) for v in vals]
    else:
        vals = [(rng.randrange(OF.P), rng.randrange(OF.P)) for _ in range(5)]
        vals[2] = OF.FP2_ZERO
        inv = CV.fp2_from_dev(port.batch_inv(CV.fp2_to_dev(vals)))
        assert inv == [OF.FP2_ZERO if v == OF.FP2_ZERO else OF.fp2_inv(v) for v in vals]
    assert from_dev(port.from_affine(xa, ya, inf)) == [
        None if p is None else double(p) for p in pts]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scalar_mul_matches_oracle(curve):
    """Full 255-bit ladder on G1; on G2 (each step ~4x a G1 step on the CPU)
    64-bit scalars over a 64-bit ladder."""
    port, _, to_dev, from_dev, _, _, _, _, mul, gen = CURVES[curve]
    rng = random.Random(3)
    bits = 255 if curve == "g1" else 64
    top = OF.R if curve == "g1" else 1 << 64
    pts = [mul(gen, rng.randrange(1, OF.R)), gen, gen, None]
    ks = [rng.randrange(top), 0, 1, top - 1]
    got = from_dev(port.scalar_mul(to_dev(pts), CV.fr_to_dev(ks), num_bits=bits))
    assert got == [None if p is None else mul(p, k) for p, k in zip(pts, ks)]
