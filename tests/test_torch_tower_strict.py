"""The strict engine's fp6/fp12 tower (ops/tower.py) against the JAX
package's (ark_blst_tpu/ops/tower.py), limb for limb.

Values are canonical in both engines, so every output must equal JAX's
limbs exactly (the tolerance is zero). Inputs are random field values made
from a seed with numpy, encoded by each package's own codec (Montgomery-R16
limbs), at batch 3; every port op runs its K7-K10 plain versions on the CPU.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower as JTS

from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops import tower as TS
from ark_blst_tpu_torch.oracle import field as OF

N = 3


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def same(port, jax_tree):
    """Exact limb equality of a port tower value and a JAX one."""
    got, want = _leaves(port), _leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (g.shape, w.shape)
        assert (g.numpy().astype(np.int64) == w.astype(np.int64)).all()


def _fp12_values(seed):
    rng = np.random.default_rng(seed)
    ints = iter([int.from_bytes(rng.bytes(48), "little") % OF.P for _ in range(12 * N)])
    return [tuple(tuple((next(ints), next(ints)) for _ in range(3)) for _ in range(2))
            for _ in range(N)]


def fp12(seed):
    """(JAX strict fp12, the port's) of the same random values."""
    vals = _fp12_values(seed)
    return JCV.fp12_to_dev(vals), CV.fp12_to_dev(vals)


def fp6(seed):
    vals = [v[0] for v in _fp12_values(seed)]
    return JCV.fp6_to_dev(vals), CV.fp6_to_dev(vals)


def fp2(seed):
    vals = [v[1][2] for v in _fp12_values(seed)]
    return JCV.fp2_to_dev(vals), CV.fp2_to_dev(vals)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "nonresidue", "mul", "mul_many", "sqr",
                                "mul_by_01_many", "mul_by_1_many", "inv", "eq"])
def test_fp6_ops(op):
    (ja, ta), (jb, tb) = fp6(1), fp6(2)
    (j0, t0), (j1, t1) = fp2(3), fp2(4)
    got, want = {
        "add": lambda: (TS.fp6_add(ta, tb), JTS.fp6_add(ja, jb)),
        "sub": lambda: (TS.fp6_sub(ta, tb), JTS.fp6_sub(ja, jb)),
        "neg": lambda: (TS.fp6_neg(ta), JTS.fp6_neg(ja)),
        "nonresidue": lambda: (TS.fp6_mul_by_nonresidue(ta), JTS.fp6_mul_by_nonresidue(ja)),
        "mul": lambda: (TS.fp6_mul(ta, tb), JTS.fp6_mul(ja, jb)),
        "mul_many": lambda: (TS.fp6_mul_many([(ta, tb), (tb, tb)]),
                             JTS.fp6_mul_many([(ja, jb), (jb, jb)])),
        "sqr": lambda: (TS.fp6_sqr(ta), JTS.fp6_sqr(ja)),
        "mul_by_01_many": lambda: (TS.fp6_mul_by_01_many([(ta, t0, t1), (tb, t1, t0)]),
                                   JTS.fp6_mul_by_01_many([(ja, j0, j1), (jb, j1, j0)])),
        "mul_by_1_many": lambda: (TS.fp6_mul_by_1_many([(ta, t1)]),
                                  JTS.fp6_mul_by_1_many([(ja, j1)])),
        "inv": lambda: (TS.fp6_inv(ta), JTS.fp6_inv(ja)),
        "eq": lambda: ((TS.fp6_eq(ta, ta), TS.fp6_eq(ta, tb)),
                       (JTS.fp6_eq(ja, ja), JTS.fp6_eq(ja, jb))),
    }[op]()
    same(got, want)


@pytest.mark.parametrize("op", ["add", "sub", "conj", "mul", "mul_many", "sqr", "inv",
                                "mul_by_014", "eq"])
def test_fp12_ops(op):
    (ja, ta), (jb, tb) = fp12(10), fp12(11)
    (j0, t0), (j1, t1), (j4, t4) = fp2(12), fp2(13), fp2(14)
    got, want = {
        "add": lambda: (TS.fp12_add(ta, tb), JTS.fp12_add(ja, jb)),
        "sub": lambda: (TS.fp12_sub(ta, tb), JTS.fp12_sub(ja, jb)),
        "conj": lambda: (TS.fp12_conj(ta), JTS.fp12_conj(ja)),
        "mul": lambda: (TS.fp12_mul(ta, tb), JTS.fp12_mul(ja, jb)),
        "mul_many": lambda: (TS.fp12_mul_many([(ta, tb), (tb, ta)]),
                             JTS.fp12_mul_many([(ja, jb), (jb, ja)])),
        "sqr": lambda: (TS.fp12_sqr(ta), JTS.fp12_sqr(ja)),
        "inv": lambda: (TS.fp12_inv(ta), JTS.fp12_inv(ja)),
        "mul_by_014": lambda: (TS.fp12_mul_by_014_many([(ta, t0, t1, t4), (tb, t4, t0, t1)]),
                               JTS.fp12_mul_by_014_many([(ja, j0, j1, j4), (jb, j4, j0, j1)])),
        "eq": lambda: ((TS.fp12_eq(ta, ta), TS.fp12_eq(ta, tb)),
                       (JTS.fp12_eq(ja, ja), JTS.fp12_eq(ja, jb))),
    }[op]()
    same(got, want)


def test_fp12_values_by_the_oracle():
    """The products, the square and the inverse are the oracle's, by value."""
    a, b = _fp12_values(20), _fp12_values(21)
    ta, tb = CV.fp12_to_dev(a), CV.fp12_to_dev(b)
    assert CV.fp12_from_dev(TS.fp12_mul(ta, tb)) == [OF.fp12_mul(x, y) for x, y in zip(a, b)]
    assert CV.fp12_from_dev(TS.fp12_sqr(ta)) == [OF.fp12_sqr(x) for x in a]
    assert CV.fp12_from_dev(TS.fp12_inv(ta)) == [OF.fp12_inv(x) for x in a]


def test_fp12_one_and_select():
    one = TS.fp12_one((N,), "cpu")
    same(one, JTS.fp12_one((N,)))
    assert CV.fp12_from_dev(one) == [OF.FP12_ONE] * N
    ja, ta = fp12(30)
    mask = np.array([True, False, True])
    same(TS.select(torch.from_numpy(mask), one, ta),
         JTS.select(jnp.asarray(mask), JTS.fp12_one((N,)), ja))


@pytest.mark.parametrize("power", [1, 2, 3, 6])
def test_fp12_frobenius(power):
    ja, ta = fp12(40)
    got = TS.fp12_frobenius(ta, power)
    same(got, JTS.fp12_frobenius(ja, power))
    same(TS.fp6_frobenius(ta[1], power), JTS.fp6_frobenius(ja[1], power))
    same(TS.fp2_frobenius(ta[0][1], power), JTS.fp2_frobenius(ja[0][1], power))
    want = _fp12_values(40)
    for _ in range(power):
        want = [OF.fp12_frobenius(v, 1) for v in want]
    assert CV.fp12_from_dev(got) == want


def test_cyclotomic_sqr():
    """On any input (the formula, as a function) and on a cyclotomic one,
    where it is the square by value."""
    ja, ta = fp12(50)
    same(TS.fp12_cyclotomic_sqr(ta), JTS.fp12_cyclotomic_sqr(ja))
    vals = _fp12_values(51)
    cyc = [OF.fp12_frobenius(OF.fp12_mul(OF.fp12_conj(v), OF.fp12_inv(v)), 2) for v in vals]
    cyc = [OF.fp12_mul(c, OF.fp12_mul(OF.fp12_conj(v), OF.fp12_inv(v))) for c, v in zip(cyc, vals)]
    got = TS.fp12_cyclotomic_sqr(CV.fp12_to_dev(cyc))
    assert CV.fp12_from_dev(got) == [OF.fp12_sqr(c) for c in cyc]


def test_strict_ops_launch_nothing_on_cpu():
    _, ta = fp12(60)
    before = {k: v.launches for k, v in SF.KERNELS.items()}
    TS.fp12_mul(ta, ta)
    assert {k: v.launches for k, v in SF.KERNELS.items()} == before
