"""The port's lazy tower (ops/tower_lazy.py) against the JAX package's
(ark_blst_tpu/ops/tower_lazy.py), digit for digit.

Inputs are made from a seed with numpy: field values ingested by the JAX
tower, whose lazy digits `tree_from_jax` carries to the port, and raw
mul-ready digit stacks with the extreme patterns. Off the TPU, JAX's
fp12_mul, fp12_sqr, fp12_mul_by_014_many and fp12_cyclotomic_sqr take the
unfused path, which is the spec of the port's K3/K4 plain versions. The
inversions (JAX's eager Fermat ladder is the slow lane) are held by value
against the oracle.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.oracle import field as OF

N = 6
F = LZ.F_BOUND


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def same(port, jax_tree):
    """Exact digit equality of a port tower value and a JAX one."""
    got, want = _leaves(port), _leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (g.shape, w.shape)
        assert (g.numpy().astype(np.int64) == w.astype(np.int64)).all()


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % OF.P for _ in range(n)]


def _fp2_vals(seed, n=N):
    rng = np.random.default_rng(seed)
    return list(zip(_ints(rng, n), _ints(rng, n)))


def _fp12_vals(seed, n=N):
    rng = np.random.default_rng(seed)
    return [tuple(tuple((c[0], c[1]) for c in zip(*[iter(_ints(rng, 6))] * 2))
                  for _ in range(2)) for _ in range(n)]


def lazy_fp2(seed):
    """(JAX lazy fp2, the same digits as port tensors)."""
    j = JTL.fp2_ingest(JCV.fp2_to_dev(_fp2_vals(seed)))
    return j, CV.tree_from_jax(j)


def lazy_fp6(seed):
    vals = [v[0] for v in _fp12_vals(seed)]
    j = JTL.fp6_ingest(JCV.fp6_to_dev(vals))
    return j, CV.tree_from_jax(j)


def lazy_fp12(seed):
    j = JTL.fp12_ingest(JCV.fp12_to_dev(_fp12_vals(seed)))
    return j, CV.tree_from_jax(j)


def digits(seed, bound=F, n=N):
    """(30, n) random digits in [-bound, bound], extreme patterns first."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-bound, bound + 1, (30, n)).astype(np.int32)
    d[:, 0], d[:, 1] = bound, -bound
    d[:, 2] = [bound if k % 2 else -bound for k in range(30)]
    return d


def test_constants_match():
    assert TL._R16_TO_R13_DIGITS == JTL._R16_TO_R13_DIGITS
    assert TL._R16_DIGITS == JTL._R16_DIGITS
    assert FI.P_MINUS_2_BITS == [int(b) for b in JTL._P_MINUS_2_BITS]
    assert (TL._BARRETT_S, TL._BARRETT_K, TL._BARRETT_HALF) == (
        JTL._BARRETT_S, JTL._BARRETT_K, JTL._BARRETT_HALF)
    for v in (0, 1, 2, OF.P - 1):
        assert TL._const_digits(v) == JTL._const_digits(v)


@pytest.mark.parametrize("bound", [F, 8191, 2**20])
def test_fold30_and_fp_ops(bound):
    a, b = digits(1, bound), digits(2, min(bound, 8191))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    same(TL.fold30(ta), JTL.fold30(ja))
    same(TL.fp_add(ta, tb), JTL.fp_add(ja, jb))
    same(TL.fp_sub(ta, tb), JTL.fp_sub(ja, jb))
    same(TL.fp_neg(ta), JTL.fp_neg(ja))
    for k in (2, 3, 4, 8):
        same(TL.fp_mul_small(tb, k), JTL.fp_mul_small(jb, k))


def test_fp_mul_many_and_fp_mul():
    xs = [digits(s) for s in (3, 4, 5, 6)]
    pairs_t = [(torch.from_numpy(xs[0]), torch.from_numpy(xs[1])),
               (torch.from_numpy(xs[2]), torch.from_numpy(xs[3]))]
    pairs_j = [(jnp.asarray(xs[0]), jnp.asarray(xs[1])), (jnp.asarray(xs[2]), jnp.asarray(xs[3]))]
    before = MM.KERNEL.launches
    same(tuple(TL.fp_mul_many(pairs_t)), tuple(JTL.fp_mul_many(pairs_j)))
    same(TL.fp_mul(*pairs_t[0]), JTL.fp_mul(*pairs_j[0]))
    assert MM.KERNEL.launches == before  # CPU tensors take the plain version


def test_ingest_egress_roundtrip():
    vals = _fp2_vals(7) + [(0, 0), (OF.P - 1, 1)]
    strict = JCV.fp2_to_dev(vals)
    port_strict = CV.tree_from_jax(strict)
    lz = TL.fp2_ingest(port_strict)
    same(lz, JTL.fp2_ingest(strict))
    out = TL.fp2_egress(lz)
    same(out, JTL.fp2_egress(JTL.fp2_ingest(strict)))
    assert CV.fp2_from_dev(out) == vals
    v12 = _fp12_vals(8)
    s12 = JCV.fp12_to_dev(v12)
    l12 = TL.fp12_ingest(CV.tree_from_jax(s12))
    same(l12, JTL.fp12_ingest(s12))
    assert CV.fp12_from_dev(TL.fp12_egress(l12)) == v12
    assert CV.fp12_from_dev(CV.fp12_to_dev(v12)) == v12
    q = (_fp2_vals(9, 1)[0], _fp2_vals(10, 1)[0])  # any fp2 pair: the codec does no curve check
    assert CV.g2_from_dev(CV.g2_to_dev([None, q])) == [None, q]
    v6 = [v[1] for v in v12]
    l6 = TL.fp6_ingest(CV.fp6_to_dev(v6))
    same(TL.fp6_egress(l6), JTL.fp6_egress(JTL.fp6_ingest(JCV.fp6_to_dev(v6))))


@pytest.mark.parametrize("op", ["add", "sub", "neg", "conj", "mul_small", "nonresidue",
                                "mul", "mul_many", "sqr", "sqr_many"])
def test_fp2_ops(op):
    (ja, ta), (jb, tb) = lazy_fp2(10), lazy_fp2(11)
    (jc, tc), (jd, td) = lazy_fp2(12), lazy_fp2(13)
    got, want = {
        "add": lambda: (TL.fp2_add(ta, tb), JTL.fp2_add(ja, jb)),
        "sub": lambda: (TL.fp2_sub(ta, tb), JTL.fp2_sub(ja, jb)),
        "neg": lambda: (TL.fp2_neg(ta), JTL.fp2_neg(ja)),
        "conj": lambda: (TL.fp2_conj(ta), JTL.fp2_conj(ja)),
        "mul_small": lambda: (TL.fp2_mul_small(ta, 8), JTL.fp2_mul_small(ja, 8)),
        "nonresidue": lambda: (TL.fp2_mul_by_nonresidue(ta), JTL.fp2_mul_by_nonresidue(ja)),
        "mul": lambda: (TL.fp2_mul(ta, tb), JTL.fp2_mul(ja, jb)),
        "mul_many": lambda: (tuple(TL.fp2_mul_many([(ta, tb), (tc, td)])),
                             tuple(JTL.fp2_mul_many([(ja, jb), (jc, jd)]))),
        "sqr": lambda: (TL.fp2_sqr(ta), JTL.fp2_sqr(ja)),
        "sqr_many": lambda: (tuple(TL.fp2_sqr_many([ta, tb, tc])),
                             tuple(JTL.fp2_sqr_many([ja, jb, jc]))),
    }[op]()
    same(got, want)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "nonresidue", "mul", "mul_many"])
def test_fp6_ops(op):
    (ja, ta), (jb, tb) = lazy_fp6(20), lazy_fp6(21)
    got, want = {
        "add": lambda: (TL.fp6_add(ta, tb), JTL.fp6_add(ja, jb)),
        "sub": lambda: (TL.fp6_sub(ta, tb), JTL.fp6_sub(ja, jb)),
        "neg": lambda: (TL.fp6_neg(ta), JTL.fp6_neg(ja)),
        "nonresidue": lambda: (TL.fp6_mul_by_nonresidue(ta), JTL.fp6_mul_by_nonresidue(ja)),
        "mul": lambda: (TL.fp6_mul(ta, tb), JTL.fp6_mul(ja, jb)),
        "mul_many": lambda: (tuple(TL.fp6_mul_many([(ta, tb), (tb, ta)])),
                             tuple(JTL.fp6_mul_many([(ja, jb), (jb, ja)]))),
    }[op]()
    same(got, want)


@pytest.mark.parametrize("op", ["conj", "mul_many", "mul", "sqr", "mul_by_014"])
def test_fp12_ops(op):
    (ja, ta), (jb, tb) = lazy_fp12(30), lazy_fp12(31)
    (j0, t0), (j1, t1), (j4, t4) = lazy_fp2(32), lazy_fp2(33), lazy_fp2(34)
    before = K4.KERNEL.launches
    got, want = {
        "conj": lambda: (TL.fp12_conj(ta), JTL.fp12_conj(ja)),
        "mul_many": lambda: (TL.fp12_mul_many([(ta, tb)])[0], JTL.fp12_mul_many([(ja, jb)])[0]),
        "mul": lambda: (TL.fp12_mul(ta, tb), JTL.fp12_mul(ja, jb)),
        "sqr": lambda: (TL.fp12_sqr(ta), JTL.fp12_sqr(ja)),
        "mul_by_014": lambda: (TL.fp12_mul_by_014_many([(ta, t0, t1, t4)])[0],
                               JTL.fp12_mul_by_014_many([(ja, j0, j1, j4)])[0]),
    }[op]()
    same(got, want)
    assert K4.KERNEL.launches == before


def test_fp12_mul_wrapper_on_raw_digits():
    """K4's plain version on mul-ready digits with the extreme patterns, not
    only on ingested values."""
    a = np.stack([digits(40 + c) for c in range(12)])
    b = np.stack([digits(60 + c, 8191) for c in range(12)])
    got = K4.fp12_mul(torch.from_numpy(a), torch.from_numpy(b))
    want = JTL.fp12_mul(JTL._pack12([jnp.asarray(x) for x in a]),
                        JTL._pack12([jnp.asarray(x) for x in b]))
    same(TL.unstack12(got), want)


def test_fp12_one_and_stacking():
    _, ta = lazy_fp12(50)
    one = TL.fp12_one(ta[0][0][0])
    same(one, JTL.fp12_one((N,)))
    assert torch.equal(TL.stack12(TL.unstack12(TL.stack12(ta))), TL.stack12(ta))
    mask = torch.tensor([True, False] * (N // 2))
    sel = TL.select(mask, one, ta)
    same(sel, JTL.select(jnp.asarray(mask.numpy()), JTL.fp12_one((N,)), lazy_fp12(50)[0]))


@pytest.mark.parametrize("power", [1, 2, 3, 6])
def test_fp12_frobenius(power):
    ja, ta = lazy_fp12(70)
    same(TL.fp12_frobenius(ta, power), JTL.fp12_frobenius(ja, power))


def test_contract_many():
    elems = [digits(80 + k, bound) for k, bound in enumerate((F, 8191, 2 * F))]
    got = TL._contract_many([torch.from_numpy(x) for x in elems])
    same(tuple(got), tuple(JTL._contract_many([jnp.asarray(x) for x in elems])))
    for x, g in zip(elems, got):  # the same residue, magnitude below 0.58p
        for vx, vg in zip(LZ.digits_to_ints(torch.from_numpy(x)), LZ.digits_to_ints(g)):
            assert (vx - vg) % OF.P == 0 or LZ.digits_to_int(x[:, 0]) >= 1 << 389
            assert abs(vg) < 0.6 * OF.P


def test_cyclotomic_sqr():
    ja, ta = lazy_fp12(90)
    core = TL._cyc_sqr_core(ta)
    same(core, JTL._cyc_sqr_core(ja))
    before = K3.KERNEL.launches
    same(TL.fp12_cyclotomic_sqr(ta), JTL.fp12_cyclotomic_sqr(ja))
    assert K3.KERNEL.launches == before
    raw = np.stack([digits(100 + c, 8191) for c in range(12)])
    same(K3.cyc_sqr_plain(torch.from_numpy(raw), 1),
         JTL._flat12(JTL._cyc_sqr_core(JTL._pack12([jnp.asarray(x) for x in raw]))))


def _by_value(port_fp12):
    return CV.fp12_from_dev(TL.fp12_egress(port_fp12))


def test_inversions_by_value():
    """fp_inv, fp2_inv, fp6_inv and fp12_inv (the Fermat ladder) against the
    oracle's inverses."""
    vals = _fp12_vals(110, n=2)
    lz = TL.fp12_ingest(CV.fp12_to_dev(vals))
    assert _by_value(TL.fp12_inv(lz)) == [OF.fp12_inv(v) for v in vals]
    f6 = TL.fp6_inv(lz[1])
    assert CV.fp6_from_dev(TL.fp6_egress(f6)) == [OF.fp6_inv(v[1]) for v in vals]
    f2 = TL.fp2_inv(lz[0][1])
    assert CV.fp2_from_dev(TL.fp2_egress(f2)) == [OF.fp2_inv(v[0][1]) for v in vals]
    f1 = TL.fp_inv(lz[0][0][0])
    assert CV.fp_from_dev(TL.fp_egress(f1)) == [OF.fp_inv(v[0][0][0]) for v in vals]


def test_fp12_mul_and_sqr_by_value():
    a, b = _fp12_vals(120, n=3), _fp12_vals(121, n=3)
    la, lb = TL.fp12_ingest(CV.fp12_to_dev(a)), TL.fp12_ingest(CV.fp12_to_dev(b))
    assert _by_value(TL.fp12_mul(la, lb)) == [OF.fp12_mul(x, y) for x, y in zip(a, b)]
    assert _by_value(TL.fp12_sqr(la)) == [OF.fp12_sqr(x) for x in a]
    assert _by_value(TL.fp12_frobenius(la, 1)) == [OF.fp12_frobenius(x, 1) for x in a]
