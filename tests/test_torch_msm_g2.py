"""The port's G2 MSM (curves/msm_bucket.py with `KC2_G2`, and the entry
points `msm_g2` / `G2.msm`) against the JAX package: the kernel codec and
the prepare stage digit for digit, the chunk planner, and the whole slice
by value against the JAX package's host oracle."""

import os
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ark_blst_tpu_torch as T
from ark_blst_tpu.curves import msm_pallas2 as MP2
from ark_blst_tpu.curves.group import G2 as JG2
from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops.limbs import FR, ints_to_limbs
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

KC = MB.KC2_G2


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


def _g2_points(rng, n):
    return [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(n)]


def test_kc2_g2_codec_matches_jax():
    rng = np.random.default_rng(41)
    d = rng.integers(-4129, 4129, (6, 30, 8)).astype(np.int32)
    d[:, :, 0] = 4128
    d[:, :, 1] = -4129
    pt = KC.nest([torch.from_numpy(x) for x in d])
    jpt = KC.nest([[jnp.asarray(r) for r in x] for x in d])
    rows = KC.point_to_rows(pt)
    jrows = np.stack([np.asarray(r) for r in MP2.KC2_G2.point_to_rows(jpt)])
    assert rows.shape == (90, 8) and (rows.numpy() == jrows.astype(np.int64)).all()
    back = KC.rows_to_point(rows)
    jback = MP2.KC2_G2.rows_to_point([jnp.asarray(r.astype(np.uint32)) for r in jrows])
    for comp, jcomp in zip(KC.components(back), KC.components(jback)):
        assert (comp.numpy() == np.stack([np.asarray(x) for x in jcomp])).all()
    assert (KC.identity_rows() == MP2.KC2_G2.identity_rows().astype(np.int64)).all()
    assert (KC.kernel, KC.coord_rows, KC.pt_rows, KC.aff_rows, KC.n_fp) == (
        MB.KERNEL_G2, MP2.KC2_G2.coord_rows, MP2.KC2_G2.pt_rows, MP2.KC2_G2.aff_rows,
        MP2.KC2_G2.n_fp)


def _projective_instance(n, seed):
    """n strict projective G2 points (x*l, y*l, l) with random Fp2 l, a few
    of them the identity, from 8 distinct oracle bases."""
    rng = random.Random(seed)
    base = _g2_points(rng, 8)
    xs, ys, zs, aff = [], [], [], []
    for i in range(n):
        if i % 97 == 5:
            xs.append(OF.FP2_ZERO), ys.append(OF.FP2_ONE), zs.append(OF.FP2_ZERO)
            aff.append(None)
            continue
        b = base[i % 8]
        lam = (rng.randrange(OF.P), rng.randrange(1, OF.P))
        xs.append(OF.fp2_mul(b[0], lam)), ys.append(OF.fp2_mul(b[1], lam)), zs.append(lam)
        aff.append(b)
    return (CV.fp2_to_dev(xs), CV.fp2_to_dev(ys), CV.fp2_to_dev(zs)), aff


def test_prepare_matches_jax():
    n, c = 1024, 4
    points, aff = _projective_instance(n, 11)
    vals = [random.Random(12).randrange(OF.R) for _ in range(n)]
    scalars = ints_to_limbs(vals, FR.num_limbs).T.copy()
    pts, digs = MB._prepare_inputs(KC, points, torch.from_numpy(scalars), c)
    jpts, jdigs = MP2._prepare_inputs.__wrapped__(
        tuple(tuple(jnp.asarray(x.numpy().astype(np.uint32)) for x in coord) for coord in points),
        jnp.asarray(scalars.astype(np.uint32)), curve=JG2, c=c)
    # digits: exact
    assert torch.equal(digs, CV.from_jax(np.asarray(jdigs)))
    # points: by value (the JAX CPU path inverts on host ints, the port
    # through the device batch inversion; same values, other digits)
    jp = CV.from_jax(np.asarray(jpts))
    assert pts.shape == jp.shape == (60, n)
    for k in range(4):
        a = LZ.canonicalize(MB.unpack15(pts[15 * k : 15 * k + 15]))
        b = LZ.canonicalize(MB.unpack15(jp[15 * k : 15 * k + 15]))
        assert torch.equal(a, b)
    # and the affine values themselves (R13 domain)
    rinv = pow(LZ.R13, -1, OF.P)
    x, y = KC.rows_to_affine(pts)
    vals = [[v * rinv % OF.P for v in LZ.digits_to_ints(LZ.canonicalize(comp))]
            for comp in x + y]
    for i in (0, 1, 6, 700):
        assert aff[i] is not None
        assert ((vals[0][i], vals[1][i]), (vals[2][i], vals[3][i])) == aff[i]


@pytest.mark.parametrize("c", [5, 6])
def test_plan_chunk2_matches_jax(c):
    for budget in (8 << 30, 40 << 30):
        assert MB.plan_chunk2(KC, c, budget) == MP2.plan_chunk2(MP2.KC2_G2, c, budget)
    with pytest.raises(ValueError):
        MB.plan_chunk2(KC, c, 1 << 20)


def test_msm_g2_slice_matches_oracle():
    """The slice end to end on the plain versions: full 255-bit scalars, the
    full window schedule, an identity point and a zero scalar in the
    stream. A CPU run never reaches the kernel."""
    rng = random.Random(21)
    n = 12
    pts = _g2_points(rng, n)
    scs = [rng.randrange(OF.R) for _ in range(n)]
    scs[0] = OF.R - 1
    pts[7], scs[9] = None, 0
    want = JOC.msm(JOC.FP2_OPS, pts, scs)
    assert OC.g2_msm(pts, scs) == want
    before = MB.KERNEL_G2.launches
    out = T.msm_g2(CV.g2_to_dev(pts), CV.fr_to_dev(scs), device="cpu", c=3)
    assert MB.KERNEL_G2.launches == before
    assert all(x.shape == (24, 1) for coord in out for x in coord)
    assert CV.g2_from_dev(out) == [want]


def test_msm_g2_two_chunks():
    """Two chunks: the chunk loop and the cross-chunk window-sum addition."""
    rng = random.Random(22)
    base = _g2_points(rng, 4)
    n = 1500
    scs = [rng.randrange(1 << 8) for _ in range(n)]
    pts = [base[i % 4] for i in range(n)]
    agg = [sum(scs[i::4]) for i in range(4)]
    out = T.msm_g2(CV.g2_to_dev(pts), CV.fr_to_dev(scs), device="cpu", c=3, chunk=1024)
    assert CV.g2_from_dev(out) == [OC.g2_msm(base, agg)]


def test_msm_g2_edges():
    empty = tuple(tuple(torch.zeros((24, 0), dtype=torch.int32) for _ in range(2))
                  for _ in range(3))
    out = T.msm_g2(empty, torch.zeros((16, 0), dtype=torch.int32), device="cpu")
    assert CV.g2_from_dev(out) == [None]
    assert T.G2.msm([], [], device="cpu") is None
    pts, scs = CV.g2_to_dev([OF.G2_GEN] * 3), CV.fr_to_dev([1, 2, 3])
    polls = []
    with pytest.raises(T.MsmAborted):
        T.msm_g2(pts, scs, device="cpu", maybe_abort=lambda: polls.append(1) or True)
    assert polls == [1]
    with pytest.raises(ValueError):
        T.msm_g2(pts, scs, device="cpu", c=1)
    with pytest.raises(ValueError):
        T.msm_g2(pts, scs, device="cpu", chunk=1000)
    with pytest.raises(ValueError):
        T.msm_g2(CV.g1_to_dev([OF.G1_GEN] * 3), scs, device="cpu")
    with pytest.raises(ValueError):
        T.G2.msm([OF.G2_GEN], [1, 2], device="cpu")
