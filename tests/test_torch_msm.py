"""The port's G1 MSM (curves/msm.py, curves/msm_bucket.py and the public
entry points) against the JAX package: window digits and the prepare stage
digit for digit, the whole slice by value against the host oracle."""

import os
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ark_blst_tpu_torch as T
from ark_blst_tpu.curves import msm as JM
from ark_blst_tpu.curves import msm_pallas2 as MP2
from ark_blst_tpu.curves.group import G1 as JG1
from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops.limbs import FR, ints_to_limbs
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle.field import G1_GEN, P, R


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


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1, R - 1, (1 << 255) - 1]
    vals += [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n - len(vals))]
    return vals, ints_to_limbs(vals, FR.num_limbs).T.copy()  # (16, n) int32


@pytest.mark.parametrize("c", [2, 3, 4, 7, 13, 15])
def test_window_digits_signed_matches_jax(c):
    _, limbs = _scalars(64, c)
    got = M.window_digits_signed(torch.from_numpy(limbs), c)
    want = np.asarray(JM.window_digits_signed(jnp.asarray(limbs.astype(np.uint32)), c))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("c", [1, 5, 16])
def test_window_digits_matches_jax(c):
    rng = np.random.default_rng(c)
    limbs = rng.integers(0, 1 << 16, (16, 64)).astype(np.int32)  # full 256-bit values
    got = M.window_digits(torch.from_numpy(limbs), c)
    want = np.asarray(JM.window_digits(jnp.asarray(limbs.astype(np.uint32)), c))
    assert (got.numpy() == want).all()


def test_signed_digits_reconstruct_the_scalar():
    vals, limbs = _scalars(32, 9)
    c = 7
    d = M.window_digits_signed(torch.from_numpy(limbs), c).numpy()
    mag, sign = d & 0x7FFF, d >> 15
    for i, v in enumerate(vals):
        assert sum(int(m) * (-1 if s else 1) << (c * j)
                   for j, (m, s) in enumerate(zip(mag[:, i], sign[:, i]))) == v


def _projective_instance(n, seed):
    """n strict projective points (x*l, y*l, l) with random l, a few of
    them the identity, from 16 distinct oracle bases."""
    rng = random.Random(seed)
    base = [OC.scalar_mul(G1_GEN, rng.randrange(1, R)) for _ in range(16)]
    xs, ys, zs, aff = [], [], [], []
    for i in range(n):
        if i % 97 == 5:
            xs.append(0), ys.append(1), zs.append(0), aff.append(None)
            continue
        b = base[i % 16]
        lam = rng.randrange(1, P)
        xs.append(b[0] * lam % P), ys.append(b[1] * lam % P), zs.append(lam)
        aff.append(b)
    return (CV.fp_to_dev(xs), CV.fp_to_dev(ys), CV.fp_to_dev(zs)), aff


def test_prepare_matches_jax():
    n, c = 1024, 4
    points, aff = _projective_instance(n, 11)
    _, scalars = _scalars(n, 12)
    pts, digs = MB._prepare_inputs(MB.KC2_G1, points, torch.from_numpy(scalars), c)
    jpts, jdigs = MP2._prepare_inputs.__wrapped__(
        tuple(jnp.asarray(x.numpy().astype(np.uint32)) for x in points),
        jnp.asarray(scalars.astype(np.uint32)), curve=JG1, c=c)
    # digits: exact
    assert torch.equal(digs, CV.from_jax(np.asarray(jdigs)))
    # points: by value (the JAX CPU path inverts on host ints, the port
    # through the device batch inversion; same values, other digits)
    jp = CV.from_jax(np.asarray(jpts))
    assert pts.shape == jp.shape == (30, n)
    for rows_p, rows_j in ((pts[:15], jp[:15]), (pts[15:], jp[15:])):
        a = LZ.canonicalize(MB.unpack15(rows_p))
        b = LZ.canonicalize(MB.unpack15(rows_j))
        assert torch.equal(a, b)
    # and the affine values themselves (R13 domain)
    rinv = pow(LZ.R13, -1, P)
    xs = LZ.digits_to_ints(LZ.canonicalize(MB.unpack15(pts[:15])))
    for i in (0, 1, 6, 700):
        assert aff[i] is not None and xs[i] * rinv % P == aff[i][0]


def test_pack_unpack_roundtrip_and_layout():
    rng = np.random.default_rng(13)
    d = torch.from_numpy(rng.integers(-4129, 4129, (30, 40)).astype(np.int32))
    w = MB.pack30(d)
    assert w.shape == (15, 40) and int(w.min()) >= 0 and int(w.max()) < 1 << 31
    assert torch.equal(MB.unpack15(w), d)
    jw = np.stack([np.asarray(x) for x in MP2.pack30([jnp.asarray(r) for r in d.numpy()])])
    assert (w.numpy() == jw.astype(np.int64)).all()
    assert (MB.KC2_G1.identity_rows() == MP2.KC2_G1.identity_rows().astype(np.int64)).all()


def test_msm_slice_matches_oracle():
    """The slice end to end on the plain versions: full 255-bit scalars, the
    full window schedule, an identity point and a zero scalar in the stream."""
    rng = random.Random(21)
    n = 48
    pts = [OC.scalar_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scs = [rng.randrange(R) for _ in range(n)]
    pts[7], scs[19] = None, 0
    want = JOC.msm(JOC.FP_OPS, pts, scs)
    assert OC.msm(pts, scs) == want
    out = T.msm_g1(CV.g1_to_dev(pts), CV.fr_to_dev(scs), device="cpu", c=4)
    assert CV.g1_from_dev(out) == [want]


def test_msm_g1_stacked_entry_and_chunks():
    """msm_g1 on limb tensors across two chunks (the chunk loop and the
    cross-chunk window-sum addition)."""
    rng = random.Random(22)
    base = [OC.scalar_mul(G1_GEN, rng.randrange(1, R)) for _ in range(4)]
    n = 1500
    scs = [rng.randrange(1 << 8) for _ in range(n)]
    pts = [base[i % 4] for i in range(n)]
    agg = [sum(scs[i::4]) for i in range(4)]
    out = T.msm_g1(CV.g1_to_dev(pts), CV.fr_to_dev(scs), device="cpu", c=4, chunk=1024)
    assert all(x.shape == (24, 1) for x in out)
    assert CV.g1_from_dev(out) == [OC.msm(base, agg)]


def test_msm_edges():
    empty = tuple(torch.zeros((24, 0), dtype=torch.int32) for _ in range(3))
    out = T.msm_g1(empty, torch.zeros((16, 0), dtype=torch.int32), device="cpu")
    assert CV.g1_from_dev(out) == [None]
    pts, scs = CV.g1_to_dev([G1_GEN] * 3), CV.fr_to_dev([1, 2, 3])
    polls = []
    with pytest.raises(T.MsmAborted):
        T.msm_g1(pts, scs, device="cpu", maybe_abort=lambda: polls.append(1) or True)
    assert polls == [1]
    with pytest.raises(ValueError):
        T.msm_g1(pts, scs, device="cpu", c=1)
    with pytest.raises(ValueError):
        T.msm_g1(pts, scs, device="cpu", chunk=1000)
    with pytest.raises(ValueError):
        T.G1.msm([G1_GEN], [1, 2], device="cpu")


def test_plan_chunk2():
    for c in (4, 7):
        chunk = MB.plan_chunk2(MB.KC2_G1, c, 8 << 30)
        assert chunk % MB.STREAMS == 0 and chunk & (chunk - 1) == 0
    assert MB.plan_chunk2(MB.KC2_G1, 7, 80 << 30) > MB.plan_chunk2(MB.KC2_G1, 7, 8 << 30)
    assert MB.plan_chunk2(MB.KC2_G1, 7, 8 << 30) == MP2.plan_chunk2(MP2.KC2_G1, 7, 8 << 30)
    with pytest.raises(ValueError):
        MB.plan_chunk2(MB.KC2_G1, 7, 1 << 20)
