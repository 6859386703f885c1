"""The port's multi-device entries (`ark_blst_tpu_torch/distributed.py` and
the sharded MSMs) on worlds of gloo ranks on the CPU, against the JAX
package's oracle.

Every world runs as child processes (`tests/torch_world.py`), never in the
pytest worker: each child imports no JAX and hands canonical ints back
under a hard timeout of 120 s, after which every child is killed. The
parent makes the inputs and compares with `ark_blst_tpu.oracle`. The bucket
MSMs truncate their windows (`max_windows`, the JAX package's option) over
scalars below 2^(c*(max_windows-1)), as `tests/test_sharded2.py` does: the
plain reduce over all 64 windows of c = 4 would take ~40 s a rank on one
core.
"""

import os
import random
import types

import pytest
import torch

from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu.oracle import field as JOF
from ark_blst_tpu_torch import distributed as D
from ark_blst_tpu_torch.config import plan_msm
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.curves.group import G1
from ark_blst_tpu_torch.ops import convert as CV
from torch_world import run_world


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among the pytest-xdist workers while the module's
    in-process MSMs run (the children take one thread each)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _points(curve: str, n: int, distinct: int, rng):
    gen, mul = (JOF.G2_GEN, JOC.g2_mul) if curve == "g2" else (JOF.G1_GEN, JOC.g1_mul)
    base = [mul(gen, rng.randrange(1, JOF.R)) for _ in range(distinct)]
    return [base[i % distinct] for i in range(n)]


def _oracle_msm(curve: str, pts, scs):
    return JOC.msm(JOC.FP2_OPS if curve == "g2" else JOC.FP_OPS, pts, scs)


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _stand_in_mesh(size: int):
    """What the sharded entries read of a mesh before any collective."""
    return types.SimpleNamespace(shape={"data": size}, rank=0, size=size,
                                 device=torch.device("cpu"), sharing=1)


def test_world_of_one_msm_distributed(tmp_path):
    """The twin of `tests/test_distributed.py::test_distributed_cluster_msm`:
    `initialize` twice, a mesh of one, `msm_distributed` on its default
    CPU backend (the scan MSM) at c = 4 with 2 lanes; the gather runs even
    in a world of one."""
    rng = random.Random(5)
    pts = [JOC.g1_mul(JOF.G1_GEN, rng.randrange(1, JOF.R)) for _ in range(32)]
    scs = [rng.randrange(JOF.R) for _ in range(32)]
    (res,) = run_world("msm_distributed", {"curve": "g1", "points": pts, "scalars": scs,
                                           "c": 4, "lanes": 2}, 1, tmp_path)
    assert res["mesh"] == {"size": 1, "rank": 0, "backend": "gloo", "sharing": 1, "gathers": 1}
    assert _tuples(res["point"]) == (_oracle_msm("g1", pts, scs),)


@pytest.mark.parametrize("curve, n, c, max_windows", [("g1", 3000, 4, 4), ("g2", 1500, 3, 5)])
def test_msm_sharded2_two_ranks(tmp_path, curve, n, c, max_windows):
    """The bucket MSM sharded over two ranks (n not a multiple of 2048 x 2:
    padded; an identity point and a zero scalar in the stream) equals the
    oracle on both ranks, and the port's unsharded chunked MSM
    (`msm_bucket.msm`, what `msm_g1`/`msm_g2` run) at the same windows."""
    rng = random.Random(11 + c)
    pts = _points(curve, n, 16, rng)
    scs = [rng.randrange(1 << (c * (max_windows - 1))) for _ in range(n)]
    pts[7], scs[9] = None, 0
    res = run_world("msm_sharded2", {"curve": curve, "points": pts, "scalars": scs, "c": c,
                                     "max_windows": max_windows}, 2, tmp_path)
    want = (_oracle_msm(curve, pts, scs),)
    assert [_tuples(r["point"]) for r in res] == [want, want]
    assert [r["mesh"]["gathers"] for r in res] == [1, 1]
    kc = MB.KC2_G2 if curve == "g2" else MB.KC2_G1
    to_dev = CV.g2_to_dev if curve == "g2" else CV.g1_to_dev
    from_dev = CV.g2_from_dev if curve == "g2" else CV.g1_from_dev
    unsharded = MB.msm(to_dev(pts), CV.fr_to_dev(scs), kc, c, max_windows=max_windows)
    assert tuple(from_dev(unsharded)) == want


def test_msm_sharded_two_ranks_both_finishes(tmp_path):
    """The twin of `tests/test_msm.py::test_msm_sharded_8dev` on two ranks:
    the scan MSM at c = 4, 2 lanes, with the Horner tail on the device and
    on host ints, full-width scalars."""
    rng = random.Random(21)
    pts = [JOC.g1_mul(JOF.G1_GEN, rng.randrange(1, JOF.R)) for _ in range(32)]
    scs = [rng.randrange(JOF.R) for _ in range(32)]
    res = run_world("msm_sharded", {"curve": "g1", "points": pts, "scalars": scs, "c": 4,
                                    "lanes": 2}, 2, tmp_path)
    want = (_oracle_msm("g1", pts, scs),)
    for r in res:
        assert _tuples(r["device"]) == want
        assert _tuples(r["host"]) == want
        assert r["mesh"]["gathers"] == 2


def test_msm_sharded2_zero_points_is_identity():
    out = MB.msm_sharded2(CV.g1_to_dev([]), CV.fr_to_dev([]), _stand_in_mesh(2), MB.KC2_G1, c=4)
    assert CV.g1_from_dev(out) == [None]


def test_msm_auto_on_the_cpu_takes_the_planned_scan(monkeypatch):
    """Off the card `msm_auto` runs JAX's off-TPU branch: the scan MSM at
    `plan_msm`'s (c, lanes) for the budget, after one abort poll."""
    seen = []
    scan = M.msm

    def spy(points, scalars, curve, c, lanes, *, device):
        seen.append((c, lanes))
        return scan(points, scalars, curve, c, lanes, device=device)

    monkeypatch.setattr(M, "msm", spy)
    rng = random.Random(23)
    n = 10
    pts = [JOC.g1_mul(JOF.G1_GEN, rng.randrange(1, JOF.R)) for _ in range(n)]
    scs = [rng.randrange(JOF.R) for _ in range(n)]
    pts[2], scs[4] = None, 0
    polls = []
    out = M.msm_auto(CV.g1_to_dev(pts), CV.fr_to_dev(scs), G1, 6 << 30,
                     maybe_abort=lambda: polls.append(1) and False, device="cpu")
    plan = plan_msm(n, 6 << 30, coords=3, limbs=24)
    assert seen == [(plan.c, plan.lanes)] and len(polls) == 1
    assert CV.g1_from_dev(out) == [_oracle_msm("g1", pts, scs)]


def test_msm_auto_abort_raises_before_dispatch(monkeypatch):
    monkeypatch.setattr(M, "msm", lambda *a, **k: pytest.fail("dispatched after an abort"))
    with pytest.raises(M.MsmAborted, match="before dispatch"):
        M.msm_auto(CV.g1_to_dev([JOF.G1_GEN]), CV.fr_to_dev([3]), G1,
                   maybe_abort=lambda: True, device="cpu")


def test_global_mesh_needs_initialize():
    with pytest.raises(RuntimeError, match="initialize"):
        D.global_mesh()


def test_msm_distributed_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        D.msm_distributed(CV.g1_to_dev([JOF.G1_GEN]), CV.fr_to_dev([3]),
                          mesh=_stand_in_mesh(1), backend="xla")


def test_sharded_entries_read_the_named_axis():
    with pytest.raises(KeyError):
        M.msm_sharded(CV.g1_to_dev([JOF.G1_GEN]), CV.fr_to_dev([3]), _stand_in_mesh(1), G1,
                      axis="model")


@pytest.mark.slow
def test_msm_sharded2_two_ranks_equals_jax_sharded2(tmp_path):
    """The two-rank bucket MSM against JAX `msm_sharded2` on a 2-device
    virtual mesh (the interpret-mode kernel; minutes on the CPU), at the
    inputs of `tests/test_sharded2.py::test_msm_sharded2_deeper_windows_matches_oracle`:
    its module rng replayed through the test before it."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from ark_blst_tpu.curves import msm_pallas2 as MP2
    from ark_blst_tpu.curves.group import G1 as JG1
    from ark_blst_tpu.ops import convert as JCV

    rng = random.Random(31337)
    for _ in range(20):  # test_msm_sharded2_matches_oracle's draws
        rng.randrange(1, JOF.R)
    for _ in range(20):
        rng.randrange(1 << 4)
    pts = [JOC.g1_mul(JOF.G1_GEN, rng.randrange(1, JOF.R)) for _ in range(24)]
    pts[5] = None
    scs = [rng.randrange(1 << 12) for _ in range(24)]
    MP2.INTERPRET = True
    try:
        mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
        want = JCV.g1_from_dev(MP2.msm_sharded2(JCV.g1_to_dev(pts), JCV.fr_to_dev(scs), mesh,
                                                curve=JG1, c=4, max_windows=4))
    finally:
        MP2.INTERPRET = False
    assert want == [_oracle_msm("g1", pts, scs)]
    res = run_world("msm_sharded2", {"curve": "g1", "points": pts, "scalars": scs, "c": 4,
                                     "max_windows": 4}, 2, tmp_path)
    assert [_tuples(r["point"]) for r in res] == [tuple(want)] * 2
