"""The port's MSM planner (`ark_blst_tpu_torch/config.py`) against the JAX
package's (`ark_blst_tpu/config.py`): the same plan and the same value of
every `MsmPlan` property over a grid of sizes, budgets and limb counts,
and the same refusals (JAX asserts, the port raises ValueError)."""

import dataclasses

import pytest

from ark_blst_tpu import config as JC
from ark_blst_tpu_torch import config as C

_PROPS = ("windows", "buckets", "bucket_bytes", "est_adds", "steps")


@pytest.mark.parametrize("limbs", [24, 48])
@pytest.mark.parametrize("budget", [1 << 20, 64 << 20, 6 << 30], ids=["1MiB", "64MiB", "6GiB"])
@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 20, 1 << 24])
def test_plan_msm_equals_jax(n, budget, limbs):
    try:
        want = JC.plan_msm(n, budget, coords=3, limbs=limbs)
    except AssertionError:  # no plan fits: the port refuses too
        with pytest.raises(ValueError, match="no plan fits"):
            C.plan_msm(n, budget, coords=3, limbs=limbs)
        return
    got = C.plan_msm(n, budget, coords=3, limbs=limbs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [getattr(got, k) for k in _PROPS] == [getattr(want, k) for k in _PROPS]
    assert got.bucket_bytes <= budget


def test_the_grid_holds_plans_and_refusals():
    """1 MiB is below the smallest plan (c = 4, 8 lanes: 2.25 MiB of G1
    buckets), so the grid above covers both outcomes."""
    smallest = C.MsmPlan(n=1, c=4, lanes=8, coords=3, limbs=24)
    assert smallest.bucket_bytes > 1 << 20
    assert C.plan_msm(1000, 6 << 30).c == JC.plan_msm(1000, 6 << 30).c


def test_plan_msm_refuses_no_points_like_jax():
    with pytest.raises(AssertionError):
        JC.plan_msm(0)
    with pytest.raises(ValueError, match="n >= 1"):
        C.plan_msm(0)


@pytest.mark.parametrize("fields", [{}, {"shape": (4,), "axis_names": ("x",)}])
def test_mesh_config_equals_jax(fields):
    assert dataclasses.asdict(C.MeshConfig(**fields)) == dataclasses.asdict(JC.MeshConfig(**fields))
