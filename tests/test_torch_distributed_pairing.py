"""The port's sharded multi-pairing (`curves/pairing.py:multi_pairing_sharded`)
on two gloo ranks on the CPU, against the JAX package: the whole pairing
(68 events and the final exponentiation) against the oracle's product,
and the truncated Miller product against the JAX package's eager unsharded
twin. Each world runs as child processes (`tests/torch_world.py`) that
import no JAX, under a hard timeout of 120 s."""

import random
import types

import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL
from ark_blst_tpu.oracle import curve as JOC
from ark_blst_tpu.oracle import field as JOF
from ark_blst_tpu.oracle import pairing as JOP
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from torch_world import run_world


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _instance(seed: int, n: int):
    """n pairs of random points, the second P the identity."""
    rng = random.Random(seed)
    ps = [JOC.g1_mul(JOF.G1_GEN, rng.randrange(1, JOF.R)) for _ in range(n)]
    qs = [JOC.g2_mul(JOF.G2_GEN, rng.randrange(1, JOF.R)) for _ in range(n)]
    ps[1] = None
    return ps, qs


def test_multi_pairing_sharded_two_ranks_matches_oracle(tmp_path):
    """All 68 events and the final exponentiation, lazy and fused (the card's
    path, on the plain versions): both ranks equal the oracle's
    prod_i e(P_i, Q_i)."""
    ps, qs = _instance(41, 4)
    res = run_world("multi_pairing_sharded", {"ps": ps, "qs": qs, "events": None,
                                              "final": True}, 2, tmp_path)
    want = JOP.final_exp(JOP.multi_miller_loop(list(zip(ps, qs))))
    assert [_tuples(r["fp12"]) for r in res] == [(want,), (want,)]
    assert [r["mesh"]["gathers"] for r in res] == [1, 1]


def test_multi_pairing_sharded_truncated_matches_jax_eager_twin(tmp_path):
    """4 events, no final exponentiation, against the JAX package's eager
    unsharded truncated Miller product, computed as
    `tests/test_pairing.py::test_multi_pairing_sharded` computes it."""
    ps, qs = _instance(43, 4)
    events = 4
    res = run_world("multi_pairing_sharded", {"ps": ps, "qs": qs, "events": events,
                                              "final": False}, 2, tmp_path)
    pv = [JOF.G1_GEN if p is None else p for p in ps]
    pdev = (JCV.fp_to_dev([p[0] for p in pv]), JCV.fp_to_dev([p[1] for p in pv]))
    qdev = (JCV.fp2_to_dev([q[0] for q in qs]), JCV.fp2_to_dev([q[1] for q in qs]))
    p_inf = np.array([p is None for p in ps])
    coeffs = DP.prepare_g2(qdev, fuse=False, engine="lazy", events=events)
    f = DP.miller_loop(pdev, coeffs, fuse=False, engine="lazy", events=events)
    f = JTL.select(p_inf, JTL.fp12_one((len(ps),)), f)
    want = JCV.fp12_from_dev(DP._egress(JTL, DP._fold_mul(JTL, f, len(ps))))
    assert [_tuples(r["fp12"]) for r in res] == [tuple(want)] * 2


def test_multi_pairing_sharded_rejects_a_batch_the_world_does_not_split():
    """n % world != 0 raises ValueError before any collective (JAX asserts)."""
    mesh = types.SimpleNamespace(shape={"data": 2}, rank=0, device=torch.device("cpu"))
    p = (CV.fp_to_dev([JOF.G1_GEN[0]] * 3), CV.fp_to_dev([JOF.G1_GEN[1]] * 3))
    q = (CV.fp2_to_dev([JOF.G2_GEN[0]] * 3), CV.fp2_to_dev([JOF.G2_GEN[1]] * 3))
    with pytest.raises(ValueError, match="do not split"):
        PR.multi_pairing_sharded(p, q, mesh)
