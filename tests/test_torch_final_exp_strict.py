"""The port's strict-engine final exponentiation against JAX's, and the
tensor-level strict `pairing` entry against the oracle, on both routes.

One strict pairing through `ark_blst_tpu_torch.pairing(...,
engine="strict", device="cpu")` at batch 2 with identity masks, fused (the
chains on strict limbs: FE-easy and FE-hard, on CPU tensors their plain
versions) and unfused (the strict tower), is held against the oracle by
value; the final exponentiation it ran is recorded and held limb for limb
against JAX `final_exp(engine="strict", fuse=False)` on the same input
(strict values are canonical: the tolerance is zero), and the two routes'
results against each other. One run of the unfused strict final
exponentiation costs ~50K plain field ops on the CPU, so the test runs it
once for both checks, and JAX's once for both routes."""

import os
import random

import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.oracle import pairing as JOP

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

RNG = random.Random(13)
PS3 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(3)]
QS3 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(3)]


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


# JAX's strict final exponentiation of an input, by its values (both
# routes hand it the same Miller loop output), and each route's pairing
_JAX_FINAL = {}
_ROUTES = {}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_strict_pairing_entry_and_final_exp(monkeypatch, fuse):
    seen, finals = [], []
    final_exp, final_strict = PR.final_exp, PR._final_strict

    def recorded(f, fuse=True, engine="lazy"):
        out = final_exp(f, fuse, engine)
        seen.append((engine, f, out))
        return out

    def recorded_strict(f, fuse=True, engine="lazy"):
        out = final_strict(f, fuse, engine)
        finals.append((engine, f, out))
        return out

    monkeypatch.setattr(PR, "final_exp", recorded)
    monkeypatch.setattr(PR, "_final_strict", recorded_strict)
    ps, qs = [PS3[0], PS3[1]], [QS3[0], QS3[1]]
    p = (CV.fp_to_dev([x[0] for x in ps]), CV.fp_to_dev([x[1] for x in ps]))
    q = (CV.fp2_to_dev([x[0] for x in qs]), CV.fp2_to_dev([x[1] for x in qs]))
    out = T.pairing(p, q, p_inf=torch.tensor([False, False]), q_inf=torch.tensor([False, True]),
                    fuse=fuse, engine="strict", device="cpu")
    assert all(x.shape == (24, 2) for x in _leaves(out))
    assert CV.fp12_from_dev(out) == [JOP.pairing(PS3[0], QS3[0]), OF.FP12_ONE]

    (engine, f_in, f_out), = finals
    assert engine == "strict"
    if fuse:  # the stack of K6-chain's limbs, masked, into FE-easy; no eager final_exp
        assert not seen and f_in.shape == (12, 24, 2)
        f_in = TL.unstack12(f_in)
    else:
        assert [(e, f is f_in) for e, f, _ in seen] == [("strict", True)]
    vals = CV.fp12_from_dev(f_in)
    key = tuple(map(str, vals))
    if key not in _JAX_FINAL:
        jf = JCV.fp12_to_dev(vals)  # canonical: the same limbs
        _JAX_FINAL[key] = DP.final_exp(jf, fuse=False, engine="strict")
    for g, w in zip(_leaves(f_out), _leaves(_JAX_FINAL[key])):
        assert (g.numpy().astype(np.int64) == np.asarray(w).astype(np.int64)).all()
    assert all(g is o for g, o in zip(_leaves(f_out), _leaves(out)))  # strict egress: nothing
    _ROUTES[fuse] = _leaves(out)
    if len(_ROUTES) == 2:  # the routes agree limb for limb
        assert all(torch.equal(a, b) for a, b in zip(_ROUTES[True], _ROUTES[False]))
