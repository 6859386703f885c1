"""The fused pairing's word route (`curves/pairing.py`: `pairing`,
`pairing_prepared`, `multi_pairing` with `engine="lazy", fuse=True`) on
CPU tensors, where every kernel wrapper runs its plain version.

On word lines the route keeps f in canonical 32-bit words from K6-chain
on: `miller_lines` stores conj(f) as words (`FMT_WORDS`), the identity
mask selects on words, FE-easy loads them, and FE-hard stores the strict
(24, N) limbs the entry returns, so the lazy egress does not run. Words
and strict limbs are canonical, so the entries are held exactly: against
the JAX package's `pairing` (run as on the CPU, its strict engine) limb for
limb, an identity P and an identity Q among the pairs; `multi_pairing`
(its product folded on words) against the oracle's product. The route's edges one by one:
tests/test_torch_pairing_edges.py; the kernels' block programs in these
layouts under g++: tests/test_torch_tower_host.py; the kernels on the
card: tests/test_torch_cuda.py.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.oracle import pairing as JOP

from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

RNG = random.Random(18)
PS4 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]
QS4 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]
# pair 1 holds an identity P, pair 2 an identity Q
PAIRS_P = [PS4[0], None, PS4[2], PS4[3]]
PAIRS_Q = [QS4[0], QS4[1], None, QS4[3]]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the torch threads among the pytest-xdist workers while the
    module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def inputs():
    """The pairs as the entries take them: strict P and Q (an identity's
    coordinates the generator's) and their identity masks."""
    (p, p_inf), (q, q_inf) = B._g1_batch(PAIRS_P, CPU), B._g2_batch(PAIRS_Q, CPU)
    return p, q, p_inf, q_inf


@pytest.fixture(scope="module")
def jax_pairing(inputs):
    """The JAX package's `pairing` of the same limbs and masks, as numpy
    leaves: the reference of both entries (its `pairing_prepared` runs the
    same Miller loop and final exponentiation on the same lines; the JAX
    strict engine runs eagerly here, so it runs once)."""
    p, q, p_inf, q_inf = inputs
    limbs = lambda x: jnp.asarray(x.numpy().astype(np.uint32))  # noqa: E731 (JCV's dtype)
    jp = tuple(limbs(x) for x in p)
    jq = tuple(tuple(limbs(x) for x in c) for c in q)
    out = DP.pairing(jp, jq, jnp.asarray(p_inf.numpy()), jnp.asarray(q_inf.numpy()))
    return [np.asarray(x).astype(np.int64) for x in _leaves(out)]


@pytest.fixture
def word_route(monkeypatch):
    """Records the f formats K6-chain is asked for, and fails any call of
    the lazy egress."""
    formats = []
    miller_lines = PS.miller_lines

    def spy(coeffs, p, schedule, f_fmt=PS.FMT_DIGITS):
        formats.append(f_fmt)
        return miller_lines(coeffs, p, schedule, f_fmt)

    def no_egress(*args, **kwargs):
        raise AssertionError("the lazy egress ran on the word route")

    monkeypatch.setattr(PS, "miller_lines", spy)
    monkeypatch.setattr(PR, "egress", no_egress)
    return formats


@pytest.mark.parametrize("entry", ["pairing", "pairing_prepared"])
def test_word_route_matches_jax(inputs, jax_pairing, word_route, entry):
    """`pairing` and `pairing_prepared` (a fused prepare: word lines) run
    the word route, K6-chain storing conj(f) as words and no egress, and
    give the JAX package's strict limbs of `pairing` limb for limb, one for
    the identity pairs."""
    p, q, p_inf, q_inf = inputs
    if entry == "pairing":
        got = PR.pairing(p, q, p_inf, q_inf)
    else:
        prepared = PR.prepare_g2_device(q, q_inf)
        assert prepared.layout == "words"
        got = PR.pairing_prepared(p, prepared, p_inf)
    assert word_route == [PS.FMT_WORDS]
    leaves = _leaves(got)
    assert len(leaves) == 12 and all(x.shape == (24, 4) for x in leaves)
    for g, w in zip(leaves, jax_pairing):
        assert np.array_equal(g.numpy().astype(np.int64), w)
    want = [JOP.pairing(a, b) if a and b else OF.FP12_ONE for a, b in zip(PAIRS_P, PAIRS_Q)]
    assert CV.fp12_from_dev(got) == want


def test_multi_pairing_runs_no_egress(inputs, word_route):
    """`multi_pairing` folds K6-chain's conj(f) words on K4's word edges,
    then FE-easy on words and FE-hard to strict limbs: the oracle's
    product, and no egress (the word route of the multi-pairings:
    tests/test_torch_multi_words.py)."""
    p, q, p_inf, q_inf = inputs
    got = CV.fp12_from_dev(PR.multi_pairing(p, q, p_inf, q_inf))
    want = JOP.final_exp(JOP.multi_miller_loop([(PS4[0], QS4[0]), (PS4[3], QS4[3])]))
    assert got == [want]
    assert word_route == [PS.FMT_WORDS]
