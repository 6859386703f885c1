"""The fused pairing's word route edge by edge on CPU tensors, where every
kernel wrapper runs its plain version: each new plain edge against the
digit route it replaces, followed by `tower_lazy.fp12_egress`, exactly
(words and strict limbs are canonical):
* `miller_lines` with `FMT_WORDS` (K6-chain storing conj(f) as words)
  against `fp12_egress(conj(f))` of its digits, and the oracle's Miller
  loop (the conjugation applied once);
* the identity mask on words (fp12 one's words);
* `easy` on words against `easy` on the digit route's conj(f);
* `hard(out="limbs")` against `hard`'s digits egressed, and the `(12, 24,
  N)` rows nested as the strict fp12 (`tower_lazy.unstack12`) in
  `fp12_egress`'s leaf order;
* a prepared stack of digit lines paired fused: the digit route, FE-hard
  still storing the limbs, no egress.
The entries against the JAX package: tests/test_torch_pairing_words.py.
"""

import os
import random

import numpy as np
import pytest
import torch

from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

RNG = random.Random(19)
PS4 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]
QS4 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(4)]
# pair 1 holds an identity P, pair 2 an identity Q
PAIRS_P = [PS4[0], None, PS4[2], PS4[3]]
PAIRS_Q = [QS4[0], QS4[1], None, QS4[3]]


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
    coordinates the generator's), their identity masks, and the fused
    prepare's word lines."""
    cpu = torch.device("cpu")
    (p, p_inf), (q, q_inf) = B._g1_batch(PAIRS_P, cpu), B._g2_batch(PAIRS_Q, cpu)
    return p, q, p_inf, q_inf, PS.prepare_lines(q, PR.MILLER_EVENTS)


def _word_limbs(words: torch.Tensor) -> torch.Tensor:
    """(12, 12, N) canonical words -> the (12, 24, N) strict limbs of the
    same numbers: each word's low and high 16 bits."""
    u = words.long() & 0xFFFFFFFF
    return torch.stack([u & 0xFFFF, u >> 16], dim=2).reshape(12, 24, -1).to(torch.int32)


def _egressed(f: torch.Tensor) -> torch.Tensor:
    """A stacked (12, 30, N) lazy fp12 -> its strict limbs, stacked (the
    digit route's `fp12_egress`)."""
    return torch.stack(TL._flat12(TL.fp12_egress(TL.unstack12(f))))


@pytest.fixture(scope="module")
def miller_both(inputs):
    """K6-chain's plain version on the fused prepare's word lines: f as
    digits, and conj(f) as words."""
    p, _, _, _, lines = inputs
    return (PS.miller_lines(lines, p, PR.MILLER_EVENTS),
            PS.miller_lines(lines, p, PR.MILLER_EVENTS, PS.FMT_WORDS))


def test_miller_lines_words_edge(inputs, miller_both):
    """`miller_lines` with FMT_WORDS stores conj(f) as canonical words: the
    limbs of `fp12_egress(conj(f))` of the digit route, and the oracle's
    miller_loop by value (the conjugation applied once); it takes word
    lines only."""
    p, q, _, _, _ = inputs
    digits, words = miller_both
    assert words.shape == (12, W.WORDS, 4)
    assert torch.equal(_word_limbs(words), _egressed(FE.conj(digits)))
    got = CV.fp12_from_dev(TL.unstack12(_word_limbs(words)))
    assert got[0] == OP.miller_loop(PS4[0], QS4[0]) and got[3] == OP.miller_loop(PS4[3], QS4[3])
    lines = W.words_to_digits_plain(PS.prepare_lines(q, PR.MILLER_EVENTS[:1]))
    with pytest.raises(ValueError, match="word lines"):
        PS.miller_lines(lines, p, PR.MILLER_EVENTS[:1], PS.FMT_WORDS)


def test_identity_mask_on_words(inputs, miller_both):
    """The mask selects fp12 one's words (R mod p in component 0) for the
    identity pairs and leaves the others' words as K6-chain stored them."""
    p, _, p_inf, q_inf, lines = inputs
    _, words = miller_both
    got = PR._masked_miller_stack(p, lines, p_inf | q_inf)
    one = _word_limbs(PR._fp12_one_words("cpu").expand(-1, -1, 2))
    assert torch.equal(_word_limbs(got[..., 1:3]), one)
    assert torch.equal(_egressed(TL.stack12(TL.fp12_one(torch.zeros(30, 2, dtype=torch.int32)))),
                       one)
    assert torch.equal(got[..., [0, 3]], words[..., [0, 3]])


def test_easy_on_words_edge(miller_both):
    """`easy` on conj(f) as words (the layout read from the shape) is
    `easy` on the digit route's conj(f), by strict limbs."""
    digits, words = miller_both
    got = FE.easy(words)
    assert got.shape == (12, 30, 4)
    assert torch.equal(_egressed(got), _egressed(FE.easy(FE.conj(digits))))


def test_hard_limbs_edge(miller_both):
    """`hard(out="limbs")` is `hard`'s digits followed by `fp12_egress`,
    limb for limb; another output is refused."""
    digits, _ = miller_both
    t2 = FE.easy(FE.conj(digits))
    got = FE.hard(t2, out="limbs")
    assert got.shape == (12, 24, 4)
    assert torch.equal(got, _egressed(FE.hard(t2)))
    with pytest.raises(ValueError):
        FE.hard(t2, out="words")


def test_strict_rows_leaf_order():
    """The (12, 24, N) rows nest as `fp12_egress`'s leaves, in its order,
    as views of the rows."""
    rng = np.random.default_rng(18)
    f = torch.from_numpy(rng.integers(-4000, 4000, (12, 30, 3)).astype(np.int32))
    egressed = TL.fp12_egress(TL.unstack12(f))
    rows = torch.stack(_leaves(egressed))
    nested = TL.unstack12(rows)
    for got, want in zip(_leaves(nested), _leaves(egressed)):
        assert torch.equal(got, want)
        assert got.data_ptr() != want.data_ptr() and got._base is rows
    assert [x.data_ptr() for x in _leaves(nested)] == [rows[c].data_ptr() for c in range(12)]


def test_prepared_digit_layout_keeps_the_digit_route(inputs, monkeypatch):
    """An unfused prepare's digit lines paired fused: K6-chain stores f as
    digits (the word layout wants word lines), the mask selects on digits,
    and FE-hard still stores the strict limbs, no egress; equal to the
    oracle."""
    p, q, p_inf, q_inf, _ = inputs
    prepared = PR.prepare_g2_device(q, q_inf, fuse=False)
    assert prepared.layout == "digits"

    def no_egress(*args, **kwargs):
        raise AssertionError("the lazy egress ran")

    monkeypatch.setattr(PR, "egress", no_egress)
    got = CV.fp12_from_dev(PR.pairing_prepared(p, prepared, p_inf))
    assert got == [OP.pairing(a, b) if a and b else OF.FP12_ONE
                   for a, b in zip(PAIRS_P, PAIRS_Q)]
