"""The multi-pairings' word route (`curves/pairing.py`: `multi_miller_loop`,
`multi_miller_loop_prepared`, `multi_pairing` with `engine="lazy",
fuse=True`) and K4's word edges (`ops/fp12_mul.py`) on CPU tensors, where
every kernel wrapper runs its plain version.

K6-chain stores each pair's conj(f) as canonical 32-bit words, the
identity mask selects on words, and the product fold runs on K4's words ->
words layout; `multi_pairing` hands the product to FE-easy (words) and
FE-hard (strict limbs), `multi_miller_loop` stores it as strict limbs from
the fold's last level (words -> limbs), so the lazy egress never runs.
Words and strict limbs are canonical, so everything is held exactly:
K4's plain layouts against JAX `tower_lazy.fp12_mul` (the `mul12`
instance's body) by canonical value, the word fold against JAX `_fold_mul`
and `_egress` limb for limb, the entries against JAX
`Bls12.multi_miller_loop(..., backend="host")` and the oracle's product,
identity pairs on both sides and at N = 1. K4's block program in these
layouts under g++: tests/test_torch_tower_host.py; on the card:
tests/test_torch_cuda.py.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ark_blst_tpu as J
from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.ops.convert import value_from_jax
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

N = 4
CPU = torch.device("cpu")
RNG = random.Random(19)
PS4 = [OC.scalar_mul(OF.G1_GEN, RNG.randrange(1, OF.R)) for _ in range(N)]
QS4 = [OC.g2_mul(OF.G2_GEN, RNG.randrange(1, OF.R)) for _ in range(N)]
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


def _fp12_vals(seed: int, n: int) -> list:
    """n random canonical fp12 values (numpy-seeded), one among them."""
    rng = np.random.default_rng(seed)
    ints = lambda k: [int.from_bytes(rng.bytes(48), "little") % OF.P for _ in range(k)]  # noqa: E731
    vals = [tuple(tuple(tuple(ints(2)) for _ in range(3)) for _ in range(2)) for _ in range(n)]
    vals[min(1, n - 1)] = OF.FP12_ONE
    return vals


def _limbs(vals) -> torch.Tensor:
    """fp12 values -> their strict (12, 24, n) limbs in the lazy tower's leaf
    order."""
    return torch.stack(TL._flat12(CV.fp12_to_dev(vals)))


def _words(vals) -> torch.Tensor:
    """fp12 values -> (12, 12, n) canonical words (two limbs to a word)."""
    u = _limbs(vals).long()
    w = u[:, 0::2] | (u[:, 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _jax_limbs(jax_fp12) -> torch.Tensor:
    """A JAX lazy fp12 -> its strict (12, 24, n) limbs (JAX's egress)."""
    leaves = JTL._flat12(JTL.fp12_egress(jax_fp12))
    return torch.stack([torch.from_numpy(np.asarray(x).astype(np.int64)) for x in leaves]).to(
        torch.int32)


def _jax_lazy(vals):
    return JTL.fp12_ingest(JCV.fp12_to_dev(vals))


def test_words_to_limbs_plain_is_the_egress():
    """The strict limbs of canonical words, split two to a word, equal the
    lazy egress of their digits limb for limb."""
    w = _words(_fp12_vals(7, 6))
    want = torch.stack(TL._flat12(TL.fp12_egress(TL.unstack12(W.words_to_digits_plain(w)))))
    assert torch.equal(W.words_to_limbs_plain(w), want)


@pytest.mark.parametrize("out", ["digits", "words", "limbs"])
def test_k4_plain_layouts_match_jax_mul12(out):
    """Each layout of K4's plain version against JAX `tower_lazy.fp12_mul`
    (the body of the `mul12` instance of `tower_fused`) on the same values,
    one among them, by canonical value: digits -> digits, words -> words,
    words -> strict limbs (no conjugation at the edges)."""
    a, b = _fp12_vals(3, 5), _fp12_vals(4, 5)
    want = _jax_limbs(JTL.fp12_mul(_jax_lazy(a), _jax_lazy(b)))
    if out == "digits":
        got = K4.fp12_mul(TL.stack12(TL.fp12_ingest(CV.fp12_to_dev(a))),
                          TL.stack12(TL.fp12_ingest(CV.fp12_to_dev(b))))
        assert got.shape == (12, 30, 5)
        got = W.words_to_limbs_plain(W.digits_to_words_plain(got))
    else:
        got = K4.fp12_mul(_words(a), _words(b), out=out)
        assert got.shape == (12, W.WORDS if out == "words" else 24, 5)
        if out == "words":
            got = W.words_to_limbs_plain(got)
    assert torch.equal(got, want)
    assert CV.fp12_from_dev(TL.unstack12(got)) == [OF.fp12_mul(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("out,operands", [("digits", "words"), ("words", "digits"),
                                          ("limbs", "digits"), ("strict", "words")])
def test_k4_rejects_layouts_it_has_no_instance_of(out, operands):
    """K4 stores digits from digits and words or limbs from words: any other
    pair raises, on the CPU as on the card."""
    vals = _fp12_vals(5, 2)
    x = _words(vals) if operands == "words" else TL.stack12(TL.fp12_ingest(CV.fp12_to_dev(vals)))
    with pytest.raises(ValueError):
        K4.fp12_mul(x, x, out=out)
    with pytest.raises(ValueError, match="stacks"):
        K4.fp12_mul(x, x[:, :, :1], out="words" if operands == "words" else "digits")


@pytest.fixture
def k4_outs(monkeypatch):
    """Records the layout each K4 call of the fold stores."""
    outs = []
    fp12_mul = K4.fp12_mul

    def spy(a, b, out=None):
        outs.append(out)
        return fp12_mul(a, b, out)

    monkeypatch.setattr(K4, "fp12_mul", spy)
    return outs


@pytest.mark.parametrize("n", [1, 3, 4])
def test_word_fold_matches_jax_fold_mul(n, k4_outs):
    """`_fold_stack` on the words of conj(x_i) against JAX `_fold_mul` and
    `_egress` on conj(x_i) limb for limb, and against the conjugation of
    JAX's fold of the x_i (conj is an automorphism): to words (then split)
    and to strict limbs from the last level; ceil(log2 n) levels, the last
    storing limbs, and at n = 1 one launch against one."""
    vals = _fp12_vals(10 + n, n)
    conj = [OF.fp12_conj(v) for v in vals]
    jf = JTL.fp12_conj(_jax_lazy(vals))
    want = _jax_limbs(DP._fold_mul(JTL, jf, n))
    assert torch.equal(want, _jax_limbs(JTL.fp12_conj(DP._fold_mul(JTL, _jax_lazy(vals), n))))
    limbs = PR._fold_stack(_words(conj), n, out="limbs")
    levels = (n - 1).bit_length()
    assert k4_outs == ["words"] * (levels - 1) + ["limbs"]
    assert limbs.shape == (12, 24, 1) and torch.equal(limbs, want)
    k4_outs.clear()
    words = PR._fold_stack(_words(conj), n)
    assert k4_outs == ["words"] * levels
    assert torch.equal(W.words_to_limbs_plain(words), want)
    acc = OF.FP12_ONE
    for v in conj:
        acc = OF.fp12_mul(acc, v)
    assert CV.fp12_from_dev(TL.unstack12(limbs)) == [acc]


@pytest.fixture
def word_route(monkeypatch):
    """Records the f formats K6-chain is asked for; fails any call of the
    lazy egress (`tower_lazy.fp12_egress`, and `curves/pairing.py:egress`
    around it)."""
    formats = []
    miller_lines = PS.miller_lines

    def spy(coeffs, p, schedule, f_fmt=PS.FMT_DIGITS):
        formats.append(f_fmt)
        return miller_lines(coeffs, p, schedule, f_fmt)

    def no_egress(*args, **kwargs):
        raise AssertionError("the lazy egress ran on the word route")

    monkeypatch.setattr(PS, "miller_lines", spy)
    monkeypatch.setattr(TL, "fp12_egress", no_egress)
    monkeypatch.setattr(PR, "egress", no_egress)
    return formats


@pytest.fixture(scope="module")
def jax_mlo():
    """JAX `Bls12.multi_miller_loop(..., backend="host")` of the pairs, at
    N = 4 and N = 1, as the port's `MillerLoopOutput`."""
    jp = [J.G1Affine.zero() if p is None else J.G1Affine(p) for p in PAIRS_P]
    jq = [J.G2Affine.zero() if q is None else J.G2Affine(q) for q in PAIRS_Q]
    return {k: value_from_jax(J.Bls12.multi_miller_loop(jp[:k], jq[:k], backend="host"))
            for k in (N, 1)}


def _oracle_product(n: int):
    return OP.multi_miller_loop([(p, q) for p, q in zip(PAIRS_P[:n], PAIRS_Q[:n]) if p and q])


@pytest.mark.parametrize("entry", ["multi_miller_loop", "multi_miller_loop_prepared"])
@pytest.mark.parametrize("n", [N, 1])
def test_multi_miller_loop_word_route_matches_jax(entry, n, jax_mlo, word_route, k4_outs):
    """`multi_miller_loop` and `multi_miller_loop_prepared` (a "words"
    stack) on the CPU: K6-chain's conj(f) as words, the fold on words, its
    last level storing the strict limbs (at N = 1 one product by one), no
    egress; the strict fp12 of batch 1, nested as the oracle's values,
    equal to JAX `Bls12.multi_miller_loop(..., backend="host")` and the
    oracle's product (identity pairs one)."""
    (p, p_inf), (q, q_inf) = B._g1_batch(PAIRS_P[:n], CPU), B._g2_batch(PAIRS_Q[:n], CPU)
    if entry == "multi_miller_loop":
        got = PR.multi_miller_loop(p, q, p_inf, q_inf)
    else:
        prepared = PR.prepare_g2_device(q, q_inf)
        assert prepared.layout == "words"
        got = PR.multi_miller_loop_prepared(p, prepared, p_inf)
    assert word_route == [PS.FMT_WORDS]
    assert k4_outs == ["words"] * ((n - 1).bit_length() - 1) + ["limbs"]
    leaves = [x for a in got for b in a for x in b]
    assert len(leaves) == 12 and all(x.shape == (24, 1) for x in leaves)
    vals = CV.fp12_from_dev(got)
    assert vals == [_oracle_product(n)]
    assert T.MillerLoopOutput(vals[0]) == jax_mlo[n]


def test_bls12_multi_miller_loop_and_multi_pairing_on_cpu(jax_mlo, word_route):
    """The tuple-level and API entries on `device="cpu"` run the word route:
    `Bls12.multi_miller_loop` equals JAX's host backend, `multi_pairing`
    the oracle's product of pairings, with identity pairs on both sides."""
    gp = [T.G1Affine.zero() if p is None else T.G1Affine(p) for p in PAIRS_P]
    gq = [T.G2Affine.zero() if q is None else T.G2Affine(q) for q in PAIRS_Q]
    assert T.Bls12.multi_miller_loop(gp, gq, device="cpu") == jax_mlo[N]
    assert B.multi_pairing(PAIRS_P, PAIRS_Q, device="cpu") == OP.final_exp(_oracle_product(N))
    assert word_route == [PS.FMT_WORDS] * 2


def test_multi_pairing_digit_prepare_keeps_its_route():
    """A "digits" prepared stack (an unfused prepare) paired fused keeps the
    digit route of the Miller product: K6 storing f as digits, the fold on
    digits and the egress, to the same product."""
    (p, p_inf), (q, q_inf) = B._g1_batch(PAIRS_P, CPU), B._g2_batch(PAIRS_Q, CPU)
    prepared = PR.prepare_g2_device(q, q_inf, fuse=False)
    assert prepared.layout == "digits"
    got = PR.multi_miller_loop_prepared(p, prepared, p_inf)
    assert CV.fp12_from_dev(got) == [_oracle_product(N)]
