"""FE-easy's and FE-hard's plain versions (`ops/final_exp.py`) on CPU
tensors against the JAX package's lazy tower, digit for digit, and the
whole fused `final_exp` against the oracle by value.

* `easy_plain` against JAX `tower_lazy.fp12_conj`, `fp12_inv(f,
  fuse=False)`, `fp12_mul` and `fp12_frobenius`, composed as the JAX
  `final_exp`'s easy part, on real Miller-loop outputs and an
  identity-masked element (f = 1). Inside JAX `fp12_inv` the norm's Fermat
  ladder is the port's plain ladder (`fp_inv.fp_inv_plain`), which
  tests/test_torch_fp_inv.py holds digit for digit against JAX
  `fp_inv(fuse=False)`: JAX's own takes ~140 s eager here (16 s with its
  product jitted), the rest of the easy part ~15 s;
* one ladder of `HARD_PROGRAM` (`LADDER_PROGRAM`, walked by `run_program`
  over `PLAIN_OPS`) against JAX `cyclotomic_exp_x_conj(f, fuse=False)` on the easy part's
  output, the whole ladder: 63 squares and 5 products;
* `hard_plain(easy_plain(f))`, which `curves/pairing.py:final_exp` now
  is on CPU tensors, against the oracle's `final_exp` by value;
* the host constants the kernels take: the Frobenius maps' words against
  the oracle's `fp12_frobenius`, and the conversion of words to digits.
The kernels run on the card (tests/test_torch_cuda.py); their block
programs run here under g++ (tests/test_torch_tower_host.py).
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import pairing as DP
from ark_blst_tpu.ops import convert as JCV
from ark_blst_tpu.ops import tower_lazy as JTL

from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the torch threads among the pytest-xdist workers while the
    module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


def miller_outputs(seed: int, n: int = 2) -> list:
    """The oracle's Miller loop of n numpy-seeded (P, Q) pairs, then one: f as
    the pipeline's masked Miller loop hands it to the final exponentiation
    (an identity pair's f set to one)."""
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(2 * n)]
    ps = [OC.scalar_mul(OF.G1_GEN, k) for k in ks[:n]]
    qs = [OC.g2_mul(OF.G2_GEN, k) for k in ks[n:]]
    return [OP.miller_loop(p, q) for p, q in zip(ps, qs)] + [OF.FP12_ONE]


def lazy_fp12(vals):
    """Oracle fp12 values -> (the JAX lazy fp12, the same digits stacked as
    the port's (12, 30, n))."""
    j = JTL.fp12_ingest(JCV.fp12_to_dev(vals))
    return j, TL.stack12(CV.tree_from_jax(j))


def jax_stack(tree) -> np.ndarray:
    return np.stack([np.asarray(x) for x in JTL._flat12(tree)])


@pytest.fixture(scope="module")
def easy_case():
    """(f values, the JAX f, the port's f, the JAX easy part, the port's)."""
    vals = miller_outputs(3)
    jf, f = lazy_fp12(vals)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTL, "fp_inv", lambda a, fuse=True: jnp.asarray(
            FI.fp_inv_plain(torch.from_numpy(np.array(a))).numpy()))
        t2 = JTL.fp12_mul(JTL.fp12_conj(jf), JTL.fp12_inv(jf, fuse=False))
        jt2 = JTL.fp12_mul(JTL.fp12_frobenius(t2, 2), t2)
    return vals, jf, f, jt2, FE.easy_plain(f)


def test_easy_plain_equals_jax_digit_for_digit(easy_case):
    """The easy part of two Miller outputs and one f = 1: conj(f) f^-1, its
    Frobenius square times itself, digit for digit with the JAX lazy
    tower; the CPU wrapper returns the plain version's digits."""
    _, _, f, jt2, got = easy_case
    assert got.shape == (12, 30, 3)
    assert (got.numpy() == jax_stack(jt2)).all()
    assert torch.equal(FE.easy(f), got)


def test_hard_ladder_equals_jax_digit_for_digit(easy_case):
    """One whole x-ladder of the hard part's program (six segments, 63
    squares and 5 products, then the conjugation) on the easy part's
    output, digit for digit with JAX `cyclotomic_exp_x_conj(fuse=False)`
    (eager, ~27 s)."""
    _, _, _, jt2, t2 = easy_case
    want = DP.cyclotomic_exp_x_conj(jt2, fuse=False, engine="lazy")
    got = FE.run_program(FE.LADDER_PROGRAM, t2, FE.PLAIN_OPS)
    assert (got.numpy() == jax_stack(want)).all()
    assert torch.equal(got, PR.cyclotomic_exp_x_conj(t2))


def test_final_exp_equals_oracle(easy_case):
    """hard_plain(easy_plain(f)) is the pipeline's fused `final_exp` on CPU
    tensors, equal to the oracle's final_exp by value (one for f = 1)."""
    vals, _, f, _, t2 = easy_case
    got = FE.hard_plain(t2)
    assert torch.equal(PR.final_exp(f), got)
    assert torch.equal(FE.hard(t2), got)
    want = [OP.final_exp(v) for v in vals]
    assert want[-1] == OF.FP12_ONE
    assert CV.fp12_from_dev(PR.egress(got)) == want


def test_hard_program_is_the_chain():
    """The program's work: 317 cyclotomic squares, 35 fp12 products,
    Frobenius maps of powers 3, 1, 2, values within HARD_VALUES, one OUT
    at its end."""
    ops = FE.HARD_PROGRAM
    squares = sum(a for code, a, _, _ in ops if code == FE.SQR)
    assert squares == 5 * sum(n for n, _ in FE.X_SEGMENTS) + 2 == 317
    assert sum(code == FE.MUL for code, *_ in ops) == 35
    assert [a for code, a, _, _ in ops if code == FE.FROB] == [3, 1, 2]
    values = [a for code, a, _, _ in ops if code == FE.STORE]
    values += [v for code, a, b, _ in ops if code == FE.LOAD for v in (a, b) if v >= 0]
    assert 0 <= min(values) and max(values) < FE.HARD_VALUES
    assert [code for code, *_ in ops].index(FE.OUT) == len(ops) - 1
    assert FE.X_SEGMENTS == DP._X_SEGMENTS


@pytest.mark.parametrize("power", [1, 2, 3])
def test_frob_words_hold_the_frobenius_maps(power):
    """FROB_WORDS, the Montgomery words the kernels multiply by: slot k of a
    random fp12, conjugated for an odd power, times the constant of slot k,
    gives the oracle's fp12_frobenius."""
    rng = random.Random(40 + power)
    a = tuple(tuple(tuple(rng.randrange(OF.P) for _ in range(2)) for _ in range(3))
              for _ in range(2))
    consts = []
    for k in range(6):
        words = FE.FROB_WORDS[power - 1, k].astype(np.uint32).astype(object)
        re, im = (sum(int(w) << (32 * j) for j, w in enumerate(h)) * pow(2, -384, OF.P) % OF.P
                  for h in words)
        consts.append((re, im))
    assert consts == FE.frob_constants(power)
    slots = [x for half in a for x in half]
    out = [OF.fp2_mul(OF.fp2_conj(x) if power % 2 else x, c) for x, c in zip(slots, consts)]
    assert (tuple(out[:3]), tuple(out[3:])) == OF.fp12_frobenius(a, power)


def test_words_to_digits_plain():
    """Canonical words of v (v 2^384) -> balanced digits of v 2^390 within
    4096, for 0, 1, p - 1 and random v."""
    rng = random.Random(44)
    vals = [0, 1, OF.P - 1] + [rng.randrange(OF.P) for _ in range(9)]
    words = np.array([FE._words(v) for v in vals], np.uint32).view(np.int32).T
    got = W.words_to_digits_plain(torch.from_numpy(words.copy())[None])
    assert got.shape == (1, 30, len(vals)) and int(got.abs().max()) <= 4096
    assert [x % OF.P for x in LZ.digits_to_ints(got[0])] == [v * LZ.R13 % OF.P for v in vals]


def test_hard_takes_words_only_on_the_card():
    """Word stacks come only from the card's FE-easy: on the CPU, where
    `easy` returns digits, `hard` refuses them (tests/test_torch_csrc.py
    holds both wrappers to the digit stacks' shapes, dtype and device)."""
    with pytest.raises(ValueError):
        FE.hard(torch.zeros((12, FE.WORDS, 4), dtype=torch.int32))
