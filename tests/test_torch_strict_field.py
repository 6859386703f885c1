"""The port's strict radix-16 engine (ops/fieldops.py, ops/strict_field.py,
ops/dispatch.py) against the JAX package, on the same numpy-seeded limbs:

* the plain versions of K7-K10 on CPU tensors, digit for digit, against
  the JAX array engine (`ops/limbs.py`: `mont_mul`, `add_mod`, `sub_mod`,
  `neg_mod`, `to_mont`, `from_mont`) for Fp and Fr, on random canonical
  values and the extreme values (0, 1, p-1, p-2, all-ones low limbs);
* the relaxed schoolbook products and the conditional subtraction against
  the JAX list engine (`ops/fieldops.py`), digit for digit;
* the three interpret-mode cases of tests/test_pallas.py (mismatched
  broadcast shapes, `mul_many` with mixed shapes) against JAX
  `pallas_field` with `INTERPRET = True` on the 2-limb test field;
* `fp_inv`, `fp_sqrt_candidate` and `fp_mul_small` against the oracle;
  the Fp `fp_inv` (K7-inv's route, on CPU tensors its plain version) limb
  for limb against JAX `ops/dispatch.fp_inv`, 0 and 1 included.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.ops import dispatch as JD
from ark_blst_tpu.ops import fieldops as JFO
from ark_blst_tpu.ops import limbs as JL
from ark_blst_tpu.ops import pallas_field as JPF
from ark_blst_tpu_torch.ops import dispatch as D
from ark_blst_tpu_torch.ops import fieldops as FO
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops.limbs import FP, FR, FieldSpec, ints_to_limbs, limbs_to_ints

SPECS = {"fp": (FP, JL.FP), "fr": (FR, JL.FR)}
TSPEC = FieldSpec("tiny", (1 << 30) - 35, 2)  # tests/test_pallas.py's 2-limb field
JTSPEC = JL.FieldSpec("tiny", (1 << 30) - 35, 2)


def edge_values(p: int, L: int) -> list:
    """0, 1, p-1, p-2 and values with all-ones low limbs below p."""
    return [0, 1, p - 1, p - 2] + [((p >> 16 * k) - 1 << 16 * k) | ((1 << 16 * k) - 1)
                                   for k in (1, 4, L // 2)]


def operand_ints(spec, seed: int):
    """Every pair of extreme values, then random canonical pairs."""
    edge = edge_values(spec.modulus, spec.num_limbs)
    rng = random.Random(seed)
    xs = [x for x in edge for _ in edge] + [rng.randrange(spec.modulus) for _ in range(15)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(spec.modulus) for _ in range(15)]
    return xs, ys


def stacked(vals, L) -> np.ndarray:
    """ints -> (L, N) limbs as a numpy int64 array (fits int32 and uint32)."""
    return ints_to_limbs(vals, L).T.astype(np.int64)


def port(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int32))


def jax_stacked(arr: np.ndarray):
    return jnp.asarray(arr.astype(np.uint32))


@jax.jit
def _jax_array_engine(a, b):  # row-major (N, L) operands of Fp and Fr
    out = {}
    for name, spec in (("fp", JL.FP), ("fr", JL.FR)):
        x, y = a[name], b[name]
        out[name] = {
            "mont_mul": JL.mont_mul(x, y, spec), "add": JL.add_mod(x, y, spec),
            "sub": JL.sub_mod(x, y, spec), "neg": JL.neg_mod(x, spec),
            "to_mont": JL.to_mont(x, spec), "from_mont": JL.from_mont(x, spec),
        }
    return out


@pytest.fixture(scope="module")
def jax_results():
    """The inputs of both fields and the JAX array engine's results, (L, N)."""
    ins, a, b = {}, {}, {}
    for name, (spec, _) in SPECS.items():
        xs, ys = operand_ints(spec, seed=len(name))
        ins[name] = (stacked(xs, spec.num_limbs), stacked(ys, spec.num_limbs))
        a[name] = jnp.asarray(ins[name][0].T.astype(np.uint32))
        b[name] = jnp.asarray(ins[name][1].T.astype(np.uint32))
    out = jax.tree.map(lambda x: np.asarray(x).T.astype(np.int64), _jax_array_engine(a, b))
    return ins, out


PORT_OPS = {
    "mont_mul": lambda a, b, s: SF.mont_mul(a, b, s), "add": lambda a, b, s: SF.add(a, b, s),
    "sub": lambda a, b, s: SF.sub(a, b, s), "neg": lambda a, b, s: SF.neg(a, s),
    "to_mont": lambda a, b, s: FO.mont_from_int_array(a, s),
    "from_mont": lambda a, b, s: FO.mont_to_int_array(a, s),
}


@pytest.mark.parametrize("field", ["fp", "fr"])
@pytest.mark.parametrize("op", list(PORT_OPS))
def test_plain_ops_match_jax_array_engine(jax_results, op, field):
    ins, out = jax_results
    spec = SPECS[field][0]
    a, b = port(ins[field][0]), port(ins[field][1])
    got = PORT_OPS[op](a, b, spec)
    assert got.dtype == torch.int32
    assert (got.numpy() == out[field][op]).all()


@pytest.mark.parametrize("batch", [64, 320], ids=["outer_product", "row_loop"])
@pytest.mark.parametrize("field", ["fp", "fr"])
def test_relaxed_products_match_jax_list_engine(field, batch):
    """mul_wide_list, mul_const_wide_list, mul_low_list and _cond_sub_list
    give the JAX list engine's relaxed digits, digit for digit, on both
    sides of `_ROW_LOOP_FROM`; the limb products reach (2^16 - 1)^2, past
    int32."""
    spec, jspec = SPECS[field]
    L = spec.num_limbs
    xs, ys = operand_ints(spec, seed=7)
    rng = random.Random(batch)
    xs += [rng.randrange(1 << 16 * L) for _ in range(batch - len(xs))]
    ys += [rng.randrange(1 << 16 * L) for _ in range(batch - len(ys))]
    xs[0], ys[0] = (1 << 16 * L) - 1, (1 << 16 * L) - 1  # all-ones limbs
    a, b = stacked(xs, L), stacked(ys, L)
    ja, jb = list(jax_stacked(a)), list(jax_stacked(b))
    ninv = FO.const_limbs(spec.ninv, L)
    pairs = [
        (FO.mul_wide_list(port(a), port(b)), JFO.mul_wide_list(ja, jb)),
        (FO.mul_const_wide_list(port(a), ninv), JFO.mul_const_wide_list(ja, ninv)),
        (FO.mul_low_list(port(a), ninv, L, const=True), JFO.mul_low_list(ja, ninv, L, const=True)),
        (FO.mul_low_list(port(a), port(b), L), JFO.mul_low_list(ja, jb, L)),
    ]
    for got, want in pairs:
        assert (got.numpy() == np.stack([np.asarray(x) for x in want]).astype(np.int64)).all()
    canon = stacked(operand_ints(spec, seed=8)[0] * (batch // 64), L)
    doubled = canon + stacked([spec.modulus] * canon.shape[1], L)  # limbwise: relaxed < 2^17
    u = FO.normalize_list(port(doubled), L)  # values in [p, 2p): strict limbs
    got = FO._cond_sub_list(u, spec)
    want = JFO._cond_sub_list(list(jax_stacked(u.numpy().astype(np.int64))), jspec)
    assert (got.numpy() == np.stack([np.asarray(x) for x in want]).astype(np.int64)).all()


# --- the interpret-mode cases of tests/test_pallas.py -------------------------

@pytest.fixture
def _pallas_interpret():
    JPF.INTERPRET = True
    yield
    JPF.INTERPRET = False


def _rand_t(rng, n):
    return [rng.randrange(TSPEC.modulus) for _ in range(n)]


def _dev_t(vals, batch_shape) -> np.ndarray:
    mont = [v * TSPEC.mont_r % TSPEC.modulus for v in vals]
    return stacked(mont, 2).reshape((2,) + batch_shape)


def _host_t(arr: torch.Tensor) -> list:
    rinv = pow(TSPEC.mont_r, -1, TSPEC.modulus)
    return [v * rinv % TSPEC.modulus for v in limbs_to_ints(arr.reshape(2, -1).T.numpy())]


def _same(got: torch.Tensor, want) -> bool:
    return got.shape == want.shape and (got.numpy() == np.asarray(want).astype(np.int64)).all()


def test_mont_mul_mismatched_batch_shapes(_pallas_interpret):
    """The round-1 failure shape: (L, lanes, W, 1) * (L, lanes, 1, 1)."""
    rng = random.Random(0)
    lanes, W = 2, 3
    a_vals, b_vals = _rand_t(rng, lanes * W), _rand_t(rng, lanes)
    a, b = _dev_t(a_vals, (lanes, W, 1)), _dev_t(b_vals, (lanes, 1, 1))
    got = SF.mont_mul(port(a), port(b), TSPEC)
    assert _same(got, JPF.mont_mul(jax_stacked(a), jax_stacked(b), JTSPEC))
    assert _host_t(got) == [a_vals[l * W + w] * b_vals[l] % TSPEC.modulus
                            for l in range(lanes) for w in range(W)]


def test_add_sub_neg_mismatched_batch_shapes(_pallas_interpret):
    rng = random.Random(1)
    a_vals, b_vals = _rand_t(rng, 4), _rand_t(rng, 2)
    a, b = _dev_t(a_vals, (2, 2)), _dev_t(b_vals, (2, 1))
    ta, tb, ja, jb = port(a), port(b), jax_stacked(a), jax_stacked(b)
    assert _same(SF.add(ta, tb, TSPEC), JPF.add(ja, jb, JTSPEC))
    assert _same(SF.sub(ta, tb, TSPEC), JPF.sub(ja, jb, JTSPEC))
    assert _same(SF.neg(tb, TSPEC), JPF.neg(jb, JTSPEC))
    p = TSPEC.modulus
    assert _host_t(SF.sub(ta, tb, TSPEC)) == [(a_vals[2 * i + j] - b_vals[i]) % p
                                              for i in range(2) for j in range(2)]


def test_mul_many_mixed_shapes(_pallas_interpret):
    """Pairs with different (and internally mismatched) batch shapes in one
    launch: the tower and MSM pattern."""
    rng = random.Random(2)
    a1, b1, a2, b2 = _rand_t(rng, 6), _rand_t(rng, 2), _rand_t(rng, 3), _rand_t(rng, 3)
    pairs = [(_dev_t(a1, (2, 3, 1)), _dev_t(b1, (2, 1, 1))), (_dev_t(a2, (3,)), _dev_t(b2, (3,)))]
    got = SF.mul_many([(port(x), port(y)) for x, y in pairs], TSPEC)
    want = JPF.mul_many([(jax_stacked(x), jax_stacked(y)) for x, y in pairs], JTSPEC)
    assert all(_same(g, w) for g, w in zip(got, want))
    p = TSPEC.modulus
    assert _host_t(got[0]) == [a1[3 * i + j] * b1[i] % p for i in range(2) for j in range(3)]
    assert _host_t(got[1]) == [x * y % p for x, y in zip(a2, b2)]


# --- dispatch against the oracle -------------------------------------------------

def _mont(vals, spec) -> torch.Tensor:
    R = 1 << 16 * spec.num_limbs
    return port(stacked([v * R % spec.modulus for v in vals], spec.num_limbs))


def _plain(t: torch.Tensor, spec) -> list:
    rinv = pow(1 << 16 * spec.num_limbs, -1, spec.modulus)
    return [v * rinv % spec.modulus for v in limbs_to_ints(t.T.numpy())]


@pytest.mark.parametrize("field", ["fp", "fr"])
def test_fp_inv_matches_oracle(field):
    spec = SPECS[field][0]
    p = spec.modulus
    vals = [0, 1, p - 1] + [random.Random(3).randrange(1, p) for _ in range(3)]
    got = _plain(D.fp_inv(_mont(vals, spec), spec), spec)
    assert got == [0 if v == 0 else pow(v, -1, p) for v in vals]


def test_fp_inv_matches_jax_dispatch():
    """The Fp inverse of `ops/dispatch.py` (one K7-inv launch on the card)
    limb for limb against JAX `ops/dispatch.fp_inv` (its `lax.scan` of
    products) on the same limbs: 0, 1, R mod p (Montgomery one), p - 1 and
    random canonical values, in a (24, 2, 4) batch."""
    p = FP.modulus
    rng = random.Random(5)
    vals = [0, 1, (1 << 384) % p, p - 1] + [rng.randrange(p) for _ in range(4)]
    x = stacked(vals, 24)
    got = D.fp_inv(port(x).reshape(24, 2, 4))
    want = np.asarray(JD.fp_inv(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    assert got.shape == (24, 2, 4)
    assert (got.reshape(24, 8).numpy().astype(np.int64) == want).all()
    assert want[:, 0].sum() == 0  # 0 -> 0


def test_fp_sqrt_candidate_and_mul_small_match_oracle():
    p = FP.modulus
    rng = random.Random(4)
    roots = [rng.randrange(p) for _ in range(4)]
    squares = [r * r % p for r in roots] + [rng.randrange(p)]
    cand = _plain(D.fp_sqrt_candidate(_mont(squares, FP)), FP)
    assert all(c * c % p == s for c, s in zip(cand[:4], squares[:4]))
    assert cand == [pow(s, (p + 1) // 4, p) for s in squares]
    twelve = _plain(D.fp_mul_small(_mont(squares, FP), 12), FP)
    assert twelve == [12 * s % p for s in squares]


@pytest.mark.parametrize("bad", ["limbs", "dtype", "device"])
def test_strict_wrappers_reject_what_the_kernels_do_not_take(bad):
    """Only (L, *batch) int32 operands on one device reach a strict kernel;
    a meta tensor (neither CPU nor CUDA) raises instead of falling back."""
    a = torch.zeros((24, 4), dtype=torch.int32)
    b = torch.zeros((24, 4), dtype=torch.int32)
    if bad == "limbs":
        b = torch.zeros((16, 4), dtype=torch.int32)
    elif bad == "dtype":
        a = a.long()
    else:
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises(ValueError):
        SF.mont_mul(a, b, FP)
