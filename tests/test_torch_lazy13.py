"""The port's stacked lazy radix-13 engine against the JAX engine, digit for
digit (exact equality: all of it is integer arithmetic).

Inputs are made with numpy from a seed and fed to both packages: the JAX
engine as lists of per-digit arrays, the port as stacked int32 tensors.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ark_blst_tpu.ops import fieldops as JFO
from ark_blst_tpu.ops import lazy13 as JLZ
from ark_blst_tpu_torch.ops import fieldops as FO
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.oracle.field import P

F = LZ.F_BOUND
N = 24  # batch


def jx(mat):
    """(n, batch) numpy -> JAX digit list."""
    return [jnp.asarray(row) for row in np.asarray(mat)]


def tt(mat):
    return torch.from_numpy(np.ascontiguousarray(mat, dtype=np.int32))


def same(port, jax_list):
    got = port.numpy()
    want = np.stack([np.asarray(x) for x in jax_list]).astype(np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (got.astype(np.int64) == want).all()


def mulready(seed, n=N):
    """Random mul-ready digits plus the adversarial patterns of
    test_lazy13.test_mul_wide_f_exact_extremes."""
    rng = np.random.default_rng(seed)
    pats = [
        [F] * 30,
        [-F] * 30,
        [F if k % 2 else -F for k in range(30)],
        [0] * 29 + [F],
        [F] + [0] * 29,
    ]
    rnd = rng.integers(-F, F + 1, (n - len(pats), 30))
    return np.concatenate([np.array(pats), rnd]).T.astype(np.int32)  # (30, n)


def canonical(seed, n=N):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 8192, (30, n)).astype(np.int32)
    m[:, 0] = 8191  # all-max digits: test_worst_case_column_bound
    edge = JLZ.int_to_digits((JLZ.R13 >> 1) - 1)  # the |input| < R13/2 edge
    m[:, 1] = edge
    return m


def relaxed(seed, n_digits, bound, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(-bound, bound, (n_digits, n)).astype(np.int32)


def test_constants_match():
    assert LZ.P_DIGITS == JLZ.P_DIGITS
    assert LZ.NINV_DIGITS == JLZ.NINV_DIGITS
    assert LZ.ONE13 == JLZ.ONE13
    assert LZ._POS_SHIFT == JLZ._POS_SHIFT and LZ._POS_SHIFT2 == JLZ._POS_SHIFT2
    assert (LZ.R13, LZ.R13_MOD_P, LZ.R13_SQ, LZ.NINV13) == (
        JLZ.R13, JLZ.R13_MOD_P, JLZ.R13_SQ, JLZ.NINV13)


def test_int32_semantics():
    """The engine leans on int32 wraparound, arithmetic >> and
    two's-complement &; pin each one in PyTorch."""
    big = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32)
    assert (big + torch.tensor([1, -1], dtype=torch.int32)).tolist() == [-(2**31), 2**31 - 1]
    neg = torch.tensor([-5, -8192, -1, -(2**30) - 7], dtype=torch.int32)
    assert (neg >> 13).tolist() == [v >> 13 for v in neg.tolist()]  # floor shift
    assert (neg & 8191).tolist() == [v & 8191 for v in neg.tolist()]  # two's complement
    # the fold identity d = lo + 2^13 * carry holds for every signed d
    d = torch.from_numpy(np.random.default_rng(5).integers(-(2**31) + 4096, 2**31 - 4096, 1000)
                         .astype(np.int32))
    u = d + 4096
    lo, hi = (u & 8191) - 4096, u >> 13
    assert torch.equal(lo.long() + (hi.long() << 13), d.long())
    assert int(lo.min()) >= -4096 and int(lo.max()) <= 4095


@pytest.mark.parametrize("n_digits,bound", [(30, 2**30), (59, 2**31 - 8192), (61, 4129 * 12)])
def test_fold_family(n_digits, bound):
    t = relaxed(n_digits, n_digits, bound)
    same(LZ.fold(tt(t)), JLZ.fold(jx(t)))
    same(LZ.fold(tt(t), 30), JLZ.fold(jx(t), 30))
    same(LZ.fold(tt(t), n_digits + 3), JLZ.fold(jx(t), n_digits + 3))
    same(LZ.fold2(tt(t)), JLZ.fold2(jx(t)))
    same(LZ.fold2(tt(t), 30), JLZ.fold2(jx(t), 30))
    same(LZ.fold_sum(tt(t)), JLZ.fold_sum(jx(t)))
    nn = np.abs(t)  # fold_nn's domain: nonneg or nearly so
    same(LZ.fold_nn(tt(nn)), JLZ.fold_nn(jx(nn)))
    same(LZ.fold_nn(tt(t)), JLZ.fold_nn(jx(t)))


def test_add_sub_neg_scale_select():
    a, b = mulready(1), relaxed(2, 33, 9000)
    same(LZ.add(tt(a), tt(b)), JLZ.add(jx(a), jx(b)))
    same(LZ.sub(tt(a), tt(b)), JLZ.sub(jx(a), jx(b)))
    same(LZ.sub(tt(b), tt(a)), JLZ.sub(jx(b), jx(a)))
    same(LZ.neg(tt(a)), JLZ.neg(jx(a)))
    same(LZ.scale(tt(a), 12), JLZ.scale(jx(a), 12))
    mask = np.random.default_rng(3).integers(0, 2, N).astype(bool)
    same(LZ.select(torch.from_numpy(mask), tt(a), tt(b)),
         JLZ.select(jnp.asarray(mask), jx(a), jx(b)))


@pytest.mark.parametrize("kind", ["mulready", "mixed", "self"])
def test_mul_wide_vs_karatsuba(kind):
    """The port's schoolbook columns equal the JAX hybrid Karatsuba and the
    JAX schoolbook: all are the true convolution."""
    a = mulready(10)
    b = {"mulready": mulready(11), "mixed": np.full((30, N), F, np.int32), "self": a}[kind]
    got = LZ.mul_wide(tt(a), tt(b))
    same(got, JLZ.mul_wide_f(jx(a), jx(b)))
    same(got, JLZ.mul_wide(jx(a), jx(b)))


def test_mul_wide_canonical_extremes():
    a, b = canonical(12), canonical(13)
    same(LZ.mul_wide(tt(a), tt(b)), JLZ.mul_wide(jx(a), jx(b)))
    v = LZ.digits_to_int(a[:, 0])
    assert LZ.digits_to_ints(LZ.mul_wide(tt(a[:, :1]), tt(a[:, :1]))) == [v * v]


@pytest.mark.parametrize("cname", ["p", "one", "max"])
def test_mul_const_wide(cname):
    cd = {"p": LZ.P_DIGITS, "one": LZ.ONE13, "max": [8191] * 30}[cname]
    a = mulready(20)
    got = LZ.mul_const_wide(tt(a), cd)
    same(got, JLZ.mul_const_wide_f(jx(a), cd))
    same(got, JLZ.mul_const_wide(jx(a), cd))
    c = canonical(21)
    same(LZ.mul_const_wide(tt(c), cd), JLZ.mul_const_wide(jx(c), cd))


@pytest.mark.parametrize("out_len", [30, 17])
def test_mul_low_const(out_len):
    t = relaxed(30, 32, 4104)
    same(LZ.mul_low_const(tt(t), LZ.NINV_DIGITS, out_len),
         JLZ.mul_low_const(jx(t), JLZ.NINV_DIGITS, out_len))


def test_prered_and_reduce_wide_of_combinations():
    a, b, c, d = mulready(40), mulready(41), mulready(42), mulready(43)
    w1p = LZ.prered(LZ.mul_wide(tt(a), tt(b)))
    w2p = LZ.prered(LZ.mul_wide(tt(c), tt(d)))
    w1j = JLZ.prered(JLZ.mul_wide_f(jx(a), jx(b)))
    w2j = JLZ.prered(JLZ.mul_wide_f(jx(c), jx(d)))
    same(w1p, w1j)
    same(LZ.reduce_wide(LZ.sub(w1p, w2p)), JLZ.reduce_wide(JLZ.sub(w1j, w2j)))
    # the 12-fold combination contract edge
    tp, tj = w1p, w1j
    for _ in range(11):
        tp, tj = LZ.add(tp, w1p), JLZ.add(tj, w1j)
    same(LZ.reduce_wide(tp), JLZ.reduce_wide(tj))


@pytest.mark.parametrize("seed", [50, 51])
def test_mont_mul(seed):
    a, b = mulready(seed), mulready(seed + 100)
    got = LZ.mont_mul(tt(a), tt(b))
    same(got, JLZ.mont_mul(jx(a), jx(b)))
    r_inv = pow(LZ.R13, -1, P)
    rows = zip(LZ.digits_to_ints(got), LZ.digits_to_ints(tt(a)), LZ.digits_to_ints(tt(b)))
    for g, x, y in rows:
        assert g % P == x * y * r_inv % P


def test_mont_mul_canonical_edge():
    """test_worst_case_column_bound: the edge value through a schoolbook
    product and one reduction, held against the JAX schoolbook path."""
    c = canonical(60)
    same(LZ.mont_mul(tt(c), tt(c)), JLZ.reduce_wide(JLZ.prered(JLZ.mul_wide(jx(c), jx(c)))))


@pytest.mark.parametrize("cname", ["r16", "one"])
def test_mont_mul_const(cname):
    from ark_blst_tpu.curves.msm_pallas2 import R16_DIGITS

    cd = {"r16": R16_DIGITS, "one": LZ.ONE13}[cname]
    a = mulready(70)
    same(LZ.mont_mul_const(tt(a), cd), JLZ.mont_mul_const(jx(a), cd))


def test_store30():
    d = np.random.default_rng(80).integers(-7 * 4096, 7 * 4096, (30, N)).astype(np.int32)
    same(LZ.store30(tt(d)), JLZ.store30(jx(d)))


def _strict_limbs(seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P for _ in range(N - 3)]
    return vals, np.stack([JLZ.int_to_digits(v, 30) for v in vals]).T


def test_from_limbs16_and_back():
    from ark_blst_tpu.ops.limbs import ints_to_limbs

    vals, _ = _strict_limbs(90)
    a16 = ints_to_limbs(vals, 24).T.astype(np.int32)  # (24, N)
    d = LZ.from_limbs16(tt(a16))
    same(d, JLZ.from_limbs16(jx(a16.astype(np.uint32))))
    assert LZ.digits_to_ints(d) == vals
    back = LZ.to_limbs16_strict(d)
    same(back, JLZ.to_limbs16_strict(jx(d.numpy())))
    assert (back.numpy() == a16).all()


@pytest.mark.parametrize("shift", [0, -5, 3])
def test_canonicalize(shift):
    """Redundant signed elements (value shifted by shift*p) -> strict
    canonical digits, against JAX and against value mod p."""
    vals, digs = _strict_limbs(100 + shift)
    x = JLZ.fold2(JLZ.add(jx(digs), [jnp.int32(v) for v in JLZ.int_to_digits(abs(shift) * P)])
                  if shift >= 0 else
                  JLZ.sub(jx(digs), [jnp.int32(v) for v in JLZ.int_to_digits(-shift * P)]))
    xm = np.stack([np.asarray(v) for v in x])[:30]
    got = LZ.canonicalize(tt(xm))
    same(got, JLZ.canonicalize(jx(xm)))
    assert LZ.digits_to_ints(got) == [v % P for v in vals]


def test_normalize_list_and_is_zero():
    rng = np.random.default_rng(110)
    t = rng.integers(0, 2**31 - 1, (26, N)).astype(np.int32)
    t[:, 0] = 0xFFFF  # long propagate chain
    t[0, 0] = 0x1FFFF
    for out_len in (26, 27, 30):
        same(FO.normalize_list(tt(t), out_len), JFO.normalize_list(jx(t.astype(np.uint32)), out_len))
    z = np.zeros((24, 4), np.int32)
    z[3, 1] = 1
    assert FO.is_zero(tt(z)).tolist() == np.asarray(JFO.is_zero(jnp.asarray(z))).tolist()
