"""The CUDA kernels on the card against their plain PyTorch versions, and the
G1 and G2 MSMs, the strict engine's scan MSM (its three chains, scan-acc's
three launches among them, scan-red's and scan-horner's edge cases and
launch shapes, scan-mul and `msm_naive`'s one scan-mul launch, `-k scan`)
and the batched pairing (fused, unfused, and strict on both routes: the
chains on strict limbs with the multi-pairings' fold on K4's strict limbs,
`-k strict`, and K7-K10 with the K7-inv inversion) on the card against the
host oracle; the arkworks API's
device routes against the checked-in vectors and its host route; the
sharded MSMs and multi-pairing in a world of one over NCCL (`-k
distributed`).
Needs an NVIDIA Hopper card and
nvcc; skipped without a card. Imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch import G1, G2
from ark_blst_tpu_torch import bls12 as B
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.curves.instance import distinct_bases
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
from ark_blst_tpu_torch.ops import fp12_sqr as K11
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import scan_msm as SM
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.ops.limbs import FP, FR, FieldSpec, ints_to_limbs, limbs_to_ints
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

pytestmark = pytest.mark.cuda

F = LZ.F_BOUND


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def test_k1_bit_equal_to_plain(dev):
    rng = np.random.default_rng(1)
    n = 1 << 16
    a = rng.integers(-F, F + 1, (30, n)).astype(np.int32)
    b = rng.integers(-F, F + 1, (30, n)).astype(np.int32)
    a[:, 0], b[:, 0] = F, F
    a[:, 1], b[:, 1] = -F, -F
    a[:, 2], b[:, 2] = 8191, 8191  # canonical x canonical
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    before = MM.KERNEL.launches
    got = MM.mont_mul(at, bt)
    torch.cuda.synchronize()
    assert MM.KERNEL.launches == before + 1
    assert torch.equal(got, MM.mont_mul_plain(at, bt))


def _inv_value(x: int) -> int:
    """R13^2 X^-1 mod p: the Montgomery inverse of a digit value X."""
    return pow(x, -1, OF.P) * LZ.R13_SQ % OF.P if x % OF.P else 0


def _fp_values_equal(got, want):
    """K1-inv and K1-scan (32-bit words inside) against their plain
    versions: the same field element in every column, the kernel's digits
    within 4096."""
    assert int(got.abs().max()) <= 4096
    assert torch.equal(LZ.canonicalize_rows(got[None]), LZ.canonicalize_rows(want[None]))


@pytest.mark.parametrize("n", [1, 1024, 8192])
def test_k1_inv_value_equal_to_plain(dev, n):
    """The Fermat ladder at the widths the paths give it (a multi-pairing,
    the MSM's root, the pairing batch), X = 0, 1, p-1 and R mod p in the
    first lanes, one launch; a sample against R13^2 X^-1 mod p."""
    x = torch.from_numpy(np.random.default_rng(n).integers(-F, F + 1, (30, n)).astype(np.int32))
    for col, v in enumerate((0, 1, OF.P - 1, (1 << 384) % OF.P)[:n]):
        x[:, col] = torch.from_numpy(LZ.int_to_digits(v))
    x = x.to(dev)
    got = _launched_once(FI.KERNEL_INV, lambda: FI.fp_inv(x))
    _fp_values_equal(got, FI.fp_inv_plain(x))
    sample = slice(0, 16)
    want = [_inv_value(v) for v in LZ.digits_to_ints(x[:, sample])]
    assert [v % OF.P for v in LZ.digits_to_ints(got[:, sample])] == want


@pytest.mark.parametrize("g,m", [(64, 1024), (8, 375)])
def test_k1_scan_value_equal_to_plain(dev, g, m):
    """One level of the batch inversion: the up pass's column products and
    the down pass's inverses by value against the plain passes (the prefix
    products are each version's own scratch), one launch each; a CUDA
    operand that is not contiguous is refused."""
    rng = np.random.default_rng(g)
    z = torch.from_numpy(rng.integers(-F, F + 1, (30, g * m)).astype(np.int32)).to(dev)
    pre, total = _launched_once(FI.KERNEL_UP, lambda: FI.scan_up(z, g))
    pre_plain, total_plain = FI.scan_up_plain(z, g)
    _fp_values_equal(total, total_plain)
    inv_total = FI.fp_inv_plain(total_plain)
    got = _launched_once(FI.KERNEL_DOWN, lambda: FI.scan_down(z, pre, inv_total, g))
    _fp_values_equal(got, FI.scan_down_plain(z, pre_plain, inv_total, g))
    want = [_inv_value(v) for v in LZ.digits_to_ints(z[:, :16])]
    assert [v % OF.P for v in LZ.digits_to_ints(got[:, :16])] == want
    with pytest.raises(ValueError, match="contiguous"):
        FI.scan_up(z.t().contiguous().t(), g)


def test_batch_inverse_on_card(dev):
    """2^18 elements: two levels (m = 4096, then 64) and the ladder at 64,
    by value against the plain version; two launches of each pass and one
    ladder."""
    rng = np.random.default_rng(18)
    z = torch.from_numpy(rng.integers(-F, F + 1, (30, 1 << 18)).astype(np.int32)).to(dev)
    kernels = (FI.KERNEL_UP, FI.KERNEL_DOWN, FI.KERNEL_INV, MM.KERNEL)
    before = [k.launches for k in kernels]
    got = FI.batch_inverse(z)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 1, 0]
    _fp_values_equal(got, FI.batch_inverse_plain(z))


def test_msm_and_pairing_k1_launches(dev):
    """A G1 MSM at 2^18 and a pairing batch of 64 on the card against the
    oracle, with their K1-family launches: the MSM's prepare 2 products,
    one ladder, two levels of the scan (2 + 2); the batch none, its final
    exponentiation's inverse and Frobenius maps inside FE-easy and FE-hard
    (was 994 and 644 launches of K1 alone, then 36 products and one
    ladder a batch)."""
    kernels = (MM.KERNEL, FI.KERNEL_INV, FI.KERNEL_UP, FI.KERNEL_DOWN)
    points, scalars, expected = distinct_bases(18, 5, dev, "g1")
    before = [k.launches for k in kernels]
    out = T.msm_g1(points, scalars, device=dev)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 1, 2, 2]
    assert CV.g1_from_dev(out) == [expected]
    rng = random.Random(9)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(64)]
    qb = [qs[(i + 2) % 4] for i in range(64)]
    before = [k.launches for k in kernels]
    got = B.pairing_batch(pb, qb, device=dev)
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 0, 0]
    want = {i: OP.pairing(ps[i], qs[(i + 2) % 4]) for i in range(4)}
    assert got == [want[i % 4] for i in range(64)]


def test_k2_bucket_equal_to_plain(dev):
    """K2 (G1) against its plain versions on 2048 real points at c = 4: the
    point conversion bit for bit, the bucket kernel (32-bit Montgomery
    words) against the radix-13 digits by value, bucket for bucket; one
    launch of each kernel."""
    c = 4
    points, scalars, _ = distinct_bases(11, 2, dev, "g1")
    pts, digs = MB._prepare_inputs(MB.KC2_G1, points, scalars, c)
    assert torch.equal(MB.point_words(MB.KC2_G1, pts), MB.point_words_plain(MB.KC2_G1, pts))
    before = (MB.KERNEL_G1_WORDS.launches, MB.KERNEL.launches)
    got = MB.accumulate(MB.KC2_G1, pts, digs, c)
    torch.cuda.synchronize()
    assert (MB.KERNEL_G1_WORDS.launches, MB.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert MB.max_dump_digit(got) <= 4096
    want = MB.accumulate_plain(MB.KC2_G1, pts, digs, c)
    assert torch.equal(MB.dump_values(MB.KC2_G1, got), MB.dump_values(MB.KC2_G1, want))


def test_msm_on_card_matches_oracle(dev):
    rng = random.Random(3)
    base = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(8)]
    pts = [base[i % 8] for i in range(3000)]
    scs = [rng.randrange(OF.R) for _ in range(3000)]
    pts[10], scs[11] = None, 0
    agg = [0] * 8
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 8] += s
    want = OC.msm(base, agg)
    assert G1.msm(pts, scs, device=dev) == want


def test_k2_g2_bucket_equal_to_plain(dev):
    """K2-G2 against its plain versions on 2048 real points at c = 4: the
    point conversion bit for bit, the bucket kernel (32-bit Montgomery
    words) against the radix-13 digits by value, bucket for bucket."""
    c = 4
    points, scalars, _ = distinct_bases(11, 12, dev, "g2")
    pts, digs = MB._prepare_inputs(MB.KC2_G2, points, scalars, c)
    assert torch.equal(MB.point_words(MB.KC2_G2, pts), MB.point_words_plain(MB.KC2_G2, pts))
    before = (MB.KERNEL_G2_WORDS.launches, MB.KERNEL_G2.launches)
    got = MB.accumulate(MB.KC2_G2, pts, digs, c)
    torch.cuda.synchronize()
    assert (MB.KERNEL_G2_WORDS.launches, MB.KERNEL_G2.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    want = MB.accumulate_plain(MB.KC2_G2, pts, digs, c)
    assert torch.equal(MB.dump_values(MB.KC2_G2, got), MB.dump_values(MB.KC2_G2, want))


def test_g2_msm_on_card_matches_oracle(dev):
    rng = random.Random(13)
    base = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pts = [base[i % 4] for i in range(1500)]
    scs = [rng.randrange(OF.R) for _ in range(1500)]
    pts[10], scs[11] = None, 0
    agg = [0] * 4
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 4] += s
    before = (MM.KERNEL.launches, MB.KERNEL_G2.launches)
    assert G2.msm(pts, scs, device=dev) == OC.g2_msm(base, agg)
    assert MM.KERNEL.launches > before[0] and MB.KERNEL_G2.launches == before[1] + 1


def test_msm_g2_on_cpu_tensors_launches_nothing(dev):
    pts = [OC.g2_mul(OF.G2_GEN, k) for k in (3, 5)]
    before = (MM.KERNEL.launches, MB.KERNEL_G2.launches)
    out = T.msm_g2(CV.g2_to_dev(pts), CV.fr_to_dev([7, 11]), device="cpu", c=3)
    assert (MM.KERNEL.launches, MB.KERNEL_G2.launches) == before
    assert CV.g2_from_dev(out) == [OC.g2_msm(pts, [7, 11])]


def _stack(rng, rows, n, dev, top=None):
    """(rows, 30, n) mul-ready digits with the extreme patterns in the first
    columns; with `top`, the top digit redrawn in [-top, top] in every
    column (the patterns kept in the other 29)."""
    a = rng.integers(-F, F + 1, (rows, 30, n)).astype(np.int32)
    for i, pattern in enumerate([F, -F, 8191, [F if k % 2 else -F for k in range(30)]][:n]):
        a[:, :, i] = pattern
    if top is not None:
        a[:, 29, :] = rng.integers(-top, top + 1, (rows, n))
    return torch.from_numpy(a).to(dev)


# The random operands of K4-K6, K11 and K12 keep |value| < 101 * 2^377 <
# 8p, the lazy engine's mul-ready domain, where their plain versions are
# field operations (their folds truncate values near 2^390; K3's plain
# version contracts its input first).
TOP_8P = 100


def _value_equal(got, want):
    """K3-K6, K11 and K12 (32-bit words inside) against their plain
    versions: the same field element in every Fp row, the kernel's digits
    within 4096."""
    assert int(got.abs().max()) <= 4096
    assert torch.equal(LZ.canonicalize_rows(got), LZ.canonicalize_rows(want))


def _launched_once(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("nsq", [1, 32])
def test_k3_value_equal_to_plain(dev, nsq):
    x = _stack(np.random.default_rng(4), 12, 1024, dev)
    got = _launched_once(K3.KERNEL, lambda: K3.cyc_sqr(x, nsq))
    _value_equal(got, K3.cyc_sqr_plain(x, nsq))


@pytest.mark.parametrize("n", [1024, 37, 1])
def test_k4_value_equal_to_plain(dev, n):
    """Also ragged and single-element blocks, as `_fold_mul` launches it."""
    rng = np.random.default_rng(5)
    a, b = _stack(rng, 12, n, dev, top=TOP_8P), _stack(rng, 12, n, dev, top=TOP_8P)
    got = _launched_once(K4.KERNEL, lambda: K4.fp12_mul(a, b))
    _value_equal(got, K4.fp12_mul_plain(a, b))


def _words(rng, n, dev):
    """(12, 12, n) canonical words of random values below 8p (the digits of
    `_stack` to words), one and zero in the first columns."""
    w = W.digits_to_words_plain(_stack(rng, 12, n, "cpu", top=TOP_8P))
    w[..., :1] = PR._fp12_one_words("cpu")
    w[..., 1:2] = 0
    return w.to(dev)


@pytest.mark.parametrize("out", ["words", "limbs"])
@pytest.mark.parametrize("n", [1024, 37, 1])
def test_k4_word_layouts_equal_to_plain(dev, n, out):
    """K4 on the multi-pairings' word edges (words -> words, words -> strict
    limbs), one launch of its own layout, at the fold's widths and ragged:
    word for word and limb for limb against its plain version, and against
    the digit layout's product of the same values (K4 on the words'
    digits), the limbs through the lazy egress."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    rng = np.random.default_rng(8)
    a, b = _words(rng, n, dev), _words(rng, n, dev)
    kernel = K4.KERNEL_WORDS if out == "words" else K4.KERNEL_LIMBS
    got = _launched_once(kernel, lambda: K4.fp12_mul(a, b, out=out))
    assert got.shape == (12, W.WORDS if out == "words" else 24, n)
    assert torch.equal(got, K4.fp12_mul_plain(a, b, out))
    digits = K4.fp12_mul(W.words_to_digits_plain(a), W.words_to_digits_plain(b))
    if out == "words":
        assert torch.equal(got, W.digits_to_words_plain(digits))
    else:
        assert torch.equal(got, torch.stack(TL._flat12(TL.fp12_egress(TL.unstack12(digits)))))


@pytest.mark.parametrize("n", [1024, 37, 1])
def test_k4_strict_limbs_equal_to_plain(dev, n):
    """K4 limbs -> limbs (the strict engine's multi-pairings' fold), one
    launch of its own layout, at the fold's widths and ragged: limb for
    limb against its plain version and the strict tower's `fp12_mul` on
    the same limbs; one column of limbs above p (2^384 - 1, loaded
    reduced)."""
    from ark_blst_tpu_torch.ops import tower as TS
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    rng = np.random.default_rng(9)
    a, b = W.words_to_limbs_plain(_words(rng, n, dev)), W.words_to_limbs_plain(_words(rng, n, dev))
    got = _launched_once(K4.KERNEL_LIMBS_LIMBS, lambda: K4.fp12_mul(a, b))
    assert got.shape == (12, 24, n)
    assert torch.equal(got, K4.fp12_mul_plain(a, b, "limbs"))
    assert torch.equal(got, TL.stack12(TS.fp12_mul(TL.unstack12(a), TL.unstack12(b))))
    a[..., -1:] = 0xFFFF
    got = _launched_once(K4.KERNEL_LIMBS_LIMBS, lambda: K4.fp12_mul(a, b))
    assert torch.equal(got, K4.fp12_mul_plain(a, b, "limbs"))


def test_strict_multi_pairings_fold_on_k4_limbs(dev):
    """The strict fused multi-pairings on the card at N = 40 (an identity on
    each side): K4 limbs -> limbs ceil(log2 N) = 6 times, K5-chain and
    K6-chain on strict limbs once, no K7-K10 launch; `multi_pairing` (with
    FE-easy on limbs and FE-hard once) and `multi_miller_loop_prepared`
    against the oracle's products, limb for limb the unfused route's."""
    rng = random.Random(30)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb, qb = [ps[i % 4] for i in range(40)], [qs[(i + 1) % 4] for i in range(40)]
    pb[3], qb[6] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    kernels = (K4.KERNEL_LIMBS_LIMBS, PS.PREPARE_KERNEL_LIMBS, PS.MILLER_KERNEL_LIMBS,
               FE.KERNEL_EASY_LIMBS, FE.KERNEL_HARD, *SF.KERNELS.values())

    def launches(fn):
        before = [k.launches for k in kernels]
        out = fn()
        torch.cuda.synchronize()
        return out, [k.launches - b for k, b in zip(kernels, before)]

    mlo = OP.multi_miller_loop([(a, b) for a, b in zip(pb, qb) if a and b])
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    got, k = launches(lambda: PR.multi_pairing(p, q, p_inf, q_inf, engine="strict"))
    assert k == [6, 1, 1, 1, 1, 0, 0, 0, 0]
    assert CV.fp12_from_dev(got) == [OP.final_exp(mlo)]
    unfused = PR.multi_pairing(p, q, p_inf, q_inf, fuse=False, engine="strict")
    assert all(torch.equal(x, y) for x, y in zip(flat(got), flat(unfused)))
    prep = PR.prepare_g2_device(q, q_inf, engine="strict")
    got, k = launches(lambda: PR.multi_miller_loop_prepared(p, prep, p_inf))
    assert k == [6, 0, 1, 0, 0, 0, 0, 0, 0]
    assert CV.fp12_from_dev(got) == [mlo]


def test_multi_pairings_fold_on_words(dev, monkeypatch):
    """The multi-pairings on the card: K6-chain storing conj(f) as words
    (never f as digits), the fold on K4's word layouts, ceil(log2 N)
    launches, `multi_miller_loop`'s last level storing the strict limbs
    (at N = 1 one launch against one), no digit K4 and no egress; the
    results equal the oracle's products, identity pairs one."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    rng = random.Random(28)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb, qb = [ps[i % 4] for i in range(40)], [qs[(i + 1) % 4] for i in range(40)]
    pb[3], qb[6] = None, None
    formats = []
    miller_lines = PS.miller_lines

    def spy(coeffs, p, schedule, f_fmt=PS.FMT_DIGITS):
        formats.append(f_fmt)
        return miller_lines(coeffs, p, schedule, f_fmt)

    def no_egress(*args, **kwargs):
        raise AssertionError("the lazy egress ran")

    monkeypatch.setattr(PS, "miller_lines", spy)
    monkeypatch.setattr(PR, "egress", no_egress)
    monkeypatch.setattr(TL, "fp12_egress", no_egress)
    kernels = (K4.KERNEL, K4.KERNEL_WORDS, K4.KERNEL_LIMBS, FE.KERNEL_EASY, FE.KERNEL_HARD)

    def launches(fn):
        before = [k.launches for k in kernels]
        out = fn()
        torch.cuda.synchronize()
        return out, [k.launches - b for k, b in zip(kernels, before)]

    for n in (40, 1):
        pairs = [(a, b) for a, b in zip(pb[:n], qb[:n]) if a and b]
        mlo = OP.multi_miller_loop(pairs)
        got, k = launches(lambda: B.multi_miller_loop(pb[:n], qb[:n], device=dev))
        assert got == mlo and k == [0, (n - 1).bit_length() - 1 if n > 1 else 0, 1, 0, 0], n
        (p, p_inf), (q, q_inf) = B._g1_batch(pb[:n], dev), B._g2_batch(qb[:n], dev)
        prep = PR.prepare_g2_device(q, q_inf)
        got, k = launches(lambda: PR.multi_miller_loop_prepared(p, prep, p_inf))
        assert CV.fp12_from_dev(got) == [mlo] and k[0] == 0 and k[2] == 1, n
        got, k = launches(lambda: B.multi_pairing(pb[:n], qb[:n], device=dev))
        assert got == OP.final_exp(mlo) and k == [0, (n - 1).bit_length(), 0, 1, 1], n
    assert formats == [PS.FMT_WORDS] * 6


@pytest.mark.parametrize("is_add", [False, True])
def test_k5_value_equal_to_plain(dev, is_add):
    rng = np.random.default_rng(6)
    r = _stack(rng, 6, 1024, dev, top=TOP_8P)
    q = _stack(rng, 4, 1024, dev, top=TOP_8P) if is_add else None
    got = _launched_once(PS.PREPARE_KERNEL, lambda: PS.prepare_step(r, q))
    _value_equal(got, PS.prepare_step_plain(r, q))


@pytest.mark.parametrize("with_sqr", [False, True])
def test_k6_value_equal_to_plain(dev, with_sqr):
    rng = np.random.default_rng(7)
    f, c, pxy = (_stack(rng, r, 1024, dev, top=TOP_8P) for r in (12, 6, 2))
    got = _launched_once(PS.MILLER_KERNEL, lambda: PS.miller_step(f, c, pxy, with_sqr))
    _value_equal(got, PS.miller_step_plain(f, c, pxy, with_sqr))


def _real_pairs(dev, n, seed):
    """n pairs of 4 distinct (P, Q) as the pipeline ingests them: the Q
    stack (4, 30, n), P (2, 30, n) and the affine points."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    rng = random.Random(seed)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    (p, _), (q, _) = B._g1_batch([ps[i % 4] for i in range(n)], dev), \
        B._g2_batch([qs[(i + 1) % 4] for i in range(n)], dev)
    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    pxy = torch.stack([TL.fp_ingest(p[0]), TL.fp_ingest(p[1])])
    return torch.stack([qx[0], qx[1], qy[0], qy[1]]), pxy, ps, qs


def test_chains_value_equal_to_plain_ragged(dev):
    """K5-chain and K6-chain over all 68 events at a ragged N (1000 = 31
    blocks of 32 and one of 8), one launch each, by value against their
    plain versions (K6's on the kernel's lines); f against the oracle's
    Miller loop on the four distinct pairs."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    n, sched = 1000, PR.MILLER_EVENTS
    q, pxy, ps, qs = _real_pairs(dev, n, 20)
    coeffs = _launched_once(PS.PREPARE_KERNEL, lambda: PS.prepare_chain(q, sched))
    assert coeffs.shape == (68, 6, 30, n)
    _value_equal(coeffs.reshape(-1, 30, n), PS.prepare_chain_plain(q, sched).reshape(-1, 30, n))
    f = TL.stack12(PR._fp12_one_like(pxy[0]))
    got = _launched_once(PS.MILLER_KERNEL, lambda: PS.miller_chain(f, coeffs, pxy, sched))
    _value_equal(got, PS.miller_chain_plain(f, coeffs, pxy, sched))
    vals = CV.fp12_from_dev(TL.fp12_egress(TL.unstack12(PR._conj(got[..., :4].contiguous()))))
    assert vals == [OP.miller_loop(ps[i], qs[(i + 1) % 4]) for i in range(4)]


def test_edge_chains_value_equal_to_plain_ragged(dev):
    """The fused pipeline's entries at a ragged N (1000), one launch each:
    `prepare_lines` (strict Q in, R = (Q, 1) formed in K5-chain) word for
    word against its plain version; `miller_lines` (strict P in, f = one
    formed in K6-chain) on those word lines and on their digits by value
    against its plain version, and against the oracle's Miller loop on the
    four distinct pairs."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    n, sched = 1000, PR.MILLER_EVENTS
    rng = random.Random(24)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    (p, _), (q, _) = B._g1_batch([ps[i % 4] for i in range(n)], dev), \
        B._g2_batch([qs[(i + 1) % 4] for i in range(n)], dev)
    lines = _launched_once(PS.PREPARE_KERNEL, lambda: PS.prepare_lines(q, sched))
    assert lines.shape == (68, 6, W.WORDS, n)
    assert torch.equal(lines, PS.prepare_lines_plain(q, sched))
    want = PS.miller_lines_plain(lines, p, sched)
    for c in (lines, W.words_to_digits_plain(lines)):
        got = _launched_once(PS.MILLER_KERNEL, lambda: PS.miller_lines(c, p, sched))
        _value_equal(got, want)
    vals = CV.fp12_from_dev(TL.fp12_egress(TL.unstack12(PR._conj(got[..., :4].contiguous()))))
    assert vals == [OP.miller_loop(ps[i], qs[(i + 1) % 4]) for i in range(4)]


def test_fused_pairing_launches_one_chain_each(dev):
    """A fused batch launches K5, K6, FE-easy and FE-hard once each and no
    K3 or K4, a prepare alone K5 once, a prepared batch K6 and the final
    exponentiation's two chains once, `multi_pairing` each chain once (and
    K4 on words for its product fold, no digit K4); the results equal the
    oracle."""
    rng = random.Random(21)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(40)]
    qb = [qs[(i + 3) % 4] for i in range(40)]
    chains = (PS.PREPARE_KERNEL, PS.MILLER_KERNEL, FE.KERNEL_EASY, FE.KERNEL_HARD, K3.KERNEL,
              K4.KERNEL, K4.KERNEL_WORDS)

    def launches(fn):
        before = [k.launches for k in chains]
        out = fn()
        torch.cuda.synchronize()
        return out, [k.launches - b for k, b in zip(chains, before)]

    want = [OP.pairing(ps[i % 4], qs[(i + 3) % 4]) for i in range(40)]
    got, n = launches(lambda: B.pairing_batch(pb, qb, device=dev))
    assert got == want and n == [1, 1, 1, 1, 0, 0, 0]
    prep, n = launches(lambda: B.prepare_g2_batch(qb, device=dev))
    assert n == [1, 0, 0, 0, 0, 0, 0]
    got, n = launches(lambda: B.pairing_batch(pb, prep, device=dev))
    assert got == want and n == [0, 1, 1, 1, 0, 0, 0]
    got, n = launches(lambda: B.multi_pairing(pb[:8], qb[:8], device=dev))
    assert n == [1, 1, 1, 1, 0, 0, 3]
    assert got == OP.final_exp(OP.multi_miller_loop(list(zip(pb[:8], qb[:8]))))


def test_prepared_layouts_pair_under_either_fuse_on_card(dev):
    """A prepare made fused (words) or unfused (digits) pairs under either
    `fuse`: equal to the oracle, K6 once a fused pairing on either layout,
    K11 and K12 on either layout unfused."""
    rng = random.Random(25)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb, qb = [ps[i % 4] for i in range(16)], [qs[(i + 2) % 4] for i in range(16)]
    pb[1] = None
    want = [OF.FP12_ONE if i == 1 else OP.pairing(ps[i % 4], qs[(i + 2) % 4]) for i in range(16)]
    for prep_fuse, layout in ((True, "words"), (False, "digits")):
        prep = B.prepare_g2_batch(qb, fuse=prep_fuse, device=dev)
        assert prep.layout == layout
        for fuse in (True, False):
            before = [k.launches for k in (PS.MILLER_KERNEL, K12.KERNEL)]
            assert B.pairing_batch(pb, prep, fuse=fuse, device=dev) == want, (layout, fuse)
            after = [k.launches for k in (PS.MILLER_KERNEL, K12.KERNEL)]
            assert [a - b for a, b in zip(after, before)] == ([1, 0] if fuse else [0, 68])


def test_word_route_value_equal_to_plain_ragged(dev):
    """The fused pairing's word route at a ragged N (1000), one launch each:
    K6-chain storing conj(f) as words, FE-easy loading words and FE-hard
    storing strict limbs, word for word and limb for limb against their
    plain versions (words and limbs are canonical); the limbs of the four
    distinct pairs against the oracle's pairing."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    n, sched = 1000, PR.MILLER_EVENTS
    rng = random.Random(26)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    (p, _), (q, _) = B._g1_batch([ps[i % 4] for i in range(n)], dev), \
        B._g2_batch([qs[(i + 1) % 4] for i in range(n)], dev)
    lines = PS.prepare_lines(q, sched)
    f = _launched_once(PS.MILLER_KERNEL, lambda: PS.miller_lines(lines, p, sched, PS.FMT_WORDS))
    assert f.shape == (12, W.WORDS, n)
    assert torch.equal(f, PS.miller_lines_plain(lines, p, sched, PS.FMT_WORDS))
    words = _launched_once(FE.KERNEL_EASY, lambda: FE.easy(f))
    t2 = FE.easy_plain(W.words_to_digits_plain(f))
    assert torch.equal(words, W.digits_to_words_plain(t2))
    got = _launched_once(FE.KERNEL_HARD, lambda: FE.hard(words, out="limbs"))
    assert got.shape == (12, 24, n)
    assert torch.equal(got, FE.hard_limbs_plain(t2))
    vals = CV.fp12_from_dev(TL.unstack12(got[..., :4]))
    assert vals == [OP.pairing(ps[i], qs[(i + 1) % 4]) for i in range(4)]


def test_fused_pairing_runs_no_egress_on_card(dev, monkeypatch):
    """`pairing_batch` (plain and prepared) and `multi_pairing` on the card
    never call the lazy egress: FE-hard stores the strict limbs; the
    results equal the oracle, identity pairs one."""
    rng = random.Random(27)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb, qb = [ps[i % 4] for i in range(24)], [qs[(i + 1) % 4] for i in range(24)]
    pb[3], qb[6] = None, None
    want = [OF.FP12_ONE if i in (3, 6) else OP.pairing(pb[i], qb[i]) for i in range(24)]

    def no_egress(*args, **kwargs):
        raise AssertionError("the lazy egress ran")

    monkeypatch.setattr(PR, "egress", no_egress)
    assert B.pairing_batch(pb, qb, device=dev) == want
    assert B.pairing_batch(pb, B.prepare_g2_batch(qb, device=dev), device=dev) == want
    assert B.pairing_batch(pb, B.prepare_g2_batch(qb, fuse=False, device=dev),
                           device=dev) == want
    assert B.multi_pairing(pb[:8], qb[:8], device=dev) == OP.final_exp(
        OP.multi_miller_loop([(a, b) for a, b in zip(pb[:8], qb[:8]) if a and b]))


def _miller_outputs(dev, n):
    """f of n pairs of 4 distinct (P, Q) as the fused pipeline hands it to
    the final exponentiation (K5-chain, K6-chain, identity pairs masked to
    one: P at column 2, Q at column 5 where n allows), and the pairs."""
    rng = random.Random(23)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(n)]
    qb = [qs[(i + 1) % 4] for i in range(n)]
    if n > 5:
        pb[2], qb[5] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    return PR._masked_miller(p, PR.prepare_g2(q), p_inf, q_inf), pb, qb


@pytest.mark.parametrize("n", [1, 33, 201, 1000])
def test_final_exp_chains_value_equal_to_plain(dev, n):
    """FE-easy and FE-hard, one launch each, on real Miller outputs (with
    identity pairs) at N = 1, 33 (FE-easy's ragged second block), 201
    (FE-hard at two elements a block on an H100's 132 SMs: its last block
    holds one) and 1000, by value
    against their plain versions: FE-easy's words against `easy_plain`'s
    digits, FE-hard on those words and on the words of `easy_plain`'s
    digits (`digits_to_words_plain`) against `hard_plain`; the first columns against the oracle's pairing."""
    f, pb, qb = _miller_outputs(dev, n)
    words = _launched_once(FE.KERNEL_EASY, lambda: FE.easy(f))
    assert words.shape == (12, FE.WORDS, n)
    t2 = FE.easy_plain(f)
    _value_equal(W.words_to_digits_plain(words), t2)
    want = FE.hard_plain(t2)
    got = _launched_once(FE.KERNEL_HARD, lambda: FE.hard(words))
    _value_equal(got, want)
    t2_words = W.digits_to_words_plain(t2)
    _value_equal(_launched_once(FE.KERNEL_HARD, lambda: FE.hard(t2_words)), want)
    cols = min(n, 8)
    vals = CV.fp12_from_dev(PR.egress(got[..., :cols].contiguous()))
    assert vals == [OP.pairing(pb[i], qb[i]) for i in range(cols)]


def _real_f_and_legs(dev):
    """f after three Miller events and the fourth event's line scaled by P
    (`_ell_legs`, K12's rows) as the unfused Miller loop forms them, for 64
    pairs of 4 distinct points."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    rng = random.Random(18)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    (p, _), (q, _) = B._g1_batch([ps[i % 4] for i in range(64)], dev), \
        B._g2_batch([qs[(i + 1) % 4] for i in range(64)], dev)
    coeffs = PR.prepare_g2(q, fuse=False, events=4)  # digits, as the unfused prepare's
    px, py = TL.fp_ingest(p[0]), TL.fp_ingest(p[1])
    pxy = torch.stack([px, py])
    f = TL.stack12(PR._fp12_one_like(px))
    for i in range(3):
        f = PS.miller_step(f, coeffs[i], pxy, True)
    a0, a1, a4 = PS._ell_legs(TL, PR._line(coeffs[3]), px, py)
    return f, torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]])


@pytest.mark.parametrize("source", ["random", "pipeline"])
def test_k11_value_equal_to_plain(dev, source):
    if source == "random":
        a = _stack(np.random.default_rng(15), 12, 1024, dev, top=TOP_8P)
    else:
        a = _real_f_and_legs(dev)[0]
    got = _launched_once(K11.KERNEL, lambda: K11.fp12_sqr(a))
    _value_equal(got, K11.fp12_sqr_plain(a))


@pytest.mark.parametrize("source", ["random", "pipeline"])
def test_k12_value_equal_to_plain(dev, source):
    if source == "random":
        rng = np.random.default_rng(16)
        f, c = _stack(rng, 12, 1024, dev, top=TOP_8P), _stack(rng, 6, 1024, dev, top=TOP_8P)
    else:
        f, c = _real_f_and_legs(dev)
        f = K11.fp12_sqr(f)  # as at a doubling event
    got = _launched_once(K12.KERNEL, lambda: K12.fp12_mul_by_014(f, c))
    _value_equal(got, K12.fp12_mul_by_014_plain(f, c))


def test_unfused_and_strict_pairing_on_card_match_fused(dev):
    """32 pairs with an identity on each side: the unfused pipeline (K11,
    K12, no K5/K6) and the strict engine unfused (K7-K10 and K7-inv, no
    chain) give the fused path's results."""
    rng = random.Random(17)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(32)]
    qb = [qs[(i + 1) % 4] for i in range(32)]
    pb[3], qb[4] = None, None
    fused = B.pairing_batch(pb, qb, device=dev)
    assert fused[5] == OP.pairing(ps[1], qs[2]) and fused[3] == fused[4] == OF.FP12_ONE
    tower = (PS.PREPARE_KERNEL, PS.MILLER_KERNEL, K11.KERNEL, K12.KERNEL)
    before = [k.launches for k in tower]
    assert B.pairing_batch(pb, qb, fuse=False, device=dev) == fused
    assert [k.launches - b for k, b in zip(tower, before)] == [0, 0, 63, 68]


    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    lazy = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, device=dev)
    lazy_kernels = (MM.KERNEL, K3.KERNEL, K4.KERNEL, FE.KERNEL_EASY, FE.KERNEL_HARD) + \
        tower
    before = [k.launches for k in lazy_kernels] + [SF.KERNELS["mont_mul"].launches]
    strict = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, fuse=False, engine="strict", device=dev)
    torch.cuda.synchronize()
    after = [k.launches for k in lazy_kernels] + [SF.KERNELS["mont_mul"].launches]
    assert after[:-1] == before[:-1] and after[-1] > before[-1]
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(strict), flat(lazy)))


def test_pairing_on_card_matches_oracle(dev):
    rng = random.Random(8)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(64)]
    qb = [qs[(3 * i + 1) % 4] for i in range(64)]
    pb[5], qb[6] = None, None
    kernels = (FE.KERNEL_EASY, FE.KERNEL_HARD, PS.PREPARE_KERNEL, PS.MILLER_KERNEL)
    before = [k.launches for k in kernels]
    got = B.pairing_batch(pb, qb, device=dev)
    assert all(k.launches > b for k, b in zip(kernels, before))
    want = {i: OP.pairing(ps[i], qs[(3 * i + 1) % 4]) for i in range(4)}
    for i, g in enumerate(got):
        assert g == (OF.FP12_ONE if i in (5, 6) else want[i % 4]), i


def test_prepared_pairing_with_default_devices(dev):
    """`prepare_g2_batch` and `pairing_batch` with their default device
    ("cuda", no index) work together and equal the oracle."""
    rng = random.Random(18)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    prep = B.prepare_g2_batch(qs)
    assert prep.stacked.is_cuda
    assert B.pairing_batch(ps, prep) == [OP.pairing(p, q) for p, q in zip(ps, qs)]


def test_strict_fused_pairing_on_card(dev):
    """The strict engine fused on the card, 32 pairs with an identity on
    each side: `pairing` launches its K5-chain, K6-chain and FE-easy
    instantiations on strict limbs and FE-hard once each and no K7-K10 or
    K7-inv, limb for limb the lazy engine's and the unfused strict route's
    results; the unfused route launches no chain and its Fermat ladder is
    one K7-inv launch; `multi_pairing` on the fused route against the
    oracle's product."""
    rng = random.Random(28)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(32)]
    qb = [qs[(i + 1) % 4] for i in range(32)]
    pb[3], qb[4] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    chains = (PS.PREPARE_KERNEL_LIMBS, PS.MILLER_KERNEL_LIMBS, FE.KERNEL_EASY_LIMBS,
              FE.KERNEL_HARD, FI.KERNEL_INV_LIMBS, *SF.KERNELS.values())

    def launches(fn):
        before = [k.launches for k in chains]
        out = fn()
        torch.cuda.synchronize()
        return out, [k.launches - b for k, b in zip(chains, before)]

    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    lazy = flat(T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, device=dev))
    fused, n = launches(lambda: T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, engine="strict",
                                          device=dev))
    assert n == [1, 1, 1, 1, 0, 0, 0, 0, 0]
    assert all(torch.equal(a, b) for a, b in zip(flat(fused), lazy))
    unfused, n = launches(lambda: T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, fuse=False,
                                            engine="strict", device=dev))
    assert n[:5] == [0, 0, 0, 0, 1] and all(k > 0 for k in n[5:])
    assert all(torch.equal(a, b) for a, b in zip(flat(unfused), lazy))
    m = 8
    pm, qm = tuple(x[:, :m] for x in p), tuple(tuple(x[:, :m] for x in c) for c in q)
    got = PR.multi_pairing(pm, qm, p_inf[:m], q_inf[:m], engine="strict")
    want = OP.final_exp(OP.multi_miller_loop(
        [(a, b) for a, b in zip(pb[:m], qb[:m]) if a and b]))
    assert CV.fp12_from_dev(got) == [want]


def test_strict_chains_equal_to_plain_ragged(dev):
    """The chains' strict-limb instantiations at a ragged N (1000), one
    launch each, limb for limb and word for word against their plain
    versions (every output canonical): K5-chain storing the lines as strict
    limbs, K6-chain on them storing conj(f) as strict limbs, FE-easy
    loading those limbs; FE-hard on its words to strict limbs; the four
    distinct pairs against the oracle's pairing."""
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    n, sched = 1000, PR.MILLER_EVENTS
    rng = random.Random(29)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    (p, _), (q, _) = B._g1_batch([ps[i % 4] for i in range(n)], dev), \
        B._g2_batch([qs[(i + 1) % 4] for i in range(n)], dev)
    lines = _launched_once(PS.PREPARE_KERNEL_LIMBS,
                           lambda: PS.prepare_lines(q, sched, PS.FMT_LIMBS))
    assert lines.shape == (68, 6, W.LIMBS, n)
    assert torch.equal(lines, PS.prepare_lines_plain(q, sched, PS.FMT_LIMBS))
    f = _launched_once(PS.MILLER_KERNEL_LIMBS,
                       lambda: PS.miller_lines(lines, p, sched, PS.FMT_LIMBS))
    assert f.shape == (12, W.LIMBS, n)
    assert torch.equal(f, PS.miller_lines_plain(lines, p, sched, PS.FMT_LIMBS))
    words = _launched_once(FE.KERNEL_EASY_LIMBS, lambda: FE.easy(f))
    t2 = FE.easy_plain(W.limbs_to_digits_plain(f))
    assert torch.equal(words, W.digits_to_words_plain(t2))
    got = _launched_once(FE.KERNEL_HARD, lambda: FE.hard(words, out="limbs"))
    assert torch.equal(got, FE.hard_limbs_plain(t2))
    vals = CV.fp12_from_dev(TL.unstack12(got[..., :4]))
    assert vals == [OP.pairing(ps[i], qs[(i + 1) % 4]) for i in range(4)]


@pytest.mark.parametrize("n", [0, 1, 1000, 8192])
def test_k7_inv_equal_to_plain(dev, n):
    """The strict engine's inversion (K7-inv, the binary GCD) on canonical
    strict limbs, 0, 1, p-1 and R mod p in the first lanes, one launch,
    limb for limb against its plain version (the strict engine's loop of
    products) and on a sample against R^2 X^-1 mod p; `ops/dispatch.fp_inv`
    launches it once and no K7. An empty batch launches nothing."""
    from ark_blst_tpu_torch.ops import dispatch as D

    if n == 0:
        x = torch.zeros((24, 0), dtype=torch.int32, device=dev)
        before = FI.KERNEL_INV_LIMBS.launches
        got = FI.fp_inv_limbs(x)
        assert got.shape == (24, 0) and torch.equal(got, FI.fp_inv_limbs_plain(x))
        assert FI.KERNEL_INV_LIMBS.launches == before
        return
    rng = random.Random(n)
    r = (1 << 384) % OF.P
    vals = ([0, 1, OF.P - 1, r] + [rng.randrange(OF.P) for _ in range(n)])[:n]
    x = torch.from_numpy(ints_to_limbs(vals, 24).T.copy()).to(dev)
    got = _launched_once(FI.KERNEL_INV_LIMBS, lambda: FI.fp_inv_limbs(x))
    assert torch.equal(got, FI.fp_inv_limbs_plain(x))
    want = [pow(v, -1, OF.P) * r * r % OF.P if v else 0 for v in vals[:16]]
    assert CV.fp_from_dev(got[:, :16]) == [w * pow(r, -1, OF.P) % OF.P for w in want]
    before = SF.KERNELS["mont_mul"].launches
    assert torch.equal(_launched_once(FI.KERNEL_INV_LIMBS, lambda: D.fp_inv(x)), got)
    assert SF.KERNELS["mont_mul"].launches == before


def _strict_stack(rng, spec, n, dev):
    """(L, n) canonical limbs: the extreme values (0, 1, p-1, p-2, all-ones
    low limbs below p) against each other, then random values below p."""
    p, L = spec.modulus, spec.num_limbs
    edge = [0, 1, p - 1, p - 2] + [((p >> 16 * k) - 1 << 16 * k) | ((1 << 16 * k) - 1)
                                   for k in (1, 4, L // 2)]
    xs = [x for x in edge for _ in edge] + [rng.randrange(p) for _ in range(n)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(p) for _ in range(n)]
    return [torch.from_numpy(ints_to_limbs(v, L).T.copy()).to(dev) for v in (xs, ys)]


@pytest.mark.parametrize("spec", [FP, FR], ids=["fp", "fr"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub", "neg"])
def test_k7_k10_bit_equal_to_plain(dev, op, spec):
    a, b = _strict_stack(random.Random(9), spec, 4000, dev)
    args = (a,) if op == "neg" else (a, b)
    got = _launched_once(SF.KERNELS[op], lambda: getattr(SF, op)(*args, spec))
    assert torch.equal(got, SF.PLAIN[op](*args, spec))


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub", "neg"])
def test_k7_k10_broadcast_pair(dev, op):
    """The MSM accumulation's shapes: bucket (24, lanes, W, 1) against point
    (24, lanes, 1, 1)."""
    a, b = _strict_stack(random.Random(10), FP, 64 * 8, dev)
    a = a[:, : 64 * 8].reshape(24, 64, 8, 1)
    b = b[:, :64].reshape(24, 64, 1, 1)
    args = (a,) if op == "neg" else (a, b)
    got = _launched_once(SF.KERNELS[op], lambda: getattr(SF, op)(*args, FP))
    assert got.shape == (24, 64, 8, 1)
    assert torch.equal(got, SF.PLAIN[op](*args, FP))


def test_strict_kernels_reject_other_fields(dev):
    tiny = FieldSpec("tiny", (1 << 30) - 35, 2)
    a = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        SF.mont_mul(a, a, tiny)


def test_scan_msm_on_card_matches_oracle(dev):
    """The scan MSM on the card: scan-acc, scan-red and scan-horner once
    each, K7-K10 in the fold across lanes."""
    rng = random.Random(14)
    base = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(8)]
    pts = [base[i % 8] for i in range(2048)]
    scs = [rng.randrange(OF.R) for _ in range(2048)]
    pts[10], scs[11] = None, 0
    agg = [0] * 8
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 8] += s
    kernels = {**SF.KERNELS, **SM.KERNELS}
    before = {k: v.launches for k, v in kernels.items()}
    out = M.msm(CV.g1_to_dev(pts), CV.fr_to_dev(scs), c=4, device=dev)
    torch.cuda.synchronize()
    assert all(SF.KERNELS[k].launches > before[k] for k in ("mont_mul", "add", "sub"))
    chains = [k for k in SM.KERNELS if k != "scan_mul"]  # scan-mul: the ladder's, not the MSM's
    assert all(SM.KERNELS[k].launches == before[k] + 1 for k in chains)
    assert SM.KERNEL_MUL.launches == before["scan_mul"]
    assert out[0].is_cuda and CV.g1_from_dev(out) == [OC.msm(base, agg)]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_chains_equal_to_plain(dev, curve):
    """scan-acc, scan-red and scan-horner on the card, one launch each,
    against their plain loops on the card limb for limb: 2^12 points of
    `curves/instance.py` (an identity point and a zero scalar), c = 8,
    256 lanes (G1) or 64 (G2), each chain on the plain loop's own input."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    lanes = 64 if curve == "g2" else 256
    points, scalars, expected = distinct_bases(12, 6, dev, curve)
    digits = M.window_digits(scalars, 8)
    got = _launched_once(SM.KERNEL_ACC, lambda: SM.bucket_accumulate(cv, points, digits, lanes, 8))
    want = SM.bucket_accumulate_plain(cv, points, digits, lanes, 8)
    assert torch.equal(SM.stack_point(got), SM.stack_point(want))
    folded = M._fold_axis(cv, want, lanes)
    got = _launched_once(SM.KERNEL_RED, lambda: SM.bucket_reduce(cv, folded))
    sums = SM.bucket_reduce_plain(cv, folded)
    assert torch.equal(SM.stack_point(got), SM.stack_point(sums))
    got = _launched_once(SM.KERNEL_HORNER, lambda: SM.horner(cv, sums, 8))
    assert torch.equal(SM.stack_point(got), SM.stack_point(SM.horner_plain(cv, sums, 8)))
    assert (CV.g2_from_dev if curve == "g2" else CV.g1_from_dev)(got) == [expected]


def _mul_instance(dev, curve: str):
    """64 points of `curves/instance.py` (point 5 the identity) and their
    scalars, the first four 0, 1, r - 1 and 2^256 - 1 (every limb 0xFFFF)."""
    points, scalars, _ = distinct_bases(6, 8, dev, curve)
    for col, k in enumerate((0, 1, OF.R - 1, (1 << 256) - 1)):
        scalars[:, col] = torch.from_numpy(ints_to_limbs([k], 16)[0]).to(dev)
    return points, scalars


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_mul_equal_to_plain(dev, curve):
    """scan-mul (`CurveOps.scalar_mul` on CUDA tensors) one launch, against
    its plain loop on the card limb for limb at 256 and 8 bits, at 1 and 33
    elements (a last block that is partly filled: 32 teams a block) at 256
    bits, one point against every scalar (the batches broadcast), and
    against the oracle."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    points, scalars = _mul_instance(dev, curve)
    for bits in (256, 8):
        got = _launched_once(SM.KERNEL_MUL, lambda: cv.scalar_mul(points, scalars, bits))
        want = SM.scalar_mul_plain(cv, points, scalars, bits)
        assert torch.equal(SM.stack_point(got), SM.stack_point(want)), bits
    for n in (1, 33):  # from lane 2: scalars r - 1, 2^256 - 1, ..., the identity at lane 5
        pts = SM.point_of(SM.stack_point(points)[..., 2:2 + n].contiguous())
        sc = scalars[:, 2:2 + n].contiguous()
        got = _launched_once(SM.KERNEL_MUL, lambda: cv.scalar_mul(pts, sc, 256))
        want = SM.scalar_mul_plain(cv, pts, sc, 256)
        assert SM.stack_point(got).shape[-1] == n
        assert torch.equal(SM.stack_point(got), SM.stack_point(want)), n
    one = SM.point_of(SM.stack_point(points)[..., 6:7])
    got = _launched_once(SM.KERNEL_MUL, lambda: cv.scalar_mul(one, scalars, 16))
    assert SM.stack_point(got).shape[-1] == scalars.shape[1]
    assert torch.equal(SM.stack_point(got),
                       SM.stack_point(SM.scalar_mul_plain(cv, one, scalars, 16)))
    got = cv.scalar_mul(points, scalars, 256)
    from_dev = CV.g2_from_dev if curve == "g2" else CV.g1_from_dev
    mul = OC.g2_mul if curve == "g2" else OC.scalar_mul
    ks = limbs_to_ints(scalars[:, :8].T.cpu().numpy())
    assert from_dev(SM.point_of(SM.stack_point(got)[..., :8])) == [
        None if p is None else mul(p, k % OF.R)
        for p, k in zip(from_dev(SM.point_of(SM.stack_point(points)[..., :8])), ks)]


def test_msm_naive_launches_one_scan_mul(dev):
    """`msm_naive` on the card: its ladder is one scan-mul launch and no
    K7-K10 (the ladder alone launches nothing else), K7-K10 only in its
    log fold; the result the instance's point."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1

    points, scalars, expected = distinct_bases(8, 9, dev, "g1")
    kernels = {**SF.KERNELS, **SM.KERNELS, "inv": FI.KERNEL_INV_LIMBS}
    before = {k: v.launches for k, v in kernels.items()}
    CG1.scalar_mul(points, scalars, 256)
    torch.cuda.synchronize()
    moved = {k for k, v in kernels.items() if v.launches != before[k]}
    assert moved == {"scan_mul"} and SM.KERNEL_MUL.launches == before["scan_mul"] + 1
    before = {k: v.launches for k, v in kernels.items()}
    out = M.msm_naive(points, scalars, CG1, device=dev)
    torch.cuda.synchronize()
    moved = {k for k, v in kernels.items() if v.launches != before[k]}
    assert SM.KERNEL_MUL.launches == before["scan_mul"] + 1
    assert moved <= {"scan_mul", "mont_mul", "add", "sub", "neg"}
    assert out[0].is_cuda and CV.g1_from_dev(out) == [expected]


# scan-acc's card cases: (c, digits, one step a stream): random scalars'
# digits at c = 4 and c = 8, every digit equal, every digit 0, n = lanes
SCAN_ACC_CASES = {"c4": (4, "random", False), "c8": (8, "random", False),
                  "equal_digits": (8, "equal", False), "zero_digits": (8, "zero", False),
                  "one_step": (8, "random", True)}


def _scan_acc_instance(dev, curve: str, case: str):
    """2^12 points of `curves/instance.py` (an identity point and a zero
    scalar; n = lanes for one step a stream) in other projective
    coordinates (each scaled by a random z), 256 lanes (G1) or 64 (G2), and
    the case's digits."""
    c, kind, one_step = SCAN_ACC_CASES[case]
    lanes = 64 if curve == "g2" else 256
    points, scalars, _ = distinct_bases(12, 6, dev, curve)
    n = lanes if one_step else scalars.shape[1]
    rng = random.Random(f"{curve}-{case}")
    z = CV.fp_to_dev([rng.randrange(1, OF.P) for _ in range(n)]).to(dev)
    scale = lambda x: SF.mont_mul(x[:, :n].contiguous(), z, FP)  # noqa: E731
    points = tuple(tuple(scale(x) for x in co) if isinstance(co, tuple) else scale(co)
                   for co in points)
    W = -(-256 // c)
    if kind == "random":
        digits = M.window_digits(scalars[:, :n].contiguous(), c)
    else:
        value = 0 if kind == "zero" else (1 << c) - 3
        digits = torch.full((W, n), value, dtype=torch.int32, device=dev)
    return points, digits, lanes, c


@pytest.mark.parametrize("case", list(SCAN_ACC_CASES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_acc_cases_equal_to_plain(dev, curve, case):
    """scan-acc's three launches (the point words, the walk, the split) on
    the card, once each, against `bucket_accumulate_plain` on the card limb
    for limb, and each launch against its plain version on the same input:
    random digits at c = 4 and c = 8, every digit equal (one bucket takes
    every point of a stream, in order), every digit 0, one step a stream."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    points, digits, lanes, c = _scan_acc_instance(dev, curve, case)
    W, B = digits.shape[0], 1 << c
    want = SM.stack_point(SM.bucket_accumulate_plain(cv, points, digits, lanes, c))
    before = {k: v.launches for k, v in SM.KERNELS.items()}
    got = SM.stack_point(SM.bucket_accumulate(cv, points, digits, lanes, c))
    torch.cuda.synchronize()
    assert {k: v.launches - before[k] for k, v in SM.KERNELS.items()} == {
        "scan_acc_words": 1, "scan_acc_walk": 1, "scan_acc_split": 1, "scan_red": 0,
        "scan_horner": 0, "scan_mul": 0}
    assert torch.equal(got, want)
    pts = SM.stack_point(points)
    pw = _launched_once(SM.KERNEL_WORDS, lambda: SM.point_words(pts))
    assert torch.equal(pw, SM.point_words_plain(pts))
    bk = _launched_once(SM.KERNEL_ACC, lambda: SM.accumulate_words(cv, pw, digits, lanes, c))
    assert torch.equal(bk, SM.accumulate_words_plain(cv, pw, digits, lanes, c))
    out = _launched_once(SM.KERNEL_SPLIT, lambda: SM.split_buckets(bk, lanes, W, B))
    assert torch.equal(out, SM.split_buckets_plain(bk, lanes, W, B))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_acc_team_shapes_agree(dev, curve):
    """scan-acc's walk at other (team, block) shapes than `ACC_SHAPE`, one
    thread a stream included, through its C entry (the wrapper launches
    `ACC_SHAPE` only), gives the plain version's records."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    points, digits, lanes, c = _scan_acc_instance(dev, curve, "c8")
    pw = SM.point_words(SM.stack_point(points))
    want = SM.accumulate_words_plain(cv, pw, digits, lanes, c)
    shapes = ([(1, 64), (2, 64), (3, 96), (6, 96), (9, 288), (18, 144), (18, 288)]
              if curve == "g2"
              else [(1, 64), (2, 96), (3, 96), (6, 96), (6, 288)])
    for team, block in shapes:
        got = torch.empty_like(want)
        SM.KERNEL_ACC.launch(pw.data_ptr(), digits.data_ptr(), got.data_ptr(), pw.shape[0],
                             lanes, digits.shape[0], 1 << c, pw.shape[1] // SM.RECORD, team,
                             block, torch.cuda.current_stream(dev).cuda_stream)
        assert torch.equal(got, want), (team, block)


# scan-red's card cases: (windows, buckets a window); scan-horner's:
# (windows, c), c = 1 with the W = 256 windows of a 256-bit scalar
SCAN_RED_CASES = {"b2_w32": (32, 2), "b16_w32": (32, 16), "b256_w32": (32, 256),
                  "b16_w1": (1, 16), "b256_w1": (1, 256)}
SCAN_HORNER_CASES = {"c1": (256, 1), "c8": (32, 8)}


def _scaled_points(dev, curve: str, n: int, seed: int):
    """n points of `curves/instance.py` (its identity point among them when
    n covers it) as a `(3 nc, 24, n)` stack, each scaled by a random z."""
    points, _, _ = distinct_bases(max(4, (n - 1).bit_length()), seed, dev, curve)
    rng = random.Random(f"{curve}-{seed}-{n}")
    z = CV.fp_to_dev([rng.randrange(1, OF.P) for _ in range(n)]).to(dev)
    stack = SM.stack_point(points)[..., :n].contiguous()
    return torch.stack([SF.mont_mul(x.contiguous(), z, FP) for x in stack])


@pytest.mark.parametrize("case", list(SCAN_RED_CASES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_red_cases_equal_to_plain(dev, curve, case):
    """scan-red on the card, one launch, against `bucket_reduce_plain` on
    the card limb for limb: B = 2, 16 and 256 at W = 32 and W = 1, the
    buckets points in random projective coordinates (bucket 0 a point: it
    is dropped), window 0 all the identity at W = 32."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    W, B = SCAN_RED_CASES[case]
    stack = _scaled_points(dev, curve, W * B, 7).reshape(-1, 24, W, B)
    if W > 1:
        stack[:, :, 0] = SM.stack_point(cv.identity((B,), dev))
    buckets = SM.point_of(stack.contiguous())
    got = _launched_once(SM.KERNEL_RED, lambda: SM.bucket_reduce(cv, buckets))
    assert torch.equal(SM.stack_point(got), SM.stack_point(SM.bucket_reduce_plain(cv, buckets)))


@pytest.mark.parametrize("case", list(SCAN_HORNER_CASES))
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_horner_cases_equal_to_plain(dev, curve, case):
    """scan-horner on the card, one launch, against `horner_plain` on the
    card limb for limb: c = 1 over 256 window sums (its column above 48 KB
    of shared memory on G2) and c = 8 over 32, the top window's sum the
    identity."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    W, c = SCAN_HORNER_CASES[case]
    stack = _scaled_points(dev, curve, W, 8)
    stack[..., W - 1] = SM.stack_point(cv.identity((1,), dev))[..., 0]
    sums = SM.point_of(stack)
    got = _launched_once(SM.KERNEL_HORNER, lambda: SM.horner(cv, sums, c))
    assert torch.equal(SM.stack_point(got), SM.stack_point(SM.horner_plain(cv, sums, c)))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scan_red_horner_shapes_agree(dev, curve):
    """scan-red at other (team, block, column) shapes than `RED_SHAPE` (the
    products on one thread, the sums on one warp or on fewer warps than
    jobs, blocks that are not whole warps, columns of 1, 2, 64 and 255
    buckets) and scan-horner at other (team, block)
    shapes than `HORNER_SHAPE`, through their C entries, give the wrappers'
    outputs."""
    from ark_blst_tpu_torch.curves.group import G1 as CG1, G2 as CG2

    cv = CG2 if curve == "g2" else CG1
    nc = 2 if curve == "g2" else 1
    W, B = 32, 256
    bk = _scaled_points(dev, curve, W * B, 9).reshape(-1, 24, W, B).contiguous()
    want = SM.stack_point(SM.bucket_reduce(cv, SM.point_of(bk)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = ([(1, 1, 2), (6, 32, 128), (12, 96, 1), (18, 200, 255), (36, 36, 2),
               (36, 256, 64)]
              if curve == "g2"
              else [(1, 1, 2), (4, 64, 128), (6, 6, 1), (12, 12, 255), (12, 100, 2),
                    (32, 256, 64)])
    for team, block, column in shapes:
        got = torch.empty_like(want)
        SM.KERNEL_RED.launch(bk.data_ptr(), got.data_ptr(), W, B, nc, team, block, column, stream)
        assert torch.equal(got, want), (team, block, column)
    sums = want.contiguous()
    want = SM.stack_point(SM.horner(cv, SM.point_of(sums), 8))
    for team, block in ((1, 1), (4, 32), (6, 6), (12, 96), (18, 18), (32, 200), (64, 256)):
        got = torch.empty_like(want)
        SM.KERNEL_HORNER.launch(sums.data_ptr(), got.data_ptr(), W, 8, nc, team, block, stream)
        assert torch.equal(got, want), (team, block)


VEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors", "bls12_381.json")


def test_api_generator_pairing_bytes_on_card(dev):
    with open(VEC_PATH) as fh:
        want = json.load(fh)["pairing"]["e_g1gen_g2gen"]
    g1, g2 = T.G1Affine.generator(), T.G2Affine.generator()
    assert T.Bls12.pairing(g1, g2, device=dev).serialize().hex() == want
    got = T.Bls12.pairing_batch([g1, T.G1Affine.zero()], [g2, g2], device=dev)
    assert got[0].serialize().hex() == want and got[1].is_one()


def test_api_msm_vectors_on_card(dev):
    with open(VEC_PATH) as fh:
        vecs = json.load(fh)["msm_g1"]
    for v in vecs:
        pts = [T.G1Affine.deserialize_compressed(bytes.fromhex(h)) for h in v["points_compressed"]]
        scs = [T.Scalar(int(s, 16)) for s in v["scalars"]]
        before = MB.KC2_G1.kernel.launches
        out = T.G1Projective.msm(pts, scs, backend="device", device=dev)
        assert MB.KC2_G1.kernel.launches > before
        assert out.into_affine().serialize_compressed().hex() == v["result_compressed"]


def test_api_g2_msm_on_card_matches_host_route(dev):
    rng = random.Random(16)
    bases = [T.G2Affine.rand(rng) for _ in range(6)] + [T.G2Affine.zero()]
    scalars = [T.Scalar.rand(rng) for _ in range(6)] + [T.Scalar(5)]
    scalars[2] = T.Scalar.zero()
    before = MB.KC2_G2.kernel.launches
    got = T.G2Projective.msm(bases, scalars, device=dev)
    assert MB.KC2_G2.kernel.launches > before
    assert got == T.G2Projective.msm(bases, scalars, backend="host")


# --- multi-device: a world of one over NCCL -------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one over NCCL on the card, formed once for the module's
    distributed tests and torn down after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    import socket

    from ark_blst_tpu_torch import distributed as D

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    D.initialize(f"localhost:{port}", 1, 0, device="cuda")
    yield D.global_mesh()
    torch.distributed.destroy_process_group()


def test_distributed_msm_world_of_one(dev, nccl_mesh):
    """`msm_distributed` (the bucket kernels, K2) at 2^16 over NCCL equals
    the instance's expected point and the unsharded `msm_g1`; the scan
    backend with the host finish at 2^10 equals the oracle."""
    from ark_blst_tpu_torch import distributed as D

    assert nccl_mesh.backend == "nccl" and nccl_mesh.shape == {"data": 1}
    points, scalars, expected = distinct_bases(16, 4, dev, "g1")
    before, gathers = MB.KERNEL.launches, nccl_mesh.gathers
    out = D.msm_distributed(points, scalars, mesh=nccl_mesh)
    torch.cuda.synchronize()
    assert MB.KERNEL.launches == before + 1 and nccl_mesh.gathers == gathers + 1
    assert out[0].is_cuda and CV.g1_from_dev(out) == [expected]
    assert CV.g1_from_dev(T.msm_g1(points, scalars, device=dev)) == [expected]
    points, scalars, expected = distinct_bases(10, 5, dev, "g1")
    before = SF.KERNELS["mont_mul"].launches
    out = D.msm_distributed(points, scalars, c=4, mesh=nccl_mesh, backend="scan", finish="host")
    assert SF.KERNELS["mont_mul"].launches > before
    assert CV.g1_from_dev(out) == [expected]


def test_distributed_pairing_world_of_one(dev, nccl_mesh):
    """`multi_pairing_sharded` over 64 pairs (one identity on each side) over
    NCCL, fused with the final exponentiation (the rank's fold on K4's
    words), equals the unsharded `multi_pairing` limb for limb and the
    oracle's product."""
    rng = random.Random(19)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(64)]
    qb = [qs[(3 * i + 1) % 4] for i in range(64)]
    pb[5], qb[6] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    kernels = (K4.KERNEL_WORDS, FE.KERNEL_EASY, FE.KERNEL_HARD, PS.PREPARE_KERNEL,
               PS.MILLER_KERNEL)
    before = [k.launches for k in kernels]
    got = PR.multi_pairing_sharded(p, q, nccl_mesh, p_inf=p_inf, q_inf=q_inf)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    want = PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    pairs = [(a, b) for a, b in zip(pb, qb)]
    assert CV.fp12_from_dev(got) == [OP.final_exp(OP.multi_miller_loop(pairs))]
