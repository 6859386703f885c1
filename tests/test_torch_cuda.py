"""The CUDA kernels on the card against their plain PyTorch versions, and the
G1 and G2 MSMs, the strict engine's scan MSM and the batched pairing (fused,
unfused and strict) on the card against the host oracle; the arkworks API's
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
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
from ark_blst_tpu_torch.ops import fp12_sqr as K11
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops.limbs import FP, FR, FieldSpec, ints_to_limbs
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
    coeffs = PR.prepare_g2(q, events=4)
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
    K12, no K5/K6) and the strict engine (K7-K10 alone) give the fused
    path's results."""
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
    lazy_kernels = (MM.KERNEL, K3.KERNEL, K4.KERNEL) + tower
    before = [k.launches for k in lazy_kernels] + [SF.KERNELS["mont_mul"].launches]
    strict = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, engine="strict", device=dev)
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
    kernels = (MM.KERNEL, K3.KERNEL, K4.KERNEL, PS.PREPARE_KERNEL, PS.MILLER_KERNEL)
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
    rng = random.Random(14)
    base = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(8)]
    pts = [base[i % 8] for i in range(2048)]
    scs = [rng.randrange(OF.R) for _ in range(2048)]
    pts[10], scs[11] = None, 0
    agg = [0] * 8
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 8] += s
    before = {k: v.launches for k, v in SF.KERNELS.items()}
    out = M.msm(CV.g1_to_dev(pts), CV.fr_to_dev(scs), c=4, device=dev)
    torch.cuda.synchronize()
    assert all(SF.KERNELS[k].launches > before[k] for k in ("mont_mul", "add", "sub"))
    assert out[0].is_cuda and CV.g1_from_dev(out) == [OC.msm(base, agg)]


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
    NCCL, fused with the final exponentiation, equals the unsharded
    `multi_pairing` limb for limb and the oracle's product."""
    rng = random.Random(19)
    ps = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    qs = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(4)]
    pb = [ps[i % 4] for i in range(64)]
    qb = [qs[(3 * i + 1) % 4] for i in range(64)]
    pb[5], qb[6] = None, None
    (p, p_inf), (q, q_inf) = B._g1_batch(pb, dev), B._g2_batch(qb, dev)
    kernels = (K3.KERNEL, K4.KERNEL, PS.PREPARE_KERNEL, PS.MILLER_KERNEL)
    before = [k.launches for k in kernels]
    got = PR.multi_pairing_sharded(p, q, nccl_mesh, p_inf=p_inf, q_inf=q_inf)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    want = PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf)
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    pairs = [(a, b) for a, b in zip(pb, qb)]
    assert CV.fp12_from_dev(got) == [OP.final_exp(OP.multi_miller_loop(pairs))]
