"""The port's arkworks API surface (`fields.py`, `groups.py`, `bls12.py`,
`oracle/serialize.py`) against the JAX package's.

Two halves:
* the twins: every test of `tests/test_api.py`, run on the port's classes
  (device routes with device="cpu", where each kernel is its plain
  version; the MSM's device route at c=4 here and c=3 below and in
  `test_torch_api_vectors.py`, windows its clamp leaves as they are);
* exact parity with the JAX package: the same seeded inputs through both
  packages give equal integers and equal bytes (rand, the field
  operations, serialization and its rejections, the flagged byte
  conversions, field_cast and the sponge methods, `G2Prepared` bytes, the
  MSM and pairing device routes, `value_from_jax`).
"""

import os
import random

import pytest
import torch

import ark_blst_tpu as J
from ark_blst_tpu.oracle import pairing as JOP

import ark_blst_tpu_torch as T
from ark_blst_tpu_torch import (
    Bls12,
    Fp,
    Fp2,
    Fp6,
    Fp12,
    G1Affine,
    G1Projective,
    G2Affine,
    G2Prepared,
    G2Projective,
    Gt,
    Scalar,
    field_cast,
)
from ark_blst_tpu_torch.ops.convert import value_from_jax
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


# --- the twins of tests/test_api.py ---------------------------------------------

FIELDS = [Fp, Scalar, Fp2, Fp6, Fp12]


@pytest.mark.parametrize("F", FIELDS, ids=lambda f: f._name)
def test_field_laws(F):
    """= field_test (ark-blst src/tests.rs:9-26)."""
    rng = random.Random(17)
    a, b = F.rand(rng), F.rand(rng)
    assert a + b == b + a
    assert a * b == b * a
    assert (a + (-a)).is_zero()
    assert a - a == F.zero()
    if not a.is_zero():
        assert (a / a).is_one()
        assert (a * a.inverse()).is_one()
    assert a * F.one() == a
    assert (a * F.zero()).is_zero()
    assert a.double() == a + a
    assert a.square() == a * a
    # distributivity
    c = F.rand(rng)
    assert a * (b + c) == a * b + a * c


@pytest.mark.parametrize("F", FIELDS, ids=lambda f: f._name)
def test_field_serialization_roundtrip(F):
    rng = random.Random(3)
    for _ in range(4):
        a = F.rand(rng)
        data = a.serialize()
        assert len(data) == F.serialized_size()
        assert F.deserialize(data) == a
    # compress flag ignored for fields (src/fp.rs:258-273)
    a = F.rand(rng)
    assert a.serialize(compress=False) == a.serialize(compress=True)


def test_field_serialized_sizes():
    """Byte widths of ark-blst: Fp=48, Scalar=32, Fp2=96, Fp6=288,
    Fp12=576."""
    assert Fp.serialized_size() == 48
    assert Scalar.serialized_size() == 32
    assert Fp2.serialized_size() == 96
    assert Fp6.serialized_size() == 288
    assert Fp12.serialized_size() == 576


@pytest.mark.parametrize("F", FIELDS, ids=lambda f: f._name)
def test_frobenius_is_correct(F):
    """x^(p^k) == frobenius_map(k); the reference no-ops these for towers
    (quirk ledger). Verified against pow for the cheap fields, and
    structurally (frobenius^degree == identity) for all."""
    rng = random.Random(5)
    a = F.rand(rng)
    deg = F.EXTENSION_DEGREE
    out = a
    for _ in range(deg):
        out = out.frobenius_map(1)
    assert out == a
    if F is Fp2:
        assert a.frobenius_map(1) == a.pow(OF.P)


def test_fp_sqrt_legendre():
    rng = random.Random(9)
    a = Fp.rand(rng)
    sq = a.square()
    assert sq.legendre() == 1
    s = sq.sqrt()
    assert s is not None and s.square() == sq
    # a known non-residue: legendre(-1)? p % 4 == 3 for BLS12-381 -> -1 is NQR
    assert (-Fp.one()).legendre() == -1
    assert (-Fp.one()).sqrt() is None


def test_fp2_sqrt():
    rng = random.Random(11)
    a = Fp2.rand(rng)
    sq = a.square()
    s = sq.sqrt()
    assert s is not None and s.square() == sq


def test_scalar_sqrt_and_fft_constants():
    rng = random.Random(13)
    a = Scalar.rand(rng)
    sq = a.square()
    s = sq.sqrt()
    assert s is not None and s.square() == sq
    # FFT constants (src/scalar.rs:465-471)
    assert Scalar.TWO_ADICITY == 32
    w = Scalar.TWO_ADIC_ROOT_OF_UNITY
    assert w.pow(1 << 32).is_one()
    assert not w.pow(1 << 31).is_one()
    assert Scalar.GENERATOR == Scalar(7)


def test_scalar_absorb_and_field_cast():
    """Sponge Absorb semantics (ark-blst src/scalar.rs:661-671):
    to_sponge_bytes = serialize_compressed; to_sponge_field_elements =
    field_cast via LE bytes."""
    rng = random.Random(15)
    a = Scalar.rand(rng)
    assert a.to_sponge_bytes() == a.serialize()
    (elem,) = a.to_sponge_field_elements()
    assert elem == a
    # cross-characteristic cast must fail (the reference returns None)
    with pytest.raises(ValueError):
        field_cast(a, Fp)
    # same-characteristic cast: Fp -> Fp identity
    b = Fp.rand(rng)
    assert field_cast(b, Fp) == b


def test_fp6_from_base_prime_field_elems_fixed():
    """The reference mis-slices c1/c2 (src/fp6.rs:490-493); ours is correct."""
    rng = random.Random(19)
    elems = [Fp.rand(rng) for _ in range(6)]
    a = Fp6.from_base_prime_field_elems(elems)
    assert a.c0 == Fp2.new(elems[0], elems[1])
    assert a.c1 == Fp2.new(elems[2], elems[3])
    assert a.c2 == Fp2.new(elems[4], elems[5])
    assert Fp6.from_base_prime_field_elems(elems[:5]) is None


def test_gt_cyclotomic_ops():
    """Cyclotomic square/inverse agree with generic ops inside the
    cyclotomic subgroup (CyclotomicMultSubgroup, src/pairing.rs:14-32)."""
    g = Bls12.pairing(G1Affine.generator(), G2Affine.generator(), backend="host")
    assert g.cyclotomic_square() == g.square()
    assert g.cyclotomic_inverse() == g.inverse()
    assert Gt.INVERSE_IS_FAST
    e = 0xDEADBEEF
    assert g.cyclotomic_exp(e) == g.pow(e)


GROUPS = [
    (G1Affine, G1Projective),
    (G2Affine, G2Projective),
]


@pytest.mark.parametrize("Aff,Proj", GROUPS, ids=["g1", "g2"])
def test_group_laws(Aff, Proj):
    """= group_test (ark-blst src/tests.rs:28-49)."""
    rng = random.Random(23)
    a, b, c = Proj.rand(rng), Proj.rand(rng), Proj.rand(rng)
    assert a + b == b + a
    assert (a + b) + c == a + (b + c)
    assert (a + (-a)).is_zero()
    assert a + Proj.zero() == a
    assert a.double() == a + a
    s = Scalar.rand(rng)
    # mul(s) vs mul_bigint agreement (src/tests.rs:42-43)
    assert a.mul(s) == a.mul_bigint(s.v)
    assert a * 2 == a.double()
    g = Aff.generator()
    assert g.is_on_curve() and g.is_in_correct_subgroup_assuming_on_curve()
    assert (g * Scalar(OF.R - 1)) + g == Proj.zero()


@pytest.mark.parametrize("Aff,Proj", GROUPS, ids=["g1", "g2"])
def test_group_serialization(Aff, Proj):
    """Round-trips in both modes + validation behavior
    (src/g1.rs:358-431)."""
    rng = random.Random(29)
    for pt in [Aff.generator(), Aff.rand(rng), Aff.zero()]:
        comp = pt.serialize_compressed()
        assert len(comp) == Aff.serialized_size(True)
        assert Aff.deserialize_compressed(comp) == pt
        unc = pt.serialize_uncompressed()
        assert len(unc) == Aff.serialized_size(False)
        assert Aff.deserialize_uncompressed(unc) == pt
    # projective serializes via affine values
    p = Proj.rand(rng)
    assert Proj.deserialize_compressed(p.serialize_compressed()) == p


def test_group_serialization_rejects_bad_subgroup():
    """validate=True must reject an on-curve point outside the r-torsion."""
    # find a curve point with small-ish x not in the subgroup
    x = 0
    while True:
        x += 1
        y2 = (x * x * x + 4) % OF.P
        y = OF.fp_sqrt(y2)
        if y is None:
            continue
        if not OC.is_in_subgroup(OC.FP_OPS, (x, y)):
            break
    bad = bytearray((x).to_bytes(48, "big"))
    bad[0] |= 0x80
    if y > (OF.P - 1) // 2:
        bad[0] |= 0x20
    with pytest.raises(ValueError):
        G1Affine.deserialize_compressed(bytes(bad), validate=True)
    # validate=False accepts it (deserialize_unchecked semantics)
    pt = G1Affine.deserialize_compressed(bytes(bad), validate=False)
    assert pt.is_on_curve() and not pt.is_in_correct_subgroup_assuming_on_curve()


@pytest.mark.parametrize("Aff,Proj", GROUPS, ids=["g1", "g2"])
def test_cofactor_ops(Aff, Proj):
    rng = random.Random(31)
    a = Aff.rand(rng)
    assert a.mul_by_cofactor_to_group() == a.mul_bigint(Aff.COFACTOR)
    if Aff is G1Affine:
        assert a.mul_by_cofactor().mul_by_cofactor_inv() == a


@pytest.mark.parametrize("Aff,Proj", GROUPS, ids=["g1", "g2"])
def test_msm_api(Aff, Proj):
    """10-point MSM vs naive fold (= src/tests.rs:50-67), host backend,
    including an identity point in the bases (the case blst fails,
    src/g1.rs:682-689)."""
    rng = random.Random(37)
    n = 10
    bases = [Aff.rand(rng) for _ in range(n)]
    bases[4] = Aff.zero()
    scalars = [Scalar.rand(rng) for _ in range(n)]
    expected = Proj.zero()
    for b, s in zip(bases, scalars):
        expected = expected + b.mul(s)
    got = Proj.msm(bases, scalars, backend="host")
    assert got == expected


def test_msm_api_device_backend():
    """Same MSM through the device pipeline (CPU mesh in tests)."""
    rng = random.Random(41)
    n = 8
    bases = [G1Affine.rand(rng) for _ in range(n)]
    bases[2] = G1Affine.zero()
    scalars = [Scalar.rand(rng) for _ in range(n)]
    host = G1Projective.msm(bases, scalars, backend="host")
    dev = G1Projective.msm(bases, scalars, backend="device", c=4, lanes=4, device="cpu")
    assert dev == host


def test_batch_normalize():
    rng = random.Random(43)
    pts = [G1Projective.rand(rng) for _ in range(4)] + [G1Projective.zero()]
    affs = G1Projective.batch_normalize(pts)
    assert all(isinstance(a, G1Affine) for a in affs)
    assert [a.p for a in affs] == [p.p for p in pts]


def test_pairing_bilinearity():
    """e(aP, bQ) == e(P, Q)^(ab) (= src/pairing.rs:91-101)."""
    rng = random.Random(47)
    a, b = Scalar.rand(rng), Scalar.rand(rng)
    P, Q = G1Affine.generator(), G2Affine.generator()
    lhs = Bls12.pairing(P.mul(a), Q.mul(b), backend="host")
    rhs = Bls12.pairing(P, Q, backend="host").pow((a.v * b.v) % OF.R)
    assert lhs == rhs
    assert not lhs.is_one()


def test_pairing_identity_semantics():
    """Identity inputs give one (src/pairing.rs:58-60)."""
    P, Q = G1Affine.generator(), G2Affine.generator()
    assert Bls12.pairing(G1Affine.zero(), Q, backend="host").is_one()
    assert Bls12.pairing(P, G2Affine.zero(), backend="host").is_one()
    # multi_pairing skips identity pairs but keeps the rest
    out = Bls12.multi_pairing([P, G1Affine.zero()], [Q, Q], backend="host")
    assert out == Bls12.pairing(P, Q, backend="host")


def test_multi_pairing_product():
    """prod e(P_i, Q_i) == e(P1,Q1)*e(P2,Q2)."""
    rng = random.Random(53)
    P1, P2 = G1Affine.rand(rng), G1Affine.rand(rng)
    Q1, Q2 = G2Affine.rand(rng), G2Affine.rand(rng)
    prod = Bls12.multi_pairing([P1, P2], [Q1, Q2], backend="host")
    sep = Bls12.pairing(P1, Q1, backend="host") * Bls12.pairing(P2, Q2, backend="host")
    assert prod == sep


def test_g2_prepared():
    """First-class reusable G2Prepared (src/g2.rs:650-694), with working
    serialization (reference todo!()s it, src/g2.rs:696-726)."""
    rng = random.Random(59)
    q = G2Affine.rand(rng)
    prep = G2Prepared.from_affine(q)
    assert not prep.is_identity()
    assert len(prep.coeffs) == G2Prepared.NUM_COEFFS
    # pairing via prepared == pairing via affine
    p = G1Affine.rand(rng)
    via_prep = Bls12.final_exponentiation(Bls12.multi_miller_loop([p], [prep]))
    direct = Bls12.pairing(p, q, backend="host")
    assert via_prep == direct
    # default = prepared generator (src/g2.rs:660-664)
    assert G2Prepared.default() == G2Prepared.from_affine(G2Affine.generator())
    # identity handling
    assert G2Prepared.from_affine(G2Affine.zero()).is_identity()
    # serialization round-trip
    data = prep.serialize()
    assert len(data) == G2Prepared.serialized_size()
    assert G2Prepared.deserialize(data) == prep
    assert G2Prepared.deserialize(G2Prepared.from_affine(G2Affine.zero()).serialize()).is_identity()


def test_pairing_matches_slow_oracle():
    """Host pairing path agrees with the first-principles slow pairing
    (cubed — the production chain absorbs a factor 3, see oracle/pairing.py)."""
    rng = random.Random(61)
    p, q = G1Affine.rand(rng), G2Affine.rand(rng)
    fast = Bls12.pairing(p, q, backend="host")
    slow = Fp12(JOP.pairing_slow(p.p, q.p))
    assert fast == slow.pow(3)


def test_hash_and_eq():
    rng = random.Random(67)
    a = Fp.rand(rng)
    assert hash(a) == hash(Fp(a.v))
    g = G1Affine.generator()
    assert hash(g) == hash(G1Affine(g.p))
    assert len({Fp(1), Fp(1), Fp(2)}) == 2


def test_api_long_tail_conversions():
    """from_str / from_bigint / from_random_bytes(_with_flags) / batch_check
    (= ark-blst src/fp.rs:289-467, src/scalar.rs:553-560,
    src/g1.rs:565-580)."""
    assert Fp.from_str(str(OF.P - 1)).v == OF.P - 1
    with pytest.raises(ValueError):
        Fp.from_str(str(OF.P))
    assert Fp.from_bigint(OF.P) is None
    assert Scalar.from_bigint(OF.R - 1).v == OF.R - 1

    # 2 flag bits -> arkworks reads flags from byte 32 of a 33-byte buffer
    s, flags = Scalar.from_random_bytes_with_flags(
        b"\x2a" + b"\x00" * 31 + b"\xc0", 0xC0
    )
    assert s.v == 42 and flags == 0xC0
    # flag bits placed at byte 31 are VALUE bits for a nonzero flag type:
    # bit 255 is shaved, bit 254 stays in the value
    s2, flags2 = Scalar.from_random_bytes_with_flags(
        b"\x2a" + b"\x00" * 30 + b"\xc0", 0xC0
    )
    assert s2.v == 42 + (1 << 254) and flags2 == 0
    assert Scalar.from_random_bytes((OF.R).to_bytes(32, "little")) is None
    assert Scalar.from_random_bytes((7).to_bytes(16, "little")).v == 7

    rng = random.Random(5)
    G1Projective.batch_check([G1Projective.rand(rng) for _ in range(3)])
    G2Projective.batch_check([G2Projective.rand(rng) for _ in range(2)])
    bad = G1Projective.rand(rng)
    bad.p = (1, 1)  # not on curve
    with pytest.raises(ValueError):
        G1Projective.batch_check([bad])


def test_field_pow_edge_cases():
    """pow with a negative exponent inverts first (x^-1 * x = 1) and raises
    cleanly (not AttributeError) on zero."""
    for F in (Fp, Scalar):
        x = F(12345)
        assert x.pow(-1) * x == F.one()
        assert x.pow(-3) * x.pow(3) == F.one()
        with pytest.raises(ZeroDivisionError):
            F.zero().pow(-1)
        assert F.zero().pow(0) == F.one()


def test_from_random_bytes_arkworks_semantics():
    """Arkworks parity: empty input is zero; bit 255 is
    shaved BEFORE the canonicality check; the flag byte is arkworks'
    output_byte_size-1 — byte 31 for empty flags, byte 32 for a 2-bit
    flag type (33-byte buffer)."""
    assert Scalar.from_random_bytes(b"").v == 0
    # value with bit 255 set: arkworks shaves it and then succeeds
    v = 5 | (1 << 255)
    s = Scalar.from_random_bytes(v.to_bytes(32, "little"))
    assert s is not None and s.v == 5
    # flags live past the serialized size for a nonzero flag type; short
    # input zero-pads, so the flags come back empty
    out = Scalar.from_random_bytes_with_flags(b"\x07", 0xC0)
    assert out is not None and out[0].v == 7 and out[1] == 0
    # empty flags: >32 bytes rejected; 2-bit flags: 33 accepted, 34 rejected
    assert Scalar.from_random_bytes(b"\x00" * 33) is None
    assert Scalar.from_random_bytes_with_flags(b"\x01" + b"\x00" * 32, 0xC0) is not None
    assert Scalar.from_random_bytes_with_flags(b"\x00" * 34, 0xC0) is None


def test_g2_cofactor_inv():
    """G2 COFACTOR_INV parity (ark-blst src/g2.rs:56-58): h^-1 mod r
    undoes clear_cofactor on subgroup points, for G1 and G2."""
    rng = random.Random(9)
    for Proj, h in ((G1Projective, OF.H_G1), (G2Projective, OF.H_G2)):
        p = Proj.rand(rng)  # in the r-torsion subgroup by construction
        q = p.mul_by_cofactor().mul_by_cofactor_inv()
        assert q == type(q)(p.p)
        assert Proj._cofactor_inv == pow(h, -1, OF.R)


def test_host_pippenger_matches_oracle():
    """The production host MSM (windowed buckets) against the naive fold
    oracle, with identity points and zero scalars in the mix
    (ark-blst src/g1.rs:602-619 role)."""
    rng = random.Random(21)
    for ops, gen in ((OC.FP_OPS, OF.G1_GEN), (OC.FP2_OPS, OF.G2_GEN)):
        pts = [OC.group_mul(ops, gen, rng.randrange(1, OF.R)) for _ in range(9)]
        pts[3] = None  # identity point
        scs = [rng.randrange(OF.R) for _ in range(9)]
        scs[5] = 0
        for c in (None, 2, 8):
            got = OC.msm_pippenger(ops, pts, scs, c=c)
            assert got == OC.group_msm(ops, pts, scs)
    assert OC.msm_pippenger(OC.FP_OPS, [], []) is None


def test_msm_rejects_tiny_window():
    with pytest.raises(ValueError):
        G1Projective.msm([G1Affine.generator()], [Scalar(1)], c=1)


def test_fp_from_random_bytes():
    """Fp::from_random_bytes is implemented with arkworks semantics (the
    reference panics, ark-blst src/fp.rs:568-579): shave bits >= 381,
    flags at the fixed byte 47, empty input is zero."""
    assert Fp.from_random_bytes(b"").v == 0
    v = 77 | (1 << 381)  # bit 381 shaved before the canonicality check
    assert Fp.from_random_bytes(v.to_bytes(48, "little")).v == 77
    assert Fp.from_random_bytes((OF.P).to_bytes(48, "little")) is None
    out = Fp.from_random_bytes_with_flags(b"\x09", 0xC0)
    assert out is not None and out[0].v == 9 and out[1] == 0
    assert Fp.from_random_bytes(b"\x00" * 49) is None


# --- exact parity with the JAX package ------------------------------------------

FIELD_PAIRS = [(J.Fp, Fp), (J.Scalar, Scalar), (J.Fp2, Fp2), (J.Fp6, Fp6), (J.Fp12, Fp12)]
FIELD_IDS = [jf._name for jf, _ in FIELD_PAIRS]
GROUP_PAIRS = [(J.G1Affine, G1Affine), (J.G1Projective, G1Projective),
               (J.G2Affine, G2Affine), (J.G2Projective, G2Projective)]
GROUP_IDS = [jg._name for jg, _ in GROUP_PAIRS]


def _canon(x):
    """A result of either package -> plain data: bytes for an element or a
    point, ints and None as they are."""
    if x is None or isinstance(x, (int, bytes)):
        return x
    if isinstance(x, tuple):
        return tuple(_canon(v) for v in x)
    if isinstance(x, list):
        return [_canon(v) for v in x]
    return (type(x).__name__, x.serialize())


def _same_outcome(jax_call, port_call):
    """Both calls raise ValueError, or both return equal values."""
    try:
        want = jax_call()
    except ValueError:
        with pytest.raises(ValueError):
            port_call()
        return None
    got = port_call()
    assert _canon(got) == _canon(want)
    return got


def test_port_exports_the_jax_surface():
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        obj = getattr(T, name)
        assert obj.__module__.startswith("ark_blst_tpu_torch."), name
        assert obj is not getattr(J, name)
    assert T.Gt is T.Fp12
    B = T.Bls12
    assert (B.G1, B.G2, B.G1Affine, B.G2Affine, B.G2Prepared, B.TargetField) == (
        G1Projective, G2Projective, G1Affine, G2Affine, G2Prepared, Gt)


@pytest.mark.parametrize("JF,TF", FIELD_PAIRS, ids=FIELD_IDS)
def test_field_rand_and_operations_match_jax(JF, TF):
    rng_j, rng_t = random.Random(101), random.Random(101)
    for _ in range(3):
        ja, jb = JF.rand(rng_j), JF.rand(rng_j)
        ta, tb = TF.rand(rng_t), TF.rand(rng_t)
        assert (ta.v, tb.v) == (ja.v, jb.v)
        assert ta.serialize() == ja.serialize()
        for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
            assert getattr(ta, op)(tb).v == getattr(ja, op)(jb).v, op
        assert (-ta).v == (-ja).v
        assert ta.inverse().v == ja.inverse().v
        assert ta.double().v == ja.double().v and ta.square().v == ja.square().v
        for e in (0, 1, 5, -3, (1 << 70) + 3):
            assert ta.pow(e).v == ja.pow(e).v, e
        for k in (0, 1, 2, 3, 6, 11):
            assert ta.frobenius_map(k).v == ja.frobenius_map(k).v, k
        for name in ("sqrt", "legendre", "conjugate", "mul_by_nonresidue",
                     "cyclotomic_square", "cyclotomic_inverse"):
            assert hasattr(TF, name) == hasattr(JF, name), name
            if hasattr(JF, name):
                for x, y in ((ta, ja), (ta.square(), ja.square())):
                    assert _canon(getattr(x, name)()) == _canon(getattr(y, name)()), name
    assert TF.zero().inverse() is None and JF.zero().inverse() is None
    if TF.EXTENSION_DEGREE == 1:
        assert (TF(7) + 5).v == (JF(7) + 5).v and (3 - TF(7)).v == (3 - JF(7)).v
        assert int(TF(-1)) == int(JF(-1))


@pytest.mark.parametrize("JG,TG", GROUP_PAIRS, ids=GROUP_IDS)
def test_group_rand_and_operations_match_jax(JG, TG):
    rng_j, rng_t = random.Random(103), random.Random(103)
    ja, jb = JG.rand(rng_j), JG.rand(rng_j)
    ta, tb = TG.rand(rng_t), TG.rand(rng_t)
    assert (ta.p, tb.p) == (ja.p, jb.p)
    k = rng_j.randrange(J.Scalar.MODULUS)
    pairs = [(ta + tb, ja + jb), (ta - tb, ja - jb), (-ta, -ja), (ta.double(), ja.double()),
             (ta.mul(Scalar(k)), ja.mul(J.Scalar(k))), (ta * 7, ja * 7),
             (ta.mul_bigint(k << 3), ja.mul_bigint(k << 3)),
             (ta.mul_by_cofactor(), ja.mul_by_cofactor()),
             (ta.mul_by_cofactor_inv(), ja.mul_by_cofactor_inv()),
             (ta.clear_cofactor(), ja.clear_cofactor()),
             (ta.mul_by_cofactor_to_group(), ja.mul_by_cofactor_to_group())]
    for got, want in pairs:
        assert type(got).__name__ == type(want).__name__
        assert got.p == want.p
    assert (ta.is_on_curve(), ta.is_in_correct_subgroup_assuming_on_curve()) == (
        ja.is_on_curve(), ja.is_in_correct_subgroup_assuming_on_curve())
    assert hash(ta) == hash(TG(ta.p)) and ta == TG(ja.p)
    assert [int(c) if TG._coord_wrap is Fp else c.v for c in ta.xy()] == [
        int(c) if JG._coord_wrap is J.Fp else c.v for c in ja.xy()]
    assert TG.zero().xy() is None and TG.COFACTOR == JG.COFACTOR


def _bad_subgroup_point(g2: bool):
    """The on-curve point of least x (G1) or x = (k, 0) (G2) outside the
    r-torsion subgroup."""
    ops, k = (OC.FP2_OPS, 0) if g2 else (OC.FP_OPS, 0)
    while True:
        k += 1
        x = (k, 0) if g2 else k
        y = (OF.fp2_sqrt if g2 else OF.fp_sqrt)(ops.add(ops.mul(ops.sqr(x), x), ops.b))
        if y is not None and not OC.is_in_subgroup(ops, (x, y)):
            return (x, y)


@pytest.mark.parametrize("JF,TF", FIELD_PAIRS, ids=FIELD_IDS)
def test_field_bytes_match_jax(JF, TF):
    rng = random.Random(107)
    n = JF.serialized_size()
    assert TF.serialized_size() == n
    for a in (JF.zero(), JF.one(), JF.rand(rng), -JF.one()):
        data = a.serialize()
        assert value_from_jax(a).serialize() == data
        assert TF.deserialize(data).v == a.v
        assert TF.deserialize(data + b"\x05").v == a.v  # trailing bytes ignored alike
        assert TF.deserialize_uncompressed(data).serialize_uncompressed() == data
    p = JF.MODULUS if hasattr(JF, "MODULUS") else OF.P
    width = 32 if JF is J.Scalar else 48
    for bad in (b"\xff" * n, b"\x00" * (n - 1), p.to_bytes(width, "little") * (n // width)):
        _same_outcome(lambda: JF.deserialize(bad), lambda: TF.deserialize(bad))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_bytes_and_rejections_match_jax(g2):
    JA, TA = (J.G2Affine, G2Affine) if g2 else (J.G1Affine, G1Affine)
    JP, TP = (J.G2Projective, G2Projective) if g2 else (J.G1Projective, G1Projective)
    rng = random.Random(109)
    good = [JA.generator(), JA.zero(), JA.rand(rng), -JA.generator()]
    encodings = []
    for pt in good:
        for compress in (True, False):
            data = pt.serialize(compress)
            assert TA(pt.p).serialize(compress) == data
            assert TP(pt.p).serialize(compress) == data
            assert TA.deserialize(data, compress).p == pt.p
            assert TP.deserialize(data, compress, validate=False).p == pt.p
            encodings.append((compress, data))
    bad_pt = _bad_subgroup_point(g2)
    c, u = JA(bad_pt).serialize(True), JA(bad_pt).serialize(False)
    size_c = len(c)
    crafted = [
        (True, c), (False, u),  # on the curve, outside the subgroup
        (True, bytes([c[0] & 0x7F]) + c[1:]),  # compressed flag cleared
        (False, bytes([u[0] | 0x80]) + u[1:]),  # compressed flag on an uncompressed input
        (True, bytes([0xC0]) + b"\x00" * (size_c - 2) + b"\x01"),  # infinity with a payload
        (True, bytes([0xE0]) + b"\x00" * (size_c - 1)),  # infinity with the sign flag
        (False, bytes([0x40]) + b"\x00" * (2 * size_c - 2) + b"\x01"),
        (True, bytes([0x9F]) + b"\xff" * (size_c - 1)),  # x not canonical
        (False, u[: size_c] + b"\xff" * size_c),  # y not canonical
        (True, c[:-1]), (False, u[:-1]),  # short
    ]
    # an x with no point on the curve
    for x0 in range(1, 50):
        x = (x0, 0) if g2 else x0
        ops = OC.FP2_OPS if g2 else OC.FP_OPS
        rhs = ops.add(ops.mul(ops.sqr(x), x), ops.b)
        if (OF.fp2_sqrt if g2 else OF.fp_sqrt)(rhs) is None:
            body = (b"\x00" * 48 + x0.to_bytes(48, "big")) if g2 else x0.to_bytes(48, "big")
            crafted.append((True, bytes([body[0] | 0x80]) + body[1:]))
            break
    # a point off the curve, uncompressed
    off = bytearray(u)
    off[-1] ^= 1
    crafted.append((False, bytes(off)))
    for compress, data in encodings + crafted:
        for validate in (True, False):
            for JC, TC in ((JA, TA), (JP, TP)):
                _same_outcome(lambda: JC.deserialize(data, compress, validate),
                              lambda: TC.deserialize(data, compress, validate))


RANDOM_BYTES = [b"", b"\x07", b"\x2a" + b"\x00" * 30 + b"\xc0", b"\x2a" + b"\x00" * 31 + b"\xc0",
                b"\xff" * 31, b"\xff" * 32, b"\xff" * 33, b"\xff" * 34, b"\xff" * 47,
                b"\xff" * 48, b"\xff" * 49, b"\x01" + b"\x00" * 32, b"\x01" + b"\x00" * 47,
                OF.R.to_bytes(32, "little"), OF.P.to_bytes(48, "little"),
                (5 | 1 << 255).to_bytes(32, "little"), (77 | 1 << 381).to_bytes(48, "little")]


@pytest.mark.parametrize("JF,TF", [(J.Fp, Fp), (J.Scalar, Scalar)], ids=["Fp", "Scalar"])
def test_from_random_bytes_matches_jax(JF, TF):
    rng = random.Random(113)
    inputs = RANDOM_BYTES + [rng.randbytes(k) for k in (16, 31, 32, 33, 47, 48, 49)]
    for data in inputs:
        for mask in (0, 0x80, 0x40, 0xC0):
            assert _canon(TF.from_random_bytes_with_flags(data, mask)) == _canon(
                JF.from_random_bytes_with_flags(data, mask)), (data.hex(), mask)
        assert _canon(TF.from_random_bytes(data)) == _canon(JF.from_random_bytes(data))
        assert TF.from_le_bytes_mod_order(data).v == JF.from_le_bytes_mod_order(data).v


def test_conversions_cast_and_sponge_match_jax():
    rng = random.Random(127)
    for JF, TF in ((J.Fp, Fp), (J.Scalar, Scalar)):
        m = JF.characteristic()
        assert TF.characteristic() == m and TF.MODULUS == JF.MODULUS
        for v in (0, 1, m - 1, m, rng.randrange(m)):
            assert _canon(TF.from_bigint(v)) == _canon(JF.from_bigint(v))
            _same_outcome(lambda: JF.from_str(str(v)), lambda: TF.from_str(str(v)))
        a = TF.rand(random.Random(5))
        assert a.into_bigint() == JF.rand(random.Random(5)).into_bigint()
    for JF, TF in FIELD_PAIRS[2:]:
        assert TF.characteristic() == JF.characteristic() == OF.P
        elems = [J.Fp.rand(rng) for _ in range(TF.EXTENSION_DEGREE)]
        if hasattr(JF, "from_base_prime_field_elems"):
            port = TF.from_base_prime_field_elems([Fp(e.v) for e in elems])
            assert port.v == JF.from_base_prime_field_elems(elems).v
            assert TF.from_base_prime_field_elems([Fp(1)]) is None
    s = J.Scalar.rand(rng)
    t = value_from_jax(s)
    assert t.to_sponge_bytes() == s.to_sponge_bytes()
    assert [x.v for x in t.to_sponge_field_elements()] == [x.v for x in s.to_sponge_field_elements()]
    assert [x.v for x in t.to_sponge_field_elements(Scalar)] == [
        x.v for x in s.to_sponge_field_elements(J.Scalar)]
    f = J.Fp.rand(rng)
    assert field_cast(value_from_jax(f), Fp).v == J.field_cast(f, J.Fp).v
    _same_outcome(lambda: J.field_cast(s, J.Fp), lambda: field_cast(t, Fp))
    assert (Scalar.TWO_ADICITY, Scalar.GENERATOR.v, Scalar.TWO_ADIC_ROOT_OF_UNITY.v) == (
        J.Scalar.TWO_ADICITY, J.Scalar.GENERATOR.v, J.Scalar.TWO_ADIC_ROOT_OF_UNITY.v)
    assert (Fp12.INVERSE_IS_FAST, G1Projective.NEGATION_IS_CHEAP) == (
        J.Fp12.INVERSE_IS_FAST, J.G1Projective.NEGATION_IS_CHEAP)
    g = J.Bls12.pairing(J.G1Affine.generator(), J.G2Affine.generator(), backend="host")
    assert value_from_jax(g).cyclotomic_exp(-12345).v == g.cyclotomic_exp(-12345).v


def test_g2_prepared_bytes_match_jax():
    rng = random.Random(131)
    jq = J.G2Affine.rand(rng)
    jprep = J.G2Prepared.from_affine(jq)
    prep = G2Prepared.from_affine(G2Affine(jq.p))
    assert prep.serialize() == jprep.serialize()
    assert prep == G2Prepared.from_projective(G2Projective(jq.p)) == value_from_jax(jprep)
    assert G2Prepared.deserialize(jprep.serialize()) == prep
    assert G2Prepared.serialized_size() == J.G2Prepared.serialized_size()
    ident = G2Prepared.from_affine(G2Affine.zero())
    assert ident.serialize() == J.G2Prepared.from_affine(J.G2Affine.zero()).serialize() == b"\x01"
    assert G2Prepared.default().serialize() == J.G2Prepared.default().serialize()
    for bad in (b"", b"\x00" + b"\x00" * 10):
        _same_outcome(lambda: J.G2Prepared.deserialize(bad), lambda: G2Prepared.deserialize(bad))


def test_g2_prepared_rejects_flags_outside_0_1_unlike_jax():
    """The deliberate difference: the JAX package reads any first byte other
    than 1 as "not the identity"; the port accepts only the flags 0 and 1."""
    data = J.G2Prepared.default().serialize()
    for flag in (2, 0x80, 0xFF):
        bad = bytes([flag]) + data[1:]
        assert not J.G2Prepared.deserialize(bad).is_identity()
        with pytest.raises(ValueError, match="identity flag"):
            G2Prepared.deserialize(bad)


def test_value_from_jax_round_trips():
    rng = random.Random(137)
    objs = [jc.rand(rng) for jc, _ in FIELD_PAIRS + GROUP_PAIRS]
    objs += [J.G1Affine.zero(), J.G2Projective.zero(), J.G2Prepared.default(),
             J.G2Prepared.from_affine(J.G2Affine.zero())]
    for j in objs:
        t = value_from_jax(j)
        assert type(t).__module__.startswith("ark_blst_tpu_torch.")
        assert type(t).__name__ == type(j).__name__
        assert t.serialize() == j.serialize()
    mlo = J.Bls12.multi_miller_loop([J.G1Affine.generator()], [J.G2Affine.generator()],
                                    backend="host")
    t = value_from_jax(mlo)
    assert isinstance(t, T.MillerLoopOutput) and t.f.serialize() == mlo.f.serialize()
    assert Bls12.final_exponentiation(t).v == J.Bls12.final_exponentiation(mlo).v
    assert t == T.MillerLoopOutput(t.f.v)
    with pytest.raises(TypeError):
        value_from_jax(object())


def _msm_inputs(JA, n, seed):
    rng = random.Random(seed)
    bases = [JA.rand(rng) for _ in range(n)]
    bases[1] = JA.zero()
    scalars = [J.Scalar.rand(rng) for _ in range(n)]
    scalars[3] = J.Scalar.zero()
    scalars[4] = J.Scalar(1)
    return bases, scalars


def test_g2_msm_device_route_matches_jax_host_route():
    """G2 at c=3 (the G1 device route against JAX's host route is in
    `test_torch_api_vectors.py`, on a vector's inputs)."""
    bases, scalars = _msm_inputs(J.G2Affine, 6, 142)
    want = J.G2Projective.msm(bases, scalars, backend="host")
    tb = [value_from_jax(b) for b in bases]
    ts = [value_from_jax(s) for s in scalars]
    got = G2Projective.msm(tb, ts, c=3, device="cpu")  # backend=None: the device route
    assert type(got) is G2Projective and got.p == want.p
    assert got.serialize() == want.serialize()
    assert G2Projective.msm(tb, [s.v for s in ts], backend="host").p == want.p
    assert G2Projective.msm([], [], device="cpu").is_zero()
    assert G2Projective.msm([], [], backend="host").is_zero()


def test_msm_rejects_bad_calls_and_aborts():
    g = G1Affine.generator()
    with pytest.raises(ValueError):
        G1Projective.msm([g], [Scalar(1), Scalar(2)], device="cpu")
    with pytest.raises(ValueError):
        G1Projective.msm([g], [Scalar(1)], backend="tpu", device="cpu")
    with pytest.raises(T.MsmAborted):
        G1Projective.msm([g], [Scalar(1)], c=3, maybe_abort=lambda: True, device="cpu")


def _pairing_inputs():
    rng = random.Random(149)
    ps = [J.G1Affine.rand(rng) for _ in range(4)]
    qs = [J.G2Affine.rand(rng) for _ in range(4)]
    ps[1], qs[2] = J.G1Affine.zero(), J.G2Affine.zero()
    want = [J.Bls12.pairing(p, q, backend="host") for p, q in zip(ps, qs)]
    return ps, qs, want


def test_pairing_batch_device_route_matches_jax():
    ps, qs, want = _pairing_inputs()
    tp = [value_from_jax(p) for p in ps]
    tq = [value_from_jax(q) for q in qs]
    tp[0] = G1Projective(tp[0].p)  # projective inputs are taken as well
    tq[3] = G2Projective(tq[3].p)
    got = Bls12.pairing_batch(tp, tq, device="cpu")
    assert all(isinstance(g, Gt) for g in got)
    assert [g.serialize() for g in got] == [w.serialize() for w in want]
    assert got[1].is_one() and got[2].is_one()
    prep = Bls12.prepare_g2_batch(tq, device="cpu")
    assert prep.n == 4
    assert Bls12.pairing_batch(tp, prep, device="cpu") == got
    with pytest.raises(ValueError):
        Bls12.pairing_batch(tp, [G2Prepared.default()] * 4, device="cpu")
    with pytest.raises(TypeError):
        Bls12.pairing_batch(tq, tp, device="cpu")


def test_multi_miller_loop_device_route_matches_jax():
    ps, qs, want = _pairing_inputs()
    tp, tq = [value_from_jax(p) for p in ps], [value_from_jax(q) for q in qs]
    mlo = Bls12.multi_miller_loop(tp, tq, device="cpu")  # backend=None: the device route
    jmlo = J.Bls12.multi_miller_loop(ps, qs, backend="host")
    assert isinstance(mlo, T.MillerLoopOutput) and mlo.f.v == jmlo.f.v
    out = Bls12.final_exponentiation(mlo)
    prod = want[0] * want[1] * want[2] * want[3]
    assert out.serialize() == prod.serialize()
    # a host G2Prepared selects the host route; on the device route it raises
    prepared = [G2Prepared.from_affine(q) for q in tq]
    assert Bls12.multi_miller_loop(tp, prepared) == mlo
    with pytest.raises(ValueError):
        Bls12.multi_miller_loop(tp, prepared, backend="device", device="cpu")
    assert Bls12.multi_miller_loop([], []).f.is_one()
    assert Bls12.multi_pairing(tp, tq, backend="host").v == prod.v
