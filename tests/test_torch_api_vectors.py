"""The frozen cross-implementation vectors (`tests/vectors/bls12_381.json`)
through the port's arkworks API surface.

The twins of every test of `tests/test_vectors.py`, on the port's classes
(the host routes, as there), then the same known answers through the
device routes with device="cpu", where each kernel is its plain version:
the generator pairing's bytes through `Bls12.pairing` and
`Bls12.pairing_batch`, and an `msm_g1` vector through `G1Projective.msm`
at the window c=3, also against the JAX package's host route. Any drift
of a byte format or of a device route's value fails here. (The card
tests run every `msm_g1` vector through the device route.)
"""

import json
import os

import pytest
import torch

import ark_blst_tpu as J
from ark_blst_tpu_torch import (
    Bls12,
    Fp,
    Fp2,
    Fp12,
    G1Affine,
    G2Affine,
    G1Projective,
    Scalar,
)


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the cores among pytest-xdist workers while the module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "bls12_381.json")

with open(VEC_PATH) as f:
    VECS = json.load(f)


def test_fp_vectors():
    for v in VECS["fp"]:
        a = Fp(int(v["value"], 16))
        assert a.serialize().hex() == v["bytes"]
        assert Fp.deserialize(bytes.fromhex(v["bytes"])) == a


def test_scalar_vectors():
    for v in VECS["scalar"]:
        a = Scalar(int(v["value"], 16))
        assert a.serialize().hex() == v["bytes"]
        assert Scalar.deserialize(bytes.fromhex(v["bytes"])) == a


def test_fp2_vectors():
    for v in VECS["fp2"]:
        a = Fp2((int(v["value"][0], 16), int(v["value"][1], 16)))
        assert a.serialize().hex() == v["bytes"]
        assert Fp2.deserialize(bytes.fromhex(v["bytes"])) == a


@pytest.mark.parametrize("group,Aff", [("g1", G1Affine), ("g2", G2Affine)])
def test_group_vectors(group, Aff):
    gen = Aff.generator()
    for v in VECS[group]:
        if v["scalar"] == "inf":
            pt = Aff.zero()
        else:
            pt = Aff(gen.mul_bigint(int(v["scalar"], 16)).p)
        assert pt.serialize_compressed().hex() == v["compressed"]
        assert pt.serialize_uncompressed().hex() == v["uncompressed"]
        assert Aff.deserialize_compressed(bytes.fromhex(v["compressed"])) == pt
        assert Aff.deserialize_uncompressed(bytes.fromhex(v["uncompressed"])) == pt


def test_g1_generator_is_public_constant():
    """External anchor: the well-known ZCash/blst generator encodings."""
    assert G1Affine.generator().serialize_compressed().hex() == (
        "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
        "6c55e83ff97a1aeffb3af00adb22c6bb"
    )
    assert G2Affine.generator().serialize_compressed().hex() == (
        "93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
        "334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051"
        "c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8"
    )


def test_second_ecosystem_known_answers():
    """Second-implementation anchors beyond the generator encodings:
    values published by INDEPENDENT ecosystems, transcribed here and
    checked against this framework's public API, restoring the
    two-independent-implementations property of ark-blst
    src/tests.rs:73-96 for group arithmetic and the pairing itself.

    Provenance:
    * 2*G1 and 2*G2 affine coordinates: EIP-2537 (BLS12-381 precompiles)
      G1ADD/G2ADD reference test vectors (geth/consensus test suites).
    * e(G1gen, G2gen) leading Fp coefficient (c0.c0.c0): the Gt generator
      value printed identically by zkcrypto `bls12_381`, noble-curves and
      matter-labs' EIP-1962/2537 implementations.
    """
    # --- 2*G1 (EIP-2537 G1ADD: G1 + G1) ---
    x2 = 0x0572cbea904d67468808c8eb50a9450c9721db309128012543902d0ac358a62ae28f75bb8f1c7c42c39a8c5529bf0f4e
    y2 = 0x166a9d8cabc673a322fda673779d8e3822ba3ecb8670e461f73bb9021d5fd76a4c56d9d4cd16bd1bba86881979749d28
    d1 = (G1Affine.generator() + G1Affine.generator()).into_affine()
    got_x, got_y = d1.xy()
    assert int(got_x) == x2 and int(got_y) == y2

    # --- 2*G2 (EIP-2537 G2ADD: G2 + G2) ---
    x2_c0 = 0x1638533957d540a9d2370f17cc7ed5863bc0b995b8825e0ee1ea1e1e4d00dbae81f14b0bf3611b78c952aacab827a053
    x2_c1 = 0x0a4edef9c1ed7f729f520e47730a124fd70662a904ba1074728114d1031e1572c6c886f6b57ec72a6178288c47c33577
    y2_c0 = 0x0468fb440d82b0630aeb8dca2b5256789a66da69bf91009cbfe6bd221e47aa8ae88dece9764bf3bd999d95d71e4c9899
    y2_c1 = 0x0f6d4552fa65dd2638b361543f887136a43253d9c66c411697003f7a13c308f5422e1aa0a59c8967acdefd8b6e36ccf3
    d2 = (G2Affine.generator() + G2Affine.generator()).into_affine()
    g2x, g2y = d2.xy()
    assert g2x == Fp2((x2_c0, x2_c1)) and g2y == Fp2((y2_c0, y2_c1))

    # --- e(G1gen, G2gen).c0.c0.c0 (Gt generator leading coefficient) ---
    c000 = 0x1250ebd871fc0a92a7b2d83168d0d727272d441befa15c503dd8e90ce98db3e7b6d194f60839c508a84305aaca1789b6
    e = Bls12.pairing(G1Affine.generator(), G2Affine.generator(), backend="host")
    # Fp12 serialization is 12 x 48-byte raw-LE Fp coefficients, c0.c0.c0 first
    assert e.serialize()[:48] == c000.to_bytes(48, "little")


def test_g1_invalid_encodings_rejected():
    for v in VECS["g1_invalid"]:
        with pytest.raises(ValueError):
            G1Affine.deserialize_compressed(bytes.fromhex(v["bytes"]))


def test_pairing_vectors():
    e = Bls12.pairing(G1Affine.generator(), G2Affine.generator(), backend="host")
    assert e.serialize().hex() == VECS["pairing"]["e_g1gen_g2gen"]
    e2 = Bls12.pairing(
        G1Affine.generator().mul(3).into_affine(),
        G2Affine.generator().mul(5).into_affine(),
        backend="host",
    )
    assert e2.serialize().hex() == VECS["pairing"]["e_3g1_5g2"]
    assert e2 == e.pow(15)
    assert Fp12.deserialize(bytes.fromhex(VECS["pairing"]["e_g1gen_g2gen"])) == e


def test_msm_vectors():
    for v in VECS["msm_g1"]:
        pts = [
            G1Affine.deserialize_compressed(bytes.fromhex(h))
            for h in v["points_compressed"]
        ]
        scs = [Scalar(int(s, 16)) for s in v["scalars"]]
        out = G1Projective.msm(pts, scs, backend="host")
        assert out.into_affine().serialize_compressed().hex() == v["result_compressed"]



# --- the same known answers through the device routes ---------------------------

def test_pairing_vectors_device_route():
    g1, g2 = G1Affine.generator(), G2Affine.generator()
    e = Bls12.pairing(g1, g2, device="cpu")  # backend=None: the device Miller loop
    assert e.serialize().hex() == VECS["pairing"]["e_g1gen_g2gen"]
    got = Bls12.pairing_batch([g1, g1.mul(3)], [g2, g2.mul(5)], device="cpu")
    assert [x.serialize().hex() for x in got] == [
        VECS["pairing"]["e_g1gen_g2gen"], VECS["pairing"]["e_3g1_5g2"]]


def test_msm_vector_device_route_matches_jax_host_route():
    """The 10-point vector, with an identity base and a zero scalar added
    (which leave its result as it is), through the device route at c=3:
    equal to its checked-in result and to the JAX package's host route."""
    v = VECS["msm_g1"][1]
    pts = [G1Affine.deserialize_compressed(bytes.fromhex(h)) for h in v["points_compressed"]]
    scs = [Scalar(int(s, 16)) for s in v["scalars"]]
    pts += [G1Affine.zero(), G1Affine.generator()]
    scs += [Scalar(12345), Scalar.zero()]
    out = G1Projective.msm(pts, scs, c=3, device="cpu")  # backend=None: the device route
    assert out.into_affine().serialize_compressed().hex() == v["result_compressed"]
    want = J.G1Projective.msm([J.G1Affine(p.p) for p in pts], [J.Scalar(s.v) for s in scs],
                              backend="host")
    assert out.p == want.p and out.serialize() == want.serialize()
