"""The pairing entry points of the port.

`Bls12` is the counterpart of `ark_blst_tpu/bls12.py:Bls12`, the arkworks
`Pairing` engine on the API's value classes (`groups.py`, `fields.py`):
`multi_miller_loop`, `final_exponentiation`, `pairing`, `multi_pairing`
and the batch entries `prepare_g2_batch` / `pairing_batch`. Its device
routes run on the functions below, which take affine int tuples (None =
the identity, which yields one):

* `pairing_batch`, `prepare_g2_batch`, `multi_pairing` and
  `multi_miller_loop` on tuples, the role of the JAX package's
  `_device_multi_miller`;
* `pairing` on strict limb tensors, as `msm_g1` takes them.

All of them run on the card by default and raise without one
(`resolve_device`); `device="cpu"` runs the kernels' plain versions.
`fuse=` and `engine=` choose the pipeline as in the JAX package
(`curves/pairing.py`), for either engine: the lazy engine (the default)
fused on K5-chain, K6-chain, FE-easy and FE-hard or unfused on K11, K12,
K3 and K4; the strict engine fused on the same chains with strict-limb
edges (its multi-pairings' product fold on K4) or unfused on K7-K10. The
final
exponentiation of `Bls12.multi_miller_loop`'s output runs on the host
oracle, as in the JAX package.
"""

from __future__ import annotations

import torch

from .curves import pairing as PR
from .curves.pairing import DeviceG2Prepared
from .device import resolve_device
from .fields import Fp12, Gt
from .groups import G1Affine, G1Projective, G2Affine, G2Prepared, G2Projective
from .ops import convert as CV
from .oracle import field as OF
from .oracle import pairing as OP


def _g1_batch(ps, dev):
    """Affine G1 points -> strict (px, py) on dev and the identity mask; the
    generator stands in for an identity."""
    inf = torch.tensor([p is None for p in ps], dtype=torch.bool, device=dev)
    pv = [OF.G1_GEN if p is None else p for p in ps]
    return (CV.fp_to_dev([p[0] for p in pv]).to(dev), CV.fp_to_dev([p[1] for p in pv]).to(dev)), inf


def _g2_batch(qs, dev):
    """Affine G2 points -> strict fp2 (qx, qy) on dev and the identity mask."""
    inf = torch.tensor([q is None for q in qs], dtype=torch.bool, device=dev)
    qv = [OF.G2_GEN if q is None else q for q in qs]
    qx, qy = CV.fp2_to_dev([q[0] for q in qv]), CV.fp2_to_dev([q[1] for q in qv])
    return (tuple(x.to(dev) for x in qx), tuple(x.to(dev) for x in qy)), inf


def pairing(p, q, *, p_inf=None, q_inf=None, fuse=True, engine="lazy", device="cuda"):
    """Elementwise pairings e(P_i, Q_i) on strict limb tensors.

    p = (px, py): Montgomery-R16 (24, N) int32 limbs of affine G1 points;
    q = ((qx0, qx1), (qy0, qy1)): the same for affine G2 points over Fp2;
    p_inf, q_inf: optional (N,) bool identity masks (those pairs yield one;
    their coordinates must still be finite field elements); fuse, engine:
    the pipeline ("lazy" or "strict"; for either, `fuse` chooses the
    chain kernels or the unfused route). Returns the strict fp12 batch,
    nested like the oracle's values, each leaf (24, N) on `device`."""
    dev = resolve_device(device)
    p = tuple(x.to(dev, torch.int32) for x in p)
    q = tuple(tuple(x.to(dev, torch.int32) for x in c) for c in q)
    n = p[0].shape[-1]
    if any(x.shape != (24, n) for x in p + q[0] + q[1]):
        raise ValueError("pairing wants (24, N) coordinates")
    p_inf = None if p_inf is None else p_inf.to(dev, torch.bool)
    q_inf = None if q_inf is None else q_inf.to(dev, torch.bool)
    return PR.pairing(p, q, p_inf, q_inf, fuse, engine)


# --- the batch pipeline on affine int tuples ----------------------------------

def prepare_g2_batch(qs, fuse=True, device="cuda") -> DeviceG2Prepared:
    """G2 line coefficients of every affine point of qs, kept on the device
    for reuse by `pairing_batch` (under either `fuse`): fuse=True one K5
    launch, the stack (68, 6, 12, N) canonical 32-bit words; fuse=False
    the prepare steps on the tower (K1), the same coefficients as (68, 6,
    30, N) digits. `DeviceG2Prepared.layout` says which."""
    dev = resolve_device(device)
    q, q_inf = _g2_batch(list(qs), dev)
    return PR.prepare_g2_device(q, q_inf, fuse)


def pairing_batch(ps, qs, fuse=True, device="cuda") -> list:
    """[e(P_i, Q_i)] as oracle fp12 tuples; qs is a list of affine G2
    points or a `DeviceG2Prepared` from `prepare_g2_batch`. fuse=True
    runs the Miller events through K6 (and the prepare through K5),
    fuse=False through K11 and K12, to the same results."""
    dev = resolve_device(device)
    ps = list(ps)
    if not ps:
        return []
    p, p_inf = _g1_batch(ps, dev)
    if isinstance(qs, DeviceG2Prepared):
        if qs.stacked.device != dev:
            raise ValueError(f"prepared G2 points on {qs.stacked.device}, pairing on {dev}")
        out = PR.pairing_prepared(p, qs, p_inf, fuse)
    else:
        qs = list(qs)
        if len(qs) != len(ps):
            raise ValueError(f"{len(ps)} G1 points but {len(qs)} G2 points")
        q, q_inf = _g2_batch(qs, dev)
        out = PR.pairing(p, q, p_inf, q_inf, fuse)
    return CV.fp12_from_dev(out)


def _product(ps, qs, device, product):
    """One fp12 over the pairs as an oracle tuple: `product` of the
    strict batches (the Miller product, or with its final exponentiation);
    one for no pairs."""
    dev = resolve_device(device)
    ps, qs = list(ps), list(qs)
    if len(qs) != len(ps):
        raise ValueError(f"{len(ps)} G1 points but {len(qs)} G2 points")
    if not ps:
        return OF.FP12_ONE
    (p, p_inf), (q, q_inf) = _g1_batch(ps, dev), _g2_batch(qs, dev)
    return CV.fp12_from_dev(product(p, q, p_inf, q_inf))[0]


def multi_miller_loop(ps, qs, device="cuda"):
    """prod_i of the Miller loops of (P_i, Q_i) as an oracle fp12 tuple, not
    final-exponentiated; pairs holding an identity contribute one."""
    return _product(ps, qs, device, PR.multi_miller_loop)


def multi_pairing(ps, qs, device="cuda"):
    """prod_i e(P_i, Q_i) as an oracle fp12 tuple: the product of the
    Miller loops, then one final exponentiation on the device."""
    return _product(ps, qs, device, PR.multi_pairing)


# --- the arkworks engine ------------------------------------------------------

class MillerLoopOutput:
    """Un-exponentiated Miller product (arkworks `MillerLoopOutput`)."""

    __slots__ = ("f",)

    def __init__(self, f: Fp12):
        self.f = f if isinstance(f, Fp12) else Fp12(f)

    def __eq__(self, other):
        return isinstance(other, MillerLoopOutput) and self.f == other.f

    def __repr__(self):
        return f"MillerLoopOutput({self.f!r})"


def _as_g1_affine(p) -> G1Affine:
    if isinstance(p, G1Projective):
        return p.into_affine()
    if isinstance(p, G1Affine):
        return p
    raise TypeError(f"expected G1 point, got {type(p).__name__}")


def _as_g2_affine(q) -> G2Affine:
    if isinstance(q, G2Projective):
        return q.into_affine()
    if isinstance(q, G2Affine):
        return q
    raise TypeError(f"expected G2 point, got {type(q).__name__}")


def _as_g2_prepared(q) -> G2Prepared:
    if isinstance(q, G2Prepared):
        return q
    return G2Prepared.from_affine(_as_g2_affine(q))


class Bls12:
    """The pairing engine (ark-blst src/pairing.rs:34-81).

    Host path: the oracle pairing (projective line coefficients, sparse
    014 products, the cyclotomic final exponentiation: the algorithm the
    device pipeline runs). Device path: `multi_miller_loop` with
    backend="device" (the default whenever no host `G2Prepared` is among
    the inputs), `prepare_g2_batch` and `pairing_batch`, on `device`.
    """

    # type bindings, mirroring src/pairing.rs:42-45
    G1 = G1Projective
    G2 = G2Projective
    G1Affine = G1Affine
    G2Affine = G2Affine
    G2Prepared = G2Prepared
    TargetField = Gt

    @staticmethod
    def multi_miller_loop(ps, qs, backend: str | None = None, *,
                          device="cuda") -> MillerLoopOutput:
        """Product of Miller loops over pairs; identity pairs contribute one
        (src/pairing.rs:49-74). `qs` entries may be G2 points or G2Prepared.
        backend: None (the device unless a G2Prepared is among `qs` or the
        input is empty), "host", or "device"."""
        ps = [_as_g1_affine(p) for p in ps]
        if len(ps) != len(qs):
            raise ValueError(f"{len(ps)} G1 points but {len(qs)} G2 points")
        has_prepared = any(isinstance(q, G2Prepared) for q in qs)
        if backend is None:
            backend = "device" if not has_prepared and ps else "host"

        if backend == "device":
            if has_prepared:
                raise ValueError("device path takes raw G2 points, not G2Prepared")
            qs = [_as_g2_affine(q) for q in qs]
            f = multi_miller_loop([p.p for p in ps], [q.p for q in qs], device=device)
            return MillerLoopOutput(Fp12(f))
        if backend != "host":
            raise ValueError(f"unknown pairing backend {backend!r}")

        qs = [_as_g2_prepared(q) for q in qs]
        f = OP.FP12_ONE
        for p, q in zip(ps, qs):
            if p.is_zero() or q.is_identity():
                continue  # substitute one, src/pairing.rs:58-60
            f = OF.fp12_mul(f, OP.miller_loop(p.p, q.coeffs))
        return MillerLoopOutput(Fp12(f))

    @staticmethod
    def final_exponentiation(mlo: MillerLoopOutput) -> Gt:
        """f -> f^((p^12-1)/r) via the easy part and the cyclotomic chain
        (src/pairing.rs:76-80), on the host oracle."""
        f = mlo.f if isinstance(mlo, MillerLoopOutput) else mlo
        return Gt(OP.final_exp(f.v if isinstance(f, Fp12) else f))

    @classmethod
    def pairing(cls, p, q, backend: str | None = None, *, device="cuda") -> Gt:
        """e(P, Q); identity inputs yield one."""
        return cls.final_exponentiation(
            cls.multi_miller_loop([p], [q], backend, device=device))

    @classmethod
    def multi_pairing(cls, ps, qs, backend: str | None = None, *, device="cuda") -> Gt:
        """prod_i e(P_i, Q_i)."""
        return cls.final_exponentiation(
            cls.multi_miller_loop(ps, qs, backend, device=device))

    @staticmethod
    def prepare_g2_batch(qs, fuse=True, *, device="cuda") -> DeviceG2Prepared:
        """G2 line coefficients of G2Affine/G2Projective points, kept on
        the device as a `DeviceG2Prepared` for reuse across `pairing_batch`
        calls: the amortization of `G2Prepared` (src/g2.rs:650-694) on the
        device path."""
        return prepare_g2_batch([_as_g2_affine(q).p for q in qs], fuse, device)

    @staticmethod
    def pairing_batch(ps, qs, fuse=True, *, device="cuda") -> list:
        """Elementwise batched pairings on the device: [e(P_i, Q_i)] as a
        list of Gt. `qs` may be a list of G2 points or a `DeviceG2Prepared`
        from `prepare_g2_batch` (prepare once, pair many)."""
        pv = [_as_g1_affine(p).p for p in ps]
        if not isinstance(qs, DeviceG2Prepared):
            if any(isinstance(q, G2Prepared) for q in qs):
                raise ValueError(
                    "device path takes raw G2 points or a DeviceG2Prepared "
                    "(Bls12.prepare_g2_batch), not host G2Prepared")
            qs = [_as_g2_affine(q).p for q in qs]
        return [Gt(v) for v in pairing_batch(pv, qs, fuse, device)]
