"""The pairing entry points of the port.

`Bls12` mirrors the device path of `ark_blst_tpu/bls12.py:Bls12` on affine
int tuples (None = the identity, which yields one), and `pairing` takes
strict limb tensors, as `msm_g1` does. All of them run on the card by
default and raise without one (`resolve_device`); `device="cpu"` runs the
kernels' plain versions. `fuse=` and `engine=` choose the pipeline as in
the JAX package (`curves/pairing.py`): the lazy engine fused (K5, K6; the
default) or unfused (K11, K12), or the strict engine (K7-K10).
"""

from __future__ import annotations

import torch

from .curves import pairing as PR
from .curves.pairing import DeviceG2Prepared
from .device import resolve_device
from .ops import convert as CV
from .oracle import field as OF


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
    the pipeline ("lazy" or "strict"; `fuse` chooses among the lazy
    engine's kernels). Returns the strict fp12 batch, nested like the
    oracle's values, each leaf (24, N) on `device`."""
    dev = resolve_device(device)
    p = tuple(x.to(dev, torch.int32) for x in p)
    q = tuple(tuple(x.to(dev, torch.int32) for x in c) for c in q)
    n = p[0].shape[-1]
    if any(x.shape != (24, n) for x in p + q[0] + q[1]):
        raise ValueError("pairing wants (24, N) coordinates")
    p_inf = None if p_inf is None else p_inf.to(dev, torch.bool)
    q_inf = None if q_inf is None else q_inf.to(dev, torch.bool)
    return PR.pairing(p, q, p_inf, q_inf, fuse, engine)


class Bls12:
    """The pairing engine at the level of affine int tuples."""

    @staticmethod
    def prepare_g2_batch(qs, fuse=True, device="cuda") -> DeviceG2Prepared:
        """G2 line coefficients of every point of qs, kept on the device for
        reuse by `pairing_batch`; fuse=False runs the prepare steps on the
        tower (K1) instead of K5, to the same coefficients."""
        dev = resolve_device(device)
        q, q_inf = _g2_batch(list(qs), dev)
        return PR.prepare_g2_device(q, q_inf, fuse)

    @staticmethod
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

    @staticmethod
    def multi_pairing(ps, qs, device="cuda"):
        """prod_i e(P_i, Q_i) as an oracle fp12 tuple: the product of the
        Miller loops, then one final exponentiation."""
        dev = resolve_device(device)
        ps, qs = list(ps), list(qs)
        if len(qs) != len(ps):
            raise ValueError(f"{len(ps)} G1 points but {len(qs)} G2 points")
        if not ps:
            return OF.FP12_ONE
        (p, p_inf), (q, q_inf) = _g1_batch(ps, dev), _g2_batch(qs, dev)
        return CV.fp12_from_dev(PR.multi_pairing(p, q, p_inf, q_inf))[0]
