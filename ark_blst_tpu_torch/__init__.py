"""BLS12-381 on PyTorch and hand-written CUDA kernels for Hopper (H100).

The port of `ark_blst_tpu` (JAX, Pallas on a TPU), slice by slice. It
exports every name of the JAX package's arkworks surface, as its own
classes:

* the fields `Fp`, `Scalar`, `Fp2`, `Fp6`, `Fp12` (`Gt`) and `field_cast`
  (`fields.py`);
* the groups `G1Affine`, `G1Projective`, `G2Affine`, `G2Projective` and
  `G2Prepared` with ZCash serialization (`groups.py`); `msm` runs the
  card's bucket MSM by default;
* the engine `Bls12` and `MillerLoopOutput` (`bls12.py`), whose
  `multi_miller_loop`, `prepare_g2_batch` and `pairing_batch` run the
  card's pairing by default.

Beside them, the port's own entry points:

* `msm_g1(points, scalars, device=...)` and `msm_g2(...)` on stacked
  strict limb tensors;
* `G1.msm(bases, scalars, device=...)` and `G2.msm(...)` on affine int
  tuples;
* `pairing(p, q, ...)` on strict limb tensors, and `bls12.pairing_batch`,
  `bls12.prepare_g2_batch`, `bls12.multi_pairing` on affine int tuples;
  `fuse=False` runs the unfused lazy pairing (K11, K12), and `pairing`'s
  `engine="strict"` the pairing on the strict tower (K7-K10);
* the strict radix-16 engine's scan Pippenger MSM,
  `curves.msm.msm(points, scalars, curve, device=...)` and `msm_naive`, on
  the complete group law of `curves.group` (`G1`, `G2`), and
  `curves.msm.msm_auto`, the bucket MSM on the card or the scan MSM at the
  plan of `config.plan_msm` on the CPU;
* multi-device on `torch.distributed` (`distributed.py`, not exported,
  as in the JAX package): `initialize`, `global_mesh` and the collectives
  `msm_distributed`, `curves.msm_bucket.msm_sharded2`,
  `curves.msm.msm_sharded` and `curves.pairing.multi_pairing_sharded`.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), where every kernel is replaced by its plain PyTorch
version. Asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch

from .bls12 import Bls12, MillerLoopOutput, pairing
from .curves import msm_bucket as _MB
from .curves.msm import MsmAborted
from .device import resolve_device
from .fields import Fp, Fp2, Fp6, Fp12, Gt, Scalar, field_cast
from .groups import G1Affine, G1Projective, G2Affine, G2Prepared, G2Projective
from .ops import convert as _CV
from .oracle.field import R as _R

__all__ = [
    "Fp", "Fp2", "Fp6", "Fp12", "Gt", "Scalar", "field_cast",
    "G1Affine", "G1Projective", "G2Affine", "G2Projective", "G2Prepared",
    "Bls12", "MillerLoopOutput",
    "G1", "G2", "MsmAborted", "msm_g1", "msm_g2", "pairing", "resolve_device",
]


def msm_g1(points, scalars, *, device="cuda", c: int = 7, chunk: int | None = None,
           maybe_abort=None):
    """G1 multi-scalar multiplication sum_i scalars[i] * points[i].

    points: strict projective (x, y, z) in Montgomery-R16 form, each a
    (24, N) int32 tensor of 16-bit limbs (identity points allowed);
    scalars: (16, N) int32 plain Fr limbs, each value < 2^255 (any scalar
    reduced mod r qualifies). Returns the strict projective result, each
    coordinate (24, 1), on `device`. `c` is the signed window width,
    `chunk` the points per chunk (default: planned from free memory), and
    `maybe_abort` a zero-argument callable polled before every chunk."""
    dev = resolve_device(device)
    points = tuple(x.to(dev, torch.int32) for x in points)
    scalars = scalars.to(dev, torch.int32)
    n = scalars.shape[-1]
    if scalars.shape[0] != 16 or any(x.shape != (24, n) for x in points):
        raise ValueError("msm_g1 wants (24, N) coordinates and (16, N) scalars")
    return _MB.msm(points, scalars, _MB.KC2_G1, c, chunk=chunk, maybe_abort=maybe_abort)


def msm_g2(points, scalars, *, device="cuda", c: int = _MB.KC2_G2.c_default,
           chunk: int | None = None, maybe_abort=None):
    """G2 multi-scalar multiplication sum_i scalars[i] * points[i].

    points: strict projective ((x0, x1), (y0, y1), (z0, z1)) over Fp2 in
    Montgomery-R16 form, each component a (24, N) int32 tensor of 16-bit
    limbs (identity points allowed); scalars as for `msm_g1`. Returns the
    strict projective result in the same form with batch (1,), on
    `device`. `c` defaults to 5, the JAX package's G2 default."""
    dev = resolve_device(device)
    points = tuple(tuple(x.to(dev, torch.int32) for x in coord) for coord in points)
    scalars = scalars.to(dev, torch.int32)
    n = scalars.shape[-1]
    if scalars.shape[0] != 16 or any(x.shape != (24, n) for coord in points for x in coord):
        raise ValueError("msm_g2 wants pairs of (24, N) coordinates and (16, N) scalars")
    return _MB.msm(points, scalars, _MB.KC2_G2, c, chunk=chunk, maybe_abort=maybe_abort)


class G1:
    """G1 at the level of affine int tuples (None = the identity)."""

    @staticmethod
    def msm(bases, scalars, device="cuda"):
        """sum_i scalars[i] * bases[i] as an affine tuple (or None); scalars
        are ints, reduced mod r."""
        if len(bases) != len(scalars):
            raise ValueError(f"{len(bases)} bases but {len(scalars)} scalars")
        dev = resolve_device(device)
        points = _CV.g1_to_dev(list(bases))
        scs = _CV.fr_to_dev([int(s) % _R for s in scalars])
        return _CV.g1_from_dev(msm_g1(points, scs, device=dev))[0]


class G2:
    """G2 at the level of affine Fp2 int tuples (None = the identity)."""

    @staticmethod
    def msm(bases, scalars, device="cuda"):
        """sum_i scalars[i] * bases[i] as an affine tuple (or None); scalars
        are ints, reduced mod r."""
        if len(bases) != len(scalars):
            raise ValueError(f"{len(bases)} bases but {len(scalars)} scalars")
        dev = resolve_device(device)
        points = _CV.g2_to_dev(list(bases))
        scs = _CV.fr_to_dev([int(s) % _R for s in scalars])
        return _CV.g2_from_dev(msm_g2(points, scs, device=dev))[0]
