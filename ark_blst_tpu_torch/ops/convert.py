"""Host codecs: Python-int values <-> the port's stacked int32 tensors.

Strict batches are limb-major `(L, N)` int32 tensors in the strict engine's
Montgomery form (R16 = 2^384 for Fp); MSM scalars are plain `(16, N)` Fr
limbs. All Montgomery conversion happens on the host with Python ints.

`from_jax` carries state across from the JAX package: it takes that
package's arrays as numpy (strict limbs, lazy digit stacks or lists, the
MSM kernel's packed point/digit/dump arrays) and returns the port's
tensors, so tests can feed both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import field as OF
from .limbs import FP, FR, ints_to_limbs, limbs_to_ints


def fp_to_dev(values) -> torch.Tensor:
    """list of ints in [0, p) -> stacked (24, N) Montgomery-R16 limbs."""
    mont = [v * FP.mont_r % FP.modulus for v in values]
    return torch.from_numpy(ints_to_limbs(mont, FP.num_limbs).T.copy())


def fp_from_dev(arr: torch.Tensor) -> list:
    """stacked (24, N) Montgomery-R16 limbs -> list of ints."""
    rinv = pow(FP.mont_r, -1, FP.modulus)
    mat = arr.reshape(arr.shape[0], -1).T.cpu().numpy()
    return [v * rinv % FP.modulus for v in limbs_to_ints(mat)]


def fr_to_dev(values) -> torch.Tensor:
    """Scalars -> plain (not Montgomery) (16, N) Fr limbs, reduced mod r."""
    vs = [v % FR.modulus for v in values]
    return torch.from_numpy(ints_to_limbs(vs, FR.num_limbs).T.copy())


def g1_to_dev(points):
    """Affine points (None = identity) -> strict projective (x, y, z)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return (fp_to_dev(xs), fp_to_dev(ys), fp_to_dev(zs))


def g1_from_dev(pt) -> list:
    """Strict projective (x, y, z) -> affine points (host division)."""
    xs, ys, zs = (fp_from_dev(c) for c in pt)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, OF.P)
            out.append((x * zi % OF.P, y * zi % OF.P))
    return out


def from_jax(a, lead: int = 1) -> torch.Tensor:
    """A JAX-package array (as numpy, or a list of per-digit arrays) -> the
    port's int32 tensor, keeping the first `lead` axes and flattening the
    rest into one batch axis.

      strict limbs (L, *batch), lead=1           -> (L, N)
      lazy digits (list of 30 arrays), lead=1    -> (30, N)
      pts_arr (aff_rows, T, 8, 128), lead=1      -> (aff_rows, T*1024)
      digs_arr (W, T, 8, 128), lead=1            -> (W, T*1024)
      dump (W, B, pt_rows, 8, 128), lead=3       -> (W, B, pt_rows, 1024)

    Every word must fit int32 (strict limbs < 2^16, digits signed, packed
    words <= 5.41e8)."""
    if isinstance(a, (list, tuple)):
        a = np.stack([np.asarray(x) for x in a])
    a = np.asarray(a)
    wide = a.astype(np.int64)
    if wide.size and (wide.max() >= 1 << 31 or wide.min() < -(1 << 31)):
        raise ValueError("array does not fit int32")
    shape = a.shape[:lead] + (-1,)
    return torch.from_numpy(wide.astype(np.int32).reshape(shape).copy())
