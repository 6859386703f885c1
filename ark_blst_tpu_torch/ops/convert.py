"""Host codecs: Python-int values <-> the port's stacked int32 tensors.

Strict batches are limb-major `(L, N)` int32 tensors in the strict engine's
Montgomery form (R16 = 2^384 for Fp); MSM scalars are plain `(16, N)` Fr
limbs. All Montgomery conversion happens on the host with Python ints.

Tower values nest like the oracle's: an fp2 batch is a pair of `(24, N)`
tensors, an fp6 batch three fp2 batches, an fp12 batch two fp6 batches.

`from_jax` carries state across from the JAX package: it takes that
package's arrays as numpy (strict limbs, lazy digit stacks or lists, the
MSM kernel's packed point/digit/dump arrays) and returns the port's
tensors, so tests can feed both packages identical inputs. `tree_from_jax`
does the same for the JAX tower's nested tuples, `coeffs_from_jax` for
its stacked Miller-loop line coefficients, and `value_from_jax` for its
API objects (fields, points, `G2Prepared`, `MillerLoopOutput`).
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
    mat = arr.reshape(arr.shape[0], -1).cpu().numpy().T  # a row of limbs: one copy, no kernel
    return [v * rinv % FP.modulus for v in limbs_to_ints(mat)]


def fr_to_dev(values) -> torch.Tensor:
    """Scalars -> plain (not Montgomery) (16, N) Fr limbs, reduced mod r."""
    vs = [v % FR.modulus for v in values]
    return torch.from_numpy(ints_to_limbs(vs, FR.num_limbs).T.copy())


def fp2_to_dev(values):
    """list of oracle fp2 tuples -> fp2 batch of (24, N) tensors."""
    return (fp_to_dev([v[0] for v in values]), fp_to_dev([v[1] for v in values]))


def fp2_from_dev(a) -> list:
    return list(zip(fp_from_dev(a[0]), fp_from_dev(a[1])))


def fp6_to_dev(values):
    return tuple(fp2_to_dev([v[i] for v in values]) for i in range(3))


def fp6_from_dev(a) -> list:
    cs = [fp2_from_dev(a[i]) for i in range(3)]
    return [tuple(c[n] for c in cs) for n in range(len(cs[0]))]


def fp12_to_dev(values):
    return tuple(fp6_to_dev([v[i] for v in values]) for i in range(2))


def fp12_from_dev(a) -> list:
    cs = [fp6_from_dev(a[i]) for i in range(2)]
    return [tuple(c[n] for c in cs) for n in range(len(cs[0]))]


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


def g2_to_dev(points):
    """Affine G2 points (None = identity) -> strict projective fp2 (x, y, z)."""
    xs = [OF.FP2_ZERO if p is None else p[0] for p in points]
    ys = [OF.FP2_ONE if p is None else p[1] for p in points]
    zs = [OF.FP2_ZERO if p is None else OF.FP2_ONE for p in points]
    return (fp2_to_dev(xs), fp2_to_dev(ys), fp2_to_dev(zs))


def g2_from_dev(pt) -> list:
    """Strict projective fp2 (x, y, z) -> affine G2 points (host division)."""
    out = []
    for x, y, z in zip(*(fp2_from_dev(c) for c in pt)):
        if z == OF.FP2_ZERO:
            out.append(None)
        else:
            zi = OF.fp2_inv(z)
            out.append((OF.fp2_mul(x, zi), OF.fp2_mul(y, zi)))
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


def tree_from_jax(tree, lead: int = 1):
    """A JAX tower value (nested tuples of arrays: an fp2 pair, an fp12, a
    Jacobian G2 point) -> the same nesting of the port's tensors, `from_jax`
    on every leaf."""
    if isinstance(tree, tuple):
        return tuple(tree_from_jax(t, lead) for t in tree)
    return from_jax(tree, lead)


def coeffs_from_jax(coeffs) -> torch.Tensor:
    """JAX line coefficients ((c0, c1, c2), fp2 each, every leaf a
    `(E, 30, *batch)` digit stack) -> the port's stacked `(E, 6, 30, N)`
    tensor, rows c0[0], c0[1], c1[0], c1[1], c2[0], c2[1]."""
    leaves = [c[k] for c in coeffs for k in range(2)]
    return torch.stack([from_jax(x, lead=2) for x in leaves], dim=1)


def value_from_jax(obj):
    """A JAX-package API object -> the port's counterpart, by canonical
    value: a field element (`Fp`, `Scalar`, `Fp2`, `Fp6`, `Fp12`/`Gt`) by
    `.v`, a point by `.p`, a `G2Prepared` by `.coeffs`, a
    `MillerLoopOutput` by `.f`. Duck-typed on the class's `_name` or
    `__name__`; imports nothing of the JAX package."""
    from .. import bls12, fields, groups

    name = getattr(type(obj), "_name", type(obj).__name__)
    if name in ("Fp", "Scalar", "Fp2", "Fp6", "Fp12"):
        return getattr(fields, name)(obj.v)
    if name in ("G1Affine", "G1Projective", "G2Affine", "G2Projective"):
        return getattr(groups, name)(obj.p)
    if name == "G2Prepared":
        return groups.G2Prepared(obj.coeffs)
    if name == "MillerLoopOutput":
        return bls12.MillerLoopOutput(fields.Fp12(obj.f.v))
    raise TypeError(f"no port counterpart for {type(obj).__name__}")
