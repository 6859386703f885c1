"""K5 and K6: one G2 prepare event and one Miller event as hand-written CUDA
kernels, with the event math they compute.

Counterparts of two `ark_blst_tpu/ops/pallas_lazy.py:tower_fused` instances:
* K5 `prepare_step` (`curves/pairing.py:_fused_prepare_step`): one Jacobian
  doubling of R, or one mixed addition of the affine Q, with its line
  triple. R `(6, 30, N)` = x, y, z fp2 components [+ Q `(4, 30, N)` =
  qx, qy] -> `(12, 30, N)`: rows 0-5 the new point, rows 6-11 the line
  coefficients c0, c1, c2. Source `csrc/prepare_step.cu` on
  `csrc/tower381.cuh`, as K6: the same field elements as
  `prepare_step_plain`, in other digits (within 4096).
* K6 `miller_step` (`curves/pairing.py:_fused_miller_step`): one Miller
  event, f <- (f^2 if with_sqr) * line(P): the line triple C `(6, 30, N)`
  scaled by P = (px, py) `(2, 30, N)` (`_ell_legs`), then the sparse
  product `fp12_mul_by_014`. F `(12, 30, N)` -> `(12, 30, N)`. Source
  `csrc/miller_step.cu` on `csrc/tower381.cuh` (32-bit Montgomery words in
  shared memory, the event's work split over a block's threads): the same
  field elements as `miller_step_plain`, in other digits (within 4096).

`_doubling_step`, `_addition_step` and `_ell_legs` are the port of the
functions of those names in `ark_blst_tpu/curves/pairing.py`, generic over
the tower module T as there: on the lazy tower digit for digit (the
kernels' plain versions and the unfused pipeline), on the strict tower
limb for limb (the `engine="strict"` pairing).
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from ..ops import tower_lazy as TL

PREPARE_KERNEL = CudaKernel(
    "prepare_step.cu",
    "pairing_prepare_step",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
)
MILLER_KERNEL = CudaKernel(
    "miller_step.cu",
    "pairing_miller_step",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
)


# --- the event math -------------------------------------------------------------

def _doubling_step(T, r):
    """Jacobian doubling over Fp2 on the tower module T (`tower_lazy` or
    the strict `tower`); returns (new_r, (c0, c1, c2))."""
    x, y, z = r
    t0, t1, zsq = T.fp2_sqr_many([x, y, z])
    t2 = T.fp2_sqr(t1)
    s = T.fp2_sqr(T.fp2_add(t1, x))
    t3 = T.fp2_mul_small(T.fp2_sub(T.fp2_sub(s, t0), t2), 2)
    t4 = T.fp2_mul_small(t0, 3)
    t6 = T.fp2_add(x, t4)
    t5 = T.fp2_sqr(t4)
    nx = T.fp2_sub(t5, T.fp2_mul_small(t3, 2))
    nz = T.fp2_sub(T.fp2_sub(T.fp2_sqr(T.fp2_add(z, y)), t1), zsq)
    m0, m1 = T.fp2_mul_many([(T.fp2_sub(t3, nx), t4), (nz, zsq)])
    ny = T.fp2_sub(m0, T.fp2_mul_small(t2, 8))
    c0 = T.fp2_mul_small(m1, 2)
    (m2,) = T.fp2_mul_many([(t4, zsq)])
    c1 = T.fp2_neg(T.fp2_mul_small(m2, 2))
    c2 = T.fp2_sub(
        T.fp2_sub(T.fp2_sub(T.fp2_sqr(t6), t0), t5), T.fp2_mul_small(t1, 4)
    )
    return (nx, ny, nz), (c0, c1, c2)


def _addition_step(T, r, q):
    """Mixed addition of the affine q to the Jacobian r, with its line, on
    the tower module T."""
    x, y, z = r
    qx, qy = q
    zsq, ysq = T.fp2_sqr_many([z, qy])
    t0, m1 = T.fp2_mul_many(
        [(zsq, qx), (T.fp2_sub(T.fp2_sub(T.fp2_sqr(T.fp2_add(qy, z)), ysq), zsq), zsq)]
    )
    t1 = m1
    t2 = T.fp2_sub(t0, x)
    t3 = T.fp2_sqr(t2)
    t4 = T.fp2_mul_small(t3, 4)
    t6 = T.fp2_sub(t1, T.fp2_mul_small(y, 2))
    t5, t9, t7 = T.fp2_mul_many([(t4, t2), (t6, qx), (t4, x)])
    nx = T.fp2_sub(T.fp2_sub(T.fp2_sqr(t6), t5), T.fp2_mul_small(t7, 2))
    nz = T.fp2_sub(T.fp2_sub(T.fp2_sqr(T.fp2_add(z, t2)), zsq), t3)
    t10 = T.fp2_add(qy, nz)
    t8, m2 = T.fp2_mul_many([(T.fp2_sub(t7, nx), t6), (y, t5)])
    ny = T.fp2_sub(t8, T.fp2_mul_small(m2, 2))
    t10 = T.fp2_sub(T.fp2_sub(T.fp2_sqr(t10), ysq), T.fp2_sqr(nz))
    t9 = T.fp2_sub(T.fp2_mul_small(t9, 2), t10)
    c0 = T.fp2_mul_small(nz, 2)
    c1 = T.fp2_mul_small(T.fp2_neg(t6), 2)
    return (nx, ny, nz), (c0, c1, t9)


def _ell_legs(T, coeff, px, py):
    """A line triple in mul_by_014 operand form: (c2, c1*px, c0*py), the
    fp2-by-fp scaling 2 base products per component, in one launch."""
    c0, c1, c2 = coeff
    s0a, s0b, s1a, s1b = T.fp_mul_many([(c0[0], py), (c0[1], py), (c1[0], px), (c1[1], px)])
    return c2, (s1a, s1b), (s0a, s0b)


def _fp2_rows(x, k):
    return (x[k], x[k + 1])


# --- K5 ---------------------------------------------------------------------------

def prepare_step_plain(r_stk: torch.Tensor, q_stk: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: `_doubling_step`, or
    `_addition_step` when q is given, flattened to (12, 30, N)."""
    r = tuple(_fp2_rows(r_stk, k) for k in (0, 2, 4))
    if q_stk is None:
        nr, c = _doubling_step(TL, r)
    else:
        nr, c = _addition_step(TL, r, (_fp2_rows(q_stk, 0), _fp2_rows(q_stk, 2)))
    return torch.stack([x for fp2 in nr + c for x in fp2])


def prepare_step(r_stk: torch.Tensor, q_stk: torch.Tensor | None = None) -> torch.Tensor:
    """One prepare event: the doubling step of R (6, 30, N), or the mixed
    addition of Q (4, 30, N) when given -> (12, 30, N). The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    ops = [r_stk] if q_stk is None else [r_stk, q_stk]
    if stacked_operands("prepare_step", ops, [6, 4][: len(ops)]):
        return prepare_step_plain(r_stk, q_stk)
    n = r_stk.shape[-1]
    out = torch.empty((12, 30, n), dtype=torch.int32, device=r_stk.device)
    q_ptr = 0 if q_stk is None else q_stk.data_ptr()
    with torch.cuda.device(r_stk.device):
        stream = torch.cuda.current_stream(r_stk.device).cuda_stream
        PREPARE_KERNEL.launch(r_stk.data_ptr(), q_ptr, out.data_ptr(), n, int(q_stk is not None),
                              stream)
    return out


# --- K6 ---------------------------------------------------------------------------

def miller_step_plain(f_stk: torch.Tensor, c_stk: torch.Tensor, pxy: torch.Tensor,
                      with_sqr: bool) -> torch.Tensor:
    """The kernel's plain PyTorch version: `fp12_sqr` (when with_sqr), then
    `_ell_legs`, then `fp12_mul_by_014_many`."""
    f = TL.unstack12(f_stk)
    if with_sqr:
        f = TL.fp12_sqr(f)
    c = tuple(_fp2_rows(c_stk, k) for k in (0, 2, 4))
    a0, a1, a4 = _ell_legs(TL, c, pxy[0], pxy[1])
    return TL.stack12(TL.fp12_mul_by_014_many([(f, a0, a1, a4)])[0])


def miller_step(f_stk: torch.Tensor, c_stk: torch.Tensor, pxy: torch.Tensor,
                with_sqr: bool) -> torch.Tensor:
    """One Miller event on F (12, 30, N) with the line triple C (6, 30, N)
    at P = (px, py) (2, 30, N) -> (12, 30, N). The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if stacked_operands("miller_step", [f_stk, c_stk, pxy], [12, 6, 2]):
        return miller_step_plain(f_stk, c_stk, pxy, with_sqr)
    out = torch.empty_like(f_stk)
    with torch.cuda.device(f_stk.device):
        stream = torch.cuda.current_stream(f_stk.device).cuda_stream
        MILLER_KERNEL.launch(f_stk.data_ptr(), c_stk.data_ptr(), pxy.data_ptr(), out.data_ptr(),
                             f_stk.shape[-1], int(with_sqr), stream)
    return out
