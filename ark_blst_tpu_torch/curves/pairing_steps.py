"""K5 and K6: the G2 prepare and the Miller loop as hand-written CUDA
chain kernels, one launch for all their events, with the event math they
compute.

Counterparts of two `ark_blst_tpu/ops/pallas_lazy.py:tower_fused`
instances and the `lax.scan`s that run them (`ark_blst_tpu/curves/
pairing.py:242` and `:342`):
* K5 `prepare_chain` (`curves/pairing.py:_fused_prepare_step` under the
  prepare's scan): Q `(4, 30, N)` = qx, qy fp2 components and a schedule
  of events (True a Jacobian doubling of R, False the mixed addition of
  the affine Q; R starts at (Q, 1)) -> each event's line coefficients
  c0, c1, c2 as `(E, 6, 30, N)`. Source `csrc/prepare_step.cu` on
  `csrc/tower381.cuh`: R and Q stay in shared memory as 32-bit words
  across the events; the same field elements as `prepare_chain_plain`,
  in other digits (within 4096).
* K6 `miller_chain` (`curves/pairing.py:_fused_miller_step` under the
  Miller scan): f `(12, 30, N)`, the lines `(E, 6, 30, N)` and P = (px,
  py) `(2, 30, N)` -> f after the events, each f <- (f^2 at a doubling) *
  line(P): the line scaled by P (`_ell_legs`), then the sparse product
  `fp12_mul_by_014`. Source `csrc/miller_step.cu` on `csrc/tower381.cuh`:
  f and P stay in shared memory as words; the same field elements as
  `miller_chain_plain`, in other digits (within 4096).
`prepare_step` and `miller_step` are one event, the chains of one.

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

_P = ctypes.c_void_p
_CHAIN_ARGS = [ctypes.c_longlong, ctypes.c_int, _P, _P]  # n, events, schedule, stream
PREPARE_KERNEL = CudaKernel("prepare_step.cu", "pairing_prepare_chain", [_P] * 4 + _CHAIN_ARGS)
MILLER_KERNEL = CudaKernel("miller_step.cu", "pairing_miller_chain", [_P] * 4 + _CHAIN_ARGS)
MAX_EVENTS = 128  # the longest schedule a chain takes (csrc/tower381.cuh)


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


def _schedule(schedule) -> tuple:
    """A chain's schedule (True a doubling event) -> (events, the C array of
    flags); raises outside 1..MAX_EVENTS."""
    flags = [bool(x) for x in schedule]
    if not 1 <= len(flags) <= MAX_EVENTS:
        raise ValueError(f"a chain runs 1 to {MAX_EVENTS} events, not {len(flags)}")
    return len(flags), (ctypes.c_ubyte * len(flags))(*flags)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- K5 ---------------------------------------------------------------------------

def prepare_step_plain(r_stk: torch.Tensor, q_stk: torch.Tensor | None = None) -> torch.Tensor:
    """One event's plain PyTorch version: `_doubling_step`, or
    `_addition_step` when q is given, flattened to (12, 30, N)."""
    r = tuple(_fp2_rows(r_stk, k) for k in (0, 2, 4))
    if q_stk is None:
        nr, c = _doubling_step(TL, r)
    else:
        nr, c = _addition_step(TL, r, (_fp2_rows(q_stk, 0), _fp2_rows(q_stk, 2)))
    return torch.stack([x for fp2 in nr + c for x in fp2])


def _r_start(q_stk: torch.Tensor) -> torch.Tensor:
    """R = (qx, qy, 1) as a (6, 30, N) stack, z = (1, 0) in the lazy form."""
    zero = torch.zeros_like(q_stk[0])
    return torch.stack([*q_stk, zero + TL._const_col(1, zero), zero])


def prepare_chain_plain(q_stk: torch.Tensor, schedule) -> torch.Tensor:
    """The chain's plain PyTorch version: `prepare_step_plain` event by
    event from R = (Q, 1) -> the lines (E, 6, 30, N)."""
    rs, lines = _r_start(q_stk), []
    for is_dbl in schedule:
        out = prepare_step_plain(rs, None if is_dbl else q_stk)
        rs = out[:6]
        lines.append(out[6:])
    return torch.stack(lines)


def _prepare_launch(r_stk, q_stk, sched, coeffs, r_out) -> None:
    events, flags = sched
    with torch.cuda.device(r_stk.device):
        PREPARE_KERNEL.launch(r_stk.data_ptr(), 0 if q_stk is None else q_stk.data_ptr(),
                              coeffs.data_ptr(), 0 if r_out is None else r_out.data_ptr(),
                              r_stk.shape[-1], events, flags, _stream(r_stk))


def prepare_chain(q_stk: torch.Tensor, schedule) -> torch.Tensor:
    """The G2 prepare of Q (4, 30, N) over a schedule of events (True a
    doubling, False an addition) -> the lines (E, 6, 30, N): one K5 launch
    for CUDA tensors, the plain version for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)  # 1 to MAX_EVENTS events, on either device
    if stacked_operands("prepare_chain", [q_stk], [4]):
        return prepare_chain_plain(q_stk, schedule)
    coeffs = torch.empty((len(schedule), 6) + tuple(q_stk.shape[1:]), dtype=torch.int32,
                         device=q_stk.device)
    _prepare_launch(_r_start(q_stk), q_stk, sched, coeffs, None)
    return coeffs


def prepare_step(r_stk: torch.Tensor, q_stk: torch.Tensor | None = None) -> torch.Tensor:
    """One prepare event: the doubling step of R (6, 30, N), or the mixed
    addition of Q (4, 30, N) when given -> (12, 30, N), the new R in rows
    0-5 and the line in rows 6-11. K5 as a chain of one event for CUDA
    tensors, the plain version for CPU tensors."""
    ops = [r_stk] if q_stk is None else [r_stk, q_stk]
    if stacked_operands("prepare_step", ops, [6, 4][: len(ops)]):
        return prepare_step_plain(r_stk, q_stk)
    out = torch.empty((12, 30, r_stk.shape[-1]), dtype=torch.int32, device=r_stk.device)
    _prepare_launch(r_stk, q_stk, _schedule([q_stk is None]), out[6:], out[:6])
    return out


# --- K6 ---------------------------------------------------------------------------

def miller_step_plain(f_stk: torch.Tensor, c_stk: torch.Tensor, pxy: torch.Tensor,
                      with_sqr: bool) -> torch.Tensor:
    """One event's plain PyTorch version: `fp12_sqr` (when with_sqr), then
    `_ell_legs`, then `fp12_mul_by_014_many`."""
    f = TL.unstack12(f_stk)
    if with_sqr:
        f = TL.fp12_sqr(f)
    c = tuple(_fp2_rows(c_stk, k) for k in (0, 2, 4))
    a0, a1, a4 = _ell_legs(TL, c, pxy[0], pxy[1])
    return TL.stack12(TL.fp12_mul_by_014_many([(f, a0, a1, a4)])[0])


def miller_chain_plain(f_stk: torch.Tensor, coeffs: torch.Tensor, pxy: torch.Tensor,
                       schedule) -> torch.Tensor:
    """The chain's plain PyTorch version: `miller_step_plain` event by
    event, event i on the line coeffs[i]."""
    for i, is_dbl in enumerate(schedule):
        f_stk = miller_step_plain(f_stk, coeffs[i], pxy, is_dbl)
    return f_stk


def _miller_launch(f_stk, coeffs, pxy, sched) -> torch.Tensor:
    events, flags = sched
    out = torch.empty_like(f_stk)
    with torch.cuda.device(f_stk.device):
        MILLER_KERNEL.launch(f_stk.data_ptr(), coeffs.data_ptr(), pxy.data_ptr(), out.data_ptr(),
                             f_stk.shape[-1], events, flags, _stream(f_stk))
    return out


def miller_chain(f_stk: torch.Tensor, coeffs: torch.Tensor, pxy: torch.Tensor,
                 schedule) -> torch.Tensor:
    """The Miller loop's events on F (12, 30, N), event i on the line triple
    coeffs[i] (coeffs (E', 6, 30, N), E' >= the schedule's E) at P = (px,
    py) (2, 30, N) -> (12, 30, N): one K6 launch for CUDA tensors, the
    plain version for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)  # 1 to MAX_EVENTS events, on either device
    n = f_stk.shape[-1]
    if coeffs.dim() != 4 or tuple(coeffs.shape[1:]) != (6, 30, n) or \
            coeffs.shape[0] < len(schedule):
        raise ValueError(f"miller_chain wants ({len(schedule)}+, 6, 30, {n}) lines, "
                         f"got {tuple(coeffs.shape)}")
    if stacked_operands("miller_chain", [f_stk, coeffs[0], pxy], [12, 6, 2]):
        return miller_chain_plain(f_stk, coeffs, pxy, schedule)
    if not coeffs.is_contiguous():
        raise ValueError("miller_chain wants contiguous operands")
    return _miller_launch(f_stk, coeffs, pxy, sched)


def miller_step(f_stk: torch.Tensor, c_stk: torch.Tensor, pxy: torch.Tensor,
                with_sqr: bool) -> torch.Tensor:
    """One Miller event on F (12, 30, N) with the line triple C (6, 30, N)
    at P = (px, py) (2, 30, N) -> (12, 30, N). K6 as a chain of one event
    for CUDA tensors, the plain version for CPU tensors."""
    if stacked_operands("miller_step", [f_stk, c_stk, pxy], [12, 6, 2]):
        return miller_step_plain(f_stk, c_stk, pxy, with_sqr)
    return _miller_launch(f_stk, c_stk, pxy, _schedule([with_sqr]))
