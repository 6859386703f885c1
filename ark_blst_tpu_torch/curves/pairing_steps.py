"""K5 and K6: the G2 prepare and the Miller loop as hand-written CUDA
chain kernels, one launch for all their events, with the event math they
compute.

Counterparts of two `ark_blst_tpu/ops/pallas_lazy.py:tower_fused`
instances and the `lax.scan`s that run them (`ark_blst_tpu/curves/
pairing.py:242` and `:342`):
* K5 (`csrc/prepare_step.cu` on `csrc/tower381.cuh`): Q and a schedule of
  events (True a Jacobian doubling of R, False the mixed addition of the
  affine Q; R starts at (Q, 1)) -> each event's line coefficients c0, c1,
  c2. R and Q stay in shared memory as 32-bit words across the events.
* K6 (`csrc/miller_step.cu` on `csrc/tower381.cuh`): the lines and P =
  (px, py) -> f after the events from f = one (or a given f), each f <-
  (f^2 at a doubling) * line(P): the line scaled by P (`_ell_legs`), then
  the sparse product `fp12_mul_by_014`. f and P stay in shared memory as
  words.
Two pairs of entries launch them, on the edges' formats of
`csrc/tower381.cuh` (`FMT_DIGITS`, `FMT_LIMBS`, `FMT_WORDS`):
* the fused pipeline's, `prepare_lines` and `miller_lines`: Q and P enter
  as the strict `(24, N)` limbs the entry points hold, R = (Q, 1) and f =
  one are formed in the kernels, and the lines cross from K5 to K6 as
  canonical words `(E, 6, 12, N)` (`ops/words.py`); f leaves as digits,
  or, for the fused pairing, as conj(f) in canonical words `(12, 12, N)`
  (`f_fmt=FMT_WORDS`), the form FE-easy loads; on the strict engine's
  edges (`lines_fmt=FMT_LIMBS`, `f_fmt=FMT_LIMBS`) the lines cross as its
  canonical strict limbs `(E, 6, 24, N)` and conj(f) leaves as strict
  limbs `(12, 24, N)`, the strict `prepare_g2` and `miller_loop` (the
  `lax.scan`s of `ark_blst_tpu/curves/pairing.py:262` and `:359` over the
  strict tower);
* the digit entries, `prepare_chain` / `miller_chain` and their chains of
  one event `prepare_step` / `miller_step`: every edge radix-13 digits,
  the same field elements as their plain versions in other digits
  (within 4096).

`_doubling_step`, `_addition_step` and `_ell_legs` are the port of the
functions of those names in `ark_blst_tpu/curves/pairing.py`, generic over
the tower module T as there: on the lazy tower digit for digit (the
kernels' plain versions and the unfused pipeline), on the strict tower
limb for limb (the `engine="strict"` pairing).
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, cpu_operands, stacked_operands
from ..ops import final_exp as FE
from ..ops import tower_lazy as TL
from ..ops.words import (FMT_DIGITS, FMT_LIMBS, FMT_WORDS, LIMBS, WORDS, digits_to_words_plain,
                         limbs_to_digits_plain, words_to_digits_plain, words_to_limbs_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
# n, events, schedule, the two edges' formats (K6: and f's out), stream
_CHAIN_ARGS = [ctypes.c_longlong, _I, _P, _I, _I, _P]
PREPARE_KERNEL = CudaKernel("prepare_step.cu", "pairing_prepare_chain", [_P] * 4 + _CHAIN_ARGS)
MILLER_KERNEL = CudaKernel("miller_step.cu", "pairing_miller_chain",
                           [_P] * 4 + _CHAIN_ARGS[:-1] + [_I, _P])
# the strict engine's instantiations (strict limbs at every edge), each
# counting its own launches
PREPARE_KERNEL_LIMBS = CudaKernel("prepare_step.cu", "pairing_prepare_chain",
                                  [_P] * 4 + _CHAIN_ARGS)
MILLER_KERNEL_LIMBS = CudaKernel("miller_step.cu", "pairing_miller_chain",
                                 [_P] * 4 + _CHAIN_ARGS[:-1] + [_I, _P])
MAX_EVENTS = 128  # the longest schedule a chain takes (csrc/tower381.cuh)
# The edges' formats of csrc/tower381.cuh (EdgeFormat), by a row's entries
FORMAT_OF_ROW = {30: FMT_DIGITS, LIMBS: FMT_LIMBS, WORDS: FMT_WORDS}
ROWS_OF_FORMAT = {fmt: rows for rows, fmt in FORMAT_OF_ROW.items()}


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


def _prepare_launch(r_stk, q_stk, sched, coeffs, r_out, in_fmt=FMT_DIGITS,
                    out_fmt=FMT_DIGITS) -> None:
    events, flags = sched
    x = q_stk if r_stk is None else r_stk
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    kernel = PREPARE_KERNEL_LIMBS if out_fmt == FMT_LIMBS else PREPARE_KERNEL
    with torch.cuda.device(x.device):
        kernel.launch(ptr(r_stk), ptr(q_stk), coeffs.data_ptr(), ptr(r_out), x.shape[-1],
                      events, flags, in_fmt, out_fmt, _stream(x))


def prepare_chain(q_stk: torch.Tensor, schedule) -> torch.Tensor:
    """The G2 prepare of Q (4, 30, N) over a schedule of events (True a
    doubling, False an addition) -> the lines (E, 6, 30, N): one K5 launch
    for CUDA tensors (R = (Q, 1) formed in the kernel), the plain version
    for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)  # 1 to MAX_EVENTS events, on either device
    if stacked_operands("prepare_chain", [q_stk], [4]):
        return prepare_chain_plain(q_stk, schedule)
    coeffs = torch.empty((len(schedule), 6) + tuple(q_stk.shape[1:]), dtype=torch.int32,
                         device=q_stk.device)
    _prepare_launch(None, q_stk, sched, coeffs, None)
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


def _strict_stack(name: str, leaves) -> torch.Tensor:
    """Strict Fp leaves, each (24, N) with one N -> their (rows, 24, N)
    stack (the kernels' operand; `cpu_operands` checks it)."""
    n = leaves[0].shape[-1]
    if any(x.dim() != 2 or tuple(x.shape) != (24, n) for x in leaves):
        raise ValueError(f"{name} wants strict (24, N) limbs, got "
                         f"{[tuple(x.shape) for x in leaves]}")
    return torch.stack(leaves)


def prepare_lines_plain(q, schedule, lines_fmt=FMT_WORDS) -> torch.Tensor:
    """`prepare_lines`' plain PyTorch version: Q ingested (`fp2_ingest`),
    `prepare_chain_plain`, the lines as words (`digits_to_words_plain`),
    or with lines_fmt FMT_LIMBS as strict limbs (`words_to_limbs_plain` of
    those)."""
    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    lines = prepare_chain_plain(torch.stack([qx[0], qx[1], qy[0], qy[1]]), schedule)
    words = digits_to_words_plain(lines)
    return words_to_limbs_plain(words) if lines_fmt == FMT_LIMBS else words


def prepare_lines(q, schedule, lines_fmt=FMT_WORDS) -> torch.Tensor:
    """The G2 prepare on strict Q: q = (qx, qy), strict fp2 pairs of (24, N)
    limbs, over a schedule of events -> the lines as canonical words (E, 6,
    12, N), the fused pipeline's, or with lines_fmt FMT_LIMBS as canonical
    strict limbs (E, 6, 24, N), the strict engine's: one K5 launch for
    CUDA tensors, Q read as limbs and R = (Q, 1) formed in the kernel; the
    plain version for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)
    if lines_fmt not in (FMT_WORDS, FMT_LIMBS):
        raise ValueError("prepare_lines stores the lines as words or as strict limbs")
    q_stk = _strict_stack("prepare_lines", [q[0][0], q[0][1], q[1][0], q[1][1]])
    if cpu_operands("prepare_lines", [q_stk]):
        return prepare_lines_plain(q, schedule, lines_fmt)
    coeffs = torch.empty((len(schedule), 6, ROWS_OF_FORMAT[lines_fmt], q_stk.shape[-1]),
                         dtype=torch.int32, device=q_stk.device)
    _prepare_launch(None, q_stk, sched, coeffs, None, FMT_LIMBS, lines_fmt)
    return coeffs


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


def _miller_launch(f_stk, coeffs, pxy, sched, line_fmt=FMT_DIGITS,
                   p_fmt=FMT_DIGITS, f_fmt=FMT_DIGITS) -> torch.Tensor:
    events, flags = sched
    n = pxy.shape[-1]
    out = torch.empty((12, ROWS_OF_FORMAT[f_fmt], n), dtype=torch.int32, device=pxy.device)
    kernel = MILLER_KERNEL_LIMBS if f_fmt == FMT_LIMBS else MILLER_KERNEL
    with torch.cuda.device(pxy.device):
        kernel.launch(0 if f_stk is None else f_stk.data_ptr(), coeffs.data_ptr(),
                      pxy.data_ptr(), out.data_ptr(), n, events, flags, line_fmt, p_fmt, f_fmt,
                      _stream(pxy))
    return out


def _check_lines(name: str, coeffs: torch.Tensor, rows, events: int, n: int) -> None:
    """Lines (E', 6, K, n) with K among `rows` and E' >= events."""
    if coeffs.dim() != 4 or coeffs.shape[1] != 6 or coeffs.shape[2] not in rows or \
            coeffs.shape[3] != n or coeffs.shape[0] < events:
        raise ValueError(f"{name} wants ({events}+, 6, {' or '.join(map(str, rows))}, {n}) "
                         f"lines, got {tuple(coeffs.shape)}")


def miller_chain(f_stk: torch.Tensor, coeffs: torch.Tensor, pxy: torch.Tensor,
                 schedule) -> torch.Tensor:
    """The Miller loop's events on F (12, 30, N), event i on the line triple
    coeffs[i] (coeffs (E', 6, 30, N), E' >= the schedule's E) at P = (px,
    py) (2, 30, N) -> (12, 30, N): one K6 launch for CUDA tensors, the
    plain version for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)  # 1 to MAX_EVENTS events, on either device
    _check_lines("miller_chain", coeffs, (30,), len(schedule), f_stk.shape[-1])
    if stacked_operands("miller_chain", [f_stk, coeffs[0], pxy], [12, 6, 2]):
        return miller_chain_plain(f_stk, coeffs, pxy, schedule)
    if not coeffs.is_contiguous():
        raise ValueError("miller_chain wants contiguous operands")
    return _miller_launch(f_stk, coeffs, pxy, sched)


def miller_lines_plain(coeffs: torch.Tensor, p, schedule, f_fmt=FMT_DIGITS) -> torch.Tensor:
    """`miller_lines`' plain PyTorch version: word lines as digits
    (`words_to_digits_plain`), strict limb lines ingested
    (`limbs_to_digits_plain`), P ingested (`fp_ingest`), then
    `miller_chain_plain` from f = one; with f_fmt FMT_WORDS, conj(f) as
    words (`digits_to_words_plain`), with FMT_LIMBS as strict limbs
    (`words_to_limbs_plain` of those)."""
    e = len(schedule)
    lines = coeffs[:e]
    if lines.shape[2] == WORDS:
        lines = words_to_digits_plain(lines)
    elif lines.shape[2] == LIMBS:
        lines = limbs_to_digits_plain(lines)
    pxy = torch.stack([TL.fp_ingest(p[0]), TL.fp_ingest(p[1])])
    f = miller_chain_plain(TL.stack12(TL.fp12_one(pxy[0])), lines, pxy, schedule)
    if f_fmt == FMT_DIGITS:
        return f
    words = digits_to_words_plain(FE.conj(f))
    return words_to_limbs_plain(words) if f_fmt == FMT_LIMBS else words


# The layouts miller_lines stores f in, by the lines' row entries
_F_FORMATS = {30: (FMT_DIGITS,), WORDS: (FMT_DIGITS, FMT_WORDS), LIMBS: (FMT_LIMBS,)}


def miller_lines(coeffs: torch.Tensor, p, schedule, f_fmt=FMT_DIGITS) -> torch.Tensor:
    """The Miller loop on strict P from f = one: the lines (E', 6, 12, N)
    words as `prepare_lines` gives them, (E', 6, 30, N) digits as the
    unfused prepare does, or (E', 6, 24, N) strict limbs as the strict
    engine's prepare does (E' >= the schedule's E), p = (px, py) strict
    (24, N) limbs -> f (12, 30, N) digits; or conj(f), with f_fmt
    FMT_WORDS (word lines only) as (12, 12, N) canonical words, the fused
    pairing's input to FE-easy, with FMT_LIMBS (strict lines only, and
    there the only layout) as (12, 24, N) canonical strict limbs, the
    strict engine's: one K6 launch for CUDA tensors, P read as limbs, f =
    one formed in the kernel and conjugated in its store; the plain
    version for CPU tensors."""
    schedule = list(schedule)
    sched = _schedule(schedule)
    _check_lines("miller_lines", coeffs, tuple(_F_FORMATS), len(schedule), p[0].shape[-1])
    if f_fmt not in _F_FORMATS[coeffs.shape[2]]:
        raise ValueError("miller_lines stores f as digits, or conj(f) as words from word lines "
                         "or as strict limbs from strict lines")
    pxy = _strict_stack("miller_lines", [p[0], p[1]])
    if cpu_operands("miller_lines", [coeffs, pxy]):
        return miller_lines_plain(coeffs, p, schedule, f_fmt)
    return _miller_launch(None, coeffs, pxy, sched, FORMAT_OF_ROW[coeffs.shape[2]], FMT_LIMBS,
                          f_fmt)


def miller_step(f_stk: torch.Tensor, c_stk: torch.Tensor, pxy: torch.Tensor,
                with_sqr: bool) -> torch.Tensor:
    """One Miller event on F (12, 30, N) with the line triple C (6, 30, N)
    at P = (px, py) (2, 30, N) -> (12, 30, N). K6 as a chain of one event
    for CUDA tensors, the plain version for CPU tensors."""
    if stacked_operands("miller_step", [f_stk, c_stk, pxy], [12, 6, 2]):
        return miller_step_plain(f_stk, c_stk, pxy, with_sqr)
    return _miller_launch(f_stk, c_stk, pxy, _schedule([with_sqr]))
