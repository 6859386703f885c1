"""FE-easy and FE-hard: the pairing's fused final exponentiation as two
hand-written CUDA chain kernels, one launch each.

Counterpart of the fused final exponentiation that the JAX package runs
inside one compiled program (`ark_blst_tpu/curves/pairing.py:388-467`),
with its Pallas kernels `ops/pallas_lazy.py:149 cyc_sqr_stacked` (K3),
`:63 tower_fused` as `mul12` (K4) and `:41 mont_mul_stacked` (K1, through
the lazy tower's inverse and Frobenius maps) between XLA's own ops. The
kernels (`csrc/final_exp.cu` on `csrc/final_exp.cuh`) keep each element in
shared memory as 32-bit Montgomery words from f's load to the result's
store:
  FE-easy  `easy`: f (12, 30, N) digits, (12, 12, N) canonical words as
           the fused pairing's K6-chain stores them (or as K4 stores the
           multi-pairings' product, N = 1), or (12, 24, N) strict limbs, the
           strict engine's fp12 stacked -> t2 = conj(f) f^-1,
           times its Frobenius square; on the card t2 comes back as a (12,
           12, N) word stack;
  FE-hard  `hard`: t2 (those words) -> the hard part, (12, 30, N) digits,
           or with `out="limbs"` the strict (12, 24, N) limbs the pairing
           returns (`tower_lazy.unstack12` nests them), so no lazy egress
           runs:
           `HARD_PROGRAM`, five ladders of x, two lone cyclotomic squares,
           ten products, three Frobenius maps.
The chain is written once: `easy_part` and `run_program` walk it over an
engine's fp12 ops, which `curves/pairing.py:final_exp` also does for the
unfused and strict paths. The plain versions (`easy_plain`, `hard_plain`)
walk it over `PLAIN_OPS`: K3's and K4's plain versions,
`tower_lazy.fp12_inv`, `frobenius` and `conj`, in the order the port has
always run them, so on CPU tensors every result is digit for digit what
it was. A kernel's output is the same field element in other digits:
canonical, within 4096; its words and strict limbs are canonical, equal
to the plain version's (`digits_to_words_plain`, then
`words_to_limbs_plain`: limb for limb `tower_lazy.fp12_egress`) word for
word and limb for limb.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..cuda import CudaKernel, stacked_operands
from ..oracle import field as OF
from ..oracle import pairing as OP
from . import cyc_sqr as K3
from . import fp12_mul as K4
from . import lazy13 as LZ
from . import tower_lazy as TL
from .words import (FMT_DIGITS, FMT_LIMBS, FMT_WORDS, LIMBS, WORDS, digits_to_words_plain,
                    limbs_to_digits_plain, split, words_to_digits_plain, words_to_limbs_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_EASY = CudaKernel("final_exp.cu", "final_exp_easy",
                         [_P, _P, _P, ctypes.c_longlong, _I, _P])
KERNEL_HARD = CudaKernel("final_exp.cu", "final_exp_hard",
                         [_P, _P, _P, ctypes.c_longlong, _P, _I, _P, _I, _P])
# FE-easy on the strict engine's limbs, counting its own launches
KERNEL_EASY_LIMBS = CudaKernel("final_exp.cu", "final_exp_easy",
                               [_P, _P, _P, ctypes.c_longlong, _I, _P])

# The |x| square-and-multiply ladder as segments: after the leading bit, a
# set bit at gap L costs L squarings then one product; trailing zeros are
# squarings only.
X_SEGMENTS = []
_run = 0
for _bit in bin(OP.X_ABS)[3:]:
    _run += 1
    if _bit == "1":
        X_SEGMENTS.append((_run, True))
        _run = 0
if _run:
    X_SEGMENTS.append((_run, False))
del _run, _bit


# --- the stacked fp12 maps ------------------------------------------------------

def conj(x: torch.Tensor) -> torch.Tensor:
    """Conjugation of a stacked fp12 (the inverse on the cyclotomic
    subgroup): the w part negated, as `tower_lazy.fp12_conj`."""
    return torch.cat([x[:6], -x[6:]])


def frobenius(x: torch.Tensor, power: int) -> torch.Tensor:
    """x^(p^power) of a stacked fp12 on the lazy tower."""
    return TL.stack12(TL.fp12_frobenius(TL.unstack12(x), power))


def frob_constants(power: int) -> list:
    """The six Fp2 constants of `tower_lazy.fp12_frobenius` at a power, one
    an Fp2 slot of the stacked fp12 (a0, a1, a2, b0, b1, b2): gamma_j of
    `fp6_frobenius` for v^j, times gamma_w for the w half."""
    c1 = c2 = c = OF.FP2_ONE
    for _ in range(power % 6):
        c1 = OF.fp2_mul(OF.fp2_conj(c1), OF._G1J[2])
        c2 = OF.fp2_mul(OF.fp2_conj(c2), OF._G1J[4])
    for _ in range(power % 12):
        c = OF.fp2_mul(OF.fp2_conj(c), OF._G1J[1])
    half = [OF.FP2_ONE, c1, c2]
    return half + [OF.fp2_mul(g, c) for g in half]


def _words(v: int) -> list:
    """A field value -> its canonical Montgomery words (v 2^384 mod p)."""
    return split(v * (1 << 384) % OF.P)


# (3, 6, 2, 12): the words of the constants of powers 1, 2 and 3
FROB_WORDS = np.array([[[_words(h) for h in c] for c in frob_constants(p)] for p in (1, 2, 3)],
                      np.uint32).view(np.int32)


# --- the hard part as a program -------------------------------------------------
#
# Ops of (code, a, b, flags) on an accumulator A and an operand B
# (csrc/final_exp.cuh): LOAD A <- value a, B <- value b (-1 keeps it; flags
# bit 0 conjugates A, bit 1 B); SQR a cyclotomic squares of A; MUL A <- A B;
# CONJ; FROB A <- A^(p^a); STORE value a <- A; OUT the result <- A.
LOAD, SQR, MUL, CONJ, FROB, STORE, OUT = range(1, 8)
# the values: T2 the input, the others the chain's t0-t6
T2, T0, T1, T3, T4, T5, T6 = range(7)
HARD_VALUES = 7


def _load(a: int = -1, b: int = -1, conj_a: bool = False, conj_b: bool = False) -> tuple:
    return (LOAD, a, b, int(conj_a) | 2 * int(conj_b))


def _op(code: int, a: int = 0) -> tuple:
    return (code, a, 0, 0)


def _ladder(base: int) -> list:
    """A <- conj(A^|x|) = A^-x for A = value `base` (cyclotomic_exp_x_conj):
    each segment's squares, then the product by the base."""
    ops = []
    for n_sqr, do_mul in X_SEGMENTS:
        ops.append(_op(SQR, n_sqr))
        if do_mul:
            ops += [_load(b=base), _op(MUL)]
    return ops + [_op(CONJ)]


# the chain of `oracle/pairing.py:final_exp`
HARD_PROGRAM = tuple(
    [_load(T2), _op(SQR, 1), _op(CONJ), _op(STORE, T1)]               # t1 = conj(t2^2)
    + [_load(T2)] + _ladder(T2) + [_op(STORE, T3)]                    # t3 = ex(t2)
    + [_op(SQR, 1), _op(STORE, T4)]                                   # t4 = t3^2
    + [_load(T1, T3), _op(MUL), _op(STORE, T5)]                       # t5 = t1 t3
    + _ladder(T5) + [_op(STORE, T1)]                                  # t1 = ex(t5)
    + _ladder(T1) + [_op(STORE, T0)]                                  # t0 = ex(t1)
    + _ladder(T0) + [_load(b=T4), _op(MUL), _op(STORE, T6)]           # t6 = ex(t0) t4
    + _ladder(T6)                                                     # t4 = ex(t6)
    + [_load(b=T5, conj_b=True), _op(MUL), _load(b=T2), _op(MUL),     # t4 = t4 conj(t5) t2
       _op(STORE, T4)]
    + [_load(T1, T2), _op(MUL), _op(FROB, 3), _op(STORE, T1)]         # t1 = (t1 t2)^(p^3)
    + [_load(T6, T2, conj_b=True), _op(MUL), _op(FROB, 1),            # t6 = (t6 conj(t2))^p
       _op(STORE, T6)]
    + [_load(T3, T0), _op(MUL), _op(FROB, 2)]                         # t3 = (t3 t0)^(p^2)
    + [_load(b=T1), _op(MUL), _load(b=T6), _op(MUL), _load(b=T4), _op(MUL), _op(OUT)])

# one ladder alone: the input's conj(x^|x|), `curves/pairing.py:cyclotomic_exp_x_conj`
LADDER_PROGRAM = tuple([_load(T2)] + _ladder(T2) + [_op(OUT)])


def run_program(program, x, ops):
    """Walk a program of the hard part over an engine's fp12 ops (`conj`,
    `mul`, `frobenius`, and `cyc_sqr`, one square, run n times for SQR n),
    the input as value T2."""
    vals, a, b = {T2: x}, None, None
    for code, u, v, flags in program:
        if code == LOAD:
            if u >= 0:
                a = ops.conj(vals[u]) if flags & 1 else vals[u]
            if v >= 0:
                b = ops.conj(vals[v]) if flags & 2 else vals[v]
        elif code == SQR:
            for _ in range(u):
                a = ops.cyc_sqr(a)
        elif code == MUL:
            a = ops.mul(a, b)
        elif code == CONJ:
            a = ops.conj(a)
        elif code == FROB:
            a = ops.frobenius(a, u)
        elif code == STORE:
            vals[u] = a
        else:
            return a
    raise ValueError("a program of the hard part ends in OUT")


def easy_part(f, ops):
    """The easy part f^((p^6-1)(p^2+1)) over an engine's fp12 ops (`conj`,
    `inv`, `mul`, `frobenius`): conj(f) f^-1, then its Frobenius square
    times itself."""
    t2 = ops.mul(ops.conj(f), ops.inv(f))
    return ops.mul(ops.frobenius(t2, 2), t2)


# --- the plain versions and the wrappers ----------------------------------------

# the lazy engine's fp12 ops on digits, as plain PyTorch (K3's and K4's
# plain versions, the tower's inverse and Frobenius maps)
PLAIN_OPS = SimpleNamespace(
    conj=conj, mul=K4.fp12_mul_plain, frobenius=frobenius,
    inv=lambda f: TL.stack12(TL.fp12_inv(TL.unstack12(f))),
    cyc_sqr=lambda f: K3.cyc_sqr_plain(f, 1))


def easy_plain(f: torch.Tensor) -> torch.Tensor:
    """FE-easy's plain PyTorch version: `easy_part` over `PLAIN_OPS`."""
    return easy_part(f, PLAIN_OPS)


def hard_plain(t2: torch.Tensor) -> torch.Tensor:
    """FE-hard's plain PyTorch version: `HARD_PROGRAM` over `PLAIN_OPS`."""
    return run_program(HARD_PROGRAM, t2, PLAIN_OPS)


@functools.lru_cache(maxsize=16)
def _tables(device: str) -> tuple:
    """HARD_PROGRAM and FROB_WORDS as int32 tensors on the device, made once."""
    prog = torch.tensor(HARD_PROGRAM, dtype=torch.int32, device=device)
    return prog, torch.from_numpy(FROB_WORDS.copy()).to(device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_words(x: torch.Tensor) -> bool:
    return x.dim() == 3 and tuple(x.shape[:2]) == (12, WORDS)


# FE-easy's input layouts by a row's entries: the format and the plain
# version's conversion to digits
_EASY_IN = {LZ.ELEM: (FMT_DIGITS, lambda f: f), WORDS: (FMT_WORDS, words_to_digits_plain),
            LIMBS: (FMT_LIMBS, limbs_to_digits_plain)}


def easy(f: torch.Tensor) -> torch.Tensor:
    """The easy part of f, (12, 30, N) digits, (12, 12, N) canonical words
    or (12, 24, N) strict limbs (the layout read from the shape), int32:
    one FE-easy launch for a CUDA tensor, whose result is a (12, 12, N)
    word stack for `hard`; for a CPU one the plain version's digits (of
    the words' or the limbs' digits, `words_to_digits_plain`,
    `limbs_to_digits_plain`)."""
    rows = f.shape[1] if f.dim() == 3 and f.shape[1] in _EASY_IN else LZ.ELEM
    fmt, to_digits = _EASY_IN[rows]
    if stacked_operands("final_exp_easy", [f], [12], rows):
        return easy_plain(to_digits(f))
    n = f.shape[-1]
    out = torch.empty((12, WORDS, n), dtype=torch.int32, device=f.device)
    _, frob = _tables(str(f.device))
    kernel = KERNEL_EASY_LIMBS if fmt == FMT_LIMBS else KERNEL_EASY
    with torch.cuda.device(f.device):
        kernel.launch(f.data_ptr(), out.data_ptr(), frob.data_ptr(), n, fmt, _stream(f))
    return out


def hard_limbs_plain(t2: torch.Tensor) -> torch.Tensor:
    """FE-hard's plain version with `out="limbs"`: `hard_plain`, to words
    and split into the strict (12, 24, N) limbs, as the kernel stores them
    (`words_to_limbs_plain`; limb for limb the lazy egress,
    `tower_lazy.fp12_egress`, in its leaf order)."""
    return words_to_limbs_plain(digits_to_words_plain(hard_plain(t2)))


def hard(t2: torch.Tensor, out: str = "digits") -> torch.Tensor:
    """The hard part of t2 -> (12, 30, N) digits, or with out="limbs" the
    strict (12, 24, N) limbs (`tower_lazy.unstack12` nests them): one FE-hard
    launch for a CUDA tensor, t2 the (12, 12, N) words that `easy` returns
    there; the plain version for a CPU one (`hard_plain`,
    `hard_limbs_plain`), t2 the digits that `easy` returns there."""
    if out not in ("digits", "limbs"):
        raise ValueError(f"final_exp_hard stores digits or limbs, not {out!r}")
    if not t2.is_cuda and stacked_operands("final_exp_hard", [t2], [12]):
        return hard_plain(t2) if out == "digits" else hard_limbs_plain(t2)
    if t2.dtype != torch.int32 or not _is_words(t2) or not t2.is_contiguous():
        raise ValueError("on the card final_exp_hard takes FE-easy's word stack: (12, 12, N) "
                         f"contiguous int32, not {tuple(t2.shape)} {t2.dtype}")
    n = t2.shape[-1]
    scratch = torch.empty((HARD_VALUES - 1, 12, WORDS, n), dtype=torch.int32, device=t2.device)
    rows = LZ.ELEM if out == "digits" else LIMBS
    res = torch.empty((12, rows, n), dtype=torch.int32, device=t2.device)
    prog, frob = _tables(str(t2.device))
    with torch.cuda.device(t2.device):
        KERNEL_HARD.launch(t2.data_ptr(), scratch.data_ptr(), res.data_ptr(), n,
                           prog.data_ptr(), len(HARD_PROGRAM), frob.data_ptr(),
                           FMT_DIGITS if out == "digits" else FMT_LIMBS, _stream(t2))
    return res
