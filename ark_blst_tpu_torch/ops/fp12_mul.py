"""K4: the fp12 product as one hand-written CUDA kernel.

Counterpart of the `mul12` instance of `ark_blst_tpu/ops/pallas_lazy.py:
tower_fused` (`ops/tower_lazy.py:_fused_op("mul12")`): two stacked fp12
batches -> their product, Karatsuba over fp6 (54 base products). The
kernel (`csrc/fp12_mul.cu` on `csrc/tower381.cuh`) holds each element in
shared memory as 32-bit Montgomery words, its work split over a block's
threads, in one of three layouts of its edges, an instantiation each:
  digits -> digits  `(12, 30, N)` digits (the unfused path's, `KERNEL`):
                    balanced digits within 4096, the same field elements as
                    `fp12_mul_plain`, its plain PyTorch version
                    (`tower_lazy.fp12_mul_many([(a, b)])`), not the same
                    digits;
  words -> words    `(12, 12, N)` canonical words (`ops/words.py`; the
                    multi-pairings' fold on K6-chain's conj(f),
                    `KERNEL_WORDS`);
  words -> limbs    the strict `(12, 24, N)` limbs (the fold's last level
                    in `multi_miller_loop`, `KERNEL_LIMBS`), nested by
                    `tower_lazy.unstack12`.
Words and limbs are canonical: the kernel's equal the plain version's word
for word and limb for limb. Each layout counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from . import lazy13 as LZ
from . import tower_lazy as TL
from .words import (FMT_LIMBS, FMT_WORDS, LIMBS, WORDS, digits_to_words_plain,
                    words_to_digits_plain, words_to_limbs_plain)

_P = ctypes.c_void_p
KERNEL = CudaKernel("fp12_mul.cu", "tower_fp12_mul", [_P, _P, _P, ctypes.c_longlong, _P])
# the word layouts: one entry taking the formats, a counter for each layout
_FORMATS_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
KERNEL_WORDS = CudaKernel("fp12_mul.cu", "tower_fp12_mul_formats", _FORMATS_ARGS)
KERNEL_LIMBS = CudaKernel("fp12_mul.cu", "tower_fp12_mul_formats", _FORMATS_ARGS)
# out= -> (the operands' layout, the kernel, the output rows, its format)
_LAYOUTS = {"digits": ("digits", KERNEL, LZ.ELEM, None),
            "words": ("words", KERNEL_WORDS, WORDS, FMT_WORDS),
            "limbs": ("words", KERNEL_LIMBS, LIMBS, FMT_LIMBS)}


def _layout(a: torch.Tensor) -> str:
    """The layout of an operand, read from its shape: (12, 12, N) words,
    otherwise digits (checked by `stacked_operands`)."""
    return "words" if a.dim() == 3 and a.shape[1] == WORDS else "digits"


def _mul_ready(w: torch.Tensor) -> torch.Tensor:
    """(12, 12, N) canonical words -> digits of the same field elements in
    the lazy tower's domain, |value| < 3p, which its products take: a
    Montgomery product by one after `words_to_digits_plain` (whose value,
    the words' times 2^6, reaches 64p)."""
    d = words_to_digits_plain(w).transpose(0, 1)
    return LZ.mont_mul_const(d, LZ.ONE13).transpose(0, 1).contiguous()


def fp12_mul_plain(a: torch.Tensor, b: torch.Tensor, out: str | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the operands' layout: on
    digits the lazy tower's product; on words the product of their digits
    (`_mul_ready`), back to words (`digits_to_words_plain`) or with
    out="limbs" to the strict limbs of those words
    (`words_to_limbs_plain`)."""
    if _layout(a) == "digits":
        return TL.stack12(TL.fp12_mul_many([(TL.unstack12(a), TL.unstack12(b))])[0])
    words = digits_to_words_plain(fp12_mul_plain(_mul_ready(a), _mul_ready(b)))
    return words_to_limbs_plain(words) if out == "limbs" else words


def fp12_mul(a: torch.Tensor, b: torch.Tensor, out: str | None = None) -> torch.Tensor:
    """a * b for two int32 fp12 stacks of one layout, read from their shape:
    (12, 30, N) digits or (12, 12, N) canonical words. `out` is "digits"
    (digits in), "words" or "limbs" (words in; the strict (12, 24, N)
    limbs), by default the operands' layout. The CUDA kernel's layout for
    CUDA tensors, the plain version for CPU tensors; other shapes and
    layouts raise."""
    layout = _layout(a)
    out = layout if out is None else out
    if out not in _LAYOUTS:
        raise ValueError(f"fp12_mul stores digits, words or limbs, not {out!r}")
    need, kernel, rows, out_fmt = _LAYOUTS[out]
    if layout != need:
        raise ValueError(f"fp12_mul stores {out} from {need} operands, not {layout}")
    width = WORDS if layout == "words" else LZ.ELEM
    if stacked_operands("fp12_mul", [a, b], [12, 12], width):
        return fp12_mul_plain(a, b, out)
    n = a.shape[-1]
    res = torch.empty((12, rows, n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if out_fmt is None:
            kernel.launch(a.data_ptr(), b.data_ptr(), res.data_ptr(), n, stream)
        else:
            kernel.launch(a.data_ptr(), b.data_ptr(), res.data_ptr(), n, FMT_WORDS, out_fmt,
                          stream)
    return res
