"""K4: the fp12 product as one hand-written CUDA kernel.

Counterpart of the `mul12` instance of `ark_blst_tpu/ops/pallas_lazy.py:
tower_fused` (`ops/tower_lazy.py:_fused_op("mul12")`): two stacked fp12
batches -> their product, Karatsuba over fp6 (54 base products). The
kernel (`csrc/fp12_mul.cu` on `csrc/tower381.cuh`) holds each element in
shared memory as 32-bit Montgomery words, its work split over a block's
threads, in one of four layouts of its edges, an instantiation each:
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
                    `tower_lazy.unstack12`;
  limbs -> limbs    strict `(12, 24, N)` limbs in and out (the strict
                    engine's fused multi-pairings' fold on K6-chain's
                    conj(f), `KERNEL_LIMBS_LIMBS`): the strict tower's
                    `fp12_mul` (K7-K10 an op, `ark_blst_tpu/curves/
                    pairing.py:470 _fold_mul` on the strict tower) in one
                    launch.
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
                    limbs_to_digits_plain, words_to_digits_plain, words_to_limbs_plain)

_P = ctypes.c_void_p
KERNEL = CudaKernel("fp12_mul.cu", "tower_fp12_mul", [_P, _P, _P, ctypes.c_longlong, _P])
# the word layouts: one entry taking the formats, a counter for each layout
_FORMATS_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
KERNEL_WORDS = CudaKernel("fp12_mul.cu", "tower_fp12_mul_formats", _FORMATS_ARGS)
KERNEL_LIMBS = CudaKernel("fp12_mul.cu", "tower_fp12_mul_formats", _FORMATS_ARGS)
KERNEL_LIMBS_LIMBS = CudaKernel("fp12_mul.cu", "tower_fp12_mul_formats", _FORMATS_ARGS)
# (the operands' layout, out=) -> (the kernel, the formats in and out)
_LAYOUTS = {("digits", "digits"): (KERNEL, None, None),
            ("words", "words"): (KERNEL_WORDS, FMT_WORDS, FMT_WORDS),
            ("words", "limbs"): (KERNEL_LIMBS, FMT_WORDS, FMT_LIMBS),
            ("limbs", "limbs"): (KERNEL_LIMBS_LIMBS, FMT_LIMBS, FMT_LIMBS)}
_ROWS = {"digits": LZ.ELEM, "words": WORDS, "limbs": LIMBS}  # a layout's rows


def _layout(a: torch.Tensor) -> str:
    """The layout of an operand, read from its shape: (12, 12, N) words,
    (12, 24, N) strict limbs, otherwise digits (checked by
    `stacked_operands`)."""
    rows = a.shape[1] if a.dim() == 3 else None
    return "words" if rows == WORDS else "limbs" if rows == LIMBS else "digits"


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
    (`_mul_ready`), on strict limbs of their ingested digits
    (`limbs_to_digits_plain`), back to words (`digits_to_words_plain`) or
    with out="limbs" (strict limbs in: always) to the strict limbs of those
    words (`words_to_limbs_plain`)."""
    layout = _layout(a)
    if layout == "digits":
        return TL.stack12(TL.fp12_mul_many([(TL.unstack12(a), TL.unstack12(b))])[0])
    ready = _mul_ready if layout == "words" else limbs_to_digits_plain
    words = digits_to_words_plain(fp12_mul_plain(ready(a), ready(b)))
    return words_to_limbs_plain(words) if out == "limbs" or layout == "limbs" else words


def fp12_mul(a: torch.Tensor, b: torch.Tensor, out: str | None = None) -> torch.Tensor:
    """a * b for two int32 fp12 stacks of one layout, read from their shape:
    (12, 30, N) digits, (12, 12, N) canonical words or (12, 24, N) strict
    limbs. `out` is "digits" (digits in), "words" or "limbs" (words in; the
    strict (12, 24, N) limbs) or "limbs" (strict limbs in), by default the
    operands' layout. The CUDA kernel's layout for CUDA tensors, the plain
    version for CPU tensors; other shapes and layouts raise."""
    layout = _layout(a)
    out = layout if out is None else out
    if (layout, out) not in _LAYOUTS:
        raise ValueError(f"fp12_mul has no layout storing {out} from {layout} operands")
    kernel, in_fmt, out_fmt = _LAYOUTS[layout, out]
    if stacked_operands("fp12_mul", [a, b], [12, 12], _ROWS[layout]):
        return fp12_mul_plain(a, b, out)
    n = a.shape[-1]
    res = torch.empty((12, _ROWS[out], n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if out_fmt is None:
            kernel.launch(a.data_ptr(), b.data_ptr(), res.data_ptr(), n, stream)
        else:
            kernel.launch(a.data_ptr(), b.data_ptr(), res.data_ptr(), n, in_fmt, out_fmt,
                          stream)
    return res
