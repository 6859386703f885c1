"""K11: the fp12 square as one hand-written CUDA kernel.

Counterpart of the `sqr12` instance of `ark_blst_tpu/ops/pallas_lazy.py:
tower_fused` (`ops/tower_lazy.py:_fused_op("sqr12")`, taken by
`tower_lazy.fp12_sqr` for a blockable operand): a stacked `(12, 30, N)`
fp12 batch -> its square, the complex squaring (2 fp6 products, 36 base
products). The kernel (`csrc/fp12_sqr.cu` on `csrc/tower381.cuh`) holds
each element in shared memory as 32-bit Montgomery words, its work split
over a block's threads, and returns balanced digits within 4096: the same
field elements as `fp12_sqr_plain`, its plain PyTorch version
(`tower_lazy.fp12_sqr`), not the same digits. The unfused Miller loop
(`curves/pairing.py`, `fuse=False`) calls it at every doubling event.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from . import tower_lazy as TL

KERNEL = CudaKernel(
    "fp12_sqr.cu",
    "tower_fp12_sqr",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)


def fp12_sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    return TL.stack12(TL.fp12_sqr(TL.unstack12(a)))


def fp12_sqr(a: torch.Tensor) -> torch.Tensor:
    """a^2 for a (12, 30, N) int32 fp12 stack: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if stacked_operands("fp12_sqr", [a], [12]):
        return fp12_sqr_plain(a)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(a.data_ptr(), out.data_ptr(), a.shape[-1], stream)
    return out
