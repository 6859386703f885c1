"""K4: the fp12 product as one hand-written CUDA kernel.

Counterpart of the `mul12` instance of `ark_blst_tpu/ops/pallas_lazy.py:
tower_fused` (`ops/tower_lazy.py:_fused_op("mul12")`): two stacked
`(12, 30, N)` fp12 batches -> their product, Karatsuba over fp6 (54 base
products). The kernel (`csrc/fp12_mul.cu` on `csrc/tower381.cuh`) holds
each element in shared memory as 32-bit Montgomery words, its work split
over a block's threads, and returns balanced digits within 4096: the same
field elements as `fp12_mul_plain`, its plain PyTorch version
(`tower_lazy.fp12_mul_many([(a, b)])`), not the same digits.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from . import tower_lazy as TL

KERNEL = CudaKernel(
    "fp12_mul.cu",
    "tower_fp12_mul",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)


def fp12_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    return TL.stack12(TL.fp12_mul_many([(TL.unstack12(a), TL.unstack12(b))])[0])


def fp12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for two (12, 30, N) int32 fp12 stacks: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if stacked_operands("fp12_mul", [a, b], [12, 12]):
        return fp12_mul_plain(a, b)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], stream)
    return out
