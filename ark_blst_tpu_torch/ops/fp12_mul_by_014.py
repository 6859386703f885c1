"""K12: the Miller loop's sparse line product as one hand-written CUDA kernel.

Counterpart of the `mul_by_014` instance of `ark_blst_tpu/ops/pallas_lazy.py:
tower_fused` (`ops/tower_lazy.py:_fused_op("mul_by_014")`, taken by a
single-item `tower_lazy.fp12_mul_by_014_many` for a blockable operand):
f * ((c0 + c1 v) + (c4 v) w) for a stacked `(12, 30, N)` fp12 batch F and
the line `(6, 30, N)` C, rows `[c0[0], c0[1], c1[0], c1[1], c4[0], c4[1]]`
(the scaled legs that `_ell_legs` returns, in the order of
`tower_lazy.py:656`); 15 fp2 products (45 base products). The kernel
(`csrc/fp12_mul_by_014.cu` on `csrc/tower381.cuh`) holds each element in
shared memory as 32-bit Montgomery words, its work split over a block's
threads, and returns balanced digits within 4096: the same field elements
as `fp12_mul_by_014_plain`, its plain PyTorch version, not the same
digits. The unfused Miller loop (`curves/pairing.py`, `fuse=False`) calls
it at every event.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from . import tower_lazy as TL

KERNEL = CudaKernel(
    "fp12_mul_by_014.cu",
    "tower_fp12_mul_by_014",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)


def fp12_mul_by_014_plain(f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    c0, c1, c4 = (c[0], c[1]), (c[2], c[3]), (c[4], c[5])
    return TL.stack12(TL.fp12_mul_by_014_many([(TL.unstack12(f), c0, c1, c4)])[0])


def fp12_mul_by_014(f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """F (12, 30, N) times the sparse line C (6, 30, N), int32: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if stacked_operands("fp12_mul_by_014", [f, c], [12, 6]):
        return fp12_mul_by_014_plain(f, c)
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        KERNEL.launch(f.data_ptr(), c.data_ptr(), out.data_ptr(), f.shape[-1], stream)
    return out
