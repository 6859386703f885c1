"""K3: n cyclotomic squarings of an fp12 as one hand-written CUDA kernel.

Counterpart of `ark_blst_tpu/ops/pallas_lazy.py:cyc_sqr_stacked`: a stacked
`(12, 30, N)` fp12 batch squared n times (Granger-Scott: 18 base products
and the 3t +- 2z recombination). The kernel (`csrc/cyc_sqr.cu` on
`csrc/tower381.cuh`) holds each element in shared memory as 32-bit
Montgomery words for all n squares, its work split over a block's threads,
and returns balanced digits within 4096: the same field elements as
`cyc_sqr_plain`, its plain PyTorch version (n times
`tower_lazy._cyc_sqr_core`, a Barrett contraction before each square), not
the same digits.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, stacked_operands
from . import tower_lazy as TL

KERNEL = CudaKernel(
    "cyc_sqr.cu",
    "tower_cyc_sqr",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
)


def cyc_sqr_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    for _ in range(n):
        x = TL.stack12(TL._cyc_sqr_core(TL.unstack12(x)))
    return x


def cyc_sqr(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (12, 30, N) int32, squared n >= 1 times in the cyclotomic subgroup:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if n < 1:
        raise ValueError(f"cyc_sqr wants n >= 1 squarings, got {n}")
    if stacked_operands("cyc_sqr", [x], [12]):
        return cyc_sqr_plain(x, n)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(x.data_ptr(), out.data_ptr(), x.shape[-1], n, stream)
    return out
