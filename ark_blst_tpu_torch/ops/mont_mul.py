"""K1: the lazy Montgomery product as a hand-written CUDA kernel.

Counterpart of `ark_blst_tpu/ops/pallas_lazy.py:mont_mul_stacked`: stacked
`(30, *batch)` int32 operands (mul-ready x mul-ready, or canonical x
canonical), out = a * b / 2^390, bit-equal to `lazy13.mont_mul`. The kernel
source is `csrc/mont_mul.cu`; `mont_mul_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel
from . import lazy13 as LZ

KERNEL = CudaKernel(
    "mont_mul.cu",
    "lz_mont_mul",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    return LZ.mont_mul(a, b)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise lazy Montgomery product of two `(30, *batch)` int32
    stacks: the CUDA kernel for CUDA tensors (contiguous), the plain version
    for CPU tensors."""
    if a.shape != b.shape or a.shape[0] != LZ.ELEM or a.dim() < 2:
        raise ValueError(f"mont_mul wants two (30, *batch) stacks, got {a.shape}, {b.shape}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("mont_mul wants int32 digits")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b)
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"mont_mul operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul wants contiguous operands")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a[0].numel(), stream)
    return out
