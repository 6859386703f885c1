"""K7-K10: the strict engine's field ops as hand-written CUDA kernels.

Counterpart of `ark_blst_tpu/ops/pallas_field.py` (`_block_call` through
`mont_mul`, `add`, `sub`, `neg`, `mul_many`). The kernels live in
`csrc/strict_field.cu` on `csrc/strict16.cuh`, one library with four
entry points, templated on L = 24 (Fp) and L = 16 (Fr):

  K7 `mont_mul`  a*b/R mod p                    (`fieldops.mul`)
  K8 `add`       a + b mod p                    (`fieldops.add`)
  K9 `sub`       a - b mod p                    (`fieldops.sub`)
  K10 `neg`      -a mod p, with -0 = 0          (`fieldops.neg`)

Operands are stacked `(L, *batch)` int32 tensors of 16-bit limbs. Each
wrapper broadcasts its operands to their common batch shape first, then
flattens to a contiguous `(L, n)`, then launches the kernel for CUDA tensors
or runs the plain version (the `fieldops` function in brackets) for CPU
tensors, and counts its launches. The kernels are bit-equal to the plain
versions for every input of 16-bit limbs (they drop the same carries); on
canonical inputs (< p) both give the canonical result. Limbs outside
[0, 2^16) are not checked and give garbage.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..cuda import CudaKernel
from . import fieldops as FO
from .limbs import FieldSpec

KERNEL_LIMBS = (24, 16)  # the specs the kernels are built for: Fp and Fr

_BINARY = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_UNARY = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
KERNELS = {
    "mont_mul": CudaKernel("strict_field.cu", "sf_mont_mul", _BINARY),  # K7
    "add": CudaKernel("strict_field.cu", "sf_add", _BINARY),  # K8
    "sub": CudaKernel("strict_field.cu", "sf_sub", _BINARY),  # K9
    "neg": CudaKernel("strict_field.cu", "sf_neg", _UNARY),  # K10
}
PLAIN = {"mont_mul": FO.mul, "add": FO.add, "sub": FO.sub, "neg": FO.neg}
# CPU tensors run the plain version in chunks of elements: its limb products
# are int64, L^2 of them per element (4.6 KB for Fp), ~19 MB per chunk
PLAIN_CHUNK = 1 << 12


def _common_shape(args) -> torch.Size:
    """The operands' broadcast shape (equal shapes skip torch's slow check)."""
    shape = args[0].shape
    if all(a.shape == shape for a in args[1:]):
        return shape
    return torch.broadcast_shapes(*(a.shape for a in args))


def _flat_operands(op: str, spec: FieldSpec, args):
    """Broadcast to the common shape, then flatten: -> (shape, [(L, n)])."""
    L = spec.num_limbs
    if any(a.dim() == 0 or a.shape[0] != L for a in args):
        raise ValueError(f"{op}: limb axis of {[tuple(a.shape) for a in args]} is not L={L}")
    shape = _common_shape(args)
    if any(a.dtype != torch.int32 for a in args):
        raise ValueError(f"{op} wants int32 limbs")
    dev = args[0].device
    if any(a.device != dev for a in args):
        raise ValueError(f"{op} operands on {[str(a.device) for a in args]}")
    return shape, [a.expand(shape).reshape(L, -1).contiguous() for a in args]


def _block_call(op: str, spec: FieldSpec, *args) -> torch.Tensor:
    """Run op over stacked `(L, *batch)` operands: the kernel for CUDA
    tensors, the plain version for CPU tensors, a ValueError otherwise."""
    shape, flats = _flat_operands(op, spec, args)
    dev = flats[0].device
    if dev.type == "cpu":
        n = flats[0].shape[1]
        outs = [PLAIN[op](*(f[:, i : i + PLAIN_CHUNK] for f in flats), spec)
                for i in range(0, max(n, 1), PLAIN_CHUNK)]
        return torch.cat(outs, dim=1).reshape(shape)
    if dev.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or CPU tensors, got {dev}")
    if spec.num_limbs not in KERNEL_LIMBS:
        raise ValueError(f"{op}: the kernel takes L in {KERNEL_LIMBS}, not {spec.num_limbs}")
    out = torch.empty_like(flats[0])
    n = out.shape[1]
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            ptrs = [f.data_ptr() for f in flats] + [out.data_ptr()]
            KERNELS[op].launch(*ptrs, n, spec.num_limbs, stream)
    return out.reshape(shape)


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return _block_call("mont_mul", spec, a, b)


def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return _block_call("add", spec, a, b)


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return _block_call("sub", spec, a, b)


def neg(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return _block_call("neg", spec, a)


def mul_many(pairs, spec: FieldSpec) -> list:
    """Several independent Montgomery products in ONE K7 launch: each pair
    is broadcast to its own common shape, the pairs are concatenated along
    the batch axis, and the product is cut back apart: [(a, b), ...] ->
    [a*b, ...]. Pairs may have mismatched shapes (a bucket (L, lanes, W, 1)
    times a point (L, lanes, 1, 1) in the MSM accumulation)."""
    L = spec.num_limbs
    shapes = [_common_shape(pair) for pair in pairs]
    flat_a = torch.cat([a.expand(s).reshape(L, -1) for (a, _), s in zip(pairs, shapes)], dim=1)
    flat_b = torch.cat([b.expand(s).reshape(L, -1) for (_, b), s in zip(pairs, shapes)], dim=1)
    out = mont_mul(flat_a, flat_b, spec)
    res, ofs = [], 0
    for shp in shapes:
        cnt = math.prod(shp[1:])
        res.append(out[:, ofs : ofs + cnt].reshape(shp))
        ofs += cnt
    return res
