"""K1-inv and K1-scan: the lazy engine's inversion chains, each one CUDA
launch; K7-inv: the strict engine's inversion, one launch.

Counterpart of the `lax.scan`s over `ark_blst_tpu/ops/pallas_lazy.py:41
mont_mul_stacked` (K1) that the JAX package runs inside one compiled
program: the Fermat ladder of `ops/tower_lazy.py:264 fp_inv` and
`curves/msm_pallas2.py:394 _fermat_inv`, and the two scans of the blocked
batch inversion `curves/msm_pallas2.py:434 _batch_inverse`. The kernels
(`csrc/fp_inv.cu` on `csrc/fp_inv.cuh`) keep each chain in registers as
32-bit Montgomery words:
  K1-inv   `fp_inv`: X^(p-2) per element of a (30, *batch) digit stack, one
           thread an element;
  K1-scan  `scan_up` and `scan_down`: one level of the batch inversion over
           a (30, g m) stack read as g rows of m columns, one thread a
           column;
  K7-inv   `fp_inv_limbs`: a^(p-2) per element of a strict (24, *batch) limb
           stack, one thread an element: the `lax.scan` of
           `ark_blst_tpu/ops/dispatch.py:128 fp_pow` over K7
           (`ops/pallas_field.py:66 _block_call`) that `:143 fp_inv` runs.
K1-inv and K7-inv compute the inverse by a constant-time binary GCD
(`csrc/fp_inv.cuh` `inverse`), not by the ladder: the same canonical
result, a chain of cheap steps instead of 608 dependent products.
Their plain versions (`fp_inv_plain`, `scan_up_plain`, `scan_down_plain`)
are the loops of lazy products (`mont_mul_plain`) the port ran before, so on
CPU tensors every result is digit for digit what it was. A kernel's output
is the same field element in other digits: canonical, within 4096.

Domains: a digit stack holds X = x R13 (R13 = 2^390); a Montgomery product
is a b / R13, so the ladder gives X^(p-2) / R13^(p-3) = x^-1 R13, the
Montgomery inverse (0 for x = 0). A strict stack holds X = x R (R = 2^384)
as canonical limbs, the kernel's words' own number: K7-inv's result is the
canonical x^-1 R, equal to its plain version (the strict engine's loop of
products, `ops/dispatch.py:fp_pow`) limb for limb.
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda import CudaKernel, cpu_operands
from ..oracle.field import P
from . import fieldops as FO
from . import lazy13 as LZ
from .limbs import FP
from .mont_mul import mont_mul_plain

# MSB-first bits of p - 2 for the Fermat ladder
P_MINUS_2_BITS = [int(b) for b in bin(P - 2)[2:]]
WORDS = 12  # 32-bit words of an element in K1-scan's prefix scratch
ROOT_WIDTH = 2048  # the batch inversion runs K1-inv at or below this width
BLOCK_ROWS = (64, 32, 16, 8, 4, 2)  # the rows g of a level, the first that divides n

_P = ctypes.c_void_p
KERNEL_INV = CudaKernel("fp_inv.cu", "lz_fp_inv", [_P, _P, ctypes.c_longlong, _P])
KERNEL_UP = CudaKernel("fp_inv.cu", "lz_scan_up",
                       [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P])
KERNEL_DOWN = CudaKernel("fp_inv.cu", "lz_scan_down",
                         [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P])
KERNEL_INV_LIMBS = CudaKernel("fp_inv.cu", "sf_fp_inv", [_P, _P, ctypes.c_longlong, _P])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_stack(name: str, z: torch.Tensor) -> None:
    if z.dim() != 2 or z.shape[0] != LZ.ELEM:
        raise ValueError(f"{name} wants a (30, n) digit stack, got {tuple(z.shape)}")


def _columns(name: str, z: torch.Tensor, g: int) -> int:
    """m, the columns of a (30, g m) stack read as g rows."""
    _check_stack(name, z)
    if g < 1 or z.shape[1] % g:
        raise ValueError(f"{name}: {z.shape[1]} elements are not {g} rows")
    return z.shape[1] // g


# --- K1-inv: the inversion -----------------------------------------------------

def fp_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the unrolled square-and-multiply
    ladder of 380 squarings and 228 products."""
    r = a
    for bit in P_MINUS_2_BITS[1:]:
        r = mont_mul_plain(r, r)
        if bit:
            r = mont_mul_plain(r, a)
    return r


def fp_inv(a: torch.Tensor) -> torch.Tensor:
    """Montgomery inverse of every element of a (30, *batch) int32 stack
    (digits |d| <= 8191; 0 for a zero element): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if a.dim() < 2 or a.shape[0] != LZ.ELEM:
        raise ValueError(f"fp_inv wants a (30, *batch) stack, got {tuple(a.shape)}")
    if cpu_operands("fp_inv", [a]):
        return fp_inv_plain(a)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        KERNEL_INV.launch(a.data_ptr(), out.data_ptr(), a[0].numel(), _stream(a))
    return out


# --- K7-inv: the strict engine's inversion ---------------------------------------

def fp_inv_limbs_plain(a: torch.Tensor) -> torch.Tensor:
    """K7-inv's plain PyTorch version: the strict engine's square-and-multiply
    over the 381 bits of p - 2 from one (`ops/dispatch.py:fp_pow`: 381
    squares and 229 products), on the plain Montgomery product
    (`fieldops.mul`)."""
    f = FO.consts(FP.mont_r, a.shape[1:], FP, a.device)
    for bit in bin(P - 2)[2:]:
        f = FO.mul(f, f, FP)
        if bit == "1":
            f = FO.mul(f, a, FP)
    return f


def fp_inv_limbs(a: torch.Tensor) -> torch.Tensor:
    """Montgomery inverse of every element of a strict (24, *batch) int32
    limb stack (0 for a zero element), canonical limbs: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if a.dim() < 2 or a.shape[0] != FP.num_limbs:
        raise ValueError(f"fp_inv_limbs wants a (24, *batch) stack, got {tuple(a.shape)}")
    x = a.reshape(FP.num_limbs, -1).contiguous()
    if cpu_operands("fp_inv_limbs", [x]):
        return fp_inv_limbs_plain(a)
    out = torch.empty_like(x)
    if x.shape[1] == 0:  # nothing to launch
        return out.reshape(a.shape)
    with torch.cuda.device(x.device):
        KERNEL_INV_LIMBS.launch(x.data_ptr(), out.data_ptr(), x.shape[1], _stream(x))
    return out.reshape(a.shape)


# --- K1-scan: one level of the blocked batch inversion -------------------------

def scan_up_plain(z: torch.Tensor, g: int):
    """The up pass's plain PyTorch version: (pre, total), pre the exclusive
    prefix products as a (g, 30, m) digit stack, total (30, m) the products
    of the columns."""
    rows = z.reshape(LZ.ELEM, g, -1).transpose(0, 1).contiguous()  # (g, 30, m)
    carry = (LZ.const(LZ.ONE13, rows[0]) + torch.zeros_like(rows[0])).contiguous()
    pre = torch.empty_like(rows)
    for k in range(g):  # exclusive prefix products
        pre[k] = carry
        carry = mont_mul_plain(carry, rows[k])
    return pre, carry


def scan_up(z: torch.Tensor, g: int):
    """Up pass over a (30, g m) int32 stack read as g rows of m columns
    (element k m + j in row k): (pre, total), total (30, m) the product of
    each column, pre the prefix products in the pass's own form for
    `scan_down` (words on the card, digits on the CPU)."""
    m = _columns("scan_up", z, g)
    if cpu_operands("scan_up", [z]):
        return scan_up_plain(z, g)
    pre = torch.empty((WORDS, z.shape[1]), dtype=torch.int32, device=z.device)
    total = torch.empty((LZ.ELEM, m), dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        KERNEL_UP.launch(z.data_ptr(), pre.data_ptr(), total.data_ptr(), g, m, _stream(z))
    return pre, total


def scan_down_plain(z: torch.Tensor, pre: torch.Tensor, inv_total: torch.Tensor,
                    g: int) -> torch.Tensor:
    """The down pass's plain PyTorch version."""
    rows = z.reshape(LZ.ELEM, g, -1).transpose(0, 1).contiguous()  # (g, 30, m)
    t = inv_total
    invs = torch.empty_like(rows)
    for k in reversed(range(g)):
        invs[k] = mont_mul_plain(t, pre[k])
        t = mont_mul_plain(t, rows[k])
    return invs.transpose(0, 1).reshape(LZ.ELEM, z.shape[1])


def scan_down(z: torch.Tensor, pre: torch.Tensor, inv_total: torch.Tensor,
              g: int) -> torch.Tensor:
    """Down pass: the inverse of every element of z, given `scan_up(z, g)`'s
    pre and the inverse of its column products (30, m)."""
    m = _columns("scan_down", z, g)
    if tuple(inv_total.shape) != (LZ.ELEM, m):
        raise ValueError(f"scan_down wants a (30, {m}) inv_total, got {tuple(inv_total.shape)}")
    cpu = cpu_operands("scan_down", [z, pre, inv_total])
    want = (g, LZ.ELEM, m) if cpu else (WORDS, z.shape[1])
    if tuple(pre.shape) != want:
        raise ValueError(f"scan_down wants pre {want}, got {tuple(pre.shape)}")
    if cpu:
        return scan_down_plain(z, pre, inv_total, g)
    inv = torch.empty_like(z)
    with torch.cuda.device(z.device):
        KERNEL_DOWN.launch(z.data_ptr(), pre.data_ptr(), inv_total.data_ptr(), inv.data_ptr(),
                           g, m, _stream(z))
    return inv


# --- the blocked batch inversion ----------------------------------------------

def block_rows(n: int) -> int | None:
    """The rows g of the batch inversion's level at width n, None where
    K1-inv runs (n <= ROOT_WIDTH, or no g divides n)."""
    if n <= ROOT_WIDTH:
        return None
    return next((g for g in BLOCK_ROWS if n % g == 0), None)


def _blocked(z, up, root, down):
    g = block_rows(z.shape[1])
    if g is None:
        return root(z)
    pre, total = up(z, g)
    return down(z, pre, _blocked(total, up, root, down), g)


def batch_inverse_plain(z: torch.Tensor) -> torch.Tensor:
    """The blocked batch inversion on the plain versions alone."""
    return _blocked(z, scan_up_plain, fp_inv_plain, scan_down_plain)


def batch_inverse(z: torch.Tensor) -> torch.Tensor:
    """Blocked Montgomery batch inversion of a lazy Fp vector (30, n): at
    each level the up pass, the inversion of the g-fold narrower column
    products, the down pass (~3 products an element); K1-inv at the root.
    The caller substitutes nonzero values for zero entries (a zero poisons
    its column). Kernels for a CUDA tensor, plain versions for a CPU one."""
    _check_stack("batch_inverse", z)
    return _blocked(z.contiguous(), scan_up, fp_inv, scan_down)
