"""The CUDA sources against the Python engine they mirror: the constants
compiled into csrc/lazy13.cuh, the kernels' C entry points and build flags.
(The kernels themselves compile and run only on the card:
tests/test_torch_cuda.py.)"""

import re

import pytest

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM

HEADER = (KC.CSRC_DIR / "lazy13.cuh").read_text()


def _array(name):
    m = re.search(rf"__constant__ int {name}\[ELEM\] = \{{([^}}]*)\}};", HEADER)
    assert m, f"{name} not found in lazy13.cuh"
    return [int(v) for v in m.group(1).replace("\n", " ").split(",")]


@pytest.mark.parametrize("name,want", [("P_DIGITS", LZ.P_DIGITS), ("NINV_DIGITS", LZ.NINV_DIGITS)])
def test_header_constants(name, want):
    assert _array(name) == want


@pytest.mark.parametrize("name,value", [
    ("ELEM", LZ.ELEM), ("RADIX", LZ.RADIX), ("DMASK", LZ.DMASK), ("HALF", LZ.HALF),
    ("BIAS", MB.BIAS),
])
def test_header_scalars(name, value):
    assert re.search(rf"constexpr int {name} = {value};", HEADER)


@pytest.mark.parametrize("kernel", [MM.KERNEL, MB.KERNEL], ids=["mont_mul", "bucket"])
def test_kernel_sources_export_their_entry(kernel):
    src = (KC.CSRC_DIR / kernel.source).read_text()
    assert re.search(rf'extern "C" int {kernel.symbol}\(', src)
    assert '#include "lazy13.cuh"' in src
    assert kernel.lib_path.parent == KC.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in KC.NVCC_FLAGS


def test_identity_rows_decode_to_identity():
    import torch

    rows = torch.from_numpy(MB.identity_rows())[:, None]
    x, y, z = MB.rows_to_coords(rows)
    assert LZ.digits_to_ints(x) == [0] and LZ.digits_to_ints(z) == [0]
    assert LZ.digits_to_ints(y) == [LZ.R13_MOD_P]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(KC.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    kernel = KC.CudaKernel("mont_mul.cu", "lz_mont_mul", [])
    if kernel.lib_path.exists():
        pytest.skip("the kernel library is already built here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()
    assert kernel.launches == 0
