"""Build the port's CUDA C++ kernels with nvcc and bind them through ctypes.

Each kernel is one `csrc/*.cu` file with a plain C entry point that launches
on the given stream and returns `cudaGetLastError()`. It is compiled for
sm_90a at first use into `build/kernels/` beside the package (a directory
git ignores), under a name that hashes the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library. The nvcc/ptxas output of
each build is kept beside its library (`.log`), so a process that reuses the
library still reads its registers, stack and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


class CudaKernel:
    """One kernel: its source, its C entry point, its shared library and the
    number of times its wrapper launched it (`launches`)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""  # nvcc/ptxas output of the library's build, once built
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / self.source]:
            h.update(f.read_bytes())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:12]}.so"

    @property
    def log_path(self) -> Path:
        return self.lib_path.with_suffix(".log")

    def start_build(self):
        """Start nvcc for this kernel unless its library and build log exist
        (then read the log); returns the process (or None) for
        `finish_build`."""
        if self.lib_path.exists() and self.log_path.exists():
            self.build_log = self.log_path.read_text()
            return None
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, self.log_path)
        os.replace(tmp, self.lib_path)

    def build(self) -> None:
        self.finish_build(self.start_build())

    def _entry(self):
        with self._lock:
            if self._fn is None:
                self.build()
                lib = ctypes.CDLL(str(self.lib_path))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                lib.ark_error_string.argtypes = [ctypes.c_int]
                lib.ark_error_string.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch reported an error."""
        err = self._entry()(*args)
        if err != 0:
            msg = self._lib.ark_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def build_all(kernels) -> list:
    """Build several kernels at once: one nvcc per source, all started
    together (kernels whose entry points share a source share its build).
    Returns the kernels that own a build, one per source."""
    owners = list({k.lib_path: k for k in kernels}.values())
    procs = [(k, k.start_build()) for k in owners]
    errors = []
    for k, proc in procs:  # wait for every nvcc before raising
        try:
            k.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return owners


def cpu_operands(name: str, tensors) -> bool:
    """Check a kernel's int32 operands: all on one device. Returns True for
    CPU tensors (the caller runs the plain version) and False for
    contiguous CUDA tensors (the caller launches the kernel); raises for
    anything else, so nothing falls back."""
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError(f"{name} wants int32 digits")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} operands on {[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} wants contiguous operands")
    return False


def stacked_operands(name: str, tensors, rows, width: int = 30) -> bool:
    """Check the operands of a tower kernel: each a `(rows[i], width, N)`
    int32 stack (30 digits a component, or 12 canonical words), N the same
    for all, all on one device (`cpu_operands`: True for CPU tensors, False
    for contiguous CUDA tensors, raises otherwise). The digits are not
    checked: the kernels take |digit| <= 8191 (mul-ready or canonical),
    which every value of the lazy tower satisfies (csrc/tower381.cuh)."""
    n = tensors[0].shape[-1]
    for t, r in zip(tensors, rows):
        if t.dim() != 3 or tuple(t.shape) != (r, width, n):
            raise ValueError(f"{name} wants {[(r, width, 'N') for r in rows]} stacks, "
                             f"got {[tuple(x.shape) for x in tensors]}")
    return cpu_operands(name, tensors)
