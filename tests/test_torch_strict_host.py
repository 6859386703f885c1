"""The per-element code of K7-K10 (csrc/strict16.cuh) compiled for the CPU
with the host C++ compiler and undefined-behaviour checks, against the
kernels' plain PyTorch versions (ops/fieldops.py), bit for bit, for Fp and
Fr, on random canonical values, on the extreme values (0, 1, p-1, p-2, values
with all-ones low limbs below p) and on non-canonical limbs (up to
2^(16 L) - 1), where both sides drop the same carries.

The header compiles as plain C++ when __CUDACC__ is not defined; a small
harness runs `sf::field_elem` over a batch. Built with
`-fsanitize=undefined -fno-sanitize-recover`, so undefined behaviour in the
arithmetic aborts the harness and fails the test. (The kernels themselves
run only on the card: tests/test_torch_cuda.py.) Skipped where no host C++
compiler is installed.
"""

import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops.limbs import FP, FR, ints_to_limbs

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "strict16.cuh"

// stdin: op (0 mont_mul, 1 add, 2 sub, 3 neg), L, n (int64 each), then a
// and b as (L, n) int32; stdout: the result (L, n).
template <int L>
void run(long long op, long long n, const int* a, const int* b, int* out) {
  for (long long i = 0; i < n; ++i) {
    switch (op) {
      case 0: sf::field_elem<L, sf::MONT_MUL>(a, b, out, n, i); break;
      case 1: sf::field_elem<L, sf::ADD>(a, b, out, n, i); break;
      case 2: sf::field_elem<L, sf::SUB>(a, b, out, n, i); break;
      default: sf::field_elem<L, sf::NEG>(a, nullptr, out, n, i);
    }
  }
}

int main() {
  long long hdr[3];
  if (fread(hdr, sizeof(long long), 3, stdin) != 3) return 2;
  const long long op = hdr[0], L = hdr[1], n = hdr[2];
  if (op < 0 || op > 3 || (L != 24 && L != 16) || n < 1) return 2;
  std::vector<int> in(2 * L * n), out(L * n);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  if (L == 24) run<24>(op, n, in.data(), in.data() + L * n, out.data());
  else run<16>(op, n, in.data(), in.data() + L * n, out.data());
  fwrite(out.data(), sizeof(int), out.size(), stdout);
  return 0;
}
"""

OPS = ["mont_mul", "add", "sub", "neg"]


@pytest.fixture(scope="module")
def harness():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    h = hashlib.sha256(HARNESS.encode())
    h.update((KC.CSRC_DIR / "strict16.cuh").read_bytes())
    out_dir = KC.BUILD_DIR.parent / "host"
    exe = out_dir / f"strict_host-{h.hexdigest()[:12]}"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"strict_host.{os.getpid()}.cpp"
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(HARNESS)
        proc = subprocess.run(
            [cxx, "-std=c++17", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
             "-Wall", "-Wno-unknown-pragmas", "-I", str(KC.CSRC_DIR), "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=600)
        src.unlink()
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, exe)
    return str(exe)


def run(exe, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L, n = a.shape
    hdr = np.array([OPS.index(op), L, n], np.int64).tobytes()
    data = a.numpy().astype(np.int32).tobytes() + b.numpy().astype(np.int32).tobytes()
    proc = subprocess.run([exe], input=hdr + data, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).reshape(L, n).copy())


def operands(spec, seed: int, canonical: bool):
    """(L, n) limb stacks: the extreme values against each other, then
    random values below p (or, non-canonical, below R)."""
    p, L = spec.modulus, spec.num_limbs
    top = p if canonical else 1 << (16 * L)
    # p's high limbs less one over k low limbs of all ones: below p
    all_ones_low = [((p >> 16 * k) - 1 << 16 * k) | ((1 << 16 * k) - 1) for k in (1, 4, L // 2)]
    edge = [0, 1, p - 1, p - 2] + all_ones_low
    if not canonical:
        edge += [p, p + 1, top - 1, top - 2, 2 * p]
    rng = random.Random(seed)
    xs = [x for x in edge for _ in edge] + [rng.randrange(top) for _ in range(40)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(top) for _ in range(40)]
    def stack(vs):
        return torch.from_numpy(ints_to_limbs(vs, L).T.copy())
    return stack(xs), stack(ys)


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "any_limbs"])
@pytest.mark.parametrize("spec", [FP, FR], ids=["fp", "fr"])
@pytest.mark.parametrize("op", OPS)
def test_strict16_host_equals_plain(harness, op, spec, canonical):
    a, b = operands(spec, OPS.index(op), canonical)
    want = SF.PLAIN[op](a, spec) if op == "neg" else SF.PLAIN[op](a, b, spec)
    assert torch.equal(run(harness, op, a, b), want)
