"""The CUDA tower code of K3-K6 (csrc/tower13.cuh), compiled for the CPU with
the host C++ compiler and undefined-behaviour checks, against the kernels'
plain PyTorch versions, bit for bit.

The headers compile as plain C++ when __CUDACC__ is not defined; a small
harness runs each kernel's per-element body over a batch. Built with
`-fsanitize=undefined -fno-sanitize-recover`, so any signed int32 overflow
in the tower's arithmetic aborts the harness and fails the test. (The
kernels themselves run only on the card: tests/test_torch_cuda.py.)
Skipped where no host C++ compiler is installed.
"""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

N = 12
F = LZ.F_BOUND

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "tower13.cuh"

// stdin: op, n, param (int64 each), then the operand stacks (int32);
// stdout: the (12, 30, n) result.
int main() {
  long long hdr[3];
  if (fread(hdr, sizeof(long long), 3, stdin) != 3) return 2;
  const long long op = hdr[0], n = hdr[1], param = hdr[2];
  static const int in_rows[] = {12, 24, 6, 10, 20};
  if (op < 0 || op > 4) return 2;
  const long long plane = 30 * n;
  std::vector<int> in(in_rows[op] * plane), out(12 * plane);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  const int* x = in.data();
  for (long long i = 0; i < n; ++i) {
    switch (op) {
      case 0: tw::cyc_sqr_elem(x, out.data(), n, i, static_cast<int>(param)); break;
      case 1: tw::fp12_mul_elem(x, x + 12 * plane, out.data(), n, i); break;
      case 2: tw::prepare_step_elem(x, nullptr, out.data(), n, i, 0); break;
      case 3: tw::prepare_step_elem(x, x + 6 * plane, out.data(), n, i, 1); break;
      default:
        tw::miller_step_elem(x, x + 12 * plane, x + 18 * plane, out.data(), n, i,
                             static_cast<int>(param));
    }
  }
  fwrite(out.data(), sizeof(int), out.size(), stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    h = hashlib.sha256(HARNESS.encode())
    for name in ("lazy13.cuh", "tower13.cuh"):
        h.update((KC.CSRC_DIR / name).read_bytes())
    out_dir = KC.BUILD_DIR.parent / "host"
    exe = out_dir / f"tower_host-{h.hexdigest()[:12]}"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"tower_host.{os.getpid()}.cpp"
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


def run(exe, op, param, *stacks):
    n = stacks[0].shape[-1]
    data = b"".join(s.contiguous().numpy().astype(np.int32).tobytes() for s in stacks)
    proc = subprocess.run([exe], input=np.array([op, n, param], np.int64).tobytes() + data,
                          capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).reshape(12, 30, n).copy())


def digit_stacks(seed, *rows):
    """Random mul-ready stacks with the extreme patterns in the first
    columns: +-F_BOUND, canonical maxima, alternating signs, the R13/2
    edge."""
    rng = np.random.default_rng(seed)
    edge = [int(v) for v in LZ.int_to_digits((LZ.R13 >> 1) - 1)]
    out = []
    for r in rows:
        a = rng.integers(-F, F + 1, (r, 30, N)).astype(np.int32)
        a[:, :, 0], a[:, :, 1], a[:, :, 2] = F, -F, 8191
        a[:, :, 3] = [F if k % 2 else -F for k in range(30)]
        a[:, :, 4] = edge
        out.append(torch.from_numpy(a))
    return out


def real_inputs():
    """Event operands as the pipeline gives them (P, Q ingested, R after
    two doublings, f after two Miller events)."""
    rng = np.random.default_rng(5)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(2 * N)]
    ps = [OC.scalar_mul(OF.G1_GEN, k) for k in ks[:N]]
    qs = [OC.g2_mul(OF.G2_GEN, k) for k in ks[N:]]
    p = (CV.fp_to_dev([x[0] for x in ps]), CV.fp_to_dev([x[1] for x in ps]))
    q = (CV.fp2_to_dev([x[0] for x in qs]), CV.fp2_to_dev([x[1] for x in qs]))
    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    one, zero = PR._fp2_one_zero_like(qx)
    rs = torch.stack([qx[0], qx[1], qy[0], qy[1], one, zero])
    for _ in range(2):
        rs = PS.prepare_step(rs)[:6]
    coeffs = PR.prepare_g2(q, events=3)
    pxy = torch.stack([TL.fp_ingest(p[0]), TL.fp_ingest(p[1])])
    fs = TL.stack12(PR._fp12_one_like(pxy[0]))
    for i in range(2):
        fs = PS.miller_step(fs, coeffs[i], pxy, True)
    return rs, torch.stack([qx[0], qx[1], qy[0], qy[1]]), fs, coeffs[2], pxy


@pytest.mark.parametrize("nsq", [1, max(r for r, _ in PR._X_SEGMENTS)])
def test_cyc_sqr_host(harness, nsq):
    (x,) = digit_stacks(1, 12)
    assert torch.equal(run(harness, 0, nsq, x), K3.cyc_sqr_plain(x, nsq))


def test_fp12_mul_host(harness):
    a, b = digit_stacks(2, 12, 12)
    assert torch.equal(run(harness, 1, 0, a, b), K4.fp12_mul_plain(a, b))


@pytest.mark.parametrize("source", ["random", "pipeline"])
@pytest.mark.parametrize("is_add", [False, True])
def test_prepare_step_host(harness, is_add, source):
    r, q = digit_stacks(3, 6, 4) if source == "random" else real_inputs()[:2]
    if is_add:
        assert torch.equal(run(harness, 3, 0, r, q), PS.prepare_step_plain(r, q))
    else:
        assert torch.equal(run(harness, 2, 0, r), PS.prepare_step_plain(r))


@pytest.mark.parametrize("source", ["random", "pipeline"])
@pytest.mark.parametrize("with_sqr", [False, True])
def test_miller_step_host(harness, with_sqr, source):
    f, c, pxy = digit_stacks(4, 12, 6, 2) if source == "random" else real_inputs()[2:]
    got = run(harness, 4, int(with_sqr), f, c, pxy)
    assert torch.equal(got, PS.miller_step_plain(f, c, pxy, with_sqr))
