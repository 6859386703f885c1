"""K1-inv's, K1-scan's and K7-inv's per-thread bodies (csrc/fp_inv.cuh)
compiled for the CPU with the host C++ compiler and undefined-behaviour
checks.

The inversion (the binary GCD of `finv::inverse`) is held against R13^2
X^-1 mod p (Python `pow`) on random digit stacks and on X = 0, 1, p-1 and
R mod p; the up and down
passes of one level of the blocked batch inversion against their plain
versions (`ops/fp_inv.py`) by value; and a whole blocked inversion at
8192 elements (one level of 64 rows, the ladder on the 128 column
products) built from the compiled bodies against the JAX package's exact
host inversion. Every output's digits are checked to be within 4096. The
strict engine's ladder (K7-inv, on strict limbs) is held against R^2 X^-1
mod p and limb for limb against its plain version (`fp_inv_limbs_plain`,
the strict engine's loop of products), values in [p, 2^384) reduced; the
binary GCD alone word for word against the Fermat ladder (`finv::fermat`)
and R^2 X^-1 mod p on random values, edge values, powers of 2 and small
values (its longest runs), its constants (INV_FIX, the batch and step
counts) pinned against Python ints. The kernels themselves run only on
the card (tests/test_torch_cuda.py).
Skipped where no host C++ compiler is installed.
"""

import hashlib
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import msm_pallas2 as JMP2
from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from ark_blst_tpu_torch.oracle import field as OF

P = OF.P
NW = 12
R13_SQ = LZ.R13_SQ

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "fp_inv.cuh"

// stdin: op, g, m, 0 (int64 each), then the operands (int32); stdout: the
// result. n = g m elements. Ops: 0 the ladder on (30, n) digits -> (30, n);
// 1 the up pass on z (30, n) -> pre (12, n) words, then total (30, m);
// 2 the down pass on z (30, n), pre (12, n), inv_total (30, m) -> (30, n);
// 3 the inversion on (24, n) strict limbs -> (24, n); 4 the binary GCD
// (`inverse`) and the Fermat ladder (`fermat`) on the words of (24, n)
// strict limbs (reduced on the load) -> (48, n), the GCD's limbs first.
int main() {
  long long hdr[4];
  if (fread(hdr, sizeof(long long), 4, stdin) != 4) return 2;
  const long long op = hdr[0], g = hdr[1], m = hdr[2], n = g * m;
  if (op < 0 || op > 4 || g < 1 || m < 1) return 2;
  const size_t in_size = op >= 3 ? 24 * n : op <= 1 ? 30 * n : 42 * n + 30 * m;
  const size_t out_size = op == 3 ? 24 * n : op == 4 ? 48 * n : op == 1 ? 12 * n + 30 * m
                                                                        : 30 * n;
  std::vector<int> in(in_size), out(out_size);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  const int* z = in.data();
  if (op == 0)
    for (long long i = 0; i < n; ++i) finv::inv_elem(z + i, out.data() + i, n);
  if (op == 3)
    for (long long i = 0; i < n; ++i)
      finv::inv_elem<t381::LIMB_ROWS>(z + i, out.data() + i, n);
  for (long long i = 0; op == 4 && i < n; ++i) {
    f381::Fp x, r;
    t381::read_row(z + i, n, t381::LIMB_ROWS, x);
    finv::inverse(x, r);
    t381::write_row(r, out.data() + i, n, t381::LIMB_ROWS);
    finv::fermat(x, r);
    t381::write_row(r, out.data() + 24 * n + i, n, t381::LIMB_ROWS);
  }
  auto* pre = reinterpret_cast<f381::u32*>(op == 1 ? out.data() : in.data() + 30 * n);
  for (long long j = 0; op == 1 && j < m; ++j)
    finv::scan_up_col(z, pre, out.data() + 12 * n, static_cast<int>(g), m, j);
  for (long long j = 0; op == 2 && j < m; ++j)
    finv::scan_down_col(z, pre, in.data() + 42 * n, out.data(), static_cast<int>(g), m, j);
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
    for name in ("fp381.cuh", "lazy13.cuh", "tower381.cuh", "fp_inv.cuh"):
        h.update((KC.CSRC_DIR / name).read_bytes())
    out_dir = KC.BUILD_DIR.parent / "host"
    exe = out_dir / f"fp_inv_host-{h.hexdigest()[:12]}"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"fp_inv_host.{os.getpid()}.cpp"
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


def run(exe, op: int, g: int, m: int, *stacks) -> torch.Tensor:
    hdr = np.array([op, g, m, 0], np.int64).tobytes()
    data = b"".join(np.ascontiguousarray(s.numpy(), np.int32).tobytes() for s in stacks)
    proc = subprocess.run([exe], input=hdr + data, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).copy())


def ladder(exe, x: torch.Tensor) -> torch.Tensor:
    return run(exe, 0, 1, x.shape[1], x).reshape(30, -1)


def scan_up(exe, z: torch.Tensor, g: int):
    n = z.shape[1]
    out = run(exe, 1, g, n // g, z)
    return out[:NW * n].reshape(NW, n), out[NW * n:].reshape(30, n // g)


def scan_down(exe, z, pre, inv_total, g: int) -> torch.Tensor:
    return run(exe, 2, g, z.shape[1] // g, z, pre, inv_total).reshape(30, -1)


def values(d: torch.Tensor) -> list:
    return [v % P for v in LZ.digits_to_ints(d)]


def inverse_value(x: int) -> int:
    """R13^2 X^-1 mod p, the Montgomery inverse of X = x R13 (0 for 0)."""
    return pow(x, -1, P) * R13_SQ % P if x % P else 0


def digit_stack(seed: int, n: int, bound: int = LZ.F_BOUND) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-bound, bound + 1, (30, n)).astype(np.int32))


def test_exponent_constant():
    text = (KC.CSRC_DIR / "fp_inv.cuh").read_text()
    m = re.search(r"__constant__ u32 P_MINUS_2\[NW\] = \{([^}]*)\};", text)
    words = [int(v, 16) for v in m.group(1).replace("\n", " ").split(",")]
    assert sum(w << (32 * j) for j, w in enumerate(words)) == P - 2
    top = int(re.search(r"constexpr int EXP_TOP = (\d+);", text).group(1))
    assert top == (P - 2).bit_length() - 1 == len(FI.P_MINUS_2_BITS) - 1
    assert sum(FI.P_MINUS_2_BITS[1:]) == 228


def _header_words(text: str, name: str) -> int:
    m = re.search(r"__constant__ u32 " + name + r"\[NW\] = \{([^}]*)\};", text)
    return sum(int(v, 16) << (32 * j) for j, v in enumerate(m.group(1).replace("\n", " ").split(",")))


def test_gcd_constants():
    """The binary GCD's counts and its final factor: 26 batches of 30 steps
    cover 2 len(p) - 1 = 761 steps; a batch's factors (|f| <= 2^30) fit a
    signed word; INV_FIX = R^3 2^((32 - 30) 26) mod p (each batch divides u
    and v by 2^32 and a and b by 2^30)."""
    text = (KC.CSRC_DIR / "fp_inv.cuh").read_text()
    steps = int(re.search(r"constexpr int GCD_STEPS = (\d+);", text).group(1))
    batches = int(re.search(r"constexpr int GCD_BATCHES = (\d+);", text).group(1))
    assert (steps, batches) == (30, 26)
    assert steps * batches >= 2 * P.bit_length() - 1 == 761
    assert steps <= 30  # |f| + |g| <= 2^steps within a signed 32-bit word
    assert _header_words(text, "INV_FIX") == pow(2, 3 * 384 + (32 - steps) * batches, P)


def gcd_values() -> list:
    """Random values, edge values, values in [p, 2^384), powers of 2 and
    small values (the binary GCD's longest runs: 2^380 takes all 761
    steps)."""
    rng = np.random.default_rng(5)
    r = (1 << 384) % P
    return ([0, 1, 2, 3, P - 1, P - 2, r, P, P + 1, (1 << 384) - 1, P + 2]
            + [1 << k for k in range(0, 381, 7)] + [1 << 380, (1 << 381) - 1, P >> 1]
            + list(range(4, 40)) + [int.from_bytes(rng.bytes(48), "little") % P
                                    for _ in range(64)])


def test_gcd_inverse_host(harness):
    """The binary GCD against R^2 X^-1 mod p and word for word against the
    Fermat ladder on the same loaded words."""
    vals = gcd_values()
    x = torch.from_numpy(ints_to_limbs(vals, 24).T.copy())
    got = run(harness, 4, 1, len(vals), x).reshape(48, -1)
    r = (1 << 384) % P
    want = [pow(v, -1, P) * r * r % P if v % P else 0 for v in vals]
    assert [int(v) for v in limbs_to_ints(got[:24].T.numpy())] == want
    assert torch.equal(got[:24], got[24:])


def test_fermat_ladder_host(harness):
    """Random mul-ready digits, random digits at the kernel's input bound
    (|d| <= 8191), and X = 0, 1, p-1, R mod p (canonical digits)."""
    x = torch.cat([digit_stack(1, 40), digit_stack(2, 20, 8191)], 1)
    for col, v in enumerate((0, 1, P - 1, (1 << 384) % P)):
        x[:, col] = torch.from_numpy(LZ.int_to_digits(v))
    got = ladder(harness, x.contiguous())
    assert int(got.abs().max()) <= 4096
    assert values(got) == [inverse_value(v) for v in values(x)]


def test_strict_fermat_ladder_host(harness):
    """K7-inv's body on strict limbs: 0, 1, p-1, R mod p, values in [p,
    2^384) that the load reduces (p, 2^384 - 1, p + 1) and random
    canonical values -> the canonical limbs of R^2 X^-1 mod p, limb for
    limb `fp_inv_limbs_plain` on the canonical inputs."""
    rng = np.random.default_rng(3)
    r = (1 << 384) % P
    vals = [0, 1, P - 1, r, P, (1 << 384) - 1, P + 1] + [
        int.from_bytes(rng.bytes(48), "little") % P for _ in range(25)]
    x = torch.from_numpy(ints_to_limbs(vals, 24).T.copy())
    got = run(harness, 3, 1, len(vals), x).reshape(24, -1)
    want = [pow(v, -1, P) * r * r % P if v % P else 0 for v in vals]
    assert [int(v) for v in limbs_to_ints(got.T.numpy())] == want
    canon = torch.from_numpy(ints_to_limbs([v % P for v in vals], 24).T.copy())
    assert torch.equal(got, FI.fp_inv_limbs_plain(canon))


@pytest.mark.parametrize("g,m", [(4, 8), (64, 3)])
def test_scan_up_down_host(harness, g, m):
    """The up pass's column products and the down pass's inverses by value
    against `scan_up_plain` / `scan_down_plain` on the same inputs (the
    prefix products are each version's own scratch)."""
    z = digit_stack(10 + g, g * m)
    pre, total = scan_up(harness, z, g)
    pre_plain, total_plain = FI.scan_up_plain(z, g)
    assert int(total.abs().max()) <= 4096
    assert values(total) == values(total_plain)
    inv_total = FI.fp_inv_plain(total_plain)
    got = scan_down(harness, z, pre, inv_total, g)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(FI.scan_down_plain(z, pre_plain, inv_total, g))
    assert values(got) == [inverse_value(v) for v in values(z)]


def test_blocked_inversion_host_matches_jax(harness):
    """n = 8192: the up pass over 64 rows, the ladder on the 128 column
    products, the down pass, all host-compiled, against the JAX package's
    exact host inversion (`_batch_inverse_host`) by value."""
    n, g = 8192, 64
    z = digit_stack(20, n)
    assert FI.block_rows(n) == g and FI.block_rows(n // g) is None
    pre, total = scan_up(harness, z, g)
    got = scan_down(harness, z, pre, ladder(harness, total), g)
    assert int(got.abs().max()) <= 4096
    want = JMP2._batch_inverse_host([jnp.asarray(z[k].numpy()) for k in range(30)])
    want = torch.from_numpy(np.stack([np.asarray(w) for w in want]).astype(np.int32))
    assert values(got) == values(want)
