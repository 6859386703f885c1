"""The 32-bit Montgomery field layer (csrc/fp381.cuh) and the bucket
kernels' body (csrc/group381.cuh, K2 over Fp and K2-G2 over Fp2) compiled
for the CPU with the host C++ compiler and undefined-behaviour checks.

The field operations are held against Python ints on random values and on
the edges 0, 1, p-1 and R mod p; the header's constants against their
definitions; the conversion of a bucket component into the dump's packed
radix-13 digits by value and digit bound; for each curve, the points'
conversion to words against the plain version, the bucket body at the
curve's MSM window (G1 c = 7, G2 c = 5) on one window against the plain
version (`MB.accumulate_plain`) by value, and a small MSM whose dump
comes from the compiled body, reduced and finished by the unchanged Python
stages, against the oracle. The kernel itself runs
only on the card (tests/test_torch_cuda.py). Skipped where no host C++
compiler is installed.
"""

import hashlib
import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.curves.instance import distinct_bases
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

P = OF.P
R = 1 << 384
NW = 12
KCS = {"g1": MB.KC2_G1, "g2": MB.KC2_G2}


@pytest.fixture(autouse=True, scope="module")
def _share_cpu_among_workers():
    """Split the torch threads among the pytest-xdist workers while the
    module runs (one thread per core in every worker oversubscribes the
    machine)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


HARNESS = r"""
#include <cstdio>
#include <vector>
#include "group381.cuh"

// stdin: op, n, p1, p2 (int64 each), then the operands (int32 words);
// stdout: the result. Elements are (12, n) word stacks, Fp2 values
// (2, 12, n). Ops: 0 mont_mul(a, b), 1 add(a, b), 2 sub(a, b), 3 neg(a),
// 4 3a, 5 12a, 6 Fp2 mul(a, b), 7 mul_b3(a) on Fp2, 8 store_r13(a) ->
// (15, n) packed rows; 9 and 11 the G2 and G1 bucket accumulation of
// W = p1 windows, B = p2 buckets, S = 1024 streams: point words (48 or 24,
// n), digits (W, n), result the dump (W, B, 90 or 45, S); 10 rows_to_words
// on (15, n) packed rows -> (12, n) words.
using f381::Fp;
using f381::Fp2;

void get(const int* x, long long n, long long i, Fp& a) { g381::load(x + i, n, a); }
void get(const int* x, long long n, long long i, Fp2& a) { g381::load(x + i, n, a); }

int main() {
  long long hdr[4];
  if (fread(hdr, sizeof(long long), 4, stdin) != 4) return 2;
  const long long op = hdr[0], n = hdr[1], W = hdr[2], B = hdr[3], S = 1024;
  if (op < 0 || op > 11 || n < 1) return 2;
  static const int in_rows[] = {24, 24, 24, 12, 12, 12, 48, 24, 12, 0, 15, 0};
  static const int out_rows[] = {12, 12, 12, 12, 12, 12, 24, 24, 15, 0, 12, 0};
  const bool bucket = op == 9 || op == 11;
  const long long wrows = op == 9 ? 48 : 24, prows = op == 9 ? 90 : 45;
  const size_t in_size = bucket ? (wrows + W) * n : in_rows[op] * n;
  const size_t out_size = bucket ? W * B * prows * S : out_rows[op] * n;
  std::vector<int> in(in_size), out(out_size);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  const int* x = in.data();
  for (int w = 0; bucket && w < W; ++w)
    for (int s = 0; s < S; ++s) {
      if (op == 9)
        g381::accumulate_stream<Fp2>(x, x + wrows * n, out.data(), n, static_cast<int>(B),
                                     static_cast<int>(S), w, s);
      else
        g381::accumulate_stream<Fp>(x, x + wrows * n, out.data(), n, static_cast<int>(B),
                                    static_cast<int>(S), w, s);
    }
  for (long long i = 0; op == 10 && i < n; ++i) g381::rows_to_words(x + i, n, out.data() + i, n);
  for (long long i = 0; op < 9 && i < n; ++i) {
    int* o = out.data() + i;
    if (op == 6 || op == 7) {
      Fp2 a, b, r;
      get(x, n, i, a);
      if (op == 6) {
        get(x + 24 * n, n, i, b);
        f381::mul(a, b, r);
      } else {
        f381::mul_b3(a, r);
      }
      g381::store(r, o, n);
      continue;
    }
    Fp a, b, r;
    get(x, n, i, a);
    if (op <= 2) get(x + 12 * n, n, i, b);
    switch (op) {
      case 0: f381::mont_mul(a, b, r); break;
      case 1: f381::add(a, b, r); break;
      case 2: f381::sub(a, b, r); break;
      case 3: f381::neg(a, r); break;
      case 4: f381::mul_small<3>(a, r); break;
      case 5: f381::mul_small<12>(a, r); break;
      default: g381::store_r13(a, o, n); continue;
    }
    g381::store(r, o, n);
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
    for name in ("fp381.cuh", "group381.cuh", "lazy13.cuh"):
        h.update((KC.CSRC_DIR / name).read_bytes())
    out_dir = KC.BUILD_DIR.parent / "host"
    exe = out_dir / f"fp381_host-{h.hexdigest()[:12]}"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"fp381_host.{os.getpid()}.cpp"
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


def run(exe, op: int, *stacks, shape, windows=0, buckets=0) -> torch.Tensor:
    n = stacks[0].shape[-1]
    hdr = np.array([op, n, windows, buckets], np.int64).tobytes()
    data = b"".join(np.ascontiguousarray(s.numpy(), np.int32).tobytes() for s in stacks)
    proc = subprocess.run([exe], input=hdr + data, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).reshape(shape).copy())


def words(vals) -> torch.Tensor:
    """ints in [0, 2^384) -> (12, n) int32 words, little-endian."""
    arr = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for v in vals] for j in range(NW)], np.uint32)
    return torch.from_numpy(arr.view(np.int32))


def ints(w: torch.Tensor) -> list:
    """(12, n) int32 words -> ints."""
    arr = w.numpy().view(np.uint32).astype(object)
    return [sum(int(arr[j, i]) << (32 * j) for j in range(NW)) for i in range(w.shape[1])]


EDGES = [0, 1, P - 1, R % P]


def pairs(seed: int):
    """Every pair of edges, then random pairs below p."""
    rng = random.Random(seed)
    xs = [x for x in EDGES for _ in EDGES] + [rng.randrange(P) for _ in range(48)]
    ys = [y for _ in EDGES for y in EDGES] + [rng.randrange(P) for _ in range(48)]
    return xs, ys


RINV = pow(R, -1, P)
FP_OPS = {
    0: lambda a, b: a * b * RINV % P,
    1: lambda a, b: (a + b) % P,
    2: lambda a, b: (a - b) % P,
    3: lambda a, b: -a % P,
    4: lambda a, b: 3 * a % P,
    5: lambda a, b: 12 * a % P,
}


@pytest.mark.parametrize("op", sorted(FP_OPS), ids=["mont_mul", "add", "sub", "neg", "mul3",
                                                    "mul12"])
def test_fp_ops_host(harness, op):
    xs, ys = pairs(op)
    got = run(harness, op, words(xs), words(ys), shape=(NW, len(xs)))
    assert ints(got) == [FP_OPS[op](a, b) for a, b in zip(xs, ys)]


def _fp2_stack(vals) -> torch.Tensor:
    return torch.cat([words([v[0] for v in vals]), words([v[1] for v in vals])])


def test_fp2_mul_host(harness):
    """The Karatsuba product (Montgomery: a b / R) and mul_b3 (12 (1 + u) a)
    against the oracle's Fp2 arithmetic."""
    xs, ys = pairs(11)
    a = [(x, y) for x, y in zip(xs, reversed(xs))]
    b = [(y, x) for x, y in zip(ys, reversed(ys))]
    got = run(harness, 6, _fp2_stack(a), _fp2_stack(b), shape=(2 * NW, len(a)))
    want = [OF.fp2_mul(OF.fp2_mul(u, v), (RINV, 0)) for u, v in zip(a, b)]
    assert list(zip(ints(got[:NW]), ints(got[NW:]))) == want
    got = run(harness, 7, _fp2_stack(a), shape=(2 * NW, len(a)))
    assert list(zip(ints(got[:NW]), ints(got[NW:]))) == [OF.fp2_mul(u, (12, 12)) for u in a]


def _header_words(name: str) -> list:
    text = (KC.CSRC_DIR / "fp381.cuh").read_text()
    m = re.search(rf"__constant__ u32 {name}\[NW\] = \{{([^}}]*)\}};", text)
    assert m, f"{name} not found in fp381.cuh"
    return [int(v, 16) for v in m.group(1).replace("\n", " ").split(",")]


_BIAS_SUM = MB.BIAS * sum(1 << (13 * k) for k in range(30))


@pytest.mark.parametrize("name,value", [
    ("P", P), ("R_MOD_P", R % P), ("R390_MOD_P", (1 << 390) % P),
    ("R378_MOD_P", (1 << 378) % P), ("DIGIT_BIAS_FIX", 318 * P - _BIAS_SUM),
])
def test_header_constants(name, value):
    assert _header_words(name) == [(value >> (32 * j)) & 0xFFFFFFFF for j in range(NW)]
    if name == "DIGIT_BIAS_FIX":  # the least multiple of p above the bias sum
        assert 0 <= value < P and (value + 8257 * (_BIAS_SUM // MB.BIAS)) >> 11 < P
    if name == "P":
        text = (KC.CSRC_DIR / "fp381.cuh").read_text()
        ninv = int(re.search(r"constexpr u32 NINV = (0x[0-9a-f]+);", text).group(1), 16)
        assert ninv == -pow(P, -1, 1 << 32) % (1 << 32)
        assert P >> 352 < (1 << 31) - 1  # CIOS without the extra carry word


def test_dump_conversion_host(harness):
    """store_r13: a canonical R16 value x R -> 15 packed rows of balanced
    radix-13 digits (|d| <= 4096) of x R13 mod p."""
    xs, _ = pairs(12)
    xs += [P - 2, (1 << 381) % P, P >> 1]
    got = run(harness, 8, words(xs), shape=(15, len(xs)))
    digits = MB.unpack15(got)
    assert int(digits.abs().max()) <= 4096
    assert LZ.digits_to_ints(digits) == [x * (1 << 6) % P for x in xs]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_conversion_host(harness, curve):
    """rows_to_words (the bucket kernels' first step): 15 packed rows of
    lazy digits -> the canonical R16 words of their value, against host ints
    and against the plain version (`MB.point_words_plain`, stacked as the
    curve's two or four components), on random digits in the whole packed
    range [-4129, 4128], the extremes of that range, and the edge values 0,
    1, p-1 and R13 mod p (balanced, as stored)."""
    rng = np.random.default_rng(13)
    d = rng.integers(-4129, 4129, (30, 64)).astype(np.int32)
    d[:, 0], d[:, 1] = 4128, -4129
    d[:, 2] = [4128 if k % 2 else -4129 for k in range(30)]
    for col, v in enumerate((0, 1, P - 1, LZ.R13_MOD_P), start=3):
        d[:, col] = MB.int_to_digits_balanced(v)
    rows = MB.pack30(torch.from_numpy(d))
    got = run(harness, 10, rows, shape=(NW, d.shape[1]))
    vals = LZ.digits_to_ints(torch.from_numpy(d))
    assert ints(got) == [v * pow(2, -6, P) % P for v in vals]
    kc = KCS[curve]
    comps = kc.word_rows // NW
    stacked = torch.cat([rows] * comps)
    assert torch.equal(torch.cat([got] * comps), MB.point_words_plain(kc, stacked))


def _dump(harness, kc, pts, digs, c):
    W = digs.shape[0]
    B = MB._num_buckets(c)
    return run(harness, 9 if kc.is_g2 else 11, MB.point_words_plain(kc, pts), digs, windows=W,
               buckets=B, shape=(W, B, kc.pt_rows, MB.STREAMS))


@pytest.mark.parametrize("curve,c", [("g1", 7), ("g2", 5)], ids=["g1-c7", "g2-c5"])
def test_bucket_accumulate_main_c_host(harness, curve, c):
    """The per-thread body at the curve's MSM window (G1 c = 7, G2 c = 5) on
    one window of real digits (the fourth), four tiles: tile 1 repeats tile
    0 (a doubling through the addition), tile 2 repeats it negated (the
    bucket falls back), tile 3 is the instance's second tile. Value-equal to
    the plain version, bucket for bucket; digits within 4096."""
    kc = KCS[curve]
    points, scalars, _ = distinct_bases(11, 4, "cpu", curve)
    pts, digs = MB._prepare_inputs(kc, points, scalars, c)
    t0, t1 = pts[:, :MB.STREAMS], pts[:, MB.STREAMS:]
    d0, d1 = digs[3:4, :MB.STREAMS], digs[3:4, MB.STREAMS:]
    neg = d0 ^ torch.where((d0 & MB.MAG_MASK) != 0, 1 << MB.SIGN_BIT, 0).to(torch.int32)
    pts = torch.cat([t0, t0, t0, t1], 1).contiguous()
    digs = torch.cat([d0, d0, neg, d1], 1).contiguous()
    got = _dump(harness, kc, pts, digs, c)
    assert MB.max_dump_digit(got) <= 4096
    want = MB.accumulate_plain(kc, pts, digs, c)
    assert torch.equal(MB.dump_values(kc, got), MB.dump_values(kc, want))


# curve: (c, windows filled, generator, scalar multiple, codecs, oracle MSM)
MSM_CASES = {
    "g1": (7, 4, OF.G1_GEN, OC.scalar_mul, CV.g1_to_dev, CV.g1_from_dev, OC.msm),
    "g2": (5, 8, OF.G2_GEN, OC.g2_mul, CV.g2_to_dev, CV.g2_from_dev, OC.g2_msm),
}


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_from_host_dump(harness, curve):
    """The MSM slice with the compiled body in the kernel's place: prepare,
    the host-compiled K2 or K2-G2 dump, the unchanged `_reduce_dump` and
    `_finish_host`, against the oracle's MSM. 2048 points over 8 bases, an
    identity point and a zero scalar, at the curve's window (G1 c = 7, G2
    c = 5); scalars below 2^(c windows - 1) fill the first windows (G1 4 of
    37, G2 8 of 52), the others hold only zero digits and are left out of
    the dump."""
    kc = KCS[curve]
    c, windows, gen, smul, to_dev, from_dev, msm = MSM_CASES[curve]
    n = 2048
    rng = random.Random(31)
    base = [smul(gen, rng.randrange(1, OF.R)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    scs = [rng.randrange(1 << (c * windows - 1)) for _ in range(n)]
    pts[10], scs[11] = None, 0
    agg = [0] * 8
    for i, s in enumerate(scs):
        if pts[i] is not None:
            agg[i % 8] += s
    rows, digs = MB._prepare_inputs(kc, to_dev(pts), CV.fr_to_dev(scs), c)
    assert not digs[windows:].any()
    dump = _dump(harness, kc, rows, digs[:windows].contiguous(), c)
    out = MB._finish_host(kc, MB._reduce_dump(kc, dump), c)
    assert from_dev(out) == [msm(base, agg)]
