"""The scan MSM's chains on the CPU: the complete RCB15 addition and
doubling of csrc/group381.cuh and the walks of csrc/scan_msm.cuh (scan-acc's
stream body, scan-red's window walk, scan-horner's walk), compiled for the
CPU with the host C++ compiler and undefined-behaviour checks, and the
chains' plain loops (`ops/scan_msm.py`) against the JAX package.

Strict values are canonical and both sides compute the same expressions,
so everything is held exactly (tolerance: none), limb for limb as
projective coordinates: `complete_add` and `complete_dbl` against
`curves/group.py` `G1.add` / `G1.double` and `G2.add` / `G2.double` on
random points with Z != 1, P + P, P + (-P), the identity on either side
and the identity doubled; the three walks on a G1 and a G2 instance of 64
points (Z != 1, an identity point and a zero scalar), 8 lanes, c = 4,
against `bucket_accumulate_plain`, `bucket_reduce_plain` and
`horner_plain`; those loops against JAX `curves/msm.py`
`_bucket_accumulate`, `_bucket_reduce` and `_horner` with `fuse=False`
digit for digit. The kernels themselves run only on the card
(tests/test_torch_cuda.py). Skipped where no host C++ compiler is
installed.
"""

import hashlib
import os
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_blst_tpu.curves import group as JG
from ark_blst_tpu.curves import msm as JM

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.curves import msm as M
from ark_blst_tpu_torch.curves.group import G1, G2
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import dispatch as D
from ark_blst_tpu_torch.ops import scan_msm as SM
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF

CURVES = {"g1": G1, "g2": G2}
N, LANES, C = 64, 8, 4  # the walks' instance: 8 steps a stream, W = 64, B = 16


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
#include "scan_msm.cuh"

// stdin: op, nc, n, a, b (int64 each), then the operands (int32); stdout:
// the result. Point stacks are (3 nc, 24, *batch) strict limbs, nc = 1
// (G1) or 2 (G2). Ops: 0 complete_add(p, q) on two (3 nc, 24, n) stacks;
// 1 complete_dbl(p); 2 scan-acc: points (3 nc, 24, n) and digits (a, n),
// lanes b, B = 16 -> (3 nc, 24, b, a, 16), the streams run last first;
// 3 scan-red: buckets (3 nc, 24, n, a) -> (3 nc, 24, n); 4 scan-horner:
// sums (3 nc, 24, n) at c = a -> (3 nc, 24, 1).
template <class F>
int run(long long op, long long n, long long a, long long b, const int* x, int* out) {
  constexpr int R = 3 * g381::NC<F>;
  const long long cs = smsm::LIMBS * n;
  if (op <= 1) {
    for (long long i = 0; i < n; ++i) {
      F X, Y, Z;
      smsm::read_point(x + i, n, cs, X, Y, Z);
      if (op == 0) {
        F X2, Y2, Z2;
        smsm::read_point(x + R * cs + i, n, cs, X2, Y2, Z2);
        g381::complete_add(X, Y, Z, X2, Y2, Z2);
      } else {
        g381::complete_dbl(X, Y, Z);
      }
      smsm::write_point(X, Y, Z, out + i, n, cs);
    }
  } else if (op == 2) {
    for (long long s = a * b - 1; s >= 0; --s)
      smsm::accumulate_stream<F>(x, x + R * cs, out, n, static_cast<int>(b),
                                 static_cast<int>(a), 16, static_cast<int>(s % b),
                                 static_cast<int>(s / b));
  } else if (op == 3) {
    for (long long w = 0; w < n; ++w)
      smsm::reduce_window<F>(x, out, static_cast<int>(n), static_cast<int>(a),
                             static_cast<int>(w));
  } else {
    smsm::horner_walk<F>(x, out, static_cast<int>(n), static_cast<int>(a));
  }
  return 0;
}

int main() {
  long long hdr[5];
  if (fread(hdr, sizeof(long long), 5, stdin) != 5) return 2;
  const long long op = hdr[0], nc = hdr[1], n = hdr[2], a = hdr[3], b = hdr[4];
  if (op < 0 || op > 4 || (nc != 1 && nc != 2) || n < 1) return 2;
  const long long pt = 3 * nc * 24;  // rows of a point stack
  const long long in_size = op == 0 ? 2 * pt * n : op == 2 ? (pt + a) * n : op == 3 ? pt * n * a
                                                                                    : pt * n;
  const long long out_size = op <= 1 ? pt * n : op == 2 ? pt * b * a * 16 : op == 3 ? pt * n : pt;
  std::vector<int> in(in_size), out(out_size, -1);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  if (nc == 1) run<f381::Fp>(op, n, a, b, in.data(), out.data());
  else run<f381::Fp2>(op, n, a, b, in.data(), out.data());
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
    for name in ("fp381.cuh", "group381.cuh", "lazy13.cuh", "tower381.cuh", "scan_msm.cuh"):
        h.update((KC.CSRC_DIR / name).read_bytes())
    out_dir = KC.BUILD_DIR.parent / "host"
    exe = out_dir / f"scan_msm_host-{h.hexdigest()[:12]}"
    if not exe.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / f"scan_msm_host.{os.getpid()}.cpp"
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(HARNESS)
        proc = subprocess.run(
            [cxx, "-std=c++17", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
             "-Wall", "-Wno-unknown-pragmas", "-I", str(KC.CSRC_DIR), "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=900)
        src.unlink()
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, exe)
    return str(exe)


def run(exe, op: int, curve, *stacks, n: int, a: int = 0, b: int = 0, shape) -> torch.Tensor:
    nc = 2 if curve.name == "g2" else 1
    hdr = np.array([op, nc, n, a, b], np.int64).tobytes()
    data = b"".join(np.ascontiguousarray(s.numpy(), np.int32).tobytes() for s in stacks)
    proc = subprocess.run([exe], input=hdr + data, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    return torch.from_numpy(np.frombuffer(proc.stdout, np.int32).reshape(shape).copy())


def affine_points(curve, rng, k: int) -> list:
    mul = OC.g2_mul if curve.name == "g2" else OC.scalar_mul
    gen = OF.G2_GEN if curve.name == "g2" else OF.G1_GEN
    return [mul(gen, rng.randrange(1, OF.R)) for _ in range(k)]


def to_dev(curve, pts):
    return (CV.g2_to_dev if curve.name == "g2" else CV.g1_to_dev)(pts)


def scaled(curve, pt, rng):
    """The same points in other projective coordinates: (X z : Y z : Z z)
    for a random z per point (the identity becomes (0 : z : 0))."""
    n = SM.stack_point(pt).shape[-1]
    z = CV.fp_to_dev([rng.randrange(1, OF.P) for _ in range(n)])
    if curve.name == "g1":
        return tuple(D.fp_mul(x, z) for x in pt)
    return tuple(tuple(D.fp_mul(x, z) for x in c) for c in pt)


def cat(a, b):
    return SM.point_of(torch.cat([SM.stack_point(a), SM.stack_point(b)], dim=-1))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_complete_add_and_dbl_host(harness, name):
    """complete_add and complete_dbl against G*.add / G*.double limb for
    limb: random pairs with Z != 1, P + P (the same coordinates and another
    representative), P + (-P), O + P, P + O, O + O, and the doubling of
    random points and of the identity."""
    curve = CURVES[name]
    rng = random.Random(7 if name == "g1" else 8)
    k = 4
    p = scaled(curve, to_dev(curve, affine_points(curve, rng, k)), rng)
    q = scaled(curve, to_dev(curve, affine_points(curve, rng, k)), rng)
    o = scaled(curve, to_dev(curve, [None] * k), rng)
    lhs = [p, p, p, p, o, p, o]
    rhs = [q, p, scaled(curve, p, rng), curve.neg(p), p, o, o]
    a, b = lhs[0], rhs[0]
    for x, y in zip(lhs[1:], rhs[1:]):
        a, b = cat(a, x), cat(b, y)
    n = SM.stack_point(a).shape[-1]
    shape = SM.stack_point(a).shape
    got = run(harness, 0, curve, SM.stack_point(a), SM.stack_point(b), n=n, shape=shape)
    assert torch.equal(got, SM.stack_point(curve.add(a, b)))
    d = cat(p, cat(o, curve.identity((k,), "cpu")))
    got = run(harness, 1, curve, SM.stack_point(d), n=3 * k, shape=SM.stack_point(d).shape)
    assert torch.equal(got, SM.stack_point(curve.double(d)))
    # the algebra is the group law: P + P = 2P, P + (-P) = O, O + P = P
    add = OC.g2_add if name == "g2" else OC.add
    dbl = OC.g2_double if name == "g2" else OC.double
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    ps, qs = from_dev(p), from_dev(q)
    want = ([add(x, y) for x, y in zip(ps, qs)] + [dbl(x) for x in ps] * 2 + [None] * k
            + ps + ps + [None] * k)
    assert from_dev(SM.point_of(run(harness, 0, curve, SM.stack_point(a), SM.stack_point(b),
                                     n=n, shape=shape))) == want


@pytest.fixture(scope="module")
def instances():
    """For each curve, 64 points in random projective coordinates (point 5
    the identity) with scalars (scalar 9 zero), and the plain loops' stages
    on them: the digits, the buckets, the fold across lanes, the window
    sums and the result."""
    out = {}
    for name, curve in CURVES.items():
        rng = random.Random(31 if name == "g1" else 32)
        base = affine_points(curve, rng, 8)
        pts = [base[i % 8] for i in range(N)]
        pts[5] = None
        scs = [rng.randrange(OF.R) for _ in range(N)]
        scs[9] = 0
        points = scaled(curve, to_dev(curve, pts), rng)
        digits = M.window_digits(CV.fr_to_dev(scs), C)
        buckets = SM.bucket_accumulate_plain(curve, points, digits, LANES, C)
        folded = M._fold_axis(curve, buckets, LANES)
        sums = SM.bucket_reduce_plain(curve, folded)
        result = SM.horner_plain(curve, sums, C)
        want = (OC.g2_msm if name == "g2" else OC.msm)(pts, scs)
        out[name] = dict(points=points, digits=digits, buckets=buckets, folded=folded,
                         sums=sums, result=result, want=want)
    return out


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_walks_host(harness, instances, name):
    """scan-acc's stream body (every stream, last first), scan-red's window
    walk and scan-horner's walk against the plain loops limb for limb, each
    on the plain loop's own input; the result is the MSM."""
    curve, inst = CURVES[name], instances[name]
    W = inst["digits"].shape[0]
    pts = SM.stack_point(inst["points"])
    got = run(harness, 2, curve, pts, inst["digits"], n=N, a=W, b=LANES,
              shape=(pts.shape[0], 24, LANES, W, 1 << C))
    assert torch.equal(got, SM.stack_point(inst["buckets"]))
    folded = SM.stack_point(inst["folded"])
    got = run(harness, 3, curve, folded, n=W, a=1 << C, shape=folded.shape[:3])
    assert torch.equal(got, SM.stack_point(inst["sums"]))
    sums = SM.stack_point(inst["sums"])
    got = run(harness, 4, curve, sums, n=W, a=C, shape=(sums.shape[0], 24, 1))
    assert torch.equal(got, SM.stack_point(inst["result"]))
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    assert from_dev(SM.point_of(got)) == [inst["want"]]


def _to_jax(tree):
    if isinstance(tree, tuple):
        return tuple(_to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy().astype(np.uint32))


def _jax_stack(tree) -> torch.Tensor:
    leaves = [x for c in tree for x in (c if isinstance(c, tuple) else (c,))]
    return torch.stack([torch.from_numpy(np.asarray(x).astype(np.int64)) for x in leaves])


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_plain_scans_match_jax(instances, name):
    """The plain loops against JAX `_bucket_accumulate`, `_bucket_reduce`
    and `_horner` (`fuse=False`, the eager branch of `_scan`) on the same
    G1 or G2 inputs, digit for digit, each on the port's previous stage."""
    inst, jcurve = instances[name], {"g1": JG.G1, "g2": JG.G2}[name]
    jb = JM._bucket_accumulate(jcurve, _to_jax(inst["points"]), _to_jax(inst["digits"]), LANES,
                               C, fuse=False)
    assert torch.equal(_jax_stack(jb), SM.stack_point(inst["buckets"]).long())
    js = JM._bucket_reduce(jcurve, _to_jax(inst["folded"]), fuse=False)
    assert torch.equal(_jax_stack(js), SM.stack_point(inst["sums"]).long())
    jr = JM._horner(jcurve, _to_jax(inst["sums"]), C, fuse=False)
    assert torch.equal(_jax_stack(jr), SM.stack_point(inst["result"]).long())
