"""The scan MSM's chains on the CPU: the complete RCB15 addition and
doubling of csrc/group381.cuh and the bodies of csrc/scan_msm.cuh (scan-acc's
three passes, its walk's team phases run job by job, in order and last
first; scan-red's window walk; scan-horner's walk), compiled for the CPU
with the host C++ compiler and undefined-behaviour checks, and the
chains' plain loops (`ops/scan_msm.py`) against the JAX package.

Strict values are canonical and both sides compute the same expressions,
so everything is held exactly (tolerance: none), limb for limb as
projective coordinates: `complete_add` and `complete_dbl` against
`curves/group.py` `G1.add` / `G1.double` and `G2.add` / `G2.double` on
random points with Z != 1, P + P, P + (-P), the identity on either side
and the identity doubled; scan-mul's team walk (the double-and-add
ladder, its phases' jobs in order and last first) against
`scalar_mul_plain` on G1 at 256 and 8 bits and on G2 at 32 and 8 (the
plain G2 ladder takes ~0.3 s a bit here), with scalars 0, 1, r - 1 and
2^256 - 1 and an identity base, and on G2 at 256 bits against the
oracle; the three walks on a G1 and a G2 instance of 64
points (Z != 1, an identity point and a zero scalar), 8 lanes, c = 4,
against `bucket_accumulate_plain`, `bucket_reduce_plain` and
`horner_plain` (scan-red's and scan-horner's team walks with their
phases' jobs in order and last first, scan-red's buckets through a column
of 1, 5 and 16 buckets); scan-red's walk at
B = 2 and 16, on a window of identities, of equal buckets (the running
sum doubles through the complete addition) and with a bucket 0 that is
not the identity, and scan-horner's at W = 1, c = 1 and on identity
window sums, each against its plain loop and the oracle; those loops
against JAX `curves/msm.py`
`_bucket_accumulate`, `_bucket_reduce` and `_horner` with `fuse=False`
digit for digit; scan-acc's passes, each against its plain version and
together against `bucket_accumulate_plain`, on G1 and G2 with random
digits at c = 4 and c = 8, every digit equal, every digit 0 and one step
a stream, limbs of numbers in [p, 2^384) and digits up to 2^16 (taken
mod 2^c). The kernels themselves run only on the card
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
from ark_blst_tpu_torch.ops.limbs import ints_to_limbs

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
#include <algorithm>
#include <cstdio>
#include <vector>
#include "scan_msm.cuh"

// The walks' team on the CPU: every job of a phase in turn, in order or
// last first (the jobs of a phase are independent); a phase spread over
// warps on the card is one more phase here.
struct HostTeam {
  bool reverse;
  template <class Job>
  void phase(int jobs, Job job) const {
    if (reverse)
      for (int j = jobs - 1; j >= 0; --j) job(j);
    else
      for (int j = 0; j < jobs; ++j) job(j);
  }
  template <class Job>
  void spread(int jobs, int, Job job) const {
    phase(jobs, job);
  }
};

// stdin: op, nc, n, a, b, c, rev (int64 each), then the operands (int32);
// stdout: the result. Point stacks are (3 nc, 24, *batch) strict limbs,
// nc = 1 (G1) or 2 (G2); records (*, 36 nc) words. Ops: 0
// complete_add(p, q) on two (3 nc, 24, n) stacks; 1 complete_dbl(p); 2
// scan-acc's three passes: points (3 nc, 24, n) and digits (a, n), lanes
// b, B = 2^c -> (3 nc, 24, b, a, B), the streams run last first; 3
// scan-red's team walk: buckets (3 nc, 24, n, a) -> (3 nc, 24, n), a
// column of b >= 1 buckets, the windows last first; 4
// scan-horner's team walk: sums (3 nc, 24, n) at c = a -> (3 nc, 24, 1)
// (c = a may exceed 16); 5 scan-acc's point words:
// (3 nc, 24, n) -> (n, 36 nc); 6 its walk: records (n, 36 nc) and digits
// (a, n), lanes b, B = 2^c -> (b a B, 36 nc); 7 its split: records
// (n, 36 nc) -> (3 nc, 24, n); 8 scan-mul's team walk: points (3 nc, 24,
// n) and scalars (16, n), num_bits a -> (3 nc, 24, n), the elements last
// first. rev runs each phase's jobs last first.
template <class F>
void words_pass(const int* pts, int* pw, long long n) {
  for (long long i = 0; i < n; ++i) smsm::point_to_words<F>(pts, pw, n, i);
}

template <class F>
void walk_pass(const HostTeam& team, const int* pw, const int* digs, int* bk, long long n,
               int lanes, int W, int B) {
  std::vector<f381::u32> sm(smsm::ACC_SLOTS<F> * f381::NW, 0xDEADBEEFu);
  const smsm::TeamMem m{sm.data(), 1};
  for (long long s = static_cast<long long>(lanes) * W - 1; s >= 0; --s) {
    const int l = static_cast<int>(s % lanes), w = static_cast<int>(s / lanes);
    int* base = smsm::stream_buckets<F>(bk, W, B, l, w);
    team.phase(B * smsm::PV<F>, [&](int j) { smsm::init_job<F>(base, j); });
    smsm::walk_stream<F>(team, m, pw, digs, bk, n, lanes, W, B, l, w);
  }
}

template <class F>
void split_pass(const HostTeam& team, const int* bk, int* out, long long E) {
  std::vector<f381::u32> sm(smsm::PW<F> * (smsm::SPLIT_ELEMS + 1), 0xDEADBEEFu);
  for (long long e0 = 0; e0 < E; e0 += smsm::SPLIT_ELEMS) {
    const int count = static_cast<int>(std::min<long long>(smsm::SPLIT_ELEMS, E - e0));
    team.phase(count * smsm::PV<F>, [&](int j) { smsm::split_load<F>(bk, sm.data(), e0, j); });
    team.phase(count, [&](int e) { smsm::split_store<F>(sm.data(), out, E, e0, e); });
  }
}

template <class F>
int run(long long op, long long n, long long a, long long b, long long c, const HostTeam& team,
        const int* x, int* out) {
  constexpr int R = 3 * g381::NC<F>;
  constexpr int PW = smsm::PW<F>;
  const long long cs = smsm::LIMBS * n;
  const int B = 1 << c;
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
    const long long E = a * b * B;
    std::vector<int> pw(n * PW, -1), bk(E * PW, -1);
    words_pass<F>(x, pw.data(), n);
    walk_pass<F>(team, pw.data(), x + R * cs, bk.data(), n, static_cast<int>(b),
                 static_cast<int>(a), B);
    split_pass<F>(team, bk.data(), out, E);
  } else if (op == 3) {
    // one team's slots and column, reused window after window (last first)
    const int column = static_cast<int>(b);
    std::vector<f381::u32> sm(smsm::RED_SLOTS<F> * f381::NW + static_cast<long long>(column) * PW,
                              0xDEADBEEFu);
    const smsm::TeamMem m{sm.data(), 1};
    for (long long w = n - 1; w >= 0; --w)
      smsm::reduce_team<F>(team, m, sm.data() + smsm::RED_SLOTS<F> * f381::NW, column, x, out,
                           static_cast<int>(n), static_cast<int>(a), static_cast<int>(w));
  } else if (op == 4) {
    std::vector<f381::u32> sm(smsm::HORNER_SLOTS<F> * f381::NW + n * PW, 0xDEADBEEFu);
    const smsm::TeamMem m{sm.data(), 1};
    smsm::horner_team<F>(team, m, sm.data() + smsm::HORNER_SLOTS<F> * f381::NW, x, out,
                         static_cast<int>(n), static_cast<int>(a));
  } else if (op == 5) {
    words_pass<F>(x, out, n);
  } else if (op == 6) {
    walk_pass<F>(team, x, x + n * PW, out, n, static_cast<int>(b), static_cast<int>(a), B);
  } else if (op == 8) {
    // one team's slots, reused element after element (last first)
    std::vector<f381::u32> sm(smsm::MUL_SLOTS<F> * f381::NW, 0xDEADBEEFu);
    const smsm::TeamMem m{sm.data(), 1};
    for (long long i = n - 1; i >= 0; --i)
      smsm::mul_team<F>(team, m, x, x + R * cs, out, n, i, static_cast<int>(a));
  } else {
    split_pass<F>(team, x, out, n);
  }
  return 0;
}

int main() {
  long long hdr[7];
  if (fread(hdr, sizeof(long long), 7, stdin) != 7) return 2;
  const long long op = hdr[0], nc = hdr[1], n = hdr[2], a = hdr[3], b = hdr[4], c = hdr[5];
  if (op < 0 || op > 8 || (nc != 1 && nc != 2) || n < 1 || c < 0 || c > 16 || b < 0 ||
      (op == 3 && b < 1) || (op == 8 && (a < 0 || a > 256)))
    return 2;
  const HostTeam team{hdr[6] != 0};
  const long long pt = 3 * nc * 24, rec = 3 * nc * 12;  // rows of a point stack, record words
  const long long B = 1LL << c;
  long long in_size = pt * n, out_size = pt * n;
  if (op == 0) in_size = 2 * pt * n;
  if (op == 2) in_size = (pt + a) * n, out_size = pt * b * a * B;
  if (op == 3) in_size = pt * n * a;
  if (op == 4) out_size = pt;
  if (op == 5) out_size = rec * n;
  if (op == 6) in_size = (rec + a) * n, out_size = rec * b * a * B;
  if (op == 7) in_size = rec * n;
  if (op == 8) in_size = (pt + 16) * n;
  std::vector<int> in(in_size), out(out_size, -1);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  if (nc == 1) run<f381::Fp>(op, n, a, b, c, team, in.data(), out.data());
  else run<f381::Fp2>(op, n, a, b, c, team, in.data(), out.data());
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


def run(exe, op: int, curve, *stacks, n: int, a: int = 0, b: int = 0, c: int = 0,
        rev: bool = False, shape) -> torch.Tensor:
    nc = 2 if curve.name == "g2" else 1
    hdr = np.array([op, nc, n, a, b, c, int(rev)], np.int64).tobytes()
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


# scan-mul's scalars: 0, 1, r - 1, 2^256 - 1 (every limb 0xFFFF: no
# reduction mod r), a random scalar on the identity base, a random one
MUL_SCALARS = (0, 1, OF.R - 1, (1 << 256) - 1, None, None)


def mul_instance(name: str, bits: int):
    """Points in random projective coordinates (point 4 the identity) and
    their scalars as (16, n) limbs, with the affine points and the ints."""
    curve = CURVES[name]
    rng = random.Random(f"mul-{name}-{bits}")
    pts = affine_points(curve, rng, len(MUL_SCALARS))
    pts[4] = None
    ks = [rng.randrange(1 << 256) if k is None else k for k in MUL_SCALARS]
    points = scaled(curve, to_dev(curve, pts), rng)
    return points, torch.from_numpy(ints_to_limbs(ks, 16).T.copy()), pts, ks


def mul_oracle(name: str, pts, ks, bits: int) -> list:
    """k P, k taken mod 2^bits, from the oracle."""
    mul = OC.g2_mul if name == "g2" else OC.scalar_mul
    return [None if p is None else mul(p, k % (1 << bits)) for p, k in zip(pts, ks)]


@pytest.mark.parametrize("name,bits", [("g1", 256), ("g1", 8), ("g2", 32), ("g2", 8)])
def test_scan_mul_walk_host(harness, name, bits):
    """scan-mul's team walk under the harness, its phases' jobs in order and
    last first, against `scalar_mul_plain` limb for limb and the oracle's
    k P mod 2^bits: the edge scalars, an identity base (point 4), points in
    random projective coordinates."""
    curve = CURVES[name]
    points, scalars, pts, ks = mul_instance(name, bits)
    plain = SM.stack_point(SM.scalar_mul_plain(curve, points, scalars, bits))
    stack = SM.stack_point(points)
    for rev in (False, True):
        got = run(harness, 8, curve, stack, scalars, n=len(ks), a=bits, rev=rev, shape=plain.shape)
        assert torch.equal(got, plain), rev
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    assert from_dev(SM.point_of(plain)) == mul_oracle(name, pts, ks, bits)


def test_scan_mul_walk_g2_full_ladder_host(harness):
    """scan-mul's G2 walk over all 256 bits against the oracle (the plain G2
    ladder would take over a minute here; the card holds the kernel to it
    limb for limb at 256 bits)."""
    points, scalars, pts, ks = mul_instance("g2", 256)
    stack = SM.stack_point(points)
    got = run(harness, 8, G2, stack, scalars, n=len(ks), a=256, shape=stack.shape)
    assert CV.g2_from_dev(SM.point_of(got)) == mul_oracle("g2", pts, ks, 256)


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
    """scan-acc's three passes (the walk's streams last first), scan-red's
    window walk and scan-horner's walk against the plain loops limb for
    limb, each on the plain loop's own input; the result is the MSM."""
    curve, inst = CURVES[name], instances[name]
    W = inst["digits"].shape[0]
    pts = SM.stack_point(inst["points"])
    got = run(harness, 2, curve, pts, inst["digits"], n=N, a=W, b=LANES, c=C,
              shape=(pts.shape[0], 24, LANES, W, 1 << C))
    assert torch.equal(got, SM.stack_point(inst["buckets"]))
    folded = SM.stack_point(inst["folded"])
    for column in (1, 5, 16):
        for rev in (False, True):
            got = run(harness, 3, curve, folded, n=W, a=1 << C, b=column, rev=rev,
                      shape=folded.shape[:3])
            assert torch.equal(got, SM.stack_point(inst["sums"])), (column, rev)
    sums = SM.stack_point(inst["sums"])
    for rev in (False, True):
        got = run(harness, 4, curve, sums, n=W, a=C, rev=rev, shape=(sums.shape[0], 24, 1))
        assert torch.equal(got, SM.stack_point(inst["result"]))
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    assert from_dev(SM.point_of(got)) == [inst["want"]]


# scan-red's cases: (windows, buckets a window, window 0's buckets):
# random, every bucket the identity, every bucket one point (the same
# coordinates), bucket 0 a point (dropped; the others random)
RED_CASES = {"b2": (3, 2, "random"), "b16": (2, 16, "random"),
             "identity_buckets": (2, 8, "identity"), "equal_buckets": (2, 8, "equal"),
             "bucket0_point": (2, 8, "random")}


def red_instance(curve, case: str):
    """(3 nc, 24, W, B) buckets in random projective coordinates, window 0
    the case's and the others random points (bucket 0 of window 0 the
    identity, as a zero digit leaves it, but in case `bucket0_point`); and
    the window sums sum_b b bucket[w, b] from the oracle."""
    W, B, kind = RED_CASES[case]
    rng = random.Random(f"red-{curve.name}-{case}")
    pts = affine_points(curve, rng, W * B)
    if kind == "identity":
        pts[:B] = [None] * B
    elif kind == "equal":
        pts[:B] = [pts[1]] * B
    if case != "bucket0_point":
        pts[0] = None
    stack = SM.stack_point(scaled(curve, to_dev(curve, pts), rng)).reshape(-1, 24, W, B)
    if kind == "equal":  # the same coordinates in every bucket of window 0
        stack[:, :, 0] = stack[:, :, 0, 1:2]
    mul = OC.g2_mul if curve.name == "g2" else OC.scalar_mul
    add = OC.g2_add if curve.name == "g2" else OC.add
    want = []
    for w in range(W):
        acc = None
        for b in range(1, B):
            acc = add(acc, mul(pts[w * B + b], b))
        want.append(acc)
    return stack.contiguous(), want


@pytest.mark.parametrize("case", list(RED_CASES))
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_red_cases_host(harness, name, case):
    """scan-red's team walk under the harness, its phases' jobs in order and
    last first, its buckets through columns of 1, 3 and 128 buckets,
    against `bucket_reduce_plain` limb for limb and the
    oracle's window sums: B = 2 and 16, a window of identities, a window
    of equal buckets (running = k P, doubled through the complete
    addition), a bucket 0 that is a point (dropped)."""
    curve = CURVES[name]
    stack, want = red_instance(curve, case)
    W, B = stack.shape[2:]
    plain = SM.stack_point(SM.bucket_reduce_plain(curve, SM.point_of(stack)))
    for column in (1, 3, 128):
        for rev in (False, True):
            got = run(harness, 3, curve, stack, n=W, a=B, b=column, rev=rev, shape=plain.shape)
            assert torch.equal(got, plain), (column, rev)
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    assert from_dev(SM.point_of(plain)) == want


# scan-horner's cases: (windows, c, identity windows)
HORNER_CASES = {"w1_c1": (1, 1, ()), "identity_sums": (4, 2, (3, 1)), "w3_c8": (3, 8, (0,))}


@pytest.mark.parametrize("case", list(HORNER_CASES))
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_horner_cases_host(harness, name, case):
    """scan-horner's team walk under the harness, its phases' jobs in order
    and last first, against `horner_plain` limb for limb and the oracle's
    sum_w sum[w] 2^(c w): one window at c = 1, window sums that are the
    identity (the first window's among them), c = 8."""
    curve = CURVES[name]
    W, c, zero = HORNER_CASES[case]
    rng = random.Random(f"horner-{name}-{case}")
    pts = affine_points(curve, rng, W)
    for w in zero:
        pts[w] = None
    sums = SM.stack_point(scaled(curve, to_dev(curve, pts), rng))
    plain = SM.stack_point(SM.horner_plain(curve, SM.point_of(sums), c))
    for rev in (False, True):
        got = run(harness, 4, curve, sums, n=W, a=c, rev=rev, shape=plain.shape)
        assert torch.equal(got, plain), rev
    mul = OC.g2_mul if name == "g2" else OC.scalar_mul
    add = OC.g2_add if name == "g2" else OC.add
    want = None
    for w, p in enumerate(pts):
        want = add(want, mul(p, 1 << (c * w)))
    from_dev = CV.g2_from_dev if name == "g2" else CV.g1_from_dev
    assert from_dev(SM.point_of(plain)) == [want]


# scan-acc's cases: (points, lanes, c, digits): random scalars' digits at
# c = 4 and c = 8, every digit equal (one bucket takes every point of a
# stream, in order), every digit 0, and one step a stream (n = lanes)
ACC_CASES = {"c4": (32, 8, 4, "random"), "c8": (32, 8, 8, "random"),
             "equal_digits": (32, 4, 4, "equal"), "zero_digits": (32, 4, 4, "zero"),
             "one_step": (8, 8, 8, "random")}


def acc_instance(curve, case: str):
    """Points in random projective coordinates (point 3 the identity) and
    the case's digits."""
    n, lanes, c, kind = ACC_CASES[case]
    rng = random.Random(f"{curve.name}-{case}")
    base = affine_points(curve, rng, 4)
    pts = [base[i % 4] for i in range(n)]
    pts[3] = None
    points = scaled(curve, to_dev(curve, pts), rng)
    W = -(-256 // c)
    if kind == "random":
        digits = M.window_digits(CV.fr_to_dev([rng.randrange(OF.R) for _ in range(n)]), c)
    else:
        digits = torch.full((W, n), 0 if kind == "zero" else (1 << c) - 3, dtype=torch.int32)
    return points, digits, lanes, c


@pytest.mark.parametrize("case", list(ACC_CASES))
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_acc_passes_host(harness, name, case):
    """scan-acc's three passes under the harness, the walk's phases job by
    job (in order and last first), against `bucket_accumulate_plain` limb
    for limb; and each pass alone (the point words, the walk's bucket
    records, the split) against its plain version on the same input."""
    curve = CURVES[name]
    points, digits, lanes, c = acc_instance(curve, case)
    n, W, B = digits.shape[1], digits.shape[0], 1 << c
    pts = SM.stack_point(points)
    want = SM.stack_point(SM.bucket_accumulate_plain(curve, points, digits, lanes, c))
    for rev in (False, True):
        got = run(harness, 2, curve, pts, digits, n=n, a=W, b=lanes, c=c, rev=rev,
                  shape=want.shape)
        assert torch.equal(got, want)
    rec = SM.RECORD * pts.shape[0] // 3
    pw = run(harness, 5, curve, pts, n=n, shape=(n, rec))
    assert torch.equal(pw, SM.point_words_plain(pts))
    bk = run(harness, 6, curve, pw, digits, n=n, a=W, b=lanes, c=c, shape=(lanes * W * B, rec))
    assert torch.equal(bk, SM.accumulate_words_plain(curve, pw, digits, lanes, c))
    out = run(harness, 7, curve, bk, n=lanes * W * B, rev=True, shape=(pts.shape[0], 24, bk.shape[0]))
    assert torch.equal(out.reshape(want.shape), SM.split_buckets_plain(bk, lanes, W, B))
    assert torch.equal(out.reshape(want.shape), want)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_acc_takes_limbs_and_digits_as_the_kernel_does_host(harness, name):
    """The point words reduce limbs of numbers in [p, 2^384) to their
    residues, and the walk takes digits mod 2^c (digits up to 2^16),
    against the plain versions."""
    curve = CURVES[name]
    rng = random.Random(61 if name == "g1" else 62)
    n, lanes, c = 16, 4, 4
    nc = 2 if name == "g2" else 1
    vals = [[rng.randrange(1 << 384) if k % 2 else rng.randrange(OF.P, 1 << 384)
             for k in range(n)] for _ in range(3 * nc)]
    pts = torch.tensor([[[(v >> (16 * j)) & 0xFFFF for v in row] for j in range(24)]
                        for row in vals], dtype=torch.int32)
    pw = run(harness, 5, curve, pts, n=n, shape=(n, SM.RECORD * nc))
    assert torch.equal(pw, SM.point_words_plain(pts))
    words = [[sum((int(pw[i, 12 * q + k]) & 0xFFFFFFFF) << (32 * k) for k in range(12))
              for i in range(n)] for q in range(3 * nc)]
    assert words == [[v % OF.P for v in row] for row in vals]
    points, _, _, _ = acc_instance(curve, "c4")
    pw = SM.point_words_plain(SM.stack_point(points))[:n]
    digits = torch.tensor([[rng.randrange(1 << 16) for _ in range(n)] for _ in range(64)],
                          dtype=torch.int32)
    bk = run(harness, 6, curve, pw, digits, n=n, a=64, b=lanes, c=c,
             shape=(lanes * 64 * 16, SM.RECORD * nc))
    assert torch.equal(bk, SM.accumulate_words_plain(curve, pw, digits, lanes, c))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scan_acc_plain_passes_compose(name):
    """The plain versions of scan-acc's passes, and the wrappers on CPU
    tensors, compose to `bucket_accumulate_plain`'s stack limb for limb."""
    curve = CURVES[name]
    points, digits, lanes, c = acc_instance(curve, "c4")
    W, B = digits.shape[0], 1 << c
    want = SM.stack_point(SM.bucket_accumulate_plain(curve, points, digits, lanes, c))
    pw = SM.point_words(SM.stack_point(points))
    bk = SM.accumulate_words(curve, pw, digits, lanes, c)
    assert bk.shape == (lanes * W * B, SM.RECORD * want.shape[0] // 3)
    assert torch.equal(SM.split_buckets(bk, lanes, W, B), want)
    assert torch.equal(SM.stack_point(SM.bucket_accumulate(curve, points, digits, lanes, c)),
                       want)


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
