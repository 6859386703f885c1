"""The CUDA code of K2-K6, K11, K12, FE-easy and FE-hard compiled for the
CPU with the host C++ compiler and undefined-behaviour checks, against
the kernels' plain PyTorch versions: K3, K4, K5, K6, K11 and K12 on the
32-bit tower (csrc/tower381.cuh; K4 also on the multi-pairings' word
edges) and the G1 and G2 bucket additions
(csrc/group381.cuh, K2 and K2-G2), all on 32-bit Montgomery words, by
value; K3, K4, K11 and K12 also against the oracle; K5 and K6 also as
the chains the pipeline launches (all 68 events of the prepare and of the
Miller loop in one block program) against their plain versions and the
oracle, also on the fused pipeline's and the strict engine's edges
(strict Q and P in; the lines as words or strict limbs; f as digits,
conj(f) as words or strict limbs); the fused final exponentiation's two
chain programs (csrc/final_exp.cuh: FE-easy, and FE-hard walking
`HARD_PROGRAM`) on real Miller outputs against the oracle's easy part and
final_exp, FE-easy also loading words or strict limbs, and the Frobenius
maps' constants on random elements against the oracle.

The headers compile as plain C++ when __CUDACC__ is not defined; a small
harness runs each bucket kernel's per-thread body over a batch, or, for
the tower kernels, one block's phases in order, job by job, as the card's
threads run them between their barriers. Built with
`-fsanitize=undefined -fno-sanitize-recover`, so any signed int32 overflow
in the arithmetic aborts the harness and fails the test. (The kernels
themselves run only on the card: tests/test_torch_cuda.py.) Skipped where
no host C++ compiler is installed.
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
from ark_blst_tpu_torch.curves import lazy_group as LG
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.curves import pairing as PR
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.curves.instance import distinct_bases
from ark_blst_tpu_torch.ops import convert as CV
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
from ark_blst_tpu_torch.ops import fp12_sqr as K11
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import tower_lazy as TL
from ark_blst_tpu_torch.ops import words as W
from ark_blst_tpu_torch.ops.limbs import ints_to_limbs
from ark_blst_tpu_torch.oracle import curve as OC
from ark_blst_tpu_torch.oracle import field as OF
from ark_blst_tpu_torch.oracle import pairing as OP

N = 12
F = LZ.F_BOUND

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "final_exp.cuh"
#include "group381.cuh"
#include "tower381.cuh"

// stdin: op, n, p1, p2 (int64 each), then the operand stacks (int32);
// stdout: the result. Ops 0-4: the tower kernels on tower381.cuh, K3
// (op 0, p1 squares), K4 (op 1), K5 (op 2 the doubling, op 3 the addition)
// and K6 (op 4, p1 with the square), K5 and K6 as chains of one event,
// result (12, 30, n), in blocks of |p2| elements, each phase's jobs in
// reverse order when p2 < 0. Ops 13/14: the chains of p1 events, in
// blocks as ops 0-4, the schedule (p1 int32 flags, 1 a doubling) after
// the stacks: K5-chain (op 13) on R (6, 30, n) and Q (4, 30, n), result
// the lines (p1, 6, 30, n) then R (6, 30, n); K6-chain (op 14) on f (12,
// 30, n), the lines (p1, 6, 30, n) and P (2, 30, n), result f (12, 30,
// n). Ops 17-19: the chains on the fused pipeline's edges, in blocks as
// ops 0-4, the schedule after the stacks: K5-chain (op 17) on strict Q
// (4, 24, n), R = (Q, 1) formed in the chain, result the lines as words
// (p1, 6, 12, n); K6-chain (op 18 on word lines (p1, 6, 12, n), op 19 on
// digit lines (p1, 6, 30, n)) and strict P (2, 24, n), f = one formed in
// the chain, result f (12, 30, n); op 20 as op 18, result conj(f) as
// words (12, 12, n), the fused pairing's layout. Ops 11/12: tower381.cuh's edge
// formats on p1 Fp rows, format p2 (t381::EdgeFormat): rows (p1, K, n)
// -> words (p1, 12, n) (read_row) and words -> rows (write_row). Ops 5/6:
// the G1/G2 mixed addition of K2/K2-G2 on (5, 12, n) or (10, 12, n)
// canonical R16 words, result (3, 12, n) or (6, 12, n).
// Ops 7/8: the G1/G2 bucket accumulation of W = p1 windows, B = p2
// buckets, S = 1024 streams: points (24, n) or (48, n) words, digits (W, n),
// result the dump (W, B, 45 or 90, S). Ops 9/10: K11 (fp12 square) and K12
// (the sparse line product) on tower381.cuh, result (12, 30, n), in blocks
// as ops 0-4. Ops 15/16: the final exponentiation's chain programs of
// final_exp.cuh, in blocks as ops 0-4: FE-easy (op 15) on f (12, 30, n) and
// the Frobenius words (432 int32) after it, result (12, 12, n) words;
// FE-hard (op 16) on value 0 as words (12, 12, n), then the program (p1
// ops of 4 int32), then the Frobenius words, result (12, 30, n) digits;
// op 21 FE-easy on f as words (12, 12, n), op 22 FE-hard with the result
// as strict limbs (12, 24, n), the fused pairing's edges. Ops 23/24: K4 on
// the multi-pairings' word edges, in blocks as ops 0-4: a and b as words
// (24, 12, n), result words (12, 12, n) (op 23) or strict limbs (12, 24, n)
// (op 24). Ops 25-27: the chains on the strict engine's edges, in blocks as
// ops 0-4: K5-chain (op 25) on strict Q (4, 24, n), the schedule after it,
// result the lines as strict limbs (p1, 6, 24, n); K6-chain (op 26) on
// strict lines (p1, 6, 24, n) and strict P (2, 24, n), the schedule after
// them, result conj(f) as strict limbs (12, 24, n); FE-easy (op 27) on f
// as strict limbs (12, 24, n) and the Frobenius words, result (12, 12, n)
// words. Op 28: FE-hard as op 16 with the scratch stack's value 1 given,
// (12, 12, n) words after the Frobenius words.
// One block program over the batch: blocks of E elements, each phase's jobs
// in order (reversed if asked), with the slots' memory filled with a
// pattern first, so that a job reading a slot no earlier phase wrote goes
// wrong.
template <class Jobs, class Job>
void run_blocks(long long n, long long block, int slots, int phases, Jobs jobs, Job job) {
  const int E = static_cast<int>(block < 0 ? -block : block);
  std::vector<uint32_t> smem(static_cast<size_t>(E) * slots * t381::SLOT, 0xA5A5A5A5u);
  for (long long i0 = 0; i0 < n; i0 += E) {
    const t381::Block b{smem.data(), E, i0, n};
    for (int ph = 0; ph < phases; ++ph) {
      const int total = jobs(ph) * E;
      for (int k = 0; k < total; ++k) {
        const int j = block < 0 ? total - 1 - k : k;
        job(b, ph, j / E, j % E);
      }
    }
  }
}

// The chains' phase runner: each phase's jobs in order, or reversed.
struct HostPhases {
  int E;
  bool reverse;
  template <class Job>
  void operator()(int ops, const Job& job) const {
    const int total = ops * E;
    for (int k = 0; k < total; ++k) {
      const int j = reverse ? total - 1 - k : k;
      job(j / E, j % E);
    }
  }
};

// A chain program (K5's or K6's) over the batch in blocks of |block|
// elements, on slots filled with the pattern first.
template <class Program>
void run_chain(long long n, long long block, int slots, Program program) {
  const int E = static_cast<int>(block < 0 ? -block : block);
  std::vector<uint32_t> smem(static_cast<size_t>(E) * slots * t381::SLOT, 0xA5A5A5A5u);
  for (long long i0 = 0; i0 < n; i0 += E)
    program(t381::Block{smem.data(), E, i0, n}, HostPhases{E, block < 0});
}

t381::Schedule schedule(int events, const int* flags) {
  std::vector<unsigned char> dbl(flags, flags + events);
  t381::Schedule s;
  if (!t381::make_schedule(events, dbl.data(), s)) exit(4);
  return s;
}

template <class F>
void mixed_add_batch(const int* x, int* out, long long n) {
  const long long plane = g381::NC<F> * 12 * n;
  for (long long i = 0; i < n; ++i) {
    F v[5];
    for (int c = 0; c < 5; ++c) g381::load(x + c * plane + i, n, v[c]);
    g381::mixed_add(v[0], v[1], v[2], v[3], v[4]);
    for (int c = 0; c < 3; ++c) g381::store(v[c], out + c * plane + i, n);
  }
}

int main() {
  long long hdr[4];
  if (fread(hdr, sizeof(long long), 4, stdin) != 4) return 2;
  const long long op = hdr[0], n = hdr[1], param = hdr[2], B = hdr[3];
  if (op < 0 || op > 28) return 2;
  const bool tower = op <= 4 || op == 9 || op == 10;
  const long long plane = 30 * n, S = 1024;
  size_t in_size, out_size;
  const long long frob_ints = fexp::FROB_POWERS * 6 * 2 * 12;
  if (op == 28) {
    in_size = 2 * 12 * 12 * n + 4 * param + frob_ints;
    out_size = 12 * 30 * n;
  } else if (op == 23 || op == 24) {
    in_size = 24 * 12 * n;
    out_size = 12 * (op == 23 ? 12 : 24) * n;
  } else if (op == 15 || op == 16 || op == 21 || op == 22 || op == 27) {
    const bool easy = op == 15 || op == 21 || op == 27;
    in_size = easy ? (op == 15 ? 30 : op == 27 ? 24 : 12) * 12 * n + frob_ints
                   : 12 * 12 * n + 4 * param + frob_ints;
    out_size = easy ? 12 * 12 * n : 12 * (op == 16 ? 30 : 24) * n;
  } else if (op == 13 || op == 14) {
    in_size = (op == 13 ? 10 : 14 + 6 * param) * plane + param;
    out_size = (op == 13 ? 6 * param + 6 : 12) * plane;
  } else if (op == 25 || op == 26) {
    in_size = op == 25 ? 4 * 24 * n + param : 6 * param * 24 * n + 2 * 24 * n + param;
    out_size = op == 25 ? 6 * param * 24 * n : 12 * 24 * n;
  } else if (op >= 17) {
    in_size = op == 17 ? 4 * 24 * n + param
                       : 6 * param * (op == 19 ? 30 : 12) * n + 2 * 24 * n + param;
    out_size = op == 17 ? 6 * param * 12 * n : 12 * (op == 20 ? 12 : 30) * n;
  } else if (tower) {
    static const int in_rows[] = {12, 24, 6, 10, 20, 0, 0, 0, 0, 12, 18};
    in_size = in_rows[op] * plane;
    out_size = 12 * plane;
  } else if (op == 11 || op == 12) {
    if (B < t381::DIGIT_ROWS || B > t381::WORD_ROWS) return 2;
    const long long k = t381::row_entries(static_cast<int>(B));
    in_size = param * (op == 11 ? k : 12) * n;
    out_size = param * (op == 11 ? 12 : k) * n;
  } else if (op == 5 || op == 6) {  // NC = 1 or 2 Fp components a coordinate
    const long long nc = op - 4;
    in_size = 5 * nc * 12 * n;
    out_size = 3 * nc * 12 * n;
  } else {
    const long long nc = op - 6;
    in_size = 24 * nc * n + param * n;
    out_size = param * B * 45 * nc * S;
  }
  std::vector<int> in(in_size), out(out_size);
  if (fread(in.data(), sizeof(int), in.size(), stdin) != in.size()) return 3;
  const int* x = in.data();
  if (op == 5) mixed_add_batch<f381::Fp>(x, out.data(), n);
  if (op == 6) mixed_add_batch<f381::Fp2>(x, out.data(), n);
  if (op == 7 || op == 8) {
    const int* digs = x + (op == 7 ? 24 : 48) * n;
    for (int w = 0; w < param; ++w)
      for (int s = 0; s < S; ++s) {
        if (op == 7) g381::accumulate_stream<f381::Fp>(x, digs, out.data(), n, B, S, w, s);
        else g381::accumulate_stream<f381::Fp2>(x, digs, out.data(), n, B, S, w, s);
      }
  }
  for (long long r = 0; (op == 11 || op == 12) && r < param; ++r)
    for (long long i = 0; i < n; ++i) {
      const int fmt = static_cast<int>(B);
      const long long k = t381::row_entries(fmt);
      f381::Fp v;
      if (op == 11) {
        t381::read_row(x + r * k * n + i, n, fmt, v);
        g381::store(v, out.data() + r * 12 * n + i, n);
      } else {
        g381::load(x + r * 12 * n + i, n, v);
        t381::write_row(v, out.data() + r * k * n + i, n, fmt);
      }
    }
  const int p1 = static_cast<int>(param);
  int* o = out.data();
  if (op == 0)
    run_blocks(n, B, t381::CYC_SLOTS, t381::cyc_sqr_phases(p1),
               [&](int ph) { return t381::cyc_sqr_jobs(ph, p1); },
               [&](const t381::Block& b, int ph, int j, int e) {
                 t381::cyc_sqr_job(b, x, o, p1, ph, j, e);
               });
  if (op == 4) {
    const int flag = p1;
    const t381::MillerChain c{x, x + 12 * plane, x + 18 * plane, o, schedule(1, &flag), 0};
    run_chain(n, B, t381::MILLER_SLOTS,
              [&](const t381::Block& b, const HostPhases& ph) { t381::miller_chain(b, c, ph); });
  }
  if (op == 14) {
    const int* pxy = x + (12 + 6 * param) * plane;
    const t381::MillerChain c{x, x + 12 * plane, pxy, o, schedule(p1, pxy + 2 * plane), 0};
    run_chain(n, B, t381::MILLER_SLOTS,
              [&](const t381::Block& b, const HostPhases& ph) { t381::miller_chain(b, c, ph); });
  }
  if (op >= 18 && op <= 20) {
    const int fmt = op == 19 ? t381::DIGIT_ROWS : t381::WORD_ROWS;
    const int* pxy = x + 6 * param * t381::row_entries(fmt) * n;
    const t381::MillerChain c{nullptr, x, pxy, o, schedule(p1, pxy + 2 * 24 * n), 0};
    run_chain(n, B, t381::MILLER_SLOTS, [&](const t381::Block& b, const HostPhases& ph) {
      if (op == 18) t381::miller_chain<t381::WORD_ROWS, t381::LIMB_ROWS>(b, c, ph);
      else if (op == 19) t381::miller_chain<t381::DIGIT_ROWS, t381::LIMB_ROWS>(b, c, ph);
      else
        t381::miller_chain<t381::WORD_ROWS, t381::LIMB_ROWS, t381::WORD_ROWS>(b, c, ph);
    });
  }
  if (op == 17 || op == 25) {
    const t381::PrepareChain c{nullptr, x, o, nullptr, schedule(p1, x + 4 * 24 * n), 0};
    run_chain(n, B, t381::PREPARE_SLOTS, [&](const t381::Block& b, const HostPhases& ph) {
      if (op == 17) t381::prepare_chain<t381::LIMB_ROWS, t381::WORD_ROWS>(b, c, ph);
      else t381::prepare_chain<t381::LIMB_ROWS, t381::LIMB_ROWS>(b, c, ph);
    });
  }
  if (op == 26) {
    const int* pxy = x + 6 * param * 24 * n;
    const t381::MillerChain c{nullptr, x, pxy, o, schedule(p1, pxy + 2 * 24 * n), 0};
    run_chain(n, B, t381::MILLER_SLOTS, [&](const t381::Block& b, const HostPhases& ph) {
      t381::miller_chain<t381::LIMB_ROWS, t381::LIMB_ROWS, t381::LIMB_ROWS>(b, c, ph);
    });
  }
  if (op == 1)
    run_blocks(n, B, t381::FP12_MUL_SLOTS, t381::FP12_MUL_PHASES,
               [&](int ph) { return t381::fp12_mul_jobs(ph); },
               [&](const t381::Block& b, int ph, int j, int e) {
                 t381::fp12_mul_job(b, x, x + 12 * plane, o, 0, ph, j, e);
               });
  if (op == 23 || op == 24)
    run_blocks(n, B, t381::FP12_MUL_SLOTS, t381::FP12_MUL_PHASES,
               [&](int ph) { return t381::fp12_mul_jobs(ph); },
               [&](const t381::Block& b, int ph, int j, int e) {
                 if (op == 23)
                   t381::fp12_mul_job<t381::WORD_ROWS, t381::WORD_ROWS>(b, x, x + 12 * 12 * n, o,
                                                                         0, ph, j, e);
                 else
                   t381::fp12_mul_job<t381::WORD_ROWS, t381::LIMB_ROWS>(b, x, x + 12 * 12 * n, o,
                                                                         0, ph, j, e);
               });
  if (op == 2 || op == 3 || op == 13) {
    const int flag = op == 2;
    const t381::PrepareChain c =
        op == 13 ? t381::PrepareChain{x, x + 6 * plane, o, o + 6 * param * plane,
                                      schedule(p1, x + 10 * plane), 0}
                 : t381::PrepareChain{x, op == 3 ? x + 6 * plane : nullptr, o + 6 * plane, o,
                                      schedule(1, &flag), 0};
    run_chain(n, B, t381::PREPARE_SLOTS,
              [&](const t381::Block& b, const HostPhases& ph) { t381::prepare_chain(b, c, ph); });
  }
  if (op == 9)
    run_blocks(n, B, t381::FP12_SQR_SLOTS, t381::FP12_SQR_PHASES,
               [&](int ph) { return t381::fp12_sqr_jobs(ph); },
               [&](const t381::Block& b, int ph, int j, int e) {
                 t381::fp12_sqr_job(b, x, o, ph, j, e);
               });
  if (op == 10)
    run_blocks(n, B, t381::MUL_BY_014_SLOTS, t381::MUL_BY_014_PHASES,
               [&](int ph) { return t381::mul_by_014_jobs(ph); },
               [&](const t381::Block& b, int ph, int j, int e) {
                 t381::mul_by_014_job(b, x, x + 12 * plane, o, ph, j, e);
               });
  if (op == 15 || op == 21 || op == 27) {
    const fexp::EasyChain c{x, o, x + 12 * (op == 15 ? 30 : op == 27 ? 24 : 12) * n};
    run_chain(n, B, fexp::SLOTS, [&](const t381::Block& b, const HostPhases& ph) {
      if (op == 15) fexp::easy_chain(b, c, ph);
      else if (op == 21) fexp::easy_chain<t381::WORD_ROWS>(b, c, ph);
      else fexp::easy_chain<t381::LIMB_ROWS>(b, c, ph);
    });
  }
  if (op == 16 || op == 22 || op == 28) {
    const long long in_len = 12 * 12 * n;
    std::vector<int> scratch(static_cast<size_t>(15 * 12 * 12 * n));
    if (op == 28)
      std::copy(x + in_len + 4 * param + frob_ints, x + 2 * in_len + 4 * param + frob_ints,
                scratch.begin());
    const fexp::HardChain c{x, scratch.data(), o, x + in_len, p1, x + in_len + 4 * param};
    // as the card runs FE-hard: jobs for the block's elements in the batch alone
    run_chain(n, B, fexp::HARD_SLOTS / 2, [&](const t381::Block& b, const HostPhases& ph) {
      const HostPhases active{fexp::active_elems(b), ph.reverse};
      if (op == 22) fexp::hard_chain<t381::LIMB_ROWS>(b, c, active);
      else fexp::hard_chain(b, c, active);
    });
  }
  fwrite(out.data(), sizeof(int), out.size(), stdout);
  return 0;
}
"""


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


@pytest.fixture(scope="module")
def harness():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    h = hashlib.sha256(HARNESS.encode())
    for path in sorted(KC.CSRC_DIR.glob("*.cuh")):
        h.update(path.read_bytes())
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


def run(exe, op, param, *stacks, shape=None, buckets=0):
    """Run harness op on the stacks; the result has `shape` (default
    (12, 30, n), the tower's)."""
    n = stacks[0].shape[-1]
    data = b"".join(s.contiguous().numpy().astype(np.int32).tobytes() for s in stacks)
    hdr = np.array([op, n, param, buckets], np.int64).tobytes()
    proc = subprocess.run([exe], input=hdr + data, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    out = np.frombuffer(proc.stdout, np.int32).reshape(shape or (12, 30, n))
    return torch.from_numpy(out.copy())


def digit_stacks(seed, *rows, top=None):
    """Random mul-ready stacks with the extreme patterns in the first
    columns: +-F_BOUND, canonical maxima, alternating signs, the R13/2
    edge; with `top`, the top digit redrawn in [-top, top] in every column
    (the patterns kept in the other 29)."""
    rng = np.random.default_rng(seed)
    edge = [int(v) for v in LZ.int_to_digits((LZ.R13 >> 1) - 1)]
    out = []
    for r in rows:
        a = rng.integers(-F, F + 1, (r, 30, N)).astype(np.int32)
        a[:, :, 0], a[:, :, 1], a[:, :, 2] = F, -F, 8191
        a[:, :, 3] = [F if k % 2 else -F for k in range(30)]
        a[:, :, 4] = edge
        if top is not None:
            a[:, 29, :] = rng.integers(-top, top + 1, (r, N))
        out.append(torch.from_numpy(a))
    return out


def real_inputs():
    """Event operands as the pipeline gives them (P, Q ingested, R after
    two doublings, f after two Miller events, the third event's line and P,
    and that line scaled by P as K12 takes it)."""
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
    coeffs = PR.prepare_g2(q, fuse=False, events=3)  # digits, as the unfused prepare's
    pxy = torch.stack([TL.fp_ingest(p[0]), TL.fp_ingest(p[1])])
    fs = TL.stack12(PR._fp12_one_like(pxy[0]))
    for i in range(2):
        fs = PS.miller_step(fs, coeffs[i], pxy, True)
    a0, a1, a4 = PS._ell_legs(TL, PR._line(coeffs[2]), pxy[0], pxy[1])
    legs = torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]])
    return rs, torch.stack([qx[0], qx[1], qy[0], qy[1]]), fs, coeffs[2], pxy, legs


# --- K3-K6 on the 32-bit tower (csrc/tower381.cuh), by value ----------------

BLOCK = 8  # elements a block in the harness: two blocks over N = 12, the second ragged
# The top digit's bound for the random operands of K4, K5 and K6: |value| <
# 101 * 2^377 < 8p, the lazy engine's mul-ready domain (LZ.canonicalize's),
# on which the plain versions are field operations; their folds truncate
# values near 2^390.
TOP_8P = 100


def values(stack: torch.Tensor) -> list:
    """(k, 30, n) digits -> each Fp row's value mod p (host ints)."""
    return [[LZ.digits_to_int(stack[r, :, j].numpy()) % OF.P for j in range(stack.shape[2])]
            for r in range(stack.shape[0])]


def assert_value_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    """The kernel's digits hold the plain version's field elements, within 4096;
    LZ.canonicalize_rows (the card tests' check) agrees with the host ints."""
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(want)
    assert torch.equal(LZ.canonicalize_rows(got), LZ.canonicalize_rows(want))


@pytest.mark.parametrize("nsq", [1, max(r for r, _ in FE.X_SEGMENTS)])
def test_cyc_sqr_host(harness, nsq):
    (x,) = digit_stacks(1, 12)
    assert_value_equal(run(harness, 0, nsq, x, buckets=BLOCK), K3.cyc_sqr_plain(x, nsq))


def random_fp12(rng: random.Random):
    """A random canonical fp12 element as the oracle holds it."""
    return tuple(tuple(tuple(rng.randrange(OF.P) for _ in range(2)) for _ in range(3))
                 for _ in range(2))


def cyclotomic_elements(n: int) -> list:
    """n elements of the cyclotomic subgroup by the oracle: f^((p^6 - 1)(p^2 +
    1)) for random f."""
    rng = random.Random(12)
    out = []
    for _ in range(n):
        f = random_fp12(rng)
        g = OF.fp12_mul(OF.fp12_conj(f), OF.fp12_inv(f))
        out.append(OF.fp12_mul(OF.fp12_frobenius(g, 2), g))
    return out


def fp_rows(cols) -> torch.Tensor:
    """Oracle Fp values, one list of k rows per element -> (k, 30, n)
    canonical R13 digits."""
    arr = np.array([[LZ.int_to_digits(v[r] * LZ.R13 % OF.P) for v in cols]
                    for r in range(len(cols[0]))])
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 2, 1)).astype(np.int32))


def fp12_stack(elems) -> torch.Tensor:
    """Oracle fp12 values -> (12, 30, n) canonical R13 digits."""
    return fp_rows([[c for b in e for a in b for c in a] for e in elems])


@pytest.mark.parametrize("nsq", [1, 3])
def test_cyc_sqr_host_oracle(harness, nsq):
    """tower381.cuh's K3 on real cyclotomic elements: nsq plain squares by the
    oracle's Python ints (its general fp12 square)."""
    elems = cyclotomic_elements(N)
    assert all(OF.fp12_cyclotomic_sqr(e) == OF.fp12_sqr(e) for e in elems[:2])
    want = elems
    for _ in range(nsq):
        want = [OF.fp12_sqr(e) for e in want]
    got = run(harness, 0, nsq, fp12_stack(elems), buckets=BLOCK)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack(want))


def test_fp12_mul_host(harness):
    a, b = digit_stacks(2, 12, 12, top=TOP_8P)
    assert_value_equal(run(harness, 1, 0, a, b, buckets=BLOCK), K4.fp12_mul_plain(a, b))


def fp12_words(elems) -> torch.Tensor:
    """Oracle fp12 values -> (12, 12, n) canonical Montgomery words (v
    2^384 mod p), the chains' and K4's word stacks."""
    cols = [[c for b in e for a in b for c in a] for e in elems]
    arr = np.array([[W.split(v[r] * (1 << 384) % OF.P) for v in cols] for r in range(12)],
                   np.uint32)  # (12, n, 12)
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 2, 1)).view(np.int32))


@pytest.mark.parametrize("out", ["words", "limbs"])
def test_fp12_mul_words_host_oracle(harness, out):
    """tower381.cuh's K4 on the multi-pairings' word edges (words in, words
    or strict limbs out; blocks of 8, the second ragged) on random
    canonical elements, one and zero among them: word for word (limb for
    limb) equal to `fp12_mul_plain` in that layout and to the oracle's
    fp12_mul, with no conjugation at the edges."""
    rng = random.Random(22)
    a = [random_fp12(rng) for _ in range(N)]
    b = [random_fp12(rng) for _ in range(N)]
    a[0], b[1] = OF.FP12_ONE, OF.FP12_ZERO
    wa, wb = fp12_words(a), fp12_words(b)
    want = [OF.fp12_mul(x, y) for x, y in zip(a, b)]
    if out == "words":
        got = run(harness, 23, 0, wa, wb, shape=(12, W.WORDS, N), buckets=BLOCK)
        assert torch.equal(got, fp12_words(want))
    else:
        got = run(harness, 24, 0, wa, wb, shape=(12, 24, N), buckets=BLOCK)
        assert torch.equal(got, torch.stack(TL._flat12(CV.fp12_to_dev(want))))
    assert torch.equal(got, K4.fp12_mul_plain(wa, wb, out))


def test_fp12_mul_host_oracle(harness):
    """tower381.cuh's K4 on random canonical elements against the oracle's
    fp12_mul (its schoolbook fp6 products, not the kernel's Karatsuba)."""
    rng = random.Random(21)
    a = [random_fp12(rng) for _ in range(N)]
    b = [random_fp12(rng) for _ in range(N)]
    got = run(harness, 1, 0, fp12_stack(a), fp12_stack(b), buckets=BLOCK)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack([OF.fp12_mul(x, y) for x, y in zip(a, b)]))


@pytest.mark.parametrize("source", ["random", "pipeline"])
@pytest.mark.parametrize("is_add", [False, True])
def test_prepare_step_host(harness, is_add, source):
    r, q = digit_stacks(3, 6, 4, top=TOP_8P) if source == "random" else real_inputs()[:2]
    if is_add:
        got, want = run(harness, 3, 0, r, q, buckets=BLOCK), PS.prepare_step_plain(r, q)
    else:
        got, want = run(harness, 2, 0, r, buckets=BLOCK), PS.prepare_step_plain(r)
    assert_value_equal(got, want)


def test_prepare_g2_host_chain(harness):
    """K5's 68 events chained on tower381.cuh, each event's R (its digits as
    the kernel wrote them) the next one's input, for five points, against
    the oracle's prepare_g2: every event's line by value in the R13
    domain."""
    rng = np.random.default_rng(8)
    qs = [OC.g2_mul(OF.G2_GEN, int(rng.integers(1, 1 << 62))) for _ in range(5)]
    want = [OP.prepare_g2(q) for q in qs]
    r = fp_rows([[*q[0], *q[1], 1, 0] for q in qs])
    q = fp_rows([[*q[0], *q[1]] for q in qs])
    k = 0
    for bit in OP.X_BITS:
        for is_add in (False, True)[: 1 + bit]:
            out = run(harness, 3, 0, r, q, buckets=BLOCK) if is_add else \
                run(harness, 2, 0, r, buckets=BLOCK)
            assert int(out.abs().max()) <= 4096
            line = fp_rows([[v for c in w[k] for v in c] for w in want])
            assert values(out[6:]) == values(line), f"event {k}"
            r, k = out[:6].contiguous(), k + 1
    assert k == 68


SCHEDULE_8 = PR.MILLER_EVENTS[:8]  # two additions, events 1 and 4


def flags(schedule) -> torch.Tensor:
    return torch.tensor([int(x) for x in schedule], dtype=torch.int32)


def chain_args(kernel, r, q, f, coeffs, pxy, schedule):
    """The harness call of a chain (op, events, stacks..., result shape):
    K5-chain on R and Q, K6-chain on f, the lines and P."""
    e = len(schedule)
    if kernel == "prepare_chain":
        return 13, e, r, q, flags(schedule), (6 * e + 6, 30, r.shape[-1])
    n = f.shape[-1]
    return 14, e, f, coeffs[:e].reshape(6 * e, 30, n), pxy, flags(schedule), (12, 30, n)


def test_prepare_chain_host_oracle(harness):
    """The K5-chain program over all 68 events for five points in one harness
    call (blocks of 4: the second ragged): every event's line equal to the
    oracle's prepare_g2 by value in the R13 domain, R after the last event
    equal to the plain version's; digits within 4096."""
    rng = np.random.default_rng(9)
    qs = [OC.g2_mul(OF.G2_GEN, int(rng.integers(1, 1 << 62))) for _ in range(5)]
    q = fp_rows([[*p[0], *p[1]] for p in qs])
    r = PS._r_start(q)
    e = PR.NUM_EVENTS
    got = run(harness, 13, e, r, q, flags(PR.MILLER_EVENTS), shape=(6 * e + 6, 30, 5), buckets=4)
    assert int(got.abs().max()) <= 4096
    want = [OP.prepare_g2(p) for p in qs]
    lines = fp_rows([[v for k in range(e) for c in w[k] for v in c] for w in want])
    assert values(got[: 6 * e]) == values(lines)
    rs = r
    for is_dbl in PR.MILLER_EVENTS:
        rs = PS.prepare_step_plain(rs, None if is_dbl else q)[:6]
    assert values(got[6 * e :]) == values(rs)


def test_miller_chain_host_oracle(harness):
    """The K6-chain program over all 68 events (f = 1, the lines of the
    plain prepare of five real Q, five real P; blocks of 4) against the
    chained miller_step_plain and the oracle's miller_loop (conjugated
    back) by value; digits within 4096."""
    rng = np.random.default_rng(10)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(10)]
    ps = [OC.scalar_mul(OF.G1_GEN, k) for k in ks[:5]]
    qs = [OC.g2_mul(OF.G2_GEN, k) for k in ks[5:]]
    coeffs = PS.prepare_chain_plain(fp_rows([[*q[0], *q[1]] for q in qs]), PR.MILLER_EVENTS)
    pxy = fp_rows([[*p] for p in ps])
    f = TL.stack12(PR._fp12_one_like(pxy[0]))
    args = chain_args("miller_chain", None, None, f, coeffs, pxy, PR.MILLER_EVENTS)
    got = run(harness, *args[:-1], shape=args[-1], buckets=4)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(PS.miller_chain_plain(f, coeffs, pxy, PR.MILLER_EVENTS))
    want = [OF.fp12_conj(OP.miller_loop(p, q)) for p, q in zip(ps, qs)]
    assert values(got) == values(fp12_stack(want))


def strict_pairs(n: int, seed: int):
    """n random pairs as the fused pipeline's entry points hold them: Q as
    strict limbs (4, 24, n) (qx re, im, qy re, im), P (2, 24, n), and the
    affine points."""
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(2 * n)]
    ps = [OC.scalar_mul(OF.G1_GEN, k) for k in ks[:n]]
    qs = [OC.g2_mul(OF.G2_GEN, k) for k in ks[n:]]
    q = torch.stack([*CV.fp2_to_dev([x[0] for x in qs]), *CV.fp2_to_dev([x[1] for x in qs])])
    p = torch.stack([CV.fp_to_dev([x[0] for x in ps]), CV.fp_to_dev([x[1] for x in ps])])
    return q, p, ps, qs


def edge_args(kernel, q, p, lines, schedule):
    """The harness call of a chain on the fused pipeline's edges (op,
    events, stacks..., result shape): K5-chain on strict Q, lines out as
    words (or, for "prepare_limbs", the strict engine's, as strict limbs);
    K6-chain on word (or digit) lines and strict P, f out as digits (or,
    for "miller_lines_words", conj(f) as words; for "miller_limbs", strict
    lines in and conj(f) out as strict limbs)."""
    e, n = len(schedule), q.shape[-1]
    if kernel == "prepare_lines":
        return 17, e, q, flags(schedule), (e, 6, W.WORDS, n)
    if kernel == "prepare_limbs":
        return 25, e, q, flags(schedule), (e, 6, W.LIMBS, n)
    if kernel == "miller_limbs":
        return 26, e, lines[:e].contiguous(), p, flags(schedule), (12, W.LIMBS, n)
    if kernel == "miller_lines_words":
        return 20, e, lines[:e].contiguous(), p, flags(schedule), (12, W.WORDS, n)
    op = 18 if lines.shape[2] == W.WORDS else 19
    return op, e, lines[:e].contiguous(), p, flags(schedule), (12, 30, n)


def word_values(stack: torch.Tensor) -> list:
    """(k, 12, n) canonical words -> each Fp row's value (the words' number
    times 2^-384 mod p), host ints."""
    inv = pow(1 << 384, -1, OF.P)
    u = stack.numpy().astype(np.uint32).astype(object)
    return [[sum(int(u[r, k, j]) << (32 * k) for k in range(W.WORDS)) * inv % OF.P
             for j in range(stack.shape[2])] for r in range(stack.shape[0])]


def test_prepare_lines_host_oracle(harness):
    """K5-chain on the fused pipeline's edges over all 68 events for five
    points (blocks of 4, the second ragged): Q read as strict limbs, R =
    (Q, 1) formed in the chain, every event's line stored as canonical
    words equal to the oracle's prepare_g2, and word for word to
    `prepare_lines_plain`."""
    q, _, _, qs = strict_pairs(5, 14)
    e = PR.NUM_EVENTS
    got = run(harness, 17, e, q, flags(PR.MILLER_EVENTS), shape=(e, 6, W.WORDS, 5), buckets=4)
    want = [OP.prepare_g2(x) for x in qs]
    assert word_values(got.reshape(6 * e, W.WORDS, 5)) == [
        [w[k][r // 2][r % 2] for w in want] for k in range(e) for r in range(6)]
    assert torch.equal(got, PS.prepare_lines_plain(((q[0], q[1]), (q[2], q[3])), PR.MILLER_EVENTS))


@pytest.mark.parametrize("lines", ["words", "digits"])
def test_miller_lines_host_oracle(harness, lines):
    """K6-chain on the fused pipeline's edges over all 68 events for five
    pairs (blocks of 4): f = one formed in the chain, P read as strict
    limbs, the lines as K5-chain's words (or as digits, an unfused
    prepare's) -> f against the oracle's miller_loop (conjugated back) and
    `miller_lines_plain` by value; digits within 4096."""
    q, p, ps, qs = strict_pairs(5, 15)
    c = PS.prepare_lines_plain(((q[0], q[1]), (q[2], q[3])), PR.MILLER_EVENTS)
    if lines == "digits":
        c = W.words_to_digits_plain(c)
    args = edge_args("miller_lines", q, p, c, PR.MILLER_EVENTS)
    got = run(harness, *args[:-1], shape=args[-1], buckets=4)
    assert int(got.abs().max()) <= 4096
    want = [OF.fp12_conj(OP.miller_loop(a, b)) for a, b in zip(ps, qs)]
    assert values(got) == values(fp12_stack(want))
    assert values(got) == values(PS.miller_lines_plain(c, (p[0], p[1]), PR.MILLER_EVENTS))


def test_miller_lines_words_host_oracle(harness):
    """K6-chain in the fused pairing's layout over all 68 events for five
    pairs (blocks of 4): word lines and strict P in, conj(f) stored as
    canonical words, equal by value to the oracle's miller_loop (the
    conjugation applied once, in the store) and word for word to
    `miller_lines_plain(..., FMT_WORDS)`."""
    q, p, ps, qs = strict_pairs(5, 15)
    c = PS.prepare_lines_plain(((q[0], q[1]), (q[2], q[3])), PR.MILLER_EVENTS)
    args = edge_args("miller_lines_words", q, p, c, PR.MILLER_EVENTS)
    got = run(harness, *args[:-1], shape=args[-1], buckets=4)
    assert (got.numpy().view(np.uint32)[:, -1] <= OF.P >> 352).all()
    want = [OP.miller_loop(a, b) for a, b in zip(ps, qs)]
    assert word_values(got) == [[w[r // 6][r // 2 % 3][r % 2] for w in want] for r in range(12)]
    assert torch.equal(got, PS.miller_lines_plain(c, (p[0], p[1]), PR.MILLER_EVENTS,
                                                  PS.FMT_WORDS))


def test_strict_chains_host_oracle(harness):
    """K5-chain and K6-chain on the strict engine's edges over all 68 events
    for three pairs (blocks of 2, the second ragged): Q read as strict
    limbs, every event's line stored as canonical strict limbs equal to
    the oracle's prepare_g2 (`fp_to_dev` of its values) limb for limb; on
    those lines and strict P, conj(f) stored as strict limbs equal to the
    oracle's miller_loop (`fp12_to_dev`) limb for limb."""
    q, p, ps, qs = strict_pairs(3, 17)
    e = PR.NUM_EVENTS
    lines = run(harness, 25, e, q, flags(PR.MILLER_EVENTS), shape=(e, 6, W.LIMBS, 3), buckets=2)
    want = [OP.prepare_g2(x) for x in qs]
    assert torch.equal(lines, torch.stack([torch.stack([
        CV.fp_to_dev([w[k][r // 2][r % 2] for w in want]) for r in range(6)])
        for k in range(e)]))
    got = run(harness, 26, e, lines, p, flags(PR.MILLER_EVENTS), shape=(12, W.LIMBS, 3),
              buckets=2)
    want = CV.fp12_to_dev([OP.miller_loop(a, b) for a, b in zip(ps, qs)])
    assert torch.equal(got, torch.stack(TL._flat12(want)))


# Strict limb values: 0, 1, p - 1, R mod p, then values in [p, 2^384) that
# the load must reduce (p, 2^384 - 1, the largest multiple of p below
# 2^384, and p + R mod p), then random canonical ones
_R_MOD_P = (1 << 384) % OF.P
_LIMB_VALUES = [0, 1, OF.P - 1, _R_MOD_P, OF.P, (1 << 384) - 1, (((1 << 384) - 1) // OF.P) * OF.P,
                OF.P + _R_MOD_P]


@pytest.mark.parametrize("fmt", ["limbs", "words"])
def test_edge_format_rows_host(harness, fmt):
    """tower381.cuh's loads and stores of the strict-limb and word formats
    against Python ints: a limb row loads as the canonical words of its
    value mod p (the values in [p, 2^384) reduced), and canonical words
    store as the limbs of their number; words load and store as they are,
    and both round trips return a canonical row unchanged."""
    rng = random.Random(16)
    vals = _LIMB_VALUES + [rng.randrange(OF.P) for _ in range(N)]
    n = len(vals)
    words = torch.from_numpy(np.array([W.split(v % OF.P) for v in vals], np.uint32)
                             .T.copy().view(np.int32))[None]
    if fmt == "limbs":
        limbs = torch.from_numpy(ints_to_limbs(vals, 24).T.copy())[None]
        assert torch.equal(run(harness, 11, 1, limbs, shape=(1, W.WORDS, n), buckets=1), words)
        canon = torch.from_numpy(ints_to_limbs([v % OF.P for v in vals], 24).T.copy())[None]
        back = run(harness, 12, 1, words, shape=(1, 24, n), buckets=1)
        assert torch.equal(back, canon)
        assert torch.equal(run(harness, 11, 1, back, shape=(1, W.WORDS, n), buckets=1), words)
    else:
        assert torch.equal(run(harness, 11, 1, words, shape=(1, W.WORDS, n), buckets=2), words)
        assert torch.equal(run(harness, 12, 1, words, shape=(1, W.WORDS, n), buckets=2), words)


@pytest.mark.parametrize("kernel", ["prepare_chain", "miller_chain", "prepare_lines",
                                    "miller_lines", "miller_lines_words", "prepare_limbs",
                                    "miller_limbs"])
def test_chain_host_truncated(harness, kernel):
    """A chain of 8 events with two additions against its plain version: on
    the pipeline's digit inputs (R after two doublings, f after two events)
    by value, digits within 4096; on the fused pipeline's edges (strict Q
    and P, R = (Q, 1) and f = one formed in the chain, word lines) the
    lines word for word and f by value, conj(f) as words word for word; on
    the strict engine's (strict lines out and in, conj(f) out as strict
    limbs) limb for limb."""
    if "limbs" in kernel:
        q, p, _, _ = strict_pairs(N, 13)
        want = PS.prepare_lines_plain(((q[0], q[1]), (q[2], q[3])), SCHEDULE_8, PS.FMT_LIMBS)
        args = edge_args(kernel, q, p, want, SCHEDULE_8)
        got = run(harness, *args[:-1], shape=args[-1], buckets=BLOCK)
        if kernel == "miller_limbs":
            want = PS.miller_lines_plain(want, (p[0], p[1]), SCHEDULE_8, PS.FMT_LIMBS)
        assert torch.equal(got, want)
        return
    if "lines" in kernel:
        q, p, _, _ = strict_pairs(N, 12)
        qx, qy, pp = (q[0], q[1]), (q[2], q[3]), (p[0], p[1])
        want = PS.prepare_lines_plain((qx, qy), SCHEDULE_8)
        args = edge_args(kernel, q, p, want, SCHEDULE_8)
        got = run(harness, *args[:-1], shape=args[-1], buckets=BLOCK)
        if kernel == "prepare_lines":
            assert torch.equal(got, want)
        elif kernel == "miller_lines":
            assert_value_equal(got, PS.miller_lines_plain(want, pp, SCHEDULE_8))
        else:
            assert torch.equal(got, PS.miller_lines_plain(want, pp, SCHEDULE_8, PS.FMT_WORDS))
        return
    r, q, f, _, pxy, _ = real_inputs()
    n = r.shape[-1]
    if kernel == "prepare_chain":
        args = chain_args(kernel, r, q, None, None, None, SCHEDULE_8)
        got = run(harness, *args[:-1], shape=args[-1], buckets=BLOCK)
        rs, want = r, []
        for is_dbl in SCHEDULE_8:
            out = PS.prepare_step_plain(rs, None if is_dbl else q)
            rs = out[:6]
            want.append(out[6:])
        assert_value_equal(got, torch.cat(want + [rs]))
    else:
        coeffs = PS.prepare_chain_plain(q, SCHEDULE_8)
        args = chain_args(kernel, r, q, f, coeffs, pxy, SCHEDULE_8)
        got = run(harness, *args[:-1], shape=args[-1], buckets=BLOCK)
        assert got.shape == (12, 30, n)
        assert_value_equal(got, PS.miller_chain_plain(f, coeffs, pxy, SCHEDULE_8))


@pytest.mark.parametrize("source", ["random", "pipeline"])
@pytest.mark.parametrize("with_sqr", [False, True])
def test_miller_step_host(harness, with_sqr, source):
    if source == "random":
        f, c, pxy = digit_stacks(4, 12, 6, 2, top=TOP_8P)
    else:
        f, c, pxy = real_inputs()[2:5]
    got = run(harness, 4, int(with_sqr), f, c, pxy, buckets=BLOCK)
    assert_value_equal(got, PS.miller_step_plain(f, c, pxy, with_sqr))


@pytest.mark.parametrize("kernel", ["cyc_sqr", "miller_sqr", "miller_line", "fp12_mul",
                                    "prepare_dbl", "prepare_add", "fp12_sqr", "mul_by_014",
                                    "prepare_chain", "miller_chain", "final_exp_easy",
                                    "final_exp_hard", "prepare_lines", "miller_lines",
                                    "miller_lines_words", "final_exp_easy_words",
                                    "final_exp_hard_limbs", "fp12_mul_words",
                                    "fp12_mul_limbs"])
def test_tower381_phases_have_no_hazards(harness, kernel):
    """Each phase's jobs are independent: run in reverse order they give the
    same digits (on the card they run at once); for the chains over 8
    events with two additions, the phases between events too; for the final
    exponentiation's chains every phase of their programs (FE-hard on
    FE-easy's words of real Miller outputs), in each layout of their
    edges."""
    if kernel.startswith("final_exp"):
        f = fp12_stack(miller_fs())
        n = f.shape[-1]
        args = (15, 0, f, FROB, (12, FE.WORDS, n))
        if kernel == "final_exp_easy_words":
            args = (21, 0, W.digits_to_words_plain(f), FROB, (12, FE.WORDS, n))
        if kernel.startswith("final_exp_hard"):
            limbs = kernel.endswith("limbs")
            args = (22 if limbs else 16, len(FE.HARD_PROGRAM),
                    run(harness, *args[:-1], shape=args[-1], buckets=3), PROGRAM, FROB,
                    (12, 24 if limbs else 30, n))
        assert torch.equal(run(harness, *args[:-1], shape=args[-1], buckets=3),
                           run(harness, *args[:-1], shape=args[-1], buckets=-3))
        return
    if "lines" in kernel:
        q, p, _, _ = strict_pairs(N, 13)
        lines = PS.prepare_lines_plain(((q[0], q[1]), (q[2], q[3])), SCHEDULE_8)
        args = edge_args(kernel, q, p, lines, SCHEDULE_8)
        assert torch.equal(run(harness, *args[:-1], shape=args[-1], buckets=BLOCK),
                           run(harness, *args[:-1], shape=args[-1], buckets=-BLOCK))
        return
    if kernel in ("fp12_mul_words", "fp12_mul_limbs"):
        rng = random.Random(19)
        a, b = (fp12_words([random_fp12(rng) for _ in range(N)]) for _ in range(2))
        args = (23 if kernel.endswith("words") else 24, 0, a, b,
                (12, W.WORDS if kernel.endswith("words") else 24, N))
        assert torch.equal(run(harness, *args[:-1], shape=args[-1], buckets=BLOCK),
                           run(harness, *args[:-1], shape=args[-1], buckets=-BLOCK))
        return
    if kernel.endswith("chain"):
        r, q, f, _, pxy, _ = real_inputs()
        args = chain_args(kernel, r, q, f, PS.prepare_chain_plain(q, SCHEDULE_8), pxy,
                          SCHEDULE_8)
        assert torch.equal(run(harness, *args[:-1], shape=args[-1], buckets=BLOCK),
                           run(harness, *args[:-1], shape=args[-1], buckets=-BLOCK))
        return
    if kernel == "cyc_sqr":
        args = (0, 2, *digit_stacks(13, 12))
    elif kernel == "fp12_mul":
        args = (1, 0, *digit_stacks(15, 12, 12, top=TOP_8P))
    elif kernel.startswith("prepare"):
        is_add = kernel == "prepare_add"
        args = (2 + is_add, 0, *digit_stacks(16, 6, 4, top=TOP_8P)[: 1 + is_add])
    elif kernel == "fp12_sqr":
        args = (9, 0, *digit_stacks(17, 12, top=TOP_8P))
    elif kernel == "mul_by_014":
        args = (10, 0, *digit_stacks(18, 12, 6, top=TOP_8P))
    else:
        args = (4, int(kernel == "miller_sqr"), *digit_stacks(14, 12, 6, 2, top=TOP_8P))
    assert torch.equal(run(harness, *args, buckets=BLOCK), run(harness, *args, buckets=-BLOCK))


def test_tower381_conversions_host(harness):
    """digits -> words -> digits: the words are the digits' value, canonical
    in the R16 domain, for every |d| <= 8191 (random digits and the
    extreme patterns); the digits back hold the same value within 4096."""
    rng = np.random.default_rng(11)
    d = rng.integers(-8191, 8192, (6, 30, N)).astype(np.int32)
    edge = [int(v) for v in LZ.int_to_digits((LZ.R13 >> 1) - 1)]
    pm1 = [int(v) for v in LZ.int_to_digits(OF.P - 1)]
    patterns = [[F] * 30, [-F] * 30, [8191] * 30, [-8191] * 30,
                [F if k % 2 else -F for k in range(30)],
                [8191 if k % 2 else -8191 for k in range(30)], edge, pm1, [0] * 30]
    for i, pat in enumerate(patterns):
        d[:, :, i] = pat
    d = torch.from_numpy(d)
    words = run(harness, 11, 6, d, shape=(6, 12, N))
    assert torch.equal(words, words_of(d))
    back = run(harness, 12, 6, words, shape=(6, 30, N))
    assert int(back.abs().max()) <= 4096
    assert values(back) == values(d)


@pytest.mark.parametrize("source", ["random", "pipeline"])
def test_fp12_sqr_host(harness, source):
    (f,) = digit_stacks(9, 12, top=TOP_8P) if source == "random" else real_inputs()[2:3]
    assert_value_equal(run(harness, 9, 0, f, buckets=BLOCK), K11.fp12_sqr_plain(f))


@pytest.mark.parametrize("source", ["random", "pipeline"])
def test_fp12_mul_by_014_host(harness, source):
    if source == "random":
        f, c = digit_stacks(10, 12, 6, top=TOP_8P)
    else:
        inputs = real_inputs()
        f, c = K11.fp12_sqr_plain(inputs[2]), inputs[5]
    assert_value_equal(run(harness, 10, 0, f, c, buckets=BLOCK), K12.fp12_mul_by_014_plain(f, c))


@pytest.mark.parametrize("kernel", ["fp12_sqr", "mul_by_014"])
def test_fp12_sqr_and_mul_by_014_host_oracle(harness, kernel):
    """tower381.cuh's K11 and K12 on random canonical elements against the
    oracle's fp12_sqr and fp12_mul (K12's line as the fp12 ((c0, c1, 0),
    (0, c4, 0)), the layout the rows' names give it)."""
    rng = random.Random(23)
    f = [random_fp12(rng) for _ in range(N)]
    if kernel == "fp12_sqr":
        got = run(harness, 9, 0, fp12_stack(f), buckets=BLOCK)
        want = [OF.fp12_sqr(x) for x in f]
    else:
        lines = [tuple(tuple(rng.randrange(OF.P) for _ in range(2)) for _ in range(3))
                 for _ in range(N)]
        c = fp_rows([[v for fp2 in line for v in fp2] for line in lines])
        got = run(harness, 10, 0, fp12_stack(f), c, buckets=BLOCK)
        zero = (0, 0)
        want = [OF.fp12_mul(x, ((c0, c1, zero), (zero, c4, zero)))
                for x, (c0, c1, c4) in zip(f, lines)]
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack(want))


# --- the final exponentiation's chains (csrc/final_exp.cuh) ------------------

FROB = torch.from_numpy(FE.FROB_WORDS.reshape(-1).copy())
PROGRAM = torch.tensor(FE.HARD_PROGRAM, dtype=torch.int32).reshape(-1)


def miller_fs(n: int = 3) -> list:
    """The oracle's Miller loop of n numpy-seeded real pairs, then one (an
    identity pair's f after the mask)."""
    rng = np.random.default_rng(24)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(2 * n)]
    pairs = zip([OC.scalar_mul(OF.G1_GEN, k) for k in ks[:n]],
                [OC.g2_mul(OF.G2_GEN, k) for k in ks[n:]])
    return [OP.miller_loop(p, q) for p, q in pairs] + [OF.FP12_ONE]


def easy_oracle(f):
    """The easy part by the oracle: g = conj(f) f^-1, then g^(p^2) g."""
    g = OF.fp12_mul(OF.fp12_conj(f), OF.fp12_inv(f))
    return OF.fp12_mul(OF.fp12_frobenius(g, 2), g)


def test_final_exp_chains_host_oracle(harness):
    """FE-easy's program on three real Miller outputs and f = 1 (blocks of 3:
    the second ragged) against the oracle's easy part and `easy_plain` by
    value, its words canonical; FE-hard's program on those words against
    the oracle's final_exp by value, and on the words of `easy_plain`'s
    digits against `hard_plain`'s; digits within 4096."""
    fs = miller_fs()
    f = fp12_stack(fs)
    n = f.shape[-1]
    words = run(harness, 15, 0, f, FROB, shape=(12, FE.WORDS, n), buckets=3)
    assert (words.numpy().view(np.uint32)[:, -1] <= OF.P >> 352).all()
    assert values(W.words_to_digits_plain(words)) == values(fp12_stack(
        [easy_oracle(x) for x in fs]))
    t2 = FE.easy_plain(f)
    assert values(W.words_to_digits_plain(words)) == values(t2)
    got = run(harness, 16, len(FE.HARD_PROGRAM), words, PROGRAM, FROB, buckets=3)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack([OP.final_exp(x) for x in fs]))
    got = run(harness, 16, len(FE.HARD_PROGRAM), W.digits_to_words_plain(t2), PROGRAM, FROB,
              buckets=3)
    assert_value_equal(got, FE.hard_plain(t2))


def test_final_exp_chains_host_pairing_edges(harness):
    """The final exponentiation's chains on the fused pairing's edges, on
    three real Miller outputs and f = 1 (blocks of 3): FE-easy loading f as
    canonical words gives FE-easy's words on f's digits word for word;
    FE-hard storing strict limbs gives `hard_limbs_plain` (the plain
    FE-hard, then `tower_lazy.fp12_egress`) limb for limb, and the oracle's
    final_exp as strict limbs (`fp12_to_dev`)."""
    fs = miller_fs()
    f = fp12_stack(fs)
    n = f.shape[-1]
    words = run(harness, 21, 0, W.digits_to_words_plain(f), FROB, shape=(12, FE.WORDS, n),
                buckets=3)
    assert torch.equal(words, run(harness, 15, 0, f, FROB, shape=(12, FE.WORDS, n), buckets=3))
    got = run(harness, 22, len(FE.HARD_PROGRAM), words, PROGRAM, FROB, shape=(12, 24, n),
              buckets=3)
    assert torch.equal(got, FE.hard_limbs_plain(FE.easy_plain(f)))
    want = TL._flat12(CV.fp12_to_dev([OP.final_exp(x) for x in fs]))
    assert torch.equal(got, torch.stack(want))


def test_final_exp_easy_host_strict_limbs(harness):
    """FE-easy loading f as the strict engine's limbs, on three real Miller
    outputs and f = 1 (blocks of 3): word for word FE-easy on f's digits,
    and the oracle's easy part by value."""
    fs = miller_fs()
    f = fp12_stack(fs)
    n = f.shape[-1]
    limbs = W.words_to_limbs_plain(W.digits_to_words_plain(f))
    words = run(harness, 27, 0, limbs, FROB, shape=(12, FE.WORDS, n), buckets=3)
    assert torch.equal(words, run(harness, 15, 0, f, FROB, shape=(12, FE.WORDS, n), buckets=3))
    assert values(W.words_to_digits_plain(words)) == values(fp12_stack(
        [easy_oracle(x) for x in fs]))


@pytest.mark.parametrize("power", [1, 2, 3])
def test_final_exp_frobenius_host_oracle(harness, power):
    """FE-hard's FROB op (a program LOAD, FROB, OUT) on random canonical fp12
    elements against the oracle's fp12_frobenius: the constants' words in
    the right Montgomery form."""
    rng = random.Random(30 + power)
    a = [random_fp12(rng) for _ in range(N)]
    program = [FE._load(FE.T2), FE._op(FE.FROB, power), FE._op(FE.OUT)]
    got = run(harness, 16, len(program), W.digits_to_words_plain(fp12_stack(a)),
              torch.tensor(program, dtype=torch.int32).reshape(-1), FROB, buckets=BLOCK)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack([OF.fp12_frobenius(x, power) for x in a]))


def test_final_exp_easy_host_zero_norm(harness):
    """FE-easy on f = 0 beside three real Miller outputs and f = 1 (blocks
    of 3): the norm of 0 is 0, which the binary GCD inverts to 0 as the
    Fermat ladder did; word for word `easy_plain` (whose lazy inverse of 0
    is 0), the easy part of 0 being 0."""
    fs = miller_fs()
    fs.insert(1, (((0, 0),) * 3,) * 2)
    f = fp12_stack(fs)
    n = f.shape[-1]
    words = run(harness, 15, 0, f, FROB, shape=(12, FE.WORDS, n), buckets=3)
    assert torch.equal(words, W.digits_to_words_plain(FE.easy_plain(f)))
    assert not words[..., 1].any() and words[..., 0].any()


@pytest.mark.parametrize("step", ["square", "product"])
def test_final_exp_hard_step_host_oracle(harness, step):
    """One whole Granger-Scott square of FE-hard (a program LOAD, SQR 1,
    OUT) on cyclotomic elements against the oracle's fp12_sqr, and one
    whole fp12 product (LOAD of the input and of value 1, MUL, OUT) on
    random elements against its fp12_mul: each step's Fp jobs, run in
    order and in reverse, by value."""
    rng = random.Random(41)
    if step == "square":
        a = cyclotomic_elements(N)
        program = [FE._load(FE.T2), FE._op(FE.SQR, 1), FE._op(FE.OUT)]
        extra, want = (), [OF.fp12_sqr(x) for x in a]
        op = 16
    else:
        a, b = ([random_fp12(rng) for _ in range(N)] for _ in range(2))
        program = [FE._load(FE.T2, FE.T0), FE._op(FE.MUL), FE._op(FE.OUT)]
        extra, want = (fp12_words(b).reshape(-1),), [OF.fp12_mul(x, y) for x, y in zip(a, b)]
        op = 28
    args = (op, len(program), fp12_words(a), torch.tensor(program, dtype=torch.int32).reshape(-1),
            FROB, *extra)
    got = run(harness, *args, buckets=BLOCK)
    assert int(got.abs().max()) <= 4096
    assert values(got) == values(fp12_stack(want))
    assert torch.equal(run(harness, *args, buckets=-BLOCK), got)


# --- K2: the bucket addition over Fp and Fp2 (csrc/group381.cuh) -------------

KCS = {"g1": MB.KC2_G1, "g2": MB.KC2_G2}


def words_of(stack: torch.Tensor) -> torch.Tensor:
    """(k, 30, n) lazy R13 digits -> (k, 12, n) int32 words of the same field
    elements as K2 and K2-G2 hold them: canonical, Montgomery R16 (by host
    ints)."""
    k, _, n = stack.shape
    vals = [[LZ.digits_to_int(stack[i, :, j].numpy()) * R16_OVER_R13 % OF.P for j in range(n)]
            for i in range(k)]
    arr = np.array([[[(v >> (32 * t)) & 0xFFFFFFFF for v in row] for t in range(12)]
                    for row in vals], np.uint32)
    return torch.from_numpy(arr.view(np.int32))


R16_OVER_R13 = pow(2, -6, OF.P)


def add_operands(kc, seed):
    """(5 nc, 30, N) balanced R13 digits of five coordinates X1, Y1, Z1, X2,
    Y2 (nc = 1 Fp component each on G1, 2 on G2) that are field elements
    (K2 and K2-G2 take canonical values, so their case is value parity on
    the lazy engine's valid inputs): column 0 the identity bucket (0 : 1 :
    0) plus a real point, column 1 a doubling (P1 = P2, Z1 = 1), column 2 a
    cancellation (P1 = -P2), columns 3-6 the edges 0, 1, p-1 and R13 mod p
    in every component, the rest random."""
    rng = random.Random(seed)
    P = OF.P
    if kc.is_g2:
        q = OC.g2_mul(OF.G2_GEN, 5)
        x, y, negy, zero, one = [*q[0]], [*q[1]], [*OF.fp2_neg(q[1])], [0, 0], [1, 0]
    else:
        q = OC.scalar_mul(OF.G1_GEN, 5)
        x, y, negy, zero, one = [q[0]], [q[1]], [-q[1] % P], [0], [1]
    cols = [zero + one + zero + x + y, x + y + one + x + y, x + negy + one + x + y]
    rows = 5 * len(one)
    cols += [[e] * rows for e in (0, 1, P - 1, LZ.R13_MOD_P)]
    cols += [[rng.randrange(P) for _ in range(rows)] for _ in range(N - len(cols))]
    arr = np.stack([[MB.int_to_digits_balanced(v * LZ.R13 % P) for v in col] for col in cols])
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(1, 2, 0)))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_mixed_add_host(harness, curve):
    """The raw addition of K2 (over Fp) and K2-G2 (over Fp2), on 32-bit
    words, by value against the lazy addition on the field elements of
    `add_operands`: the identity bucket, a doubling, a cancellation, the
    edges 0, 1, p-1 and R13 mod p, random values."""
    kc = KCS[curve]
    nc = 2 if kc.is_g2 else 1
    x = add_operands(kc, 6)
    coords = [tuple(x[c * nc : (c + 1) * nc]) if kc.is_g2 else x[c] for c in range(5)]
    want = torch.stack(kc.components(LG.mixed_add(kc.f, tuple(coords[:3]), tuple(coords[3:]))))
    got = run(harness, 6 if kc.is_g2 else 5, 0, words_of(x), shape=(3 * nc, 12, N))
    assert torch.equal(got, words_of(want))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_bucket_accumulate_host(harness, curve):
    """The kernels' per-thread body (K2 and K2-G2 on the 32-bit layer) on
    real points against the plain version, dump for dump by value, its
    digits within 4096: six tiles of one window, c = 2, where tile 1
    repeats tile 0 (a doubling through the addition), tile 2 repeats it
    negated (the bucket falls back), and the other tiles are random."""
    kc, c = KCS[curve], 2
    B = MB._num_buckets(c)
    points, scalars, _ = distinct_bases(10, 3, "cpu", curve)
    pts, _ = MB._prepare_inputs(kc, points, scalars, c)
    rng = np.random.default_rng(7)
    mag = rng.integers(0, B, (6, MB.STREAMS))
    sign = rng.integers(0, 2, (6, MB.STREAMS))
    mag[1], sign[1] = mag[0], sign[0]
    mag[2], sign[2] = mag[0], 1 - sign[0]
    digs = torch.from_numpy((mag | (sign << MB.SIGN_BIT)).reshape(1, -1).astype(np.int32))
    pts = pts.repeat(1, 6).contiguous()
    want = MB.accumulate_plain(kc, pts, digs, c)
    got = run(harness, 8 if kc.is_g2 else 7, 1, MB.point_words_plain(kc, pts), digs,
              shape=(1, B, kc.pt_rows, MB.STREAMS), buckets=B)
    assert MB.max_dump_digit(got) <= 4096
    assert torch.equal(MB.dump_values(kc, got), MB.dump_values(kc, want))
