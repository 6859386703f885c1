#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ark_blst_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds and runs its main path there.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env      the card's name and power limit; builds every kernel of the
              path from the sources (one nvcc per source, in parallel) and
              reports build seconds, registers and spills;
  2. k1       K1 (mont_mul) against its plain PyTorch version at 2^22
              elements, bit for bit, random and extreme digit patterns;
  3. k2       K2 (bucket accumulation) against its plain version at the
              main path's inputs (2^22 points, c=7, W=37), bucket for bucket;
  4. msm      the G1 MSM at 2^22 distinct bases with c=7 (built on the card
              by `curves/instance.py`, with an identity point and a zero
              scalar in the stream) through the public entry point
              `msm_g1`, checked against the expected point, with the launch
              counts of that run and its points/s; then the four stages
              rerun one by one with a synchronize between them, once for
              the stage times and once under `torch.profiler` for each
              stage's device time, kernel launches and device busy share;
then the `kernels` line (time, launches, bound and plain time per kernel)
and, last, {"ok": true, "device": {...}}. Any failure raises: the script
then exits non-zero and prints no last line. Without CUDA it exits 1.

Bound model (bound_ms): the larger of bytes / 3.35e12 B/s and int32
instructions / 33.5e12 per s. The instruction rate is the float32 rate of
the H100's data sheet (67 TFLOP/s, an FMA counted as two) in instructions:
132 SMs x 128 lanes x 1.98 GHz, one instruction per lane per clock, i.e.
the issue ceiling with the IMAD and integer-ALU pipes both busy.
Instruction counts follow the kernels' straight-line code: a digit product
or multiply-add is one, a balanced fold four per digit (add, and, add3,
shift). K1's bytes read each input once and write the output once; K2's
also count its scattered traffic, one bucket read and write and one point
read per bucket add. Beside the bound each kernel line gives the IMAD-pipe
floor: the IMAD instructions of the compiled kernel (`cuobjdump -sass`,
static count; both kernels are straight-line code around their loops)
over 132 SMs x 64 per clock x 1.98 GHz = 16.7e12 per s.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
IMAD_PER_S = 132 * 64 * 1.98e9
LOG_N = 22
C = 7
SEED = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --- operation counts of the kernels' code (per element / per bucket add) ----

def _fold(n: int) -> int:  # add, and, add3, shift per digit
    return 4 * n


_MUL_COLS = 30 * 30
_PRERED = _MUL_COLS + _fold(59) + _fold(60)
_REDUCE = _fold(61) + 30 * 31 // 2 + _fold(30) + _fold(31) + _MUL_COLS + _fold(62) + _fold(63)
MONT_MUL_OPS = _PRERED + _REDUCE
_FOLD_SUM = _fold(30)
MIXED_ADD_OPS = (
    5 * MONT_MUL_OPS + 2 * (30 + _FOLD_SUM)  # round 1 and its two folded sums
    + 8 * 30 + 7 * _FOLD_SUM  # the linear glue between the rounds
    + 6 * _PRERED + 3 * 61 + 3 * _REDUCE  # round 2 and its three reductions
)
BUCKET_ADD_OPS = MIXED_ADD_OPS + 75 * 4 + 3 * (_fold(30) + _fold(31)) + 45 * 4  # + unpack/store/pack


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_summary(log: str) -> dict:
    out = {}
    for line in log.splitlines():
        if "registers" in line:
            out["registers"] = int(line.split("Used")[1].split("registers")[0])
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            out["stack_bytes"] = int(parts[0])
            out["spill_store_bytes"] = int(parts[4])
            out["spill_load_bytes"] = int(parts[8])
    return out


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _sass_counts(kernel) -> dict:
    """Static instruction counts of a built kernel library: all but NOPs,
    the IMAD family, and of it the IMAD.MOV register moves."""
    from ark_blst_tpu_torch import cuda as KC

    cuobjdump = os.path.join(os.path.dirname(KC._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel.lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = [m.group(1) for m in _SASS_OP.finditer(sass)]
    ops = [op for op in ops if op != "NOP"]
    return {"instructions": len(ops), "imad": sum(op.startswith("IMAD") for op in ops),
            "imad_mov": sum(op.startswith("IMAD.MOV") for op in ops)}


def imad_floor_ms(imads: float) -> float:
    return 1e3 * imads / IMAD_PER_S


# --- phases --------------------------------------------------------------------

def phase_env(torch):
    from ark_blst_tpu_torch import cuda as KC
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.ops import mont_mul as MM

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    KC.build_all([MM.KERNEL, MB.KERNEL])
    build_s = time.perf_counter() - t0
    sass = {k.source: _sass_counts(k) for k in (MM.KERNEL, MB.KERNEL)}
    emit({
        "phase": "env", "gpu": smi[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": {k.source: _ptxas_summary(k.build_log) for k in (MM.KERNEL, MB.KERNEL)},
        "sass": sass,
    })
    return sass


def phase_k1(torch, dev, sass: dict) -> dict:
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.ops import mont_mul as MM

    n, F = 1 << LOG_N, LZ.F_BOUND
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randint(-F, F + 1, (30, n), generator=g, device=dev, dtype=torch.int32)
    b = torch.randint(-F, F + 1, (30, n), generator=g, device=dev, dtype=torch.int32)

    def col(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    alt = [F if k % 2 else -F for k in range(30)]
    edge = [int(v) for v in LZ.int_to_digits((LZ.R13 >> 1) - 1)]
    cases = [
        ([F] * 30, [F] * 30), ([-F] * 30, [-F] * 30),  # all +4129, all -4129
        ([8191] * 30, [8191] * 30), (edge, edge),  # canonical maxima, the R13/2 edge
        (alt, [F] * 30), (alt, alt),
        ([0] * 29 + [F], [F] * 30), ([F] + [0] * 29, [F] + [0] * 29),
    ]
    for i, (x, y) in enumerate(cases):
        a[:, i], b[:, i] = col(x), col(y)
    got = MM.mont_mul(a, b)
    want = MM.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and torch.equal(got, want), "K1 differs from its plain version")
    ms = cuda_ms(torch, lambda: MM.mont_mul(a, b), 10)
    plain_ms = cuda_ms(torch, lambda: MM.mont_mul_plain(a, b), 2)
    bms, by = bound_ms(n * 3 * 30 * 4, n * MONT_MUL_OPS)
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    emit({"phase": "k1", "n": n, "extreme_cases": len(cases), "bit_equal": True, **res,
          "imad_floor_ms": imad_floor_ms(n * sass["imad"])})
    del a, b, got, want
    torch.cuda.empty_cache()
    return res


def phase_k2(torch, pts, digs, sass: dict) -> dict:
    from ark_blst_tpu_torch.curves import msm_bucket as MB

    got = MB.accumulate(pts, digs, C)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = MB.accumulate_plain(pts, digs, C)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and torch.equal(got, want), "K2 differs from its plain version")
    del want
    ms = cuda_ms(torch, lambda: MB.accumulate(pts, digs, C), 2)
    W, n = digs.shape
    B = MB._num_buckets(C)
    adds = int(((digs & MB.MAG_MASK) != 0).sum())
    negs = int((((digs >> MB.SIGN_BIT) & 1) != 0).sum())
    bytes_once = (pts.numel() + digs.numel() + W * B * MB.PT_ROWS * MB.STREAMS) * 4
    scattered = adds * (2 * MB.PT_ROWS + MB.AFF_ROWS) * 4  # bucket read + write, point read
    bms, by = bound_ms(bytes_once + scattered, adds * BUCKET_ADD_OPS + negs * 30)
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    emit({"phase": "k2", "n": n, "windows": W, "buckets": B, "adds": adds,
          "buckets_equal": True, **res, "bytes_once": bytes_once, "bytes_scattered": scattered,
          "bytes_ms": 1e3 * (bytes_once + scattered) / HBM_BYTES_PER_S,
          "imad_floor_ms": imad_floor_ms(adds * sass["imad"])})
    return res


def phase_msm(torch, dev, points, scalars, expected) -> dict:
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import mont_mul as MM

    n = scalars.shape[1]
    kernels = (MM.KERNEL, MB.KERNEL)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = T.msm_g1(points, scalars, device=dev, c=C)  # the main path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    check(all(x.shape == (24, 1) and x.device == dev for x in out), "result shape")
    check(CV.g1_from_dev(out) == [expected], "G1 MSM result differs from the expected point")
    check(all(x > 0 for x in launches), f"a kernel of the path was not launched: {launches}")

    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stages = {}
    for name, summary in run_stages(torch, points, scalars, expected, profiled=False):
        stages[name + "_ms"] = summary["wall_ms"]
    profiled = dict(run_stages(torch, points, scalars, expected, profiled=True))
    wall = sum(p["wall_ms"] for p in profiled.values())
    device = sum(p["device_ms"] for p in profiled.values())
    emit({"phase": "msm", "n": n, "c": C, "ok": True, "seconds": dt, "points_per_s": n / dt,
          "launches": {"mont_mul": launches[0], "bucket_accumulate": launches[1]},
          "stages": stages, "peak_mem_gib": peak_gib})
    emit({"phase": "msm_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return {"mont_mul": launches[0], "bucket_accumulate": launches[1]}


def run_stages(torch, points, scalars, expected, profiled: bool):
    """The MSM's four stages one by one, each ended by a synchronize; yields
    (stage, summary) with the stage's host-clock time and, when profiled,
    the device time of its kernels, their number, the device busy share and
    the three kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.ops import convert as CV

    def device_us(evt):
        return float(getattr(evt, "self_device_time_total", 0.0))

    def stage(fn):
        torch.cuda.synchronize()
        if not profiled:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, {"wall_ms": 1e3 * (time.perf_counter() - t0)}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(device_us(e) for e in kernels) / 1e3
        check(device_ms > 0, "the profiler saw no device time")
        top = sorted(kernels, key=device_us, reverse=True)[:3]
        return out, {
            "wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_launches": sum(e.count for e in kernels), "busy_share": device_ms / wall_ms,
            "top": [{"kernel": e.key[:60], "count": e.count, "device_ms": device_us(e) / 1e3}
                    for e in top],
        }

    (pts, digs), summary = stage(lambda: MB._prepare_inputs(points, scalars, C))
    yield "prepare", summary
    dump, summary = stage(lambda: MB.accumulate(pts, digs, C))
    yield "k2", summary
    ws, summary = stage(lambda: MB._reduce_dump(dump))
    yield "reduce", summary
    out, summary = stage(lambda: MB._finish_host(ws, C))
    yield "finish", summary
    check(CV.g1_from_dev(out) == [expected], "staged MSM result differs")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sass = phase_env(torch)
    k1 = phase_k1(torch, dev, sass["mont_mul.cu"])

    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    t0 = time.perf_counter()
    points, scalars, expected = distinct_bases(LOG_N, SEED, dev)
    torch.cuda.synchronize()
    emit({"phase": "instance", "n": scalars.shape[1], "seconds": time.perf_counter() - t0})
    pts, digs = MB._prepare_inputs(points, scalars, C)
    k2 = phase_k2(torch, pts, digs, sass["bucket_accumulate.cu"])
    del pts, digs
    torch.cuda.empty_cache()
    launches = phase_msm(torch, dev, points, scalars, expected)

    emit({"kernels": [
        {"name": "mont_mul", "route": "cuda", "source": "ark_blst_tpu_torch/csrc/mont_mul.cu",
         "replaces": "ark_blst_tpu/ops/pallas_lazy.py:41", "launches": launches["mont_mul"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "bucket_accumulate", "route": "cuda",
         "source": "ark_blst_tpu_torch/csrc/bucket_accumulate.cu",
         "replaces": "ark_blst_tpu/curves/msm_pallas2.py:359",
         "launches": launches["bucket_accumulate"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
