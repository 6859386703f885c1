#!/usr/bin/env python3
"""scan-red and scan-horner on one NVIDIA card, at the scan MSM's shapes
(c = 8: W = 32 windows of B = 256 buckets) and at other launch shapes,
beside the latencies that bound a chain.

    python3 scripts/scan_red_probe.py [--curves g1,g2]
                                      [--red-g1 12x192x128,...] [--red-g2 36x384x128,...]
                                      [--horner-g1 6x192,...] [--horner-g2 18x384,...]

Builds `ark_blst_tpu_torch/csrc/scan_msm.cu` from the checkout (nvcc, as
the package does) and `scripts/chain_latency.cu` (the package's nvcc
flags), prints the card's name and power limit, then one JSON line of
latencies: one thread's chain of 256 and of 4,096 dependent Fp products
(`csrc/fp381.cuh` mont_mul) and of modular sums, each one's time (CUDA
events), and a block's barrier after a shared-memory store, at 32 and 64
threads. Then for each curve one JSON line: the ptxas registers, stack and
spills of `reduce_kernel` and `horner_kernel`; scan-red on 32 x 256
buckets (points of `curves/instance.py`) at its `RED_SHAPE` held against
`bucket_reduce_plain` limb for limb, then at each TEAMxBLOCKxCOLUMN shape
of the curve's list (threads that take the products, threads a block,
buckets the block's column holds) through its C entry:
its time (the mean of three launches after one warm-up), the blocks an SM
holds (the occupancy API) and whether its window sums equal the
default's limb for limb; scan-horner on those 32 sums at c = 8 likewise
at each TEAMxBLOCK of its list, its default held against `horner_plain`. Each
walk's latency floor is beside its time: its dependent product layers
(scan-red 2 a step over B steps, scan-horner 2 a group operation over W
(c + 1)) times the measured product latency. Last, each walk at its
default shape under `scripts/scan_chain_clocks.cu` (the same bodies,
block 0's SM clocks a phase): the clocks by phase kind (products, sums,
the column's refills), and with their sums on the products' threads (a
block of `team`).
Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from scan_acc_probe import _ptxas  # noqa: E402

W, B, C = 32, 256, 8
RED = {"g1": "12x192x128,12x192x256,12x192x32,12x12x128,12x96x128,12x256x128,6x192x128,"
              "24x192x128",
       "g2": "36x192x128,36x192x256,36x192x32,36x36x128,36x256x128,36x96x128,18x192x128,"
              "48x192x128"}
HORNER = {"g1": "6x192,6x6,6x128,4x192,12x192,3x192",
          "g2": "18x256,18x18,18x192,12x256,36x256,6x256"}
LATENCY = Path(__file__).resolve().parent / "chain_latency.cu"
CLOCKS = Path(__file__).resolve().parent / "scan_chain_clocks.cu"
PHASES = {1: ("P1", "L1", "P2", "L2"), 2: ("P1", "L0", "L1", "P2", "L2")}


def _ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _build(src: Path):
    """nvcc a probe source beside this script with the package's flags into
    the package's build directory; returns its library."""
    from ark_blst_tpu_torch import cuda as KC

    h = hashlib.sha256(" ".join(KC.NVCC_FLAGS).encode())
    for f in sorted(KC.CSRC_DIR.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    lib = KC.BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"
    KC.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([KC._nvcc(), *KC.NVCC_FLAGS, "-I", str(KC.CSRC_DIR), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def phase_clocks(torch, clib, which: int, inp, out, W: int, n: int, nc: int, team: int,
                 block: int, column: int, kinds: list) -> dict:
    """One walk under scan_chain_clocks.cu: block 0's SM clocks a phase,
    summed and averaged by phase kind (`kinds`, the walk's phases in
    order), with each kind's share of the walk's clocks."""
    fn = clib.scan_chain_clocks
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    clocks = torch.zeros(len(kinds), dtype=torch.int64, device=inp.device)
    err = fn(which, inp.data_ptr(), out.data_ptr(), W, n, nc, team, block, column,
             clocks.data_ptr(), len(kinds), torch.cuda.current_stream(inp.device).cuda_stream)
    if err:
        raise RuntimeError(f"scan_chain_clocks: CUDA error {err}")
    torch.cuda.synchronize()
    total = int(clocks.sum())
    by = {}
    for kind, cyc in zip(kinds, clocks.tolist()):
        k = by.setdefault(kind, {"count": 0, "clocks": 0})
        k["count"] += 1
        k["clocks"] += cyc
    for k in by.values():
        k.update(mean=k["clocks"] / k["count"], share=k["clocks"] / total)
    return {"team": team, "block": block, "column": column, "clocks": total, "by_phase": by}


def red_kinds(nc: int, column: int) -> list:
    kinds = []
    for k in range(B):
        if k % column == 0:
            kinds.append("refill" if k else "init")
        kinds += PHASES[nc]
    return kinds + ["store"]


def horner_kinds(nc: int) -> list:
    kinds = ["init"]
    for _ in range(W):
        for d in range(C + 1):
            kinds += [("add " if d == C else "dbl ") + p for p in PHASES[nc]]
    return kinds + ["store"]


def latencies(torch, dev, lib) -> dict:
    """ms of one thread's chains of dependent products and sums, and of a
    block's barriers; a step's latency from two chain lengths."""
    fn = lib.chain_latency
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    seed = torch.tensor([(0x12345 * (k + 1)) & 0x7FFFFFFF for k in range(24)],
                        dtype=torch.int32, device=dev)
    seed[11] = seed[23] = 0x01234567  # both below p
    out = torch.empty(256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(mode: int, n: int, threads: int = 1) -> float:
        def run():
            err = fn(mode, n, threads, seed.data_ptr(), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"chain_latency: CUDA error {err}")
        return _ms(torch, run)

    res = {}
    for name, mode, threads in (("mont_mul", 0, 1), ("add", 1, 1), ("barrier_32", 2, 32),
                                ("barrier_64", 2, 64)):
        short, long_ = chain(mode, 256, threads), chain(mode, 4096, threads)
        res[name] = {"ms_256": short, "ms_4096": long_, "us_each": (long_ - short) / 3840 * 1e3}
    return res


def _shape(lib, kind: int, nc: int, team: int, block: int, records: int) -> int:
    fn = lib.scan_msm_shape
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(kind, nc, team, block, records, ctypes.byref(threads), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"scan_msm_shape: CUDA error {err}")
    return per_sm.value


def probe(torch, dev, curve_name: str, red: list, horner: list, lib, log: str,
          product_us: float, clib) -> dict:
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    curve = G2 if curve_name == "g2" else G1
    nc = 2 if curve_name == "g2" else 1
    suffix = "IN4f3813Fp2E" if nc == 2 else "IN4f3812FpE"
    stream = torch.cuda.current_stream(dev).cuda_stream
    points, _, _ = distinct_bases(13, 23, dev, curve_name)
    bk = SM.stack_point(points).reshape(-1, 24, W, B).contiguous()
    want = SM.stack_point(SM.bucket_reduce(curve, SM.point_of(bk)))
    plain = SM.stack_point(SM.bucket_reduce_plain(curve, SM.point_of(bk)))
    red_floor = 2 * B * product_us / 1e3
    res = {"curve": curve_name, "W": W, "B": B, "c": C,
           "ptxas": {k: _ptxas(log, k + suffix) for k in ("reduce_kernel", "horner_kernel")},
           "red_default": {"shape": SM.RED_SHAPE[nc], "equal_to_plain": bool(torch.equal(want,
                                                                                       plain))},
           "red_latency_floor_ms": red_floor}

    def red_run(team, block, column):
        got = torch.empty_like(want)
        SM.KERNEL_RED.launch(bk.data_ptr(), got.data_ptr(), W, B, nc, team, block, column,
                             stream)
        return got

    lines = []
    for team, block, column in red:
        got = red_run(team, block, column)
        ms = _ms(torch, lambda: red_run(team, block, column))
        lines.append({"team": team, "block": block, "column": column,
                      "blocks_per_sm": _shape(lib, 1, nc, team, block, column),
                      "equal_to_default": bool(torch.equal(got, want)), "ms": ms,
                      "us_a_step": ms / B * 1e3, "of_floor": ms / red_floor})
    res["red"] = lines

    sums = want.contiguous()
    hwant = SM.stack_point(SM.horner(curve, SM.point_of(sums), C))
    hplain = SM.stack_point(SM.horner_plain(curve, SM.point_of(sums), C))
    ops = W * (C + 1)
    horner_floor = 2 * ops * product_us / 1e3
    res.update(horner_default={"shape": SM.HORNER_SHAPE[nc],
                               "equal_to_plain": bool(torch.equal(hwant, hplain))},
               horner_latency_floor_ms=horner_floor)

    def horner_run(team, block):
        got = torch.empty_like(hwant)
        SM.KERNEL_HORNER.launch(sums.data_ptr(), got.data_ptr(), W, C, nc, team, block, stream)
        return got

    lines = []
    for team, block in horner:
        got = horner_run(team, block)
        ms = _ms(torch, lambda: horner_run(team, block))
        lines.append({"team": team, "block": block,
                      "blocks_per_sm": _shape(lib, 2, nc, team, block, W),
                      "equal_to_default": bool(torch.equal(got, hwant)), "ms": ms,
                      "us_an_operation": ms / ops * 1e3, "of_floor": ms / horner_floor})
    res["horner"] = lines
    # each walk's clocks by phase at its default shape (scan-red also with
    # its buckets converted as jobs)
    team, block, column = SM.RED_SHAPE[nc]
    out = torch.empty_like(want)
    res["red_clocks"] = [phase_clocks(torch, clib, 0, bk, out, W, B, nc, team, blk, column,
                                      red_kinds(nc, column)) for blk in (block, team)]
    hout = torch.empty_like(hwant)
    team, block = SM.HORNER_SHAPE[nc]
    res["horner_clocks"] = [phase_clocks(torch, clib, 1, sums, hout, W, C, nc, team, blk, 0,
                                         horner_kinds(nc)) for blk in (block, team)]
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--curves", default="g1,g2")
    for curve in ("g1", "g2"):
        ap.add_argument(f"--red-{curve}", default=RED[curve])
        ap.add_argument(f"--horner-{curve}", default=HORNER[curve])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_red_probe: CUDA is not available", file=sys.stderr)
        return 1
    from ark_blst_tpu_torch.ops import scan_msm as SM

    dev = torch.device("cuda", 0)
    SM.KERNEL_RED.build()
    lib = ctypes.CDLL(str(SM.KERNEL_RED.lib_path))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    lat = latencies(torch, dev, _build(LATENCY))
    print(json.dumps({"latency": lat}), flush=True)
    clib = _build(CLOCKS)
    for curve in args.curves.split(","):
        red = [tuple(int(v) for v in s.split("x"))
               for s in getattr(args, f"red_{curve}").split(",") if s]
        horner = [tuple(int(v) for v in s.split("x"))
                  for s in getattr(args, f"horner_{curve}").split(",") if s]
        print(json.dumps(probe(torch, dev, curve, red, horner, lib, SM.KERNEL_RED.build_log,
                               lat["mont_mul"]["us_each"], clib)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
