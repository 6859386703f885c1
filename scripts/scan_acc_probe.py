#!/usr/bin/env python3
"""scan-acc's launches on one NVIDIA card, at the scan MSM's main-path
widths and at other team and block shapes of its walk.

    python3 scripts/scan_acc_probe.py [--curves g1,g2]
                                      [--g1 6x96,1x64,...] [--g2 18x288,...]
                                      [--straight 32,64,128]

Builds `ark_blst_tpu_torch/csrc/scan_msm.cu` from the checkout (nvcc, as
the package does), prints the card's name and power limit, then for each
curve one JSON line: the instance as chip_smoke.py builds it (G1 2^20
points, 1,024 lanes, seed 17; G2 2^18, 256 lanes, seed 19; c = 8), the
ptxas registers, stack and spills of the walk, the point words and the
split, and the time of each launch (CUDA events, the mean of two launches
after one warm-up): the point words, the split, and the walk at each
TEAMxBLOCK shape of the curve's list (threads a team x threads a block),
with the blocks an SM holds (the occupancy API), the waves of its grid,
and whether its bucket records equal the default shape's (`ACC_SHAPE`)
word for word; the walk with one thread a stream and the complete
addition written straight through (`scripts/scan_acc_straight.cu`, built
here with the package's nvcc flags) at each block size of `--straight`,
held and reported the same way: the team walk's job interpreter against
the addition's own arithmetic; and the walk at the default shape with
every digit 0 (each stream's steps on one bucket, its record in cache:
the walk without its bucket traffic).
The whole scan-acc (`bucket_accumulate`) is timed at full width and at
chip_smoke.py's check size (G1 2^14 points, G2 2^12, 16 additions a
stream), and held there against `bucket_accumulate_plain` limb for limb;
from the two times, the fixed cost and the time a step. Needs a card;
imports no JAX.
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

# curve: (log2 points, lanes, seed) at full width and at the check size
FULL = {"g1": (20, 1024, 17), "g2": (18, 256, 19)}
CHECK = {"g1": (14, 1024, 47), "g2": (12, 256, 53)}
C = 8
SHAPES = {"g1": "3x96,1x64,2x64,6x96,3x96",
          "g2": "18x288,1x32,1x64,2x64,3x96,6x96,9x288,18x288"}
STRAIGHT = Path(__file__).resolve().parent / "scan_acc_straight.cu"


def _ptxas(log: str, fragment: str) -> dict:
    """Registers, stack frame and spill bytes of the kernel entry whose
    mangled name holds `fragment`, from an `nvcc -Xptxas -v` log."""
    out, cur = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        if fragment not in cur:
            continue
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            out.update(stack_frame=int(parts[0]), spill_store_bytes=int(parts[4]),
                       spill_load_bytes=int(parts[8]))
        if "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split("registers")[0])
    return out


def _ms(torch, fn, reps: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _build_straight():
    """nvcc scan_acc_straight.cu with the package's flags into the package's
    build directory; returns (its library, its nvcc/ptxas log)."""
    from ark_blst_tpu_torch import cuda as KC

    h = hashlib.sha256(" ".join(KC.NVCC_FLAGS).encode())
    for f in sorted(KC.CSRC_DIR.glob("*.cuh")) + [STRAIGHT]:
        h.update(f.read_bytes())
    lib = KC.BUILD_DIR / f"scan_acc_straight-{h.hexdigest()[:12]}.so"
    KC.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([KC._nvcc(), *KC.NVCC_FLAGS, "-I", str(KC.CSRC_DIR), "-o", str(lib),
                           str(STRAIGHT)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {STRAIGHT.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def _walk(torch, SM, pw, digits, lanes: int, c: int, team: int, block: int):
    """scan-acc's walk at (team, block) through its C entry (the wrapper
    launches it at `ACC_SHAPE`): the bucket records."""
    nc = pw.shape[1] // SM.RECORD
    bk = torch.empty((lanes * digits.shape[0] << c, pw.shape[1]), dtype=torch.int32,
                     device=pw.device)
    SM.KERNEL_ACC.launch(pw.data_ptr(), digits.data_ptr(), bk.data_ptr(), pw.shape[0], lanes,
                         digits.shape[0], 1 << c, nc, team, block,
                         torch.cuda.current_stream(pw.device).cuda_stream)
    return bk


def _straight(torch, slib, pw, digits, lanes: int, c: int, block: int):
    """The straight-line walk of scan_acc_straight.cu, `block` streams a
    block: the bucket records."""
    from ark_blst_tpu_torch.ops import scan_msm as SM

    fn = slib.scan_acc_straight
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bk = torch.empty((lanes * digits.shape[0] << c, pw.shape[1]), dtype=torch.int32,
                     device=pw.device)
    err = fn(pw.data_ptr(), digits.data_ptr(), bk.data_ptr(), pw.shape[0], lanes,
             digits.shape[0], 1 << c, pw.shape[1] // SM.RECORD, block,
             torch.cuda.current_stream(pw.device).cuda_stream)
    if err:
        raise RuntimeError(f"scan_acc_straight: CUDA error {err}")
    return bk


def _blocks_per_sm(lib, nc: int, team: int, block: int) -> int:
    fn = lib.scan_msm_shape
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(0, nc, team, block, 0, ctypes.byref(threads), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"scan_msm_shape: CUDA error {err}")
    return per_sm.value


def probe(torch, dev, curve_name: str, shapes: list, lib, log: str, straight: list, slib,
          slog: str) -> dict:
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    curve = G2 if curve_name == "g2" else G1
    nc = 2 if curve_name == "g2" else 1
    suffix = "IN4f3813Fp2E" if nc == 2 else "IN4f3812FpE"
    res = {"curve": curve_name, "c": C,
           "ptxas": {k: _ptxas(log, k + suffix)
                     for k in ("walk_kernel", "words_kernel", "split_kernel")},
           "straight_ptxas": _ptxas(slog, "straight_kernel" + suffix)}

    log_n, lanes, seed = CHECK[curve_name]
    points, scalars, _ = distinct_bases(log_n, seed, dev, curve_name)
    digits = M.window_digits(scalars, C)
    want = SM.stack_point(SM.bucket_accumulate_plain(curve, points, digits, lanes, C))
    got = SM.stack_point(SM.bucket_accumulate(curve, points, digits, lanes, C))
    check_ms = _ms(torch, lambda: SM.bucket_accumulate(curve, points, digits, lanes, C))
    res["check"] = {"n": scalars.shape[1], "lanes": lanes, "steps": scalars.shape[1] // lanes,
                    "equal_to_plain": bool(torch.equal(got, want)), "ms": check_ms}

    log_n, lanes, seed = FULL[curve_name]
    points, scalars, _ = distinct_bases(log_n, seed, dev, curve_name)
    digits = M.window_digits(scalars, C)
    n, W, B = scalars.shape[1], digits.shape[0], 1 << C
    pts = SM.stack_point(points)
    pw = SM.point_words(pts)
    ref = SM.accumulate_words(curve, pw, digits, lanes, C)
    bk_bytes = ref.numel() * 4
    res.update(n=n, lanes=lanes, steps=n // lanes, scratch_bytes=bk_bytes,
               words_ms=_ms(torch, lambda: SM.point_words(pts)),
               split_ms=_ms(torch, lambda: SM.split_buckets(ref, lanes, W, B)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    walks = []
    for team, block in shapes:
        bk = _walk(torch, SM, pw, digits, lanes, C, team, block)
        per_sm = _blocks_per_sm(lib, nc, team, block)
        grid = -(-lanes * W // (block // team))
        walks.append({"team": team, "block": block, "blocks_per_sm": per_sm,
                      "waves": grid / (sms * max(per_sm, 1)),
                      "equal_to_default": bool(torch.equal(bk, ref)),
                      "ms": _ms(torch, lambda: _walk(torch, SM, pw, digits, lanes, C, team,
                                                     block))})
        del bk
    res["walk"] = walks
    lines = []
    occ = slib.scan_acc_straight_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for block in straight:
        bk = _straight(torch, slib, pw, digits, lanes, C, block)
        per_sm = ctypes.c_int()
        if occ(nc, block, ctypes.byref(per_sm)):
            raise RuntimeError("scan_acc_straight_occupancy failed")
        lines.append({"block": block, "blocks_per_sm": per_sm.value,
                      "waves": -(-lanes * W // block) / (sms * max(per_sm.value, 1)),
                      "equal_to_default": bool(torch.equal(bk, ref)),
                      "ms": _ms(torch, lambda: _straight(torch, slib, pw, digits, lanes, C,
                                                         block))})
        del bk
    res["straight"] = lines
    # every digit 0: each stream's steps hit one bucket, its record in cache
    zeros = torch.zeros_like(digits)
    res["walk_zero_digits_ms"] = _ms(torch, lambda: SM.accumulate_words(curve, pw, zeros, lanes,
                                                                         C))
    del ref
    torch.cuda.empty_cache()
    full_ms = _ms(torch, lambda: SM.bucket_accumulate(curve, points, digits, lanes, C))
    steps_full, steps_check = n // lanes, res["check"]["steps"]
    per_step = (full_ms - check_ms) / (steps_full - steps_check)
    res.update(ms=full_ms, per_step_ms=per_step, fixed_ms=check_ms - steps_check * per_step)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--curves", default="g1,g2")
    ap.add_argument("--g1", default=SHAPES["g1"])
    ap.add_argument("--g2", default=SHAPES["g2"])
    ap.add_argument("--straight", default="32,64,128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_acc_probe: CUDA is not available", file=sys.stderr)
        return 1
    from ark_blst_tpu_torch.ops import scan_msm as SM

    dev = torch.device("cuda", 0)
    SM.KERNEL_ACC.build()
    lib = ctypes.CDLL(str(SM.KERNEL_ACC.lib_path))
    slib, slog = _build_straight()
    straight = [int(b) for b in args.straight.split(",") if b]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for curve in args.curves.split(","):
        shapes = [tuple(int(v) for v in s.split("x")) for s in getattr(args, curve).split(",")]
        print(json.dumps(probe(torch, dev, curve, shapes, lib, SM.KERNEL_ACC.build_log,
                               straight, slib, slog)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
