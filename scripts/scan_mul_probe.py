#!/usr/bin/env python3
"""scan-mul (`CurveOps.scalar_mul` on the card) at `MUL_SHAPE` and at other
launch shapes, on one NVIDIA card.

    python3 scripts/scan_mul_probe.py [--log-n 12] [--curves g1,g2]
                                      [--g1 6x192,6x96,...] [--g2 18x576,18x288,...]

Builds `ark_blst_tpu_torch/csrc/scan_msm.cu` from the checkout (nvcc, as
the package does), prints the card's name and power limit, then for each
curve one JSON line: the ptxas registers, stack and spills of
`mul_kernel`; 2^log_n bases of `curves/instance.py` and their scalars at
256 bits through `scalar_mul` (its `MUL_SHAPE`), then at each TEAMxBLOCK
of the curve's list (threads a team, threads a block) through the C
entry: its time (the mean of three launches after one warm-up), the
blocks an SM holds (the occupancy API), the waves of its grid and whether
its points equal the default shape's limb for limb. Needs a card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from scan_acc_probe import _ptxas  # noqa: E402
from scan_red_probe import _ms, _shape  # noqa: E402

SHAPES = {"g1": "6x192,6x96,6x384,3x96", "g2": "18x576,18x288,9x288,18x144"}
SEEDS = {"g1": 59, "g2": 60}  # chip_smoke.py's scan-mul instances
BITS = 256


def probe(torch, dev, curve_name: str, shapes: list, log_n: int, lib) -> dict:
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    curve = G2 if curve_name == "g2" else G1
    nc = 2 if curve_name == "g2" else 1
    points, scalars, _ = distinct_bases(log_n, SEEDS[curve_name], dev, curve_name)
    pts = SM.stack_point(points)
    n = pts.shape[2]
    want = SM.stack_point(curve.scalar_mul(points, scalars, BITS))
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(team, block):
        out = torch.empty_like(pts)
        SM.KERNEL_MUL.launch(pts.data_ptr(), scalars.data_ptr(), out.data_ptr(), n, BITS, nc,
                             team, block, stream)
        return out

    lines = []
    for team, block in shapes:
        got = run(team, block)
        per_sm = _shape(lib, 5, nc, team, block, 0)
        blocks = -(-n // (block // team))
        lines.append({"team": team, "block": block, "blocks": blocks, "blocks_per_sm": per_sm,
                      "waves": blocks / (sms * max(per_sm, 1)),
                      "equal_to_default": bool(torch.equal(got, want)),
                      "ms": _ms(torch, lambda: run(team, block))})
    suffix = "IN4f3813Fp2E" if nc == 2 else "IN4f3812FpE"
    return {"curve": curve_name, "n": n, "num_bits": BITS, "default": SM.MUL_SHAPE[nc],
            "ptxas": _ptxas(SM.KERNEL_MUL.build_log, "mul_kernel" + suffix), "shapes": lines}


def main() -> int:
    import ctypes

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=12)
    ap.add_argument("--curves", default="g1,g2")
    for curve in ("g1", "g2"):
        ap.add_argument(f"--{curve}", default=SHAPES[curve])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_mul_probe: CUDA is not available", file=sys.stderr)
        return 1
    from ark_blst_tpu_torch.ops import scan_msm as SM

    dev = torch.device("cuda", 0)
    SM.KERNEL_MUL.build()
    lib = ctypes.CDLL(str(SM.KERNEL_MUL.lib_path))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for curve in args.curves.split(","):
        shapes = [tuple(int(v) for v in s.split("x")) for s in getattr(args, curve).split(",") if s]
        print(json.dumps(probe(torch, dev, curve, shapes, args.log_n, lib)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
