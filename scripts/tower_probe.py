#!/usr/bin/env python3
"""K3 (`ark_blst_tpu_torch/csrc/cyc_sqr.cu`) and K6 (`csrc/miller_step.cu`)
at other launch shapes, on one NVIDIA card: each shape is E elements and T
threads a block (`tower_cyc_sqr_shaped`, `pairing_miller_step_shaped`; the
shape is an argument of the kernel, so the probe changes no code), and
K6's edges alone (the conversions of its 20 input and 12 output Fp
components, `edges_only`).

    python3 scripts/tower_probe.py [--k3 32x288,16x144] [--k6 32x256,16x128]

Builds the two kernels from the checkout's sources (`cuda.build_all`), makes
the pairing batch's inputs as chip_smoke.py makes them (N = 8192 random
mul-ready digits, seed 7; K6's top digit bounded), and prints the card's
name and power limit, then one JSON line per shape: the blocks an SM holds
(the occupancy API at the compiled registers and the shape's shared
memory), the grid's waves, the time (the mean of three launches after one
warm-up, CUDA events) of K3 at n = 1 and n = 32 squares or K6 with and
without the square, and whether the output equals the default shape's bit
for bit (every shape computes the same words). Needs a card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N, SEED = 8192, 7
K3_SHAPES = "32x288,32x96,32x192,16x144,16x288,64x288"
K6_SHAPES = "32x256,32x128,32x480,16x128,16x240,64x512"


def _shapes(arg: str) -> list:
    return [tuple(int(v) for v in s.split("x")) for s in arg.split(",") if s]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tower_probe: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--k3", default=K3_SHAPES)
    ap.add_argument("--k6", default=K6_SHAPES)
    args = ap.parse_args()

    import chip_smoke as CS
    from ark_blst_tpu_torch import cuda as KC
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import cyc_sqr as K3
    from ark_blst_tpu_torch.ops import lazy13 as LZ

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    KC.build_all([K3.KERNEL, PS.MILLER_KERNEL])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    ptxas = {k.source: CS._ptxas_summary(k.build_log) for k in (K3.KERNEL, PS.MILLER_KERNEL)}
    print(json.dumps({"ptxas": ptxas}), flush=True)

    x, f, c, pxy = CS.digit_stacks(torch, dev, [12, 12, 6, 2])
    for t in (f, c, pxy):  # K6's operands below 8p, as chip_smoke.py's k6 phase
        t[:, 29, :] = torch.randint(-100, 101, (t.shape[0], N), device=dev, dtype=torch.int32)

    def lib(kernel, name, argtypes):
        fn = getattr(ctypes.CDLL(str(kernel.lib_path)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    k3 = lib(K3.KERNEL, "tower_cyc_sqr_shaped", [vp, vp, i64, i32, i32, i32, vp])
    k6 = lib(PS.MILLER_KERNEL, "pairing_miller_step_shaped",
             [vp, vp, vp, vp, i64, i32, i32, i32, i32, vp])
    occ = {k: lib(kernel, kernel.symbol + "_shape", [ctypes.POINTER(ctypes.c_int)] * 4)
           for k, kernel in (("k3", K3.KERNEL), ("k6", PS.MILLER_KERNEL))}

    def occupancy(which, E, T):
        vals = [ctypes.c_int(E), ctypes.c_int(T), ctypes.c_int(), ctypes.c_int()]
        err = occ[which](*(ctypes.byref(v) for v in vals))
        return {"smem_bytes": vals[2].value, "blocks_per_sm": vals[3].value, "error": err}

    def launch(fn, *a):
        err = fn(*a)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    def timed(fn):
        return CS.cuda_ms(torch, fn, 3)

    out = torch.empty_like(x)
    ref3 = {n: K3.cyc_sqr(x, n) for n in (1, 32)}
    ref6 = {w: PS.miller_step(f, c, pxy, w) for w in (True, False)}
    for E, T in _shapes(args.k3):
        res = {"kernel": "k3", "shape": f"{E}x{T}", **occupancy("k3", E, T)}
        blocks = -(-N // E)
        res["waves"] = blocks / (sms * max(res["blocks_per_sm"], 1))
        for n in (1, 32):
            run = lambda n=n: launch(k3, x.data_ptr(), out.data_ptr(), N, n, E, T, stream)  # noqa: E731
            res[f"ms_{n}"] = timed(run)
            res[f"equal_{n}"] = bool(torch.equal(out, ref3[n]))
        print(json.dumps(res), flush=True)
    for E, T in _shapes(args.k6):
        res = {"kernel": "k6", "shape": f"{E}x{T}", **occupancy("k6", E, T)}
        blocks = -(-N // E)
        res["waves"] = blocks / (sms * max(res["blocks_per_sm"], 1))
        for w in (True, False):
            run = lambda w=w: launch(k6, f.data_ptr(), c.data_ptr(), pxy.data_ptr(),  # noqa: E731
                                     out.data_ptr(), N, int(w), E, T, 0, stream)
            key = "with_square" if w else "line_only"
            res[f"ms_{key}"] = timed(run)
            res[f"equal_{key}"] = bool(torch.equal(out, ref6[w]))
        run = lambda: launch(k6, f.data_ptr(), c.data_ptr(), pxy.data_ptr(),  # noqa: E731
                             out.data_ptr(), N, 1, E, T, 1, stream)
        res["ms_edges_only"] = timed(run)
        res["edges_value_equal"] = bool(torch.equal(LZ.canonicalize_rows(out),
                                                    LZ.canonicalize_rows(f)))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
