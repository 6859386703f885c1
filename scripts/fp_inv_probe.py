#!/usr/bin/env python3
"""K7-inv's inversion body on one NVIDIA card: the constant-time binary GCD
(`ark_blst_tpu_torch/csrc/fp_inv.cuh` `inverse`) beside the Fermat ladder
it replaced, at the main path's widths, and the latencies of its parts.

    python3 scripts/fp_inv_probe.py [--widths 1,1000,8192] [--reps 5]

Builds `scripts/fp_inv_probe.cu` with the package's nvcc flags, prints the
card's name and power limit, then one JSON line: for each width, the GCD
body and the Fermat body on the same random canonical strict limbs (0, 1,
p - 1 and R mod p in the first lanes), timed in turns (GCD, Fermat,
Fermat, GCD; CUDA events, the mean of `--reps` launches after a warm-up),
their outputs equal limb for limb and equal to the oracle's R^2 X^-1 mod p
on a sample; the ptxas registers, stack and spills of each; and, on one
thread, the time of a batch of the GCD's 30 steps, of a batch's update, of
the whole inversion and of one dependent 32-bit operation, with the
latency floor they give: the 780 dependent steps (2 len(p) - 1 = 761 of
them needed) at the measured time a step. chip_smoke.py's phase k7_inv
times the Fermat body here in turns with K7-inv. Needs a card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ark_blst_tpu_torch.cuda import CudaKernel  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "fp_inv_probe.cu"
_P = ctypes.c_void_p
PROBE = CudaKernel(str(SOURCE), "fp_inv_probe",
                   [ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P, _P])
GCD, FERMAT = 0, 1  # the bodies' modes
STEPS, UPDATE, WHOLE, OPS = 2, 3, 4, 5  # the one-thread chains' modes
GCD_STEPS, GCD_BATCHES = 30, 26  # csrc/fp_inv.cuh
CHAIN_LINKS = {STEPS: 2000, UPDATE: 500, WHOLE: 20, OPS: 4000}


def ptxas(log: str, fragment: str) -> dict | None:
    """Registers, stack and spill bytes of the kernel whose mangled name
    holds `fragment`, from an `nvcc -Xptxas -v` log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            text = " ".join(lines[i:i + 4])
            get = lambda pat: int(m.group(1)) if (m := re.search(pat, text)) else 0  # noqa: E731
            return {"registers": get(r"Used (\d+) registers"), "stack": get(r"(\d+) bytes stack"),
                    "spill_stores": get(r"(\d+) bytes spill stores"),
                    "spill_loads": get(r"(\d+) bytes spill loads")}
    return None


def _stream(torch, t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def body(torch, mode: int, x):
    """The GCD (mode 0) or Fermat (mode 1) body on (24, n) strict limbs."""
    out = torch.empty_like(x)
    PROBE.launch(mode, x.shape[1], x.data_ptr(), out.data_ptr(), None, None, _stream(torch, x))
    return out


def body_ms(torch, mode: int, x, reps: int) -> float:
    """Mean device ms of `reps` launches of a body after one warm-up."""
    body(torch, mode, x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        body(torch, mode, x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _seed(torch, dev):
    """a, b, u, v random canonical words and four factors of a batch."""
    from ark_blst_tpu_torch.oracle.field import P

    rng = random.Random(24)
    vals = [rng.randrange(P) for _ in range(4)]
    words = [(v >> (32 * k)) & 0xFFFFFFFF for v in vals for k in range(12)]
    words += [rng.randrange(1 << 29), (-rng.randrange(1 << 28)) & 0xFFFFFFFF,
              (-rng.randrange(1 << 29)) & 0xFFFFFFFF, rng.randrange(1 << 28)]
    return torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in words],
                        dtype=torch.int32, device=dev)


def latencies(torch, dev) -> dict:
    """One thread's chains: us a GCD batch of steps, a step, a batch's
    update, an inversion, a dependent 32-bit operation; the latency floor of
    the inversion's 780 dependent steps."""
    seed = _seed(torch, dev)
    out = torch.zeros(24, dtype=torch.int32, device=dev)
    res = {}
    for mode, name in ((STEPS, "batch_steps_us"), (UPDATE, "update_us"), (WHOLE, "inverse_us"),
                       (OPS, "op_ns")):
        links = CHAIN_LINKS[mode]
        run = lambda k: PROBE.launch(mode, k, None, None, seed.data_ptr(), out.data_ptr(),  # noqa: E731
                                     _stream(torch, seed))
        run(1)
        torch.cuda.synchronize()
        times = []
        for k in (links, 2 * links):  # the difference drops the launch's own cost
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(k)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        per_link_ms = (times[1] - times[0]) / links
        res[name] = per_link_ms * 1e3 if mode != OPS else per_link_ms * 1e6 / 32
    res["step_us"] = res["batch_steps_us"] / GCD_STEPS
    res["floor_steps_ms"] = GCD_STEPS * GCD_BATCHES * res["step_us"] / 1e3
    res["parts_ms"] = (GCD_BATCHES * (res["batch_steps_us"] + res["update_us"])) / 1e3
    return res


def strict_inputs(torch, dev, n: int):
    """(24, n) canonical strict limbs, random, with 0, 1, p - 1 and R mod p in
    the first lanes."""
    from ark_blst_tpu_torch.ops.limbs import ints_to_limbs
    from ark_blst_tpu_torch.oracle.field import P

    rng = random.Random(n)
    vals = ([0, 1, P - 1, (1 << 384) % P] + [rng.randrange(P) for _ in range(n)])[:n]
    return torch.from_numpy(ints_to_limbs(vals, 24).T.copy()).to(dev)


def probe(torch, dev, widths, reps: int) -> dict:
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.oracle.field import P

    res = {"widths": []}
    for n in widths:
        x = strict_inputs(torch, dev, n)
        gcd, fermat = body(torch, GCD, x), body(torch, FERMAT, x)
        torch.cuda.synchronize()
        if not torch.equal(gcd, fermat):
            raise RuntimeError(f"the GCD and Fermat bodies differ at n = {n}")
        vals = CV.fp_from_dev(x[:, :64])  # X = v R: the result is v^-1 R
        if CV.fp_from_dev(gcd[:, :64]) != [pow(v, -1, P) if v else 0 for v in vals]:
            raise RuntimeError(f"the GCD body differs from the oracle at n = {n}")
        turns = [body_ms(torch, m, x, reps) for m in (GCD, FERMAT, FERMAT, GCD)]
        res["widths"].append({"n": n, "gcd_ms": [turns[0], turns[3]],
                              "fermat_ms": [turns[1], turns[2]]})
    res["ptxas"] = {"gcd": ptxas(PROBE.build_log, "inv_kernelILi0E"),
                    "fermat": ptxas(PROBE.build_log, "inv_kernelILi1E")}
    res["latency"] = latencies(torch, dev)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="1,1000,8192")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp_inv_probe: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    PROBE.build()
    widths = [int(w) for w in args.widths.split(",") if w]
    print(json.dumps({"probe": "fp_inv", "gpu": smi.splitlines()[0],
                      **probe(torch, dev, widths, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
