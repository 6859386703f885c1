#!/usr/bin/env python3
"""FE-hard (`ark_blst_tpu_torch/csrc/final_exp.cu` `hard_kernel`) split by
phase kind on one NVIDIA card.

    python3 scripts/fe_hard_probe.py [--widths 8192,1] [--min-blocks M]

Builds `scripts/fe_hard_clocks.cu` (the library's FE-hard body at the
library's shape for the width and its launch bound, under a phase runner that reads block 0's
SM clock at each barrier and sums the clocks by the kind that
`final_exp.cuh` `hard_chain` names for each phase: the loads, the
squares' products and recombinations, the fp12 products' phases, the
Frobenius maps, the conjugations, the stores, the output) with the
package's nvcc flags, and the package's FE-easy and FE-hard. For each
width N: the fused pairing's real Miller outputs of the first N pairs (as
chip_smoke.py's phase `final_exp_chains` makes them), FE-easy's words, then
FE-hard to strict limbs through the package (its time, the mean of three
launches after one) and under the clocks (its time likewise, and its
output limb for limb the package's). Prints the card's name and power
limit, the probe's ptxas line, then one JSON line a width: block 0's walk
in clocks, and for each kind its phases, clocks, clocks a phase and share
of the walk, with the share of the package's time beside (`ms`). With
`--min-blocks M` the clocked kernel is built bounded for M blocks an SM
(`-DFE_HARD_MIN_BLOCKS=M`: more registers a thread where M is smaller)
and its time beside the package's compares the two builds. Needs a card;
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

CLOCKS = Path(__file__).resolve().parent / "fe_hard_clocks.cu"
# fexp::HardKind, in order
KINDS = ("load", "sqr_products", "sqr_recombine", "mul_p1", "mul_p2", "mul_fp6", "mul_result",
         "mul_move", "conj", "frob", "frob_move", "store", "out")


def _build(src: Path, flags: list) -> tuple:
    """nvcc the probe source with the package's flags and `flags` into the
    package's build directory; returns its library and the nvcc/ptxas
    output."""
    from ark_blst_tpu_torch import cuda as KC

    h = hashlib.sha256(" ".join(KC.NVCC_FLAGS + flags).encode())
    for f in sorted(KC.CSRC_DIR.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    lib = KC.BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"
    KC.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([KC._nvcc(), *KC.NVCC_FLAGS, *flags, "-I", str(KC.CSRC_DIR), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def split(acc: list, ms: float) -> dict:
    """Block 0's counters -> the walk's clocks and each kind's phases,
    clocks, clocks a phase, share, and that share of `ms`."""
    n = len(KINDS)
    walk = acc[2 * n]
    by = {}
    for k, name in enumerate(KINDS):
        if acc[n + k]:
            share = acc[k] / walk
            by[name] = {"phases": acc[n + k], "clocks": acc[k],
                        "clocks_per_phase": acc[k] / acc[n + k], "share": share,
                        "ms": share * ms}
    return {"walk_clocks": walk, "phases": sum(acc[n:2 * n]), "by_kind": by}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fe_hard_probe: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="8192,1")
    ap.add_argument("--min-blocks", type=int, default=0)
    args = ap.parse_args()

    import chip_smoke as CS
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import final_exp as FE

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    FE.KERNEL_HARD.build()
    clib, log = _build(CLOCKS, [f"-DFE_HARD_MIN_BLOCKS={args.min_blocks}"]
                       if args.min_blocks > 0 else [])
    print(json.dumps({"ptxas": CS._ptxas_summary(log),
                      "library_ptxas": CS._ptxas_summary(FE.KERNEL_HARD.build_log)}), flush=True)
    fn = clib.fe_hard_clocks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ps, qs, _, _ = CS.pairing_inputs()
    for n in (int(w) for w in args.widths.split(",") if w):
        (p, p_inf), (q, q_inf) = B._g1_batch(ps[:n], dev), B._g2_batch(qs[:n], dev)
        f = PR._masked_miller_stack(p, PR.prepare_g2(q), PR._skip_mask(p_inf, q_inf))
        words = FE.easy(f)
        want = FE.hard(words, out="limbs")
        prog, frob = FE._tables(str(dev))
        scratch = torch.empty((FE.HARD_VALUES - 1, 12, FE.WORDS, n), dtype=torch.int32,
                              device=dev)
        out = torch.empty_like(want)
        acc = torch.zeros(2 * len(KINDS) + 1, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def clocked():
            acc.zero_()
            err = fn(words.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, prog.data_ptr(),
                     len(FE.HARD_PROGRAM), frob.data_ptr(), 1, sms, acc.data_ptr(), stream)
            if err:
                raise RuntimeError(f"fe_hard_clocks: CUDA error {err}")

        ms = CS.cuda_ms(torch, lambda: FE.hard(words, out="limbs"), 3)
        clocked_ms = CS.cuda_ms(torch, clocked, 3)
        clocked()
        torch.cuda.synchronize()
        res = {"n": n, "launch": CS._tower32_shape(torch, FE.KERNEL_HARD, n, (n,)), "ms": ms,
               "clocked_ms": clocked_ms,
               "equal": bool(torch.equal(out, want)), **split(acc.tolist(), ms)}
        print(json.dumps(res), flush=True)
        if not res["equal"]:
            raise RuntimeError(f"the clocked FE-hard differs from the package's at n = {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
