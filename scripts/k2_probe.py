#!/usr/bin/env python3
"""Where a bucket kernel's time goes, on one NVIDIA card: K2 (G1,
`ark_blst_tpu_torch/csrc/bucket_accumulate.cu`) or K2-G2
(`csrc/bucket_accumulate_g2.cu`) beside probes built from
`scripts/k2_probe.cu` — its own per-thread body at other launch shapes,
the same computation with each thread's buckets contiguous in a scratch
buffer, and cut-down versions with one bucket a thread in shared memory
(no global bucket traffic), without the bucket scatter, and with the
addition replaced by its 11 products — and the kernel itself at other
stream counts and windows.

    python3 scripts/k2_probe.py [--curve g1|g2] [--probes kernel_64x5,...]
                                [--streams 2048,4096] [--windows 8]

Builds every probe from the checkout's sources (one nvcc each, all started
together, into build/k2_probe/; a probe nvcc fails on is reported and
left out) and the kernel itself, then runs each on the MSM's main-path
inputs as chip_smoke.py builds them (G1: 2^22 distinct bases, c = 7, seed
7; G2: 2^20, c = 5, seed 11; the points converted to words once,
beforehand). Prints the card's name and power limit, then one JSON line
per probe: its ptxas registers, stack and spills, the blocks an SM holds
and the waves of its grid, its time (the mean of three launches after one
warm-up, CUDA events), and for the probes that compute the MSM's dump
(`kernel_*`, `contig_bucket_*`) whether it equals the kernel's bit for
bit. Then the sweep: the kernel and those probes at each stream count of
`--streams` (c kept) and at each window of `--windows` (1024 streams),
timed the same way; the kernel's dump of each is reduced and finished by
the MSM's own stages (`_reduce_dump`, `_finish_host`) and checked against
the expected point, the probes' dumps against the kernel's bit for bit.
The stream count and the window are arguments of the kernel, so the sweep
changes no code.
Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = {"kernel": 0, "shared_bucket": 1, "no_scatter": 2, "products_only": 3,
            "contig_bucket": 4}
FULL = ("kernel", "contig_bucket")  # the variants whose dump is the MSM's
DEFAULT = {
    "g1": ("kernel_64x5,kernel_64x4,kernel_64x6,kernel_64x8,kernel_32x10,kernel_128x3,"
           "contig_bucket_64x5,contig_bucket_64x4,contig_bucket_128x3,"
           "shared_bucket_64x5,no_scatter_64x5,products_only_64x5"),
    "g2": ("kernel_64x8,kernel_64x6,kernel_64x1,kernel_32x13,kernel_128x4,"
           "contig_bucket_64x8,shared_bucket_64x8,no_scatter_64x8,products_only_64x8"),
}
# curve: (log2 points, c, seed), chip_smoke.py's main-path instances
INSTANCE = {"g1": (22, 7, 7), "g2": (20, 5, 11)}


def _ptxas(log: str, entry: str) -> dict:
    """Registers, stack frame and spill bytes of the kernel entry whose
    mangled name holds `entry`, from an `nvcc -Xptxas -v` log."""
    out, cur = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        if entry not in cur:
            continue
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            out.update(stack_frame=int(parts[0]), spill_store_bytes=int(parts[4]),
                       spill_load_bytes=int(parts[8]))
        if "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split("registers")[0])
    return out


def _ints(arg: str) -> list:
    return [int(v) for v in arg.split(",") if v]


def main() -> int:
    import torch

    from ark_blst_tpu_torch import cuda as KC
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import convert as CV

    ap = argparse.ArgumentParser()
    ap.add_argument("--curve", choices=("g1", "g2"), default="g1")
    ap.add_argument("--probes", default=None)
    ap.add_argument("--streams", default="2048,4096", help="stream counts of the sweep")
    ap.add_argument("--windows", default="8", help="windows c of the sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kc = MB.KC2_G2 if args.curve == "g2" else MB.KC2_G1
    entry = kc.kernel.source[: -len(".cu")] + "_kernel"

    src = Path(__file__).resolve().parent / "k2_probe.cu"
    out_dir = KC.BUILD_DIR.parent / "k2_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in (args.probes or DEFAULT[args.curve]).split(","):
        variant, shape = name.rsplit("_", 1)
        threads, min_blocks = (int(v) for v in shape.split("x"))
        lib = out_dir / f"{args.curve}_{name}.so"
        cmd = [KC._nvcc(), *KC.NVCC_FLAGS, f"-DPROBE_G2={int(kc.is_g2)}",
               f"-DPROBE_VARIANT={VARIANTS[variant]}", f"-DPROBE_THREADS={threads}",
               f"-DPROBE_MIN_BLOCKS={min_blocks}", "-I", str(KC.CSRC_DIR), "-o", str(lib),
               str(src)]
        procs.append((name, threads, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    KC.build_all([kc.kernel])  # the kernel itself, while the probes build
    builds = []
    for name, threads, lib, proc in procs:  # a probe that fails to build is reported
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"probe": name, "nvcc_rc": proc.returncode, "log": log[-2000:]}),
                  flush=True)
            continue
        builds.append((name, threads, lib, log))

    dev = torch.device("cuda", 0)
    log_n, c, seed = INSTANCE[args.curve]
    points, scalars, expected = distinct_bases(log_n, seed, dev, args.curve)
    pts, digs = MB._prepare_inputs(kc, points, scalars, c)
    words = MB.point_words(kc, pts)
    n = digs.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(launch) -> float:
        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 3

    def run(fn, digits, cc, S, dump):
        W, B = digits.shape[0], MB._num_buckets(cc)

        def launch():
            err = fn(words.data_ptr(), digits.data_ptr(), dump.data_ptr(), n, W, B, S, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        return timed(launch)

    def new_dump(digits, cc, S):
        return torch.empty((digits.shape[0], MB._num_buckets(cc), kc.pt_rows, S),
                           dtype=torch.int32, device=dev)

    def set_scratch(so, name, digits, cc, S):
        """The contiguous-bucket variant's scratch: W S B buckets of
        pt_words ints (12 a Fp component, 36 or 72 a bucket)."""
        if not name.startswith("contig_bucket"):
            return None
        pt_words = kc.n_fp * 12
        scratch = torch.empty(digits.shape[0] * S * MB._num_buckets(cc) * pt_words,
                              dtype=torch.int32, device=dev)
        so.probe_set_scratch(ctypes.c_void_p(scratch.data_ptr()))
        return scratch

    kernel_fn = ctypes.CDLL(str(kc.kernel.lib_path))[kc.kernel.symbol]
    kernel_fn.argtypes, kernel_fn.restype = kc.kernel.argtypes, ctypes.c_int
    ref = new_dump(digs, c, MB.STREAMS)
    ms = run(kernel_fn, digs, c, MB.STREAMS, ref)
    print(json.dumps({"probe": entry, "streams": MB.STREAMS, "c": c, "ms": ms,
                      **_ptxas(kc.kernel.build_log, entry)}), flush=True)
    loaded = []
    for name, threads, lib, log in builds:
        so = ctypes.CDLL(str(lib))
        fn = so.probe_launch
        fn.argtypes, fn.restype = kc.kernel.argtypes, ctypes.c_int
        per_sm = ctypes.c_int()
        so.probe_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        if so.probe_blocks_per_sm(ctypes.byref(per_sm)):
            raise RuntimeError(f"occupancy query failed for {name}")
        so.probe_set_scratch.argtypes = [ctypes.c_void_p]
        dump = new_dump(digs, c, MB.STREAMS)
        scratch = set_scratch(so, name, digs, c, MB.STREAMS)
        blocks = -(-digs.shape[0] * MB.STREAMS // threads)
        res = {"probe": name, "ms": run(fn, digs, c, MB.STREAMS, dump),
               **_ptxas(log, "probe_kernel"), "threads": threads,
               "blocks_per_sm": per_sm.value, "waves": blocks / (sms * per_sm.value)}
        if name.rsplit("_", 1)[0] in FULL:
            res["equal_to_kernel"] = bool(torch.equal(dump, ref))
            loaded.append((name, threads, per_sm.value, so, fn))
        del dump, scratch
        print(json.dumps(res), flush=True)
    del ref
    torch.cuda.empty_cache()

    # the sweep: other stream counts at the main path's c, other windows at
    # 1024 streams
    configs = [(S, c) for S in _ints(args.streams)] + [(MB.STREAMS, w) for w in
                                                       _ints(args.windows)]
    for S, cc in configs:
        digits = digs if cc == c else MB._prepare_inputs(kc, points, scalars, cc)[1]
        ref = new_dump(digits, cc, S)
        ms = run(kernel_fn, digits, cc, S, ref)
        out = MB._finish_host(kc, MB._reduce_dump(kc, ref), cc)
        got = CV.g2_from_dev(out) if kc.is_g2 else CV.g1_from_dev(out)
        W = digits.shape[0]
        line = {"sweep": entry, "streams": S, "c": cc, "windows": W, "ms": ms,
                "msm_result_ok": got == [expected], "probes": {}}
        for name, threads, per_sm, so, fn in loaded:
            dump = new_dump(digits, cc, S)
            scratch = set_scratch(so, name, digits, cc, S)
            blocks = -(-W * S // threads)
            line["probes"][name] = {"ms": run(fn, digits, cc, S, dump),
                                    "waves": blocks / (sms * per_sm),
                                    "equal_to_kernel": bool(torch.equal(dump, ref))}
            del dump, scratch
        print(json.dumps(line), flush=True)
        del ref, digits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
