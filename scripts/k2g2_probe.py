#!/usr/bin/env python3
"""Where K2-G2's time goes, on one NVIDIA card: the G2 bucket kernel
(`ark_blst_tpu_torch/csrc/bucket_accumulate_g2.cu`) beside probes built
from `scripts/k2g2_probe.cu` — its own per-thread body at other launch
shapes, and cut-down versions with one bucket a thread in shared memory
(no global bucket traffic), without the bucket scatter, and with the
addition replaced by its 33 products.

    python3 scripts/k2g2_probe.py [--probes kernel_64x8,no_scatter_64x8,...]

Builds every probe from the checkout's sources (one nvcc each, all started
together, into build/k2g2_probe/; a probe nvcc fails on is reported and
left out) and the kernel itself, then runs each on
the G2 MSM's main-path inputs (2^20 distinct bases, c = 5, seed 11, as
chip_smoke.py builds them; the points converted to words once, beforehand).
Prints the card's name and power limit, then one JSON line per probe: its
ptxas registers, stack and spills, the blocks an SM holds and the waves of
its grid, its time (the mean of three launches after one warm-up, CUDA
events), and for the `kernel_*` probes whether its dump equals the
kernel's bit for bit. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = {"kernel": 0, "shared_bucket": 1, "no_scatter": 2, "products_only": 3}
DEFAULT = ("kernel_64x8,kernel_64x6,kernel_64x1,kernel_32x13,kernel_128x4,"
           "shared_bucket_64x8,no_scatter_64x8,products_only_64x8")


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


def main() -> int:
    import torch

    from ark_blst_tpu_torch import cuda as KC
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", default=DEFAULT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2g2_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    src = Path(__file__).resolve().parent / "k2g2_probe.cu"
    out_dir = KC.BUILD_DIR.parent / "k2g2_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in args.probes.split(","):
        variant, shape = name.rsplit("_", 1)
        threads, min_blocks = (int(v) for v in shape.split("x"))
        lib = out_dir / f"{name}.so"
        cmd = [KC._nvcc(), *KC.NVCC_FLAGS, f"-DPROBE_VARIANT={VARIANTS[variant]}",
               f"-DPROBE_THREADS={threads}", f"-DPROBE_MIN_BLOCKS={min_blocks}",
               "-I", str(KC.CSRC_DIR), "-o", str(lib), str(src)]
        procs.append((name, threads, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    KC.build_all([MB.KERNEL_G2])  # the kernel itself, while the probes build
    builds = []
    for name, threads, lib, proc in procs:  # a probe that fails to build is reported
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"probe": name, "nvcc_rc": proc.returncode, "log": log[-2000:]}),
                  flush=True)
            continue
        builds.append((name, threads, lib, log))

    dev = torch.device("cuda", 0)
    kc, c = MB.KC2_G2, 5
    points, scalars, _ = distinct_bases(20, 11, dev, "g2")
    pts, digs = MB._prepare_inputs(kc, points, scalars, c)
    words = MB.g2_point_words(pts)
    W, n = digs.shape
    B, S = MB._num_buckets(c), MB.STREAMS
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dump = torch.empty((W, B, kc.pt_rows, S), dtype=torch.int32, device=dev)

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

    ref = torch.empty_like(dump)
    ms = timed(lambda: MB.KERNEL_G2.launch(words.data_ptr(), digs.data_ptr(), ref.data_ptr(),
                                           n, W, B, S, stream))
    print(json.dumps({"probe": "bucket_accumulate_g2", "ms": ms,
                      **_ptxas(MB.KERNEL_G2.build_log, "bucket_accumulate_g2_kernel")}),
          flush=True)
    for name, threads, lib, log in builds:
        so = ctypes.CDLL(str(lib))
        fn = so.probe_launch
        fn.argtypes = MB.KERNEL_G2.argtypes
        fn.restype = ctypes.c_int
        per_sm = ctypes.c_int()
        so.probe_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        if so.probe_blocks_per_sm(ctypes.byref(per_sm)):
            raise RuntimeError(f"occupancy query failed for {name}")

        def launch():
            err = fn(words.data_ptr(), digs.data_ptr(), dump.data_ptr(), n, W, B, S, stream)
            if err:
                raise RuntimeError(f"launch failed for {name}: CUDA error {err}")

        blocks = -(-W * S // threads)
        res = {"probe": name, "ms": timed(launch), **_ptxas(log, "probe_kernel"),
               "threads": threads, "blocks_per_sm": per_sm.value,
               "waves": blocks / (sms * per_sm.value)}
        if name.startswith("kernel_"):
            res["equal_to_kernel"] = bool(torch.equal(dump, ref))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
