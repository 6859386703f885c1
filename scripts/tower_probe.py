#!/usr/bin/env python3
"""K3 (`ark_blst_tpu_torch/csrc/cyc_sqr.cu`), K4 (`csrc/fp12_mul.cu`), K5
(`csrc/prepare_step.cu`, the prepare's chain), K6 (`csrc/miller_step.cu`,
the Miller loop's chain), K11 (`csrc/fp12_sqr.cu`), K12
(`csrc/fp12_mul_by_014.cu`) and FE-hard (`csrc/final_exp.cu`, the final
exponentiation's hard part) at other launch shapes, on one NVIDIA card:
each shape is E elements and T threads a block (`tower_cyc_sqr_shaped`,
`tower_fp12_mul_shaped`, `pairing_prepare_chain_shaped`,
`pairing_miller_chain_shaped`, `tower_fp12_sqr_shaped`,
`tower_fp12_mul_by_014_shaped`), and the edges of K4-K6, K11 and K12
alone (the conversions of their input and output Fp components,
`edges_only`; for a chain the conversions once and the lines, one row an
event). K3 and K6 run every shape in the library's own build
(`__launch_bounds__(512)`). K4, K5, K11 and K12 are bounded by their
launch shape, so each of their shapes gets a build of its own, bounded by
it: T threads and as many blocks an SM as the shape's shared memory holds
(`-DK4_THREADS=T -DK4_MIN_BLOCKS=M`, `K5_*`, `K11_*`, `K12_*` likewise),
with its ptxas registers and spills.

    python3 scripts/tower_probe.py [--k3 32x288,16x144] [--k4 32x192] \
        [--k5 32x192,16x96] [--k6 32x256,16x128] [--k11 32x192] \
        [--k12 32x256,24x192] [--chains 32,16,8] [--widths 8192,1024] \
        [--fe 32x576,16x288,32x576x1]

An empty list (`--k3 ""`) skips a kernel's shapes. Builds the six kernels
from the checkout's sources (`cuda.build_all`) and the shapes' builds of
K4, K5, K11 and K12 beside them, all at once, into `build/tower_probe/`;
makes the pairing batch's inputs as chip_smoke.py makes them (N = 8192
random mul-ready digits, seed 7; the top digit of the operands of K4-K6,
K11 and K12 bounded), and prints the card's name and power limit, then
one JSON line per shape: the blocks an SM holds (the occupancy API at the
compiled registers and the shape's shared memory), the grid's waves, the
time (the mean of three launches after one warm-up, CUDA events) of K3
at n = 1 and n = 32 squares, K4, K5's doubling and addition (one event),
K6 with and without the square (one event), K11 or K12, each with its
edges alone, and whether the output equals the library's default shape's
bit for bit (every shape computes the same words; the edges alone store
their inputs' values); K4 also on its word layouts (words in, words or
strict limbs out: the multi-pairings' fold) on the words of its
operands. Then, for each width N of `--widths` (the pairs of the
pipeline's real inputs, 8 distinct, as chip_smoke.py's phase
`tower_chains` makes them) and each E of `--chains`, one line for the
two chains of all 68 events in the library's builds at E elements a
block (six threads an element for K5, eight for K6): their times and
their edges alone in each layout of the edges (`pairing`, the fused
pairing's: strict Q and P in, R = (Q, 1) and f = one formed in the
kernels, the lines as words, K6 storing conj(f) as words (K6 only: K5's
is `strict_words`'); `strict_words`, the same with f stored as digits, as
the public `miller_loop` takes it; `digits`, the digit entries': R, Q, f,
P and the lines as digits), their blocks an SM and waves, and whether
their output equals the default shape's. Then, for each width N, FE-easy
at its default shape on f as words (the fused pairing's conj(f), the
identities masked to one) and on its digits, and FE-hard at each shape of
`--fe` (a build of its own, bounded as K4's: `-DFE_HARD_THREADS=T
-DFE_HARD_MIN_BLOCKS=M`) on the easy part of the first N pairs' real
Miller outputs, storing strict limbs (the fused pairing's) and digits
(a shape ExTxM bounds its build for M blocks an SM instead):
their times, blocks an SM, waves and whether FE-hard's output equals the
library's bit for bit. Needs a card; imports no JAX.
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
K4_SHAPES = "32x192,32x256,32x128,16x128,16x96"
K5_SHAPES = "32x192,32x128,16x96,16x64,64x384"
K11_SHAPES = "32x192,32x256,32x384,24x144,16x96,16x192"
K12_SHAPES = "32x256,32x192,32x320,24x192,24x128,16x128"
FE_SHAPES = "32x576,16x288,32x576x1,16x288x3,32x288,24x432"
CHAIN_ELEMS = "32,16,8"
CHAIN_WIDTHS = "8192,1024"
K5_THREADS_PER_ELEM, K6_THREADS_PER_ELEM = 6, 8
SMEM_RESERVED = 1024  # shared memory the card reserves a block
DIG, LIM, WRD = 0, 1, 2  # the chains' edge formats (csrc/tower381.cuh EdgeFormat)


def _shapes(arg: str) -> list:
    return [tuple(int(v) for v in s.split("x")) for s in arg.split(",") if s]


def _bounded_builds(KC, props, kernels: dict) -> tuple:
    """Start one nvcc for each bound that the shapes of K4, K5, K11 and
    K12 ask for; kernels maps "k4", "k5", "k11", "k12" to (source, macro
    prefix, bytes an element, shapes: (E, T), or (E, T, M) for a bound of M
    blocks an SM). Returns {(which, *shape): (library, min blocks)} and
    {library: process}, one build for each bound."""
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", 228 * 1024)
    out_dir = KC.BUILD_DIR.parent / "tower_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    shapes_of, procs = {}, {}
    for which, (source, macro, elem_bytes, shapes) in kernels.items():
        for shape in shapes:
            E, T = shape[:2]
            blocks = shape[2] if len(shape) > 2 else max(
                1, min(smem_sm // (E * elem_bytes + SMEM_RESERVED), 2048 // T))
            lib = out_dir / f"{which}_{T}x{blocks}.so"
            shapes_of[(which, *shape)] = (lib, blocks)
            if lib not in procs:
                cmd = [KC._nvcc(), *KC.NVCC_FLAGS, f"-D{macro}_THREADS={T}",
                       f"-D{macro}_MIN_BLOCKS={blocks}", "-I", str(KC.CSRC_DIR), "-o",
                       str(lib), str(KC.CSRC_DIR / source)]
                procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)
    return shapes_of, procs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tower_probe: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--k3", default=K3_SHAPES)
    ap.add_argument("--k4", default=K4_SHAPES)
    ap.add_argument("--k5", default=K5_SHAPES)
    ap.add_argument("--k6", default=K6_SHAPES)
    ap.add_argument("--k11", default=K11_SHAPES)
    ap.add_argument("--k12", default=K12_SHAPES)
    ap.add_argument("--chains", default=CHAIN_ELEMS)
    ap.add_argument("--widths", default=CHAIN_WIDTHS)
    ap.add_argument("--fe", default=FE_SHAPES)
    args = ap.parse_args()

    import chip_smoke as CS
    from ark_blst_tpu_torch import cuda as KC
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import cyc_sqr as K3
    from ark_blst_tpu_torch.ops import fp12_mul as K4
    from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
    from ark_blst_tpu_torch.ops import final_exp as FE
    from ark_blst_tpu_torch.ops import fp12_sqr as K11
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.ops import words as W

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    kernels = {"k3": K3.KERNEL, "k4": K4.KERNEL, "k5": PS.PREPARE_KERNEL,
               "k6": PS.MILLER_KERNEL, "k11": K11.KERNEL, "k12": K12.KERNEL,
               "fe": FE.KERNEL_HARD}
    props = torch.cuda.get_device_properties(0)
    slot_bytes = 12 * 2 * 4  # one Fp2 slot of 32-bit words
    bounded, procs = _bounded_builds(KC, props, {
        "k4": ("fp12_mul.cu", "K4", 30 * slot_bytes, _shapes(args.k4)),
        "k5": ("prepare_step.cu", "K5", 26 * slot_bytes, _shapes(args.k5)),
        "k11": ("fp12_sqr.cu", "K11", 30 * slot_bytes, _shapes(args.k11)),
        "k12": ("fp12_mul_by_014.cu", "K12", 27 * slot_bytes, _shapes(args.k12)),
        "fe": ("final_exp.cu", "FE_HARD", 72 * slot_bytes // 2, _shapes(args.fe))})
    KC.build_all(list(kernels.values()))  # the library, while the shapes build
    sms = props.multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    ptxas = {k.source: CS._ptxas_summary(k.build_log) for k in kernels.values()}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    logs = {}
    for path, proc in procs.items():
        logs[path], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path.name}:\n{logs[path]}")
    shape_ptxas = {key: {"min_blocks": blocks, **CS._ptxas_summary(logs[path])}
                   for key, (path, blocks) in bounded.items()}

    x, f, c, pxy, a, b, r, q = CS.digit_stacks(torch, dev, [12, 12, 6, 2, 12, 12, 6, 4])
    # the operands of K4-K6, K11 and K12 below 8p, as chip_smoke.py's phases make them
    CS._below_8p(torch, dev, (f, c, pxy, a, b, r, q), SEED)

    def lib(path, name, argtypes):
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    entries = {"k3": ("tower_cyc_sqr_shaped", [vp, vp, i64, i32, i32, i32, vp]),
               "k4": ("tower_fp12_mul_shaped", [vp, vp, vp, i64, i32, i32, i32, i32, i32, vp]),
               "k5": ("pairing_prepare_chain_shaped",
                      [vp, vp, vp, vp, i64, i32, vp, i32, i32, i32, i32, i32, vp]),
               "k6": ("pairing_miller_chain_shaped",
                      [vp, vp, vp, vp, i64, i32, vp, i32, i32, i32, i32, i32, i32, vp]),
               "k11": ("tower_fp12_sqr_shaped", [vp, vp, i64, i32, i32, i32, vp]),
               "k12": ("tower_fp12_mul_by_014_shaped", [vp, vp, vp, i64, i32, i32, i32, vp]),
               "fe": ("final_exp_hard_shaped",
                      [vp, vp, vp, i64, vp, i32, vp, i32, i32, i32, vp])}

    def flags(schedule):
        return (ctypes.c_ubyte * len(schedule))(*[int(x) for x in schedule])

    def shaped(which, *shape):
        """The shaped entry and the occupancy entry of the build that runs
        the shape: its own for K4, K5, K11, K12 and FE-hard, the library's
        for K3 and K6."""
        path = bounded[(which, *shape)][0] if (which, *shape) in bounded \
            else kernels[which].lib_path
        lead = [ctypes.c_int] if which == "fe" else []  # FE-hard's width (0: E, T given)
        occ = lib(path, kernels[which].symbol + "_shape",
                  lead + [ctypes.POINTER(ctypes.c_int)] * 4)
        return lib(path, *entries[which]), (lambda *a: occ(*[0] * len(lead), *a))

    def occupancy(occ, E, T):
        vals = [ctypes.c_int(E), ctypes.c_int(T), ctypes.c_int(), ctypes.c_int()]
        err = occ(*(ctypes.byref(v) for v in vals))
        return {"smem_bytes": vals[2].value, "blocks_per_sm": vals[3].value, "error": err}

    def launch(fn, *a):
        err = fn(*a)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    def timed(fn):
        return CS.cuda_ms(torch, fn, 3)

    def shape_line(which, *shape):
        E, T = shape[:2]
        fn, occ = shaped(which, *shape)
        res = {"kernel": which, "shape": "x".join(map(str, shape)), **occupancy(occ, E, T)}
        res["waves"] = -(-N // E) / (sms * max(res["blocks_per_sm"], 1))
        if (which, *shape) in shape_ptxas:
            res["ptxas"] = shape_ptxas[(which, *shape)]
        return fn, res

    def edges_hold(inputs):
        """The edges alone store their inputs' values: output row c holds
        input component c mod the inputs' rows."""
        src = torch.cat(inputs)
        rows = [c % src.shape[0] for c in range(12)]
        return bool(torch.equal(LZ.canonicalize_rows(out),
                                LZ.canonicalize_rows(src[rows])))

    out = torch.empty_like(x)
    ref3 = {n: K3.cyc_sqr(x, n) for n in (1, 32)}
    ref4 = K4.fp12_mul(a, b)
    # K4's word layouts (the multi-pairings' fold) on the words of a and b
    aw, bw = W.digits_to_words_plain(a), W.digits_to_words_plain(b)
    ref4w = {"words": K4.fp12_mul(aw, bw, out="words"), "limbs": K4.fp12_mul(aw, bw, out="limbs")}
    ref5 = {add: PS.prepare_step(r, q if add else None) for add in (False, True)}
    ref6 = {w: PS.miller_step(f, c, pxy, w) for w in (True, False)}
    ref11, ref12 = K11.fp12_sqr(f), K12.fp12_mul_by_014(f, c)
    for E, T in _shapes(args.k3):
        k3, res = shape_line("k3", E, T)
        for n in (1, 32):
            run = lambda n=n: launch(k3, x.data_ptr(), out.data_ptr(), N, n, E, T, stream)  # noqa: E731
            res[f"ms_{n}"] = timed(run)
            res[f"equal_{n}"] = bool(torch.equal(out, ref3[n]))
        print(json.dumps(res), flush=True)
    for E, T in _shapes(args.k4):
        k4, res = shape_line("k4", E, T)
        for edges in (0, 1):
            run = lambda e=edges, k4=k4: launch(k4, a.data_ptr(), b.data_ptr(),  # noqa: E731
                                                out.data_ptr(), N, DIG, DIG, E, T, e, stream)
            res["ms_edges_only" if edges else "ms"] = timed(run)
            if edges:
                res["edges_value_equal"] = edges_hold([a])
            else:
                res["equal"] = bool(torch.equal(out, ref4))
        for name, fmt in (("words", WRD), ("limbs", LIM)):
            got = torch.empty_like(ref4w[name])
            for edges in (0, 1):
                run = lambda e=edges, k4=k4, fmt=fmt, got=got: launch(  # noqa: E731
                    k4, aw.data_ptr(), bw.data_ptr(), got.data_ptr(), N, WRD, fmt, E, T, e,
                    stream)
                res[f"ms_{name}_edges_only" if edges else f"ms_{name}"] = timed(run)
                if not edges:
                    res[f"equal_{name}"] = bool(torch.equal(got, ref4w[name]))
        print(json.dumps(res), flush=True)
    for E, T in _shapes(args.k5):
        k5, res = shape_line("k5", E, T)
        for add in (False, True):
            key = "addition" if add else "doubling"
            for edges in (0, 1):
                run = lambda e=edges, add=add, k5=k5: launch(  # noqa: E731
                    k5, r.data_ptr(), q.data_ptr(), out[6:].data_ptr(), out[:6].data_ptr(), N, 1,
                    flags([not add]), DIG, DIG, E, T, e, stream)
                res[f"ms_{key}_edges_only" if edges else f"ms_{key}"] = timed(run)
                if edges:  # R out, and the line rows R's components
                    res[f"{key}_edges_value_equal"] = edges_hold([r])
                else:
                    res[f"equal_{key}"] = bool(torch.equal(out, ref5[add]))
        print(json.dumps(res), flush=True)
    for E, T in _shapes(args.k6):
        k6, res = shape_line("k6", E, T)
        for w in (True, False):
            run = lambda w=w: launch(k6, f.data_ptr(), c.data_ptr(), pxy.data_ptr(),  # noqa: E731
                                     out.data_ptr(), N, 1, flags([w]), DIG, DIG, DIG, E, T, 0,
                                     stream)
            key = "with_square" if w else "line_only"
            res[f"ms_{key}"] = timed(run)
            res[f"equal_{key}"] = bool(torch.equal(out, ref6[w]))
        run = lambda: launch(k6, f.data_ptr(), c.data_ptr(), pxy.data_ptr(),  # noqa: E731
                             out.data_ptr(), N, 1, flags([True]), DIG, DIG, DIG, E, T, 1,
                             stream)
        res["ms_edges_only"] = timed(run)
        res["edges_value_equal"] = edges_hold([f])
        print(json.dumps(res), flush=True)
    for which, shapes, operands, ref in (("k11", args.k11, (f,), ref11),
                                         ("k12", args.k12, (f, c), ref12)):
        for E, T in _shapes(shapes):
            fn, res = shape_line(which, E, T)
            ptrs = [x.data_ptr() for x in operands]
            for edges in (0, 1):
                run = lambda e=edges, fn=fn, ptrs=ptrs: launch(  # noqa: E731
                    fn, *ptrs, out.data_ptr(), N, E, T, e, stream)
                res["ms_edges_only" if edges else "ms"] = timed(run)
                if edges:
                    res["edges_value_equal"] = edges_hold([f])
                else:
                    res["equal"] = bool(torch.equal(out, ref))
            print(json.dumps(res), flush=True)

    from ark_blst_tpu_torch.curves import pairing as PR

    sched = flags(PR.MILLER_EVENTS)
    events = len(PR.MILLER_EVENTS)
    k5, occ5 = lib(PS.PREPARE_KERNEL.lib_path, *entries["k5"]), \
        lib(PS.PREPARE_KERNEL.lib_path, "pairing_prepare_chain_shape", [ctypes.POINTER(i32)] * 4)
    k6, occ6 = lib(PS.MILLER_KERNEL.lib_path, *entries["k6"]), \
        lib(PS.MILLER_KERNEL.lib_path, "pairing_miller_chain_shape", [ctypes.POINTER(i32)] * 4)
    for n in (int(w) for w in args.widths.split(",") if w):
        # each layout of the edges: K5's (r, q, in and out formats; None: the
        # layout is K6's alone) and K6's (f, P, line, P and f formats)
        # pointers with their outputs' references
        qt, pt, _, _ = CS.chain_inputs(torch, dev, n)
        q = torch.stack([qt[0][0], qt[0][1], qt[1][0], qt[1][1]])
        pxy = torch.stack([pt[0], pt[1]])
        q_dig, pxy_dig, f1 = CS.digit_chain_inputs(torch, qt, pt)
        r1 = PS._r_start(q_dig)
        lines = PS.prepare_lines(qt, PR.MILLER_EVENTS)
        c_dig = PS.prepare_chain(q_dig, PR.MILLER_EVENTS)
        layouts = {
            "pairing": (None, lines, (0, pxy.data_ptr(), WRD, LIM, WRD),
                        PS.miller_lines(lines, pt, PR.MILLER_EVENTS, PS.FMT_WORDS)),
            "strict_words": ((0, q.data_ptr(), LIM, WRD), lines,
                             (0, pxy.data_ptr(), WRD, LIM, DIG),
                             PS.miller_lines(lines, pt, PR.MILLER_EVENTS)),
            "digits": ((r1.data_ptr(), q_dig.data_ptr(), DIG, DIG), c_dig,
                       (f1.data_ptr(), pxy_dig.data_ptr(), DIG, DIG, DIG),
                       PS.miller_chain(f1, c_dig, pxy_dig, PR.MILLER_EVENTS))}
        for E in (int(e) for e in args.chains.split(",") if e):
            res = {"kernel": "chains", "n": n, "elements_per_block": E}
            for which, occ, T in (("k5", occ5, K5_THREADS_PER_ELEM * E),
                                  ("k6", occ6, K6_THREADS_PER_ELEM * E)):
                line = {"threads": T, **occupancy(occ, E, T)}
                line["blocks"] = -(-n // E)
                line["waves"] = line["blocks"] / (sms * max(line["blocks_per_sm"], 1))
                for name, (a5, c_ref, a6, f_ref) in layouts.items():
                    if which == "k5" and a5 is None:
                        continue
                    got = torch.empty_like(c_ref if which == "k5" else f_ref)
                    for only in (0, 1):
                        if which == "k5":
                            run = lambda e=only, T=T, a=a5, o=got: launch(  # noqa: E731
                                k5, a[0], a[1], o.data_ptr(), 0, n, events, sched, a[2], a[3],
                                E, T, e, stream)
                        else:
                            run = lambda e=only, T=T, a=a6, c=c_ref, o=got: launch(  # noqa: E731
                                k6, a[0], c.data_ptr(), a[1], o.data_ptr(), n, events, sched,
                                a[2], a[3], a[4], E, T, e, stream)
                        line[f"ms_{name}_edges_only" if only else f"ms_{name}"] = timed(run)
                        if not only:
                            line[f"equal_{name}"] = bool(
                                torch.equal(got, c_ref if which == "k5" else f_ref))
                res[which] = line
            print(json.dumps(res), flush=True)

    from ark_blst_tpu_torch import bls12 as B

    ps, qs, _, _ = CS.pairing_inputs()
    for n in (int(w) for w in args.widths.split(",") if w):
        (p, p_inf), (q, q_inf) = B._g1_batch(ps[:n], dev), B._g2_batch(qs[:n], dev)
        f = PR._masked_miller_stack(p, PR.prepare_g2(q), PR._skip_mask(p_inf, q_inf))
        f_digits = W.words_to_digits_plain(f)
        words = FE.easy(f)
        refs = {"limbs": FE.hard(words, out="limbs"), "digits": FE.hard(words)}
        prog, frob = FE._tables(str(dev))
        scratch = torch.empty((FE.HARD_VALUES - 1, 12, FE.WORDS, n), dtype=torch.int32,
                              device=dev)
        res = {"kernel": "final_exp", "n": n, "easy_ms": timed(lambda: FE.easy(f)),
               "easy_digits_ms": timed(lambda: FE.easy(f_digits)),
               "easy_equal": bool(torch.equal(FE.easy(f_digits), words))}
        res["easy_launch"] = CS._tower32_shape(torch, FE.KERNEL_EASY, n)
        print(json.dumps(res), flush=True)
        for shape in _shapes(args.fe):
            E, T = shape[:2]
            fn, res = shape_line("fe", *shape)
            res["n"], res["blocks"] = n, -(-n // E)
            res["waves"] = res["blocks"] / (sms * max(res["blocks_per_sm"], 1))
            for out_name, fmt in (("limbs", LIM), ("digits", DIG)):
                fo = torch.empty_like(refs[out_name])
                run = lambda fn=fn, E=E, T=T, fo=fo, fmt=fmt: launch(  # noqa: E731
                    fn, words.data_ptr(), scratch.data_ptr(), fo.data_ptr(), n, prog.data_ptr(),
                    len(FE.HARD_PROGRAM), frob.data_ptr(), fmt, E, T, stream)
                key = "" if out_name == "limbs" else "_digits"
                res["ms" + key] = timed(run)
                res["equal" + key] = bool(torch.equal(fo, refs[out_name]))
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
