"""The CUDA sources against the Python engines they mirror: the constants
compiled into csrc/lazy13.cuh, csrc/tower381.cuh and csrc/strict16.cuh
(csrc/fp381.cuh's in tests/test_torch_fp381_host.py), the kernels' C entry
points and build flags, and the parallel build's one nvcc per source.
(The kernels themselves compile and run only on the card:
tests/test_torch_cuda.py.)"""

import re

import pytest

from ark_blst_tpu_torch import cuda as KC
from ark_blst_tpu_torch.curves import msm_bucket as MB
from ark_blst_tpu_torch.curves import pairing_steps as PS
from ark_blst_tpu_torch.ops import cyc_sqr as K3
from ark_blst_tpu_torch.ops import final_exp as FE
from ark_blst_tpu_torch.ops import fp12_mul as K4
from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
from ark_blst_tpu_torch.ops import fp12_sqr as K11
from ark_blst_tpu_torch.ops import fp_inv as FI
from ark_blst_tpu_torch.ops import lazy13 as LZ
from ark_blst_tpu_torch.ops import mont_mul as MM
from ark_blst_tpu_torch.ops import scan_msm as SM
from ark_blst_tpu_torch.ops import strict_field as SF
from ark_blst_tpu_torch.ops.limbs import FP, FR

HEADER = (KC.CSRC_DIR / "lazy13.cuh").read_text()
TOWER = (KC.CSRC_DIR / "tower381.cuh").read_text()
STRICT = (KC.CSRC_DIR / "strict16.cuh").read_text()


def _array(name):
    m = re.search(rf"__constant__ int {name}\[ELEM\] = \{{([^}}]*)\}};", HEADER)
    assert m, f"{name} not found in lazy13.cuh"
    return [int(v) for v in m.group(1).replace("\n", " ").split(",")]


@pytest.mark.parametrize("name,want", [("P_DIGITS", LZ.P_DIGITS), ("NINV_DIGITS", LZ.NINV_DIGITS)])
def test_header_constants(name, want):
    assert _array(name) == want


@pytest.mark.parametrize("name,value", [
    ("ELEM", LZ.ELEM), ("RADIX", LZ.RADIX), ("DMASK", LZ.DMASK), ("HALF", LZ.HALF),
    ("BIAS", MB.BIAS),
])
def test_header_scalars(name, value):
    assert re.search(rf"constexpr int {name} = {value};", HEADER)


@pytest.mark.parametrize("name,value", [
    # with the digits biased by 8192, the residue of the digits' own value
    ("DIGIT8192_FIX", -8192 * ((LZ.R13 - 1) // 8191) % LZ.P),
])
def test_tower_header_constants(name, value):
    """The 32-bit tower's word constants (csrc/tower381.cuh)."""
    m = re.search(rf"__constant__ u32 {name}\[NW\] = \{{([^}}]*)\}};", TOWER)
    assert m, f"{name} not found in tower381.cuh"
    words = [int(v.strip(), 16) for v in m.group(1).split(",")]
    assert words == [(value >> 32 * k) & 0xFFFFFFFF for k in range(12)]


@pytest.mark.parametrize("name,spec", [("FP", FP), ("FR", FR)])
def test_strict_header_constants(name, spec):
    """p and -p^-1 mod R in the 32-bit words of csrc/strict16.cuh."""
    W = spec.num_limbs // 2
    for const, value in (("P", spec.modulus), ("NINV", spec.ninv)):
        m = re.search(rf"__constant__ uint32_t {name}_{const}\[{W}\] = \{{([^}}]*)\}};", STRICT)
        assert m, f"{name}_{const} not found in strict16.cuh"
        words = [int(v.strip().rstrip("u"), 16) for v in m.group(1).split(",")]
        assert words == [(value >> 32 * k) & 0xFFFFFFFF for k in range(W)]


@pytest.mark.parametrize(
    "kernel",
    [MM.KERNEL, MB.KERNEL, K3.KERNEL, K4.KERNEL, PS.PREPARE_KERNEL, PS.MILLER_KERNEL,
     MB.KERNEL_G2, MB.KERNEL_G2_WORDS, *SF.KERNELS.values(), K11.KERNEL, K12.KERNEL,
     MB.KERNEL_G1_WORDS, FI.KERNEL_INV, FI.KERNEL_UP, FI.KERNEL_DOWN, FE.KERNEL_EASY,
     FE.KERNEL_HARD, K4.KERNEL_WORDS, K4.KERNEL_LIMBS, FI.KERNEL_INV_LIMBS,
     PS.PREPARE_KERNEL_LIMBS, PS.MILLER_KERNEL_LIMBS, FE.KERNEL_EASY_LIMBS,
     K4.KERNEL_LIMBS_LIMBS, SM.KERNEL_WORDS, SM.KERNEL_ACC, SM.KERNEL_SPLIT, SM.KERNEL_RED,
     SM.KERNEL_HORNER],
    ids=["mont_mul", "bucket", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step",
         "bucket_g2", "g2_point_words", *("strict_" + op for op in SF.KERNELS), "fp12_sqr",
         "fp12_mul_by_014", "g1_point_words", "fp_inv", "scan_up", "scan_down",
         "final_exp_easy", "final_exp_hard", "fp12_mul_words", "fp12_mul_limbs",
         "fp_inv_limbs", "prepare_chain_limbs", "miller_chain_limbs", "final_exp_easy_limbs",
         "fp12_mul_limbs_limbs", "scan_acc_words", "scan_acc", "scan_acc_split", "scan_red",
         "scan_horner"])  # scan_acc: the walk's entry, scan_msm_accumulate
def test_kernel_sources_export_their_entry(kernel):
    src = (KC.CSRC_DIR / kernel.source).read_text()
    assert re.search(rf'extern "C" int {kernel.symbol}\(', src)
    assert any(f'#include "{h}"' in src
               for h in ("lazy13.cuh", "tower381.cuh", "group381.cuh", "strict16.cuh",
                         "fp_inv.cuh", "final_exp.cuh", "scan_msm.cuh"))
    assert kernel.lib_path.parent == KC.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in KC.NVCC_FLAGS


@pytest.mark.parametrize("bad", ["rows", "digits_or_batch", "dtype", "device"])
@pytest.mark.parametrize("kernel", ["cyc_sqr", "fp12_mul", "prepare_step", "miller_step",
                                    "fp12_sqr", "fp12_mul_by_014", "final_exp_easy",
                                    "final_exp_hard", "fp12_mul_words", "fp12_mul_limbs",
                                    "fp12_mul_limbs_limbs"])
def test_tower_wrappers_reject_what_the_kernels_do_not_take(kernel, bad):
    """Only (rows, 30, N) int32 stacks (K4's word layouts: (12, 12, N)
    words) on one device reach a tower kernel, and only CPU tensors take
    the plain version: a meta tensor raises."""
    import torch

    rows = {"cyc_sqr": [12], "fp12_mul": [12, 12], "prepare_step": [6, 4],
            "miller_step": [12, 6, 2], "fp12_sqr": [12], "fp12_mul_by_014": [12, 6],
            "final_exp_easy": [12], "final_exp_hard": [12], "fp12_mul_words": [12, 12],
            "fp12_mul_limbs": [12, 12], "fp12_mul_limbs_limbs": [12, 12]}[kernel]
    width = 12 if kernel.startswith("fp12_mul_") and "014" not in kernel else 30
    width = 24 if kernel == "fp12_mul_limbs_limbs" else width
    ops = [torch.zeros((r, width, 4), dtype=torch.int32) for r in rows]
    if bad == "rows":
        ops[-1] = torch.zeros((rows[-1] + 1, 30, 4), dtype=torch.int32)
    elif bad == "digits_or_batch":  # a batch that differs, or 29 digits for one operand
        shape = (rows[-1], 30, 5) if len(rows) > 1 else (rows[-1], 29, 4)
        ops[-1] = torch.zeros(shape, dtype=torch.int32)
    elif bad == "dtype":
        ops[0] = ops[0].long()
    else:
        ops = [x.to("meta") for x in ops]
    call = {"cyc_sqr": lambda: K3.cyc_sqr(ops[0], 1),
            "fp12_mul": lambda: K4.fp12_mul(*ops),
            "prepare_step": lambda: PS.prepare_step(*ops),
            "miller_step": lambda: PS.miller_step(*ops, True),
            "fp12_sqr": lambda: K11.fp12_sqr(ops[0]),
            "fp12_mul_by_014": lambda: K12.fp12_mul_by_014(*ops),
            "final_exp_easy": lambda: FE.easy(ops[0]),
            "final_exp_hard": lambda: FE.hard(ops[0]),
            "fp12_mul_words": lambda: K4.fp12_mul(*ops, out="words"),
            "fp12_mul_limbs": lambda: K4.fp12_mul(*ops, out="limbs"),
            "fp12_mul_limbs_limbs": lambda: K4.fp12_mul(*ops)}[kernel]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("bad", ["dtype", "device", "shape"])
@pytest.mark.parametrize("chain", ["scan_acc", "scan_red", "scan_horner"])
def test_scan_wrappers_reject_what_the_kernels_do_not_take(chain, bad):
    """The scan chains take int32 strict limb stacks on one device, their
    point leaves (24, *batch) and scan-acc's digits (W, N) with N a multiple
    of the lanes; anything else raises (a meta tensor too: only CPU
    tensors take the plain loops)."""
    import torch

    from ark_blst_tpu_torch.curves.group import G1

    batch = {"scan_acc": (8,), "scan_red": (4, 16), "scan_horner": (4,)}[chain]
    pt = tuple(torch.zeros((24, *batch), dtype=torch.int32) for _ in range(3))
    digits = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        pt = (pt[0].long(), *pt[1:])
    elif bad == "device":
        pt = tuple(x.to("meta") for x in pt)
        digits = digits.to("meta")
    elif chain == "scan_acc":
        digits = digits[:, :7]  # 7 points do not split into 2 lanes
    else:
        pt = tuple(x[:23] for x in pt)
    call = {"scan_acc": lambda: SM.bucket_accumulate(G1, pt, digits, 2, 4),
            "scan_red": lambda: SM.bucket_reduce(G1, pt),
            "scan_horner": lambda: SM.horner(G1, pt, 4)}[chain]
    with pytest.raises(ValueError):
        call()


def test_chain_schedule_limit_matches_the_header():
    """The wrappers refuse the schedules the chain kernels refuse."""
    assert re.search(rf"constexpr int MAX_EVENTS = {PS.MAX_EVENTS};", TOWER)


@pytest.mark.parametrize("bad", ["rows", "events", "dtype", "device"])
@pytest.mark.parametrize("kernel", ["prepare_chain", "miller_chain", "prepare_lines",
                                    "miller_lines"])
def test_chain_wrappers_reject_what_the_kernels_do_not_take(kernel, bad):
    """K5's and K6's chains take (rows, 30, N) int32 stacks, lines (E', 6,
    30, N) with E' at least the schedule's events, 1 to MAX_EVENTS events,
    all on one device; the fused pipeline's entries strict (24, N) limbs
    and lines (E', 6, 12 or 30, N); only CPU tensors take the plain
    version."""
    import torch

    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    sched = [True, False]
    q, f, c, pxy = z(4, 30, 4), z(12, 30, 4), z(2, 6, 30, 4), z(2, 30, 4)
    limbs, words = [z(24, 4) for _ in range(4)], z(2, 6, 12, 4)
    if bad == "rows":
        q, pxy, words = z(5, 30, 4), z(3, 30, 4), z(2, 6, 24, 4)
        limbs[-1] = z(23, 4)
    elif bad == "events":  # one past the longest schedule; more events than lines
        sched = [True] * (PS.MAX_EVENTS + 1) if kernel.startswith("prepare") else [True] * 3
    elif bad == "dtype":
        q, f, words = q.long(), f.long(), words.long()
        limbs = [x.long() for x in limbs]
    else:
        q, f, c, pxy, words = (x.to("meta") for x in (q, f, c, pxy, words))
        limbs = [x.to("meta") for x in limbs]
    with pytest.raises(ValueError):
        if kernel == "prepare_chain":
            PS.prepare_chain(q, sched)
        elif kernel == "miller_chain":
            PS.miller_chain(f, c, pxy, sched)
        elif kernel == "prepare_lines":
            PS.prepare_lines(((limbs[0], limbs[1]), (limbs[2], limbs[3])), sched)
        else:
            PS.miller_lines(words, (limbs[2], limbs[3]), sched)


@pytest.mark.parametrize("call", ["prepare_digits", "miller_limbs_from_words",
                                  "miller_words_from_limbs", "miller_digits_from_limbs"])
def test_chain_edges_reject_layouts_without_an_instantiation(call):
    """The chains' entries take only the edge layouts that have an
    instantiation: K5-chain stores the lines as words or strict limbs;
    K6-chain stores conj(f) as strict limbs from strict lines alone, and
    from strict lines nothing else."""
    import torch

    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    q, p, sched = ((z(24, 4), z(24, 4)), (z(24, 4), z(24, 4))), (z(24, 4), z(24, 4)), [True]
    with pytest.raises(ValueError):
        if call == "prepare_digits":
            PS.prepare_lines(q, sched, PS.FMT_DIGITS)
        elif call == "miller_limbs_from_words":
            PS.miller_lines(z(1, 6, 12, 4), p, sched, PS.FMT_LIMBS)
        elif call == "miller_words_from_limbs":
            PS.miller_lines(z(1, 6, 24, 4), p, sched, PS.FMT_WORDS)
        else:
            PS.miller_lines(z(1, 6, 24, 4), p, sched)


def test_identity_rows_decode_to_identity():
    import torch

    rows = torch.from_numpy(MB.KC2_G1.identity_rows())[:, None]
    x, y, z = MB.KC2_G1.rows_to_point(rows)
    assert LZ.digits_to_ints(x) == [0] and LZ.digits_to_ints(z) == [0]
    assert LZ.digits_to_ints(y) == [LZ.R13_MOD_P]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(KC.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    kernel = KC.CudaKernel("mont_mul.cu", "lz_mont_mul", [])
    if kernel.lib_path.exists():
        pytest.skip("the kernel library is already built here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()
    assert kernel.launches == 0


def test_g2_identity_rows_decode_to_identity():
    import torch

    rows = torch.from_numpy(MB.KC2_G2.identity_rows())[:, None]
    x, y, z = MB.KC2_G2.rows_to_point(rows)
    assert [LZ.digits_to_ints(c) for c in x + z] == [[0]] * 4
    assert LZ.digits_to_ints(y[0]) == [LZ.R13_MOD_P] and LZ.digits_to_ints(y[1]) == [0]


def test_build_all_starts_one_nvcc_per_source(monkeypatch):
    """K7-K10 share csrc/strict_field.cu: one build serves all four."""
    started = []
    monkeypatch.setattr(KC.CudaKernel, "start_build", lambda self: started.append(self) or None)
    owners = KC.build_all([MM.KERNEL, *SF.KERNELS.values()])
    assert sorted(k.source for k in owners) == ["mont_mul.cu", "strict_field.cu"]
    assert started == owners


def test_every_kernel_source_is_built_once(monkeypatch):
    """The thirteen kernel sources of the port, one nvcc each: every
    `csrc/*.cu` belongs to a kernel, the tower kernels K11/K12 have their
    own, K1-inv, K1-scan's two passes and K7-inv share `fp_inv.cu`,
    FE-easy and FE-hard share `final_exp.cu`, K4's four layouts
    `fp12_mul.cu`, the chains' strict instantiations their sources, and
    the scan MSM's three chains `scan_msm.cu`."""
    started = []
    monkeypatch.setattr(KC.CudaKernel, "start_build", lambda self: started.append(self) or None)
    kernels = [MM.KERNEL, MB.KERNEL, MB.KERNEL_G2, K3.KERNEL, K4.KERNEL, PS.PREPARE_KERNEL,
               PS.MILLER_KERNEL, *SF.KERNELS.values(), K11.KERNEL, K12.KERNEL,
               FI.KERNEL_INV, FI.KERNEL_UP, FI.KERNEL_DOWN, FE.KERNEL_EASY, FE.KERNEL_HARD,
               K4.KERNEL_WORDS, K4.KERNEL_LIMBS, FI.KERNEL_INV_LIMBS, PS.PREPARE_KERNEL_LIMBS,
               PS.MILLER_KERNEL_LIMBS, FE.KERNEL_EASY_LIMBS, K4.KERNEL_LIMBS_LIMBS,
               *SM.KERNELS.values()]
    owners = KC.build_all(kernels)
    assert sorted(k.source for k in owners) == sorted(p.name for p in KC.CSRC_DIR.glob("*.cu"))
    assert len(owners) == 13 and started == owners


def test_cached_build_keeps_its_ptxas_log(monkeypatch, tmp_path):
    """A process that finds a kernel's library already built still reads the
    ptxas report of its build (registers, stack, spills), from the log kept
    beside the library, and starts no nvcc; a library without its log is
    rebuilt. A stand-in nvcc writes the library and a ptxas line."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
        "echo \"ptxas info    : Used 128 registers, used 0 barriers, 64 bytes cumulative"
        " stack size\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(KC, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(KC, "BUILD_DIR", tmp_path / "kernels")

    first = KC.CudaKernel("mont_mul.cu", "lz_mont_mul", [])
    (owner,) = KC.build_all([first])
    assert "Used 128 registers" in owner.build_log
    assert owner.lib_path.exists() and owner.log_path.exists()

    again = KC.CudaKernel("mont_mul.cu", "lz_mont_mul", [])
    (owner,) = KC.build_all([again])
    assert owner.build_log == first.build_log
    assert calls.read_text().count("run") == 1

    again.log_path.unlink()
    rebuilt = KC.CudaKernel("mont_mul.cu", "lz_mont_mul", [])
    rebuilt.build()
    assert "Used 128 registers" in rebuilt.build_log
    assert calls.read_text().count("run") == 2


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_words_wrapper(curve):
    """`MB.point_words` on CPU rows is its plain version, and it raises for
    rows the conversion kernels do not take: another row count, another
    dtype, a device that is neither the CPU nor CUDA."""
    import numpy as np
    import torch

    kc = MB.KC2_G2 if curve == "g2" else MB.KC2_G1
    rng = np.random.default_rng(5)
    comps = [torch.from_numpy(rng.integers(-4096, 4097, (30, 64)).astype(np.int32))
             for _ in range(kc.aff_rows // 15)]
    pts = torch.cat([MB.pack30(d) for d in comps])
    words = MB.point_words(kc, pts)
    assert words.shape == (kc.word_rows, 64) and words.dtype == torch.int32
    assert torch.equal(words, MB.point_words_plain(kc, pts))
    for bad in (pts[1:], pts.long(), pts.to("meta")):
        with pytest.raises(ValueError):
            MB.point_words(kc, bad)
