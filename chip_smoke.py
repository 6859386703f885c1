#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ark_blst_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds and runs its main path there.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env      the card's name and power limit; builds the kernels from
              their ten sources (one nvcc per source, all in parallel) and
              reports build seconds, registers, spills and static SASS
              counts;
  2. k1       K1 (mont_mul) against its plain PyTorch version at 2^22
              elements, bit for bit, random and extreme digit patterns,
              and again timed at the pairing's batch (8192 elements);
  3. k2       K2 (G1 bucket accumulation) at the main path's inputs (2^22
              points, c=7, W=37): its first kernel, the points' conversion
              to R16 words (`point_words`), against its plain version bit
              for bit; its bucket kernel (32-bit Montgomery words) against
              the plain version (radix-13 digits) by canonical value,
              bucket for bucket, with its dump digits within 4096; each
              kernel timed alone and the wrapper with both; registers,
              stack, spills and launch shape (blocks, waves); the bound
              beside the bound of the same work on radix-13 digits;
  4. msm      the G1 MSM at 2^22 distinct bases with c=7 (built on the card
              by `curves/instance.py`, with an identity point and a zero
              scalar in the stream) through the public entry point
              `msm_g1`, checked against the expected point, with the launch
              counts of that run and its points/s; then the four stages
              rerun one by one with a synchronize between them, once for
              the stage times and once under `torch.profiler` for each
              stage's device time, kernel launches and device busy share;
  5. k2_g2    K2-G2 at the G2 main path's inputs (2^20 points, c=5,
              W=52), checked and measured as K2 in phase 3;
  6. msm_g2   the G2 MSM at 2^20 distinct bases with c=5 (the JAX
              package's bench.py size, built on the card by
              `curves/instance.py`, seed 11, with an identity point and a
              zero scalar) through the public entry point `msm_g2`,
              checked against the expected point, with the launch counts
              of that run, its peak memory and its points/s, then the
              stages rerun and profiled as in phase 4;
  7. k3-k6    the pairing's tower kernels against their plain versions at
              the pairing batch (N = 8192): random mul-ready digits with
              the extreme patterns of k1; K3 (cyclotomic squares) at n = 1
              and at the longest run of the exponent ladder (32), K4 (fp12
              product), K5 (prepare event) and K6 (Miller event) in both
              forms, each also on real event inputs taken from the
              pipeline; then K11 (fp12 square) and K12 (sparse line
              product, phase `k11_k12`) on random digits and on f and the
              scaled line of a real Miller event; all six (32-bit
              Montgomery words inside, csrc/tower381.cuh) by canonical
              value, their digits within 4096, the random operands of
              K4-K6, K11 and K12 with the top digit bounded (|value| < 8p,
              where the plain versions are field operations), each with
              its registers, stack, shared memory and launch shape and its
              bound beside the radix-13 one;
  8. pairing  8192 pairings of 8 distinct (P, Q) pairs (P_i = P[i mod 8],
              Q_i = Q[(3i+1) mod 8], the construction of the JAX package's
              bench.py) with one identity P and one identity Q, through the
              public entry `bls12.pairing_batch`: every result checked
              against the oracle pairing (the identity pairs against one),
              the launches of K1 and K3-K6 in that call, pairings/s of a
              warm call, the stages (ingest, prepare_g2, miller_loop,
              final_exp, egress) rerun with a synchronize between them and
              once more under `torch.profiler`, the peak device memory;
              then the prepared path (`prepare_g2_batch` once,
              `pairing_batch` against it), checked equal to the unprepared
              results;
     pairing_unfused  the same instance through `bls12.pairing_batch(...,
              fuse=False)`: every result checked against the oracle and the
              fused results (the two paths' digits differ on the card, K11
              and K12 on 32-bit words, their values agree), K11 launched
              63 and K12 68 times, K5/K6 never,
              with pairings/s, stages and their launches, a profiled
              rerun, peak memory and the prepared path with fuse=False;
     pairing_strict  the same instance through the tensor entry
              `pairing(..., engine="strict")`: limb for limb against the
              lazy engine's output and against the oracle, on K7-K10 alone
              (every other kernel at 0 launches), with stages, K7-K10
              launches per stage, per Miller event (mean) and per
              cyclotomic square, and a profiled rerun; then `multi_pairing` and
              `multi_miller_loop_prepared` on both engines at 1024 pairs,
              equal to each other and the first to the oracle's product;
     api      the arkworks API's batch entries with their defaults (the
              card's routes): `G1Projective.msm` over 2^20 G1Affine bases
              of `curves/instance.py` (made affine on the card, brought to
              the host, the identity and the zero scalar included) with
              Scalar scalars, and `G2Projective.msm` over 2^16, each
              checked against the instance's expected point, with the
              call's seconds split into host ingest, `msm_g1`/`msm_g2`
              and egress (`_CallClock`), points/s and K1/K2 launches; the
              phase-8 instance through `Bls12.pairing_batch` on
              G1Affine/G2Projective, plain and prepared, equal to phase
              8's checked results, its split and pairings/s beside a
              tuple-level call's; `Bls12.multi_miller_loop` then
              `final_exponentiation` over the first 1024 pairs against the
              oracle's product; the generator pairing's bytes and every
              `msm_g1` vector of `tests/vectors/bls12_381.json` through
              the device routes; a validated compressed round trip of the
              MSM results and 64 bases a curve;
     fp_inv_batch  `tower_lazy.fp_inv_batch` against `fp_inv` at 8192
              elements, both checked against the oracle's inverses, timed;
  9. k7_k10   the strict engine's kernels K7-K10 (mont_mul, add, sub, neg)
              against their plain versions, bit for bit, at Fp (2^22
              elements) and Fr (2^20): seeded random canonical values with
              every pair of extreme values (0, 1, p-1, p-2, all-ones low
              limbs below p) in the first columns; the plain versions run in
              chunks of 2^20 elements; then once more on the MSM's broadcast
              pair (24, 1024, 32, 1) x (24, 1024, 1, 1);
 10. fpmul    32 chained K7 products over 2^20 Fp elements (bench.py's
              bench_fpmul), checked against the oracle, products/s;
 11. msm_scan the strict engine's scan Pippenger MSM (`curves/msm.py:msm`)
              at 2^20 distinct G1 bases (`curves/instance.py`, with an
              identity point and a zero scalar), c = 8, 1024 lanes, then
              `G1.to_affine` of the result on the card, both checked
              against the expected point, with the launches of K7-K10 in
              that run, its peak memory and points/s; then the stages
              (digits, accumulate, fold, reduce, horner) rerun with a
              synchronize between them, and once more under
              `torch.profiler`;
 12. msm_scan_g2  the same for G2 at 2^18 bases, c = 8, 256 lanes; its
              `to_affine` inverts in Fp2, which launches K10;
 13. msm_naive   a 2^12 G1 instance through `msm_naive` and through `msm`,
              both checked, and `G1.to_affine` of the 2^12 bases (one batch
              inversion, one Fermat ladder at batch 1 on K7) checked point
              for point against the host's affine values;
phase distributed, the sharded entries on `torch.distributed`, in lines
`distributed_*` among the phases above, each path's launches counted from
0 just before it and read just after:
     distributed_init  a world of one over NCCL in this process
              (`distributed.initialize`, `global_mesh`), formed before
              phase msm so that the instances below are reused;
     distributed_msm, distributed_msm_g2  `msm_distributed` (backend
              "pallas": K1, K2 or K2-G2 and its point conversion on the
              rank) on phase msm's 2^22 G1 instance at c = 7 and phase
              msm_g2's 2^20 G2 instance at c = 5 before they are freed,
              checked against the expected point, its warm seconds in
              turns with the single-device entry's (sharded, single,
              single, sharded), the gather's bytes and time, and a
              profiled rerun (device time, busy share);
     distributed_pairing  `multi_pairing_sharded` over the phase-8
              instance (8192 pairs, fused, 68 events, the final
              exponentiation) after phase api: equal to the oracle's
              product of the checked pairings and, limb for limb, to the
              unsharded `multi_pairing`, timed in turns with it, with K1
              and K3-K6 launches, the gather and a profiled rerun;
     distributed_msm_scan  `msm_sharded` (the scan MSM, K7-K10) at 2^16
              G1 bases, c = 8, 1024 lanes, `finish="host"`;
     distributed_msm_auto  `msm_auto` at 2^20 G1 bases on the card: one K2
              launch (the bucket route), no strict kernel, the point
              checked; then the world of one is destroyed;
     distributed_two_ranks  two ranks over gloo on the one card (NCCL
              refuses two ranks on one device): this script twice more,
              `--rank R --world 2 --port P --out FILE`, each rank on cuda:0
              running the sharded G1 MSM at 2^20, c = 7, chunk 2^19 (K1,
              K2 on its shard), and the sharded pairing over the first 1024
              pairs of the phase-8 instance with the final exponentiation;
              both ranks' results equal to each other and to the expected
              point and the oracle's product; a rank that fails or passes
              300 s fails the phase (every child killed);
     distributed  the phase's seconds, part by part;
then the `kernels` line (time, launches, bound and plain time per kernel;
K1 gives its G1 MSM launches as `launches`, its G2 MSM launches as
`launches_msm_g2`, its fused and unfused pairing launches as
`launches_pairing` and `launches_pairing_unfused` and its times at 8192
elements as `at_pairing_batch`; K3 and K4 give the fused pairing's
launches, the unfused one's beside; K11 and K12 the unfused pairing's;
K7-K10 give as `launches` the sum over the two scan MSM runs, each run's
count and the strict pairing's beside it, and their Fp times at 2^22, Fr
and broadcast times beside; every kernel phase distributed launches gives
those launches per path as `launches_distributed`) and, last, {"ok": true, "device": {...}}. Any failure raises: the
script then exits non-zero and prints no last line. Without CUDA it exits 1.

Bound model (bound_ms): the larger of bytes / 3.35e12 B/s and int32
instructions / 33.5e12 per s. The instruction rate is the float32 rate of
the H100's data sheet (67 TFLOP/s, an FMA counted as two) in instructions:
132 SMs x 128 lanes x 1.98 GHz, one instruction per lane per clock, i.e.
the issue ceiling with the IMAD and integer-ALU pipes both busy.
Instruction counts follow the kernels' straight-line code: a digit product
or multiply-add is one, a balanced fold four per digit (add, and, add3,
shift). K1's bytes read each input once and write the output once. K2
and K2-G2 run on 12 x 32-bit words: a CIOS Montgomery product is 912
instructions (three per 32 x 32 -> 64-bit multiply-add with its carry,
2 x 144 of them, and the final subtraction), a modular sum 60, a G1
bucket add 11,388 (G1_BUCKET_ADD_OPS: 11 products, 21 Fp sums, 96 words
loaded and stored), a G2 bucket add 36,348 (G2_BUCKET_ADD_OPS: 33
products, 46 Fp sums and the Fp2 Karatsuba glue), and once per bucket
component its conversion to the dump's digits; their bytes count the
points' words, the digits and the dump once, and per add a bucket read
and written (36 or 72 words) and a point read (24 or 48 words). Their
lines also give the bound of the same work as the radix-13 kernels they
replaced counted it (36,735 a G1 bucket add, G1_R13_BUCKET_ADD_OPS;
94,039 a G2 one, G2_R13_BUCKET_ADD_OPS). Their first kernels, the points'
conversion to words (`g1_point_words`, `g2_point_words`), count
POINT_COMPONENT_OPS per component and the packed rows read and the words
written once. Beside the bound each kernel line gives the IMAD-pipe
floor: the IMAD instructions of the compiled kernel (`cuobjdump -sass`,
static count; both kernels are straight-line code around their loops; a
bucket kernel's count is its library's, which also holds the two
conversions, a product each)
over 132 SMs x 64 per clock x 1.98 GHz = 16.7e12 per s. The radix-13
bounds of the tower kernels count their base products times
MONT_MUL_OPS plus the folded glue of each tower operation (the op model
below), and bytes as each input read once and the output written once.
K3-K6, K11 and K12 run on 12 x 32-bit words (csrc/tower381.cuh):
CYC_SQR32_OPS a square (18 CIOS products and 107 modular sums),
FP12_MUL32_OPS a product of fp12s (54 and 224), PREPARE32_OPS a doubling
(25, 87 and 2 negations) or an addition (37, 107 and 2), MILLER32_OPS an
event (85 or 49 products and 277 or 119 sums), FP12_SQR32_OPS an fp12
square (36 and 158), MUL_BY_014_32_OPS a sparse line product (45 and
119), and per launch the conversion of each input Fp component from digits to
words (DIGITS_TO_WORDS_OPS) and of each output one back
(WORDS_TO_DIGITS_OPS); their lines give the radix-13 work's bound beside
(`bound_radix13_ms`), and their IMAD floor counts the launch's products
(conversions included) at the IMAD instructions of one product of their
own library: its static IMAD count (moves left out) over the CIOS bodies
it compiles (its wide multiply-adds over the 288 of one product). The
strict kernels K7-K10 count bytes as 4 L per operand and result element
(int32 limbs), and instructions by `strict_ops`: three per 32 x 32-bit
word product, two per word of a carry chain, three per word of the
conditional subtraction, two per word packed or unpacked; every one of
them is bytes-bound.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
IMAD_PER_S = 132 * 64 * 1.98e9
LOG_N = 22
C = 7
SEED = 7
G2_LOG_N = 20  # bench.py:bench_msm_g2
G2_C = 5
G2_SEED = 11
PAIRING_N = 8192
PAIRING_DISTINCT = 8
IDENTITY_P_AT, IDENTITY_Q_AT = 3, 10
STRICT_MULTI_N = 1024  # multi_pairing / multi_miller_loop_prepared on both engines
STRICT_LOG_N = {"fp": 22, "fr": 20}
STRICT_PLAIN_CHUNK = 1 << 20
FPMUL_N, FPMUL_ITERS = 1 << 20, 32  # bench.py:bench_fpmul
SCAN_C = 8  # the JAX package's msm default: W = 32, B = 256
# curve: (log2 bases, lanes, seed); G2 is cut to 2^18 for the Fp2 fold's
# temporaries (3x G1's per element) and the time limit
SCAN = {"g1": (20, 1024, 17), "g2": (18, 256, 19)}
NAIVE_LOG_N, NAIVE_SEED = 12, 23
# the API phase: curve -> (log2 bases, seed); 2^20 is a KZG/Groth16 size, 2^22
# would spend ~2 minutes in the host codecs alone
API_MSM = {"g1": (20, 29), "g2": (16, 31)}
API_MULTI_N = 1024
API_ROUNDTRIP = 64
# phase distributed: the sharded scan MSM and msm_auto instances (log2 bases,
# seed), the two-rank world's G1 MSM (log2 bases, seed, chunk a rank) and
# pairs, its timeout, and the gathers timed per measurement
DIST_SCAN_LOG_N, DIST_SCAN_SEED = 16, 37
DIST_AUTO_LOG_N, DIST_AUTO_SEED = 20, 41
TWO_RANK_LOG_N, TWO_RANK_SEED, TWO_RANK_CHUNK = 20, 43, 1 << 19
TWO_RANK_PAIRS = 1024
TWO_RANK_TIMEOUT = 300
GATHER_REPS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# --- operation counts of the kernels' code (per element / per bucket add) ----

def _fold(n: int) -> int:  # add, and, add3, shift per digit
    return 4 * n


_MUL_COLS = 30 * 30
_PRERED = _MUL_COLS + _fold(59) + _fold(60)
_REDUCE = _fold(61) + 30 * 31 // 2 + _fold(30) + _fold(31) + _MUL_COLS + _fold(62) + _fold(63)
MONT_MUL_OPS = _PRERED + _REDUCE
_FOLD_SUM = _fold(30)
MIXED_ADD_OPS = (
    5 * MONT_MUL_OPS + 2 * (30 + _FOLD_SUM)  # round 1 and its two folded sums
    + 8 * 30 + 7 * _FOLD_SUM  # the linear glue between the rounds
    + 6 * _PRERED + 3 * 61 + 3 * _REDUCE  # round 2 and its three reductions
)
# The G1 and G2 additions on radix-13 digits (the kernels they replaced,
# kept as the yardstick of the redesign). G2: a Karatsuba triple is 3
# prered products, 2 folded leg sums and the re/im combinations; 11
# triples, 16 reductions
G1_R13_BUCKET_ADD_OPS = MIXED_ADD_OPS + 75 * 4 + 3 * (_fold(30) + _fold(31)) + 45 * 4
_FP2_PRERED = 3 * _PRERED + 2 * (30 + _FOLD_SUM) + 3 * 61
G2_R13_MIXED_ADD_OPS = (
    5 * (_FP2_PRERED + 2 * _REDUCE) + 4 * (30 + _FOLD_SUM)  # round 1 and its folded sums
    + 2 * (8 * 30 + 7 * _FOLD_SUM) + 4 * 30  # the glue on both components, mul_b3's (1 + u)
    + 6 * _FP2_PRERED + 6 * 61 + 6 * _REDUCE  # round 2 and its six reductions
)
G2_R13_BUCKET_ADD_OPS = G2_R13_MIXED_ADD_OPS + 150 * 4 + 6 * (_fold(30) + _fold(31)) + 90 * 4

# K2 and K2-G2 on the 32-bit Montgomery layer (csrc/fp381.cuh,
# csrc/group381.cuh), 12 words an element: a 32 x 32 -> 64-bit multiply-add with its carry is
# three instructions (IMAD.WIDE.U32 and a two-word add), a word of a carry
# chain two, a select or mask one
_NW = 12
MONT_MUL32_OPS = _NW * (2 * _NW * 3 + 1) + 3 * _NW  # CIOS rows, the conditional subtraction
ADD32_OPS = 2 * _NW + 3 * _NW  # add, sub, and sub: a carry chain, then the subtraction of p
NEG32_OPS = 4 * _NW  # the zero test, the borrow chain, the mask
FP2_MUL32_OPS = 3 * MONT_MUL32_OPS + 5 * ADD32_OPS  # Karatsuba: 2 leg sums, 3 differences
# 11 Fp2 products and 46 Fp sums: the six Fp2 sums and differences of round 1
# and three of round 2 (18), two mul_b3 (a sum, a difference and twice 12x
# by four doublings: 20), 3 t0 (4), and t3's two differences (4)
G2_MIXED_ADD32_OPS = 11 * FP2_MUL32_OPS + 46 * ADD32_OPS
G2_BUCKET_ADD_OPS = G2_MIXED_ADD32_OPS + 2 * 72 + 48  # + bucket load/store, point load
# 11 Fp products and 21 Fp sums: four sums of round 1, t3's two
# differences, z3 and t1m (8), two mul_b3 (12x by four doublings: 8), 3 t0
# (2) and the three sums of round 2
G1_MIXED_ADD32_OPS = 11 * MONT_MUL32_OPS + 21 * ADD32_OPS
G1_BUCKET_ADD_OPS = G1_MIXED_ADD32_OPS + 2 * 36 + 24  # + bucket load/store, point load
BUCKET_ADD_OPS = {"g1": G1_BUCKET_ADD_OPS, "g2": G2_BUCKET_ADD_OPS}
R13_BUCKET_ADD_OPS = {"g1": G1_R13_BUCKET_ADD_OPS, "g2": G2_R13_BUCKET_ADD_OPS}
# one bucket component into the dump's digits: the product by 2^390 mod p,
# 30 digits cut out (three instructions each), one balanced fold, packing
DUMP_COMPONENT_OPS = MONT_MUL32_OPS + 30 * 3 + _fold(30) + 15 * 3
# one point component into words: 30 digits placed (six instructions each),
# the carries (two a word), 11 conditional subtractions of 2^k p (four a
# word of 13), the product by 2^378
POINT_COMPONENT_OPS = 30 * 6 + 2 * 13 + 11 * 4 * 13 + MONT_MUL32_OPS

# the tower's work on radix-13 digits, per element: the yardstick
# (`bound_radix13_ms`) of K3-K6, K11 and K12, which ran on such digits
# before they moved to 32-bit words
_LIN = 30 + _fold(30)  # fp add / sub / small scale: the digit op, then fold30
_LIN2 = 2 * _LIN  # the same on fp2 (and fp2_mul_by_nonresidue)
FP2_MUL_OPS = 3 * MONT_MUL_OPS + 3 * _LIN + 60 + _fold(30)
FP2_SQR_OPS = 2 * MONT_MUL_OPS + 3 * _LIN
FP6_MUL_OPS = 6 * FP2_MUL_OPS + 17 * _LIN2
FP12_MUL_OPS = 3 * FP6_MUL_OPS + 16 * _LIN2
FP12_SQR_OPS = 2 * FP6_MUL_OPS + 17 * _LIN2
MUL_BY_014_OPS = 15 * FP2_MUL_OPS + 23 * _LIN2
CONTRACT_OPS = 3 + 2 * 30 + 2 * _fold(30)
CYC_SQR_OPS = 12 * CONTRACT_OPS + 9 * FP2_SQR_OPS + 34 * _LIN2
PREPARE_OPS = {False: 8 * FP2_SQR_OPS + 3 * FP2_MUL_OPS + 20 * _LIN2 + 60,  # doubling
               True: 8 * FP2_SQR_OPS + 7 * FP2_MUL_OPS + 23 * _LIN2 + 60}  # addition
MILLER_OPS = {True: FP12_SQR_OPS + 4 * MONT_MUL_OPS + MUL_BY_014_OPS,  # with the square
              False: 4 * MONT_MUL_OPS + MUL_BY_014_OPS}
# K3, K6, K11 and K12 on the 32-bit tower (csrc/tower381.cuh), per element.
# A cyclotomic square: 18 products and 107 Fp sums (the nine Fp2 squares'
# 27, the three pair sums' 6, t, s and r with xi 26, 3t +- 2z 48). The fp12
# square (K11, K6's first half): 36 products and 158 sums (the legs'
# operand sums 38, twelve Fp2 Karatsuba recombinations 60, two fp6
# interpolations 40, g 20). The sparse product (K12, K6's second half): 45
# products and 119 sums (fifteen recombinations 75, s and c14 8, the
# combination 36). An event: the square, the line's 4 products, the sparse
# product.
CYC_SQR32_OPS = 18 * MONT_MUL32_OPS + 107 * ADD32_OPS
FP12_SQR32_OPS = 36 * MONT_MUL32_OPS + 158 * ADD32_OPS
MUL_BY_014_32_OPS = 45 * MONT_MUL32_OPS + 119 * ADD32_OPS
MILLER32_OPS = {True: FP12_SQR32_OPS + 4 * MONT_MUL32_OPS + MUL_BY_014_32_OPS,
                False: 4 * MONT_MUL32_OPS + MUL_BY_014_32_OPS}
# K4 and K5 on the 32-bit tower, per element, their sums counted as the
# plain code's algebra needs them, as K3's and K6's: a sum of W terms is
# W - 1 Fp2 additions, a shared sum counted once, a small multiple by
# doublings, xi two Fp sums. K4: 54 products and 224 Fp sums (the 18 Fp2
# Karatsuba recombinations 90; the operand sums 48, a0 + a1 and b0 + b1 12
# and the three fp6 products' leg sums 36; three fp6 interpolations 66; the
# result 20). The doubling (pairing_steps._doubling_step): 25 products, 87
# sums (the squares' and products' recombinations 39, the linear steps 48)
# and 2 negations (c1 = -2 m2); the addition: 37, 107 (59, 48) and 2.
FP12_MUL32_OPS = 54 * MONT_MUL32_OPS + 224 * ADD32_OPS
PREPARE32_OPS = {False: 25 * MONT_MUL32_OPS + 87 * ADD32_OPS + 2 * NEG32_OPS,
                 True: 37 * MONT_MUL32_OPS + 107 * ADD32_OPS + 2 * NEG32_OPS}
# one Fp component in: 30 digits biased and placed (six instructions each),
# the carries (two a word of 13), 12 conditional subtractions of 2^k p (four
# a word of 13), the product by 2^378; out: the product by 2^390, 30 digits
# cut out (three each), one balanced fold
DIGITS_TO_WORDS_OPS = 30 * 6 + 2 * 13 + 12 * 4 * 13 + MONT_MUL32_OPS
WORDS_TO_DIGITS_OPS = MONT_MUL32_OPS + 30 * 3 + _fold(30)
CIOS_WIDE_MULS = 2 * _NW * _NW  # a_j b_i and m p_j, 32 x 32 -> 64 bits each
PREPARE_PRODUCTS = {False: 25, True: 37}
PREPARE_INPUTS = {False: 6, True: 10}  # Fp components: R, and Q for the addition
MILLER_PRODUCTS = {True: 85, False: 49}
ELEM_BYTES = 30 * 4  # one Fp element of digits


def strict_ops(op: str, limbs: int) -> int:
    """int32 instructions per element of K7-K10 (csrc/strict16.cuh), W = L/2
    words: the product's 2 W^2 + W(W+1)/2 word products at three each and
    its W(W+1)/2 carry propagations at two; one carry chain (add, neg) or
    two (sub) at two per word; the conditional subtraction at three per
    word; packing two per word in, two per word out."""
    W = limbs // 2
    io = 2 * W * (1 if op == "neg" else 2) + 2 * W
    if op == "mont_mul":
        return 3 * (2 * W * W + W * (W + 1) // 2) + W * (W + 1) + 3 * W + io
    return 2 * W * (2 if op == "sub" else 1) + 3 * W + io


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_summary(log: str) -> dict:
    """Each kernel entry's registers and cumulative stack (`entries`, by
    mangled name), those of the entry with the most registers, and the
    spill bytes summed over all functions of the library."""
    out = {"spill_store_bytes": 0, "spill_load_bytes": 0, "entries": {}}
    entry, frame = None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            frame = int(parts[0])
            out["spill_store_bytes"] += int(parts[4])
            out["spill_load_bytes"] += int(parts[8])
        if "Used" in line and "registers" in line:
            stack = (int(line.split("barriers,")[1].split("bytes")[0])
                     if "cumulative stack size" in line else frame)
            out["entries"][entry] = {
                "registers": int(line.split("Used")[1].split("registers")[0]), "stack_bytes": stack}
    big = max(out["entries"].values(), key=lambda e: e["registers"],
              default={"registers": 0, "stack_bytes": 0})
    out.update(registers=big["registers"], registers_max=big["registers"],
               stack_bytes=big["stack_bytes"])
    return out


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _sass_counts(kernel) -> dict:
    """Static instruction counts of a built kernel library: all but NOPs,
    the IMAD family, of it the IMAD.MOV register moves and the 32 x 32 ->
    64-bit multiply-adds (IMAD.WIDE.U32 or IMAD.HI.U32, 288 in each
    12-word CIOS product)."""
    from ark_blst_tpu_torch import cuda as KC

    cuobjdump = os.path.join(os.path.dirname(KC._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel.lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = [m.group(1) for m in _SASS_OP.finditer(sass)]
    ops = [op for op in ops if op != "NOP"]
    return {"instructions": len(ops), "imad": sum(op.startswith("IMAD") for op in ops),
            "imad_mov": sum(op.startswith("IMAD.MOV") for op in ops),
            "imad_wide": sum(op.startswith(("IMAD.WIDE.U32", "IMAD.HI.U32")) for op in ops)}


def imad_floor_ms(imads: float) -> float:
    return 1e3 * imads / IMAD_PER_S


# --- phases --------------------------------------------------------------------

def all_kernels() -> dict:
    """The kernels by name: K1, K2 (the G1 and G2 MSMs; each bucket
    kernel's source also holds its point conversion), K3-K6 (the fused pairing), K7-K10 (the
    strict engine; one source, four entry points), K11 and K12 (the unfused
    pairing): ten sources."""
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import cyc_sqr as K3
    from ark_blst_tpu_torch.ops import fp12_mul as K4
    from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
    from ark_blst_tpu_torch.ops import fp12_sqr as K11
    from ark_blst_tpu_torch.ops import mont_mul as MM
    from ark_blst_tpu_torch.ops import strict_field as SF

    return {"mont_mul": MM.KERNEL, "bucket_accumulate": MB.KERNEL,
            "g1_point_words": MB.KERNEL_G1_WORDS,
            "bucket_accumulate_g2": MB.KERNEL_G2, "g2_point_words": MB.KERNEL_G2_WORDS,
            "cyc_sqr": K3.KERNEL,
            "fp12_mul": K4.KERNEL, "prepare_step": PS.PREPARE_KERNEL,
            "miller_step": PS.MILLER_KERNEL,
            **{"strict_" + op: k for op, k in SF.KERNELS.items()},
            "fp12_sqr": K11.KERNEL, "fp12_mul_by_014": K12.KERNEL}


def phase_env(torch):
    from ark_blst_tpu_torch import cuda as KC

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    owners = KC.build_all(list(all_kernels().values()))  # one per source
    build_s = time.perf_counter() - t0
    sass = {k.source: _sass_counts(k) for k in owners}
    ptxas = {k.source: _ptxas_summary(k.build_log) for k in owners}
    emit({
        "phase": "env", "gpu": smi[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "sources": len(owners), "ptxas": ptxas, "sass": sass,
    })
    return sass, ptxas


def extreme_cases() -> list:
    """Operand pairs of digit patterns at the engine's bounds."""
    from ark_blst_tpu_torch.ops import lazy13 as LZ

    F = LZ.F_BOUND
    alt = [F if k % 2 else -F for k in range(30)]
    edge = [int(v) for v in LZ.int_to_digits((LZ.R13 >> 1) - 1)]
    return [
        ([F] * 30, [F] * 30), ([-F] * 30, [-F] * 30),  # all +4129, all -4129
        ([8191] * 30, [8191] * 30), (edge, edge),  # canonical maxima, the R13/2 edge
        (alt, [F] * 30), (alt, alt),
        ([0] * 29 + [F], [F] * 30), ([F] + [0] * 29, [F] + [0] * 29),
    ]


def phase_k1(torch, dev, sass: dict) -> dict:
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.ops import mont_mul as MM

    n, F = 1 << LOG_N, LZ.F_BOUND
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randint(-F, F + 1, (30, n), generator=g, device=dev, dtype=torch.int32)
    b = torch.randint(-F, F + 1, (30, n), generator=g, device=dev, dtype=torch.int32)

    def col(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    cases = extreme_cases()
    for i, (x, y) in enumerate(cases):
        a[:, i], b[:, i] = col(x), col(y)
    got = MM.mont_mul(a, b)
    want = MM.mont_mul_plain(a, b)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and torch.equal(got, want), "K1 differs from its plain version")
    ms = cuda_ms(torch, lambda: MM.mont_mul(a, b), 10)
    plain_ms = cuda_ms(torch, lambda: MM.mont_mul_plain(a, b), 2)
    bms, by = bound_ms(n * 3 * 30 * 4, n * MONT_MUL_OPS)
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    # the pairing's own launches: one Fp product (or a few concatenated) per
    # batch element, N = PAIRING_N
    ap, bp = a[:, :PAIRING_N].contiguous(), b[:, :PAIRING_N].contiguous()
    errp = _held(torch, "K1", MM.mont_mul(ap, bp), MM.mont_mul_plain(ap, bp))
    bmsp, byp = bound_ms(PAIRING_N * 3 * 30 * 4, PAIRING_N * MONT_MUL_OPS)
    res["at_pairing_batch"] = {
        "n": PAIRING_N, "max_abs_err": errp, "ms": cuda_ms(torch, lambda: MM.mont_mul(ap, bp), 10),
        "plain_ms": cuda_ms(torch, lambda: MM.mont_mul_plain(ap, bp), 10),
        "bound_ms": bmsp, "bound_by": byp}
    emit({"phase": "k1", "n": n, "extreme_cases": len(cases), "bit_equal": True, **res,
          "imad_floor_ms": imad_floor_ms(n * sass["imad"])})
    del a, b, got, want, ap, bp
    torch.cuda.empty_cache()
    return res


def _launch_shape(torch, kc, total_threads: int) -> dict:
    """A bucket kernel's block size and the blocks an SM holds (both from
    its C entry `<symbol>_shape`, the occupancy API at the compiled
    registers and stack), and the waves its grid makes on the card's SMs."""
    fn = getattr(ctypes.CDLL(str(kc.kernel.lib_path)), kc.kernel.symbol + "_shape")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(ctypes.byref(threads), ctypes.byref(per_sm))
    check(err == 0, f"{kc.kernel.symbol}_shape: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-total_threads // threads.value)
    return {"threads": threads.value, "blocks": blocks, "blocks_per_sm": per_sm.value,
            "sms": sms, "waves": blocks / (sms * per_sm.value)}


def phase_k2(torch, phase: str, kc, c: int, pts, digs, imad: int, ptxas: dict) -> tuple:
    """K2 (G1) or K2-G2 at the curve's main-path inputs: its point
    conversion (`point_words`) against the plain version bit for bit
    (canonical words are unique), its bucket kernel (32-bit Montgomery
    words) against the plain version (radix-13 digits) by canonical value,
    bucket for bucket; then each timed alone and the wrapper with both.
    Returns the two kernels' results."""
    from ark_blst_tpu_torch.curves import msm_bucket as MB

    words = MB.point_words(kc, pts)
    words_plain = MB.point_words_plain(kc, pts)
    torch.cuda.synchronize()
    werr = int((words.long() - words_plain.long()).abs().max())
    check(werr == 0 and torch.equal(words, words_plain),
          f"{kc.name}_point_words differs from its plain version")
    del words_plain
    got = MB.accumulate(kc, pts, digs, c)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = MB.accumulate_plain(kc, pts, digs, c)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    max_digit = MB.max_dump_digit(got)
    got_v, want_v = MB.dump_values(kc, got), MB.dump_values(kc, want)
    err = int((got_v.long() - want_v.long()).abs().max())
    check(err == 0 and torch.equal(got_v, want_v), f"{phase} differs from its plain version")
    check(max_digit <= 4096, f"{phase} dump digit {max_digit} above 4096")
    del got, want, got_v, want_v
    torch.cuda.empty_cache()

    W, n = digs.shape
    B, S = MB._num_buckets(c), MB.STREAMS
    dump = torch.empty((W, B, kc.pt_rows, S), dtype=torch.int32, device=pts.device)
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(torch, lambda: kc.kernel.launch(
        words.data_ptr(), digs.data_ptr(), dump.data_ptr(), n, W, B, S, stream), 2)
    wrapper_ms = cuda_ms(torch, lambda: MB.accumulate(kc, pts, digs, c), 2)
    words_ms = cuda_ms(torch, lambda: MB.point_words(kc, pts), 10)
    words_plain_ms = cuda_ms(torch, lambda: MB.point_words_plain(kc, pts), 2)
    del dump, words
    adds = int(((digs & MB.MAG_MASK) != 0).sum())
    negs = int((((digs >> MB.SIGN_BIT) & 1) != 0).sum())
    buckets = W * B * S
    comps = kc.n_fp // 3  # Fp components of a coordinate
    # bytes: the words, the digits and the dump once; per add a bucket read
    # and write (36 words a component) and a point read (24 a component)
    bytes_once = (kc.word_rows * n + digs.numel() + buckets * kc.pt_rows) * 4
    scattered = adds * comps * (2 * 36 + 24) * 4
    bms, by = bound_ms(bytes_once + scattered, adds * BUCKET_ADD_OPS[kc.name]
                       + negs * comps * NEG32_OPS + buckets * kc.n_fp * DUMP_COMPONENT_OPS)
    # the same work on radix-13 digits, as the kernel it replaced bounded it
    r13_bytes = (pts.numel() + digs.numel() + buckets * kc.pt_rows) * 4 + adds * (
        2 * kc.pt_rows + kc.aff_rows) * 4
    bms_r13, by_r13 = bound_ms(r13_bytes, adds * R13_BUCKET_ADD_OPS[kc.name] + negs * comps * 30)
    shape = _launch_shape(torch, kc, W * S)
    res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "max_abs_err": err,
           "wrapper_ms": wrapper_ms, "bound_radix13_ms": bms_r13, "bound_radix13_by": by_r13}
    wbms, wby = bound_ms((kc.aff_rows + kc.word_rows) * n * 4,
                         2 * comps * n * POINT_COMPONENT_OPS)
    words_res = {"ms": words_ms, "plain_ms": words_plain_ms, "bound_ms": wbms, "bound_by": wby,
                 "max_abs_err": werr}
    emit({"phase": phase, "n": n, "c": c, "windows": W, "buckets": B, "adds": adds,
          "value_equal": True, "max_dump_digit": max_digit, **res,
          "ops_per_add": BUCKET_ADD_OPS[kc.name],
          "ops_per_add_radix13": R13_BUCKET_ADD_OPS[kc.name],
          "bytes_once": bytes_once, "bytes_scattered": scattered,
          "bytes_ms": 1e3 * (bytes_once + scattered) / HBM_BYTES_PER_S,
          "imad_per_add": imad, "imad_floor_ms": imad_floor_ms(adds * imad),
          "ptxas": ptxas, "launch": shape, "point_words": {"bit_equal": True, **words_res}})
    return res, words_res


def phase_msm(torch, dev, phase: str, kc, c: int, points, scalars, expected) -> dict:
    """The G1 or G2 MSM through its public entry (`msm_g1` / `msm_g2`),
    checked, with its launches, peak memory, points/s and the staged and
    profiled reruns."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.ops import mont_mul as MM

    entry = T.msm_g2 if kc.is_g2 else T.msm_g1
    names = ("mont_mul", kc.kernel.source[: -len(".cu")], kc.name + "_point_words")
    kernels = (MM.KERNEL, kc.kernel, kc.words_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = entry(points, scalars, device=dev, c=c)  # the main path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(zip(names, (k.launches for k in kernels)))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    leaves = kc.components(out)
    check(all(x.shape == (24, 1) and x.device == dev for x in leaves), "result shape")
    check(_affine(kc, out) == [expected], f"{phase} result differs from the expected point")
    check(all(x > 0 for x in launches.values()),
          f"a kernel of the path was not launched: {launches}")

    stages = {}
    for name, summary in run_stages(torch, kc, c, points, scalars, expected, profiled=False):
        stages[name + "_ms"] = summary["wall_ms"]
    profiled = dict(run_stages(torch, kc, c, points, scalars, expected, profiled=True))
    wall = sum(p["wall_ms"] for p in profiled.values())
    device = sum(p["device_ms"] for p in profiled.values())
    n = scalars.shape[1]
    emit({"phase": phase, "n": n, "c": c, "ok": True, "seconds": dt, "points_per_s": n / dt,
          "launches": launches, "stages": stages, "peak_mem_gib": peak_gib})
    emit({"phase": phase + "_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return launches


def _affine(curve, pt) -> list:
    """A projective point batch of a `KernelCurve2` or a `CurveOps` (both
    named "g1" or "g2") -> affine host tuples."""
    from ark_blst_tpu_torch.ops import convert as CV

    return CV.g2_from_dev(pt) if curve.name == "g2" else CV.g1_from_dev(pt)


def _launch_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def _stage(torch, fn, profiled: bool, need_device: bool = True, expect: tuple = ()):
    """Run fn() after a synchronize and up to the next one; returns (out,
    summary) with the host-clock time and the launches of each kernel of the
    port (the counters' increments) or, when profiled, the device time
    of its kernels, their number, the device busy share and the three
    kernels that took the most device time. The device events are summed
    from the profiler's raw event list: `key_averages()` builds a Python
    object per event and took ~0.75 ms per launch on the card's host (45 s
    for 60K launches), where a scan MSM launches hundreds of thousands."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if not profiled:
        before = _launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: n - before[k] for k, n in _launch_counts().items() if n != before[k]}
        return out, {"wall_ms": wall_ms, "launches": launches}
    # The profiler has returned no device event for a stage that is one long
    # kernel (K2-G2, 0.65-3.9 s, in some runs on the H100), or only the
    # events of the stage's short kernels: a stage whose events miss a
    # kernel named in `expect` is run under it once more, and then timed
    # between two CUDA events, which bound its device time from above; the
    # summary says which it is.
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        count, ns = Counter(), Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                count[e.name()] += 1
                ns[e.name()] += e.duration_ns()
        device_ms = sum(ns.values()) / 1e6
        seen = device_ms > 0 and all(any(e in name for name in ns) for e in expect)
        if seen or not need_device:
            break
    summary = {"profile_attempts": attempt, "device_ms_from": "profiler",
               "kernel_launches": sum(count.values()),
               "top": [{"kernel": name[:60], "count": count[name], "device_ms": t / 1e6}
                       for name, t in ns.most_common(5)]}
    if not seen and need_device:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        device_ms = start.elapsed_time(end)
        summary.update(device_ms_from="cuda_events", kernel_launches=None, top=[])
    check(device_ms > 0 or not need_device, "the stage ran nothing on the card")
    return out, {"wall_ms": wall_ms, "device_ms": device_ms,
                 "busy_share": device_ms / wall_ms, **summary}


def run_stages(torch, kc, c: int, points, scalars, expected, profiled: bool):
    """The MSM's four stages one by one, each ended by a synchronize; yields
    (stage, summary) as `_stage` gives it."""
    from ark_blst_tpu_torch.curves import msm_bucket as MB

    (pts, digs), summary = _stage(
        torch, lambda: MB._prepare_inputs(kc, points, scalars, c), profiled)
    yield "prepare", summary
    # the bucket kernel's own name, which the profiler has failed to report
    kernel_name = kc.kernel.source[: -len(".cu")] + "_kernel"
    dump, summary = _stage(torch, lambda: MB.accumulate(kc, pts, digs, c), profiled,
                           expect=(kernel_name,))
    yield "k2", summary
    ws, summary = _stage(torch, lambda: MB._reduce_dump(kc, dump), profiled)
    yield "reduce", summary
    out, summary = _stage(torch, lambda: MB._finish_host(kc, ws, c), profiled)
    yield "finish", summary
    check(_affine(kc, out) == [expected], "staged MSM result differs")


# --- the pairing's kernels and path -------------------------------------------

def _held(torch, name: str, got, want) -> int:
    """Hold a kernel's output against its plain version's, bit for bit."""
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(err == 0 and torch.equal(got, want), f"{name} differs from its plain version")
    return err


def _timed(torch, kernel_fn, plain_fn, n_bytes: int, ops: int, imads) -> dict:
    """Kernel and plain times at the same inputs, with the bound and the
    products' IMAD floor (None where not measured)."""
    bms, by = bound_ms(n_bytes, ops)
    return {"ms": cuda_ms(torch, kernel_fn, 3), "plain_ms": cuda_ms(torch, plain_fn, 1),
            "bound_ms": bms, "bound_by": by,
            "imad_floor_ms": None if imads is None else imad_floor_ms(imads)}


def digit_stacks(torch, dev, rows_list) -> list:
    """Random mul-ready (rows, 30, N) stacks, N = PAIRING_N, with the extreme
    patterns (one operand side each) in the first columns."""
    from ark_blst_tpu_torch.ops import lazy13 as LZ

    F = LZ.F_BOUND
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for j, rows in enumerate(rows_list):
        x = torch.randint(-F, F + 1, (rows, 30, PAIRING_N), generator=g, device=dev,
                          dtype=torch.int32)
        for i, case in enumerate(extreme_cases()):
            x[:, :, i] = torch.tensor(case[j % 2], dtype=torch.int32, device=dev)[None, :]
        out.append(x)
    return out


def _held_values(torch, name: str, got, want) -> int:
    """Hold a kernel on 32-bit words (K3-K6, K11, K12) against its plain
    version by value: the same field element in every Fp row (canonical
    digits), the kernel's digits within 4096. Returns the largest |digit|
    difference of the canonical digits (0)."""
    from ark_blst_tpu_torch.ops import lazy13 as LZ

    torch.cuda.synchronize()
    cg, cw = LZ.canonicalize_rows(got), LZ.canonicalize_rows(want)
    err = int((cg.long() - cw.long()).abs().max())
    check(err == 0 and torch.equal(cg, cw), f"{name} differs from its plain version by value")
    top = int(got.abs().max())
    check(top <= 4096, f"{name} output digit {top} above 4096")
    return err


def _tower32_shape(torch, kernel, n: int) -> dict:
    """The launch shape of K3-K6, K11 or K12 from its C entry
    `<symbol>_shape`: elements and threads a block, shared bytes a block,
    the blocks an SM holds (the occupancy API), and the grid's waves and
    warps an SM at n."""
    fn = getattr(ctypes.CDLL(str(kernel.lib_path)), kernel.symbol + "_shape")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(*(ctypes.byref(v) for v in vals))
    check(err == 0, f"{kernel.symbol}_shape: CUDA error {err}")
    elems, threads, smem, per_sm = (v.value for v in vals)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-n // elems)
    return {"elements_per_block": elems, "threads": threads, "smem_bytes": smem,
            "blocks": blocks, "blocks_per_sm": per_sm, "sms": sms,
            "waves": blocks / (sms * per_sm),
            "warps_per_sm": min(blocks / sms, per_sm) * -(-threads // 32)}


def _tower32_imad(sass: dict) -> float | None:
    """IMAD instructions of one CIOS product in a 32-bit tower library: its
    static IMAD count (moves left out) over the CIOS bodies it compiles
    (its wide multiply-adds over the 288 of one product); None where the
    SASS shows none."""
    bodies = sass["imad_wide"] / CIOS_WIDE_MULS
    return (sass["imad"] - sass["imad_mov"]) / bodies if bodies else None


def phase_k3(torch, dev, real, sass: dict, ptxas: dict) -> dict:
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import cyc_sqr as K3

    (x,) = digit_stacks(torch, dev, [12])
    n = x.shape[-1]
    imad = _tower32_imad(sass)
    runs = {}
    for nsq in (1, max(r for r, _ in PR._X_SEGMENTS)):
        err = max(_held_values(torch, "K3", K3.cyc_sqr(v, nsq), K3.cyc_sqr_plain(v, nsq))
                  for v in (x, real[2]))
        nbytes = n * 2 * 12 * ELEM_BYTES
        conv = 12 * (DIGITS_TO_WORDS_OPS + WORDS_TO_DIGITS_OPS)
        runs[nsq] = {"max_abs_err": err, **_timed(
            torch, lambda: K3.cyc_sqr(x, nsq), lambda: K3.cyc_sqr_plain(x, nsq),
            nbytes, n * (nsq * CYC_SQR32_OPS + conv),
            None if imad is None else n * (18 * nsq + 24) * imad)}
        runs[nsq]["bound_radix13_ms"], runs[nsq]["bound_radix13_by"] = bound_ms(
            nbytes, n * nsq * CYC_SQR_OPS)
    emit({"phase": "k3", "n": n, "value_equal": True, "real_inputs": True,
          "runs": {f"squarings_{k}": v for k, v in runs.items()},
          "ops_per_square": CYC_SQR32_OPS, "ops_per_square_radix13": CYC_SQR_OPS,
          "imad_per_product": imad, "ptxas": ptxas["cyc_sqr.cu"],
          "launch": _tower32_shape(torch, K3.KERNEL, n)})
    return runs[max(runs)]


def _below_8p(torch, dev, stacks, seed: int) -> None:
    """Redraw the top digit of each random stack in [-100, 100]: |value| <
    8p, where the plain versions of K4-K6, K11 and K12 are field operations
    (their folds truncate values near 2^390)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for x in stacks:
        x[:, 29, :] = torch.randint(-100, 101, (x.shape[0], x.shape[-1]), generator=g,
                                    device=dev, dtype=torch.int32)


def phase_k4(torch, dev, real, sass: dict, ptxas: dict) -> dict:
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import fp12_mul as K4

    a, b = digit_stacks(torch, dev, [12, 12])
    _below_8p(torch, dev, (a, b), SEED + 4)
    n = a.shape[-1]
    # real operands: f after three Miller events and after a fourth
    f_real = real[2]
    g_real = PS.miller_step(f_real, real[3], real[4], True)
    err = max(_held_values(torch, "K4", K4.fp12_mul(x, y), K4.fp12_mul_plain(x, y))
              for x, y in ((a, b), (f_real, g_real)))
    imad = _tower32_imad(sass)
    nbytes = n * 3 * 12 * ELEM_BYTES
    conv = 24 * DIGITS_TO_WORDS_OPS + 12 * WORDS_TO_DIGITS_OPS
    res = {"max_abs_err": err, **_timed(
        torch, lambda: K4.fp12_mul(a, b), lambda: K4.fp12_mul_plain(a, b),
        nbytes, n * (FP12_MUL32_OPS + conv), None if imad is None else n * (54 + 36) * imad)}
    res["bound_radix13_ms"], res["bound_radix13_by"] = bound_ms(nbytes, n * FP12_MUL_OPS)
    emit({"phase": "k4", "n": n, "value_equal": True, "real_inputs": True, **res,
          "ops_per_product": FP12_MUL32_OPS, "ops_per_product_radix13": FP12_MUL_OPS,
          "ops_conversions": conv, "imad_per_product": imad, "ptxas": ptxas["fp12_mul.cu"],
          "launch": _tower32_shape(torch, K4.KERNEL, n)})
    return res


def real_event_inputs(torch, p, q):
    """K5's, K6's, K11's and K12's operands as the pipeline gives them: R
    after three doubling events of `prepare_g2`, f after three Miller
    events, the fourth event's line and P, and that line scaled by P
    (`_ell_legs`, K12's rows) as the unfused Miller loop forms it."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    one, zero = PR._fp2_one_zero_like(qx)
    rs = torch.stack([qx[0], qx[1], qy[0], qy[1], one, zero])
    qs = torch.stack([qx[0], qx[1], qy[0], qy[1]])
    for _ in range(3):
        rs = PS.prepare_step(rs)[:6]
    coeffs = PR.prepare_g2(q, events=4)
    px, py = TL.fp_ingest(p[0]), TL.fp_ingest(p[1])
    pxy = torch.stack([px, py])
    fs = TL.stack12(PR._fp12_one_like(px))
    for i in range(3):
        fs = PS.miller_step(fs, coeffs[i], pxy, True)
    a0, a1, a4 = PS._ell_legs(TL, PR._line(coeffs[3]), px, py)
    legs = torch.stack([a0[0], a0[1], a1[0], a1[1], a4[0], a4[1]])
    return rs, qs, fs, coeffs[3], pxy, legs


def phase_k5(torch, dev, real, sass: dict, ptxas: dict) -> dict:
    from ark_blst_tpu_torch.curves import pairing_steps as PS

    r_rand, q_rand = digit_stacks(torch, dev, [6, 4])
    _below_8p(torch, dev, (r_rand, q_rand), SEED + 5)
    r_real, q_real = real[0], real[1]
    n = r_rand.shape[-1]
    imad = _tower32_imad(sass)
    forms, err = {}, 0
    for is_add in (False, True):
        for r, q in ((r_rand, q_rand), (r_real, q_real)):
            qq = q if is_add else None
            err = max(err, _held_values(torch, "K5", PS.prepare_step(r, qq),
                                        PS.prepare_step_plain(r, qq)))
        qq = q_rand if is_add else None
        nbytes = n * (PREPARE_INPUTS[is_add] + 12) * ELEM_BYTES
        conv = PREPARE_INPUTS[is_add] * DIGITS_TO_WORDS_OPS + 12 * WORDS_TO_DIGITS_OPS
        form = _timed(
            torch, lambda: PS.prepare_step(r_rand, qq), lambda: PS.prepare_step_plain(r_rand, qq),
            nbytes, n * (PREPARE32_OPS[is_add] + conv),
            None if imad is None
            else n * (PREPARE_PRODUCTS[is_add] + PREPARE_INPUTS[is_add] + 12) * imad)
        form["bound_radix13_ms"], form["bound_radix13_by"] = bound_ms(
            nbytes, n * PREPARE_OPS[is_add])
        form["ops_per_event"], form["ops_conversions"] = PREPARE32_OPS[is_add], conv
        forms["addition" if is_add else "doubling"] = form
    emit({"phase": "k5", "n": n, "value_equal": True, "real_inputs": True, "max_abs_err": err,
          **forms, "imad_per_product": imad, "ptxas": ptxas["prepare_step.cu"],
          "launch": _tower32_shape(torch, PS.PREPARE_KERNEL, n)})
    return {"max_abs_err": err, **forms["doubling"], "addition": forms["addition"]}


def phase_k6(torch, dev, real, sass: dict, ptxas: dict) -> dict:
    from ark_blst_tpu_torch.curves import pairing_steps as PS

    f_rand, c_rand, p_rand = digit_stacks(torch, dev, [12, 6, 2])
    n = f_rand.shape[-1]
    _below_8p(torch, dev, (f_rand, c_rand, p_rand), SEED + 6)
    imad = _tower32_imad(sass)
    forms, err = {}, 0
    for with_sqr in (True, False):
        for f, c, pxy in ((f_rand, c_rand, p_rand), real[2:5]):
            err = max(err, _held_values(torch, "K6", PS.miller_step(f, c, pxy, with_sqr),
                                        PS.miller_step_plain(f, c, pxy, with_sqr)))
        nbytes = n * (12 + 6 + 2 + 12) * ELEM_BYTES
        conv = 20 * DIGITS_TO_WORDS_OPS + 12 * WORDS_TO_DIGITS_OPS
        form = _timed(
            torch, lambda: PS.miller_step(f_rand, c_rand, p_rand, with_sqr),
            lambda: PS.miller_step_plain(f_rand, c_rand, p_rand, with_sqr),
            nbytes, n * (MILLER32_OPS[with_sqr] + conv),
            None if imad is None else n * (MILLER_PRODUCTS[with_sqr] + 32) * imad)
        form["bound_radix13_ms"], form["bound_radix13_by"] = bound_ms(
            nbytes, n * MILLER_OPS[with_sqr])
        forms["with_square" if with_sqr else "line_only"] = form
    emit({"phase": "k6", "n": n, "value_equal": True, "real_inputs": True, "max_abs_err": err,
          **forms, "ops_per_event": MILLER32_OPS[True],
          "ops_per_event_radix13": MILLER_OPS[True],
          "ops_conversions": 20 * DIGITS_TO_WORDS_OPS + 12 * WORDS_TO_DIGITS_OPS,
          "imad_per_product": imad, "ptxas": ptxas["miller_step.cu"],
          "launch": _tower32_shape(torch, PS.MILLER_KERNEL, n)})
    return {"max_abs_err": err, **forms["with_square"]}


def phase_k11_k12(torch, dev, real, sass: dict, ptxas: dict) -> tuple:
    """K11 (fp12 square) and K12 (sparse line product) against their plain
    versions at N = 8192, by value: random mul-ready digits with the
    extreme patterns and the top digit bounded (|value| < 8p), and real
    inputs (f after three Miller events, squared for K12 as at a doubling
    event, and the fourth event's scaled line)."""
    from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
    from ark_blst_tpu_torch.ops import fp12_sqr as K11

    f_rand, c_rand = digit_stacks(torch, dev, [12, 6])
    _below_8p(torch, dev, (f_rand, c_rand), SEED + 11)
    f_real, legs_real = real[2], real[5]
    n = f_rand.shape[-1]
    err11 = max(_held_values(torch, "K11", K11.fp12_sqr(f), K11.fp12_sqr_plain(f))
                for f in (f_rand, f_real))
    f_sq = K11.fp12_sqr(f_real)
    err12 = max(_held_values(torch, "K12", K12.fp12_mul_by_014(f, c),
                             K12.fp12_mul_by_014_plain(f, c))
                for f, c in ((f_rand, c_rand), (f_sq, legs_real)))
    out, line = {}, {}
    for name, kernel, err, kernel_fn, plain_fn, rows_in, ops, ops13, products in (
            ("fp12_sqr", K11.KERNEL, err11, lambda: K11.fp12_sqr(f_rand),
             lambda: K11.fp12_sqr_plain(f_rand), 12, FP12_SQR32_OPS, FP12_SQR_OPS, 36),
            ("fp12_mul_by_014", K12.KERNEL, err12, lambda: K12.fp12_mul_by_014(f_rand, c_rand),
             lambda: K12.fp12_mul_by_014_plain(f_rand, c_rand), 18, MUL_BY_014_32_OPS,
             MUL_BY_014_OPS, 45)):
        imad = _tower32_imad(sass[kernel.source])
        nbytes = n * (rows_in + 12) * ELEM_BYTES
        conv = rows_in * DIGITS_TO_WORDS_OPS + 12 * WORDS_TO_DIGITS_OPS
        res = {"max_abs_err": err, **_timed(
            torch, kernel_fn, plain_fn, nbytes, n * (ops + conv),
            None if imad is None else n * (products + rows_in + 12) * imad)}
        res["bound_radix13_ms"], res["bound_radix13_by"] = bound_ms(nbytes, n * ops13)
        out[name] = res
        line[name] = {**res, "ops_per_element": ops, "ops_per_element_radix13": ops13,
                      "ops_conversions": conv, "imad_per_product": imad,
                      "ptxas": ptxas[kernel.source],
                      "launch": _tower32_shape(torch, kernel, n)}
    emit({"phase": "k11_k12", "n": n, "value_equal": True, "real_inputs": True, **line})
    return out["fp12_sqr"], out["fp12_mul_by_014"]


def pairing_inputs():
    """8192 (P, Q) pairs of 8 distinct pairs, one identity P and one
    identity Q: (ps, qs, p8, q8)."""
    import random

    from ark_blst_tpu_torch.oracle import curve as OC
    from ark_blst_tpu_torch.oracle import field as OF

    rng = random.Random(SEED)
    k = PAIRING_DISTINCT
    p8 = [OC.scalar_mul(OF.G1_GEN, rng.randrange(1, OF.R)) for _ in range(k)]
    q8 = [OC.g2_mul(OF.G2_GEN, rng.randrange(1, OF.R)) for _ in range(k)]
    ps = [p8[i % k] for i in range(PAIRING_N)]
    qs = [q8[(3 * i + 1) % k] for i in range(PAIRING_N)]
    ps[IDENTITY_P_AT], qs[IDENTITY_Q_AT] = None, None
    return ps, qs, p8, q8


def pairing_instance():
    """The pairs of `pairing_inputs`; returns (ps, qs, expected) with the
    oracle's values."""
    from ark_blst_tpu_torch.oracle import field as OF
    from ark_blst_tpu_torch.oracle import pairing as OP

    ps, qs, p8, q8 = pairing_inputs()
    k = PAIRING_DISTINCT
    want = [OP.pairing(p8[a], q8[(3 * a + 1) % k]) for a in range(k)]
    expected = [OF.FP12_ONE if i in (IDENTITY_P_AT, IDENTITY_Q_AT) else want[i % k]
                for i in range(PAIRING_N)]
    return ps, qs, expected


def run_pairing_stages(torch, dev, ps, qs, expected, profiled: bool, fuse: bool = True,
                       engine: str = "lazy"):
    """The pairing's stages one by one: ingest (host codecs to strict limbs
    on the card), prepare_g2, miller_loop (with the identity mask),
    final_exp, egress (strict limbs back to host ints)."""
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV

    ((p, p_inf), (q, q_inf)), summary = _stage(
        torch, lambda: (B._g1_batch(ps, dev), B._g2_batch(qs, dev)), profiled, need_device=False)
    yield "ingest", summary
    coeffs, summary = _stage(torch, lambda: PR.prepare_g2(q, fuse, engine), profiled)
    yield "prepare_g2", summary
    f, summary = _stage(
        torch, lambda: PR._masked_miller(p, coeffs, p_inf, q_inf, fuse, engine), profiled)
    yield "miller_loop", summary
    f, summary = _stage(torch, lambda: PR.final_exp(f, fuse, engine), profiled)
    yield "final_exp", summary
    out, summary = _stage(torch, lambda: CV.fp12_from_dev(PR.egress(f, engine)), profiled,
                          need_device=engine == "lazy")
    yield "egress", summary
    check(out == expected, "staged pairing results differ from the oracle")


def _staged(torch, dev, ps, qs, expected, **pipeline) -> tuple:
    """One unprofiled staged run: ({stage_ms: host ms}, {stage: launches})."""
    summaries = dict(run_pairing_stages(torch, dev, ps, qs, expected, False, **pipeline))
    return ({name + "_ms": v["wall_ms"] for name, v in summaries.items()},
            {name: v["launches"] for name, v in summaries.items()})


def _profile_totals(profiled: dict) -> dict:
    wall = sum(v["wall_ms"] for v in profiled.values())
    device = sum(v["device_ms"] for v in profiled.values())
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "kernel_launches": sum(v["kernel_launches"] or 0 for v in profiled.values())}


def phase_pairing(torch, dev, ps, qs, expected) -> dict:
    from ark_blst_tpu_torch import bls12 as B

    names = ("mont_mul", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step")
    kernels = all_kernels()
    n = len(ps)
    B.pairing_batch(ps, qs, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    got = B.pairing_batch(ps, qs, device=dev)  # the main path
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    bad = sum(g != e for g, e in zip(got, expected))
    check(len(got) == n and bad == 0, f"{bad} of {n} pairings differ from the oracle")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")

    stages = {name + "_ms": summary["wall_ms"]
              for name, summary in run_pairing_stages(torch, dev, ps, qs, expected, False)}
    profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True))
    wall = sum(v["wall_ms"] for v in profiled.values())
    device = sum(v["device_ms"] for v in profiled.values())

    t0 = time.perf_counter()
    prep = B.prepare_g2_batch(qs, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    B.pairing_batch(ps, prep, device=dev)  # warm-up
    t0 = time.perf_counter()
    got_prep = B.pairing_batch(ps, prep, device=dev)
    dt_prep = time.perf_counter() - t0
    check(got_prep == got, "prepared pairings differ from the unprepared ones")
    # both entry points with their default device ("cuda", no index)
    got_default = B.pairing_batch(ps, B.prepare_g2_batch(qs))
    check(got_default == got, "default-device prepared pairings differ")

    emit({"phase": "pairing", "n": n, "distinct": PAIRING_DISTINCT, "ok": True,
          "identities_one": True, "seconds": dt, "pairings_per_s": n / dt,
          "launches": launches, "stages": stages, "peak_mem_gib": peak_gib,
          "prepared": {"ok": True, "prepare_s": prep_s, "seconds": dt_prep,
                       "pairings_per_s": n / dt_prep, "default_device_ok": True}})
    emit({"phase": "pairing_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return launches, got


def _reset_launches() -> dict:
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    return kernels


def phase_pairing_unfused(torch, dev, ps, qs, expected, fused) -> dict:
    """The phase-8 instance through `bls12.pairing_batch(..., fuse=False)`:
    the prepare on the tower (K1), each Miller event K11 + legs (K1) + K12,
    the exponent ladders one K3 square per bit; checked against the oracle
    and the fused results, with launches, pairings/s, stages, a profiled
    rerun, peak memory and the prepared path."""
    from ark_blst_tpu_torch import bls12 as B

    names = ("mont_mul", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step", "fp12_sqr",
             "fp12_mul_by_014")
    n = len(ps)
    B.pairing_batch(ps, qs, fuse=False, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = _reset_launches()
    t0 = time.perf_counter()
    got = B.pairing_batch(ps, qs, fuse=False, device=dev)  # the main path
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    bad = sum(g != e for g, e in zip(got, expected))
    check(len(got) == n and bad == 0, f"{bad} of {n} unfused pairings differ from the oracle")
    check(got == fused, "unfused pairings differ from the fused ones")
    check(launches["fp12_sqr"] == 63 and launches["fp12_mul_by_014"] == 68,
          f"K11/K12 launches per batch: {launches}")
    check(launches["prepare_step"] == 0 and launches["miller_step"] == 0,
          f"the unfused path launched K5/K6: {launches}")
    check(all(launches[k] > 0 for k in ("mont_mul", "cyc_sqr", "fp12_mul")),
          f"a kernel of the path was not launched: {launches}")

    stages, stage_launches = _staged(torch, dev, ps, qs, expected, fuse=False)
    profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True, fuse=False))

    t0 = time.perf_counter()
    prep = B.prepare_g2_batch(qs, fuse=False, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_prep = B.pairing_batch(ps, prep, fuse=False, device=dev)
    dt_prep = time.perf_counter() - t0
    check(got_prep == got, "unfused prepared pairings differ from the unprepared ones")

    emit({"phase": "pairing_unfused", "n": n, "ok": True, "equal_to_fused": True,
          "seconds": dt, "pairings_per_s": n / dt, "launches": launches, "stages": stages,
          "stage_launches": stage_launches, "peak_mem_gib": peak_gib,
          "prepared": {"ok": True, "prepare_s": prep_s, "seconds": dt_prep,
                       "pairings_per_s": n / dt_prep}})
    emit({"phase": "pairing_unfused_profile", **_profile_totals(profiled), "stages": profiled})
    return launches


def _fp12_product(values) -> tuple:
    from ark_blst_tpu_torch.oracle import field as OF

    acc = OF.FP12_ONE
    for v in values:
        acc = OF.fp12_mul(acc, v)
    return acc


def phase_pairing_strict(torch, dev, ps, qs, expected) -> dict:
    """The phase-8 instance through the tensor entry `pairing(...,
    engine="strict")` on K7-K10 alone, limb for limb against the lazy
    engine's output, with launches, stages and a profiled rerun; then
    `multi_pairing` and `multi_miller_loop_prepared` on both engines at
    STRICT_MULTI_N pairs."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import strict_field as SF
    from ark_blst_tpu_torch.ops import tower as TS

    (p, p_inf), (q, q_inf) = B._g1_batch(ps, dev), B._g2_batch(qs, dev)
    lazy = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = _reset_launches()
    t0 = time.perf_counter()
    out = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, engine="strict", device=dev)  # the path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    strict_names = {"strict_" + op for op in SF.KERNELS}
    check(all(launches[k] > 0 for k in strict_names), f"K7-K10 not all launched: {launches}")
    check(all(v == 0 for k, v in launches.items() if k not in strict_names),
          f"the strict pairing launched a lazy kernel: {launches}")
    leaves = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    check(all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(lazy))),
          "strict pairing limbs differ from the lazy engine's")
    check(CV.fp12_from_dev(out) == expected, "strict pairings differ from the oracle")

    stages, stage_launches = _staged(torch, dev, ps, qs, expected, engine="strict")
    profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True, engine="strict"))
    before = _launch_counts()
    TS.fp12_cyclotomic_sqr(out)
    per_cyc_sqr = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    per_event = {k: v / len(PR.MILLER_EVENTS) for k, v in stage_launches["miller_loop"].items()}

    m = STRICT_MULTI_N
    pm, qm = tuple(x[:, :m] for x in p), tuple(tuple(x[:, :m] for x in c) for c in q)
    pim, qim = p_inf[:m], q_inf[:m]
    want = _fp12_product(expected[:m])
    multi = {}
    for engine in ("lazy", "strict"):
        t0 = time.perf_counter()
        mp = PR.multi_pairing(pm, qm, pim, qim, engine=engine)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prep = PR.prepare_g2_device(qm, qim, engine=engine)
        mml = PR.multi_miller_loop_prepared(pm, prep, pim)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(CV.fp12_from_dev(mp) == [want], f"{engine} multi_pairing differs from the oracle")
        multi[engine] = {"multi_pairing_s": t1 - t0, "prepared_multi_miller_s": t2 - t1,
                         "values": (leaves(mp), leaves(mml))}
    for i, what in enumerate(("multi_pairing", "multi_miller_loop_prepared")):
        check(all(torch.equal(a, b) for a, b in
                  zip(multi["lazy"]["values"][i], multi["strict"]["values"][i])),
              f"{what}: the engines disagree")
    for v in multi.values():
        del v["values"]

    n = len(ps)
    emit({"phase": "pairing_strict", "n": n, "ok": True, "equal_to_lazy": True,
          "seconds": dt, "pairings_per_s": n / dt, "launches": launches,
          "strict_launches": sum(launches[k] for k in strict_names), "stages": stages,
          "stage_launches": stage_launches, "launches_per_miller_event": per_event,
          "launches_per_cyclotomic_sqr": per_cyc_sqr, "peak_mem_gib": peak_gib, "multi": {"n": m, "engines_agree": True, **multi}})
    emit({"phase": "pairing_strict_profile", **_profile_totals(profiled), "stages": profiled})
    return {op: launches["strict_" + op] for op in SF.KERNELS}


# --- the arkworks API surface on the card's MSM and pairing paths --------------

def _bulk_ints(torch, x) -> list:
    """(L, N) int32 16-bit limbs on any device -> N ints, through one byte
    buffer (the codecs' per-limb loop takes ~8 us a value)."""
    raw = x.cpu().numpy().astype("<u2").T.copy().tobytes()
    width = 2 * x.shape[0]
    return [int.from_bytes(raw[i:i + width], "little") for i in range(0, len(raw), width)]


def api_msm_instance(torch, dev, curve_name: str, log_n: int, seed: int):
    """`curves/instance.py`'s known-answer instance as the API's objects:
    the bases made affine on the card (`curves.group`'s batch inversion),
    brought to the host in bulk and wrapped as G1Affine/G2Affine (the
    identity at IDENTITY_AT included), the scalars as Scalar (the zero one
    included); returns (bases, scalars, expected affine tuple)."""
    from ark_blst_tpu_torch import G1Affine, G2Affine, Scalar
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops.limbs import FP
    from ark_blst_tpu_torch.oracle.field import P

    points, scalars, expected = distinct_bases(log_n, seed, dev, curve_name)
    g2 = curve_name == "g2"
    xa, ya, inf = (G2 if g2 else G1).to_affine(points)
    rinv = pow(FP.mont_r, -1, P)

    def fp(t):
        return [v * rinv % P for v in _bulk_ints(torch, t)]

    def dec(t):
        return list(zip(fp(t[0]), fp(t[1]))) if g2 else fp(t)

    aff = G2Affine if g2 else G1Affine
    bases = [aff(None) if i else aff((x, y)) for x, y, i in zip(dec(xa), dec(ya), inf.tolist())]
    return bases, [Scalar(v) for v in _bulk_ints(torch, scalars)], expected


class _CallClock:
    """While in use, times every call of the given module functions (label
    -> seconds summed over calls, each ended by a synchronize, so a call's
    device work is inside its time) and puts the functions back after. A
    call made inside a timed one counts toward the outer one only (the MSM's
    host finish calls the codecs too)."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.seconds = {label: 0.0 for _, _, label in targets}
        self.depth = 0

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in self.targets]
        for (mod, attr, fn), (_, _, label) in zip(self.saved, self.targets):
            setattr(mod, attr, self._timed(fn, label))
        return self.seconds

    def _timed(self, fn, label):
        def timed(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.depth += 1
            try:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.torch.cuda.synchronize()
                self.seconds[label] += time.perf_counter() - t0
            finally:
                self.depth -= 1
            return out
        return timed

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def _api_msm(torch, dev, curve_name: str) -> tuple:
    """`G*Projective.msm` with the default backend and device on the
    known-answer instance: checked, with the call's seconds split into host
    ingest, the device MSM and egress, its points/s and launches."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.ops import convert as CV

    log_n, seed = API_MSM[curve_name]
    g2 = curve_name == "g2"
    t0 = time.perf_counter()
    bases, scalars, expected = api_msm_instance(torch, dev, curve_name, log_n, seed)
    setup_s = time.perf_counter() - t0
    proj = T.G2Projective if g2 else T.G1Projective
    to_dev, entry, back = ("g2_to_dev", "msm_g2", "g2_from_dev") if g2 else (
        "g1_to_dev", "msm_g1", "g1_from_dev")
    names = ("mont_mul", "bucket_accumulate" + ("_g2" if g2 else ""), curve_name + "_point_words")
    kernels = _reset_launches()
    clock = _CallClock(torch, [(CV, to_dev, "ingest_points"), (CV, "fr_to_dev", "ingest_scalars"),
                               (T, entry, entry), (CV, back, "egress")])
    torch.cuda.synchronize()
    with clock as split:
        t0 = time.perf_counter()
        out = proj.msm(bases, scalars)  # the API's main path: default backend, device "cuda"
        dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    check(type(out) is proj and out.p == expected,
          f"api {curve_name} MSM differs from the expected point")
    check(all(v > 0 for v in launches.values()), f"a kernel of the API MSM was not launched: {launches}")
    res = {"n": len(bases), "c": (MB.KC2_G2 if g2 else MB.KC2_G1).c_default, "ok": True,
           "seconds": dt,
           "points_per_s": len(bases) / dt, **{k + "_s": v for k, v in split.items()},
           "unwrap_s": dt - sum(split.values()), "launches": launches,
           "instance_setup_s": setup_s}
    return res, bases, out


def phase_api(torch, dev, ps, qs, expected, fused) -> None:
    """The arkworks API's batch entries on the card: G1Projective.msm at
    2^20 and G2Projective.msm at 2^16 on the known-answer instances; the
    phase-8 instance through `Bls12.pairing_batch`, plain and prepared,
    equal to phase 8's checked results; `Bls12.multi_miller_loop` and
    `final_exponentiation` at 1024 pairs; the repo's vectors (the
    generator pairing, the msm_g1 vectors) byte for byte; and a compressed,
    validated serialization round trip of the MSM results and 64 bases of
    each curve."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV

    t_phase = time.perf_counter()
    msm = {}
    round_trip = []
    for curve_name in ("g1", "g2"):
        msm[curve_name], bases, out = _api_msm(torch, dev, curve_name)
        emit({"phase": "api_msm_" + curve_name, **msm[curve_name]})
        round_trip += [out] + bases[:API_ROUNDTRIP]
        del bases
        torch.cuda.empty_cache()

    # pairings: the tuple-level call, then the API's, plain and prepared
    gp = [T.G1Affine(p) for p in ps]
    gq = [T.G2Projective(q) for q in qs]
    t0 = time.perf_counter()
    B.pairing_batch(ps, qs, device=dev)
    tuple_s = time.perf_counter() - t0
    names = ("mont_mul", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step")
    kernels = _reset_launches()
    clock = _CallClock(torch, [(B, "_g1_batch", "ingest_g1"), (B, "_g2_batch", "ingest_g2"),
                               (PR, "pairing", "device"), (CV, "fp12_from_dev", "egress")])
    with clock as split:
        t0 = time.perf_counter()
        got = T.Bls12.pairing_batch(gp, gq)  # default device "cuda"
        dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    check(all(isinstance(g, T.Gt) for g in got) and [g.v for g in got] == fused,
          "api pairing_batch differs from phase 8's results")
    check(all(v > 0 for v in launches.values()), f"a kernel of the API pairing was not launched: {launches}")
    t0 = time.perf_counter()
    prep = T.Bls12.prepare_g2_batch(gq)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_prep = T.Bls12.pairing_batch(gp, prep)
    dt_prep = time.perf_counter() - t0
    check(got_prep == got, "api prepared pairings differ from the unprepared ones")
    n = len(ps)
    emit({"phase": "api_pairing", "n": n, "ok": True, "equal_to_phase_pairing": True,
          "seconds": dt, "pairings_per_s": n / dt, **{k + "_s": v for k, v in split.items()},
          "unwrap_s": dt - sum(split.values()), "launches": launches,
          "tuple_level_seconds": tuple_s, "tuple_level_pairings_per_s": n / tuple_s,
          "prepared": {"ok": True, "prepare_s": prep_s, "seconds": dt_prep,
                       "pairings_per_s": n / dt_prep}})

    # Miller loop on the card, final exponentiation on the host
    m = API_MULTI_N
    kernels = _reset_launches()
    t0 = time.perf_counter()
    mlo = T.Bls12.multi_miller_loop(gp[:m], gq[:m])  # backend None: the device route
    t1 = time.perf_counter()
    e = T.Bls12.final_exponentiation(mlo)
    t2 = time.perf_counter()
    launches = {k: kernels[k].launches for k in ("fp12_mul", "prepare_step", "miller_step")}
    check(isinstance(mlo, T.MillerLoopOutput) and e.v == _fp12_product(expected[:m]),
          "api multi_miller_loop + final_exponentiation differs from the oracle's product")
    check(all(v > 0 for v in launches.values()), f"a kernel of the API Miller loop was not launched: {launches}")
    emit({"phase": "api_miller", "n": m, "ok": True, "multi_miller_loop_s": t1 - t0,
          "final_exponentiation_host_s": t2 - t1, "launches": launches})
    del gp, gq, prep

    # the repo's vectors, through the device routes
    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "vectors",
                           "bls12_381.json")) as fh:
        vecs = json.load(fh)
    e = T.Bls12.pairing(T.G1Affine.generator(), T.G2Affine.generator())
    check(e.serialize().hex() == vecs["pairing"]["e_g1gen_g2gen"], "generator pairing bytes differ")
    for v in vecs["msm_g1"]:
        pts = [T.G1Affine.deserialize_compressed(bytes.fromhex(h)) for h in v["points_compressed"]]
        scs = [T.Scalar(int(s, 16)) for s in v["scalars"]]
        out = T.G1Projective.msm(pts, scs, backend="device")
        check(out.into_affine().serialize_compressed().hex() == v["result_compressed"],
              "an msm_g1 vector differs")
    vectors_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pt in round_trip:
        back = type(pt).deserialize_compressed(pt.serialize_compressed(), validate=True)
        check(back == pt, f"compressed round trip of a {type(pt).__name__} differs")
    emit({"phase": "api_vectors", "ok": True, "generator_pairing_bytes_equal": True,
          "msm_g1_vectors": len(vecs["msm_g1"]), "vectors_s": vectors_s,
          "round_trip_points": len(round_trip), "round_trip_s": time.perf_counter() - t0})
    emit({"phase": "api", "ok": True, "seconds": time.perf_counter() - t_phase})


def phase_fp_inv_batch(torch, dev) -> dict:
    """`tower_lazy.fp_inv_batch` (the log-depth tree) against `fp_inv` (the
    per-lane Fermat ladder) at the pairing's batch: both checked against the
    oracle's inverses and timed. A reading only: nothing calls it."""
    import random

    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import mont_mul as MM
    from ark_blst_tpu_torch.ops import tower_lazy as TL
    from ark_blst_tpu_torch.oracle import field as OF

    rng = random.Random(SEED)
    vals = [rng.randrange(1, OF.P) for _ in range(PAIRING_N)]
    a = TL.fp_ingest(CV.fp_to_dev(vals).to(dev))
    want = [pow(v, -1, OF.P) for v in vals]
    res = {}
    for name, fn in (("fp_inv_batch", TL.fp_inv_batch), ("fp_inv", TL.fp_inv)):
        fn(a)  # warm-up
        torch.cuda.synchronize()
        MM.KERNEL.launches = 0
        t0 = time.perf_counter()
        out = fn(a)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = MM.KERNEL.launches
        check(CV.fp_from_dev(TL.fp_egress(out)) == want, f"{name} differs from the oracle")
        res[name] = {"ms": ms, "k1_launches": launches}
    emit({"phase": "fp_inv_batch", "n": PAIRING_N, "ok": True, **res})
    return res


# --- the strict engine: K7-K10 and the scan MSM ---------------------------------

def strict_edge_values(p: int, limbs: int) -> list:
    """0, 1, p-1, p-2 and values with all-ones low limbs below p."""
    return [0, 1, p - 1, p - 2] + [((p >> 16 * k) - 1 << 16 * k) | ((1 << 16 * k) - 1)
                                   for k in (1, 4, limbs // 2)]


def strict_operands(torch, dev, spec, n: int):
    """Two (L, n) stacks of seeded random canonical limbs, every pair of
    extreme values in the first columns."""
    from ark_blst_tpu_torch.ops.limbs import ints_to_limbs

    L, p = spec.num_limbs, spec.modulus
    g = torch.Generator(device=dev).manual_seed(SEED)
    ops = [torch.randint(0, 1 << 16, (L, n), generator=g, device=dev, dtype=torch.int32)
           for _ in range(2)]
    top = p >> 16 * (L - 1)  # a top limb below p's keeps the value below p
    edge = strict_edge_values(p, L)
    pairs = ([x for x in edge for _ in edge], [y for _ in edge for y in edge])
    for x, vals in zip(ops, pairs):
        x[L - 1] = torch.randint(0, top, (n,), generator=g, device=dev, dtype=torch.int32)
        x[:, : len(vals)] = torch.from_numpy(ints_to_limbs(vals, L).T.copy()).to(dev)
    return ops


def _plain_chunked(torch, op: str, spec, args):
    from ark_blst_tpu_torch.ops import strict_field as SF

    n = args[0].shape[1]
    return torch.cat([SF.PLAIN[op](*(x[:, i : i + STRICT_PLAIN_CHUNK] for x in args), spec)
                      for i in range(0, n, STRICT_PLAIN_CHUNK)], dim=1)


def phase_k7_k10(torch, dev) -> dict:
    """K7-K10 against their plain versions: Fp at 2^22, Fr at 2^20, then the
    broadcast pair; returns per op its Fp numbers with the Fr and broadcast
    numbers nested."""
    from ark_blst_tpu_torch.ops import strict_field as SF
    from ark_blst_tpu_torch.ops.limbs import FP, FR

    res = {op: {} for op in SF.KERNELS}
    for spec in (FP, FR):
        n = 1 << STRICT_LOG_N[spec.name]
        a, b = strict_operands(torch, dev, spec, n)
        for op in SF.KERNELS:
            fn, args = getattr(SF, op), ((a,) if op == "neg" else (a, b))
            got = fn(*args, spec)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = _plain_chunked(torch, op, spec, args)
            end.record()
            end.synchronize()
            err = _held(torch, f"K7-K10 {op} over {spec.name}", got, want)
            del got, want
            bms, by = bound_ms(n * spec.num_limbs * 4 * (len(args) + 1),
                               n * strict_ops(op, spec.num_limbs))
            res[op][spec.name] = {"n": n, "max_abs_err": err,
                                  "ms": cuda_ms(torch, lambda: fn(*args, spec), 10),
                                  "plain_ms": start.elapsed_time(end),
                                  "bound_ms": bms, "bound_by": by}
        del a, b
        torch.cuda.empty_cache()
    a, b = strict_operands(torch, dev, FP, 1024 * 32)
    ab, bb = a.reshape(24, 1024, 32, 1), b[:, :1024].reshape(24, 1024, 1, 1)
    for op in SF.KERNELS:
        fn, args = getattr(SF, op), ((ab,) if op == "neg" else (ab, bb))
        got = fn(*args, FP)
        check(got.shape == (24, 1024, 32, 1), f"{op} broadcast shape {tuple(got.shape)}")
        res[op]["broadcast"] = {"max_abs_err": _held(torch, f"{op} broadcast", got,
                                                     SF.PLAIN[op](*args, FP)),
                                "ms": cuda_ms(torch, lambda: fn(*args, FP), 10)}
    for op, r in res.items():
        emit({"phase": "k7_k10", "op": op, "bit_equal": True, **r})
    return {op: {**r["fp"], "fr": r["fr"], "broadcast": r["broadcast"]} for op, r in res.items()}


def phase_fpmul(torch, dev) -> dict:
    """bench.py's bench_fpmul on K7: 32 chained products over 2^20 Fp
    elements (1024 random values tiled, against themselves rolled by 7)."""
    import random

    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import strict_field as SF
    from ark_blst_tpu_torch.ops.limbs import FP

    rng = random.Random(0)
    vals = [rng.randrange(FP.modulus) for _ in range(1 << 10)]
    a = CV.fp_to_dev(vals).to(dev).repeat(1, FPMUL_N >> 10)
    b = torch.roll(a, 7, dims=1)

    def chain():
        x = a
        for _ in range(FPMUL_ITERS):
            x = SF.mont_mul(x, b, FP)
        return x

    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = [vals[i] * pow(vals[(i - 7) % len(vals)], FPMUL_ITERS, FP.modulus) % FP.modulus
            for i in range(64)]
    check(CV.fp_from_dev(out[:, :64]) == want, "fpmul chain differs from the oracle")
    ms = cuda_ms(torch, chain, 3)
    res = {"phase": "fpmul", "n": FPMUL_N, "iters": FPMUL_ITERS, "ok": True, "seconds": dt,
           "products_per_s": FPMUL_N * FPMUL_ITERS / dt, "device_ms": ms,
           "device_products_per_s": FPMUL_N * FPMUL_ITERS / (ms / 1e3)}
    emit(res)
    return res


def _strict_launches() -> dict:
    from ark_blst_tpu_torch.ops import strict_field as SF

    return {op: k.launches for op, k in SF.KERNELS.items()}


def _reset_strict_launches() -> None:
    from ark_blst_tpu_torch.ops import strict_field as SF

    for k in SF.KERNELS.values():
        k.launches = 0


def _affine_of(curve, xa, ya, inf) -> list:
    """Device affine coordinates -> host affine tuples (None = identity)."""
    from ark_blst_tpu_torch.ops import convert as CV

    dec = CV.fp2_from_dev if curve.name == "g2" else CV.fp_from_dev
    return [None if i else (x, y) for x, y, i in zip(dec(xa), dec(ya), inf.tolist())]


def run_scan_stages(torch, curve, lanes: int, points, scalars, expected, profiled: bool):
    """The scan MSM's stages one by one (no padding: n is a multiple of
    lanes), each ended by a synchronize; yields (stage, summary)."""
    from ark_blst_tpu_torch.curves import msm as M

    digs, summary = _stage(torch, lambda: M.window_digits(scalars, SCAN_C), profiled)
    yield "digits", summary
    bk, summary = _stage(
        torch, lambda: M._bucket_accumulate(curve, points, digs, lanes, SCAN_C), profiled)
    yield "accumulate", summary
    bk, summary = _stage(torch, lambda: M._fold_axis(curve, bk, lanes), profiled)
    yield "fold", summary
    ws, summary = _stage(torch, lambda: M._bucket_reduce(curve, bk), profiled)
    yield "reduce", summary
    out, summary = _stage(torch, lambda: M._horner(curve, ws, SCAN_C), profiled)
    yield "horner", summary
    check(_affine(curve, out) == [expected], "staged scan MSM result differs")


def phase_msm_scan(torch, dev, phase: str, curve_name: str) -> dict:
    """The scan MSM at full width through `curves/msm.py:msm`, then
    `to_affine` on the card: the slice's main path."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    curve = G2 if curve_name == "g2" else G1
    log_n, lanes, seed = SCAN[curve_name]
    t0 = time.perf_counter()
    points, scalars, expected = distinct_bases(log_n, seed, dev, curve_name)
    torch.cuda.synchronize()
    emit({"phase": "instance", "curve": curve_name, "n": scalars.shape[1],
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_strict_launches()
    t0 = time.perf_counter()
    out = M.msm(points, scalars, curve, c=SCAN_C, lanes=lanes, device=dev)  # the main path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    affine = curve.to_affine(out)
    torch.cuda.synchronize()
    dt_affine = time.perf_counter() - t0 - dt
    launches = _strict_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(x.shape == (24, 1) and x.device == dev
              for x in (out if curve_name == "g1" else sum(out, ()))), "result shape")
    check(_affine(curve, out) == [expected], f"{phase} result differs from the expected point")
    check(_affine_of(curve, *affine) == [expected], f"{phase}: to_affine differs")
    needed = ("mont_mul", "add", "sub") + (("neg",) if curve_name == "g2" else ())
    check(all(launches[k] > 0 for k in needed), f"a kernel of the path was not launched: {launches}")

    stages = {name + "_ms": summary["wall_ms"] for name, summary in
              run_scan_stages(torch, curve, lanes, points, scalars, expected, False)}
    profiled = dict(run_scan_stages(torch, curve, lanes, points, scalars, expected, True))
    wall = sum(v["wall_ms"] for v in profiled.values())
    device = sum(v["device_ms"] for v in profiled.values())
    n = scalars.shape[1]
    emit({"phase": phase, "n": n, "c": SCAN_C, "lanes": lanes, "ok": True, "seconds": dt,
          "points_per_s": n / dt, "to_affine_s": dt_affine, "launches": launches,
          "stages": stages, "peak_mem_gib": peak_gib})
    emit({"phase": phase + "_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return launches


def phase_msm_naive(torch, dev) -> dict:
    """msm_naive and msm on a 2^12 G1 instance, then to_affine of its bases."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    points, scalars, expected = distinct_bases(NAIVE_LOG_N, NAIVE_SEED, dev, "g1")
    torch.cuda.synchronize()
    _reset_strict_launches()
    t0 = time.perf_counter()
    naive = M.msm_naive(points, scalars, G1, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scan = M.msm(points, scalars, G1, c=SCAN_C, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    affine = G1.to_affine(points)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _strict_launches()
    check(_affine(G1, naive) == [expected], "msm_naive differs from the expected point")
    check(_affine(G1, scan) == [expected], "msm at 2^12 differs from the expected point")
    got = _affine_of(G1, *affine)
    want = _affine(G1, points)  # the host's division of the same points
    bad = sum(g != w for g, w in zip(got, want))
    check(len(got) == len(want) and bad == 0, f"to_affine: {bad} of {len(want)} points differ")
    res = {"phase": "msm_naive", "n": scalars.shape[1], "ok": True, "naive_s": t1 - t0,
           "msm_s": t2 - t1, "to_affine_s": t3 - t2, "to_affine_points": len(got),
           "launches": launches}
    emit(res)
    return launches


# --- phase distributed: the sharded entries on torch.distributed --------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gather_ms(torch, mesh, like) -> float:
    """Mean milliseconds of one `mesh.all_gather` of a tensor like the
    partials a call gathers (a collective: every rank runs it)."""
    mesh.all_gather(like)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GATHER_REPS):
        mesh.all_gather(like)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / GATHER_REPS


def distributed_init(torch):
    """Phase distributed, first part: a world of one over NCCL in this
    process, on the card every other phase uses."""
    from ark_blst_tpu_torch import distributed as D

    t0 = time.perf_counter()
    D.initialize(f"localhost:{_free_port()}", 1, 0, device="cuda")
    mesh = D.global_mesh()
    torch.cuda.synchronize()
    check(mesh.backend == "nccl" and mesh.shape == {"data": 1} and mesh.device.type == "cuda",
          f"world of one: {mesh}")
    dt = time.perf_counter() - t0
    emit({"phase": "distributed_init", "collective": str(mesh.backend), "world": mesh.size,
          "device": str(mesh.device), "seconds": dt})
    return mesh, dt


def _in_turns(torch, sharded, single, first_s: float) -> dict:
    """After a first timed call of `sharded` (`first_s`), time `single`,
    `single`, `sharded` (the order sharded, single, single, sharded, so a
    drift of the host's speed falls on both): each call's seconds and the
    means."""
    times = {"sharded": [first_s], "single": []}
    for name, fn in (("single", single), ("single", single), ("sharded", sharded)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    return {"seconds": mean["sharded"], "single_device_seconds": mean["single"],
            "over_single_s": mean["sharded"] - mean["single"], "in_turns_s": times}


def distributed_msm(torch, dev, mesh, kc, c: int, points, scalars, expected) -> tuple:
    """`msm_distributed` in the world of one (backend "pallas": K2 or K2-G2
    on the rank) on the instance of phase msm / msm_g2, checked against its
    expected point, with its launches, its warm seconds in turns with the
    single-device entry's (`msm_g1` / `msm_g2`), the gather's bytes and
    time, and a profiled rerun."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch import distributed as D
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.group import G1, G2

    names = ("mont_mul", kc.kernel.source[: -len(".cu")], kc.name + "_point_words")
    run = lambda: D.msm_distributed(points, scalars, curve=G2 if kc.is_g2 else G1,  # noqa: E731
                                    c=c, mesh=mesh)
    entry = T.msm_g2 if kc.is_g2 else T.msm_g1
    kernels = _reset_launches()
    gathers, nbytes = mesh.gathers, mesh.gather_bytes
    t0 = time.perf_counter()
    out = run()  # the sharded path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    check(_affine(kc, out) == [expected],
          f"distributed {kc.name} MSM differs from the expected point")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(mesh.gathers == gathers + 1, "the world of one did not gather")
    res = {"backend": "pallas", "collective": str(mesh.backend), "world": mesh.size,
           "n": scalars.shape[1], "c": c, "ok": True, "launches": launches,
           "gather_bytes": mesh.gather_bytes - nbytes,
           **_in_turns(torch, run, lambda: entry(points, scalars, device=dev, c=c), dt)}
    res["points_per_s"] = scalars.shape[1] / res["seconds"]
    like = torch.zeros((kc.n_fp * 30, MB._num_windows(c)), dtype=torch.int32, device=dev)
    res["gather_ms"] = _gather_ms(torch, mesh, like)
    kernel_name = kc.kernel.source[: -len(".cu")] + "_kernel"
    _, prof = _stage(torch, run, profiled=True, expect=(kernel_name,))
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share", "device_ms_from")}
    return res, launches


def distributed_pairing(torch, dev, mesh, ps, qs, expected) -> tuple:
    """`multi_pairing_sharded` in the world of one over the phase-8 instance,
    fused, all 68 events and the final exponentiation: equal to the
    oracle's product of the checked pairings and, limb for limb, to the
    unsharded `multi_pairing`."""
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV

    (p, p_inf), (q, q_inf) = B._g1_batch(ps, dev), B._g2_batch(qs, dev)
    want = _fp12_product(expected)
    names = ("mont_mul", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step")
    run = lambda: PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf)  # noqa: E731
    kernels = _reset_launches()
    gathers, nbytes = mesh.gathers, mesh.gather_bytes
    t0 = time.perf_counter()
    got = run()  # the sharded path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(CV.fp12_from_dev(got) == [want],
          "sharded multi-pairing differs from the oracle's product")
    check(mesh.gathers == gathers + 1, "the world of one did not gather")
    single = PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf)
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(single))),
          "sharded multi-pairing differs from multi_pairing")
    like = torch.zeros((12, 30, 1), dtype=torch.int32, device=dev)
    res = {"engine": "lazy", "fuse": True, "events": 68, "final": True,
           "collective": str(mesh.backend), "world": mesh.size, "n": len(ps), "ok": True,
           "equal_to_oracle_product": True, "equal_to_multi_pairing": True,
           "launches": launches, "gather_bytes": mesh.gather_bytes - nbytes,
           **_in_turns(torch, run, lambda: PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf), dt),
           "gather_ms": _gather_ms(torch, mesh, like)}
    _, prof = _stage(torch, run, profiled=True)
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share", "device_ms_from")}
    return res, launches


def distributed_scan_and_auto(torch, dev, mesh) -> tuple:
    """`msm_sharded` (the scan MSM, K7-K10) in the world of one at 2^16 with
    the host finish, and `msm_auto` on the card at 2^20, which must take the
    bucket route (one K2 launch, no strict kernel); both against their
    instances' expected points."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    points, scalars, expected = distinct_bases(DIST_SCAN_LOG_N, DIST_SCAN_SEED, dev, "g1")
    _reset_launches()
    t0 = time.perf_counter()
    out = M.msm_sharded(points, scalars, mesh, G1, c=SCAN_C, lanes=SCAN["g1"][1],
                        finish="host")  # the sharded scan path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scan_launches = _strict_launches()
    check(_affine(G1, out) == [expected], "sharded scan MSM differs from the expected point")
    check(all(scan_launches[k] > 0 for k in ("mont_mul", "add", "sub")),
          f"a kernel of the path was not launched: {scan_launches}")
    scan = {"backend": "scan", "collective": str(mesh.backend), "world": mesh.size,
            "n": scalars.shape[1], "c": SCAN_C, "lanes": SCAN["g1"][1], "finish": "host",
            "ok": True, "seconds": dt, "launches": scan_launches}
    del points, scalars

    points, scalars, expected = distinct_bases(DIST_AUTO_LOG_N, DIST_AUTO_SEED, dev, "g1")
    kernels = _reset_launches()
    t0 = time.perf_counter()
    out = M.msm_auto(points, scalars, G1, device=dev)  # the card's route of msm_auto
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    auto_launches = {name: kernels[name].launches
                     for name in ("mont_mul", "bucket_accumulate", "g1_point_words")}
    check(_affine(G1, out) == [expected], "msm_auto differs from the expected point")
    check(auto_launches["bucket_accumulate"] == 1 and not any(_strict_launches().values()),
          f"msm_auto did not take the bucket route: {auto_launches}")
    auto = {"route": "bucket", "n": scalars.shape[1], "ok": True, "seconds": dt,
            "launches": auto_launches}
    return scan, auto, scan_launches, auto_launches


def distributed_two_ranks(torch, pair_want) -> dict:
    """Two ranks over gloo on the one card: this script twice more, with
    `--rank`, each on cuda:0 running the kernels on its shard (the G1 MSM
    at 2^20, c = 7, chunk 2^19; the sharded pairing over the first 1024
    pairs of the phase-8 instance with the final exponentiation). Both
    ranks' results must be equal and right; a rank that fails or passes its
    timeout fails the phase, and every child is killed."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_world")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the rendezvous is on localhost
    port = _free_port()
    procs, logs, outs = [], [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            outs.append(os.path.join(out_dir, f"rank{rank}.json"))
            if os.path.exists(outs[-1]):
                os.remove(outs[-1])
            logs.append(open(os.path.join(out_dir, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world", "2",
                 "--port", str(port), "--out", outs[-1]],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > TWO_RANK_TIMEOUT:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for rank, log in enumerate(logs):
            log.seek(0)
            text = log.read()
            log.close()
            if procs[rank].returncode != 0:
                print(f"--- rank {rank} (exit {procs[rank].returncode}) ---\n{text[-6000:]}",
                      file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          f"a rank failed or passed its {TWO_RANK_TIMEOUT} s timeout: "
          f"{[p.returncode for p in procs]}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    msm_points = [r["msm"].pop("point") for r in ranks]
    expected = ranks[0]["msm"].pop("expected")
    ranks[1]["msm"].pop("expected")
    check(msm_points[0] == msm_points[1] == [expected], "the ranks' MSMs differ or are wrong")
    fp12 = [_as_tuples(r["pairing"].pop("fp12")) for r in ranks]
    check(fp12[0] == fp12[1] == (pair_want,), "the ranks' multi-pairings differ or are wrong")
    return {"world": 2, "collective": "gloo", "device": "cuda:0", "ok": True,
            "equal_across_ranks": True, "wall_s": wall, "ranks": ranks}


def _as_tuples(x):
    return tuple(_as_tuples(v) for v in x) if isinstance(x, list) else x


def rank_main(argv) -> int:
    """One rank of phase distributed's two-rank world (`--rank R --world W
    --port P --out FILE`): joins the gloo group on cuda:0, runs the sharded
    G1 MSM and the sharded pairing on its shard, writes its results."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch import distributed as D
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import convert as CV

    t_start = time.perf_counter()
    D.initialize(f"localhost:{a.port}", a.world, a.rank, device="cuda:0", backend="gloo")
    mesh = D.global_mesh()
    dev = mesh.device
    init_s = time.perf_counter() - t_start

    kc = MB.KC2_G1
    points, scalars, expected = distinct_bases(TWO_RANK_LOG_N, TWO_RANK_SEED, dev, "g1")
    kernels = _reset_launches()
    nbytes = mesh.gather_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = MB.msm_sharded2(points, scalars, mesh, kc, c=C, chunk=TWO_RANK_CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    msm = {"n": scalars.shape[1], "c": C, "chunk": TWO_RANK_CHUNK, "seconds": dt,
           "launches": {name: kernels[name].launches
                        for name in ("mont_mul", "bucket_accumulate", "g1_point_words")},
           "gather_bytes": mesh.gather_bytes - nbytes,
           "gather_ms": _gather_ms(torch, mesh, torch.zeros(
               (kc.n_fp * 30, MB._num_windows(C)), dtype=torch.int32, device=dev)),
           "point": _affine(kc, out), "expected": expected}
    check(all(v > 0 for v in msm["launches"].values()), f"rank {a.rank}: {msm['launches']}")
    del points, scalars
    torch.cuda.empty_cache()

    ps, qs, _, _ = pairing_inputs()
    (p, p_inf) = B._g1_batch(ps[:TWO_RANK_PAIRS], dev)
    (q, q_inf) = B._g2_batch(qs[:TWO_RANK_PAIRS], dev)
    kernels = _reset_launches()
    nbytes = mesh.gather_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pairing = {"n": TWO_RANK_PAIRS, "seconds": dt,
               "launches": {name: kernels[name].launches for name in
                            ("mont_mul", "cyc_sqr", "fp12_mul", "prepare_step", "miller_step")},
               "gather_bytes": mesh.gather_bytes - nbytes,
               "gather_ms": _gather_ms(torch, mesh,
                                       torch.zeros((12, 30, 1), dtype=torch.int32, device=dev)),
               "fp12": CV.fp12_from_dev(got)}
    check(all(v > 0 for v in pairing["launches"].values()), f"rank {a.rank}: {pairing['launches']}")
    with open(a.out, "w") as f:
        json.dump({"rank": a.rank, "collective": str(mesh.backend), "device": str(dev),
                   "sharing": mesh.sharing, "init_s": init_s, "msm": msm, "pairing": pairing,
                   "seconds": time.perf_counter() - t_start}, f)
    torch.distributed.destroy_process_group()
    return 0


def _kernel_line(name, source, replaces, launches, res, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": "ark_blst_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None, **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sass, ptxas = phase_env(torch)
    k1 = phase_k1(torch, dev, sass["mont_mul.cu"])

    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.instance import distinct_bases

    mesh, init_s = distributed_init(torch)  # phase distributed, on the instances below
    dist_s, dist_launches = {"init": init_s}, {}
    k2s, msm_launches = {}, {}
    # IMADs per bucket add: each kernel inlines its whole addition (the
    # static count also holds the products of its two conversions)
    for kc, log_n, c, seed, k2_phase, msm_phase in (
            (MB.KC2_G1, LOG_N, C, SEED, "k2", "msm"),
            (MB.KC2_G2, G2_LOG_N, G2_C, G2_SEED, "k2_g2", "msm_g2")):
        t0 = time.perf_counter()
        points, scalars, expected = distinct_bases(log_n, seed, dev, kc.name)
        torch.cuda.synchronize()
        emit({"phase": "instance", "curve": kc.name, "n": scalars.shape[1],
              "seconds": time.perf_counter() - t0})
        pts, digs = MB._prepare_inputs(kc, points, scalars, c)
        source = kc.kernel.source
        k2s[kc.name], k2s[kc.name + "_words"] = phase_k2(
            torch, k2_phase, kc, c, pts, digs, sass[source]["imad"], ptxas[source])
        del pts, digs
        torch.cuda.empty_cache()
        msm_launches[kc.name] = phase_msm(torch, dev, msm_phase, kc, c, points, scalars, expected)
        t0 = time.perf_counter()
        res, dist_launches[kc.name] = distributed_msm(torch, dev, mesh, kc, c, points, scalars,
                                                      expected)
        emit({"phase": "distributed_" + msm_phase, **res})
        dist_s[msm_phase] = time.perf_counter() - t0
        del points, scalars
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ps, qs, pairs_expected = pairing_instance()
    emit({"phase": "pairing_instance", "n": len(ps), "seconds": time.perf_counter() - t0})
    (p, _), (q, _) = B._g1_batch(ps, dev), B._g2_batch(qs, dev)
    real = real_event_inputs(torch, p, q)
    k3 = phase_k3(torch, dev, real, sass["cyc_sqr.cu"], ptxas)
    k4 = phase_k4(torch, dev, real, sass["fp12_mul.cu"], ptxas)
    k5 = phase_k5(torch, dev, real, sass["prepare_step.cu"], ptxas)
    k6 = phase_k6(torch, dev, real, sass["miller_step.cu"], ptxas)
    k11, k12 = phase_k11_k12(torch, dev, real, sass, ptxas)
    del real
    torch.cuda.empty_cache()
    launches, fused = phase_pairing(torch, dev, ps, qs, pairs_expected)
    unfused = phase_pairing_unfused(torch, dev, ps, qs, pairs_expected, fused)
    torch.cuda.empty_cache()
    strict_pairing = phase_pairing_strict(torch, dev, ps, qs, pairs_expected)
    torch.cuda.empty_cache()
    phase_api(torch, dev, ps, qs, pairs_expected, fused)
    t0 = time.perf_counter()
    res, dist_launches["pairing"] = distributed_pairing(torch, dev, mesh, ps, qs, pairs_expected)
    emit({"phase": "distributed_pairing", **res})
    two_rank_want = _fp12_product(pairs_expected[:TWO_RANK_PAIRS])
    del ps, qs, pairs_expected, fused
    torch.cuda.empty_cache()
    scan, auto, dist_launches["scan"], dist_launches["auto"] = distributed_scan_and_auto(
        torch, dev, mesh)
    emit({"phase": "distributed_msm_scan", **scan})
    emit({"phase": "distributed_msm_auto", **auto})
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    dist_s["pairing_scan_auto"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit({"phase": "distributed_two_ranks", **distributed_two_ranks(torch, two_rank_want)})
    dist_s["two_ranks"] = time.perf_counter() - t0
    emit({"phase": "distributed", "ok": True, "seconds": sum(dist_s.values()), "parts_s": dist_s})
    phase_fp_inv_batch(torch, dev)

    k7_k10 = phase_k7_k10(torch, dev)
    torch.cuda.empty_cache()
    phase_fpmul(torch, dev)
    scan = {}
    for name, phase in (("g1", "msm_scan"), ("g2", "msm_scan_g2")):
        scan[name] = phase_msm_scan(torch, dev, phase, name)
        torch.cuda.empty_cache()
    naive = phase_msm_naive(torch, dev)
    bodies = {"mont_mul": "_mul_body :39", "add": "_add_body :43", "sub": "_sub_body :48",
              "neg": "_neg_body :56"}
    strict_lines = [
        _kernel_line("strict_" + op, "strict_field.cu",
                     f"ark_blst_tpu/ops/pallas_field.py:66 ({bodies[op]})",
                     scan["g1"][op] + scan["g2"][op], k7_k10[op],
                     launches_msm_scan=scan["g1"][op], launches_msm_scan_g2=scan["g2"][op],
                     launches_msm_naive=naive[op],
                     launches_distributed={"msm_scan": dist_launches["scan"][op]},
                     launches_pairing_strict=strict_pairing[op], fr=k7_k10[op]["fr"],
                     broadcast=k7_k10[op]["broadcast"])
        for op in bodies]

    emit({"kernels": [
        _kernel_line("mont_mul", "mont_mul.cu", "ark_blst_tpu/ops/pallas_lazy.py:41",
                     msm_launches["g1"]["mont_mul"], k1,
                     launches_msm_g2=msm_launches["g2"]["mont_mul"],
                     launches_pairing=launches["mont_mul"],
                     launches_pairing_unfused=unfused["mont_mul"],
                     launches_distributed={"msm_g1": dist_launches["g1"]["mont_mul"],
                                           "msm_g2": dist_launches["g2"]["mont_mul"],
                                           "pairing": dist_launches["pairing"]["mont_mul"],
                                           "msm_auto": dist_launches["auto"]["mont_mul"]},
                     at_pairing_batch=k1["at_pairing_batch"]),
        _kernel_line("bucket_accumulate", "bucket_accumulate.cu",
                     "ark_blst_tpu/curves/msm_pallas2.py:359 (KC2_G1)",
                     msm_launches["g1"]["bucket_accumulate"], k2s["g1"],
                     launches_distributed={
                         "msm_g1": dist_launches["g1"]["bucket_accumulate"],
                         "msm_auto": dist_launches["auto"]["bucket_accumulate"]},
                     wrapper_ms=k2s["g1"]["wrapper_ms"],
                     bound_radix13_ms=k2s["g1"]["bound_radix13_ms"]),
        _kernel_line("g1_point_words", "bucket_accumulate.cu",
                     "ark_blst_tpu/curves/msm_pallas2.py:359 (KC2_G1; K2's point input)",
                     msm_launches["g1"]["g1_point_words"], k2s["g1_words"],
                     launches_distributed={
                         "msm_g1": dist_launches["g1"]["g1_point_words"],
                         "msm_auto": dist_launches["auto"]["g1_point_words"]}),
        _kernel_line("bucket_accumulate_g2", "bucket_accumulate_g2.cu",
                     "ark_blst_tpu/curves/msm_pallas2.py:359 (KC2_G2)",
                     msm_launches["g2"]["bucket_accumulate_g2"], k2s["g2"],
                     launches_distributed={
                         "msm_g2": dist_launches["g2"]["bucket_accumulate_g2"]},
                     wrapper_ms=k2s["g2"]["wrapper_ms"],
                     bound_radix13_ms=k2s["g2"]["bound_radix13_ms"]),
        _kernel_line("g2_point_words", "bucket_accumulate_g2.cu",
                     "ark_blst_tpu/curves/msm_pallas2.py:359 (KC2_G2; K2-G2's point input)",
                     msm_launches["g2"]["g2_point_words"], k2s["g2_words"],
                     launches_distributed={"msm_g2": dist_launches["g2"]["g2_point_words"]}),
        _kernel_line("cyc_sqr", "cyc_sqr.cu", "ark_blst_tpu/ops/pallas_lazy.py:149",
                     launches["cyc_sqr"], k3,
                     launches_distributed={"pairing": dist_launches["pairing"]["cyc_sqr"]},
                     launches_pairing_unfused=unfused["cyc_sqr"],
                     bound_radix13_ms=k3["bound_radix13_ms"]),
        _kernel_line("fp12_mul", "fp12_mul.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (ops/tower_lazy.py:567 mul12)",
                     launches["fp12_mul"], k4,
                     launches_distributed={"pairing": dist_launches["pairing"]["fp12_mul"]},
                     launches_pairing_unfused=unfused["fp12_mul"],
                     bound_radix13_ms=k4["bound_radix13_ms"]),
        _kernel_line("prepare_step", "prepare_step.cu", "ark_blst_tpu/ops/pallas_lazy.py:63",
                     launches["prepare_step"], k5,
                     launches_distributed={"pairing": dist_launches["pairing"]["prepare_step"]},
                     bound_radix13_ms=k5["bound_radix13_ms"],
                     addition_ms=k5["addition"]["ms"],
                     addition_bound_ms=k5["addition"]["bound_ms"],
                     addition_bound_radix13_ms=k5["addition"]["bound_radix13_ms"]),
        _kernel_line("miller_step", "miller_step.cu", "ark_blst_tpu/ops/pallas_lazy.py:63",
                     launches["miller_step"], k6,
                     launches_distributed={"pairing": dist_launches["pairing"]["miller_step"]},
                     bound_radix13_ms=k6["bound_radix13_ms"]),
        *strict_lines,
        _kernel_line("fp12_sqr", "fp12_sqr.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (ops/tower_lazy.py:570 sqr12)",
                     unfused["fp12_sqr"], k11, bound_radix13_ms=k11["bound_radix13_ms"]),
        _kernel_line("fp12_mul_by_014", "fp12_mul_by_014.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (ops/tower_lazy.py:573 mul_by_014)",
                     unfused["fp12_mul_by_014"], k12,
                     bound_radix13_ms=k12["bound_radix13_ms"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
