#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ark_blst_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds and runs its main path there.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env      the card's name and power limit; builds the kernels from
              their thirteen sources and scripts/fp_inv_probe.cu (one nvcc
              per source, all in parallel) and reports build seconds,
              registers, spills and static SASS counts;
  2. k1       K1 (mont_mul) against its plain PyTorch version at 2^22
              elements, bit for bit, random and extreme digit patterns,
              and again timed at the pairing's batch (8192 elements);
     k1_chains  the lazy engine's inversion chains (`ops/fp_inv.py`, one
              launch a chain, 32-bit words inside) against their plain
              versions by canonical value, their digits within 4096, and
              against the oracle's inverses on a sample: K1-inv (the
              binary-GCD inversion) at 8192 (the pairing batch), 1,024 (the G1 MSM's
              root), 256 (the G2 MSM's) and 1 (a multi-pairing) with X =
              0, 1, p-1 and R mod p in the first lanes; K7-inv (the strict
              engine's inversion on strict limbs, the same body) at 8192,
              1000 and 1 on canonical limbs with the same first lanes, limb
              for limb against its plain version (the strict loop of
              products on the plain product) and the oracle on a sample,
              timed beside K1-inv and the 610 K7 launches it replaced
              (the Fermat ladder's body is timed by scripts/fp_inv_probe.py,
              not here: no phase runs it), with the body's one-thread
              latencies (a batch of
              GCD steps, its update, a dependent operation) and the floor
              of its 780 dependent steps; K1-scan's up and
              down passes at the G1 MSM's two levels (64 rows of 65,536
              and of 1,024 columns) and the G2 MSM's (64 rows of 16,384
              and of 256);
              the whole `batch_inverse` at 2^22; each timed beside its
              plain version and its bound, with registers, stack, spills
              and launch shape;
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
              counts of that run (checked for the K1 family: 2 K1 products,
              one K1-inv ladder, two levels of K1-scan, 2 + 2 passes) and
              its points/s; then the four stages
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
              of that run (K1 10, K1-inv 1, K1-scan 2 + 2), its peak memory
              and its points/s, then the
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
              bound beside the radix-13 one (K5 and K6 as chains of one
              event); K4 also in its word layouts (words -> words and
              words -> strict limbs, the multi-pairings' product fold) on
              the words of its operands and of the real ones, at 8192 and
              at each width of the fold (4096 down to 1), word for word
              and limb for limb against its plain version, each timed
              beside the digit layout at the same width; and in the
              strict engine's layout (strict limbs -> strict limbs, its
              multi-pairings' fold) on the strict limbs of those words,
              likewise;
     tower_chains  K5-chain and K6-chain, the prepare's and the Miller
              loop's 68 events in one launch each, through the fused
              pipeline's entries (`prepare_lines`, `miller_lines`) on its
              real inputs (the pairs of phase 8 as strict limbs; R = (Q,
              1) and f = one formed in the kernels; the lines as 32-bit
              words between) at N = 8192 and at the ragged N = 1000:
              every event's line word for word against the plain version;
              K6-chain in the fused pairing's layout (conj(f) stored as
              words) word for word, and storing f as digits (the
              public `miller_loop`'s; on the lines as words and as digits)
              by canonical value, f's digits within 4096; at 8192 the
              lines, f and conj(f) of the first eight pairs (identities
              skipped) against the oracle's prepare_g2 and miller_loop;
              each timed beside its plain version and its bound, K6's f as
              digits beside, the digit entries' run of the same events
              (`prepare_chain`, `miller_chain`, digits in and between)
              beside with their bound, and the lines' bytes in each layout,
              with the launch shape and ptxas; both chains on the strict
              engine's edges (the lines and conj(f) as strict limbs, its
              fused `prepare_g2` and `miller_loop`) limb for limb against
              their plain versions and the word chains' output, timed
              beside the word instantiations in the same run; the card's
              clocks, temperature and power draw before and after the
              timings;
     final_exp_chains  FE-easy and FE-hard, the fused final
              exponentiation in two launches (`ops/final_exp.py`: the easy
              part to 32-bit words, the hard part's program from them), on
              real Miller outputs of the phase-8 pairs (the fused pairing's
              route: conj(f) as words, identities masked to one on words)
              at N = 8192, the ragged 1000 and 1 (a multi-pairing's):
              FE-easy on those words and on their digits word for word
              against its plain version, FE-hard storing strict limbs limb
              for limb (on FE-easy's words and on the plain easy part's)
              and storing digits (within 4096) by value; at 999 both
              against their first 999 columns at 1000 (partly filled last
              blocks; FE-hard's block size follows the width); at 8192 the first
              eight results (an identity among them) against the oracle's
              pairings; each timed in the fused pairing's layout beside its
              plain version and its bound, the other layout beside, with
              its launch shape and ptxas; FE-easy on the strict engine's
              fused route (K5-chain and K6-chain on strict limbs, the mask
              on the limbs) word for word, timed beside FE-easy on words;
  8. pairing  8192 pairings of 8 distinct (P, Q) pairs (P_i = P[i mod 8],
              Q_i = Q[(3i+1) mod 8], the construction of the JAX package's
              bench.py) with one identity P and one identity Q, through the
              public entry `bls12.pairing_batch`: every result checked
              against the oracle pairing (the identity pairs against one),
              the launches of K1, K1-inv, K3-K6 and FE-easy/FE-hard in that
              call (K5, K6, FE-easy and FE-hard once, K1, K1-inv, K3 and K4
              never, and the lazy egress never called, checked),
              pairings/s of a warm call, the stages (ingest, prepare_g2,
              miller_loop: K6-chain storing conj(f) as words and the mask
              on words; final_exp: FE-easy on words, FE-hard storing the
              strict limbs; egress: host codecs alone) rerun with a
              synchronize between them and once more under
              `torch.profiler` (each launches its chains once and no other
              kernel of the port, and at most 10, 6, 4 and 0 device kernels,
              12 in all, checked; the egress's none also as dispatched),
              the peak device memory;
              then the prepared path (`prepare_g2_batch` once, one K5
              launch; `pairing_batch` against it, one K6, FE-easy and
              FE-hard launch and no K5),
              checked equal to the unprepared results;
     pairing_unfused  the same instance through `bls12.pairing_batch(...,
              fuse=False)`: every result checked against the oracle and the
              fused results (the two paths' digits differ on the card, K11
              and K12 on 32-bit words, their values agree), K11 launched
              63 and K12 68 times, K3 317, K4 37, K1 658 and K1-inv once,
              K5, K6, FE-easy and FE-hard never,
              with pairings/s, stages and their launches, a profiled
              rerun, peak memory and the prepared path with fuse=False;
     pairing_strict  the same instance through the tensor entry
              `pairing(..., engine="strict")` on both routes, timed in
              turns (fused, unfused, unfused, fused), each limb for limb
              against the lazy engine's output and against the oracle:
              fused (the default) on the chains' strict-limb
              instantiations, K5-chain, K6-chain and FE-easy once each and
              FE-hard once, no K7-K10 or K7-inv (checked), its stages
              (at most 10, 6, 4 and 0 device kernels, 12 in all, the
              egress none also as dispatched; checked) and a profiled
              rerun; unfused (`fuse=False`) on K7-K10 and one K7-inv
              ladder, no chain (checked), with stages, K7-K10 launches
              per stage, per Miller event (mean) and per cyclotomic
              square, and a profiled rerun; then `multi_pairing` and
              `multi_miller_loop_prepared` at 1024 pairs on the lazy
              engine and both strict routes, equal to each other and the
              first to the oracle's product, with their launches, each
              entry counted from 0: the strict fused route's fold on K4's
              strict limbs 10 times and no K7-K10 launch (checked), its
              prepared Miller product against the oracle's;
              and line `multi_pairing`: the word route of `multi_pairing`,
              `multi_miller_loop` and `multi_miller_loop_prepared` at 1024
              pairs and of `multi_pairing` at 8192, each run once with the
              counts at 0 (K6 once, K4 ceil(log2 N) times on words, the
              Miller product's last level once to strict limbs, no digit
              K4, the lazy egress never called; checked), limb for limb
              against the digit route it replaced (K6 storing f as
              digits, the fold on K4's digits, the eager egress) and
              against the oracle's product, both routes timed in turns,
              with their device kernels under the profiler and as
              dispatched, the digit route's egress alone timed, with the
              card's name and power limit;
     api      the arkworks API's batch entries with their defaults (the
              card's routes): `G1Projective.msm` over 2^18 G1Affine bases
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
              oracle's product (K4 nine times on words and once to strict
              limbs, the lazy egress never called; checked); the generator pairing's bytes and every
              `msm_g1` vector of `tests/vectors/bls12_381.json` through
              the device routes; a validated compressed round trip of the
              MSM results and 64 bases a curve;
     fp_inv_batch  `tower_lazy.fp_inv_batch` against `fp_inv` (one K1-inv
              launch) at 8192 elements, both checked against the oracle's
              inverses, timed;
  9. k7_k10   the strict engine's kernels K7-K10 (mont_mul, add, sub, neg)
              against their plain versions, bit for bit, at Fp (2^22
              elements) and Fr (2^20): seeded random canonical values with
              every pair of extreme values (0, 1, p-1, p-2, all-ones low
              limbs below p) in the first columns; the plain versions run in
              chunks of 2^20 elements; then once more on the MSM's broadcast
              pair (24, 1024, 32, 1) x (24, 1024, 1, 1);
 10. fpmul    32 chained K7 products over 2^20 Fp elements (bench.py's
              bench_fpmul), checked against the oracle, products/s;
 11. msm_scan the strict engine's scan Pippenger MSM (`curves/msm.py:msm`):
              first its three chains (`ops/scan_msm.py`: scan-acc, the
              bucket accumulation; scan-red, the running/total sums;
              scan-horner) against their plain loops (K7-K10 on the card)
              limb for limb at a check size, 2^14 G1 bases and 1024 lanes,
              each on the plain loop's own input, timed beside it, and
              scan-acc's three launches (its point words, its walk, its
              split) each against its plain version there; then
              at 2^20 distinct G1 bases (`curves/instance.py`, with an
              identity point and a zero scalar), c = 8, 1024 lanes, then
              `G1.to_affine` of the result on the card, both checked
              against the expected point, each chain launched once and
              K7-K10 only in the fold across lanes and in `to_affine`
              (checked, their counts printed), its peak memory and
              points/s; then the stages (digits, accumulate, fold,
              reduce, horner) rerun with a synchronize between them, and
              once more under `torch.profiler`; each launch's time at full
              width beside its bound, launch shape and ptxas; scan-acc's
              time as a function (its three launches) beside the
              function's bound, its scratch bytes, and its fixed cost and
              time a step from its times at the two sizes;
 12. msm_scan_g2  the same for G2 (the check at 2^12 bases, 256 lanes;
              the run at 2^18 bases, c = 8, 256 lanes); its `to_affine`
              inverts in Fp2, which launches K10;
 13. msm_naive   scan-mul (`CurveOps.scalar_mul`, one launch) on G1 and
              G2 against its plain loop (K7-K10 on the card) limb for limb
              at 32 elements and 256 bits, scalars 0, 1, r - 1 and
              2^256 - 1 and an identity base in the first lanes, and
              against the oracle there; its time at 2^12 elements beside
              the plain loop's, at its launch shape (`MUL_SHAPE`; other
              shapes: scripts/scan_mul_probe.py); then a 2^12 G1 instance
              through the ladder alone
              (one scan-mul launch, no K7-K10: checked), `msm_naive` (one
              scan-mul launch, K7-K10 only in its fold: checked) and
              `msm`, both checked, and `G1.to_affine` of the 2^12 bases
              (one batch inversion, one K7-inv at batch 1) checked point
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
              and K3-K6 launches, the gather and a profiled rerun; then on
              the strict engine fused (the chains on strict limbs, the
              fold on K4's strict limbs, no K7-K10; checked), limb for
              limb the lazy result;
     distributed_msm_scan  `msm_sharded` (the scan MSM: scan-acc and
              scan-red once, K7-K10 in the fold; checked) at 2^16 G1
              bases, c = 8, 1024 lanes, `finish="host"`;
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
elements as `at_pairing_batch`; K1-inv (`fp_inv`) and K1-scan
(`batch_inverse_scan`, its up and down passes together) the same
launches, K1-inv its times at 8192 elements and the other widths beside,
K5-chain (`prepare_chain`) and K6-chain (`miller_chain`) the fused
batch's launches, the prepared batch's, the unfused one's and the sharded
pairing's, their times at 8192 with the ragged width's, the same events
launched one by one (`by_event_ms`) and the one-event runs of phases k5
and k6 beside, FE-easy and FE-hard (`final_exp_easy`, `final_exp_hard`)
the fused batch's launches, the prepared batch's, the unfused one's and
the sharded pairing's, their times at 8192 with the other widths',
K1-scan one level of the G1 MSM (64 x 65,536) and the other three levels
and the whole `batch_inverse` at 2^22 beside; K3 and K4 give the unfused
pairing's launches (the path that runs them; the fused batch's 0 beside); K4's word
layouts (`fp12_mul_words`, `fp12_mul_limbs`) the launches of
`multi_pairing` and of `multi_miller_loop` at 1024, each multi-pairing
entry's, the API's and the sharded pairing's beside, their times at 8192
and at each width of the fold with the digit layout's; K11 and K12 the
unfused pairing's;
K7-K10 give as `launches` the sum over the two scan MSM runs (the fold
across lanes and `to_affine`), each run's
count and the strict pairing's beside it (the unfused route's; the fused
route's 0 and the strict multi-pairings' beside), and their Fp times at
2^22, Fr and broadcast times beside; K4 on strict limbs
(`fp12_mul_limbs_limbs`) the strict fused `multi_pairing`'s launches at
1024, its prepared Miller product's and the sharded strict pairing's
beside, its times at 8192 and each fold width with the digit layout's;
the scan chains (`scan_acc_words`, `scan_acc_walk`, `scan_acc_split`:
scan-acc's point words, walk and split; `scan_red`, `scan_horner`) the G1
scan MSM's launches, the G2 one's and the sharded scan's beside, their
times at full width (G1; G2's under `g2`) beside their bounds, their plain
versions' times and their own at the check size, launch shapes (the
walk's team; scan-red's team, block and column; scan-horner's team) and
ptxas;
`scan_acc` scan-acc as one function (its three launches, `launches` its
walk's), its time, bound, plain time, fixed cost, time a step and scratch
bytes; the strict
engine's chains
(`prepare_chain_limbs`, `miller_chain_limbs`, `final_exp_easy_limbs`)
the fused strict batch's launches, their times at 8192 with the other
widths' and the word instantiation's in the same run (`words_ms`), their
registers; K7-inv (`fp_inv_limbs`) the unfused strict batch's launch, the
scan MSMs' and `msm_naive`'s `to_affine`'s, its times at 8192 and the other widths with
K1-inv's and the K7 loop's it replaced beside, the
binary GCD's bound (`bound_ms`), the Fermat work's (`fermat_bound_ms`) and
the GCD's latency floor; `scan_mul` the
`msm_naive` launch, its time at 2^12 on G1 (G2's under `g2`) beside its
bound, plain time, launch shape and ptxas; every kernel phase distributed launches gives
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
(WORDS_TO_DIGITS_OPS); K4's word layouts the product alone, its 24
components in and 12 out as words or strict limbs (a load or a store, in
the bytes alone); K5-chain and K6-chain count each event's
products and sums, Q (K5) or P (K6) in once as strict limbs
(LIMBS_TO_WORDS_OPS: packed, four conditional subtractions), each
event's 6 line components out (K5) or in (K6) as words (no conversion),
and conj(f) out once as words, 6 negations (K6 storing f as digits
beside: 12 conversions; `chain_work`), and bytes as those components
read or written once (96 bytes a limb component, 48 a word one, 120 a
digit one); beside, the digit entries' edges (R and Q or f and P in, the
lines out and in, all as converted digits); FE-easy and FE-hard
count their Fp2 and fp12 work (the norm's inverse by the binary GCD it
runs, `gcd_inv_ops`, FE-hard's squares and products from its program), f in as
words and the easy part out as words (FE-easy), the easy part in as
words and the result out as strict limbs, a split of each word
(FE-hard; `final_exp_work`), the digit layouts beside (f in, the result
out as converted digits), their values' scratch words left out as the
kernel's own. The one-launch
kernels' lines (and the chains' one-event runs) give the radix-13 work's
bound beside (`bound_radix13_ms`), and their IMAD floor counts the
launch's products
(conversions included) at the IMAD instructions of one product of their
own library: its static IMAD count (moves left out) over the CIOS bodies
it compiles (its wide multiply-adds over the 288 of one product). K1-inv
and K7-inv count per element the binary GCD they run (`gcd_inv_ops`: 26
batches of 30 steps, the approximations and the four linear updates, one
product), K1-inv one conversion in and one out besides, and the digits or
limbs read and written once; beside it (`fermat_bound_ms`) the Fermat
work they ran before: the CIOS products of the shortest sliding-window
chain for p - 2 (`window_chain_products`: 460 at width 5, 377 squarings
and 83 products with the table, where the Fermat ladder runs 608), and
the GCD's latency floor (780 dependent steps at the time a step that
scripts/fp_inv_probe.cu measures on one thread, `floor_ms`); K1-scan
per level of n = g m elements the work the function needs, whatever the
passes: each element converted in once and its inverse out once, three
products for each element past the first row (the prefix, the inverse,
the running inverse), each column's product out and its inverse in
(the kernel converts z in once in each pass), and the stack and the
inverses read and written once, the column products once each way (the
prefix words are the kernel's own scratch, left out). The
strict kernels K7-K10 count bytes as 4 L per operand and result element
(int32 limbs), and instructions by `strict_ops`: three per 32 x 32-bit
word product, two per word of a carry chain, three per word of the
conditional subtraction, two per word packed or unpacked; every one of
them is bytes-bound. K4 on strict limbs counts K4's product and each
input component's load from limbs (LIMBS_TO_WORDS_OPS). The scan chains
count complete additions (COMPLETE_ADD32_OPS: 12 products and 27 Fp sums
on G1, 12 Fp2 products and 58 Fp sums on G2) and doublings
(COMPLETE_DBL32_OPS: 8 products and 13 sums, 8 Fp2 products and 28 Fp
sums), and each point component converted once from limbs: scan-acc one
addition a point and window, its bytes the points, digits and buckets
once (as a function; its point words the conversion, its walk the
additions on words, its split bytes alone); scan-red 2 (B - 1) additions
a window; scan-horner W (c doublings and an addition)
(`scan_chain_work`); scan-mul num_bits doublings and additions an element,
its points and scalars read and its results written once as limbs
(`scan_mul_work`).
"""

from __future__ import annotations

import ctypes
import functools
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
# phase tower_chains: a ragged width near multi_pairing's 1024 (31 blocks of
# 32 and one of 8), and the first columns held against the oracle
CHAIN_RAGGED_N = 1000
CHAIN_ORACLE_COLS = 8
# phase final_exp_chains: the pairing batch, the ragged width, a
# multi-pairing's one element after its fold
FINAL_EXP_WIDTHS = (PAIRING_N, CHAIN_RAGGED_N, 1)
STRICT_MULTI_N = 1024  # multi_pairing / multi_miller_loop_prepared on both engines
STRICT_LOG_N = {"fp": 22, "fr": 20}
STRICT_PLAIN_CHUNK = 1 << 20
FPMUL_N, FPMUL_ITERS = 1 << 20, 32  # bench.py:bench_fpmul
SCAN_C = 8  # the JAX package's msm default: W = 32, B = 256
# curve: (log2 bases, lanes, seed); G2 is cut to 2^18 for the Fp2 fold's
# temporaries (3x G1's per element) and the time limit
SCAN = {"g1": (20, 1024, 17), "g2": (18, 256, 19)}
# the scan chains against their plain loops (K7-K10 on the card, a launch
# per field op): curve -> (log2 bases, lanes, seed), the full width's lanes
SCAN_CHECK = {"g1": (14, 1024, 47), "g2": (12, 256, 53)}
NAIVE_LOG_N, NAIVE_SEED = 12, 23
MUL_CHECK_LOG_N, MUL_SEED = 5, 59  # scan-mul's check: 32 elements (seed + 1 on G2)
# the API phase: curve -> (log2 bases, seed); G1 is cut from 2^20 (a
# KZG/Groth16 size) to 2^18 for the time limit: the host codecs took ~45 s
# of it at 2^20 (2^22 would spend ~2 minutes in them)
API_MSM = {"g1": (18, 29), "g2": (16, 31)}
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
# The scan MSM's chains on group381.cuh's complete_add / complete_dbl: an
# addition 12 products and 27 Fp sums on G1 (the three operand-sum legs
# 12, 3 t0 2, two mul_b3 8, z3 and t1' 2, the results 3), 12 Fp2 products
# and 58 Fp sums on G2 (19 Fp2 sums, two each, and two mul_b3 of 10); a
# doubling 8 products and 13 Fp sums on G1 (8 t0 3, mul_b3 4, 3 t2 2, the
# sum and difference 2, 2X and Y3 2), 8 Fp2 products and 28 Fp sums on G2
COMPLETE_ADD32_OPS = {"g1": 12 * MONT_MUL32_OPS + 27 * ADD32_OPS,
                      "g2": 12 * FP2_MUL32_OPS + 58 * ADD32_OPS}
COMPLETE_DBL32_OPS = {"g1": 8 * MONT_MUL32_OPS + 13 * ADD32_OPS,
                      "g2": 8 * FP2_MUL32_OPS + 28 * ADD32_OPS}
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
# one Fp component in from strict limbs: 24 limbs masked and packed (three
# a word), 4 conditional subtractions of 2^k p (four a word); in or out as
# words, a load or a store a word, counted in the bytes alone
LIMBS_TO_WORDS_OPS = 12 * 3 + 4 * 4 * 12
CIOS_WIDE_MULS = 2 * _NW * _NW  # a_j b_i and m p_j, 32 x 32 -> 64 bits each
PREPARE_PRODUCTS = {False: 25, True: 37}
PREPARE_INPUTS = {False: 6, True: 10}  # Fp components: R, and Q for the addition
MILLER_PRODUCTS = {True: 85, False: 49}
ELEM_BYTES = 30 * 4  # one Fp element of digits
LIMB_BYTES = 24 * 4  # one Fp element of strict limbs
WORD_BYTES = 12 * 4  # one Fp element of words
# phase k1_chains: K1-inv at the pairing batch, the G1 MSM's root, the G2
# MSM's root and a multi-pairing's width (K7-inv at the pairing batch, the
# ragged width near a multi-pairing's 1,024 and one, K7_INV_WIDTHS); K1-scan at the G1 MSM's two levels
# at 2^22 and the G2 MSM's two at 2^20 (rows, columns)
K1_INV_WIDTHS = (PAIRING_N, 1024, 256, 1)
K7_INV_WIDTHS = (PAIRING_N, CHAIN_RAGGED_N, 1)
# The binary-GCD inversion (csrc/fp_inv.cuh `inverse`), int32 instructions
# an element counted from the code: a step (gcd_steps) 31: the swap's
# compare and masks on the 64-bit approximations, the masked subtraction,
# the shift, the four factors' swap, subtraction and doubling; the
# approximations 100 (nine masked word shifts of six words, the leading
# zeros, the 96-bit shift); a signed 12-word x 32-bit product 75 (a wide
# multiply-add, carry, complement and increment a word), a pair of them
# summed 176; the update of a or b (gcd_lin) the pair, the shift by 30 and
# the negation, 226; of u or v (gcd_mod) the pair, the Montgomery step, the
# correction by p and one conditional subtraction, 311; 26 batches of 30
# steps, the approximations and the four updates, then one CIOS product
GCD_STEPS, GCD_BATCHES = 30, 26
GCD_STEP_OPS, GCD_APPROX_OPS = 31, 100
_GCD_PAIR = 2 * (3 + 12 * 6) + 13 * 2
GCD_LIN_OPS = _GCD_PAIR + 12 * 4 + 2
GCD_MOD_OPS = _GCD_PAIR + 1 + 12 * 4 + 2 + 12 * 3 + 12 * 4
GCD_BATCH_OPS = GCD_APPROX_OPS + GCD_STEPS * GCD_STEP_OPS + 2 * GCD_LIN_OPS + 2 * GCD_MOD_OPS + 8
K1_SCAN_LEVELS = ((64, 1 << 16), (64, 1 << 10), (64, 1 << 14), (64, 1 << 8))


def gcd_inv_ops() -> int:
    """int32 instructions of one element's binary-GCD inversion on words
    (GCD_BATCH_OPS a batch, then the product by the final factor)."""
    return GCD_BATCHES * GCD_BATCH_OPS + MONT_MUL32_OPS


def window_chain_products(bits) -> int:
    """Products, squarings included, of the shortest sliding-window chain
    over widths 1-8 that raises x to the exponent with these bits (most
    significant first): x^2 and the odd powers x^3 .. x^(2^w - 1) first,
    then a squaring a bit and a product a window."""
    best = None
    for w in range(1, 9):
        i, first, count = 0, True, (2 ** (w - 1) if w > 1 else 0)
        while i < len(bits):
            if bits[i] == 0:
                count += 0 if first else 1
                i += 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == 0:
                j -= 1
            count += 0 if first else (j - i) + 1
            first, i = False, j
        best = count if best is None else min(best, count)
    return best


def fp_inv_ops(bits) -> int:
    """int32 instructions of one lane's inverse: the shortest window chain's
    CIOS products between one conversion in and one out."""
    return (window_chain_products(bits) * MONT_MUL32_OPS
            + DIGITS_TO_WORDS_OPS + WORDS_TO_DIGITS_OPS)


def final_exp_work() -> dict:
    """(bytes, int32 instructions) an element of FE-easy and FE-hard, the
    work the function needs. FE-easy: f's 12 components in as words (the
    fused pairing's; "easy_digits": from digits, converted), fp12_inv (26
    Fp2 products and 15 Fp2 squares with FE-easy's, 62 Fp2 sums and 13
    products by xi, 3 Fp2 and 1 Fp negations, the norm's 4 products and 1
    sum, its inverse by the binary GCD the kernel runs, `gcd_inv_ops`),
    the two fp12 products and the Frobenius square's 5 Fp2 products; t2 out
    as words.
    FE-hard, counted from HARD_PROGRAM: its cyclotomic squares and fp12
    products, each Frobenius map's 5 Fp2 products (6 Fp2 negations for an
    odd power), each conjugation's 3 Fp2 negations (the kernel's Fp jobs
    make more sums, 117 a square and 365 a product against the 107 and
    224 counted: each leg sums its own operands; the bound keeps the
    function's count); t2 in as words, the
    result out as strict limbs (a word split in two: a store; "hard_digits":
    as digits, converted); "easy_limbs": FE-easy with f in as the strict
    engine's limbs (a repack, counted in the bytes alone)."""
    from ark_blst_tpu_torch.ops import final_exp as FE

    fp2_sqr = 2 * MONT_MUL32_OPS + 3 * ADD32_OPS
    easy = (26 * FP2_MUL32_OPS + 15 * fp2_sqr + (62 + 13) * 2 * ADD32_OPS + 7 * NEG32_OPS
            + gcd_inv_ops() + 4 * MONT_MUL32_OPS + ADD32_OPS
            + 2 * FP12_MUL32_OPS + 5 * FP2_MUL32_OPS)
    prog = FE.HARD_PROGRAM
    conjs = sum(c == FE.CONJ for c, *_ in prog) + sum(
        bin(fl).count("1") for c, _, _, fl in prog if c == FE.LOAD)
    hard = (sum(a for c, a, _, _ in prog if c == FE.SQR) * CYC_SQR32_OPS
            + sum(c == FE.MUL for c, *_ in prog) * FP12_MUL32_OPS
            + sum(5 * FP2_MUL32_OPS + 12 * NEG32_OPS * (a % 2) for c, a, _, _ in prog
                  if c == FE.FROB)
            + conjs * 6 * NEG32_OPS)
    words = 12 * WORD_BYTES  # an fp12 as words
    return {"easy": (2 * words, easy), "hard": (words + 12 * LIMB_BYTES, hard),
            "easy_limbs": (12 * LIMB_BYTES + words, easy),
            "easy_digits": (12 * ELEM_BYTES + words, easy + 12 * DIGITS_TO_WORDS_OPS),
            "hard_digits": (words + 12 * ELEM_BYTES, hard + 12 * WORDS_TO_DIGITS_OPS)}


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
    """Each kernel entry's registers, cumulative stack and spill bytes
    (`entries`, by mangled name), those of the entry with the most
    registers, and the spill bytes summed over all functions of the
    library."""
    out = {"spill_store_bytes": 0, "spill_load_bytes": 0, "entries": {}}
    entry, frame, spills = None, 0, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "spill stores" in line:
            parts = line.replace(",", "").split()
            frame, spills = int(parts[0]), (int(parts[4]), int(parts[8]))
            out["spill_store_bytes"] += spills[0]
            out["spill_load_bytes"] += spills[1]
        if "Used" in line and "registers" in line:
            stack = (int(line.split("barriers,")[1].split("bytes")[0])
                     if "cumulative stack size" in line else frame)
            out["entries"][entry] = {
                "registers": int(line.split("Used")[1].split("registers")[0]), "stack_bytes": stack,
                "spill_store_bytes": spills[0], "spill_load_bytes": spills[1]}
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
    """The kernels by name: K1, K1-inv and K1-scan (its up and down passes;
    one source with K1-inv), K7-inv (the strict engine's Fermat ladder, the
    same source), K2 (the G1 and G2 MSMs; each bucket kernel's source also
    holds its point conversion), K3 and K4 (the unfused final
    exponentiation; K4's word layouts, words -> words and words -> strict
    limbs, the multi-pairings' product fold, a counter each), K5 and K6
    (the fused prepare and Miller loop; their strict-limb instantiations,
    the strict engine's fused route, a counter each), FE-easy and FE-hard
    (the fused final exponentiation; one source; FE-easy on strict limbs
    a counter of its own), K7-K10 (the strict engine; one source, four
    entry points), K4 on strict limbs (the strict multi-pairings' fold),
    scan-acc, scan-red and scan-horner (the scan MSM's chains; one source),
    K11 and K12 (the unfused Miller loop): thirteen sources."""
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import cyc_sqr as K3
    from ark_blst_tpu_torch.ops import final_exp as FE
    from ark_blst_tpu_torch.ops import fp12_mul as K4
    from ark_blst_tpu_torch.ops import fp12_mul_by_014 as K12
    from ark_blst_tpu_torch.ops import fp12_sqr as K11
    from ark_blst_tpu_torch.ops import fp_inv as FI
    from ark_blst_tpu_torch.ops import mont_mul as MM
    from ark_blst_tpu_torch.ops import scan_msm as SM
    from ark_blst_tpu_torch.ops import strict_field as SF

    return {"mont_mul": MM.KERNEL, "fp_inv": FI.KERNEL_INV, "scan_up": FI.KERNEL_UP,
            "scan_down": FI.KERNEL_DOWN, "fp_inv_limbs": FI.KERNEL_INV_LIMBS,
            "bucket_accumulate": MB.KERNEL,
            "g1_point_words": MB.KERNEL_G1_WORDS,
            "bucket_accumulate_g2": MB.KERNEL_G2, "g2_point_words": MB.KERNEL_G2_WORDS,
            "cyc_sqr": K3.KERNEL,
            "fp12_mul": K4.KERNEL, "fp12_mul_words": K4.KERNEL_WORDS,
            "fp12_mul_limbs": K4.KERNEL_LIMBS, "fp12_mul_limbs_limbs": K4.KERNEL_LIMBS_LIMBS,
            "prepare_step": PS.PREPARE_KERNEL,
            "miller_step": PS.MILLER_KERNEL, "final_exp_easy": FE.KERNEL_EASY,
            "final_exp_hard": FE.KERNEL_HARD, "prepare_chain_limbs": PS.PREPARE_KERNEL_LIMBS,
            "miller_chain_limbs": PS.MILLER_KERNEL_LIMBS,
            "final_exp_easy_limbs": FE.KERNEL_EASY_LIMBS,
            **{"strict_" + op: k for op, k in SF.KERNELS.items()}, **SM.KERNELS,
            "fp12_sqr": K11.KERNEL, "fp12_mul_by_014": K12.KERNEL}


def _smi() -> list:
    """The cards' names and power limits, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


@functools.lru_cache(maxsize=None)
def fp_inv_probe():
    """scripts/fp_inv_probe.py as a module: the binary GCD's one-thread
    latencies, beside K7-inv."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "fp_inv_probe.py")
    spec = importlib.util.spec_from_file_location("fp_inv_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_env(torch):
    from ark_blst_tpu_torch import cuda as KC

    smi = _smi()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    # one per source, scripts/fp_inv_probe.cu with them
    owners = KC.build_all([*all_kernels().values(), fp_inv_probe().PROBE])
    build_s = time.perf_counter() - t0
    sass = {os.path.basename(k.source): _sass_counts(k) for k in owners}
    ptxas = {os.path.basename(k.source): _ptxas_summary(k.build_log) for k in owners}
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


def scan_level_ops(g: int, m: int) -> tuple:
    """int32 instructions of one level of the blocked batch inversion over g
    rows of m columns, split as its up and down passes (the bound model in
    the docstring)."""
    n = g * m
    up = n * DIGITS_TO_WORDS_OPS + (n - m) * MONT_MUL32_OPS + m * WORDS_TO_DIGITS_OPS
    down = m * DIGITS_TO_WORDS_OPS + n * WORDS_TO_DIGITS_OPS + 2 * (n - m) * MONT_MUL32_OPS
    return up, down


def k1_family_expected(n: int, products: int) -> dict:
    """The K1-family launches of one MSM prepare over n points: its K1
    products, one K1-inv ladder at the root, and an up and a down pass of
    K1-scan for each level of the batch inversion."""
    from ark_blst_tpu_torch.ops import fp_inv as FI

    levels = 0
    while (g := FI.block_rows(n)) is not None:
        n //= g
        levels += 1
    return {"mont_mul": products, "fp_inv": 1, "scan_up": levels, "scan_down": levels}


def _fp_held(torch, name: str, got, want) -> int:
    """A (30, n) stack of K1-inv or K1-scan against its plain version's by
    value (canonical digits), its digits within 4096."""
    return _held_values(torch, name, got[None], want[None])


def _once_ms(torch, fn) -> tuple:
    """(device ms, result) of one call of fn between two CUDA events, no
    warm-up: for the plain versions of the inversion chains, which take
    seconds and run the lazy product phase k1 has already warmed."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _oracle_sample(torch, name: str, x, got, k: int = 64) -> None:
    """The first k lanes of got against R13^2 X^-1 mod p of x's lanes."""
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.oracle.field import P

    k = min(k, x.shape[1])
    want = [pow(v, -1, P) * LZ.R13_SQ % P if v % P else 0
            for v in LZ.digits_to_ints(x[:, :k])]
    check([v % P for v in LZ.digits_to_ints(got[:, :k])] == want,
          f"{name} differs from the oracle's inverses")


def strict_limb_stack(torch, gen, dev, n: int):
    """(24, n) canonical strict limbs on the card, random (the top limb
    below p's), with 0, 1, p - 1 and R mod p (one) in the first lanes."""
    from ark_blst_tpu_torch.ops.limbs import int_to_limbs
    from ark_blst_tpu_torch.oracle.field import P

    x = torch.randint(0, 1 << 16, (24, n), generator=gen, device=dev, dtype=torch.int32)
    x[23] = torch.randint(0, P >> 368, (n,), generator=gen, device=dev, dtype=torch.int32)
    for col, v in enumerate((0, 1, P - 1, (1 << 384) % P)[:n]):
        x[:, col] = torch.tensor([int(d) for d in int_to_limbs(v, 24)], dtype=torch.int32,
                                 device=dev)
    return x


def phase_k7_inv(torch, dev, gen) -> dict:
    """K7-inv (the strict engine's inversion, the binary GCD, one launch) at
    K7_INV_WIDTHS on canonical strict limbs, limb for limb against its
    plain version and on a sample against the oracle's inverses; timed
    beside K1-inv (the same body on digits, `k1_inv_ms`, in turns with it)
    and the loop of 610 K7 launches it replaced (`k7_loop_ms`), with its
    bounds (`bound_ms`: the binary GCD's instructions; `fermat_bound_ms`:
    the Fermat work, the shortest window chain's products; the limbs' load
    and store a repack, counted in the bytes), the GCD's latency floor
    (`floor_ms`, from the probe's one-thread chains, `latency`) and its
    launch shape."""
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import dispatch as D
    from ark_blst_tpu_torch.ops import fp_inv as FI
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.oracle.field import P

    probe = fp_inv_probe()
    latency = probe.latencies(torch, dev)
    out = {}
    for n in K7_INV_WIDTHS:
        x = strict_limb_stack(torch, gen, dev, n)
        xd = torch.randint(-LZ.F_BOUND, LZ.F_BOUND + 1, (30, n), generator=gen, device=dev,
                           dtype=torch.int32)  # K1-inv's digits, timed in turns
        plain_ms, want = _once_ms(torch, lambda: FI.fp_inv_limbs_plain(x))
        got = FI.fp_inv_limbs(x)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0 and torch.equal(got, want), "K7-inv differs from its plain version")
        vals = CV.fp_from_dev(x[:, :64])
        check(CV.fp_from_dev(got[:, :64]) == [pow(v, -1, P) if v else 0 for v in vals],
              "K7-inv differs from the oracle's inverses")
        bms, by = bound_ms(n * 2 * LIMB_BYTES, n * gcd_inv_ops())
        k1_ms = cuda_ms(torch, lambda: FI.fp_inv(xd), 3)
        ms = cuda_ms(torch, lambda: FI.fp_inv_limbs(x), 3)
        ms2 = cuda_ms(torch, lambda: FI.fp_inv_limbs(x), 3)
        out[n] = {"n": n, "max_abs_err": err, "ms": ms, "ms_turns": [ms, ms2],
                  "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "fermat_bound_ms": bound_ms(
                      n * 2 * LIMB_BYTES,
                      n * window_chain_products(FI.P_MINUS_2_BITS) * MONT_MUL32_OPS)[0],
                  "floor_ms": latency["floor_steps_ms"],
                  "k1_inv_ms": [k1_ms, cuda_ms(torch, lambda: FI.fp_inv(xd), 3)],
                  "k7_loop_ms": cuda_ms(torch, lambda: D.fp_pow(x, P - 2), 1),
                  "launch": _launch_shape(torch, FI.KERNEL_INV_LIMBS, n)}
    out["latency"] = latency
    return out


def phase_k1_chains(torch, dev, ptxas: dict) -> dict:
    """K1-inv and K1-scan against their plain versions by value and against
    the oracle on a sample, timed at the main path's widths; K7-inv beside
    (`phase_k7_inv`)."""
    from ark_blst_tpu_torch.ops import fp_inv as FI
    from ark_blst_tpu_torch.ops import lazy13 as LZ
    from ark_blst_tpu_torch.oracle.field import P

    t_phase = time.perf_counter()
    F = LZ.F_BOUND
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def stack(n):
        return torch.randint(-F, F + 1, (30, n), generator=gen, device=dev, dtype=torch.int32)

    inv = {}
    for n in K1_INV_WIDTHS:
        x = stack(n)
        for col, v in enumerate((0, 1, P - 1, (1 << 384) % P)[:n]):
            x[:, col] = torch.tensor(LZ.int_to_digits(v), dtype=torch.int32, device=dev)
        plain_ms, want = _once_ms(torch, lambda: FI.fp_inv_plain(x))
        got = FI.fp_inv(x)
        err = _fp_held(torch, "K1-inv", got, want)
        _oracle_sample(torch, "K1-inv", x, got)
        bms, by = bound_ms(n * 2 * ELEM_BYTES,
                           n * (gcd_inv_ops() + DIGITS_TO_WORDS_OPS + WORDS_TO_DIGITS_OPS))
        inv[n] = {"n": n, "max_abs_err": err, "ms": cuda_ms(torch, lambda: FI.fp_inv(x), 3),
                  "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "fermat_bound_ms": bound_ms(n * 2 * ELEM_BYTES,
                                              n * fp_inv_ops(FI.P_MINUS_2_BITS))[0],
                  "launch": _launch_shape(torch, FI.KERNEL_INV, n)}
    scan = []
    for g, m in K1_SCAN_LEVELS:
        n = g * m
        z = stack(n)
        pre, total = FI.scan_up(z, g)
        plain_up_ms, (pre_plain, total_plain) = _once_ms(torch, lambda: FI.scan_up_plain(z, g))
        err_up = _fp_held(torch, "K1-scan up", total, total_plain)
        inv_total = FI.fp_inv(total)
        got = FI.scan_down(z, pre, inv_total, g)
        plain_down_ms, want = _once_ms(
            torch, lambda: FI.scan_down_plain(z, pre_plain, inv_total, g))
        err_down = _fp_held(torch, "K1-scan down", got, want)
        _oracle_sample(torch, "K1-scan", z, got)
        ops_up, ops_down = scan_level_ops(g, m)
        bms, by = bound_ms(2 * (n + m) * ELEM_BYTES, ops_up + ops_down)
        up_ms = cuda_ms(torch, lambda: FI.scan_up(z, g), 3)
        down_ms = cuda_ms(torch, lambda: FI.scan_down(z, pre, inv_total, g), 3)
        scan.append({"rows": g, "columns": m, "max_abs_err": max(err_up, err_down),
                     "ms": up_ms + down_ms, "up_ms": up_ms, "down_ms": down_ms,
                     "plain_ms": plain_up_ms + plain_down_ms, "plain_up_ms": plain_up_ms,
                     "plain_down_ms": plain_down_ms, "bound_ms": bms, "bound_by": by,
                     "up_bound_ms": bound_ms((n + m) * ELEM_BYTES, ops_up)[0],
                     "down_bound_ms": bound_ms((n + m) * ELEM_BYTES, ops_down)[0],
                     "launch": {"up": _launch_shape(torch, FI.KERNEL_UP, m),
                                "down": _launch_shape(torch, FI.KERNEL_DOWN, m)}})
        del z, pre, total, pre_plain, total_plain, inv_total, got, want
    n = 1 << LOG_N
    z = stack(n)
    got = FI.batch_inverse(z)
    plain_ms, want = _once_ms(torch, lambda: FI.batch_inverse_plain(z))
    err = _fp_held(torch, "batch_inverse", got, want)
    _oracle_sample(torch, "batch_inverse", z, got)
    whole = {"n": n, "max_abs_err": err, "ms": cuda_ms(torch, lambda: FI.batch_inverse(z), 3),
             "plain_ms": plain_ms}
    del z, got, want
    torch.cuda.empty_cache()
    inv7 = phase_k7_inv(torch, dev, gen)
    torch.cuda.empty_cache()
    res = {"fp_inv": {**inv[PAIRING_N], "at_widths": [inv[n] for n in K1_INV_WIDTHS[1:]]},
           "scan": {**scan[0], "levels": scan, "batch_inverse": whole},
           "fp_inv_limbs": {**inv7[PAIRING_N],
                            "at_widths": [inv7[n] for n in K7_INV_WIDTHS[1:]],
                            "latency": inv7["latency"]}}
    emit({"phase": "k1_chains", "ok": True, "fp_inv": list(inv.values()), "scan_levels": scan,
          "batch_inverse": whole, "fp_inv_limbs": [inv7[n] for n in K7_INV_WIDTHS],
          "gcd_latency": inv7["latency"],
          "ptxas": ptxas["fp_inv.cu"], "seconds": time.perf_counter() - t_phase})
    return res


def _launch_shape(torch, kernel, total_threads: int) -> dict:
    """A kernel's block size and the blocks an SM holds (both from its C
    entry `<symbol>_shape`, the occupancy API at the compiled registers and
    stack), and the waves its grid makes on the card's SMs (a bucket
    kernel, K1-inv, K1-scan)."""
    fn = getattr(ctypes.CDLL(str(kernel.lib_path)), kernel.symbol + "_shape")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(ctypes.byref(threads), ctypes.byref(per_sm))
    check(err == 0, f"{kernel.symbol}_shape: CUDA error {err}")
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
    shape = _launch_shape(torch, kc.kernel, W * S)
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

    entry = T.msm_g2 if kc.is_g2 else T.msm_g1
    names = _msm_kernel_names(kc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = _reset_launches()
    t0 = time.perf_counter()
    out = entry(points, scalars, device=dev, c=c)  # the main path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    leaves = kc.components(out)
    check(all(x.shape == (24, 1) and x.device == dev for x in leaves), "result shape")
    check(_affine(kc, out) == [expected], f"{phase} result differs from the expected point")
    check(all(x > 0 for x in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    _check_k1_family(launches, scalars.shape[1], kc)

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


def _msm_kernel_names(kc) -> tuple:
    """The kernels of an MSM's path: the K1 family of its prepare, its
    bucket kernel and point conversion."""
    return ("mont_mul", "fp_inv", "scan_up", "scan_down", kc.kernel.source[: -len(".cu")],
            kc.name + "_point_words")


def _check_k1_family(launches: dict, n: int, kc) -> None:
    """An MSM prepare's K1-family launches: 2 K1 products for G1 (the
    affine coordinates), 10 for G2 (the norm, the conjugate and two Fp2
    products), one ladder and two passes a level."""
    want = k1_family_expected(n, 10 if kc.is_g2 else 2)
    got = {k: launches[k] for k in want}
    check(got == want, f"{kc.name} MSM K1-family launches {got}, expected {want}")


def _affine(curve, pt) -> list:
    """A projective point batch of a `KernelCurve2` or a `CurveOps` (both
    named "g1" or "g2") -> affine host tuples."""
    from ark_blst_tpu_torch.ops import convert as CV

    return CV.g2_from_dev(pt) if curve.name == "g2" else CV.g1_from_dev(pt)


def _launch_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def _dispatched_launches(torch, fn) -> int:
    """The launches of one run of fn() as dispatched: the port's kernels'
    (their counters) and the aten ops that ran on a CUDA tensor other than
    views and allocations, each counted as one launch (a copy from the
    host as its memcpy). For a stage the profiler returned no device event
    for."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves(out))
            if on_card and not func.is_view and not str(func).startswith("aten.empty"):
                Count.ops += 1
            return out

    before = sum(_launch_counts().values())
    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.ops + sum(_launch_counts().values()) - before


def _stage(torch, fn, profiled: bool, need_device: bool = True, expect: tuple = (),
           attempts: int = 2):
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
    # between two CUDA events, which bound its device time from above, and
    # its launches are counted as dispatched (`_dispatched_launches`); the
    # summary says which it is.
    for attempt in range(1, attempts + 1):
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
               "device_kernels": sum(c for name, c in count.items()
                                     if not name.startswith(("Memcpy", "Memset"))),
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
        dispatched = _dispatched_launches(torch, fn)
        summary.update(device_ms_from="cuda_events", top=[], kernel_launches=dispatched,
                       device_kernels=dispatched, kernel_launches_from="dispatch")
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


def _tower32_shape(torch, kernel, n: int, formats: tuple = ()) -> dict:
    """The launch shape of K3-K6, K11, K12, FE-easy or FE-hard from its C
    entry `<symbol>_shape` (its leading ints `formats` first: K4's in and
    out EdgeFormat; FE-hard's width n, whose shape it reports): elements
    and threads a block, shared bytes a
    block, the blocks an SM holds (the occupancy API) and their warps
    (`resident_warps_per_sm`), and the grid's waves and warps an SM at n."""
    fn = getattr(ctypes.CDLL(str(kernel.lib_path)), kernel.symbol + "_shape")
    fn.argtypes = [ctypes.c_int] * len(formats) + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(*formats, *(ctypes.byref(v) for v in vals))
    check(err == 0, f"{kernel.symbol}_shape: CUDA error {err}")
    elems, threads, smem, per_sm = (v.value for v in vals)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-n // elems)
    return {"elements_per_block": elems, "threads": threads, "smem_bytes": smem,
            "blocks": blocks, "blocks_per_sm": per_sm, "sms": sms,
            "waves": blocks / (sms * per_sm),
            "resident_warps_per_sm": per_sm * -(-threads // 32),
            "warps_per_sm": min(blocks / sms, per_sm) * -(-threads // 32)}


def _tower32_imad(sass: dict) -> float | None:
    """IMAD instructions of one CIOS product in a 32-bit tower library: its
    static IMAD count (moves left out) over the CIOS bodies it compiles
    (its wide multiply-adds over the 288 of one product); None where the
    SASS shows none."""
    bodies = sass["imad_wide"] / CIOS_WIDE_MULS
    return (sass["imad"] - sass["imad_mov"]) / bodies if bodies else None


def phase_k3(torch, dev, real, sass: dict, ptxas: dict) -> dict:
    from ark_blst_tpu_torch.ops import cyc_sqr as K3
    from ark_blst_tpu_torch.ops import final_exp as FE

    (x,) = digit_stacks(torch, dev, [12])
    n = x.shape[-1]
    imad = _tower32_imad(sass)
    runs = {}
    for nsq in (1, max(r for r, _ in FE.X_SEGMENTS)):
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
    res["ptxas"] = _k4_ptxas(ptxas["fp12_mul.cu"], "digits")
    layouts = phase_k4_words(torch, a, b, f_real, g_real, imad, ptxas["fp12_mul.cu"])
    emit({"phase": "k4", "n": n, "value_equal": True, "real_inputs": True, **res,
          "ops_per_product": FP12_MUL32_OPS, "ops_per_product_radix13": FP12_MUL_OPS,
          "ops_conversions": conv, "imad_per_product": imad,
          "ptxas_library": ptxas["fp12_mul.cu"], "launch": _tower32_shape(torch, K4.KERNEL, n),
          "gpu": _smi()[0], **layouts})
    return res, layouts


# K4's layouts (csrc/fp12_mul.cu): (in, out) EdgeFormat of each
# instantiation, digits 0, limbs 1, words 2
K4_LAYOUTS = {"digits": (0, 0), "words": (2, 2), "limbs": (2, 1), "limbs_limbs": (1, 1)}
# the widths of the multi-pairings' fold levels: 8192 pairs fold from 4096
# down to 1 (1,024 pairs from 512)
K4_FOLD_WIDTHS = tuple(1 << k for k in range(12, -1, -1))
K4_REPS = 20  # launches a timing of K4's layouts at 8192 (one of three has read 6x the others)


def _ptxas_of(summary: dict, fragment: str) -> dict | None:
    """Registers, stack and spills of the kernel entry whose mangled name
    holds `fragment` (an instantiation by its template arguments, as
    "prepare_chain_kernelILi1ELi1E")."""
    return next((v for k, v in summary["entries"].items() if fragment in k), None)


def _k4_ptxas(summary: dict, layout: str) -> dict | None:
    """Registers and stack of one K4 instantiation, by its template
    arguments in the mangled name (the library's spills are shared)."""
    fmt_in, fmt_out = K4_LAYOUTS[layout]
    return next((v for k, v in summary["entries"].items()
                 if f"fp12_mul_kernelILi{fmt_in}ELi{fmt_out}E" in k), None)


def phase_k4_words(torch, a, b, f_real, g_real, imad, ptxas_k4: dict) -> dict:
    """K4's word and strict-limb layouts (the multi-pairings' fold: words
    -> words, words -> strict limbs at its last level, and the strict
    engine's limbs -> limbs) at N = 8192 on the canonical words (or their
    strict limbs) of K4's random operands and of real Miller values, word
    for word and limb for limb against their plain versions, each timed
    beside its plain version, its bound and the digit layout; then at each
    width of the fold (`K4_FOLD_WIDTHS`), held against the plain version
    and timed beside the digit layout at the same width; with registers and
    launch shape."""
    from ark_blst_tpu_torch.ops import fp12_mul as K4
    from ark_blst_tpu_torch.ops import words as W

    n = a.shape[-1]
    aw, bw = W.digits_to_words_plain(a), W.digits_to_words_plain(b)
    fw, gw = W.digits_to_words_plain(f_real), W.digits_to_words_plain(g_real)
    words, limbs = (aw, bw, fw, gw), tuple(W.words_to_limbs_plain(x) for x in (aw, bw, fw, gw))
    out = {}
    # layout: its kernel, operands, out=, bytes of an input and an output Fp
    # element, and its loads' instructions an element (a repack of strict
    # limbs reduced below p)
    for layout, kernel, (xa, xb, xf, xg), store, in_bytes, out_bytes, load_ops in (
            ("words", K4.KERNEL_WORDS, words, "words", WORD_BYTES, WORD_BYTES, 0),
            ("limbs", K4.KERNEL_LIMBS, words, "limbs", WORD_BYTES, LIMB_BYTES, 0),
            ("limbs_limbs", K4.KERNEL_LIMBS_LIMBS, limbs, "limbs", LIMB_BYTES, LIMB_BYTES,
             24 * LIMBS_TO_WORDS_OPS)):
        name = "K4 " + layout
        err = max(_held(torch, name, K4.fp12_mul(x, y, out=store),
                        K4.fp12_mul_plain(x, y, store)) for x, y in ((xa, xb), (xf, xg)))
        nbytes = n * (24 * in_bytes + 12 * out_bytes)
        res = {"max_abs_err": err, **_timed(
            torch, lambda: K4.fp12_mul(xa, xb, out=store),
            lambda: K4.fp12_mul_plain(xa, xb, store), nbytes, n * (FP12_MUL32_OPS + load_ops),
            None if imad is None else n * 54 * imad)}
        # the layout and the digits in turns (layout, digits, digits, layout),
        # K4_REPS launches each: `ms` and `digits_ms` are their means
        runs = {"ms": [], "digits_ms": []}
        for turn in ("ms", "digits_ms", "digits_ms", "ms"):
            fn = (lambda: K4.fp12_mul(xa, xb, out=store)) if turn == "ms" else \
                (lambda: K4.fp12_mul(a, b))
            runs[turn].append(cuda_ms(torch, fn, K4_REPS))
        res.update({k: sum(v) / len(v) for k, v in runs.items()}, runs=runs)
        widths = {}
        for w in K4_FOLD_WIDTHS:
            x, y = xa[..., :w].contiguous(), xb[..., :w].contiguous()
            xd, yd = a[..., :w].contiguous(), b[..., :w].contiguous()
            _held(torch, f"{name} at {w}", K4.fp12_mul(x, y, out=store),
                  K4.fp12_mul_plain(x, y, store))
            widths[w] = {
                "ms": cuda_ms(torch, lambda: K4.fp12_mul(x, y, out=store), 5),
                "digits_ms": cuda_ms(torch, lambda: K4.fp12_mul(xd, yd), 5),
                "bound_ms": bound_ms(w * (24 * in_bytes + 12 * out_bytes),
                                     w * (FP12_MUL32_OPS + load_ops))[0]}
        res.update(at_widths=widths, ptxas=_k4_ptxas(ptxas_k4, layout),
                   launch=_tower32_shape(torch, kernel, n, K4_LAYOUTS[layout]))
        out[layout] = res
    return out


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
    coeffs = PR.prepare_g2(q, fuse=False, events=4)  # digits, as the unfused prepare's
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
    return {"max_abs_err": err, **forms["with_square"], "line_only": forms["line_only"]}


def chain_inputs(torch, dev, n: int) -> tuple:
    """The fused chains' operands as the entry points hold them, for the
    first n pairs of `pairing_inputs` (identities included): Q = (qx, qy)
    and P = (px, py) as strict (24, n) limbs; and the affine pairs."""
    from ark_blst_tpu_torch import bls12 as B

    ps, qs, _, _ = pairing_inputs()
    (p, _), (q, _) = B._g1_batch(ps[:n], dev), B._g2_batch(qs[:n], dev)
    return q, p, ps[:n], qs[:n]


def digit_chain_inputs(torch, q, p) -> tuple:
    """The digit entries' operands for the same pairs (the edges before the
    chains took strict limbs): Q (4, 30, n) and P (2, 30, n) ingested, f =
    one (12, 30, n)."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import tower_lazy as TL

    qx, qy = TL.fp2_ingest(q[0]), TL.fp2_ingest(q[1])
    pxy = torch.stack([TL.fp_ingest(p[0]), TL.fp_ingest(p[1])])
    return (torch.stack([qx[0], qx[1], qy[0], qy[1]]), pxy,
            TL.stack12(PR._fp12_one_like(pxy[0])))


def chain_work(schedule, digit_edges: bool = False) -> dict:
    """(bytes, int32 instructions) an element of the two chains over a
    schedule, the work the function needs: K5-chain each event's products
    and sums, Q in once, each event's 6 line components out; K6-chain each
    event's products and sums, P in once, each event's 6 line components
    in, f out once. The fused pipeline's edges: Q and P strict limbs
    (packed, reduced), the lines words (no conversion), f out as the fused
    pairing's conj(f) in words (6 negations; "miller_f_digits": f as
    digits, converted, as the public `miller_loop` takes it); the strict
    engine's edges ("prepare_limbs", "miller_limbs"): Q and P as above, the
    lines and conj(f) as canonical strict limbs, a repack each way counted
    in the bytes alone; with digit_edges the digit entries' edges: R and Q
    (K5) or f and P (K6) in, the lines both ways and f out as digits,
    converted."""
    e = len(schedule)
    prepare = sum(PREPARE32_OPS[not d] for d in schedule)
    miller = sum(MILLER32_OPS[d] for d in schedule)
    f_digits = 12 * WORDS_TO_DIGITS_OPS
    if digit_edges:
        return {
            "prepare": ((PREPARE_INPUTS[True] + 6 * e) * ELEM_BYTES,
                        prepare + PREPARE_INPUTS[True] * DIGITS_TO_WORDS_OPS
                        + 6 * e * WORDS_TO_DIGITS_OPS),
            "miller": ((14 + 6 * e + 12) * ELEM_BYTES,
                       miller + f_digits + (14 + 6 * e) * DIGITS_TO_WORDS_OPS)}
    p_lines = 2 * LIMB_BYTES + 6 * e * WORD_BYTES
    miller += 2 * LIMBS_TO_WORDS_OPS
    return {"prepare": (4 * LIMB_BYTES + 6 * e * WORD_BYTES, prepare + 4 * LIMBS_TO_WORDS_OPS),
            "miller": (p_lines + 12 * WORD_BYTES, miller + 6 * NEG32_OPS),
            "miller_f_digits": (p_lines + 12 * ELEM_BYTES, miller + f_digits),
            "prepare_limbs": (4 * LIMB_BYTES + 6 * e * LIMB_BYTES,
                              prepare + 4 * LIMBS_TO_WORDS_OPS),
            "miller_limbs": (2 * LIMB_BYTES + 6 * e * LIMB_BYTES + 12 * LIMB_BYTES,
                             miller + 6 * NEG32_OPS)}


def _word_values(words) -> list:
    """(rows, 12, m) canonical words on the host -> each row's values (the
    words' number times 2^-384 mod p)."""
    from ark_blst_tpu_torch.oracle.field import P

    inv = pow(1 << 384, -1, P)
    u = words.numpy().astype("uint32").astype(object)
    return [[sum(int(u[r, k, j]) << (32 * k) for k in range(12)) * inv % P
             for j in range(u.shape[2])] for r in range(u.shape[0])]


def _chain_oracle(torch, lines, f, f_words, ps, qs) -> int:
    """The word lines, f (digits) and conj(f) (words) of the first
    CHAIN_ORACLE_COLS pairs (identities skipped) against the oracle's
    prepare_g2 (by value) and miller_loop (f conjugated back, as the
    pipeline does; the words' value as they are: the conjugation applied
    once, in K6-chain's store). Returns the columns held."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.oracle import pairing as OP

    cols = [i for i in range(CHAIN_ORACLE_COLS) if ps[i] is not None and qs[i] is not None]
    got = _word_values(lines[..., cols].reshape(-1, 12, len(cols)).cpu())
    for j, i in enumerate(cols):
        want = OP.prepare_g2(qs[i])
        for e, line in enumerate(want):
            vals = [got[6 * e + r][j] for r in range(6)]
            check(vals == [v for fp2 in line for v in fp2],
                  f"K5-chain: pair {i}, event {e} differs from the oracle's prepare_g2")
    want = [OP.miller_loop(ps[i], qs[i]) for i in cols]
    fs = CV.fp12_from_dev(PR.egress(PR._conj(f[..., cols].contiguous())))
    check(fs == want, "K6-chain differs from the oracle's miller_loop")
    got = _word_values(f_words[..., cols].cpu())
    check(got == [[w[r // 6][r // 2 % 3][r % 2] for w in want] for r in range(12)],
          "K6-chain's conj(f) words differ from the oracle's miller_loop")
    return len(cols)


def _clocks() -> str:
    """The card's SM clock and its maximum, temperature and power draw now,
    as nvidia-smi gives them (beside the chains' times)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def _prepare_by_event(PS, q, schedule) -> None:
    """The prepare as one launch an event (the chain of one), as the fused
    path ran it before the chain."""
    rs = PS._r_start(q)
    for is_dbl in schedule:
        rs = PS.prepare_step(rs, None if is_dbl else q)[:6]


def _miller_by_event(PS, f, coeffs, pxy, schedule) -> None:
    """The Miller loop as one launch an event (the chain of one)."""
    for i, is_dbl in enumerate(schedule):
        f = PS.miller_step(f, coeffs[i], pxy, is_dbl)


def phase_tower_chains(torch, dev, ptxas: dict) -> tuple:
    """K5-chain and K6-chain (the prepare and the Miller loop, all 68 events
    in one launch each) through the fused pipeline's entries
    (`prepare_lines`, `miller_lines`: Q and P strict limbs in, R = (Q, 1)
    and f = one formed in the kernels, the lines words between) on the
    pipeline's pairs at N = 8192 and at the ragged CHAIN_RAGGED_N: the
    lines word for word against their plain version; K6-chain in the fused
    pairing's layout (conj(f) stored as words) word for word, and storing
    f as digits (the public `miller_loop`'s; also on the lines as digits, an
    unfused prepare's) by canonical value, its digits within 4096; at 8192
    also against the oracle on a sample; each timed beside its plain
    version and its bound, with its launch shape (K6's f as digits beside:
    `f_digits_ms`, `bound_f_digits_ms`); beside, the same kernels on the
    digit entries' edges (`prepare_chain`, `miller_chain`: digits in and
    between, the edges before these layouts) with their bound
    (`digit_edges_ms`, `bound_digit_edges_ms`) and, at 8192, the same
    events launched one by one (`by_event_ms`). The card's clocks before
    and after the timings (`clocks`)."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import words as W

    t_phase = time.perf_counter()
    sched = PR.MILLER_EVENTS
    work, work_digits = chain_work(sched), chain_work(sched, digit_edges=True)
    out, strict = {"prepare": {}, "miller": {}}, {"prepare": {}, "miller": {}}
    oracle_cols = 0
    clocks = {"before": _clocks()}
    for n in (PAIRING_N, CHAIN_RAGGED_N):
        q, p, ps, qs = chain_inputs(torch, dev, n)
        lines = PS.prepare_lines(q, sched)
        plain_ms, want = _once_ms(torch, lambda: PS.prepare_lines_plain(q, sched))
        check(lines.shape == (len(sched), 6, W.WORDS, n) and torch.equal(lines, want),
              "K5-chain's word lines differ from prepare_lines_plain's")
        fw = PS.miller_lines(lines, p, sched, PS.FMT_WORDS)
        plain6_ms, want6w = _once_ms(
            torch, lambda: PS.miller_lines_plain(lines, p, sched, PS.FMT_WORDS))
        check(fw.shape == (12, W.WORDS, n) and torch.equal(fw, want6w),
              "K6-chain's conj(f) words differ from miller_lines_plain's")
        f = PS.miller_lines(lines, p, sched)
        plain6d_ms, want6 = _once_ms(torch, lambda: PS.miller_lines_plain(lines, p, sched))
        err6 = _held_values(torch, "K6-chain, f as digits", f, want6)
        err6 = max(err6, _held_values(torch, "K6-chain on digit lines",
                                      PS.miller_lines(W.words_to_digits_plain(lines), p, sched),
                                      want6))
        if n == PAIRING_N:
            oracle_cols = _chain_oracle(torch, lines, f, fw, ps, qs)
        q_dig, pxy_dig, f1 = digit_chain_inputs(torch, q, p)
        coeffs_dig = PS.prepare_chain(q_dig, sched)
        for name, kernel, err, fn, p_ms, digit_fn, by_event in (
                ("prepare", PS.PREPARE_KERNEL, 0, lambda: PS.prepare_lines(q, sched), plain_ms,
                 lambda: PS.prepare_chain(q_dig, sched),
                 lambda: _prepare_by_event(PS, q_dig, sched)),
                ("miller", PS.MILLER_KERNEL, 0,
                 lambda: PS.miller_lines(lines, p, sched, PS.FMT_WORDS),
                 plain6_ms, lambda: PS.miller_chain(f1, coeffs_dig, pxy_dig, sched),
                 lambda: _miller_by_event(PS, f1, coeffs_dig, pxy_dig, sched))):
            nbytes, ops = work[name]
            bms, by = bound_ms(n * nbytes, n * ops)
            dbms, dby = bound_ms(n * work_digits[name][0], n * work_digits[name][1])
            out[name][n] = {"n": n, "max_abs_err": err, "ms": cuda_ms(torch, fn, 3),
                            "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                            "digit_edges_ms": cuda_ms(torch, digit_fn, 3),
                            "bound_digit_edges_ms": dbms, "bound_digit_edges_by": dby,
                            "launch": _tower32_shape(torch, kernel, n)}
            if n == PAIRING_N:
                out[name][n]["by_event_ms"] = cuda_ms(torch, by_event, 3)
        fbms, fby = bound_ms(n * work["miller_f_digits"][0], n * work["miller_f_digits"][1])
        out["miller"][n].update(
            f_digits_ms=cuda_ms(torch, lambda: PS.miller_lines(lines, p, sched), 3),
            f_digits_plain_ms=plain6d_ms, f_digits_max_abs_err=err6, bound_f_digits_ms=fbms,
            bound_f_digits_by=fby)
        out["prepare"][n]["lines_bytes"] = lines.numel() * 4
        out["prepare"][n]["lines_bytes_as_digits"] = coeffs_dig.numel() * 4
        strict_chains(torch, strict, n, q, p, lines, fw)
        del q, p, lines, want, fw, want6w, f, want6, q_dig, pxy_dig, f1, coeffs_dig
    q, p, _, _ = chain_inputs(torch, dev, 1)  # the strict chains at one pair too
    lines = PS.prepare_lines(q, sched)
    strict_chains(torch, strict, 1, q, p, lines, PS.miller_lines(lines, p, sched, PS.FMT_WORDS))
    clocks["after"] = _clocks()
    torch.cuda.empty_cache()
    emit({"phase": "tower_chains", "events": len(sched), "value_equal": True,
          "real_inputs": True, "oracle_columns": oracle_cols, "clocks": clocks,
          "prepare": list(out["prepare"].values()), "miller": list(out["miller"].values()),
          "ops_per_element": {k: v[1] for k, v in work.items()},
          "bytes_per_element": {k: v[0] for k, v in work.items()},
          "ops_per_element_digit_edges": {k: v[1] for k, v in work_digits.items()},
          "bytes_per_element_digit_edges": {k: v[0] for k, v in work_digits.items()},
          "ptxas": {"prepare": ptxas["prepare_step.cu"], "miller": ptxas["miller_step.cu"]},
          "strict": {k: list(v.values()) for k, v in strict.items()},
          "seconds": time.perf_counter() - t_phase})
    for name, source, fragment in (("prepare", "prepare_step.cu", "prepare_chain_kernelILi1ELi1E"),
                                   ("miller", "miller_step.cu",
                                    "miller_chain_kernelILi1ELi1ELi1E")):
        strict[name][PAIRING_N]["ptxas"] = _ptxas_of(ptxas[source], fragment)
    return (*({**v[PAIRING_N], "at_ragged": v[CHAIN_RAGGED_N]} for v in out.values()),
            *({**v[PAIRING_N], "at_widths": [v[CHAIN_RAGGED_N], v[1]]} for v in strict.values()))


def strict_chains(torch, res: dict, n: int, q, p, lines, fw) -> None:
    """K5-chain and K6-chain on the strict engine's edges at n pairs (strict
    Q and P in, the lines and conj(f) as strict limbs: the strict
    `prepare_g2` and `miller_loop`, `fuse=True`): limb for limb against
    their plain versions and against the word instantiations' lines and
    conj(f) split into limbs (at 8192, 1,000 and 1); each timed beside the
    word instantiation in
    the same run (`words_ms`: the fused pipeline's, timed right after),
    with its bound (`chain_work`'s "prepare_limbs", "miller_limbs") and
    launch shape; into res[name][n]."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import words as W

    sched, work = PR.MILLER_EVENTS, chain_work(PR.MILLER_EVENTS)
    limbs = PS.prepare_lines(q, sched, PS.FMT_LIMBS)
    plain5_ms, want5 = _once_ms(torch, lambda: PS.prepare_lines_plain(q, sched, PS.FMT_LIMBS))
    check(limbs.shape == (len(sched), 6, W.LIMBS, n) and torch.equal(limbs, want5)
          and torch.equal(limbs, W.words_to_limbs_plain(lines)),
          "K5-chain's strict lines differ from their plain version's")
    f = PS.miller_lines(limbs, p, sched, PS.FMT_LIMBS)
    plain6_ms, want6 = _once_ms(
        torch, lambda: PS.miller_lines_plain(limbs, p, sched, PS.FMT_LIMBS))
    check(f.shape == (12, W.LIMBS, n) and torch.equal(f, want6)
          and torch.equal(f, W.words_to_limbs_plain(fw)),
          "K6-chain's strict conj(f) differs from its plain version's")
    for name, kernel, fn, words_fn, plain_ms in (
            ("prepare", PS.PREPARE_KERNEL_LIMBS, lambda: PS.prepare_lines(q, sched, PS.FMT_LIMBS),
             lambda: PS.prepare_lines(q, sched), plain5_ms),
            ("miller", PS.MILLER_KERNEL_LIMBS,
             lambda: PS.miller_lines(limbs, p, sched, PS.FMT_LIMBS),
             lambda: PS.miller_lines(lines, p, sched, PS.FMT_WORDS), plain6_ms)):
        nbytes, ops = work[name + "_limbs"]
        bms, by = bound_ms(n * nbytes, n * ops)
        res[name][n] = {"n": n, "max_abs_err": 0, "ms": cuda_ms(torch, fn, 3),
                        "words_ms": cuda_ms(torch, words_fn, 3), "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by,
                        "launch": _tower32_shape(torch, kernel, n)}
    res["prepare"][n]["lines_bytes"] = limbs.numel() * 4


def phase_final_exp_chains(torch, dev, ptxas: dict) -> tuple:
    """FE-easy and FE-hard (the fused final exponentiation, one launch each)
    on real Miller outputs (the first n pairs of phase 8 through the fused
    pairing's route: the fused prepare, K6-chain storing conj(f) as words,
    the identity pairs masked to one on words) at FINAL_EXP_WIDTHS, in the
    fused pairing's layouts and in the others their callers use: FE-easy
    on those words and on their digits, word for word against `easy_plain`
    (the words canonical); FE-hard storing strict limbs limb for limb
    against `hard_limbs_plain`, also on `easy_plain`'s words, and storing
    digits (within 4096) by value; at CHAIN_RAGGED_N - 1 elements (FE-hard
    eight elements a block, its last block holding seven; FE-easy's last
    block seven of 32) both equal to the first columns at CHAIN_RAGGED_N;
    at 8192 the first CHAIN_ORACLE_COLS
    results (an identity among them) against the oracle's pairings; each
    timed beside its plain version (on the card the lazy tower's products
    run on K1, its inverse on K1-inv) and its bound, with its launch shape
    (the other layout beside: `digits_ms`, `bound_digits_ms`); FE-easy on
    the strict engine's fused route (`easy_limbs`: K5-chain and K6-chain on
    strict limbs, the mask on the limbs, FE-easy loading them) word for word
    against the same, timed beside FE-easy on words (`words_ms`) in the
    same run."""
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import final_exp as FE
    from ark_blst_tpu_torch.ops import tower_lazy as TL
    from ark_blst_tpu_torch.ops import words as W
    from ark_blst_tpu_torch.oracle import pairing as OP

    t_phase = time.perf_counter()
    work = final_exp_work()
    ps, qs, _, _ = pairing_inputs()
    out = {"easy": {}, "hard": {}, "easy_limbs": {}}
    oracle_cols = 0
    for n in FINAL_EXP_WIDTHS:
        (p, p_inf), (q, q_inf) = B._g1_batch(ps[:n], dev), B._g2_batch(qs[:n], dev)
        skip = PR._skip_mask(p_inf, q_inf)
        f = PR._masked_miller_stack(p, PR.prepare_g2(q), skip)
        # the strict engine's fused route: conj(f) as strict limbs, masked
        f_limbs = PR._masked_miller_stack(p, PR.prepare_g2(q, engine="strict"), skip,
                                          f_fmt=W.FMT_LIMBS)
        check(torch.equal(f_limbs, W.words_to_limbs_plain(f)),
              "the strict route's conj(f) limbs differ from the word route's words")
        f_digits = W.words_to_digits_plain(f)
        words = FE.easy(f)
        easy_plain_ms, t2 = _once_ms(torch, lambda: FE.easy_plain(W.words_to_digits_plain(f)))
        t2_words = W.digits_to_words_plain(t2)
        check(torch.equal(words, t2_words), "FE-easy on words differs from easy_plain")
        check(torch.equal(FE.easy(f_digits), t2_words), "FE-easy on digits differs from easy_plain")
        check(torch.equal(FE.easy(f_limbs), t2_words),
              "FE-easy on strict limbs differs from easy_plain")
        easy_limbs_plain_ms, t2_limbs = _once_ms(
            torch, lambda: FE.easy_plain(W.limbs_to_digits_plain(f_limbs)))
        check(torch.equal(W.digits_to_words_plain(t2_limbs), t2_words),
              "easy_plain on strict limbs differs from easy_plain on words")
        got = FE.hard(words, out="limbs")
        hard_plain_ms, want = _once_ms(torch, lambda: FE.hard_limbs_plain(t2))
        check(got.shape == (12, 24, n) and torch.equal(got, want),
              "FE-hard's strict limbs differ from hard_limbs_plain")
        check(torch.equal(FE.hard(t2_words, out="limbs"), want),
              "FE-hard on easy_plain's words differs from hard_limbs_plain")
        if n == CHAIN_RAGGED_N:  # a partly filled last block of each kernel at n - 1
            check(torch.equal(FE.easy(f[..., :n - 1].contiguous()), words[..., :n - 1])
                  and torch.equal(FE.hard(words[..., :n - 1].contiguous(), out="limbs"),
                                  got[..., :n - 1]),
                  f"FE-easy or FE-hard at {n - 1} elements differs from their first columns at {n}")
        got_digits = FE.hard(words)
        err_digits = int(got_digits.abs().max())
        check(err_digits <= 4096 and torch.equal(
            torch.stack(TL._flat12(TL.fp12_egress(TL.unstack12(got_digits)))), want),
            "FE-hard's digits differ from hard_limbs_plain by value")
        if n == PAIRING_N:
            cols = CHAIN_ORACLE_COLS
            vals = CV.fp12_from_dev(TL.unstack12(got[..., :cols]))
            check(vals == [OP.pairing(ps[i], qs[i]) for i in range(cols)],
                  "FE-easy and FE-hard differ from the oracle's pairings")
            oracle_cols = cols
        for name, kernel, fn, digits_fn, plain_ms in (
                ("easy", FE.KERNEL_EASY, lambda: FE.easy(f), lambda: FE.easy(f_digits),
                 easy_plain_ms),
                ("hard", FE.KERNEL_HARD, lambda: FE.hard(words, out="limbs"),
                 lambda: FE.hard(words), hard_plain_ms)):
            bms, by = bound_ms(n * work[name][0], n * work[name][1])
            dbms, dby = bound_ms(n * work[name + "_digits"][0], n * work[name + "_digits"][1])
            out[name][n] = {"n": n, "max_abs_err": 0, "ms": cuda_ms(torch, fn, 3),
                            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                            "digits_ms": cuda_ms(torch, digits_fn, 3), "bound_digits_ms": dbms,
                            "bound_digits_by": dby,
                            "launch": _tower32_shape(torch, kernel, n,
                                                     (n,) if name == "hard" else ())}
        out["hard"][n]["digits_max_abs_err"] = err_digits
        bms, by = bound_ms(n * work["easy_limbs"][0], n * work["easy_limbs"][1])
        out["easy_limbs"][n] = {"n": n, "max_abs_err": 0,
                                "ms": cuda_ms(torch, lambda: FE.easy(f_limbs), 3),
                                "words_ms": cuda_ms(torch, lambda: FE.easy(f), 3),
                                "plain_ms": easy_limbs_plain_ms, "bound_ms": bms, "bound_by": by,
                                "launch": _tower32_shape(torch, FE.KERNEL_EASY_LIMBS, n)}
        del p, q, f, f_digits, f_limbs, words, t2, t2_words, t2_limbs, got, want, got_digits
    torch.cuda.empty_cache()
    out["easy_limbs"][PAIRING_N]["ptxas"] = _ptxas_of(ptxas["final_exp.cu"], "easy_kernelILi1E")
    emit({"phase": "final_exp_chains", "value_equal": True, "real_inputs": True,
          "oracle_columns": oracle_cols, "easy": list(out["easy"].values()),
          "hard": list(out["hard"].values()), "easy_limbs": list(out["easy_limbs"].values()),
          "ops_per_element": {k: v[1] for k, v in work.items()},
          "bytes_per_element": {k: v[0] for k, v in work.items()},
          "ptxas": ptxas["final_exp.cu"], "seconds": time.perf_counter() - t_phase})
    return tuple({**v[PAIRING_N], "at_widths": [v[n] for n in FINAL_EXP_WIDTHS[1:]]}
                 for v in out.values())


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
    final_exp, egress (strict limbs back to host ints). Fused, the entry's
    route that keeps f a stack: miller_loop K6-chain storing conj(f) as
    words (lazy) or strict limbs (strict) and the mask on that stack,
    final_exp FE-easy on it and FE-hard storing the strict limbs, egress
    the host codecs alone (`egress_dispatched`: the ops it ran on the card,
    as dispatched; none)."""
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.curves import pairing_steps as PS
    from ark_blst_tpu_torch.ops import convert as CV

    ((p, p_inf), (q, q_inf)), summary = _stage(
        torch, lambda: (B._g1_batch(ps, dev), B._g2_batch(qs, dev)), profiled, need_device=False)
    yield "ingest", summary
    chains = fuse  # the fused stages: a chain each, checked
    f_fmt = PS.FMT_WORDS if engine == "lazy" else PS.FMT_LIMBS
    coeffs, summary = _stage(torch, lambda: PR.prepare_g2(q, fuse, engine), profiled,
                             expect=("prepare_chain_kernel",) if chains else (),
                             attempts=4 if chains else 2)
    yield "prepare_g2", summary
    if chains:
        miller = lambda: PR._masked_miller_stack(  # noqa: E731
            p, coeffs, PR._skip_mask(p_inf, q_inf), f_fmt=f_fmt)
    else:
        miller = lambda: PR._masked_miller(p, coeffs, p_inf, q_inf, fuse, engine)  # noqa: E731
    f, summary = _stage(torch, miller, profiled, expect=("miller_chain_kernel",) if chains else (),
                        attempts=4 if chains else 2)
    yield "miller_loop", summary
    final = PR._final_strict if chains else PR.final_exp
    f, summary = _stage(torch, lambda: final(f, fuse, engine), profiled,
                        expect=("easy_kernel", "hard_kernel") if chains else (),
                        attempts=4 if chains else 2)
    yield "final_exp", summary
    egress = (lambda: CV.fp12_from_dev(f)) if chains else \
        (lambda: CV.fp12_from_dev(PR.egress(f, engine)))
    out, summary = _stage(torch, egress, profiled, need_device=engine == "lazy" and not chains)
    if chains:
        summary["egress_dispatched"] = _dispatched_launches(torch, egress)
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


# The K1-family launches of a pairing batch, fused and unfused: the
# products outside the tower kernels, and one K1-inv ladder (the final
# exponentiation's fp12 inverse); none fused, where FE-easy and FE-hard
# hold the inverse and the Frobenius maps
PAIRING_K1 = {True: {"mont_mul": 0, "fp_inv": 0}, False: {"mont_mul": 658, "fp_inv": 1}}
# the fused pairing's kernels, each launched once a batch, and the lazy
# tower's that it no longer launches (K1, K1-inv, K3, K4; K4's word layouts
# run the multi-pairings' product fold)
PAIRING_FUSED = ("prepare_step", "miller_step", "final_exp_easy", "final_exp_hard")
PAIRING_NAMES = ("mont_mul", "fp_inv", "cyc_sqr", "fp12_mul", "fp12_mul_words",
                 "fp12_mul_limbs") + PAIRING_FUSED


def _check_pairing_k1(launches: dict, fuse: bool, what: str) -> None:
    got = {k: launches[k] for k in PAIRING_K1[fuse]}
    check(got == PAIRING_K1[fuse], f"{what} K1-family launches {got}, "
                                   f"expected {PAIRING_K1[fuse]}")


def _check_final_exp(launches: dict, want: tuple, what: str) -> None:
    """FE-easy's and FE-hard's launches of a path: one each where it runs
    the fused final exponentiation, none unfused or for a Miller loop
    alone."""
    got = (launches["final_exp_easy"], launches["final_exp_hard"])
    check(got == want, f"{what} launched FE-easy and FE-hard {got} times, expected {want}")


def _check_fused_batch(launches: dict, what: str, prepared: bool = False) -> None:
    """A fused pairing batch: K5 (unless prepared), K6, FE-easy and FE-hard
    once each, and no K1, K1-inv, K3 or K4."""
    _check_chains(launches, (0 if prepared else 1, 1), what)
    _check_final_exp(launches, (1, 1), what)
    _check_pairing_k1(launches, True, what)
    check(all(launches[k] == 0 for k in ("cyc_sqr", "fp12_mul", "fp12_mul_words",
                                         "fp12_mul_limbs")),
          f"{what} launched K3 or K4: {launches}")


def _check_chains(launches: dict, want: tuple, what: str) -> None:
    """K5's and K6's launches of a path: one chain each for a fused batch,
    (0, 1) for a prepared one, (1, 0) for a prepare alone."""
    got = (launches["prepare_step"], launches["miller_step"])
    check(got == want, f"{what} launched K5 and K6 {got} times, expected {want}")


# The fused stages' launches on the card (the profiler's device events, the
# chains' own among them) at most: the prepare a stack of Q and K5; the
# Miller loop the stack of P, K6 (conj(f) stored as words), the mask's or
# and its select; the final exponentiation FE-easy and FE-hard; the egress
# none (host codecs on FE-hard's limbs, copied to the host)
STAGE_MAX_LAUNCHES = {"prepare_g2": 10, "miller_loop": 6, "final_exp": 4, "egress": 0}
STAGE_CHAINS = {"prepare_g2": {"prepare_step": 1}, "miller_loop": {"miller_step": 1},
                "final_exp": {"final_exp_easy": 1, "final_exp_hard": 1}, "egress": {}}
PAIRING_MAX_DEVICE_KERNELS = 12  # prepare_g2 to egress, a fused batch


def _check_stage_launches(staged: dict, profiled: dict, chains: dict = STAGE_CHAINS) -> int:
    """The fused stages from prepare_g2 to egress: each launches its chains
    (`chains`, by stage: the lazy engine's or the strict engine's
    instantiations) once and no other kernel of the port (the counters), at most
    STAGE_MAX_LAUNCHES device kernels (the profiler's events, copies left
    out), the egress none also as dispatched (a stage the profiler returned
    no event for is not taken for one that launched none), and at most
    PAIRING_MAX_DEVICE_KERNELS in all. Returns that sum."""
    total = 0
    for stage, most in STAGE_MAX_LAUNCHES.items():
        want = chains[stage]
        check(staged[stage]["launches"] == want,
              f"{stage} launched {staged[stage]['launches']}, expected {want}")
        got = profiled[stage]["device_kernels"]
        check(got <= most, f"{stage} launched {got} device kernels, expected at most {most}")
        total += got
    for summary in (staged["egress"], profiled["egress"]):
        check(summary["egress_dispatched"] == 0,
              f"the egress ran {summary['egress_dispatched']} ops on the card")
    check(total <= PAIRING_MAX_DEVICE_KERNELS,
          f"a fused batch launched {total} device kernels from prepare_g2 to egress, expected "
          f"at most {PAIRING_MAX_DEVICE_KERNELS}")
    return total


class _EgressCalls:
    """Counts the calls of the lazy egress (`curves/pairing.py:egress` and
    the eager radix-13 to strict conversion it runs,
    `tower_lazy.fp12_egress`) while it is entered; the word routes of the
    fused pairing and of the multi-pairings call it never."""

    def __enter__(self):
        from ark_blst_tpu_torch.curves import pairing as PR
        from ark_blst_tpu_torch.ops import tower_lazy as TL

        self.calls = 0
        self._saved = [(PR, "egress", PR.egress), (TL, "fp12_egress", TL.fp12_egress)]

        def counting(fn):
            def counted(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return counted

        for mod, name, fn in self._saved:
            setattr(mod, name, counting(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def phase_pairing(torch, dev, ps, qs, expected) -> dict:
    from ark_blst_tpu_torch import bls12 as B

    names = PAIRING_NAMES
    kernels = all_kernels()
    n = len(ps)
    B.pairing_batch(ps, qs, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    with _EgressCalls() as egress:
        t0 = time.perf_counter()
        got = B.pairing_batch(ps, qs, device=dev)  # the main path
        dt = time.perf_counter() - t0
    check(egress.calls == 0, f"the fused pairing batch ran the lazy egress {egress.calls} times")
    launches = {name: kernels[name].launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    bad = sum(g != e for g, e in zip(got, expected))
    check(len(got) == n and bad == 0, f"{bad} of {n} pairings differ from the oracle")
    check(all(launches[k] > 0 for k in PAIRING_FUSED),
          f"a kernel of the path was not launched: {launches}")
    _check_fused_batch(launches, "pairing batch")

    staged = dict(run_pairing_stages(torch, dev, ps, qs, expected, False))
    stages = {name + "_ms": summary["wall_ms"] for name, summary in staged.items()}
    profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True))
    device_kernels = _check_stage_launches(staged, profiled)
    wall = sum(v["wall_ms"] for v in profiled.values())
    device = sum(v["device_ms"] for v in profiled.values())

    kernels = _reset_launches()
    t0 = time.perf_counter()
    prep = B.prepare_g2_batch(qs, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    _check_chains({k: kernels[k].launches for k in names}, (1, 0), "prepare_g2_batch")
    _check_final_exp({k: kernels[k].launches for k in names}, (0, 0), "prepare_g2_batch")
    B.pairing_batch(ps, prep, device=dev)  # warm-up
    kernels = _reset_launches()
    with _EgressCalls() as egress:
        t0 = time.perf_counter()
        got_prep = B.pairing_batch(ps, prep, device=dev)
        dt_prep = time.perf_counter() - t0
    check(egress.calls == 0, "the prepared pairing batch ran the lazy egress")
    prep_launches = {name: kernels[name].launches for name in names}
    check(got_prep == got, "prepared pairings differ from the unprepared ones")
    _check_fused_batch(prep_launches, "prepared pairing batch", prepared=True)
    # both entry points with their default device ("cuda", no index)
    got_default = B.pairing_batch(ps, B.prepare_g2_batch(qs))
    check(got_default == got, "default-device prepared pairings differ")

    emit({"phase": "pairing", "n": n, "distinct": PAIRING_DISTINCT, "ok": True,
          "identities_one": True, "seconds": dt, "pairings_per_s": n / dt,
          "launches": launches, "egress_calls": 0, "stages": stages,
          "stage_launches": {k: v["launches"] for k, v in staged.items()},
          "device_kernels": device_kernels,
          "stage_device_kernels": {k: v.get("device_kernels") for k, v in profiled.items()},
          "egress_dispatched": [staged["egress"]["egress_dispatched"],
                                profiled["egress"]["egress_dispatched"]],
          "prepared_lines_bytes": prep.stacked.numel() * 4, "prepared_layout": prep.layout,
          "peak_mem_gib": peak_gib,
          "prepared": {"ok": True, "prepare_s": prep_s, "seconds": dt_prep,
                       "pairings_per_s": n / dt_prep, "launches": prep_launches,
                       "default_device_ok": True}})
    emit({"phase": "pairing_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return {**launches, "prepared": prep_launches}, got


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

    names = PAIRING_NAMES + ("fp12_sqr", "fp12_mul_by_014")
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
    _check_final_exp(launches, (0, 0), "unfused pairing batch")
    check(launches["cyc_sqr"] == 317 and launches["fp12_mul"] == 37,
          f"K3/K4 launches per unfused batch: {launches}")
    check(launches["fp12_mul_words"] == 0 and launches["fp12_mul_limbs"] == 0,
          f"the unfused batch launched K4's word layouts: {launches}")
    check(all(launches[k] > 0 for k in ("mont_mul", "fp_inv", "cyc_sqr", "fp12_mul")),
          f"a kernel of the path was not launched: {launches}")
    _check_pairing_k1(launches, False, "unfused pairing batch")

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


# The strict engine's fused route (`pairing(..., engine="strict")`, fuse on):
# the chains' strict-limb instantiations and FE-hard, each launched once a
# batch, stage by stage; no other kernel of the port
STRICT_FUSED = ("prepare_chain_limbs", "miller_chain_limbs", "final_exp_easy_limbs",
                "final_exp_hard")
STRICT_STAGE_CHAINS = {"prepare_g2": {"prepare_chain_limbs": 1},
                       "miller_loop": {"miller_chain_limbs": 1},
                       "final_exp": {"final_exp_easy_limbs": 1, "final_exp_hard": 1},
                       "egress": {}}
STRICT_TURNS = (True, False, False, True)  # `fuse` of the timed strict calls, in turns
# the multi-pairings' routes of phase pairing_strict: (name, engine, fuse)
STRICT_MULTI_ROUTES = (("lazy", "lazy", True), ("strict_fused", "strict", True),
                       ("strict_unfused", "strict", False))


def _check_strict_route(launches: dict, fuse: bool, what: str) -> None:
    """The launches of a strict pairing batch: fused, the chains' strict
    instantiations and FE-hard once each and nothing else; unfused, K7-K10
    and one K7-inv ladder (the fp2 inverse of the final exponentiation) and
    nothing else."""
    from ark_blst_tpu_torch.ops import strict_field as SF

    got = {k: v for k, v in launches.items() if v}
    if fuse:
        want = {k: 1 for k in STRICT_FUSED}
        check(got == want, f"{what} launched {got}, expected {want}")
        return
    strict_names = {"strict_" + op for op in SF.KERNELS}
    check(set(got) == strict_names | {"fp_inv_limbs"} and got["fp_inv_limbs"] == 1,
          f"{what} launched {got}, expected K7-K10 and one K7-inv")


def phase_pairing_strict(torch, dev, ps, qs, expected) -> tuple:
    """The phase-8 instance through the tensor entry `pairing(...,
    engine="strict")` on both routes, timed in turns (STRICT_TURNS): fused
    (the default: K5-chain, K6-chain and FE-easy on strict limbs, FE-hard;
    no K7-K10 or K7-inv, checked) and unfused (`fuse=False`: K7-K10 and
    one K7-inv ladder, no chain, checked), each limb for limb against the
    lazy engine's output and against the oracle; each route's stages (the
    fused stages checked at most 10, 6, 4 and 0 device kernels, 12 in all,
    the egress none also as dispatched) and a profiled rerun; the unfused
    route's K7-K10 launches per stage, per Miller event (mean) and per
    cyclotomic square; then `multi_pairing` and `multi_miller_loop_prepared`
    at STRICT_MULTI_N pairs on the lazy engine and both strict routes
    (STRICT_MULTI_ROUTES), equal to each other and the first to the
    oracle's product, with their seconds and launches, each entry counted
    from 0: the strict fused route's fold on K4's strict limbs,
    ceil(log2 N) launches, and no K7-K10 launch (checked), its prepared
    Miller product against the oracle's."""
    import ark_blst_tpu_torch as T
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import strict_field as SF
    from ark_blst_tpu_torch.ops import tower as TS
    from ark_blst_tpu_torch.oracle import pairing as OP

    (p, p_inf), (q, q_inf) = B._g1_batch(ps, dev), B._g2_batch(qs, dev)
    lazy = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, device=dev)
    T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, engine="strict", device=dev)  # warm-up
    torch.cuda.synchronize()
    leaves = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    routes = {True: {"seconds": []}, False: {"seconds": []}}
    for fuse in STRICT_TURNS:
        first = "launches" not in routes[fuse]
        torch.cuda.reset_peak_memory_stats(dev)
        kernels = _reset_launches()
        t0 = time.perf_counter()
        out = T.pairing(p, q, p_inf=p_inf, q_inf=q_inf, fuse=fuse, engine="strict",
                        device=dev)  # the path
        torch.cuda.synchronize()
        routes[fuse]["seconds"].append(time.perf_counter() - t0)
        if not first:
            continue
        what = f"the strict pairing batch (fuse={fuse})"
        launches = {name: k.launches for name, k in kernels.items()}
        _check_strict_route(launches, fuse, what)
        check(all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(lazy))),
              f"{what}: limbs differ from the lazy engine's")
        check(CV.fp12_from_dev(out) == expected, f"{what} differs from the oracle")
        routes[fuse].update(launches={k: v for k, v in launches.items() if v},
                            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        if not fuse:
            unfused_out = out

    fused_staged = dict(run_pairing_stages(torch, dev, ps, qs, expected, False, engine="strict"))
    fused_profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True, engine="strict"))
    device_kernels = _check_stage_launches(fused_staged, fused_profiled, STRICT_STAGE_CHAINS)
    stages, stage_launches = _staged(torch, dev, ps, qs, expected, fuse=False, engine="strict")
    profiled = dict(run_pairing_stages(torch, dev, ps, qs, expected, True, fuse=False,
                                       engine="strict"))
    before = _launch_counts()
    TS.fp12_cyclotomic_sqr(unfused_out)
    per_cyc_sqr = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    per_event = {k: v / len(PR.MILLER_EVENTS) for k, v in stage_launches["miller_loop"].items()}

    m = STRICT_MULTI_N
    pm, qm = tuple(x[:, :m] for x in p), tuple(tuple(x[:, :m] for x in c) for c in q)
    pim, qim = p_inf[:m], q_inf[:m]
    want = _fp12_product(expected[:m])
    multi = {}
    levels = (m - 1).bit_length()
    for name, engine, fuse in STRICT_MULTI_ROUTES:
        kernels = _reset_launches()
        t0 = time.perf_counter()
        mp = PR.multi_pairing(pm, qm, pim, qim, fuse=fuse, engine=engine)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mp_launches = {k: v.launches for k, v in kernels.items() if v.launches}
        prep = PR.prepare_g2_device(qm, qim, fuse=fuse, engine=engine)
        torch.cuda.synchronize()
        kernels = _reset_launches()
        t2 = time.perf_counter()
        mml = PR.multi_miller_loop_prepared(pm, prep, pim, fuse=fuse)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        mml_launches = {k: v.launches for k, v in kernels.items() if v.launches}
        check(CV.fp12_from_dev(mp) == [want], f"{name} multi_pairing differs from the oracle")
        if name == "strict_fused":
            # the fold on K4's strict limbs, one launch a level, no K7-K10
            chains = {"fp12_mul_limbs_limbs": levels, "miller_chain_limbs": 1}
            check(mp_launches == {**chains, "prepare_chain_limbs": 1, "final_exp_easy_limbs": 1,
                                  "final_exp_hard": 1},
                  f"strict fused multi_pairing launched {mp_launches}")
            check(mml_launches == chains,
                  f"strict fused multi_miller_loop_prepared launched {mml_launches}")
            check(OP.final_exp(CV.fp12_from_dev(mml)[0]) == want,
                  "strict fused multi_miller_loop_prepared differs from the oracle")
        multi[name] = {"multi_pairing_s": t1 - t0, "prepare_s": t2 - t1,
                       "prepared_multi_miller_s": t3 - t2, "launches": mp_launches,
                       "launches_prepared": mml_launches, "values": (leaves(mp), leaves(mml))}
    for i, what in enumerate(("multi_pairing", "multi_miller_loop_prepared")):
        for name in ("strict_fused", "strict_unfused"):
            check(all(torch.equal(a, b) for a, b in
                      zip(multi["lazy"]["values"][i], multi[name]["values"][i])),
                  f"{what}: the lazy engine and the {name} route disagree")
    for v in multi.values():
        del v["values"]
    multi_launches = phase_multi_pairing(torch, p, q, p_inf, q_inf, expected,
                                         multi["lazy"]["multi_pairing_s"])

    n = len(ps)
    fused, unfused = routes[True], routes[False]
    emit({"phase": "pairing_strict", "n": n, "ok": True, "equal_to_lazy": True,
          "gpu": _smi()[0], "turns": ["fused" if f else "unfused" for f in STRICT_TURNS],
          "fused": {**fused, "pairings_per_s": n / min(fused["seconds"]),
                    "device_kernels": device_kernels,
                    "stages": {k + "_ms": v["wall_ms"] for k, v in fused_staged.items()},
                    "stage_launches": {k: v["launches"] for k, v in fused_staged.items()},
                    "stage_device_kernels": {k: v.get("device_kernels")
                                             for k, v in fused_profiled.items()},
                    "egress_dispatched": [fused_staged["egress"]["egress_dispatched"],
                                          fused_profiled["egress"]["egress_dispatched"]]},
          "unfused": {**unfused, "pairings_per_s": n / min(unfused["seconds"]),
                      "strict_launches": sum(unfused["launches"].values()), "stages": stages,
                      "stage_launches": stage_launches,
                      "launches_per_miller_event": per_event,
                      "launches_per_cyclotomic_sqr": per_cyc_sqr},
          "multi": {"n": m, "routes_agree": True, **multi}})
    emit({"phase": "pairing_strict_profile", "fused": {**_profile_totals(fused_profiled),
                                                       "stages": fused_profiled},
          "unfused": {**_profile_totals(profiled), "stages": profiled}})
    return unfused["launches"], fused["launches"], multi, multi_launches


# The multi-pairing entries of phase multi_pairing: (name, pairs, the
# entry's kind); the Miller product's kinds end in K4's store of strict
# limbs, `multi_pairing` in FE-easy and FE-hard
MULTI_ENTRIES = (("multi_pairing", STRICT_MULTI_N, "final"),
                 ("multi_miller_loop", STRICT_MULTI_N, "miller"),
                 ("multi_miller_loop_prepared", STRICT_MULTI_N, "prepared"),
                 ("multi_pairing_8192", PAIRING_N, "final"))
MULTI_TURNS = 3  # calls of each route, in turns (word, digit, digit, word, ...)


def _digit_miller_product(PR, final: bool, coeffs=None):
    """`multi_miller_loop` (or `multi_pairing`, with `final`) on the digit
    route the word route replaced: K6-chain storing f as digits, the digit
    mask, the fold on K4's digits, then the eager egress (or FE-easy on
    digits and FE-hard to limbs); on `coeffs` (a prepared stack's lines)
    when given, without the prepare."""
    def product(p, q, p_inf=None, q_inf=None):
        lines = PR.prepare_g2(q) if coeffs is None else coeffs
        f = PR._fold_mul(PR._masked_miller(p, lines, p_inf, q_inf), p[0].shape[-1])
        return PR._final_strict(f) if final else PR.egress(f)
    return product


def _multi_routes(PR, p, q, p_inf, q_inf, kind: str) -> tuple:
    """An entry's call on the word route (the entry itself), the same
    product on the digit route it replaced (`_digit_miller_product`), and
    the digit route's Miller product before its egress (for the egress
    alone)."""
    n = p[0].shape[-1]
    if kind == "prepared":
        prep = PR.prepare_g2_device(q, q_inf)
        word = lambda: PR.multi_miller_loop_prepared(p, prep, p_inf)  # noqa: E731
        lines, q_inf = prep.stacked, prep.q_inf
    else:
        word = {"final": lambda: PR.multi_pairing(p, q, p_inf, q_inf),
                "miller": lambda: PR.multi_miller_loop(p, q, p_inf, q_inf)}[kind]
        lines = PR.prepare_g2(q)
    digit = functools.partial(  # the prepared entry's on its stack, the others' with a prepare
        _digit_miller_product(PR, kind == "final", lines if kind == "prepared" else None),
        p, q, p_inf, q_inf)
    product = lambda: PR._fold_mul(PR._masked_miller(p, lines, p_inf, q_inf), n)  # noqa: E731
    return word, digit, product


def phase_multi_pairing(torch, p, q, p_inf, q_inf, expected, first_s: float) -> dict:
    """The multi-pairings on the word route (`MULTI_ENTRIES`: `multi_pairing`,
    `multi_miller_loop` and `multi_miller_loop_prepared` at 1,024 pairs,
    `multi_pairing` at 8192): each run once with the counts at 0 before it
    (K6-chain once, K4 ceil(log2 N) on words, the Miller product's last
    level K4's limbs store, no digit K4; the lazy egress never called,
    checked), its result against the digit route's limb for limb and
    against the oracle's product of the checked pairings (the Miller
    product through the oracle's final exponentiation); then both routes
    timed in turns, MULTI_TURNS calls each, under the profiler (device
    kernels, device time) and as dispatched, and the digit route's eager
    egress alone. Emits line `multi_pairing`; returns each entry's
    launches."""
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.oracle import pairing as OP

    out, launches = {}, {}
    leaves = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    for name, m, kind in MULTI_ENTRIES:
        pm, qm = tuple(x[:, :m] for x in p), tuple(tuple(x[:, :m] for x in c) for c in q)
        pim, qim = p_inf[:m], q_inf[:m]
        word, digit, product = _multi_routes(PR, pm, qm, pim, qim, kind)
        word()  # warm-up (and the prepare, for the prepared entry)
        torch.cuda.synchronize()
        kernels = _reset_launches()
        with _EgressCalls() as egress:
            got = word()  # the path
            torch.cuda.synchronize()
        counts = {k: v.launches for k, v in kernels.items() if v.launches}
        check(egress.calls == 0, f"{name} ran the lazy egress {egress.calls} times")
        levels = (m - 1).bit_length()
        final = kind == "final"
        want = {"miller_step": 1, "fp12_mul_words": levels - (0 if final else 1),
                "fp12_mul_limbs": 0 if final else 1,
                "final_exp_easy": int(final), "final_exp_hard": int(final),
                "prepare_step": 0 if kind == "prepared" else 1}
        check(counts == {k: v for k, v in want.items() if v},
              f"{name} launched {counts}, expected {want}")
        ref = digit()
        check(all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref))),
              f"{name} differs from the digit route")
        value = CV.fp12_from_dev(got)[0]
        check((value if final else OP.final_exp(value)) == _fp12_product(expected[:m]),
              f"{name} differs from the oracle's product")
        runs = {"words": [], "digits": []}
        for turn in range(MULTI_TURNS):
            for route in (("words", "digits") if turn % 2 == 0 else ("digits", "words")):
                fn = word if route == "words" else digit
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs[route].append(time.perf_counter() - t0)
        res = {"n": m, "seconds": runs["words"], "digit_route_seconds": runs["digits"],
               "launches": counts, "egress_calls": 0, "equal_to_digit_route": True,
               "equal_to_oracle": True}
        # the profiler has returned no event of K5 or K6 in some runs of a
        # call (the word route's, in this phase): a profile missing a chain
        # of the call is taken again, then timed by CUDA events and counted
        # as dispatched (`_stage`)
        chains = ("miller_chain_kernel", "fp12_mul_kernel") + (
            () if kind == "prepared" else ("prepare_chain_kernel",))
        for route, fn in (("words", word), ("digits", digit)):
            _, prof = _stage(torch, fn, True, expect=chains, attempts=4)
            key = "" if route == "words" else "digit_route_"
            res.update({key + "device_kernels": prof["device_kernels"],
                        key + "device_events": prof["kernel_launches"],
                        key + "device_ms": prof["device_ms"],
                        key + "device_ms_from": prof["device_ms_from"],
                        key + "dispatched": _dispatched_launches(torch, fn),
                        key + "top": prof["top"]})
        if not final:  # the digit route's eager egress alone, on its product
            f = product()
            egress_s = []
            for _ in range(MULTI_TURNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                PR.egress(f)
                torch.cuda.synchronize()
                egress_s.append(time.perf_counter() - t0)
            res.update(egress_alone_seconds=egress_s,
                       egress_dispatched=_dispatched_launches(torch, lambda: PR.egress(f)))
        out[name], launches[name] = res, counts
    emit({"phase": "multi_pairing", "gpu": _smi()[0], "seconds_first": first_s, **out})
    return launches


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
    names = ("mont_mul", "fp_inv", "scan_up", "scan_down",
             "bucket_accumulate" + ("_g2" if g2 else ""), curve_name + "_point_words")
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


def phase_api(torch, dev, ps, qs, expected, fused) -> dict:
    """The arkworks API's batch entries on the card: G1Projective.msm at
    2^18 and G2Projective.msm at 2^16 on the known-answer instances; the
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
    names = PAIRING_NAMES
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
    check(all(launches[k] > 0 for k in PAIRING_FUSED),
          f"a kernel of the API pairing was not launched: {launches}")
    _check_fused_batch(launches, "api pairing_batch")
    t0 = time.perf_counter()
    prep = T.Bls12.prepare_g2_batch(gq)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    kernels = _reset_launches()
    t0 = time.perf_counter()
    got_prep = T.Bls12.pairing_batch(gp, prep)
    dt_prep = time.perf_counter() - t0
    check(got_prep == got, "api prepared pairings differ from the unprepared ones")
    _check_fused_batch({k: kernels[k].launches for k in names}, "api prepared pairing_batch",
                       prepared=True)
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
    with _EgressCalls() as egress:
        t0 = time.perf_counter()
        mlo = T.Bls12.multi_miller_loop(gp[:m], gq[:m])  # backend None: the device route
        t1 = time.perf_counter()
    e = T.Bls12.final_exponentiation(mlo)
    t2 = time.perf_counter()
    launches = {k: kernels[k].launches for k in ("fp12_mul", "fp12_mul_words", "fp12_mul_limbs",
                                                  "prepare_step", "miller_step",
                                                  "final_exp_easy", "final_exp_hard")}
    check(egress.calls == 0, f"api multi_miller_loop ran the lazy egress {egress.calls} times")
    check(isinstance(mlo, T.MillerLoopOutput) and e.v == _fp12_product(expected[:m]),
          "api multi_miller_loop + final_exponentiation differs from the oracle's product")
    levels = (m - 1).bit_length()
    check((launches["fp12_mul"], launches["fp12_mul_words"], launches["fp12_mul_limbs"])
          == (0, levels - 1, 1), f"api multi_miller_loop's fold launched {launches}, expected "
                                 f"K4 {levels - 1} times on words and once to limbs")
    _check_chains(launches, (1, 1), "api multi_miller_loop")
    _check_final_exp(launches, (0, 0), "api multi_miller_loop (final exponentiation on the host)")
    first_s, host_fe_s = t1 - t0, t2 - t1
    # the same call in turns with the digit route the word route replaced
    # (`_digit_miller_product` in place of `curves/pairing.py:multi_miller_loop`)
    turns = {"words": [], "digits": []}
    for route in ("words", "digits", "digits", "words"):
        saved = PR.multi_miller_loop
        if route == "digits":
            PR.multi_miller_loop = _digit_miller_product(PR, final=False)
        try:
            t0 = time.perf_counter()
            again = T.Bls12.multi_miller_loop(gp[:m], gq[:m])
            turns[route].append(time.perf_counter() - t0)
        finally:
            PR.multi_miller_loop = saved
        check(again == mlo, f"api multi_miller_loop on the {route} route differs")
    emit({"phase": "api_miller", "n": m, "ok": True, "multi_miller_loop_s": first_s,
          "final_exponentiation_host_s": host_fe_s, "launches": launches, "egress_calls": 0,
          "seconds_in_turns": turns})
    miller_launches = launches
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
    return miller_launches


def phase_fp_inv_batch(torch, dev) -> dict:
    """`tower_lazy.fp_inv_batch` (the log-depth tree, its width-1 root on
    K1-inv) against `fp_inv` (the per-lane Fermat ladder, one K1-inv launch)
    at the pairing's batch: both checked against the oracle's inverses and
    timed, with their K1 and K1-inv launches. A reading only: nothing calls
    `fp_inv_batch`."""
    import random

    from ark_blst_tpu_torch.ops import convert as CV
    from ark_blst_tpu_torch.ops import fp_inv as FI
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
        MM.KERNEL.launches = FI.KERNEL_INV.launches = 0
        t0 = time.perf_counter()
        out = fn(a)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(CV.fp_from_dev(TL.fp_egress(out)) == want, f"{name} differs from the oracle")
        res[name] = {"ms": ms, "k1_launches": MM.KERNEL.launches,
                     "k1_inv_launches": FI.KERNEL_INV.launches}
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


def _strict_kernels() -> dict:
    """The strict engine's kernels by op: K7-K10 and K7-inv ("inv")."""
    from ark_blst_tpu_torch.ops import fp_inv as FI
    from ark_blst_tpu_torch.ops import strict_field as SF

    return {**SF.KERNELS, "inv": FI.KERNEL_INV_LIMBS}


def _strict_launches() -> dict:
    return {op: k.launches for op, k in _strict_kernels().items()}


def _affine_of(curve, xa, ya, inf) -> list:
    """Device affine coordinates -> host affine tuples (None = identity)."""
    from ark_blst_tpu_torch.ops import convert as CV

    dec = CV.fp2_from_dev if curve.name == "g2" else CV.fp_from_dev
    return [None if i else (x, y) for x, y, i in zip(dec(xa), dec(ya), inf.tolist())]


def run_scan_stages(torch, curve, lanes: int, points, scalars, expected, profiled: bool):
    """The scan MSM's stages one by one (no padding: n is a multiple of
    lanes), each ended by a synchronize: the digits, the three chains
    (scan-acc, scan-red, scan-horner) and the fold across lanes between
    them; yields (stage, summary, its output)."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.ops import scan_msm as SM

    digs, summary = _stage(torch, lambda: M.window_digits(scalars, SCAN_C), profiled)
    yield "digits", summary, digs
    bk, summary = _stage(
        torch, lambda: SM.bucket_accumulate(curve, points, digs, lanes, SCAN_C), profiled,
        expect=("words_kernel", "walk_kernel", "split_kernel"))
    yield "accumulate", summary, bk
    bk, summary = _stage(torch, lambda: M._fold_axis(curve, bk, lanes), profiled)
    yield "fold", summary, bk
    ws, summary = _stage(torch, lambda: SM.bucket_reduce(curve, bk), profiled,
                         expect=("reduce_kernel",))
    yield "reduce", summary, ws
    out, summary = _stage(torch, lambda: SM.horner(curve, ws, SCAN_C), profiled,
                          expect=("horner_kernel",))
    yield "horner", summary, out
    check(_affine(curve, out) == [expected], "staged scan MSM result differs")


# the scan MSM's launches: scan-acc's three (its point words, its walk, its
# split), scan-red, scan-horner
SCAN_CHAINS = ("scan_acc_words", "scan_acc_walk", "scan_acc_split", "scan_red", "scan_horner")
SCAN_KIND = {"scan_acc_walk": 0, "scan_red": 1, "scan_horner": 2, "scan_acc_words": 3,
             "scan_acc_split": 4, "scan_mul": 5}  # scan_msm_shape's kinds
SCAN_ENTRY = {"scan_acc_walk": "walk_kernel", "scan_acc_words": "words_kernel",
              "scan_acc_split": "split_kernel", "scan_red": "reduce_kernel",
              "scan_horner": "horner_kernel"}  # their kernels' names


def scan_chain_work(curve_name: str, n: int, lanes: int, c: int) -> dict:
    """(bytes, int32 instructions) of each chain at an MSM of n points over
    `lanes` lanes at window c, the work the function needs: scan-acc
    (`scan_acc`, whatever launches implement it) one complete
    addition a point and window and each point's 3 nc components converted
    once from strict limbs (LIMBS_TO_WORDS_OPS), the points and digits read
    once and the buckets written once as limbs; its launches each their
    own: the point words the conversion, the limbs in and the words out;
    the walk the additions, the words and digits in and the buckets out as
    words; the split the words in and the limbs out (two instructions a
    limb); scan-red 2 (B - 1) additions a window and each bucket in once;
    scan-horner W (c doublings and an addition) and each window sum in
    once."""
    nc = 2 if curve_name == "g2" else 1
    W, B, comp = -(-256 // c), 1 << c, 3 * nc
    E = lanes * W * B
    add, dbl = COMPLETE_ADD32_OPS[curve_name], COMPLETE_DBL32_OPS[curve_name]
    load = comp * LIMBS_TO_WORDS_OPS
    return {
        "scan_acc": (comp * LIMB_BYTES * (n + E) + 4 * W * n, n * W * add + n * load),
        "scan_acc_words": (comp * (LIMB_BYTES + WORD_BYTES) * n, n * load),
        "scan_acc_walk": (comp * WORD_BYTES * (n + E) + 4 * W * n, n * W * add),
        "scan_acc_split": (comp * (WORD_BYTES + LIMB_BYTES) * E, comp * 2 * 24 * E),
        "scan_red": (comp * LIMB_BYTES * W * (B + 1), W * (B - 1) * (2 * add + load)),
        "scan_horner": (comp * LIMB_BYTES * (W + 1), W * (c * dbl + add + load))}


def _scan_shape(torch, kernel, kind: int, nc: int, total_threads: int, team: int = 1,
                block: int = 1, records: int = 0) -> dict:
    """A launch's block size and blocks an SM (`scan_msm_shape`, the
    occupancy API at its registers, stack and shared memory; scan-acc's
    walk at its team and block, scan-red at its team, block and column of
    `records` buckets, scan-horner at its team, block and W = `records`)
    and the waves of its grid."""
    fn = getattr(ctypes.CDLL(str(kernel.lib_path)), "scan_msm_shape")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    err = fn(kind, nc, team, block, records, ctypes.byref(threads), ctypes.byref(per_sm))
    check(err == 0, f"scan_msm_shape: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-total_threads // threads.value)
    res = {"threads": threads.value, "blocks": blocks, "blocks_per_sm": per_sm.value,
           "sms": sms, "waves": blocks / (sms * max(per_sm.value, 1)),
           "threads_total": total_threads}
    if kind == SCAN_KIND["scan_red"]:
        return {**res, "team": team, "column": records}
    return {**res, "team": team} if kind in (SCAN_KIND["scan_acc_walk"], SCAN_KIND["scan_horner"],
                                            SCAN_KIND["scan_mul"]) else res


def check_scan_chains(torch, dev, curve, curve_name: str) -> dict:
    """scan-acc, scan-red and scan-horner against their plain loops (K7-K10
    on the card) limb for limb at the check size (SCAN_CHECK), each on the
    plain loop's own input (the fold across lanes between), the result
    against the instance's point; scan-acc as the function
    (`scan_acc`, its three launches) and each launch against its
    plain version on the same input (the point words and the walk's bucket
    records word for word, the split limb for limb); each one's time (CUDA
    events) beside its plain version's (one call) at that size."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    log_n, lanes, seed = SCAN_CHECK[curve_name]
    points, scalars, expected = distinct_bases(log_n, seed, dev, curve_name)
    digits = M.window_digits(scalars, SCAN_C)
    res = {}

    def hold(name, kernel_fn, plain_fn, stack=SM.stack_point):
        plain_ms, want = _once_ms(torch, plain_fn)
        err = _held(torch, name, stack(kernel_fn()), stack(want))
        res[name] = {"max_abs_err": err, "check_ms": cuda_ms(torch, kernel_fn, 2),
                     "plain_ms": plain_ms, "check_n": scalars.shape[1], "check_lanes": lanes}
        return want

    bk = hold("scan_acc",
              lambda: SM.bucket_accumulate(curve, points, digits, lanes, SCAN_C),
              lambda: SM.bucket_accumulate_plain(curve, points, digits, lanes, SCAN_C))
    pts, W, B, same = SM.stack_point(points), digits.shape[0], 1 << SCAN_C, lambda x: x
    pw = hold("scan_acc_words", lambda: SM.point_words(pts), lambda: SM.point_words_plain(pts),
              same)
    words = hold("scan_acc_walk", lambda: SM.accumulate_words(curve, pw, digits, lanes, SCAN_C),
                 lambda: SM.accumulate_words_plain(curve, pw, digits, lanes, SCAN_C), same)
    hold("scan_acc_split", lambda: SM.split_buckets(words, lanes, W, B),
         lambda: SM.split_buckets_plain(words, lanes, W, B), same)
    del pw, words
    folded = M._fold_axis(curve, bk, lanes)
    sums = hold("scan_red", lambda: SM.bucket_reduce(curve, folded),
                lambda: SM.bucket_reduce_plain(curve, folded))
    out = hold("scan_horner", lambda: SM.horner(curve, sums, SCAN_C),
               lambda: SM.horner_plain(curve, sums, SCAN_C))
    check(_affine(curve, out) == [expected], f"{curve_name} scan chains at the check size: "
          "the result differs from the expected point")
    return res


def phase_msm_scan(torch, dev, phase: str, curve_name: str, ptxas: dict) -> tuple:
    """The scan MSM: its three chains against their plain loops at the check
    size (`check_scan_chains`), then at full width through
    `curves/msm.py:msm` (the slice's main path), then `to_affine` on the
    card, both checked against the expected point; the chains launched once
    each and K7-K10 only in the fold across lanes (its staged rerun's
    count) and in `to_affine` (checked); the stages rerun with a
    synchronize between them and once more under the profiler; each
    chain's time at full width beside its bound, launch shape and ptxas.
    Returns (the path's launches, the chains' lines)."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    curve = G2 if curve_name == "g2" else G1
    chains = check_scan_chains(torch, dev, curve, curve_name)
    log_n, lanes, seed = SCAN[curve_name]
    t0 = time.perf_counter()
    points, scalars, expected = distinct_bases(log_n, seed, dev, curve_name)
    torch.cuda.synchronize()
    emit({"phase": "instance", "curve": curve_name, "n": scalars.shape[1],
          "seconds": time.perf_counter() - t0})
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = _reset_launches()
    t0 = time.perf_counter()
    out = M.msm(points, scalars, curve, c=SCAN_C, lanes=lanes, device=dev)  # the main path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    before = _launch_counts()
    affine = curve.to_affine(out)
    torch.cuda.synchronize()
    dt_affine = time.perf_counter() - t0 - dt
    affine_launches = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(x.shape == (24, 1) and x.device == dev
              for x in (out if curve_name == "g1" else sum(out, ()))), "result shape")
    check(_affine(curve, out) == [expected], f"{phase} result differs from the expected point")
    check(_affine_of(curve, *affine) == [expected], f"{phase}: to_affine differs")
    strict = {"strict_mont_mul", "strict_add", "strict_sub", "strict_neg"}
    check(all(launches.get(k) == 1 for k in SCAN_CHAINS)
          and set(launches) <= strict | set(SCAN_CHAINS)
          and all(launches.get(k, 0) > 0 for k in ("strict_mont_mul", "strict_add", "strict_sub")),
          f"{phase}: the path launched {launches}, expected each chain once and K7-K10")
    check(set(affine_launches) <= strict | {"fp_inv_limbs"},
          f"{phase}: to_affine launched {affine_launches}")

    staged = {name: (summary, value) for name, summary, value in
              run_scan_stages(torch, curve, lanes, points, scalars, expected, False)}
    fold_launches = staged["fold"][0]["launches"]
    check(fold_launches == {k: v for k, v in launches.items() if k in strict},
          f"{phase}: K7-K10 ran outside the fold across lanes: {launches} against the "
          f"fold's {fold_launches}")
    stages = {name + "_ms": v[0]["wall_ms"] for name, v in staged.items()}
    profiled = {name: summary for name, summary, _ in
                run_scan_stages(torch, curve, lanes, points, scalars, expected, True)}
    wall = sum(v["wall_ms"] for v in profiled.values())
    device = sum(v["device_ms"] for v in profiled.values())
    n = scalars.shape[1]
    digs, bk, sums = (staged[k][1] for k in ("digits", "fold", "reduce"))
    nc, W, B = (2 if curve_name == "g2" else 1), digs.shape[0], 1 << SCAN_C
    pts = SM.stack_point(points)
    pw = SM.point_words(pts)
    words = SM.accumulate_words(curve, pw, digs, lanes, SCAN_C)
    calls = {"scan_acc": lambda: SM.bucket_accumulate(curve, points, digs, lanes,
                                                               SCAN_C),
             "scan_acc_words": lambda: SM.point_words(pts),
             "scan_acc_walk": lambda: SM.accumulate_words(curve, pw, digs, lanes, SCAN_C),
             "scan_acc_split": lambda: SM.split_buckets(words, lanes, W, B),
             "scan_red": lambda: SM.bucket_reduce(curve, bk),
             "scan_horner": lambda: SM.horner(curve, sums, SCAN_C)}
    work = scan_chain_work(curve_name, n, lanes, SCAN_C)
    team, block = SM.ACC_SHAPE[nc]
    red_team, red_block, red_column = SM.RED_SHAPE[nc]
    horner_team, horner_block = SM.HORNER_SHAPE[nc]
    threads = {"scan_acc_words": n, "scan_acc_walk": lanes * W * team,
               "scan_acc_split": lanes * W * B, "scan_red": W * red_block,
               "scan_horner": horner_block}
    shapes = {"scan_acc_walk": (team, block, 0), "scan_red": (red_team, red_block, red_column),
              "scan_horner": (horner_team, horner_block, W)}
    for name in ("scan_acc", *SCAN_CHAINS):
        bms, by = bound_ms(*work[name])
        chains[name].update(ms=cuda_ms(torch, calls[name], 2), bound_ms=bms, bound_by=by,
                            bytes=work[name][0], instructions=work[name][1])
        if name in SCAN_KIND:
            chains[name].update(
                launch=_scan_shape(torch, SM.KERNELS[name], SCAN_KIND[name], nc, threads[name],
                                   *shapes.get(name, (1, 1, 0))),
                ptxas=_ptxas_of(ptxas, SCAN_ENTRY[name]
                                + ("IN4f3813Fp2E" if nc == 2 else "IN4f3812FpE")))
    # scan-acc's fixed cost (the identity's stores, the conversions, the
    # split) and its time a step, from the function's times at the check
    # size and at full width (the same lanes and windows: 16 and n / lanes
    # additions a stream)
    fn = chains["scan_acc"]
    steps_check, steps = fn["check_n"] // lanes, n // lanes
    per_step = (fn["ms"] - fn["check_ms"]) / (steps - steps_check)
    fn.update(per_step_ms=per_step, fixed_ms=fn["check_ms"] - steps_check * per_step,
              scratch_bytes=words.numel() * words.element_size(),
              out_bytes=3 * nc * LIMB_BYTES * lanes * W * B)
    del pw, words
    emit({"phase": phase, "n": n, "c": SCAN_C, "lanes": lanes, "ok": True, "seconds": dt,
          "points_per_s": n / dt, "to_affine_s": dt_affine, "launches": launches,
          "to_affine_launches": affine_launches, "fold_launches": fold_launches,
          "stages": stages, "stage_launches": {k: v[0]["launches"] for k, v in staged.items()},
          "peak_mem_gib": peak_gib, "chains": chains, "gpu": _smi()[0]})
    emit({"phase": phase + "_profile", "wall_ms": wall, "device_ms": device,
          "busy_share": device / wall, "stages": profiled})
    return {**launches, **{"to_affine_" + k: v for k, v in affine_launches.items()}}, chains


def scan_mul_work(curve_name: str, n: int, num_bits: int) -> tuple:
    """(bytes, int32 instructions) of scan-mul over n elements: num_bits
    doublings and additions an element, each point component converted once
    from limbs; the points and scalars read and the results written once as
    limbs."""
    nc = 2 if curve_name == "g2" else 1
    ops = num_bits * (COMPLETE_DBL32_OPS[curve_name] + COMPLETE_ADD32_OPS[curve_name])
    return (n * (2 * 3 * nc * LIMB_BYTES + 16 * 4),
            n * (ops + 3 * nc * LIMBS_TO_WORDS_OPS))


def mul_check_instance(torch, dev, curve_name: str, log_n: int, seed: int):
    """2^log_n bases of `curves/instance.py` with their scalars, the first
    lanes' scalars 0, 1, r - 1 and 2^256 - 1 (every limb 0xFFFF) and base 4
    the identity; with the scalars as ints."""
    from ark_blst_tpu_torch.curves.group import G1, G2
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM
    from ark_blst_tpu_torch.ops.limbs import int_to_limbs
    from ark_blst_tpu_torch.oracle.field import R

    curve = G2 if curve_name == "g2" else G1
    points, scalars, _ = distinct_bases(log_n, seed, dev, curve_name)
    for col, k in enumerate((0, 1, R - 1, (1 << 256) - 1)):
        scalars[:, col] = torch.tensor([int(v) for v in int_to_limbs(k, 16)], dtype=torch.int32,
                                       device=dev)
    stack = SM.stack_point(points)
    stack[:, :, 4:5] = SM.stack_point(curve.identity((1,), dev))
    return curve, SM.point_of(stack), scalars


def check_scan_mul(torch, dev, curve_name: str, ptxas: dict) -> dict:
    """scan-mul (one launch) against its plain loop (K7-K10 on the card)
    limb for limb and the oracle at the check size (32 elements, 256 bits,
    the edge scalars and an identity base), then at 2^12 elements: its time
    beside the plain loop's (one call) and its bound, its launch shape
    (`MUL_SHAPE`) and ptxas (other shapes: scripts/scan_mul_probe.py)."""
    from ark_blst_tpu_torch.oracle import curve as OC
    from ark_blst_tpu_torch.oracle.field import R
    from ark_blst_tpu_torch.ops import scan_msm as SM
    from ark_blst_tpu_torch.ops.limbs import limbs_to_ints

    nc = 2 if curve_name == "g2" else 1
    seed = MUL_SEED + (nc - 1)
    curve, points, scalars = mul_check_instance(torch, dev, curve_name, MUL_CHECK_LOG_N, seed)
    before = SM.KERNEL_MUL.launches
    got = SM.stack_point(curve.scalar_mul(points, scalars, SM.SCALAR_BITS))
    check(SM.KERNEL_MUL.launches == before + 1, "scan-mul: not one launch")
    want = SM.stack_point(SM.scalar_mul_plain(curve, points, scalars, SM.SCALAR_BITS))
    err = _held(torch, f"scan-mul ({curve_name})", got, want)
    ks = limbs_to_ints(scalars[:, :8].T.cpu().numpy())
    mul = OC.g2_mul if nc == 2 else OC.scalar_mul
    check(_affine(curve, SM.point_of(got[..., :8])) == [
        None if p is None else mul(p, k % R)
        for p, k in zip(_affine(curve, SM.point_of(SM.stack_point(points)[..., :8])), ks)],
        f"scan-mul ({curve_name}) differs from the oracle")
    check_n = scalars.shape[1]
    check_ms = cuda_ms(torch, lambda: curve.scalar_mul(points, scalars, SM.SCALAR_BITS), 2)
    curve, points, scalars = mul_check_instance(torch, dev, curve_name, NAIVE_LOG_N, seed)
    n = scalars.shape[1]
    plain_ms, want = _once_ms(torch, lambda: SM.scalar_mul_plain(curve, points, scalars,
                                                                  SM.SCALAR_BITS))
    got = curve.scalar_mul(points, scalars, SM.SCALAR_BITS)
    err = max(err, _held(torch, f"scan-mul ({curve_name}) at 2^12", SM.stack_point(got),
                         SM.stack_point(want)))
    ms = cuda_ms(torch, lambda: curve.scalar_mul(points, scalars, SM.SCALAR_BITS), 3)
    work = scan_mul_work(curve_name, n, SM.SCALAR_BITS)
    bms, by = bound_ms(*work)
    team, block = SM.MUL_SHAPE[nc]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bytes": work[0], "instructions": work[1], "n": n, "num_bits": SM.SCALAR_BITS,
            "check_n": check_n, "check_ms": check_ms,
            "launch": _scan_shape(torch, SM.KERNEL_MUL, SCAN_KIND["scan_mul"], nc,
                                  -(-n // (block // team)) * block, team, block),
            "ptxas": _ptxas_of(ptxas, "mul_kernel" + ("IN4f3813Fp2E" if nc == 2
                                                      else "IN4f3812FpE"))}


def phase_msm_naive(torch, dev, ptxas: dict) -> tuple:
    """scan-mul checked and timed on G1 and G2 (`check_scan_mul`); then on a
    2^12 G1 instance the ladder alone (one scan-mul launch, nothing else),
    `msm_naive` (the slice's path: one scan-mul launch, K7-K10 only in its
    fold), `msm`, and `to_affine` of the bases (one K7-inv), each path's
    launches counted from 0 just before it and read just after. Returns
    (the launches by path, scan-mul's lines by curve)."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves.group import G1
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    t_phase = time.perf_counter()
    mul = {name: check_scan_mul(torch, dev, name, ptxas) for name in ("g1", "g2")}
    points, scalars, expected = distinct_bases(NAIVE_LOG_N, NAIVE_SEED, dev, "g1")
    torch.cuda.synchronize()
    strict = {"strict_mont_mul", "strict_add", "strict_sub", "strict_neg"}

    def counted(fn):
        kernels = _reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {k: v.launches for k, v in kernels.items()
                                               if v.launches}

    _, ladder_s, ladder = counted(lambda: G1.scalar_mul(points, scalars, SM.SCALAR_BITS))
    check(ladder == {"scan_mul": 1}, f"the ladder launched {ladder}, expected one scan_mul")
    naive, naive_s, naive_launches = counted(lambda: M.msm_naive(points, scalars, G1, device=dev))
    check(naive_launches.get("scan_mul") == 1 and set(naive_launches) <= strict | {"scan_mul"},
          f"msm_naive launched {naive_launches}, expected one scan_mul and K7-K10")
    scan, msm_s, msm_launches = counted(lambda: M.msm(points, scalars, G1, c=SCAN_C, device=dev))
    affine, affine_s, affine_launches = counted(lambda: G1.to_affine(points))
    check(_affine(G1, naive) == [expected], "msm_naive differs from the expected point")
    check(_affine(G1, scan) == [expected], "msm at 2^12 differs from the expected point")
    got = _affine_of(G1, *affine)
    want = _affine(G1, points)  # the host's division of the same points
    bad = sum(g != w for g, w in zip(got, want))
    check(len(got) == len(want) and bad == 0, f"to_affine: {bad} of {len(want)} points differ")
    launches = {"naive": naive_launches, "msm": msm_launches, "to_affine": affine_launches}
    emit({"phase": "msm_naive", "n": scalars.shape[1], "ok": True, "naive_s": naive_s,
          "ladder_s": ladder_s, "msm_s": msm_s, "to_affine_s": affine_s,
          "to_affine_points": len(got), "launches": launches, "ladder_launches": ladder,
          "scan_mul": mul, "seconds": time.perf_counter() - t_phase, "gpu": _smi()[0]})
    return launches, mul


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

    names = _msm_kernel_names(kc)
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
    _check_k1_family(launches, scalars.shape[1], kc)
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
    unsharded `multi_pairing`; then on the strict engine fused (the chains
    on strict limbs, the fold on K4's strict limbs, no K7-K10; checked),
    limb for limb the lazy result. Returns the line and the launches, the
    strict route's as `strict:<kernel>`."""
    from ark_blst_tpu_torch import bls12 as B
    from ark_blst_tpu_torch.curves import pairing as PR
    from ark_blst_tpu_torch.ops import convert as CV

    (p, p_inf), (q, q_inf) = B._g1_batch(ps, dev), B._g2_batch(qs, dev)
    want = _fp12_product(expected)
    names = PAIRING_NAMES
    run = lambda: PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf)  # noqa: E731
    kernels = _reset_launches()
    gathers, nbytes = mesh.gathers, mesh.gather_bytes
    t0 = time.perf_counter()
    got = run()  # the sharded path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in names}
    check(all(launches[k] > 0 for k in PAIRING_FUSED + ("fp12_mul_words",)),
          f"a kernel of the path was not launched: {launches}")
    check(launches["fp12_mul"] == 0 and launches["fp12_mul_limbs"] == 0,
          f"the sharded multi-pairing folded off K4's words: {launches}")
    _check_pairing_k1(launches, True, "sharded multi-pairing")
    _check_chains(launches, (1, 1), "sharded multi-pairing")
    _check_final_exp(launches, (1, 1), "sharded multi-pairing")
    check(CV.fp12_from_dev(got) == [want],
          "sharded multi-pairing differs from the oracle's product")
    check(mesh.gathers == gathers + 1, "the world of one did not gather")
    single = PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf)
    flat = lambda t: [x for a in t for b in a for x in b]  # noqa: E731
    check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(single))),
          "sharded multi-pairing differs from multi_pairing")
    like = torch.zeros((12, 12, 1), dtype=torch.int32, device=dev)  # a rank's words
    res = {"engine": "lazy", "fuse": True, "events": 68, "final": True,
           "collective": str(mesh.backend), "world": mesh.size, "n": len(ps), "ok": True,
           "equal_to_oracle_product": True, "equal_to_multi_pairing": True,
           "launches": launches, "gather_bytes": mesh.gather_bytes - nbytes,
           **_in_turns(torch, run, lambda: PR.multi_pairing(p, q, p_inf=p_inf, q_inf=q_inf), dt),
           "gather_ms": _gather_ms(torch, mesh, like)}
    _, prof = _stage(torch, run, profiled=True)
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share", "device_ms_from")}
    # the strict engine fused: the chains on strict limbs, the rank's fold on
    # K4's strict limbs (ceil(log2 N) launches; none after the gather of one)
    kernels = _reset_launches()
    t0 = time.perf_counter()
    strict = PR.multi_pairing_sharded(p, q, mesh, p_inf=p_inf, q_inf=q_inf, engine="strict")
    torch.cuda.synchronize()
    strict_s = time.perf_counter() - t0
    strict_launches = {k: v.launches for k, v in kernels.items() if v.launches}
    want_launches = {"prepare_chain_limbs": 1, "miller_chain_limbs": 1,
                     "fp12_mul_limbs_limbs": (len(ps) - 1).bit_length(),
                     "final_exp_easy_limbs": 1, "final_exp_hard": 1}
    check(strict_launches == want_launches,
          f"the strict sharded multi-pairing launched {strict_launches}, expected {want_launches}")
    check(all(torch.equal(a, b) for a, b in zip(flat(strict), flat(got))),
          "the strict sharded multi-pairing differs from the lazy one")
    res["strict"] = {"engine": "strict", "fuse": True, "seconds": strict_s,
                     "launches": strict_launches, "equal_to_lazy": True}
    return res, {**launches, **{"strict:" + k: v for k, v in strict_launches.items()}}


def distributed_scan_and_auto(torch, dev, mesh) -> tuple:
    """`msm_sharded` (the scan MSM: scan-acc's three launches and scan-red
    once each, K7-K10
    in the fold across lanes; checked) in the world of one at 2^16 with the
    host finish, and `msm_auto` on the card at 2^20, which must take the
    bucket route (one K2 launch, no strict kernel); both against their
    instances' expected points."""
    from ark_blst_tpu_torch.curves import msm as M
    from ark_blst_tpu_torch.curves import msm_bucket as MB
    from ark_blst_tpu_torch.curves.group import G1
    from ark_blst_tpu_torch.curves.instance import distinct_bases
    from ark_blst_tpu_torch.ops import scan_msm as SM

    points, scalars, expected = distinct_bases(DIST_SCAN_LOG_N, DIST_SCAN_SEED, dev, "g1")
    _reset_launches()
    t0 = time.perf_counter()
    out = M.msm_sharded(points, scalars, mesh, G1, c=SCAN_C, lanes=SCAN["g1"][1],
                        finish="host")  # the sharded scan path
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    scan_launches = _strict_launches()
    chain_launches = {k: v.launches for k, v in SM.KERNELS.items()}
    check(_affine(G1, out) == [expected], "sharded scan MSM differs from the expected point")
    check(all(scan_launches[k] > 0 for k in ("mont_mul", "add", "sub")),
          f"a kernel of the path was not launched: {scan_launches}")
    # the host finish: scan-acc (its three launches) and scan-red on the
    # rank, no scan-horner
    check(chain_launches == {"scan_acc_words": 1, "scan_acc_walk": 1, "scan_acc_split": 1,
                             "scan_red": 1, "scan_horner": 0, "scan_mul": 0},
          f"the sharded scan MSM's chains launched {chain_launches}")
    scan_launches.update(chain_launches)
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
    auto_launches = {name: kernels[name].launches for name in _msm_kernel_names(MB.KC2_G1)}
    check(_affine(G1, out) == [expected], "msm_auto differs from the expected point")
    check(auto_launches["bucket_accumulate"] == 1 and not any(_strict_launches().values())
          and not any(k.launches for k in SM.KERNELS.values()),
          f"msm_auto did not take the bucket route: {auto_launches}")
    _check_k1_family(auto_launches, scalars.shape[1], MB.KC2_G1)
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
           "launches": {name: kernels[name].launches for name in _msm_kernel_names(kc)},
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
               "launches": {name: kernels[name].launches for name in PAIRING_NAMES},
               "gather_bytes": mesh.gather_bytes - nbytes,
               "gather_ms": _gather_ms(torch, mesh,
                                       torch.zeros((12, 30, 1), dtype=torch.int32, device=dev)),
               "fp12": CV.fp12_from_dev(got)}
    check(all(pairing["launches"][k] > 0 for k in PAIRING_FUSED + ("fp12_mul_words",)),
          f"rank {a.rank}: {pairing['launches']}")
    check(pairing["launches"]["fp12_mul"] == 0, f"rank {a.rank} folded on K4's digits")
    _check_chains(pairing["launches"], (1, 1), f"rank {a.rank}'s sharded pairing")
    _check_final_exp(pairing["launches"], (1, 1), f"rank {a.rank}'s sharded pairing")
    with open(a.out, "w") as f:
        json.dump({"rank": a.rank, "collective": str(mesh.backend), "device": str(dev),
                   "sharing": mesh.sharing, "init_s": init_s, "msm": msm, "pairing": pairing,
                   "seconds": time.perf_counter() - t_start}, f)
    torch.distributed.destroy_process_group()
    return 0


# what the chains' kernel lines give of their one-event runs (phases k5, k6)
ONE_EVENT_KEYS = ("ms", "plain_ms", "bound_ms", "bound_radix13_ms")


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
    chains = phase_k1_chains(torch, dev, ptxas)

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
    k4, k4w = phase_k4(torch, dev, real, sass["fp12_mul.cu"], ptxas)
    k5 = phase_k5(torch, dev, real, sass["prepare_step.cu"], ptxas)
    k6 = phase_k6(torch, dev, real, sass["miller_step.cu"], ptxas)
    k11, k12 = phase_k11_k12(torch, dev, real, sass, ptxas)
    del real
    k5c, k6c, k5s, k6s = phase_tower_chains(torch, dev, ptxas)
    torch.cuda.empty_cache()
    fe_easy, fe_hard, fe_easy_limbs = phase_final_exp_chains(torch, dev, ptxas)
    launches, fused = phase_pairing(torch, dev, ps, qs, pairs_expected)
    unfused = phase_pairing_unfused(torch, dev, ps, qs, pairs_expected, fused)
    torch.cuda.empty_cache()
    strict_pairing, strict_fused, strict_multi, multi_launches = phase_pairing_strict(
        torch, dev, ps, qs, pairs_expected)
    torch.cuda.empty_cache()
    api_launches = phase_api(torch, dev, ps, qs, pairs_expected, fused)
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
    scan, scan_chains = {}, {}
    for name, phase in (("g1", "msm_scan"), ("g2", "msm_scan_g2")):
        scan[name], scan_chains[name] = phase_msm_scan(torch, dev, phase, name,
                                                       ptxas["scan_msm.cu"])
        torch.cuda.empty_cache()
    naive, scan_mul = phase_msm_naive(torch, dev, ptxas["scan_msm.cu"])

    def scan_strict(curve: str, key: str) -> int:
        """A strict kernel's launches in a scan MSM run: the fold across
        lanes and `to_affine`."""
        return scan[curve].get(key, 0) + scan[curve].get("to_affine_" + key, 0)

    bodies = {"mont_mul": "_mul_body :39", "add": "_add_body :43", "sub": "_sub_body :48",
              "neg": "_neg_body :56"}
    strict_lines = [
        _kernel_line("strict_" + op, "strict_field.cu",
                     f"ark_blst_tpu/ops/pallas_field.py:66 ({bodies[op]})",
                     scan_strict("g1", "strict_" + op) + scan_strict("g2", "strict_" + op),
                     k7_k10[op],
                     launches_msm_scan=scan_strict("g1", "strict_" + op),
                     launches_msm_scan_g2=scan_strict("g2", "strict_" + op),
                     launches_msm_naive=naive["naive"].get("strict_" + op, 0),
                     launches_distributed={"msm_scan": dist_launches["scan"][op]},
                     launches_pairing_strict=strict_pairing.get("strict_" + op, 0),
                     launches_pairing_strict_fused=strict_fused.get("strict_" + op, 0),
                     launches_multi={name: v["launches"].get("strict_" + op, 0)
                                     for name, v in strict_multi.items()},
                     fr=k7_k10[op]["fr"], broadcast=k7_k10[op]["broadcast"])
        for op in bodies]
    strict_chain_lines = [
        _kernel_line(name, source, replaces, strict_fused.get(name, 0), res,
                     launches_pairing_strict_unfused=strict_pairing.get(name, 0),
                     launches_multi={route: v["launches"].get(name, 0)
                                     for route, v in strict_multi.items()},
                     **{k: res[k] for k in ("at_ragged", "at_widths", "words_ms", "launch",
                                            "ptxas", "lines_bytes") if k in res})
        for name, source, replaces, res in (
            ("prepare_chain_limbs", "prepare_step.cu",
             "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 under the strict prepare's lax.scan, "
             "ark_blst_tpu/curves/pairing.py:262)", k5s),
            ("miller_chain_limbs", "miller_step.cu",
             "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 under the strict Miller lax.scan, "
             "ark_blst_tpu/curves/pairing.py:359)", k6s),
            ("final_exp_easy_limbs", "final_exp.cu",
             "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 in the strict final exponentiation, "
             "ark_blst_tpu/curves/pairing.py:422 and :430-467: its easy part)", fe_easy_limbs))]
    inv7 = chains["fp_inv_limbs"]
    strict_chain_lines.append(_kernel_line(
        "fp_inv_limbs", "fp_inv.cu",
        "ark_blst_tpu/ops/pallas_field.py:66 (K7 under the Fermat lax.scan of "
        "ark_blst_tpu/ops/dispatch.py:139 fp_pow, from :143 fp_inv)",
        strict_pairing.get("fp_inv_limbs", 0), inv7,
        launches_pairing_strict_fused=strict_fused.get("fp_inv_limbs", 0),
        launches_msm_scan=scan_strict("g1", "fp_inv_limbs"),
        launches_msm_scan_g2=scan_strict("g2", "fp_inv_limbs"),
        launches_msm_naive_to_affine=naive["to_affine"].get("fp_inv_limbs", 0),
        launches_multi={route: v["launches"].get("fp_inv_limbs", 0)
                        for route, v in strict_multi.items()},
        at_widths=inv7["at_widths"], launch=inv7["launch"],
        fermat_bound_ms=inv7["fermat_bound_ms"], floor_ms=inv7["floor_ms"],
        latency=inv7["latency"],
        ptxas=_ptxas_of(ptxas["fp_inv.cu"], "fp_inv_kernelILi1E")))
    g1, g2 = scan_mul["g1"], scan_mul["g2"]
    strict_chain_lines.append(_kernel_line(
        "scan_mul", "scan_msm.cu",
        "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 under the lax.scan of "
        "ark_blst_tpu/curves/group.py:276, scalar_mul :257; msm_naive's ladder)",
        naive["naive"].get("scan_mul", 0), g1,
        **{k: g1[k] for k in ("n", "num_bits", "check_n", "check_ms", "bytes", "instructions",
                              "launch", "ptxas")},
        g2={k: g2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "n",
                                "check_ms", "launch", "ptxas")}))
    strict_chain_lines.append(_kernel_line(
        "fp12_mul_limbs_limbs", "fp12_mul.cu",
        "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 in the strict tower's fp12_mul under the "
        "strict multi-pairings' product fold, ark_blst_tpu/curves/pairing.py:470 _fold_mul)",
        strict_multi["strict_fused"]["launches"].get("fp12_mul_limbs_limbs", 0),
        k4w["limbs_limbs"],
        launches_multi_prepared=strict_multi["strict_fused"]["launches_prepared"].get(
            "fp12_mul_limbs_limbs", 0),
        launches_multi_unfused=strict_multi["strict_unfused"]["launches"].get(
            "fp12_mul_limbs_limbs", 0),
        launches_distributed={"pairing": dist_launches["pairing"].get(
            "strict:fp12_mul_limbs_limbs", 0)},
        digits_ms=k4w["limbs_limbs"]["digits_ms"], at_widths=k4w["limbs_limbs"]["at_widths"],
        launch=k4w["limbs_limbs"]["launch"], ptxas=k4w["limbs_limbs"]["ptxas"]))
    scan_where = "ark_blst_tpu/ops/pallas_field.py:66 (K7-K10 under the lax.scan of " \
        "ark_blst_tpu/curves/msm.py:138 _scan from "
    line_keys = ("ms", "plain_ms", "check_ms", "check_n", "check_lanes", "max_abs_err",
                 "bound_ms", "bound_by", "bytes", "instructions")
    # scan-acc as one function (its three launches, each its own line
    # below): `launches` its walk's, the three beside
    acc_keys = (*line_keys, "fixed_ms", "per_step_ms", "scratch_bytes", "out_bytes")
    g1 = scan_chains["g1"]["scan_acc"]
    strict_chain_lines.append(_kernel_line(
        "scan_acc", "scan_msm.cu", scan_where + ":155 _bucket_accumulate; scan-acc's three "
        "launches as one function)", scan["g1"].get("scan_acc_walk", 0), g1,
        launches_of={k: scan["g1"].get(k, 0)
                     for k in ("scan_acc_words", "scan_acc_walk", "scan_acc_split")},
        launches_msm_scan_g2=scan["g2"].get("scan_acc_walk", 0),
        **{k: g1[k] for k in acc_keys if k not in ("ms", "plain_ms", "max_abs_err",
                                                     "bound_ms", "bound_by")},
        g2={k: scan_chains["g2"]["scan_acc"][k] for k in acc_keys}))
    scan_replaces = {
        "scan_acc_words": ":155 _bucket_accumulate; scan-acc's point words",
        "scan_acc_walk": ":155 _bucket_accumulate; scan-acc's walk",
        "scan_acc_split": ":155 _bucket_accumulate; scan-acc's split",
        "scan_red": ":199 _bucket_reduce, its scan at :223",
        "scan_horner": ":227 _horner, its fori_loop at :241"}
    for name, where in scan_replaces.items():
        g1, g2 = scan_chains["g1"][name], scan_chains["g2"][name]
        strict_chain_lines.append(_kernel_line(
            name, "scan_msm.cu", scan_where + where + ")",
            scan["g1"].get(name, 0), g1, launches_msm_scan_g2=scan["g2"].get(name, 0),
            launches_distributed={"msm_scan": dist_launches["scan"].get(name, 0)},
            check_ms=g1["check_ms"], check_n=g1["check_n"], check_lanes=g1["check_lanes"],
            bytes=g1["bytes"], instructions=g1["instructions"], launch=g1["launch"],
            ptxas=g1["ptxas"],
            g2={k: g2[k] for k in (*line_keys, "launch", "ptxas")}))

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
        _kernel_line("fp_inv", "fp_inv.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:41 (the Fermat lax.scans of "
                     "ops/tower_lazy.py:264 fp_inv and curves/msm_pallas2.py:394 _fermat_inv)",
                     msm_launches["g1"]["fp_inv"], chains["fp_inv"],
                     launches_msm_g2=msm_launches["g2"]["fp_inv"],
                     launches_pairing=launches["fp_inv"],
                     launches_pairing_unfused=unfused["fp_inv"],
                     launches_distributed={name: dist_launches[key]["fp_inv"] for name, key in (
                         ("msm_g1", "g1"), ("msm_g2", "g2"), ("pairing", "pairing"),
                         ("msm_auto", "auto"))},
                     at_widths=chains["fp_inv"]["at_widths"],
                     fermat_bound_ms=chains["fp_inv"]["fermat_bound_ms"],
                     launch=chains["fp_inv"]["launch"]),
        _kernel_line("batch_inverse_scan", "fp_inv.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:41 (the up and down lax.scans of "
                     "curves/msm_pallas2.py:434 _batch_inverse)",
                     msm_launches["g1"]["scan_up"] + msm_launches["g1"]["scan_down"],
                     chains["scan"],
                     launches_up_down=[msm_launches["g1"]["scan_up"],
                                       msm_launches["g1"]["scan_down"]],
                     launches_msm_g2=msm_launches["g2"]["scan_up"]
                     + msm_launches["g2"]["scan_down"],
                     launches_distributed={name: dist_launches[key]["scan_up"]
                                           + dist_launches[key]["scan_down"]
                                           for name, key in (("msm_g1", "g1"), ("msm_g2", "g2"),
                                                             ("msm_auto", "auto"))},
                     rows=chains["scan"]["rows"], columns=chains["scan"]["columns"],
                     levels=chains["scan"]["levels"][1:],
                     batch_inverse=chains["scan"]["batch_inverse"]),
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
                     unfused["cyc_sqr"], k3, launches_pairing_fused=launches["cyc_sqr"],
                     launches_distributed={"pairing": dist_launches["pairing"]["cyc_sqr"]},
                     bound_radix13_ms=k3["bound_radix13_ms"]),
        _kernel_line("fp12_mul", "fp12_mul.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (ops/tower_lazy.py:567 mul12)",
                     unfused["fp12_mul"], k4, launches_pairing_fused=launches["fp12_mul"],
                     launches_multi={name: c.get("fp12_mul", 0)
                                     for name, c in multi_launches.items()},
                     launches_distributed={"pairing": dist_launches["pairing"]["fp12_mul"]},
                     bound_radix13_ms=k4["bound_radix13_ms"], ptxas=k4["ptxas"]),
        *[_kernel_line("fp12_mul_" + layout, "fp12_mul.cu",
                       "ark_blst_tpu/ops/pallas_lazy.py:63 (ops/tower_lazy.py:567 mul12, under "
                       "the multi-pairings' product fold, ark_blst_tpu/curves/pairing.py:470 "
                       "_fold_mul" + (" and :485 _egress)" if layout == "limbs" else ")"),
                       multi_launches[main]["fp12_mul_" + layout], k4w[layout],
                       launches_multi={name: c.get("fp12_mul_" + layout, 0)
                                       for name, c in multi_launches.items()},
                       launches_api_miller=api_launches["fp12_mul_" + layout],
                       launches_distributed={
                           "pairing": dist_launches["pairing"]["fp12_mul_" + layout]},
                       launches_pairing_fused=launches["fp12_mul_" + layout],
                       launches_pairing_unfused=unfused["fp12_mul_" + layout],
                       digits_ms=k4w[layout]["digits_ms"], at_widths=k4w[layout]["at_widths"],
                       launch=k4w[layout]["launch"], ptxas=k4w[layout]["ptxas"])
          for layout, main in (("words", "multi_pairing"), ("limbs", "multi_miller_loop"))],
        *[_kernel_line("final_exp_" + part, "final_exp.cu", replaces,
                       launches["final_exp_" + part], res,
                       launches_prepared=launches["prepared"]["final_exp_" + part],
                       launches_pairing_unfused=unfused["final_exp_" + part],
                       launches_distributed={
                           "pairing": dist_launches["pairing"]["final_exp_" + part]},
                       at_widths=res["at_widths"], launch=res["launch"],
                       digits_ms=res["digits_ms"], bound_digits_ms=res["bound_digits_ms"],
                       ptxas=_ptxas_of(ptxas["final_exp.cu"], entry))
          for part, entry, replaces, res in (
              ("easy", "easy_kernelILi2E",
               "ark_blst_tpu/ops/pallas_lazy.py:63 (mul12) and :41 (the easy part of "
                       "the fused final exponentiation, ark_blst_tpu/curves/pairing.py:438-443: "
                       "fp12_inv's products and Fermat scan, the Frobenius square)", fe_easy),
              ("hard", "hard_kernelILi1E",
               "ark_blst_tpu/ops/pallas_lazy.py:149, :63 (mul12) and :41 (the hard "
                       "part, ark_blst_tpu/curves/pairing.py:444-467: five x-ladders, products, "
                       "Frobenius maps)", fe_hard))],
        _kernel_line("prepare_chain", "prepare_step.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (tower_fused under the prepare's "
                     "lax.scan, ark_blst_tpu/curves/pairing.py:242)",
                     launches["prepare_step"], k5c,
                     launches_prepared=launches["prepared"]["prepare_step"],
                     launches_pairing_unfused=unfused["prepare_step"],
                     launches_distributed={"pairing": dist_launches["pairing"]["prepare_step"]},
                     at_ragged=k5c["at_ragged"], launch=k5c["launch"],
                     by_event_ms=k5c["by_event_ms"], digit_edges_ms=k5c["digit_edges_ms"],
                     bound_digit_edges_ms=k5c["bound_digit_edges_ms"],
                     lines_bytes=k5c["lines_bytes"],
                     lines_bytes_as_digits=k5c["lines_bytes_as_digits"],
                     one_event={"doubling": {k: k5[k] for k in ONE_EVENT_KEYS},
                                "addition": {k: k5["addition"][k] for k in ONE_EVENT_KEYS}}),
        _kernel_line("miller_chain", "miller_step.cu",
                     "ark_blst_tpu/ops/pallas_lazy.py:63 (tower_fused under the Miller "
                     "lax.scan, ark_blst_tpu/curves/pairing.py:342)",
                     launches["miller_step"], k6c,
                     launches_prepared=launches["prepared"]["miller_step"],
                     launches_pairing_unfused=unfused["miller_step"],
                     launches_distributed={"pairing": dist_launches["pairing"]["miller_step"]},
                     at_ragged=k6c["at_ragged"], launch=k6c["launch"],
                     by_event_ms=k6c["by_event_ms"], digit_edges_ms=k6c["digit_edges_ms"],
                     bound_digit_edges_ms=k6c["bound_digit_edges_ms"],
                     f_digits_ms=k6c["f_digits_ms"], bound_f_digits_ms=k6c["bound_f_digits_ms"],
                     one_event={"with_square": {k: k6[k] for k in ONE_EVENT_KEYS},
                                "line_only": {k: k6["line_only"][k] for k in ONE_EVENT_KEYS}}),
        *strict_lines,
        *strict_chain_lines,
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
