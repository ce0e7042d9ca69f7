#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (zokrates_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each timed:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
  2. build: nvcc of the kernels (csrc/: one library per source, built in
     parallel), gcc of the native host tail
  2b. the CLI (run_cli_path), before the kernel checks, so that none of
     its child processes runs beside a timed kernel: `python -m
     zokrates_tpu_torch compile -i main.zok` of the README's sha256
     source and then `setup` and, once the kernels are built, `compute-
     witness --vectorized` (the card's generator forced), in a child
     process started with the script (cli_compile_job, beside the build:
     a setup launches no kernel of the port): the R1CS (A, B, C, instance
     and variable counts) equal to bench_artifacts/sha256.out's, abi.json
     to sha256.abi.json; each a child process timed by wall clock with its
     start, compute-witness --abi on preimage [0, ..., 15] (a first call:
     it must name the scalar interpreter on stderr, and the generator's
     witness file must equal its), generate-proof, verify (PASSED),
     export-verifier, print-proof; a proof.json with a coordinate of a
     changed through cli.main (FAILED, exit 1) and print-proof -f remix;
     these walls are taken under contention (port_tools/cli_phase.py
     --alone takes each alone).
     Meanwhile the toy matrix, its cells in child processes side by side
     (CLI_TOY_JOBS), each through cli.main in its process (CLI_TOY: 20
     squarings and an asm block compiled to Zir directives): g16 on
     bn128, bls12_381, bls12_377 and bw6_761 (each proof's MSM kernels at
     the curve's width only; on bls12_377, Fq2 with u^2 = -5, a tampered
     proof and a wrong public input rejected), gm17 on bn128, bls12_381
     and bw6_761 (in the bw6_761 g16 cell's process; the proof's MSM
     kernels at 24 limbs only and emul at 24, the key's queries over
     BW6-761's Fq), marlin on bn128 (universal-setup -n 9), the bellman
     ceremony on bn128 (mpc-init from a phase-1 radix, mpc-contribute,
     mpc-verify, mpc-export, a proof with the exported key; mixed_add_lm
     and accumulate_lm launched), nova-setup / nova-prove / nova-verify
     of z' = z*z + z on pallas, and the bn128 toy's witness by the card's
     generator (forced: the Zir solvers in its host segment) equal to the
     scalar interpreter's; every proof verified. Then 16 witnesses by
     cli.main compute-witness in this process (the program read once;
     the first by the scalar interpreter, equal to the child process's,
     the rest by the card's generator, planned and captured once, the
     first of them equal to the scalar interpreter's) and generate-proof -w ...
     --also-witness ... on all 16 (groth16.prove_batch) with the launch
     counts set to 0 just before and read just after: every kernel of
     rows 1-7 launched, no plain version on the card (PlainGuard); all 16
     proofs verify in one weighted pairing product (and not with one C
     swapped), the last also through cli.main verify
  3. kernel checks: every CUDA kernel of the Groth16 path against its plain
     PyTorch version on the card, at the prove's shapes, from seeded
     inputs (real curve points; doubling, cancellation and infinity cases
     included): the walk in modes mixed-unsafe, mixed-safe and general,
     the suffix walk and its epilogue (suffix_fold), each over Fq and Fq2,
     over G1 also at the epilogue's dense h MSM shape and at the a/b1/l
     MSM's shapes (three queries on one plan; the shared-bucket h MSM's
     kernels are held on a proof's own plan in phase 4); each walk shape's sub-chunk
     length S and thread count are logged, and each suffix shape's
     sub-chunks a lane k (msm_sorted.suffix_split) and thread count;
     emul, ereduce_wide, the NTT and the matvec walk mulacc_walk (B = 1 and
     16, on the sha256 circuit's walk plans at the lanes the path takes,
     groth16.walk_lanes, and at the reference's 1024 lanes) over the
     scalar field, emul, ereduce_wide and the NTT also at the B = 16
     batch's shapes (emul: to_mont (16, 27281) one row, the 48
     transforms' n^-1 one row and coset table shared, A*B (16, 2^15) as
     the h stage's slices and full, 1/Z, n^-1 and from_mont one row, the
     inverse coset table shared; ereduce_wide: the walk's flush slots at
     the path's plans and the row sums; the NTT: 48 forward, 48 and 16
     inverse) — outputs must be bit-equal; then a full sorted MSM on the
     card against the Python-int oracle (G1 and G2)
  4. main path: the sha256 circuit (bench_artifacts/sha256.out, 27,459
     constraints, domain 2^15) and its witness through the port's readers,
     the CLI's proving key (with the shared-bucket h query h16_p128, in
     place of a second setup),
     3 proofs with distinct fixed r, s, each verified by the host pairing
     check; every kernel's launch count over setup and proofs must be
     above 0 (mulacc_walk at least once a proof), the walk, suffix and
     epilogue launches per proof are logged by shape, and no plain field
     product, reduction, matvec walk or COO matvec may run on the card
     inside the h stage, the corrections or the MSMs; then the h MSM of
     one proof's h scalars in both forms (shared-bucket and dense per
     window: equal as group elements, each timed), and that MSM's h16
     walk (the plain version on two blocks of its plan, walk_blocks),
     first merge walk, suffix and epilogue on its own plan and
     points against their plain versions (bit-equal, timed; each walk
     also at every S through the kernel's C entry point, bit-equal to the
     wrapper's output; the suffix at the prove's k)
  5. witness generator (interp/vectorized.py, VectorizedInterpreter on
     the card): 16 distinct sha256 witnesses (preimage [16b, ..., 16b +
     15]), each held value for value against the scalar interpreter (both
     timed: the plan's build, the first call, eager and captured into one
     CUDA graph a segment, and the replayed calls), emul and ereduce_wide
     launches a witness (the replays' counted), no plain field product or
     reduction on the card (WitnessGuard); emul and ereduce_wide at the
     plan's widest calls against their plain versions; Pedersen-512 (the
     deep case, two witnesses) and port_artifacts/solvers_bn128.out.gz
     (ConditionEq, Or, EuclideanDiv, Bits) the same, the latter's failing
     inputs (an assert, a division by zero) raising the scalar
     interpreter's errors; then the batched path, as bench.py measures:
     those 16 witnesses, one warm-up prove_batch and 2 timed ones; all 16 proofs of the last
     batch verify in one pairing product with random weights (verify_all;
     the same batch with one proof's C swapped must fail), all 16 are
     distinct, proofs 0 and 1 equal prove() of the same witness with the
     same r, s byte for byte, the launch counts (set to 0 before the
     first batch) are above 0, and no plain version runs on the card;
     one more batch under torch.profiler gives the card's busy time;
     then groth16._matvec_walk at B = 1 and 16 (device time and its
     steps by CUDA events) and the peak allocation of one B = 16 h stage
  6. BLS12-381 path: the same sha256 program compiled for bls12_381
     (port_artifacts/sha256_bls12_381.out.gz, read with gzip) and 16
     witnesses from the card's generator, as in phase 5 (preimage [16b, ..., 16b + 15];
     witness 0 proves on the main path); every kernel of its prove against
     its plain version at the prove's shapes, as in phase 3: the walks,
     suffix and epilogue at 12 limbs over Fq and Fq2 (dense h, a/b1/l and
     b2 shapes, the h16 epilogue), emul, ereduce_wide, the NTT at (3, 2^15) both ways and
     mulacc_walk at the B = 1 shapes on its 255-bit r (the batch's shapes
     run BN254's 8-limb instantiations, held in phase 3), a quarter of the
     values within 2^8 of r; full sorted MSMs against the oracle over G1 and G2 of
     BLS12-381 and BLS12-377; setup (with h16_p128; the b2 query keeps
     its coordinates, packed on the card into rows of 144 words), 3 proofs
     verified, a tampered proof and a wrong public input rejected; the h
     MSM shared-bucket against dense, and its h16 suffix on a proof's own
     table and its h16 merge walk on the proof's own plan, as
     in phase 4, and its h16 mixed walk on two blocks of one sub-chunk of
     that plan (walk_blocks: its plain version takes 30-45 s for the whole
     walk at 12 limbs); then prove_batch, the matvec's
     steps and the h stage's peak allocation as in phase 5. The
     launch counts are also tallied by limb width: every MSM kernel
     launches at 12 limbs there, at no other width
  6b. GM17 on BLS12-381: the same program as a SAP (domain 2^16), setup,
     3 proofs, verify, the forgeries rejected, no plain version on the
     card, every MSM kernel at 12 limbs only and emul at 12 limbs (the
     pk's queries to Montgomery form over Fq); then emul (12 limbs over
     Fq, 8 over r) and the NTT at that prove's shapes against their
     plain versions
  7. (BLS12-377's toy proof is one of the CLI's toy matrix, phase 2b)
  8. GM17 path: the same sha256 circuit as a SAP (domain 2^16), setup
     with a seeded rng, 3 proofs with distinct fixed r through
     schemes/gm17.prove (the h stage on the NTT and emul kernels, the four
     MSMs through groth16's MSM entry points) with their stage split, each
     verified; a tampered proof (a <-> c) and a wrong public input are
     rejected; the launch counts (set to 0 before setup) of the walk,
     suffix, epilogue, NTT and emul kernels are above 0, and no plain
     version runs on the card in the h stage or the MSMs; then the
     kernels against their plain versions at that prove's shapes: the b
     query's Fq2 MSM (the walks, mixed-unsafe at (64, 32768) and general;
     the suffix and the epilogue over all 32 windows of the c = 8 MSM;
     the walks' plain versions on their first GM17_PLAIN_LANES lanes; its
     G1 MSMs run the Fq walks that phases 3-4 hold at Groth16's shapes),
     the NTT at (2, 2^16) and (1, 2^16) both ways, emul at the h stage's
     shapes and at the queries' conversion to Montgomery form
  9. the point kernels mixed_add_lm (N = 2^16) and accumulate_lm (16
     buckets, 16 steps, 2^14 lanes) on random inputs, against their plain
     versions from real curve points with every edge case (P at infinity, P == Q, P == -Q, digit 0, digits >=
     n_buckets, buckets hit several times); and the throughput probe: the
     card's rate of 32-bit IMAD and of 8-limb CIOS products
  10. Marlin: the universal setup of the CLI's default size (2^17 powers
     of tau, fixed-base on the card), the index of the stdlib's Pedersen-512
     circuit (port_artifacts/pedersen512_bn128.out.gz: |H| = 4,096, |K| =
     16,384) and 2 proofs of its witness for inputs [0, ..., 15] with a
     seeded prover rng, each verified, each split into its rounds
     (transforms, MSMs and host Python apart), a flipped evals_beta
     entry, a flipped t_beta and a wrong public output rejected; the
     launch counts set to 0 before the universal setup, the NTT, emul and
     MSM kernels launched by every proof, no plain version on the card and
     no Python scalar multiply of a G1 point over setup, index and proofs
     (MarlinGuard); one more proof under torch.profiler; then every walk,
     suffix and epilogue launch of two MSMs of the first proof (h2's
     commitment, padded to 2^17 points in the c = 8, M1 = 1024
     configuration, and a hiding commitment's 4-point MSM, M1 = 32)
     against its plain version, the NTT at (1, 2^17) both ways and at the
     index's (1, 2^14) inverse, emul at the (1, 2^17) one-row shape; and a
     BLS12-381 toy (the cube program, SRS of degree 64: setup, index, a
     proof that verifies, a forgery that does not, the MSM kernels at 12
     limbs only)
  11. Nova: a SHA-256 hash chain on Pallas
     (port_artifacts/sha256_chain_pallas.out.gz: the step u32[8] h ->
     sha256(h), 26,557 constraints) as a user's nova-setup / nova-prove /
     nova-prove --continue / nova-verify drive it: setup at full width
     (65,536 hash-to-curve bases, host Python, run in a child process
     started with the script, beside the earlier phases), 8 steps from
     SHA-256's initial hash value and 2 more resuming that proof, the final
     state against 10 rounds of hashlib.sha256, verify, the reference
     tests' three tamperings rejected; each step split into witness, cross
     term, commitments (the MSMs against their host preparation) and fold;
     the launch counts set to 0 just before the first prove, every MSM
     kernel and emul launched at 8 limbs only, no plain version on the
     card and no Python G1 scalar multiply but the folds' two (NovaGuard);
     one more step under torch.profiler (busy time, idle share, launches
     recorded against the wrappers'); then every walk, suffix and epilogue
     launch of the eighth step's two MSMs (com_w, com_t) against its plain
     version on its own inputs, the same kernels at com_t's shapes on
     random tables with coordinates near q over Pallas and Vesta Fq (no
     mixed-safe walk: msm_sorted_host runs it only after a collision), emul at Pasta
     q, a full sorted MSM against the oracle on both curves' G1; and
     compress / verify_compressed on the square step (z' = z*z + z) on
     Pallas and Vesta, two tamperings rejected
  12. the Groth16 phase-2 ceremony, as the CLI's mpc init / contribute /
     beacon / verify / export commands drive it (run_mpc_path): the bellman
     ceremony on BN254 sha256 (a phase1radix for its 2^15 domain generated
     on the card, the file written and read back byte-equal, initialize,
     a contribution and a beacon, mpc.params written and read back
     byte-equal, verify giving the two hashes, export, prove_batch of the
     16 witnesses with the exported key, every proof verified (verify_all),
     and four forgeries rejected: a tampered h point, a swapped delta_g1, a wrong
     cs_hash, a PublicKey with another r_delta); schemes/mpc on BLS12-381
     sha256 (init: mpc.from_keys on the BLS12-381 main path's key pair;
     a contribution and a beacon, verify, export, 3
     proofs that verify, a tampered h query rejected); the bellman
     ceremony on BLS12-381's cube toy (initialize, a contribution,
     verify, export, a proof that verifies: the bellman ceremony at 12
     limbs); each step timed. The launch counts
     are set to 0 just before and read after: mixed_add_lm (the
     contributions' and the terms' ladders) and accumulate_lm (the column
     sums) must launch at 8 and 12 limbs, no plain version may run on the
     card, and the Python G1/G2 scalar multiplies inside initialize,
     contribute and verify must be the contributions' named few
     (MpcGuard). Then 64 sampled points of every contribution against the
     host's k * P, 64 sampled columns of each accumulator of the BN254 and
     the toy initialize against the host's sums (their terms rebuilt from
     the r1cs and the radix; a column without terms must be None), and each point kernel's
     widest call at each width and stage against its plain version on the
     same inputs (bit-equal, timed, with its bound)
  13. BW6-761 recursion (run_bw6_path): Groth16 over BW6-761 on the
     stdlib's in-circuit BLS12-377 GM17 verifier
     (port_artifacts/snark_gm17_bw6_761.out.gz: 123,507 constraints,
     domain 2^17; its read, 4 witnesses by the port's interpreter and the
     generator's plan in a child process started with the script, beside
     the earlier phases): the 4 witnesses again by the card's generator on
     that plan (the host segment's SnarkVerifyBls12377 solver, then the
     check batch of 4.7M terms at 12 limbs), value for value, and one
     with a host-solved variable changed raising UnsatisfiedConstraint;
     setup, 3 proofs of the reference's test vector (output 1) with their
     stage split, each verified by the BW6-761 pairing, a proof with C
     swapped and one with its output flipped rejected; prove_batch of 4
     witnesses (the vector and three with an inner input changed: outputs
     1, 0, 0, 0), its proof 0 equal to the first proof byte for byte, all
     verified in one weighted pairing product and a false one caught; the
     launch counts set to 0 before setup and before the batch: the MSM
     kernels at 24 limbs only, emul, ereduce_wide, the NTT and mulacc_walk
     at 12 only, no plain version on the card; then every distinct walk,
     suffix and epilogue call of one proof against its plain version (the
     walks on their first 64 lanes), emul, ereduce_wide, the NTT and
     mulacc_walk at the prove's shapes (B = 1)
  13b. GM17 over BW6-761 on the same circuit at full size (its SAP of
     247,028 rows, domain 2^18): setup in a child process started with
     the script (bw6_gm17_setup_job: it reads the artifact for the
     recursion's host work too; run_all waits for it after the CLI phase,
     so that its plain products never run beside a timed kernel); the
     key's queries to Montgomery form (emul at 24 limbs over BW6-761's Fq:
     the a, c and h queries' 2^18 points and the b query's, G2 over Fq)
     and BW6_GM17_PROOFS proofs of witnesses 0 and 1 (outputs 1 and 0),
     each split into its stages, with the launch counts set to 0 just
     before: emul at 24 and 12 limbs, the NTT at 12, the MSM kernels at 24
     only, no plain version on the card (PlainGuard); each proof verified
     by the BW6-761 pairing, a tampered proof (a <-> c) and a wrong public
     input rejected; then emul (24 limbs at the queries' conversion, 12 at
     the h stage's shapes) and the NTT at 2^18 against their plain
     versions (its MSMs run the 24-limb walk, suffix and epilogue that
     phase 13 holds at Groth16's shapes)
  13c. a contribution to the recursion circuit's Groth16 key of phase 13
     (mpc.from_keys after that phase's proofs: contribute changes the key
     in place): contribute (one ladder over the h query's 2^17 rows and
     the l query's real rows, mixed_add_lm at 24 limbs; the doublings
     jec's plain products, timed apart), verify, a contribution whose
     published [s]G1 was changed rejected, export and a Groth16 proof of
     witness 0 with the exported key that verifies; the launch counts set
     to 0 just before: mixed_add_lm at 24 limbs, no plain version on the
     card and a contribution's named Python scalar multiplies only
     (MpcGuard); then MPC_SAMPLES sampled h and l rows against the host's
     s^-1 * P and the ladder's widest mixed_add_lm against its plain
     version
  14. the kernels JSON line (each check record with its width in 32-bit
     limbs and its curve; launches on every path: "launches" the main
     path's, for the point kernels the ceremony's; the Marlin path's also
     per proof, the Nova path's also per step; "launches_bw6_761" and
     "launches_bw6_761_batch" the recursion's; "launches_witness*" the
     witness generator's on each program; "launches_cli" the CLI batch's
     for rows 1-7 and the CLI ceremony's for the point kernels;
     "launches_gm17_bw6_761" and "launches_mpc_bw6_761" phases 13b and
     13c's), the
     witness generator's and the CLI's JSON lines, the nvidia-smi line,
     and the result line.

Exits non-zero on any failure; with no CUDA device it raises before
printing a result.

Kernel time bounds (bound_ms) are the larger of two times. Operations: the
Montgomery products these inputs need (a skipped position, or an add or a
doubling with a point at infinity, costs none; an Fq2 product is 3 Fq
products) times the 32-bit multiplies of one CIOS product at the kernel's
width n (n x n a*b and n x n m*p products, low and high halves, plus n
m = t0*n0: n(4n + 1), 264 at 8 limbs, 588 at 12, 2,328 at 24), over the H100 SXM's
32-bit integer multiply rate: 64 IMAD per SM per clock, half the float32
FMA rate behind its published 67 TFLOP/s, i.e. 16.75e12/s at 700 W.
The probe of phase 9 measures that rate; the constant stays the
derivation, with the measured ratio beside it in PERF.md.
Bytes: inputs read once and outputs written once, over 3.35 TB/s. Field
elements cross every kernel boundary as int64 words of 16-bit limbs (128 B
per element; 192 B over BW6-761's 377-bit r), point rows as int32 words
of 16-bit limbs (64 B per Fq coordinate on BN254, 96 B on the BLS12
curves, 192 B on BW6-761); the matvec walk's plan
holds its coefficients as 32-bit limbs (32 B a record) and int32 columns
and flags, and it writes the flushed runs only (mulacc_bytes).
"""

from __future__ import annotations

import io
import json
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
INT32_MUL_RATE = 16.75e12      # 32-bit multiplies / s, H100 SXM at 700 W
HBM_RATE = 3.35e12             # bytes / s, H100 SXM


def muls_per_mont(nl32: int) -> int:
    """32-bit multiplies of one CIOS product at nl32 32-bit limbs (field.cuh's
    mont_mul): per limb of a, nl32 products a_i*b_j and nl32 products m*p_j,
    low and high halves, and m = t_0*n0: 264 at 8 limbs, 588 at 12."""
    return nl32 * (4 * nl32 + 1)


MULS_PER_MONT = muls_per_mont(8)
FQ2_MULS = 3                   # Fq products per Fq2 product (Karatsuba)
MIXED_MULS, GENERAL_MULS = 11, 16  # Montgomery products per point add
DOUBLE_MULS = 7                # Montgomery products per doubling
ELEM_BYTES = 128               # one field element as 16 int64 words
SEED = 2024                    # inputs of the checks, setup randomness, r and s
NPROOFS = 3
BATCH = 16                     # witnesses per prove_batch, as bench.py
NBATCHES = 2                   # timed batches after the warm-up
GM17_PROOFS = 3
# lanes of the GM17 Fq2 MSM's walks held to their plain version (the kernel
# runs all 32768; the plain version of the whole walk took 7.0 s)
GM17_PLAIN_LANES = 4096
# kernel -> (its library, a key of kernels/cuda.SOURCES; the TPU kernel it replaces)
REPLACES = {
    "walk_mixed": ("zkt_msm", "zokrates_tpu/kernels/msm_sorted.py:140"),
    "walk_general": ("zkt_msm", "zokrates_tpu/kernels/msm_sorted.py:190"),
    "suffix": ("zkt_msm", "zokrates_tpu/kernels/msm_sorted.py:278"),
    "suffix_fold": ("zkt_msm", "zokrates_tpu/kernels/msm_sorted.py:366"),
    "emul": ("zkt_field", "zokrates_tpu/kernels/pallas_field.py:676"),
    "ereduce_wide": ("zkt_field", "zokrates_tpu/kernels/pallas_field.py:751"),
    "ntt": ("zkt_ntt", "zokrates_tpu/kernels/ntt_pallas.py:40"),
    "mulacc_walk": ("zkt_mulacc", "zokrates_tpu/kernels/pallas_field.py:808"),
    "mixed_add_lm": ("zkt_point", "zokrates_tpu/kernels/pallas_field.py:296"),
    "accumulate_lm": ("zkt_point", "zokrates_tpu/kernels/pallas_field.py:404"),
}
# the kernels every GM17 prove launches (no matvec walk, no lazy reduction)
GM17_KERNELS = ("walk_mixed", "walk_general", "suffix", "suffix_fold", "ntt", "emul")
# the variant whose time stands for each kernel in the kernels line: the
# one the main path launches on the most data (G1; the shared-bucket h
# MSM's walks, suffix and epilogue on a proof's own plan and table; the batch's coset product (48, 2^15) and the
# walk matvec's row sums at B = 16, the batch of 3 forward transforms, the
# batched matvec walk); for the point kernels, whose path is the
# ceremony's: a BN254 sha256 contribution's ladder step and initialize's
# column sums, on their own inputs
MAIN_VARIANT = {"walk_mixed": ("Fq", "mixed-safe h16 real"), "walk_general": ("Fq", "general h16 real"),
                "suffix": ("Fq", "fold=False h16 real"), "suffix_fold": ("Fq", "h16 MSM real"),
                "emul": ("Fr", "B=16 coset"), "ereduce_wide": ("Fr", "B=16 row sums"),
                "ntt": ("Fr", "forward x3"), "mulacc_walk": ("Fr", f"B={BATCH}"),
                "mixed_add_lm": ("Fq", "mpc contribution"), "accumulate_lm": ("Fq", "mpc column sums")}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


class Points:
    """A small pool of real curve points as limb rows (int32, 16-bit
    Montgomery limbs): affine [x|y] rows, and Jacobian [X|Y|Z] rows with
    random Z for the same points and their negatives (so the complete add
    meets doublings and cancellations), plus one point at infinity (Z = 0,
    X and Y arbitrary) as the last row. With `near` (G1), a quarter of the
    points have x within 2^8 of q (near_points) and a quarter of the
    Jacobian rows Z within 2^8 of q."""

    def __init__(self, ext: bool, rng: random.Random, n: int = 16, curve: str = "bn128", near: bool = False):
        import torch
        from zokrates_tpu_torch.ec.curve import g1_group, g2_group
        from zokrates_tpu_torch.ec.tower import Fq2
        from zokrates_tpu_torch.fields.jfield import field_ops
        from zokrates_tpu_torch.fields.jfield2 import field_ops2

        grp = g2_group(curve) if ext else g1_group(curve)
        q = grp.q
        self.q = q
        self.beta = grp.tower.beta - q if ext else None
        self.width = field_ops(q).nl // 2
        f = field_ops2(q, self.beta) if ext else field_ops(q)
        pts = near_points(grp, n // 4) if near else []
        pts += [grp.generator() * rng.randrange(1, grp.r) for _ in range(n - len(pts))]

        def coord(v):
            return (v.c0, v.c1) if ext else v

        def rows(vals):
            return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

        self.affine = torch.cat([rows([coord(p.x) for p in pts]), rows([coord(p.y) for p in pts])], 1)
        X, Y, Z = [], [], []
        for p in pts + [-p for p in pts]:
            if ext:
                z = Fq2(grp.tower, rng.randrange(1, q), rng.randrange(q))
                X.append(coord(p.x * z * z))
                Y.append(coord(p.y * z * z * z))
                Z.append(coord(z))
            else:
                z = q - rng.randrange(1, 1 << 8) if near and len(Z) % 4 == 0 else rng.randrange(1, q)
                X.append(p.x * z * z % q)
                Y.append(p.y * z * z * z % q)
                Z.append(z)
        X.append(coord(pts[0].x))
        Y.append(coord(pts[1].y))
        Z.append((0, 0) if ext else 0)
        self.jac = torch.cat([rows(X), rows(Y), rows(Z)], 1)
        self.inf_row = self.jac.shape[0] - 1


def near_points(grp, n: int):
    """n points of a G1 with x within 2^8 of q: x = q - k for the first k
    where x^3 + a x + b is a square."""
    from zokrates_tpu_torch.schemes.nova import _sqrt_mod

    q, out, k = grp.q, [], 1
    while len(out) < n:
        x = q - k
        y = _sqrt_mod(x * x % q * x + grp.a * x + grp.b, q)
        if y is not None:
            out.append(grp.point(x, y))
        k += 1
    if k > 1 << 8:
        raise AssertionError(f"{n} points with x near q need k up to {k}")
    return out


def walk_inputs(pool: Points, K: int, L: int, mode: str, nrng: np.random.Generator):
    """Walk rows (K, width, L), flags (K, L) and the infinity mask of the
    rows (general mode) from the pool; 10% skips, 25% flushes."""
    import torch

    src = pool.affine if mode == "mixed" else pool.jac
    hi = src.shape[0] if mode == "mixed" else src.shape[0] - 1
    idx = nrng.integers(0, hi, (K, L))
    if mode != "mixed":
        idx[nrng.random((K, L)) < 0.05] = pool.inf_row
    q = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    skip = nrng.random((K, L)) < 0.1
    flush = nrng.random((K, L)) < 0.25
    flags = flush.astype(np.int32) | (skip.astype(np.int32) << 1)
    qinf = idx == pool.inf_row if mode != "mixed" else np.zeros((K, L), bool)
    return q, torch.as_tensor(flags), qinf


def walk_launch(K: int, L: int):
    """The walk kernel's launch at (K, L): positions per sub-chunk S
    (msm_sorted.walk_split), sub-chunks per lane and threads (one per lane
    and sub-chunk); logged beside each walk shape."""
    from zokrates_tpu_torch.kernels.msm_sorted import walk_split

    S = walk_split(K, L)
    T = -(-K // S)
    log(f"    walk launch ({K}, {L}): S = {S}, {T} sub-chunk{'s' if T > 1 else ''} a lane, {T * L} threads")
    return {"S": S, "subchunks": T, "threads": T * L}


def suffix_launch(Lb: int, M: int):
    """The suffix kernel's launch at (Lb, M): sub-chunks a lane k
    (msm_sorted.suffix_split) and threads (one per lane and sub-chunk);
    logged beside each suffix shape."""
    from zokrates_tpu_torch.kernels.msm_sorted import suffix_split

    k = suffix_split(Lb, M)
    log(f"    suffix launch ({Lb}, {M}): k = {k}, {Lb // k} bucket{'s' if Lb // k > 1 else ''} a thread, "
        f"{k * M} threads")
    return {"k": k, "threads": k * M}


def walk_adds(flags: np.ndarray, qinf: np.ndarray) -> int:
    """Point adds the walk computes in full: positions not skipped whose
    accumulator and incoming point are both finite (an add with a point at
    infinity returns the other operand)."""
    K, L = flags.shape
    inf = np.ones(L, bool)
    n = 0
    for k in range(K):
        active = (flags[k] & 2) == 0
        n += int(np.count_nonzero(active & ~inf & ~qinf[k]))
        inf = np.where(active, inf & qinf[k], inf)
        inf |= (flags[k] & 1) != 0
    return n


def suffix_adds(ainf: np.ndarray, binf: np.ndarray) -> int:
    """Complete adds the suffix walk computes in full (three per bucket,
    each free when an operand is at infinity)."""
    Lb, M = ainf.shape
    acc_inf = np.ones(M, bool)
    tot_inf = np.ones(M, bool)
    n = 0
    for t in range(Lb):
        n += int(np.count_nonzero(~ainf[t] & ~binf[t]))
        t_inf = ainf[t] & binf[t]
        n += int(np.count_nonzero(~acc_inf & ~t_inf))
        acc_inf = acc_inf & t_inf
        n += int(np.count_nonzero(~tot_inf & ~acc_inf))
        tot_inf = tot_inf & acc_inf
    return n


def bound(mults: int, nbytes: int, width: int = 8):
    """(bound_ms, bound_by) for `mults` Montgomery products at `width` 32-bit
    limbs and `nbytes` of inputs and outputs."""
    t_ops = mults * muls_per_mont(width) / INT32_MUL_RATE
    t_bytes = nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`, whose launches never wait for the card:
    CUDA events around `reps` calls that the host enqueues behind a spin
    kernel (torch.cuda._sleep), so the card runs them back to back and the
    wrappers' host time (ctypes, allocation) stays out of the reading. The
    spin is lengthened until it outlasts the host's enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 24
    while True:
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        for _ in range(reps):
            fn()
        ev[2].record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        if cycles >= 1 << 34:
            raise RuntimeError(f"cuda_ms: enqueueing {reps} calls took {host:.1f} ms on the host")
        cycles *= 4


def host_ms(fn):
    """(result, wall ms) of one call that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _record(name, field, mode, shape, got, want, ms_k, ms_p, mults, nbytes, width=8, curve="bn128"):
    import torch

    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    bms, by = bound(mults, nbytes, width)
    rec = dict(field=field, mode=mode, shape=list(shape), width=width, curve=curve, equal=equal,
               max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bms, bound_by=by)
    log(f"  {name:12s} {mode:13s} {field:3s} {width:2d} limbs {str(tuple(shape)):18s}: bit-equal={equal} "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.1f} ms, bound {bms:.4f} ms ({by})")
    if not equal:
        raise AssertionError(f"{name} {mode} over {field} differs from its plain version")
    return rec


def check_kernels(shapes, dev, tag: str = "", seed: int = SEED, curve: str = "bn128", near: bool = False,
                  safe_mixed: bool = True, plain_lanes: int = 0):
    """Every kernel variant vs its plain version on `dev`, bit for bit, at
    a path's shapes (main_path_shapes, gm17_shapes or nova_shapes) over the
    curve's Fq and Fq2 (8 32-bit limbs on BN254 and the Pasta curves, 12 on
    the BLS12 curves; Fq alone where shapes has no "fq2"), `tag` appended
    to the walk and suffix labels, `near`: the G1 pool's coordinates near q
    (Points). safe_mixed=False leaves out the mixed-safe walk at the dense
    MSM's shape: msm_sorted_host (GM17's and Nova's MSMs) runs it only
    again after a collision, and it is held at the Groth16 paths' shapes.
    plain_lanes > 0: each walk runs on the card at its whole shape and its
    plain version on the first plain_lanes lanes only (a lane's walk is
    its own); the kernel time and the bound stay the whole call's.
    Returns the per-kernel check records for the kernels JSON line."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted as ms

    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    records = {"walk_mixed": [], "walk_general": [], "suffix": [], "suffix_fold": []}
    for ext in [ext for ext in (False, True) if ("fq2" if ext else "fq") in shapes]:
        pool = Points(ext, rng, curve=curve, near=near and not ext)
        q, beta, width = pool.q, pool.beta, pool.width
        fname = "Fq2" if ext else "Fq"
        fm = FQ2_MULS if ext else 1
        sh = shapes["fq2" if ext else "fq"]
        variants = [(mode, safe, tag, sh) for mode, safe in
                    (("mixed", False), ("mixed", True), ("general", True)) if safe_mixed or mode != "mixed" or not safe]
        extra = sh.get("extra", {})  # the h16 and a/b1/l MSMs' walks (safe, as the prove)
        for vtag, shp in extra.items():
            variants += [("mixed", True, vtag, shp), ("general", True, vtag, shp)]
        for mode, safe, vtag, shp in variants:
            K, L = shp["walk_" + mode]
            qrows, flags, qinf = walk_inputs(pool, K, L, mode, nrng)
            qd, fd = qrows.to(dev), flags.to(dev)
            out = ms.walk(qd, fd, q, mode, safe, beta)
            torch.cuda.synchronize()
            lanes = plain_lanes if 0 < plain_lanes < L else L
            qs, fs = qd[..., :lanes].contiguous(), fd[:, :lanes].contiguous()
            ref, ms_p = host_ms(lambda: ms.walk_plain(qs, fs, q, mode, safe, beta))
            got = tuple(t[..., :lanes] for t in out)
            ms_k = cuda_ms(lambda: ms.walk(qd, fd, q, mode, safe, beta))
            per_add = MIXED_MULS if mode == "mixed" else GENERAL_MULS
            mults = walk_adds(flags.numpy(), qinf) * per_add * fm
            nbytes = 4 * (qrows.numel() + flags.numel() + sum(t.numel() for t in out))
            label = ("general" if mode == "general" else mode + ("-safe" if safe else "-unsafe")) + vtag
            rec = _record("walk", fname, label, (K, L), got, ref, ms_k, ms_p, mults, nbytes, width, curve)
            if lanes < L:
                rec["plain_lanes"] = lanes
                log(f"    plain version on the first {lanes} of the call's {L} lanes")
            rec["collisions"] = int(out[1].sum())
            rec.update(walk_launch(K, L))
            records["walk_" + mode].append(rec)

        for stag, shp in [(tag, sh)] + list(extra.items()):
            Lb, M = shp["suffix"]
            ia = nrng.integers(0, pool.jac.shape[0], (Lb, M))
            ib = nrng.integers(0, pool.jac.shape[0], (Lb, M))
            A = pool.jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous().to(dev)
            B = pool.jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous().to(dev)
            out = ms.suffix(A, B, q, beta)
            torch.cuda.synchronize()
            ref, ms_p = host_ms(lambda: ms.suffix_plain(A, B, q, beta))
            ms_k = cuda_ms(lambda: ms.suffix(A, B, q, beta))
            mults = suffix_adds(ia == pool.inf_row, ib == pool.inf_row) * GENERAL_MULS * fm
            nbytes = 4 * (A.numel() + B.numel() + out.numel())
            rec = _record("suffix", fname, "fold=False" + stag, (Lb, M), (out,), (ref,), ms_k, ms_p, mults, nbytes,
                          width, curve)
            rec.update(suffix_launch(Lb, M))
            records["suffix"].append(rec)

        for label, (G, lw, L) in sh["fold"].items():
            label += tag if curve != "bn128" else ""
            inf = pool.inf_row
            idx = nrng.integers(0, inf, (2, G * lw))
            idx[nrng.random((2, G * lw)) < 0.1] = inf
            out6 = torch.cat([pool.jac[torch.as_tensor(idx[0])], pool.jac[torch.as_tensor(idx[1])]],
                             1).T.contiguous().to(dev)
            out = ms.suffix_fold(out6, q, G, lw, L, beta)
            torch.cuda.synchronize()
            ref, ms_p = host_ms(lambda: ms.suffix_fold_plain(out6, q, G, lw, L, beta))
            ms_k = cuda_ms(lambda: ms.suffix_fold(out6, q, G, lw, L, beta))
            mults = fold_mults(idx[0] == inf, idx[1] == inf, G, lw, L) * fm
            nbytes = 4 * out6.numel() + 8 * sum(t.numel() for t in out)
            records["suffix_fold"].append(
                _record("suffix_fold", fname, label, (G, lw, L), out, ref, ms_k, ms_p, mults, nbytes, width,
                        curve))
    return records


def fold_mults(ainf: np.ndarray, tinf: np.ndarray, G: int, lw: int, L: int) -> int:
    """Montgomery products the suffix epilogue computes for these lanes
    (acc, tot at infinity where ainf, tinf): the ladder's adds and the
    doublings of acc below base's top bit, the lane add and the tree's
    adds, an add or a doubling with a point at infinity costing none."""
    n = 0
    lane_inf = np.empty(G * lw, bool)
    for m in range(G * lw):
        base = (lw - 1 - m % lw) * L
        res_inf, k = True, 0
        while base >> k:
            if (base >> k) & 1:
                n += GENERAL_MULS * (not res_inf and not ainf[m])
                res_inf = res_inf and ainf[m]
            if base >> (k + 1):
                n += DOUBLE_MULS * (not ainf[m])
            k += 1
        n += GENERAL_MULS * (not res_inf and not tinf[m])
        lane_inf[m] = res_inf and tinf[m]
    P = lane_inf.reshape(G, lw)
    while P.shape[1] > 1:
        s = P.shape[1] // 2
        n += GENERAL_MULS * int(np.count_nonzero(~P[:, :s] & ~P[:, s:]))
        P = P[:, :s] & P[:, s:]
    return n


def nl_of(p: int) -> int:
    """16-bit limbs of an element mod p: 16 for the 254/255-bit fields, 24
    for the BLS12 base fields."""
    from zokrates_tpu_torch.fields.limbs import n_limbs

    return n_limbs(p)


def fr_elems(shape, nrng: np.random.Generator, p: int, near: float = 0.0):
    """Canonical residues mod p as (..., nl) int64 16-bit limbs: random low
    limbs and a top limb below p's; a share `near` of them within 2^8 of p
    instead."""
    import torch

    nl = nl_of(p)
    x = nrng.integers(0, 1 << 16, tuple(shape) + (nl,), dtype=np.int64)
    x[..., -1] = nrng.integers(0, p >> (16 * nl - 16), tuple(shape))
    if near:
        sel = nrng.random(tuple(shape)) < near
        k = nrng.integers(1, 1 << 8, int(sel.sum()))
        table = np.asarray([[((p - v) >> (16 * i)) & 0xFFFF for i in range(nl)] for v in range(1 << 8)], np.int64)
        x[sel] = table[k]  # p - k's limbs
    return torch.as_tensor(x)


def check_field_kernels(fr, dev, seed: int = SEED + 2, curve: str = "bn128", tag: str = "", near: float = 0.0):
    """emul, ereduce_wide and the NTT against their plain versions at a
    path's shapes (fr: the "fr" entry of main_path_shapes or gm17_shapes)
    over the curve's fields, `tag` appended to the labels, a share `near`
    of the elements within 2^8 of the modulus: emul cases (label, field
    "Fr" or "Fq", batch, elements, b: "shared" (L, nl), "full" (B, L, nl),
    "row" (stride 0) or "strided" (a and b the [:, 0] and [:, 1] slices of
    a (B, 3, L, nl) tensor, as the h stage's A*B)), at 8 32-bit limbs or,
    over a BLS12 base field, 12; ereduce_wide cases (label, batch,
    elements) and the NTT's size with its cases (label, batch, inverse)."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import ntt_pallas as nk
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.kernels.ntt import domain_for_curve

    p = P.SCALAR_FIELDS[curve].p
    moduli = {"Fr": p, "Fq": P.BASE_FIELDS[curve].p}
    nrng = np.random.default_rng(seed)
    records = {"emul": [], "ereduce_wide": [], "ntt": []}
    for label, fname, B, L, kind in fr["emul"]:
        m = moduli[fname]
        nl = nl_of(m)
        label += tag
        if kind == "strided":
            abc = fr_elems((B, 3, L), nrng, m, near).to(dev)
            a, b = abc[:, 0], abc[:, 1]
        else:
            a = fr_elems((B, L), nrng, m, near).to(dev)
            b = {"shared": lambda: fr_elems((L,), nrng, m, near),
                 "full": lambda: fr_elems((B, L), nrng, m, near),
                 "row": lambda: fr_elems((), nrng, m, near).expand(L, nl)}[kind]().to(dev)
        out = pf.emul(m, a, b)
        torch.cuda.synchronize()
        ref, ms_p = host_ms(lambda: pf.emul_plain(m, a, b))
        ms_k = cuda_ms(lambda: pf.emul(m, a, b))
        b_elems = {"shared": L, "full": B * L, "strided": B * L, "row": 1}[kind]
        nbytes = ELEM_BYTES * nl // 16 * (2 * B * L + b_elems)
        rec = _record("emul", fname, label, (B, L), (out,), (ref,), ms_k, ms_p, B * L, nbytes, nl // 2, curve)
        rec["b"] = kind
        records["emul"].append(rec)
        del a, b, out, ref
    nlr = nl_of(p)  # Fr's 16-bit limbs: 16, or 24 for BW6-761's 377-bit r
    for label, B, L in fr["ereduce_wide"]:
        label += tag
        t = torch.as_tensor(nrng.integers(0, 1 << 31, (B, L, nlr), dtype=np.int64)).to(dev)
        out = pf.ereduce_wide(p, t)
        torch.cuda.synchronize()
        ref, ms_p = host_ms(lambda: pf.ereduce_wide_plain(p, t))
        ms_k = cuda_ms(lambda: pf.ereduce_wide(p, t))
        records["ereduce_wide"].append(_record("ereduce_wide", "Fr", label, (B, L), (out,), (ref,),
                                               ms_k, ms_p, 2 * B * L, 2 * ELEM_BYTES * nlr // 16 * B * L,
                                               nlr // 2, curve))
    n, ntt_cases = fr.get("ntt", (0, []))
    dom = domain_for_curve(curve, n) if ntt_cases else None
    for label, B, inverse in ntt_cases:
        label += tag
        x = fr_elems((B, n), nrng, p, near).to(dev)
        out = nk.fft_core(dom, x, inverse)
        torch.cuda.synchronize()
        ref, ms_p = host_ms(lambda: nk.fft_core_plain(dom, x, inverse))
        ms_k = cuda_ms(lambda: nk.fft_core(dom, x, inverse))
        mults = B * (n // 2) * dom.k
        nbytes = 2 * ELEM_BYTES * nlr // 16 * B * n + 2 * nlr * (n - 1)
        records["ntt"].append(_record("ntt", "Fr", label, (B, n), (out,), (ref,), ms_k, ms_p,
                                      mults, nbytes, nlr // 2, curve))
    return records


def path_walks(rdev, batches=(1, BATCH)):
    """The walk plans of the h stage's matvec on this R1CSDevice:
    {B: plan} for B = 1 (prove) and BATCH (prove_batch), or the given
    batch sizes, at the lanes groth16.walk_lanes picks."""
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk
    from zokrates_tpu_torch.schemes import groth16 as g

    L = sum(mat.rows_np.size for mat in (rdev.A, rdev.B, rdev.C))
    return {B: build_mulacc_walk(rdev, g.walk_lanes(B, L)) for B in batches}


def mulacc_bytes(w, B: int, m: int, runs: int, nl: int = 16) -> int:
    """Bytes the function of mulacc_walk must move on plan w for B proofs
    of m variables of nl 16-bit limbs, each read or written once: z (8*nl
    B a variable and proof: 128 at 16 limbs), each real record's packed
    coefficient (2*nl B), column and flag (4 B each), and the lazy sums of
    `runs` runs of the 3n rows (8*nl B a run and proof). The plan's
    padded records and the slots of their runs and of the padding are
    layout, not work, and are not counted."""
    elem = 8 * nl
    return elem * B * m + (2 * nl + 4 + 4) * w.n_records + elem * B * runs


def check_mulacc(rdev, dev, curve: str = "bn128", tag: str = "", near: float = 0.0, batches=(1, BATCH),
                 reference: bool = True):
    """mulacc_walk against its plain version, bit for bit, on the circuit's
    walk plans: at B = 1 (prove) and B = 16 (prove_batch; or `batches`),
    each at the lanes the path takes (path_walks) and, with `reference`,
    at the reference's 1024, with
    seeded canonical z mod the curve's r (a share `near` within 2^8 of r).
    Bound: one product a real record and proof; bytes as mulacc_bytes,
    with the runs of the 3n rows of whichever layout has fewer, the path's
    or the reference's (the same bound at every lane count)."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.ir.r1cs_device import REFERENCE_LANES, build_mulacc_walk
    from zokrates_tpu_torch.kernels import pallas_field as pf

    p = P.SCALAR_FIELDS[curve].p
    nl = nl_of(p)
    m = rdev.num_variables
    nrng = np.random.default_rng(SEED + 3)
    records = []
    w_ref = build_mulacc_walk(rdev, REFERENCE_LANES)
    for B, w_path in path_walks(rdev, batches).items():
        z = fr_elems((B, m), nrng, p, near).to(dev)
        for w in [w_path] + ([w_ref] if reference and w_ref.M != w_path.M else []):
            label = f"B={B}" + ("" if w is w_path else f" {w.M} lanes") + tag
            out = pf.mulacc_walk(p, z, w)
            torch.cuda.synchronize()
            # the plain version's products of a proof are its own: it runs
            # on as many proofs at a time as keep its temporaries below 2^30
            # limb words (sha256's B = 16 in one call; BW6-761's 4.7M
            # records one proof at a time)
            per = max(1, (1 << 30) // (w.n_records * nl * 8))
            ref, ms_p = host_ms(lambda: torch.cat([pf.mulacc_walk_plain(p, z[b:b + per], w)
                                                   for b in range(0, B, per)]))
            ms_k = cuda_ms(lambda: pf.mulacc_walk(p, z, w))
            runs = min(w_path.n_row_flush, w_ref.n_row_flush)
            rec = _record("mulacc_walk", "Fr", label, (B, w.K, w.M), (out,), (ref,), ms_k, ms_p,
                          B * w.n_records, mulacc_bytes(w, B, m, runs, nl), nl // 2, curve)
            rec.update(lanes=w.M, slots=w.pos.numel(), n_flush=w.n_flush)
            records.append(rec)
            del out, ref
        del z
    return {"mulacc_walk": records}


def matvec_steps(p, rdev, Z, reps: int = 5):
    """Median ms of each step of groth16._matvec_walk over `reps` runs of
    its steps, replayed here between CUDA events (host gaps between the
    steps' launches included): mulacc_walk (the pack and the walk), the
    reduction of the slots, the row sums, the reduction of the rows."""
    import torch
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.schemes import groth16 as g

    B, _, nl = Z.shape
    L = sum(mat.rows_np.size for mat in (rdev.A, rdev.B, rdev.C))
    w = build_mulacc_walk(rdev, g.walk_lanes(B, L))
    names = ("mulacc", "ereduce snap", "index_add", "ereduce rows")
    runs = []
    for _ in range(reps):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        evs[0].record()
        snap = pf.mulacc_walk(p, Z, w)
        evs[1].record()
        part = pf.ereduce_wide(p, snap)
        del snap
        evs[2].record()
        sums = torch.zeros((B, w.n_rows, nl), dtype=torch.int64, device=Z.device)
        sums.index_add_(1, w.seg[: w.n_row_flush], part[:, : w.n_row_flush])
        evs[3].record()
        pf.ereduce_wide(p, sums)
        evs[4].record()
        torch.cuda.synchronize()
        runs.append([evs[i].elapsed_time(evs[i + 1]) for i in range(len(names))])
    return {name: float(np.median([r[i] for r in runs])) for i, name in enumerate(names)}


def log_matvec(r1cs, dev, curve: str):
    """groth16._matvec_walk at B = 1 and BATCH on random canonical z: its
    device time (cuda_ms) and its steps (matvec_steps); then the peak
    allocation of one B = BATCH groth16._h_stage above what was allocated
    before it."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes import groth16 as g

    p = P.SCALAR_FIELDS[curve].p
    n = 1 << (r1cs.num_constraints + r1cs.num_instance - 1).bit_length()
    rdev = g._r1cs_device(r1cs, n, dev)
    nrng = np.random.default_rng(SEED + 4)
    for B, w in path_walks(rdev).items():
        Z = fr_elems((B, r1cs.num_variables), nrng, p).to(dev)
        ms = cuda_ms(lambda: g._matvec_walk(p, rdev, Z))
        parts = matvec_steps(p, rdev, Z)
        log(f"  _matvec_walk {curve} B={B} ({w.M} lanes, K={w.K}, {w.pos.numel()} slots): {ms:.4f} ms; steps: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms")
        if B == BATCH:
            g._h_stage(curve, rdev, Z)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            g._h_stage(curve, rdev, Z)
            torch.cuda.synchronize()
            log(f"  _h_stage {curve} B={B}: peak allocation {(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB "
                f"above the {base / 1e9:.3f} GB before it")
        del Z


def check_msm_oracle(dev, N: int = 8192, curve: str = "bn128", g2: bool = True):
    """Full sorted MSM on the card (plans, walks, merges, suffix, host
    combine) over the curve's G1 and (with `g2`) G2 against the Python-int
    oracle: points k_i*G, so the MSM is (sum k_i s_i) * G."""
    import torch
    from zokrates_tpu_torch.ec.curve import g1_group, g2_group
    from zokrates_tpu_torch.ec.tower import Fq2
    from zokrates_tpu_torch.fields.jfield import field_ops
    from zokrates_tpu_torch.fields.jfield2 import field_ops2
    from zokrates_tpu_torch.fields.limbs import ints_to_limbs
    from zokrates_tpu_torch.kernels.msm_sorted import msm_sorted_host, pack_points, pack_points_g2

    rng = random.Random(SEED + 1)
    for ext in (False, True) if g2 else (False,):
        grp = g2_group(curve) if ext else g1_group(curve)
        q, r = grp.q, grp.r
        beta = grp.tower.beta - q if ext else None
        base = [grp.generator() * rng.randrange(1, r) for _ in range(8)]
        ks = [rng.randrange(8) for _ in range(N)]
        pts = [base[k] for k in ks]
        sc = [rng.randrange(r) if i % 3 else rng.randrange(4) for i in range(N)]
        if ext:
            f = field_ops2(q, beta)
            P128 = pack_points_g2(q, f.encode([(p.x.c0, p.x.c1) for p in pts]),
                                  f.encode([(p.y.c0, p.y.c1) for p in pts]))
        else:
            f = field_ops(q)
            P128 = pack_points(q, f.encode([p.x for p in pts]), f.encode([p.y for p in pts]))
        S = torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64))
        t0 = time.perf_counter()
        jx, jy, jz = msm_sorted_host(q, r, P128.to(dev), S.to(dev), beta=beta)
        dt = time.perf_counter() - t0
        want = grp.zero()
        for k in range(8):
            want = want + base[k] * (sum(s for kk, s in zip(ks, sc) if kk == k) % r)
        if ext:
            zi = Fq2(grp.tower, *jz).inv()
            got = (Fq2(grp.tower, *jx) * zi * zi, Fq2(grp.tower, *jy) * zi * zi * zi)
        else:
            zi = pow(jz, -1, q)
            got = (jx * zi * zi % q, jy * zi ** 3 % q)
        ok = got == (want.x, want.y)
        log(f"  sorted MSM {curve} {'G2' if ext else 'G1'} N={N} ({P128.shape[1]}-word rows) on the card vs "
            f"oracle: equal={ok} ({dt:.2f} s)")
        if not ok:
            raise AssertionError("sorted MSM disagrees with the Python-int oracle")


def check_point_kernels(dev):
    """mixed_add_lm and accumulate_lm against their plain versions, bit for
    bit, from real G1 points k_j*G and their negatives. mixed_add_lm: P at
    infinity, P == Q, P == -Q and other pairs; accumulate_lm: digits 0 and
    >= n_buckets (up to 0xFFFFFFFF), buckets hit several times, repeated
    (doubling) and negated (cancelling) points. Bounds: 11 products a mixed
    add (a doubling too: 4 before its branch, 7 in it), none where P, the
    bucket, is at infinity; bytes 64 per coordinate row, 4 per digit."""
    import torch
    from zokrates_tpu_torch.ec.curve import g1_group
    from zokrates_tpu_torch.fields.jfield import field_ops
    from zokrates_tpu_torch.kernels import pallas_field as pf

    N, R, n_buckets, chunk_len = 1 << 16, 1 << 14, 16, 16
    grp = g1_group("bn128")
    q = grp.q
    f = field_ops(q)
    rng = random.Random(SEED + 4)
    nrng = np.random.default_rng(SEED + 4)
    npts = 16
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(npts)]
    pool = pts + [-pt for pt in pts]  # pool[j + npts] = -pool[j]
    PX = f.encode([pt.x for pt in pool], device=dev)
    PY = f.encode([pt.y for pt in pool], device=dev)

    def lm(t):  # (..., L, nl) int64 -> (..., nl, L) int32 limb-major rows
        return t.transpose(-1, -2).to(torch.int32).contiguous()

    # mixed_add_lm: kind 0 any P, 1 P at infinity, 2 P == Q, 3 P == -Q
    qi = nrng.integers(0, 2 * npts, N)
    kind = nrng.choice(4, N, p=[0.8, 0.05, 0.075, 0.075])
    pi = np.where(kind == 2, qi, np.where(kind == 3, (qi + npts) % (2 * npts), nrng.integers(0, 2 * npts, N)))
    X, Y, Z = [], [], []
    for i in range(N):
        if kind[i] == 1:
            X.append(rng.randrange(q))
            Y.append(rng.randrange(q))
            Z.append(0)
            continue
        pt, z = pool[pi[i]], rng.randrange(1, q)
        X.append(pt.x * z * z % q)
        Y.append(pt.y * z * z % q * z % q)
        Z.append(z)
    qt = torch.as_tensor(qi, device=dev)
    args = (lm(f.encode(X, device=dev)), lm(f.encode(Y, device=dev)), lm(f.encode(Z, device=dev)),
            lm(PX[qt]), lm(PY[qt]))
    out = pf.mixed_add_lm(q, *args)
    torch.cuda.synchronize()
    ref, ms_p = host_ms(lambda: pf.mixed_add_lm_plain(q, *args))
    ms_k = cuda_ms(lambda: pf.mixed_add_lm(q, *args))
    same_x = pi % npts == qi % npts
    cases = {"P at infinity": int(np.count_nonzero(kind == 1)),
             "P == Q": int(np.count_nonzero((kind != 1) & (pi == qi))),
             "P == -Q": int(np.count_nonzero((kind != 1) & same_x & (pi != qi))),
             "Z = 0 out": int((out[2] == 0).all(0).sum())}
    log(f"  mixed_add_lm cases: {cases}")
    if min(cases.values()) == 0 or cases["Z = 0 out"] != cases["P == -Q"]:
        raise AssertionError(f"mixed_add_lm inputs miss an edge case: {cases}")
    rec_m = _record("mixed_add_lm", "Fq", "N=2^16", (16, N), out, ref, ms_k, ms_p,
                    MIXED_MULS * int(np.count_nonzero(kind != 1)), 8 * 64 * N)
    rec_m["cases"] = cases
    del args, out, ref

    # accumulate_lm
    digits = nrng.integers(0, n_buckets + 4, (chunk_len, R)).astype(np.int64)
    qidx = nrng.integers(0, 2 * npts, (chunk_len, R))
    digits[:4, 0], qidx[:4, 0] = 1, [0, 0, npts, 0]             # P, P (doubles), -P, P
    digits[:2, 1], qidx[:2, 1] = 2, [3, 3 + npts]               # P, -P (cancels)
    digits[:, 2] = [0, n_buckets, 0x7FFFFFFF, 0xFFFFFFFF] * (chunk_len // 4)  # touch nothing
    cnt = np.zeros((R, n_buckets, npts), np.int16)  # bucket = sum_j cnt_j * k_j * G
    lanes = np.arange(R)
    mults, stats = 0, {"digit 0": int(np.count_nonzero(digits == 0)),
                       "digit >= n_buckets": int(np.count_nonzero(digits >= n_buckets)),
                       "doublings": 0, "cancels": 0}
    for t in range(chunk_len):
        d = digits[t]
        hit = (d >= 1) & (d < n_buckets)
        L, b = lanes[hit], d[hit]
        j, sgn = qidx[t, hit] % npts, np.where(qidx[t, hit] < npts, 1, -1)
        before = cnt[L, b]
        single = np.abs(before).sum(-1) == 1
        stats["doublings"] += int(np.count_nonzero(single & (before[np.arange(len(L)), j] == sgn)))
        stats["cancels"] += int(np.count_nonzero(single & (before[np.arange(len(L)), j] == -sgn)))
        mults += MIXED_MULS * int(np.count_nonzero(before.any(-1)))
        cnt[L, b, j] += sgn.astype(np.int16)
    stats["buckets hit twice or more"] = int(np.count_nonzero(
        np.stack([(digits == b).sum(0) for b in range(1, n_buckets)]) >= 2))
    log(f"  accumulate_lm cases: {stats}")
    if min(stats.values()) == 0:
        raise AssertionError(f"accumulate_lm inputs miss an edge case: {stats}")
    qt = torch.as_tensor(qidx, device=dev)
    dg = torch.as_tensor(digits.astype(np.uint32).view(np.int32), device=dev)
    aq = (dg, lm(PX[qt]).reshape(chunk_len * 16, R), lm(PY[qt]).reshape(chunk_len * 16, R))
    out = pf.accumulate_lm(q, *aq, n_buckets=n_buckets)
    torch.cuda.synchronize()
    ref, ms_p = host_ms(lambda: pf.accumulate_lm_plain(q, *aq, n_buckets=n_buckets))
    ms_k = cuda_ms(lambda: pf.accumulate_lm(q, *aq, n_buckets=n_buckets))
    nbytes = 4 * chunk_len * R + 2 * 64 * chunk_len * R + 3 * 64 * n_buckets * R
    rec_a = _record("accumulate_lm", "Fq", "16x16, 2^14 lanes", (n_buckets, chunk_len, R), out, ref,
                    ms_k, ms_p, mults, nbytes)
    rec_a["cases"] = stats
    return {"mixed_add_lm": [rec_m], "accumulate_lm": [rec_a]}


def probe_rates(dev):
    """The card's rate of 32-bit IMAD and of 8-limb CIOS products (field.cuh's
    mul), from saturating kernels of their own (csrc/probe.cu): 8 blocks of
    256 threads per SM, CUDA events around 3 launches after a warm-up.
    Returns the rates, their ratios to INT32_MUL_RATE (a CIOS product
    counted as MULS_PER_MONT multiplies) and each launch's bound, its
    multiplies over INT32_MUL_RATE."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = 8 * sms
    threads = 256 * blocks
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, pl, one, n0, _ = cuda.field_params(P.BASE_FIELDS["bn128"].p, None, cuda.NL32_FIELD)

    def seconds(launch, reps=3):
        cuda.check(launch(), "probe")
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            cuda.check(launch(), "probe")
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps / 1e3

    imad_iters, mont_iters = 8192, 512
    t_imad = seconds(lambda: lib.zkt_probe_imad(out.data_ptr(), blocks, imad_iters, 0x9E3779B9, stream))
    t_mont = seconds(lambda: lib.zkt_probe_mont(out.data_ptr(), blocks, mont_iters, pl, one, n0, stream))
    imad = threads * imad_iters * 128 / t_imad
    cios = threads * mont_iters * 4 / t_mont
    res = {"imad_per_s": imad, "imad_ratio": imad / INT32_MUL_RATE, "imad_ms": t_imad * 1e3,
           "imad_bound_ms": threads * imad_iters * 128 / INT32_MUL_RATE * 1e3,
           "cios_per_s": cios, "cios_mults_per_s": cios * MULS_PER_MONT,
           "cios_ratio": cios * MULS_PER_MONT / INT32_MUL_RATE, "cios_ms": t_mont * 1e3,
           "cios_bound_ms": threads * mont_iters * 4 * MULS_PER_MONT / INT32_MUL_RATE * 1e3,
           "sms": sms, "blocks": blocks}
    log(f"  32-bit IMAD: {imad:.4e}/s ({res['imad_ratio']:.4f} x the bound's {INT32_MUL_RATE:.4e}); "
        f"CIOS products: {cios:.4e}/s = {res['cios_mults_per_s']:.4e} multiplies/s at {MULS_PER_MONT} "
        f"a product ({res['cios_ratio']:.4f} x); {sms} SMs, {blocks} blocks of 256")
    print(json.dumps({"probe": res}), flush=True)
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def load_sha256():
    from zokrates_tpu_torch.fields.field import FIELDS
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize
    from zokrates_tpu_torch.ir.witness import Witness

    art = os.path.join(ROOT, "bench_artifacts")
    with open(os.path.join(art, "sha256.out"), "rb") as f:
        prog = deserialize(f.read())
    r1cs = r1cs_from_prog(prog)
    with open(os.path.join(art, "sha256.witness"), "rb") as f:
        wit = Witness.read(f, FIELDS["bn128"])
    return prog, r1cs, wit


def load_sha256_bls12_381():
    """The sha256 program compiled for bls12_381
    (port_artifacts/sha256_bls12_381.out.gz, read with gzip) and its R1CS."""
    import gzip

    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(os.path.join(ROOT, "port_artifacts", "sha256_bls12_381.out.gz"), "rb") as f:
        prog = deserialize(f.read())
    return prog, r1cs_from_prog(prog)


def sha256_inputs(prog, count: int = BATCH):
    """`count` distinct flat sha256 inputs as bench.py makes them: preimage
    [16b, ..., 16b + 15] through the ABI (bench_artifacts/sha256.abi.json)
    over the program's curve."""
    from zokrates_tpu_torch.abi import encode_inputs
    from zokrates_tpu_torch.fields.field import FIELDS

    with open(os.path.join(ROOT, "bench_artifacts", "sha256.abi.json")) as f:
        abi = json.load(f)
    P = FIELDS[prog.curve].P
    return [encode_inputs([[[b * 16 + j for j in range(16)]]], abi["inputs"], P) for b in range(count)]


def round_trip(prog, wits):
    """Each witness written in the binary witness format and read back."""
    from zokrates_tpu_torch.fields.field import FIELDS
    from zokrates_tpu_torch.ir.witness import Witness

    field = FIELDS[prog.curve]
    out = []
    for w in wits:
        buf = io.BytesIO()
        w.write(buf, field)
        out.append(Witness.read(io.BytesIO(buf.getvalue()), field))
    return out


def field_launches():
    from zokrates_tpu_torch.kernels import pallas_field

    return {k: pallas_field.LAUNCHES.get(k, 0) for k in ("emul", "ereduce_wide")}


def card_witnesses(prog, flats, label: str, vi=None, calls=None):
    """Witnesses of `prog` for the flat inputs `flats` by the levelized
    generator on the card (VectorizedInterpreter(device="cuda").execute,
    interp/vectorized.py) under a WitnessGuard: the plan's build, the first
    call (each segment run eagerly, then captured into a CUDA graph) and
    the later calls (replays) timed, emul and ereduce_wide launches counted
    per witness (the replays' included) and the graph replays. `vi` may
    hold an adopted plan. Returns (witnesses, stats)."""
    import torch
    from zokrates_tpu_torch.interp import vectorized

    vi = vi or vectorized.VectorizedInterpreter(device="cuda")
    t0 = time.perf_counter()
    plan = vi.plan(prog)
    st = {"plan_s": time.perf_counter() - t0, "segments": len(plan.segments),
          "levels": sum(map(len, plan.segments)), "groups": sum(len(lv.groups) for seg in plan.segments for lv in seg),
          "host_groups": sum(h is not None for h in plan.host_groups),
          "checks": 0 if plan.checks is None else plan.checks.quads.k, "ms": [], "launches": [], "replays": [],
          "shapes": None if plan.checks is None else witness_shapes(plan, f" {prog.curve}")}
    wits = []
    with WitnessGuard() as guard:
        for flat in flats:
            before, replays = field_launches(), sum(vectorized.REPLAYS.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wits.append(vi.execute(prog, flat))
            torch.cuda.synchronize()
            st["ms"].append((time.perf_counter() - t0) * 1e3)
            st["launches"].append({k: v - before[k] for k, v in field_launches().items()})
            st["replays"].append(sum(vectorized.REPLAYS.values()) - replays)
    if guard.calls:
        raise AssertionError(f"{label}: plain field products or reductions ran on the card in the witness "
                             f"generator: {guard.calls}")
    for key in ("emul", "ereduce_wide"):
        if any(n[key] <= 0 for n in st["launches"]):
            raise AssertionError(f"{label}: {key} did not launch on every witness: {st['launches']}")
    steady = st["ms"][1:]
    st["first_ms"] = st["ms"][0]
    st["steady_ms"] = sum(steady) / len(steady) if steady else None
    log(f"  {label}: plan {st['plan_s']:.2f} s ({st['segments']} segments, {st['levels']} levels, {st['groups']} "
        f"groups, {st['host_groups']} host groups, {st['checks']} checks); {len(flats)} witnesses on the card: "
        f"first {st['first_ms']:.1f} ms (eager + capture), then "
        + (f"{st['steady_ms']:.1f} ms a witness (replays; {min(steady):.1f}-{max(steady):.1f})" if steady else "-")
        + f"; launches a witness: first {st['launches'][0]}, then {st['launches'][-1]}, graph replays "
        f"{st['replays'][-1]}; total {sum(st['ms']) / 1e3:.2f} s")
    return wits, st


def hold_to_scalar(prog, flats, wits, label: str, st, want=None):
    """Each witness value for value against the scalar interpreter's (or
    against `want`, witnesses the scalar interpreter made elsewhere); the
    scalar interpreter timed here over all of `flats`."""
    from zokrates_tpu_torch.interp.interpreter import Interpreter

    if want is None:
        t0 = time.perf_counter()
        want = [Interpreter().execute(prog, flat) for flat in flats]
        st["scalar_s"] = time.perf_counter() - t0
        log(f"  {label}: the scalar interpreter: {st['scalar_s']:.2f} s for {len(flats)} "
            f"({st['scalar_s'] / len(flats) * 1e3:.1f} ms a witness) against the card's {sum(st['ms']) / 1e3:.2f} s")
    bad = [i for i, (g, w) in enumerate(zip(wits, want)) if g.values != w.values]
    log(f"  {label}: {len(wits)} witnesses equal the scalar interpreter's value for value: {not bad}")
    if bad:
        raise AssertionError(f"{label}: witnesses {bad} differ from the scalar interpreter's")


def batch_witnesses(prog, count: int = BATCH, stats=None):
    """`count` distinct sha256 witnesses as bench.py makes them (preimage
    [16b, ..., 16b + 15], sha256_inputs) by the levelized generator on the
    card (card_witnesses), all held value for value against the scalar
    interpreter, each written in the binary witness format and read back.
    `stats`, a dict, receives the generator's times and counts."""
    flats = sha256_inputs(prog, count)
    label = f"sha256 {prog.curve} witnesses"
    wits, st = card_witnesses(prog, flats, label)
    hold_to_scalar(prog, flats, wits, label, st)
    if stats is not None:
        stats.update(st)
    return round_trip(prog, wits)


SOLVERS_ARTIFACT = "solvers_bn128.out.gz"
# main(field a, bool b, u32 x, u32 y) -> u32[4]: [x / y, x % y, x | y, b || a == 42], after assert(a != 7)
SOLVERS_INPUTS = [[5, 0, 1000003, 97], [42, 1, 0xFFFFFFFF, 1], [0, 0, 12, 5]]
SOLVERS_FAILING = [[7, 0, 1, 1], [0, 0, 12, 0]]  # the failed assert; u32 division by zero


def load_gz_prog(name: str):
    import gzip

    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(os.path.join(ROOT, "port_artifacts", name), "rb") as f:
        return deserialize(f.read())


def run_witness_path(result):
    """The levelized witness generator on the programs the batch paths do
    not reach, under a WitnessGuard: Pedersen-512 (the deep case: 855
    levels of Div groups, each a Fermat chain of emul products), two
    witnesses (the first call eager + capture, the second a replay), and
    the solver program (port_artifacts/SOLVERS_ARTIFACT: ConditionEq, Or,
    EuclideanDiv (u32 / and %), Bits) at SOLVERS_INPUTS, each value for
    value against the scalar interpreter; its SOLVERS_FAILING inputs must
    raise the scalar interpreter's UnsatisfiedConstraint, eagerly and on
    replay. The launch counts are set to 0 just before each program and
    read after; `result` receives the stats."""
    from zokrates_tpu_torch.interp import vectorized
    from zokrates_tpu_torch.interp.interpreter import Interpreter, UnsatisfiedConstraint

    prog = load_gz_prog("pedersen512_bn128.out.gz")
    flats = [list(range(16)), [0xFFFFFFFF - i for i in range(16)]]
    label = "Pedersen-512 witnesses"
    clear_launches()
    wits, st = card_witnesses(prog, flats, label)
    st["kernel_launches"] = launch_counts()
    hold_to_scalar(prog, flats, wits, label, st)
    result["pedersen512"] = st

    prog = load_gz_prog(SOLVERS_ARTIFACT)
    label = "solver program witnesses"
    clear_launches()
    vi = vectorized.VectorizedInterpreter(device="cuda")
    wits, st = card_witnesses(prog, SOLVERS_INPUTS, label, vi)
    hold_to_scalar(prog, SOLVERS_INPUTS, wits, label, st)
    solvers = sorted({(g.solver.name if g.solver else "assign") for seg in vi.plan(prog).segments
                      for lv in seg for g in lv.groups})
    log(f"  {label}: device groups by solver {solvers}; outputs {[w.return_values() for w in wits]}")
    errors = []
    with WitnessGuard() as guard:
        for flat in SOLVERS_FAILING:
            try:
                Interpreter().execute(prog, flat)
                raise AssertionError(f"the scalar interpreter accepted {flat}")
            except UnsatisfiedConstraint as e:
                want = str(e)
            for _ in range(2):
                try:
                    vi.execute(prog, flat)
                    raise AssertionError(f"the card's generator accepted {flat}")
                except UnsatisfiedConstraint as e:
                    if str(e) != want:
                        raise AssertionError(f"{flat}: the card raised {e!s}, the scalar interpreter {want}")
            errors.append(want)
    if guard.calls:
        raise AssertionError(f"plain field products or reductions ran on the card: {guard.calls}")
    st["kernel_launches"] = launch_counts()
    st["errors"] = errors
    log(f"  {label}: {SOLVERS_FAILING} raise the scalar interpreter's errors on the card, eagerly and on "
        f"replay: {errors}")
    result["solvers"] = st


def witness_shapes(plan, tag: str):
    """emul and ereduce_wide at the generator's widest calls on `plan`, as
    check_field_kernels takes them: the check batch's coefficient products
    (its three sides' terms, coefficients a packed row each), its row sums
    (3k sums), the quads' products (k, b packed) and W's conversion from
    Montgomery form (one row)."""
    cb = plan.checks
    terms = len(cb.quads.l_rows) + len(cb.quads.r_rows) + len(cb.lin_rows)
    k = cb.quads.k
    return {"emul": [(f"witness check terms{tag}", "Fr", 1, terms, "full"),
                     (f"witness check quads{tag}", "Fr", 1, k, "full"),
                     (f"witness from_mont W{tag}", "Fr", 1, plan.num_dense, "row")],
            "ereduce_wide": [(f"witness check sums{tag}", 1, 3 * k)]}


def walk_shapes(Wn: int, Ks: int, cfg):
    """(K, L) of the mixed walk, the merge walk and the suffix walk of a
    sorted MSM over Wn windows of Ks sorted positions each."""
    from zokrates_tpu_torch.kernels.msm_sorted import _plan_shapes

    s = _plan_shapes(Ks, Wn, cfg)
    return {"walk_mixed": (s["K1"], Wn * cfg.M1), "walk_general": (s["cap1"] // cfg.lw2, Wn * cfg.lw2),
            "suffix": (s["L4"], Wn * cfg.lw2)}


def fold_shape(Wn: int, Ks: int, cfg):
    """(G, lw, L) of the suffix epilogue of the same MSM."""
    return (Wn, cfg.lw2, walk_shapes(Wn, Ks, cfg)["suffix"][0])


def main_path_shapes(r1cs, wit):
    """The kernels' shapes in this circuit's prove: G1 at the h MSM, both in
    the shared-bucket form the prove takes (one window of Wc*N slots,
    "h16") and dense over all windows, and at the witness G1 MSMs' device
    windows (the a, b1 and l queries share one plan: three times the
    lanes, "a/b1/l"), Fq2 at the b2 MSM's device windows for this
    witness, and the scalar field's elementwise kernels and transforms at
    the h stage's and the corrections' sizes."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.fields.limbs import n_limbs
    from zokrates_tpu_torch.kernels.msm_sorted import _windows, default_config, shared_window_count
    from zokrates_tpu_torch.native import available
    from zokrates_tpu_torch.schemes import groth16 as g

    p = P.SCALAR_FIELDS[r1cs.curve].p
    m = r1cs.num_variables
    n = 1 << (r1cs.num_constraints + r1cs.num_instance - 1).bit_length()
    N = max(g._msm_tier(m), g._msm_tier(n - 1))
    cfg = default_config(N)
    W = _windows(p, cfg.c)
    z = g._witness_limbs(r1cs, wit, p, n_limbs(p))
    w0, w1, Ks, hw0, hw1 = g._split_with_host(g._window_nnz_batch([z], W, cfg.c), W, cfg, N, available())

    g2_W, g2_Ks = (w0, N) if w0 else (w1 - w0, Ks)
    fq, fq2 = walk_shapes(W, N, cfg), walk_shapes(g2_W, g2_Ks, cfg)
    cfgH, Wc = g._shared_h_cfg(cfg), shared_window_count(p, 16)
    fq["extra"] = {" h16": walk_shapes(1, Wc * N, cfgH), " a/b1/l": walk_shapes(3 * g2_W, g2_Ks, cfg)}
    fq["fold"] = {"h16 MSM": fold_shape(1, Wc * N, cfgH), "h MSM": fold_shape(W, N, cfg),
                  "a/b1/l MSM": fold_shape(3 * g2_W, g2_Ks, cfg)}
    fq2["fold"] = {"b2 MSM": fold_shape(g2_W, g2_Ks, cfg)}
    nnz = sum(len(row) for mat in (r1cs.A, r1cs.B, r1cs.C) for row in mat) + r1cs.num_instance
    chunk = min(N, 1 << 15)
    B = BATCH
    # emul's B = 16 shapes, launches a batch: to_mont 1, the 3B inverse
    # transforms' n^-1 and the coset table 1 each, A*B 1 (slices of the
    # (B, 3, n) coset values), 1/Z(g), the coset ifft's n^-1 and from_mont
    # 3, its coset table 1; ereduce_wide's: the walk's snapshot and its row
    # sums (walk_reduce_shapes), 1 each
    fr = {"emul": [("matvec (COO, not on the card's path)", "Fr", 1, nnz, "shared"),
                   ("to_mont", "Fr", 1, m, "row"), ("A*B", "Fr", 1, n, "full"),
                   ("corrections", "Fr", 3, N, "shared"),
                   ("B=16 to_mont", "Fr", B, m, "row"), ("B=16 n^-1", "Fr", 3 * B, n, "row"),
                   ("B=16 coset", "Fr", 3 * B, n, "shared"), ("B=16 A*B", "Fr", B, n, "strided"),
                   ("B=16 A*B full", "Fr", B, n, "full"), ("B=16 1/Z, n^-1, from_mont", "Fr", B, n, "row"),
                   ("B=16 coset^-1", "Fr", B, n, "shared")],
          "ereduce_wide": [("matvec (COO, not on the card's path)", 1, 3 * n),
                           ("corrections", 3, -(-N // chunk))],
          "ntt": (n, [("forward x3", 3, False), ("inverse x3", 3, True), ("inverse x1", 1, True),
                      ("B=16 forward x48", 3 * B, False), ("B=16 inverse x48", 3 * B, True),
                      ("B=16 inverse x16", B, True)])}
    info = dict(N=N, n=n, W=W, c=cfg.c, M1=cfg.M1, lw2=cfg.lw2, split=(w0, w1, Ks, hw0, hw1), nnz=nnz)
    return {"fq": fq, "fq2": fq2, "fr": fr}, info


def walk_summary(walks) -> str:
    return "matvec walk plans " + ", ".join(f"B={B}: K={w.K} x M={w.M} lanes, {w.pos.numel()} slots"
                                             for B, w in walks.items())


def walk_reduce_shapes(walks):
    """ereduce_wide's shapes behind the walk matvec (groth16._matvec_walk),
    at B = 1 and 16: the flush slots of the plan the path takes at that B
    (walks: path_walks) and the row sums (3n rows)."""
    return [(("" if B == 1 else f"B={B} ") + label, B, L) for B, w in walks.items()
            for label, L in (("walk slots", w.pos.numel()), ("row sums", w.n_rows))]


def gm17_shapes(pk, dev, curve: str = "bn128"):
    """The kernels' shapes in a GM17 prove with this pk on the curve: the
    dense sorted MSM over all windows at the G1 queries' padded size (a, c
    and h share one) and at the G2 query's; the h stage's emul and NTT
    calls at the domain size n (U, W to Montgomery form, the two inverse
    transforms' n^-1, the coset tables, U^2, the 1/t, back from Montgomery
    form and two_r * u, the last four over one row); and the queries'
    conversion to Montgomery form over Fq (12 limbs on BLS12-381, 24 on
    BW6-761, whose G2 query is 2 coordinates over Fq a point) when the pk
    first packs them."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels.msm_sorted import _windows, default_config

    r = P.SCALAR_FIELDS[curve].p
    pkd = pk.dev(dev)
    n = pk.domain_size

    def of(N, fold_label):
        cfg = default_config(N)
        full = -(-N // (cfg.M1 * cfg.R)) * (cfg.M1 * cfg.R)  # groth16._sorted_inputs
        W = _windows(r, cfg.c)
        return dict(walk_shapes(W, full, cfg), fold={fold_label: fold_shape(W, full, cfg)})

    sizes = {pkd[k].shape[0] for k in ("a", "c", "h")}
    if len(sizes) != 1:
        raise AssertionError(f"the GM17 G1 queries have sizes {sizes}; the checks cover one")
    N1, N2 = sizes.pop(), pkd["bx"].shape[0]
    fr = {"emul": [("gm17 U,W to_mont", "Fr", 1, 2 * n, "row"), ("gm17 ninv x2", "Fr", 2, n, "row"),
                   ("gm17 coset x2", "Fr", 2, n, "shared"), ("gm17 U^2", "Fr", 1, n, "shared"),
                   ("gm17 1/t", "Fr", 1, n, "row"),
                   ("gm17 G1 query", "Fq", 1, N1, "row"),
                   ("gm17 G2 query", "Fq", 1, (2 if pkd["bx"].dim() == 2 else 4) * N2, "row")],
          "ereduce_wide": [],
          "ntt": (n, [("gm17 inverse x2", 2, True), ("gm17 forward x2", 2, False),
                      ("gm17 inverse x1", 1, True)])}
    return {"fq": of(N1, "gm17 a/c/h MSM"), "fq2": of(N2, "gm17 b MSM"), "fr": fr}


class PlainGuard:
    """While active, counts the calls of jfield's mul and reduce_wide, of
    mulacc_walk_plain and of the COO matvec on CUDA tensors made inside
    groth16._h_stage, groth16._corr_fast, gm17._h_stage or
    msm_sorted._msm_from_plan. The
    plain NTT stage loop, the plain suffix epilogue and the plain
    elementwise ops all come down to the first two, so a count of 0 shows
    that those stages ran on the kernels alone, and that the h stage took
    the mulacc walk."""

    def __init__(self):
        from zokrates_tpu_torch.fields import jfield
        from zokrates_tpu_torch.kernels import msm_sorted, pallas_field
        from zokrates_tpu_torch.schemes import gm17, groth16

        self.depth = 0
        self.calls = {}
        self.patches = [(jfield.FieldOps, "mul", self._plain), (jfield.FieldOps, "reduce_wide", self._plain),
                        (pallas_field, "mulacc_walk_plain", self._plain), (groth16, "_matvec_coo", self._plain),
                        (groth16, "_h_stage", self._stage), (groth16, "_corr_fast", self._stage),
                        (msm_sorted, "_msm_from_plan", self._stage), (gm17, "_h_stage", self._stage)]
        self.saved = []

    def _plain(self, name, fn):
        def wrapped(*args, **kw):
            import torch

            if self.depth and any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    def _any(self, name, fn):
        """Counts every call on a CUDA tensor, at any depth."""
        def wrapped(*args, **kw):
            import torch

            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    def _stage(self, name, fn):
        def wrapped(*args, **kw):
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
        return wrapped

    def __enter__(self):
        for owner, name, wrap in self.patches:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


class WitnessGuard(PlainGuard):
    """PlainGuard over the levelized witness generator: counts jfield's mul
    and reduce_wide on CUDA tensors inside
    VectorizedInterpreter._execute_plan (the plan's device setup, the
    segments, host groups and the check batch), where every product must
    take emul and every reduction ereduce_wide."""

    def __init__(self):
        super().__init__()
        from zokrates_tpu_torch.interp import vectorized

        self.patches.append((vectorized.VectorizedInterpreter, "_execute_plan", self._stage))


def launch_counts():
    from zokrates_tpu_torch.kernels import msm_sorted, ntt_pallas, pallas_field

    counts = {}
    for mod in (msm_sorted, pallas_field, ntt_pallas):
        counts.update(mod.LAUNCHES)
    return counts


def run_main_path(r1cs, wit, dev, forgeries: bool = False, keys=None):
    """Setup, NPROOFS proofs and their verification on the r1cs's curve,
    with the kernels' launch counts set to 0 just before setup and read
    after the proofs; with `forgeries`, a tampered proof (a <-> c) and a
    wrong public input must fail to verify. `keys`, a key pair set up
    elsewhere (the CLI's), takes the place of setup."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted
    from zokrates_tpu_torch.schemes import groth16 as g

    p = P.SCALAR_FIELDS[r1cs.curve].p
    rng = random.Random(SEED)
    clear_launches()
    t0 = time.perf_counter()
    pk, vk = keys or g.setup(r1cs, rng=lambda: rng.randrange(1, p), device=dev)
    torch.cuda.synchronize()
    log(f"  {'the CLI setup' if keys else 'setup'}: {time.perf_counter() - t0:.2f} s (domain {pk.domain_size}, "
        f"{r1cs.num_variables} variables; b2 rows {pk.b2_rows().shape[1]} words, h16 rows "
        f"{None if pk.h16_p128 is None else pk.h16_p128.shape})")

    proofs, walls = [], []
    with PlainGuard() as guard, ShapeTally() as tally:
        for i in range(NPROOFS):
            rs = iter([(SEED + 1000 + 2 * i) % p, (SEED + 2001 + 2 * i) % p])
            timings = {}
            t0 = time.perf_counter()
            proof = g.prove(r1cs, pk, wit, rng=lambda: next(rs), device=dev, timings=timings)
            walls.append(time.perf_counter() - t0)
            proofs.append(proof)
            log(f"  prove {i}: {walls[-1] * 1e3:.1f} ms  "
                + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in timings.items()))
    launches = launch_counts()
    tally.report(NPROOFS, "proof")
    log(f"  launches by width (kernel, 32-bit limbs): {dict(msm_sorted.WIDTH_LAUNCHES)}")
    log(f"  plain field products / reductions on the card in the h stage, corrections and MSMs: "
        f"{guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the main path: {guard.calls}")

    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = g.verify(vk, proof)
        log(f"  verify {i}: {ok} ({time.perf_counter() - t0:.2f} s)")
        if not ok:
            raise AssertionError(f"proof {i} failed to verify")
    if len({json.dumps(pr.points, sort_keys=True) for pr in proofs}) != len(proofs):
        raise AssertionError("proofs with distinct r, s are not distinct")
    if forgeries:
        check_forgeries(g, vk, proofs[0], r1cs.curve)
    check_launches(launches, NPROOFS, "the main path")
    steady = walls[1:]  # proof 0 carries the one-off uploads
    log(f"  launches over setup and {NPROOFS} proofs: {launches}")
    log(f"  steady state: {len(steady) / sum(steady):.4f} proofs/s "
        f"({sum(steady) / len(steady) * 1e3:.1f} ms/proof over proofs 1..{len(walls) - 1})")
    return launches, pk, vk


def clear_launches():
    from zokrates_tpu_torch.kernels import msm_sorted, ntt_pallas, pallas_field

    for mod in (msm_sorted, pallas_field, ntt_pallas):
        mod.LAUNCHES.clear()
        mod.WIDTH_LAUNCHES.clear()


def check_forgeries(scheme, vk, proof, curve: str):
    """A tampered proof (a <-> c) and a proof with a wrong public input must
    fail scheme.verify."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes.types import Proof, fr_to_json

    tampered = Proof.from_json(proof.to_json())
    tampered.points["a"], tampered.points["c"] = tampered.points["c"], tampered.points["a"]
    wrong = Proof.from_json(proof.to_json())
    if not wrong.inputs:
        raise AssertionError("the circuit has no public input to alter")
    wrong.inputs[0] = fr_to_json((int(wrong.inputs[0], 16) + 1) % P.SCALAR_FIELDS[curve].p, curve)
    for name, bad in (("tampered (a <-> c)", tampered), ("wrong public input", wrong)):
        ok = scheme.verify(vk, bad)
        log(f"  verify {name}: {ok}")
        if ok:
            raise AssertionError(f"a proof with a {name} verified")


def check_width(width: int, path: str):
    """Every MSM kernel launched at `width` 32-bit limbs on the path (counts
    set to 0 just before it) and at no other width."""
    from zokrates_tpu_torch.kernels import msm_sorted

    counts = dict(msm_sorted.WIDTH_LAUNCHES)
    names = ("walk_mixed", "walk_general", "suffix", "suffix_fold")
    missing = [n for n in names if counts.get((n, width), 0) <= 0]
    other = {k: v for k, v in counts.items() if k[1] != width}
    if missing or other:
        raise AssertionError(f"on {path} the MSM kernels must launch at {width} limbs only: {counts}")
    return {n: counts[(n, width)] for n in names}


def check_launches(launches, runs: int, path: str):
    """Every kernel launched; the matvec walk at least once a prove call;
    each suffix launch followed by its epilogue."""
    for name in REPLACES:
        if name not in MPC_KERNELS and launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on {path}: {launches}")
    if launches["mulacc_walk"] < runs:
        raise AssertionError(f"mulacc_walk launched {launches['mulacc_walk']} times in {runs} prove calls")
    if launches["suffix_fold"] != launches["suffix"]:
        raise AssertionError(f"every suffix launch must be followed by its epilogue: {launches}")


def compare_h_msm(r1cs, wit, pk, dev):
    """The h MSM of one proof's h scalars on the r1cs's curve in the
    shared-bucket form the prove takes (c = 16, one window over the pk's
    h16 rows) and dense per window (c = 8 over the h rows): equal after
    the host combine, as affine points. Each is timed with the host clock
    around plan + MSM, ending in a synchronize (the second of two runs),
    with its stage split."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted as ms
    from zokrates_tpu_torch.schemes import groth16 as g

    p, q = P.SCALAR_FIELDS[r1cs.curve].p, P.BASE_FIELDS[r1cs.curve].p
    m, n = r1cs.num_variables, pk.domain_size
    N = g._hw_fused_tier(m, n)
    cfg = ms.default_config(N)
    W, Wc, cfgH = ms._windows(p, cfg.c), ms.shared_window_count(p, 16), g._shared_h_cfg(cfg)
    if not g._use_h16(pk, p, N, dev):
        raise AssertionError(f"the pk carries no shared-bucket h query at the prover's tier N = {N}")
    z = g._witness_limbs(r1cs, wit, p, nl_of(p))
    Z = torch.as_tensor(np.pad(z, ((0, N - m), (0, 0))).astype(np.int64), device=dev)[None]
    h = g._h_stage(r1cs.curve, g._r1cs_device(r1cs, n, dev), Z)[0]
    h_pad = torch.nn.functional.pad(h[: n - 1], (0, 0, 0, N - (n - 1)))
    pkd = pk.dev(dev, N, m)
    def h16(mark):
        plan = ms._msm_plan_shared(Wc, N, cfgH, h_pad)
        mark("plans")
        return ms._msm_from_plan(q, 1, cfgH, pkd["h16"], plan, True, mark=mark)[0]

    def dense(mark):
        plan = ms._msm_plan(W, N, cfg, h_pad)
        mark("plans")
        return ms._msm_from_plan(q, W, cfg, pkd["h"], plan, True, mark=mark)[0]

    res = {}
    with Capture() as cap:  # the h16 MSM's kernel inputs, for check_h16_real
        h16(lambda label: None)
    for name, fn, Wn, c in (("h16", h16, 1, 16), ("dense", dense, W, cfg.c)):
        fn(lambda label: None)
        stages = {}
        out, wall = host_ms(lambda: fn(g._Stages(stages, dev)))
        jx, jy, jz = ms.combine_windows(q, p, tuple(a[0].cpu().numpy() for a in out), Wn, c)
        zi = pow(jz, -1, q)
        res[name] = ((jx * zi * zi % q, jy * zi ** 3 % q), wall, stages)
        log(f"  h MSM {name:5s} ({Wn} window{'s' if Wn > 1 else ''}, c={c}): {wall:.2f} ms  "
            + "  ".join(f"{k}={v * 1e3:.2f}ms" for k, v in stages.items()))
    equal = res["h16"][0] == res["dense"][0]
    log(f"  h MSM shared-bucket == dense as affine points: {equal}")
    if not equal:
        raise AssertionError("the shared-bucket h MSM disagrees with the dense h MSM")
    return {k: v[1] for k, v in res.items()}, cap.calls


class Capture:
    """While active, passes every call of msm_sorted's walk, suffix and
    suffix_fold wrappers to note(name, args) (positional arguments, as
    the MSM calls them); by default keeps the arguments in order."""

    NAMES = ("walk", "suffix", "suffix_fold")

    def __init__(self, note=None):
        self.calls = {name: [] for name in self.NAMES}
        self.note = note or (lambda name, args: self.calls[name].append(args))

    def __enter__(self):
        from zokrates_tpu_torch.kernels import msm_sorted

        self.saved = {name: getattr(msm_sorted, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            def wrapped(*args, _name=name, _fn=fn):
                self.note(_name, args)
                return _fn(*args)
            setattr(msm_sorted, name, wrapped)
        return self

    def __exit__(self, *exc):
        from zokrates_tpu_torch.kernels import msm_sorted

        for name, fn in self.saved.items():
            setattr(msm_sorted, name, fn)


class ShapeTally(Capture):
    """While active, counts the launches of the walk, suffix and epilogue
    kernels by kernel, field and shape (walk (K, L), suffix (Lb, M),
    suffix_fold (G, lw, L)); only calls on CUDA tensors launch."""

    def __init__(self):
        from collections import Counter

        self.counts = Counter()
        super().__init__(self._count)

    def _count(self, name, args):
        if not args[0].is_cuda:
            return
        beta = args[-1]
        field = "Fq" if beta is None else "Fq2"
        if name == "walk":
            mode, safe = args[3], args[4]
            name = "walk_" + mode + ("" if mode == "general" else "-safe" if safe else "-unsafe")
            shape = tuple(args[1].shape)
        elif name == "suffix":
            shape = (args[0].shape[0], args[0].shape[2])
        else:
            shape = tuple(args[2:5])
        self.counts[(name, field, shape)] += 1

    def report(self, runs: int, what: str):
        """Logs the launches per run by kernel and shape (with each walk
        shape's S, each suffix shape's k and their thread counts) and
        returns them as records."""
        from zokrates_tpu_torch.kernels.msm_sorted import suffix_split, walk_split

        log(f"  launches per {what} by kernel and shape (over {runs}):")
        out = []
        for (name, field, shape), n in sorted(self.counts.items()):
            rec = {"kernel": name, "field": field, "shape": list(shape), "per_run": n / runs}
            extra = ""
            if name.startswith("walk"):
                S = walk_split(*shape)
                rec.update(S=S, threads=-(-shape[0] // S) * shape[1])
                extra = f", S = {S}, {rec['threads']} threads"
            elif name == "suffix":
                k = suffix_split(*shape)
                rec.update(k=k, threads=k * shape[1])
                extra = f", k = {k}, {rec['threads']} threads"
            log(f"    {name:20s} {field:3s} {str(shape):16s} {n / runs:g}{extra}")
            out.append(rec)
        return out


def sweep_walk_split(args, want):
    """The walk kernel at sub-chunk lengths S = K, 64, 32, 16, 8, 4, 2, 1
    (where <= K) through its C entry point, on the wrapper's inputs
    `args`: each output bit-equal to the wrapper's `want`, each timed.
    Returns {S: ms}; the wrapper's S comes from walk_split."""
    import torch
    from zokrates_tpu_torch.kernels import cuda

    qrows, flags, p, mode, safe, beta = args
    K, L = flags.shape
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(p, beta)
    stream = torch.cuda.current_stream(flags.device).cuda_stream
    out = torch.empty_like(want[0])
    coll = torch.empty_like(want[1])
    times = {}
    for S in sorted({K, 64, 32, 16, 8, 4, 2, 1}, reverse=True):
        if S > K:
            continue

        def launch():
            coll.zero_()
            cuda.check(lib.zkt_msm_walk(qrows.data_ptr(), flags.data_ptr(), out.data_ptr(), coll.data_ptr(), K,
                                        L, S, nl, int(beta is not None), int(mode == "mixed"), int(safe), pl,
                                        one, n0, babs, stream), "walk")
        out.fill_(-1)
        launch()
        torch.cuda.synchronize()
        if not (torch.equal(out, want[0]) and torch.equal(coll, want[1])):
            raise AssertionError(f"the {mode} walk at S = {S} differs from the wrapper's output")
        times[S] = cuda_ms(launch)
    log(f"    sweep ({K}, {L}), bit-equal at every S: "
        + "  ".join(f"S={S} {t:.4f} ms" for S, t in times.items()))
    return times


def check_suffix_real(args, tag: str = "", width: int = 8, curve: str = "bn128", label: str = "h16 real"):
    """The shared-bucket h MSM's suffix on one proof's own dense bucket
    table (`args` as compare_h_msm captured them; another MSM's by its
    `label`) against its plain version, bit for bit, timed (its kernel at
    every k is a card test: test_suffix_kernel_at_every_split). The
    random-table check at the same shape draws every slot from a pool of
    points; the real table holds each bucket's one or two records, with
    empty slots at infinity."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted as ms

    a, b, p, beta = args
    Lb, _, M = a.shape
    out = ms.suffix(*args)
    torch.cuda.synchronize()
    ref, ms_p = host_ms(lambda: ms.suffix_plain(*args))
    ms_k = cuda_ms(lambda: ms.suffix(*args))
    en = a.shape[1] // 3
    ainf, binf = ((t[:, 2 * en:] == 0).all(1).cpu().numpy() for t in (a, b))
    mults = suffix_adds(ainf, binf) * GENERAL_MULS * (1 if beta is None else FQ2_MULS)
    nbytes = 4 * (a.numel() + b.numel() + out.numel())
    rec = _record("suffix", "Fq" if beta is None else "Fq2", f"fold=False {label}{tag}", (Lb, M), (out,), (ref,),
                  ms_k, ms_p, mults, nbytes, width, curve)
    rec["empty_slots"] = int(ainf.sum() + binf.sum())
    rec.update(suffix_launch(Lb, M))
    return rec


def check_walk_call(args, label: str, width: int = 8, curve: str = "bn128", sweep: bool = False,
                    blocks: int = 0, max_lanes: int = 0):
    """One captured walk call (`args` as the MSM passed them) against its
    plain version, bit for bit, timed; with `sweep`, also at every S
    (sweep_walk_split); with `blocks` (a safe or general walk), the plain
    version only on walk_blocks' two blocks of max(S, blocks) positions, S
    the call's sub-chunk length (it steps one position at a time, 60-90 ms
    a position at 12 limbs on the card, and cannot take a whole h16 walk
    in the time): the kernel's outputs of the whole call at those
    positions and lanes, and its collision flags, all zero; the kernel
    time and the bound stay the whole call's; with `max_lanes` too, the
    blocks keep only the lanes below it (a lane's walk is its own: the
    plain version of a 24-limb walk over 147,456 lanes takes minutes).
    G1: a coordinate's rows are its limbs."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted as ms

    qrows, flags, p, mode, safe, beta = args
    K, L = flags.shape
    launch = walk_launch(K, L)
    out = ms.walk(*args)
    torch.cuda.synchronize()
    fl = flags.cpu().numpy()
    if blocks:
        if mode == "mixed" and not safe:
            raise ValueError("the block check takes a safe or general walk")
        checked = walk_blocks(fl, launch["S"], max(launch["S"], blocks))
        if max_lanes:
            every = np.arange(min(L, max_lanes))
            checked = [(k0, k1, every if lanes is None else lanes[lanes < max_lanes]) for k0, k1, lanes in checked]
            checked = [c for c in checked if c[2].size]
        got, want, ms_p = [out[1]], [torch.zeros_like(out[1])], 0.0
        for k0, k1, lanes in checked:
            li = slice(None) if lanes is None else torch.as_tensor(lanes, device=qrows.device)
            qb, fb = qrows[k0:k1][..., li].contiguous(), flags[k0:k1][:, li].contiguous()
            (ref, _), t = host_ms(lambda: ms.walk_plain(qb, fb, p, mode, safe, beta))
            ms_p += t
            got.append(out[0][k0:k1][..., li])
            want.append(ref)
    else:
        got, (want, ms_p) = out, host_ms(lambda: ms.walk_plain(*args))
    ms_k = cuda_ms(lambda: ms.walk(*args))
    qinf = np.zeros(fl.shape, bool)
    if mode == "general":
        en = nl_of(p)
        qinf = (qrows[:, 2 * en:3 * en] == 0).all(1).cpu().numpy()
    mults = walk_adds(fl, qinf) * (MIXED_MULS if mode == "mixed" else GENERAL_MULS)
    nbytes = 4 * (qrows.numel() + flags.numel() + sum(t.numel() for t in out))
    label = ("general" if mode == "general" else mode + ("-safe" if safe else "-unsafe")) + " " + label
    rec = _record("walk", "Fq", label, (K, L), got, want, ms_k, ms_p, mults, nbytes, width, curve)
    if blocks:
        rec["plain_checked"] = [{"positions": [k0, k1], "lanes": L if lanes is None else int(lanes.size)}
                                for k0, k1, lanes in checked]
        log(f"    plain version on positions and lanes {rec['plain_checked']} of the call")
    rec["collisions"] = int(out[1].sum())
    rec["flushes"] = int(np.count_nonzero(fl & 1))
    rec.update(launch)
    if sweep:
        rec["sweep"] = sweep_walk_split(args, out)
    return rec


def walk_blocks(flags: np.ndarray, S: int, n: int):
    """Two blocks of n positions on which a walk's plain version reproduces
    the kernel's outputs without the positions before them: positions
    [0, n) on every lane, and [k0, k0 + n) from the middle sub-chunk
    boundary k0 (sub-chunks of S positions; or the first position after it
    where any lane qualifies) on the lanes whose accumulator is at infinity
    there, those that flush at k0 - 1 and do not skip k0 (an add to the
    point at infinity returns the incoming point, whatever the
    accumulator's x and y). Returns [(k0, k1, lanes or None for all)]."""
    K, _ = flags.shape
    n = min(n, K)
    blocks = [(0, n, None)]
    for k0 in range(max(S * (-(-K // S) // 2), n), K - n + 1):
        lanes = np.flatnonzero(((flags[k0 - 1] & 1) != 0) & ((flags[k0] & 2) == 0))
        if lanes.size:
            blocks.append((k0, k0 + n, lanes))
            break
    return blocks


def check_fold_call(args, label: str, width: int = 8, curve: str = "bn128"):
    """One captured suffix epilogue call against its plain version, bit
    for bit, timed (G1: rows [acc | tot], a coordinate's rows its limbs)."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted as ms

    out6, p, G, lw, L, beta = args
    got = ms.suffix_fold(*args)
    torch.cuda.synchronize()
    ref, ms_p = host_ms(lambda: ms.suffix_fold_plain(*args))
    ms_k = cuda_ms(lambda: ms.suffix_fold(*args))
    en = nl_of(p)
    ainf = (out6[2 * en:3 * en] == 0).all(0).cpu().numpy()
    tinf = (out6[5 * en:6 * en] == 0).all(0).cpu().numpy()
    mults = fold_mults(ainf, tinf, G, lw, L)
    nbytes = 4 * out6.numel() + 8 * sum(t.numel() for t in got)
    return _record("suffix_fold", "Fq", label, (G, lw, L), got, ref, ms_k, ms_p, mults, nbytes, width, curve)


def check_h16_real(calls):
    """The shared-bucket h MSM's mixed walk, its first merge walk, its
    suffix and its epilogue on one proof's own inputs (the plan and sorted
    points of its h scalars, as compare_h_msm captured them), each against
    its plain version, bit for bit, and timed (the mixed walk's plain
    version on two blocks of its plan, walk_blocks, as BLS12-381's: over
    all 512 positions it took 30 s); each walk also at every S
    (sweep_walk_split); the suffix at the prove's k (check_suffix_real).
    The random-flag
    checks at the same shapes flush 25% of positions; the real plan's
    bucket runs are about 16 long."""
    walks = calls["walk"]
    records = {"walk_mixed": [], "walk_general": [], "suffix": [], "suffix_fold": []}
    for args, blocks in ((walks[0], 32), (walks[1], 0)):
        records["walk_" + args[3]].append(check_walk_call(args, "h16 real", sweep=True, blocks=blocks))
    records["suffix"].append(check_suffix_real(calls["suffix"][0]))
    records["suffix_fold"].append(check_fold_call(calls["suffix_fold"][0], "h16 MSM real"))
    return records


def verify_all(vk, proofs, seed: int) -> bool:
    """Every proof of `proofs` against `vk` in one pairing product, with
    random 128-bit weights w_i: prod e(-w_i A_i, B_i) e(sum w_i alpha,
    beta) e(sum w_i vk_x_i, gamma) e(sum w_i C_i, delta) == 1, vk_x_i the
    proof's combination of gamma_abc by its inputs (groth16.verify's
    equation for each proof, combined). One Miller loop a proof and three
    more, one final exponentiation; a set holding a false proof passes
    with probability about 2^-128."""
    from zokrates_tpu_torch.ec.pairing import pairing_product_is_one
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes.types import fr_from_json, g1_from_json, g2_from_json

    curve = vk.curve
    r_ord = P.SCALAR_FIELDS[curve].p
    rng = random.Random(seed)
    w = [rng.getrandbits(128) | 1 for _ in proofs]
    abc = [g1_from_json(x, curve) for x in vk.data["gamma_abc"]]
    coef = [sum(w) % r_ord] + [0] * (len(abc) - 1)  # of gamma_abc: sum_i w_i (1, inputs_i)
    pairs = []
    c_sum = None
    for wi, pr in zip(w, proofs):
        ins = [fr_from_json(x, curve) for x in pr.inputs]
        if len(ins) + 1 != len(abc):
            return False
        for j, v in enumerate(ins):
            coef[j + 1] = (coef[j + 1] + wi * v) % r_ord
        pairs.append((-(g1_from_json(pr.points["a"], curve) * wi), g2_from_json(pr.points["b"], curve)))
        c = g1_from_json(pr.points["c"], curve) * wi
        c_sum = c if c_sum is None else c_sum + c
    vk_x = None
    for pt, k in zip(abc, coef):
        t = pt * k
        vk_x = t if vk_x is None else vk_x + t
    pairs += [(g1_from_json(vk.data["alpha"], curve) * (sum(w) % r_ord), g2_from_json(vk.data["beta"], curve)),
              (vk_x, g2_from_json(vk.data["gamma"], curve)), (c_sum, g2_from_json(vk.data["delta"], curve))]
    return pairing_product_is_one(curve, pairs)


def check_batch_verifies(vk, proofs, seed: int, what: str) -> None:
    """verify_all on every proof of a batch, and on the same batch with one
    proof's C swapped for another's, which must fail (the MPC phase calls
    verify_all alone)."""
    import copy

    t0 = time.perf_counter()
    ok = verify_all(vk, proofs, seed)
    t1 = time.perf_counter()
    bad = copy.deepcopy(proofs)
    bad[-1].points["c"] = proofs[0].points["c"]
    forged = verify_all(vk, bad, seed + 1)
    log(f"  {what}: all {len(proofs)} proofs verify in one weighted pairing product: {ok} "
        f"({t1 - t0:.1f} s); with proof {len(proofs) - 1}'s C swapped: {forged} ({time.perf_counter() - t1:.1f} s)")
    if not ok:
        raise AssertionError(f"{what}: the batch's proofs do not all verify")
    if forged:
        raise AssertionError(f"{what}: a batch holding a false proof verified")


def run_batch_path(r1cs, pk, vk, wits, dev, smi):
    """prove_batch as bench.py runs it: one warm-up batch, NBATCHES timed
    ones, with the launch counts set to 0 just before the first and read
    after the last; every proof of the last batch verifies (verify_all, in
    one pairing product) and a false one in it is caught, all are
    distinct, and proofs 0 and 1 equal prove() of the same witness with
    the same r, s."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted
    from zokrates_tpu_torch.schemes import groth16 as g

    p = P.SCALAR_FIELDS[r1cs.curve].p

    def rs(i):  # r0, s0, r1, s1, ... of batch i
        return [(SEED + 10000 * (i + 1) + j) % p for j in range(2 * len(wits))]

    clear_launches()
    walls, splits = [], []
    with PlainGuard() as guard, ShapeTally() as tally:
        for i in range(1 + NBATCHES):
            draws = iter(rs(i))
            timings = {}
            t0 = time.perf_counter()
            proofs = g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev, timings=timings)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            splits.append(timings)
            log(f"  prove_batch {i} (B={len(wits)}): {walls[-1] * 1e3:.1f} ms  "
                + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in timings.items()))
    launches = launch_counts()
    tally.report(1 + NBATCHES, f"batch of {len(wits)}")
    log(f"  plain versions on the card in the batched h stage, corrections and MSMs: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the batched path: {guard.calls}")
    check_launches(launches, 1 + NBATCHES, "the batched path")
    log(f"  launches over {1 + NBATCHES} batches: {launches}")
    log(f"  launches by width (kernel, 32-bit limbs): {dict(msm_sorted.WIDTH_LAUNCHES)}")

    check_batch_verifies(vk, proofs, SEED + 5, "the last batch")
    if len({json.dumps(pr.points, sort_keys=True) for pr in proofs}) != len(proofs):
        raise AssertionError("batch proofs with distinct witnesses and r, s are not distinct")
    last = rs(NBATCHES)
    for b in (0, 1):
        draws = iter(last[2 * b : 2 * b + 2])
        single = g.prove(r1cs, pk, wits[b], rng=lambda: next(draws), device=dev)
        same = json.dumps(single.to_json()) == json.dumps(proofs[b].to_json())
        log(f"  batch proof {b} == prove() with the same witness, r, s (JSON bytes): {same}")
        if not same:
            raise AssertionError(f"batch proof {b} differs from prove()")

    timed = walls[1:]
    ms_batch = sum(timed) / len(timed) * 1e3
    split = {k: sum(t.get(k, 0.0) for t in splits[1:]) / len(timed) * 1e3 for k in splits[-1]}
    log(f"  B={len(wits)} sha256 {r1cs.curve} prove_batch: {len(wits) * len(timed) / sum(timed):.4f} proofs/s, "
        f"{ms_batch:.1f} ms/batch (mean of batches 1..{NBATCHES}; {smi}): "
        + "  ".join(f"{k}={v:.1f}ms" for k, v in split.items()))
    profile_batch(r1cs, pk, wits, dev, rs(NBATCHES + 1))
    return launches


# kernels of the h stage: the wrapper's launch counter -> the kernel names
# (substrings) the profiler records for its launches
PROFILED_KERNELS = {"emul": ("emul_kernel",), "ntt": ("ntt_pass_kernel",),
                    "mulacc_walk": ("::pack_kernel(", "::mulacc_kernel<"), "ereduce_wide": ("ereduce",)}


def profile_batch(r1cs, pk, wits, dev, rs):
    """One more prove_batch (after the launch counts were read) under
    torch.profiler: the card's busy time, the sum of the device time of
    its kernels and copies, against the batch's wall time under the
    profiler, the kernels that take most of it, every suffix kernel
    (suffix_kernel, suffix_split_kernel) below those, and the device time
    of emul_kernel and ntt_pass_kernel summed over their instantiations.
    Checks that the profiler recorded every launch of the h stage's
    kernels that their wrappers counted in the batch (PROFILED_KERNELS)
    and logs both counts: the profiler can drop a kernel's record
    (PERF.md), and then the busy time is short by its device time. Returns
    {"busy_ms", "wall_ms", "counted", "profiled"}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zokrates_tpu_torch.schemes import groth16 as g

    draws = iter(rs)
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    after = launch_counts()
    dev_ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    counted = {k: after.get(k, 0) - before.get(k, 0) for k in PROFILED_KERNELS}
    profiled = {k: sum(e.count for e in dev_ev if any(n in e.key for n in names))
                for k, names in PROFILED_KERNELS.items()}
    res = {"busy_ms": busy, "wall_ms": wall, "counted": counted, "profiled": profiled}
    log(f"  profiled prove_batch: launches counted by the wrappers {counted}, recorded by the profiler "
        f"{profiled}")
    if busy <= 0:
        log(f"  profiled prove_batch: {wall:.1f} ms wall; device busy time not measured "
            "(the profiler recorded no device events)")
        return res
    log(f"  profiled prove_batch: {wall:.1f} ms wall, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / wall:.3f}); top device time, then the other suffix kernels:")
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "suffix" in e.key]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    for name in ("emul_kernel", "ntt_pass_kernel"):
        evs = [e for e in dev_ev if name in e.key]
        log(f"  profiled {name}: {sum(e.self_device_time_total for e in evs) / 1e3:.2f} ms over "
            f"{sum(e.count for e in evs)} launches")
    if profiled != counted:
        log("  WARNING: the profiler missed launches of the batch; its busy time is short by their device time")
    return res


def run_bls12_381_path(dev, smi, records, witness_result, loaded):
    """Groth16 on BLS12-381 on the card: the sha256 circuit of
    port_artifacts/ and witnesses from the port's interpreter (witness 0,
    preimage [0, ..., 15], proves on the main path); every kernel of its
    prove against its plain version at the prove's shapes (the MSM kernels
    at 12 limbs over Fq and Fq2, the scalar-field kernels on its 255-bit r
    with a quarter of the values within 2^8 of r), appended to `records`;
    full sorted MSMs against the oracle on BLS12-381 and BLS12-377; setup,
    NPROOFS proofs and forgeries; the batch of BATCH witnesses. Returns the
    launch counts of the main path and of the batches, the r1cs, the main
    path's witness and its key pair (the ceremony's phase starts on it).
    `loaded`: load_sha256_bls12_381()'s result and its seconds (run_all
    reads the artifact while it waits for the GM17 setup's child)."""
    import torch
    from zokrates_tpu_torch.schemes import groth16 as g

    curve, tag = "bls12_381", " bls12_381"
    log("== BLS12-381: sha256 (port_artifacts/sha256_bls12_381.out.gz), witnesses")
    t0 = time.perf_counter()
    (prog, r1cs), t_load = loaded
    witness_result[curve] = {}
    clear_launches()
    wits = batch_witnesses(prog, stats=witness_result[curve])
    witness_result[curve]["kernel_launches"] = launch_counts()
    shapes, info = main_path_shapes(r1cs, wits[0])
    # the h16 MSM's walks and suffix are held on a proof's own plan and
    # table below (its mixed walk on two blocks of the plan: its plain
    # version takes 30-45 s for the whole walk at 12 limbs)
    del shapes["fq"]["extra"][" h16"]
    rdev = g._r1cs_device(r1cs, info["n"], dev)
    walks = path_walks(rdev)
    shapes["fr"]["ereduce_wide"] += walk_reduce_shapes(walks)
    log(f"  {r1cs.curve}: {r1cs.num_constraints} constraints, {r1cs.num_variables} variables (read in "
        f"{t_load:.1f} s); {len(wits)} witnesses by the card's generator ({time.perf_counter() - t0:.1f} "
        f"s, the scalar check included); MSM {info}; {walk_summary(walks)}")

    log("== BLS12-381 kernel checks (kernel vs plain version at the prove's shapes, bit-equal)")
    t0 = time.perf_counter()
    # the scalar-field kernels at the B = 1 shapes: the batch's shapes run
    # the same 8-limb instantiations as BN254's r, held in phase 3
    fr = {"emul": [e for e in shapes["fr"]["emul"] if not e[0].startswith("B=")],
          "ereduce_wide": [e for e in shapes["fr"]["ereduce_wide"] if not e[0].startswith("B=")],
          "ntt": (shapes["fr"]["ntt"][0], [e for e in shapes["fr"]["ntt"][1] if not e[0].startswith("B=")])}
    for got in (check_kernels(shapes, dev, tag, SEED + 8, curve),
                check_field_kernels(fr, dev, SEED + 9, curve, tag, near=0.25),
                check_mulacc(rdev, dev, curve, tag, near=0.25, batches=(1,))):
        for name, recs in got.items():
            records[name] += recs
    for c in ("bls12_381", "bls12_377"):
        check_msm_oracle(dev, curve=c)
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== BLS12-381 main path: setup, prove, verify (sha256, 2^15)")
    launches, pk, vk = run_main_path(r1cs, wits[0], dev, forgeries=True)
    log(f"  12-limb MSM launches over setup and {NPROOFS} proofs: {check_width(12, 'the BLS12-381 main path')}")
    log("== BLS12-381 h MSM: shared-bucket vs dense; its h16 suffix and walks on that proof's own table "
        "and plan (bit-equal)")
    _, h16_calls = compare_h_msm(r1cs, wits[0], pk, dev)
    records["suffix"].append(check_suffix_real(h16_calls["suffix"][0], tag, 12, curve))
    records["walk_mixed"].append(check_walk_call(h16_calls["walk"][0], "h16 real" + tag, 12, curve, blocks=32))
    records["walk_general"].append(check_walk_call(h16_calls["walk"][1], "h16 real" + tag, 12, curve))
    del h16_calls
    log(f"== BLS12-381 batched path: prove_batch, B={BATCH} distinct sha256 witnesses")
    launches_batch = run_batch_path(r1cs, pk, vk, wits, dev, smi)
    log(f"  12-limb MSM launches over the batches: {check_width(12, 'the BLS12-381 batched path')}")
    log_matvec(r1cs, dev, curve)
    return launches, launches_batch, r1cs, wits[0], (pk, vk)


def run_gm17_path(r1cs, wit, dev, smi):
    """GM17 on sha256 over the r1cs's curve: setup with a seeded rng,
    GM17_PROOFS proofs with distinct fixed r and their stage split, with the
    launch counts set to 0 just before setup and read after the last
    proof; each proof verifies, a tampered proof (a <-> c) and a wrong
    public input do not, and no plain version runs on the card in the h
    stage or the MSMs. Returns the launch counts, the launches by width
    (the MSM kernels' and emul's) and the proving key."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted, pallas_field
    from zokrates_tpu_torch.schemes import gm17

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    rng = random.Random(SEED + 5)
    clear_launches()
    t0 = time.perf_counter()
    pk, vk = gm17.setup(r1cs, rng=lambda: rng.randrange(1, p), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"  setup: {setup_s:.2f} s (SAP of {len(pk.sap_U)} rows, domain {pk.domain_size}, "
        f"{len(pk.a_query)} variables, {len(vk.data['query'])} instance)")

    proofs, walls, splits = [], [], []
    with PlainGuard() as guard, ShapeTally() as tally:
        for i in range(GM17_PROOFS):
            r = (SEED + 3000 + i) % p
            timings = {}
            t0 = time.perf_counter()
            proofs.append(gm17.prove(r1cs, pk, wit, rng=lambda: r, device=dev, timings=timings))
            walls.append(time.perf_counter() - t0)
            splits.append(timings)
            log(f"  prove {i}: {walls[-1] * 1e3:.1f} ms  "
                + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in timings.items()))
    launches = launch_counts()
    widths = {**msm_sorted.WIDTH_LAUNCHES, **pallas_field.WIDTH_LAUNCHES}
    tally.report(GM17_PROOFS, "GM17 proof")
    log(f"  plain versions on the card in the GM17 h stage and MSMs: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the GM17 path: {guard.calls}")
    missing = [k for k in GM17_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} were not launched on the GM17 path: {launches}")
    log(f"  launches over setup and {GM17_PROOFS} proofs: {launches}")
    log(f"  launches by width (kernel, 32-bit limbs): {widths}")

    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = gm17.verify(vk, proof)
        log(f"  verify {i}: {ok} ({time.perf_counter() - t0:.2f} s)")
        if not ok:
            raise AssertionError(f"GM17 proof {i} failed to verify")
    if len({json.dumps(pr.points, sort_keys=True) for pr in proofs}) != len(proofs):
        raise AssertionError("GM17 proofs with distinct r are not distinct")
    check_forgeries(gm17, vk, proofs[0], curve)

    steady = walls[1:]  # proof 0 carries the query packing and uploads
    split = {k: sum(t.get(k, 0.0) for t in splits[1:]) / len(steady) * 1e3 for k in splits[-1]}
    log(f"  GM17 sha256 {curve} steady state: {sum(steady) / len(steady) * 1e3:.1f} ms/proof over proofs "
        f"1..{len(walls) - 1} ({smi}): " + "  ".join(f"{k}={v:.1f}ms" for k, v in split.items()))
    return launches, widths, pk


# ---------------------------------------------------------------------------
# Marlin: the universal setup at the CLI's default size, the Pedersen-512 index
# ---------------------------------------------------------------------------


MARLIN_DEGREE = 1 << 17        # the CLI's universal-setup -n 17: 131,072 powers of tau
MARLIN_PROOFS = 2
# the kernels every Marlin prove launches (KZG commitments: the sorted MSM;
# fft_ints / ifft_ints: the NTT and emul)
MARLIN_KERNELS = ("walk_mixed", "walk_general", "suffix", "suffix_fold", "ntt", "emul")
MARLIN_STAGES = ("round 1", "round 2", "round 3", "openings")


def load_pedersen512():
    """The stdlib's 512-bit Pedersen hash compiled for bn128
    (port_artifacts/pedersen512_bn128.out.gz), its R1CS and the witness of
    inputs [0, ..., 15] from the port's interpreter."""
    import gzip

    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(os.path.join(ROOT, "port_artifacts", "pedersen512_bn128.out.gz"), "rb") as f:
        prog = deserialize(f.read())
    return r1cs_from_prog(prog), Interpreter().execute(prog, list(range(16)))


class MarlinGuard(PlainGuard):
    """PlainGuard with Marlin's index and prove as its stages (plain field
    products or reductions on CUDA tensors inside marlin.setup_with_srs or
    marlin.prove are counted), and besides, at any depth (the universal
    setup too), every call of a kernel wrapper's plain version on a CUDA
    tensor and every Python scalar multiply of a G1 point."""

    def __init__(self):
        super().__init__()
        from zokrates_tpu_torch.ec.curve import PointG1
        from zokrates_tpu_torch.kernels import msm_sorted, ntt_pallas, pallas_field
        from zokrates_tpu_torch.schemes import marlin

        self.patches += [(marlin, "setup_with_srs", self._stage), (marlin, "prove", self._stage),
                         (PointG1, "__mul__", self._count), (PointG1, "__rmul__", self._count)]
        for mod, names in ((msm_sorted, ("walk_plain", "suffix_plain", "suffix_fold_plain")),
                           (pallas_field, ("emul_plain", "ereduce_wide_plain")),
                           (ntt_pallas, ("fft_core_plain",))):
            self.patches += [(mod, name, self._any) for name in names]

    def _count(self, name, fn):
        def wrapped(*args, **kw):
            self.calls["G1 " + name] = self.calls.get("G1 " + name, 0) + 1
            return fn(*args, **kw)
        return wrapped


class MarlinClock:
    """While active, splits each marlin.prove run through prove() into its
    stages by the transcript's squeezes (alpha ends round 1, beta round 2,
    delta round 3, then the openings) and adds up, per stage, the wall time
    inside Domain.fft_ints / ifft_ints ("transforms"; of it, the host's
    limb conversions, "conversions") and inside groth16._msm_g1, the KZG
    commitments' MSM entry point ("msms"; it ends in a host read, so its
    wall time holds its device work); the rest of a stage is host Python
    (polynomial arithmetic, divisions, evaluations, the transcript). Also
    counts the transforms by (size, inverse) and the MSMs by coefficient
    count."""

    KEYS = ("wall", "transforms", "conversions", "msms")

    def __init__(self):
        from collections import Counter

        self.sizes = Counter()
        self.runs = []

    def _stage(self):
        return MARLIN_STAGES[(self.squeezes >= 1) + (self.squeezes >= 5) + (self.squeezes >= 6)]

    def _close(self):
        now = time.perf_counter()
        self.cur[self._stage()]["wall"] += now - self.t_mark
        self.t_mark = now

    def prove(self, fn):
        """fn() (one marlin.prove), its stage split appended to runs."""
        self.squeezes = 0
        self.cur = {st: dict.fromkeys(self.KEYS, 0.0) for st in MARLIN_STAGES}
        self.t_mark = time.perf_counter()
        out = fn()
        self._close()
        self.runs.append(self.cur)
        return out

    def _timed(self, key, fn, size=None):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.cur[self._stage()][key] += time.perf_counter() - t0
                if size is not None:
                    self.sizes[size(*args)] += 1
        return wrapped

    def __enter__(self):
        from zokrates_tpu_torch.kernels import ntt
        from zokrates_tpu_torch.schemes import groth16, marlin

        squeeze = marlin._Transcript.squeeze

        def counted(tr, r):
            if self.squeezes in (0, 4, 5):  # alpha, beta, delta: a stage ends
                self._close()
            self.squeezes += 1
            return squeeze(tr, r)

        self.saved = [(marlin._Transcript, "squeeze", squeeze), (ntt.Domain, "_ints", ntt.Domain._ints),
                      (ntt, "ints_to_limbs", ntt.ints_to_limbs), (ntt, "limbs_to_ints", ntt.limbs_to_ints),
                      (groth16, "_msm_g1", groth16._msm_g1)]
        marlin._Transcript.squeeze = counted
        ntt.Domain._ints = self._timed("transforms", ntt.Domain._ints,
                                       lambda dom, xs, inverse, device: ("ifft" if inverse else "fft", dom.n))
        ntt.ints_to_limbs = self._timed("conversions", ntt.ints_to_limbs)
        ntt.limbs_to_ints = self._timed("conversions", ntt.limbs_to_ints)
        groth16._msm_g1 = self._timed("msms", groth16._msm_g1,
                                      lambda curve, points, scalars, device=None: ("msm", len(scalars)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)

    def report(self, runs):
        """Mean stage split over `runs` (indices into runs), in ms, logged
        with the host share of each stage."""
        mean = {st: {k: sum(self.runs[i][st][k] for i in runs) / len(runs) * 1e3 for k in self.KEYS}
                for st in MARLIN_STAGES}
        for st, v in mean.items():
            host = v["wall"] - v["transforms"] - v["msms"]
            log(f"    {st:9s} {v['wall']:9.1f} ms: transforms {v['transforms']:8.1f} (host conversions "
                f"{v['conversions']:7.1f}), MSMs {v['msms']:8.1f}, host Python {host:8.1f}")
            v["host_python"] = host
        return mean


class MsmPick(Capture):
    """While active, keeps the walk, suffix and epilogue calls (Capture)
    of two MSMs of the first marlin.prove: h2's commitment (the third KZG
    commitment of round 3, the twelfth kzg.commit of a proof) and the
    first hiding commitment's gamma part (w's blinder, 3 scalars: the
    4-point MSM). Calls of every other MSM are dropped."""

    H2_COMMIT = 11

    def __init__(self):
        super().__init__(self._keep)
        self.tag = None
        self.picked = {"h2": {n: [] for n in self.NAMES}, "hiding": {n: [] for n in self.NAMES}}
        self.n_commit = self.n_gamma = 0
        self.sizes = {}

    def _keep(self, name, args):
        if self.tag is not None:
            self.picked[self.tag][name].append(args)

    def _tagged(self, fn, which):
        def wrapped(srs, coeffs, *args, **kw):
            n = self.n_commit if which == "commit" else self.n_gamma
            tag = {("commit", self.H2_COMMIT): "h2", ("gamma", 0): "hiding"}.get((which, n))
            if which == "commit":
                self.n_commit += 1
            else:
                self.n_gamma += 1
            if tag is None or self.sizes.get(tag) is not None:
                return fn(srs, coeffs, *args, **kw)
            self.tag, self.sizes[tag] = tag, len(coeffs)
            try:
                return fn(srs, coeffs, *args, **kw)
            finally:
                self.tag = None
        return wrapped

    def __enter__(self):
        from zokrates_tpu_torch.schemes import kzg

        self.kzg_saved = (kzg.commit, kzg.commit_gamma)
        kzg.commit = self._tagged(kzg.commit, "commit")
        kzg.commit_gamma = self._tagged(kzg.commit_gamma, "gamma")
        return super().__enter__()

    def __exit__(self, *exc):
        from zokrates_tpu_torch.schemes import kzg

        super().__exit__(*exc)
        kzg.commit, kzg.commit_gamma = self.kzg_saved


def check_picked_msm(calls, label: str, width: int = 8, curve: str = "bn128"):
    """Every walk, suffix and epilogue call of one captured MSM against its
    plain version, bit for bit, timed, with its bound."""
    records = {"walk_mixed": [], "walk_general": [], "suffix": [], "suffix_fold": []}
    for args in calls["walk"]:
        records["walk_" + args[3]].append(check_walk_call(args, label, width, curve))
    for args in calls["suffix"]:
        records["suffix"].append(check_suffix_real(args, "", width, curve, label))
    for args in calls["suffix_fold"]:
        records["suffix_fold"].append(check_fold_call(args, label, width, curve))
    return records


def cube_r1cs(curve: str):
    """The cube program of the JAX package's tests (y == x^3 + x + 5, x
    private, y public) over the curve's r: instance [one, y], witness [x,
    t1 = x*x, t2 = t1*x] (dense index = IR variable), with the witness of
    x = 3."""
    from zokrates_tpu_torch.ir.r1cs import R1CS
    from zokrates_tpu_torch.ir.witness import Witness

    y, x, t1, t2 = 1, 2, 3, 4
    A = [[(x, 1)], [(t1, 1)], [(0, 1)]]
    B = [[(x, 1)], [(x, 1)], [(t2, 1), (x, 1), (0, 5)]]
    C = [[(t1, 1)], [(t2, 1)], [(y, 1)]]
    vals = {x: 3, t1: 9, t2: 27, y: 35}
    return R1CS(curve, 2, 3, A, B, C, {v: v for v in range(1, 5)}), Witness(vals)


def marlin_forgeries(marlin, vk, proof, curve: str):
    """A flipped evals_beta entry, a flipped t_beta and a wrong public
    output must fail marlin.verify. Returns their names."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes.types import Proof, fr_to_json

    def copy():
        return Proof.from_json(json.loads(json.dumps(proof.to_json())))

    def flipped(*path):
        bad = copy()
        d = bad.points
        for key in path[:-1]:
            d = d[key]
        d[path[-1]] = fr_to_json(int(d[path[-1]], 16) ^ 1, curve)
        return bad

    wrong = copy()
    wrong.inputs[0] = fr_to_json((int(wrong.inputs[0], 16) + 1) % P.SCALAR_FIELDS[curve].p, curve)
    for name, bad in (("flipped evals_beta z_a", flipped("evals_beta", "z_a")),
                      ("flipped t_beta", flipped("t_beta")), ("wrong public output", wrong)):
        ok = marlin.verify(vk, bad)
        log(f"  verify {name}: {ok}")
        if ok:
            raise AssertionError(f"a Marlin proof with a {name} verified")


def marlin_seeded(curve: str, seed: int):
    from zokrates_tpu_torch.fields import params as P

    rng = random.Random(seed)
    r = P.SCALAR_FIELDS[curve].p
    return lambda: rng.randrange(1, r)


def run_marlin_path(dev, smi, records):
    """Marlin on the card: the universal setup at MARLIN_DEGREE, the index
    of the Pedersen-512 circuit, MARLIN_PROOFS proofs of its witness with a
    seeded prover rng (each verified, the first split into its stages and
    two of its MSMs captured), the forgeries, and one more proof under
    torch.profiler; the launch counts set to 0 just before the universal
    setup; then every kernel at this path's shapes against its plain
    version (appended to `records`), and a BLS12-381 toy. Returns the
    launch counts over setup, index and proofs, and per proof."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted, pallas_field
    from zokrates_tpu_torch.kernels.fixed_base import fixed_base_for
    from zokrates_tpu_torch.schemes import marlin

    curve = "bn128"
    log("== Marlin: the Pedersen-512 circuit (port_artifacts/pedersen512_bn128.out.gz)")
    t0 = time.perf_counter()
    r1cs, wit = load_pedersen512()
    log(f"  {r1cs.num_constraints} constraints, {r1cs.num_variables} variables, witness of [0..15] by the port's "
        f"interpreter ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    fb = fixed_base_for(curve, "g1")
    log(f"  fixed-base window table (built once a process, on the host: {fb.W} windows of {1 << fb.c} points by "
        f"integer adds, {fb.W} window bases by a Python multiply by 2^{fb.c}; Groth16's setup shares it): "
        f"{time.perf_counter() - t0:.2f} s")
    clear_launches()
    with MarlinGuard() as guard:
        t0 = time.perf_counter()
        srs = marlin.universal_setup(curve, MARLIN_DEGREE, rng=marlin_seeded(curve, SEED + 20), device=dev)
        torch.cuda.synchronize()
        t_srs = time.perf_counter() - t0
        log(f"  universal setup: {len(srs.powers_g1)} powers of tau and {len(srs.gamma_powers_g1)} hiding powers "
            f"in {t_srs:.2f} s on the card (fixed-base; {smi})")
        after_srs = launch_counts()
        t0 = time.perf_counter()
        pk, vk = marlin.setup_with_srs(srs, r1cs, device=dev)
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        after_index = launch_counts()
        nnz = [len(pk.mats[m].entries) for m in "abc"]
        log(f"  index: |H| = {pk.n}, |K| = {pk.k}, nonzeros {nnz}, needs {max(pk.n, 6 * pk.k - 7)} powers: "
            f"{t_index:.2f} s ({smi}); launches {after_index}")

        proofs, walls = [], []
        with MarlinClock() as clock, MsmPick() as pick, ShapeTally() as tally:
            for i in range(MARLIN_PROOFS):
                rand = marlin_seeded(curve, SEED + 30 + i)
                t0 = time.perf_counter()
                proofs.append(clock.prove(lambda: marlin.prove(r1cs, pk, wit, rng=rand, device=dev)))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                log(f"  prove {i}: {walls[-1] * 1e3:.1f} ms")
    launches = launch_counts()
    per_proof = {k: (v - after_index.get(k, 0)) / MARLIN_PROOFS for k, v in launches.items()}
    tally.report(MARLIN_PROOFS, "Marlin proof")
    log(f"  launches over the universal setup {after_srs}, the index {after_index}, all {launches}; "
        f"per proof {per_proof}")
    log(f"  launches by width (kernel, 32-bit limbs): {dict(msm_sorted.WIDTH_LAUNCHES)} "
        f"{dict(pallas_field.WIDTH_LAUNCHES)}")
    log(f"  plain versions on the card and Python G1 scalar multiplies over setup, index and proofs: "
        f"{guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions or Python scalar multiplies ran on the Marlin path: {guard.calls}")
    missing = [k for k in MARLIN_KERNELS if per_proof.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} were not launched by the Marlin proofs: {per_proof}")
    log(f"  transforms and MSMs a proof by (kind, size): "
        f"{ {k: v / MARLIN_PROOFS for k, v in sorted(clock.sizes.items())} }")
    steady = list(range(1, MARLIN_PROOFS))
    log(f"  stage split, mean of proofs {steady[0]}..{steady[-1]} ({smi}):")
    split = clock.report(steady)
    log("  stage split of proof 0 (first transforms and MSMs at each size):")
    clock.report([0])

    verify_ms = []
    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = marlin.verify(vk, proof)
        verify_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  verify {i}: {ok} ({verify_ms[-1]:.1f} ms)")
        if not ok:
            raise AssertionError(f"Marlin proof {i} failed to verify")
    if len({json.dumps(pr.points, sort_keys=True) for pr in proofs}) != len(proofs):
        raise AssertionError("Marlin proofs with distinct prover rngs are not distinct")
    marlin_forgeries(marlin, vk, proofs[0], curve)
    busy = profile_marlin(r1cs, pk, wit, dev)
    ms_proof = sum(walls[1:]) / len(walls[1:]) * 1e3
    log(f"  Marlin Pedersen-512 {curve}: setup {t_srs:.2f} s, index {t_index:.2f} s, {ms_proof:.1f} ms/proof "
        f"(mean of proofs 1..{len(walls) - 1}), verify {sum(verify_ms) / len(verify_ms):.1f} ms; {smi}")
    result = {"setup_s": t_srs, "index_s": t_index, "ms_proof": ms_proof, "walls_ms": [w * 1e3 for w in walls],
              "verify_ms": verify_ms, "split_ms": split, "busy": busy}

    log("== Marlin kernel checks (kernel vs plain version at this path's shapes, bit-equal)")
    t0 = time.perf_counter()
    log(f"  captured MSMs: coefficients {pick.sizes}")
    for tag, calls in pick.picked.items():
        if not calls["walk"]:
            raise AssertionError(f"no MSM was captured for {tag}")
        for name, recs in check_picked_msm(calls, f"marlin {tag}").items():
            records[name] += recs
    del pick
    n = max(size for kind, size in clock.sizes if kind == "fft")
    for fr in ({"emul": [("marlin n^-1, to/from Montgomery", "Fr", 1, n, "row")], "ereduce_wide": [],
                "ntt": (n, [("marlin forward x1", 1, False), ("marlin inverse x1", 1, True)])},
               {"emul": [], "ereduce_wide": [], "ntt": (pk.k, [("marlin index inverse x1", 1, True)])}):
        for name, recs in check_field_kernels(fr, dev, SEED + 21).items():
            records[name] += recs
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== Marlin BLS12-381: the cube program, SRS of degree 64")
    run_marlin_bls12_381_toy(dev)
    return launches, per_proof, result


def profile_marlin(r1cs, pk, wit, dev):
    """One more Marlin proof under torch.profiler: its wall time, the
    card's busy time (kernels and copies) and the kernels that take most
    of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zokrates_tpu_torch.schemes import marlin

    rand = marlin_seeded(r1cs.curve, SEED + 40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marlin.prove(r1cs, pk, wit, rng=rand, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    if busy <= 0:
        log(f"  profiled Marlin proof: {wall:.1f} ms wall; device busy time not measured "
            "(the profiler recorded no device events)")
        return {"wall_ms": wall, "busy_ms": None}
    log(f"  profiled Marlin proof: {wall:.1f} ms wall, device busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}); "
        "top device time:")
    for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy}


def run_marlin_bls12_381_toy(dev):
    """Marlin on BLS12-381 on the card on the cube program: universal setup
    of degree 64, index, one proof that verifies, a forgery that does not,
    every MSM kernel launched at 12 limbs only."""
    from zokrates_tpu_torch.schemes import marlin

    curve = "bls12_381"
    r1cs, wit = cube_r1cs(curve)
    clear_launches()
    t0 = time.perf_counter()
    srs = marlin.universal_setup(curve, 64, rng=marlin_seeded(curve, SEED + 50), device=dev)
    pk, vk = marlin.setup_with_srs(srs, r1cs, device=dev)
    t1 = time.perf_counter()
    proof = marlin.prove(r1cs, pk, wit, rng=marlin_seeded(curve, SEED + 51), device=dev)
    t2 = time.perf_counter()
    ok = marlin.verify(vk, proof)
    log(f"  {curve} cube ({r1cs.num_constraints} constraints): setup and index {t1 - t0:.2f} s, prove "
        f"{(t2 - t1) * 1e3:.1f} ms, verify: {ok}; 12-limb MSM launches "
        f"{check_width(12, 'the Marlin BLS12-381 proof')}")
    if not ok:
        raise AssertionError("the Marlin BLS12-381 proof failed to verify")
    bad = json.loads(json.dumps(proof.to_json()))
    from zokrates_tpu_torch.schemes.types import Proof, fr_to_json

    bad["proof"]["evals_beta"]["z_a"] = fr_to_json(int(bad["proof"]["evals_beta"]["z_a"], 16) ^ 1, curve)
    ok = marlin.verify(vk, Proof.from_json(bad))
    log(f"  verify flipped evals_beta z_a: {ok}")
    if ok:
        raise AssertionError("a forged Marlin BLS12-381 proof verified")


# ---------------------------------------------------------------------------
# Nova: IVC over Pallas, a SHA-256 hash chain
# ---------------------------------------------------------------------------

NOVA_ARTIFACT = "sha256_chain_pallas.out.gz"
NOVA_STEPS, NOVA_RESUMED = 8, 2  # nova-prove of 8 steps, then nova-prove --continue of 2
NOVA_Z0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,  # SHA-256's initial hash value
           0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
# the kernels every Nova step launches (Pedersen commitments: the sorted
# MSM, and emul taking the bases to Montgomery form)
NOVA_KERNELS = ("walk_mixed", "walk_general", "suffix", "suffix_fold", "emul")
NOVA_SPLIT = ("wall", "witness", "cross term", "commitments", "msm", "bases", "fold")
# profiler kernel names of each wrapper's launches (suffix_fold: two a call)
NOVA_PROFILED = {"walk": ("walk_kernel",), "suffix": ("suffix_kernel", "suffix_split_kernel"),
                 "suffix_fold": ("fold_ladder_kernel", "fold_tree_kernel"), "emul": ("emul_kernel",)}


def load_sha256_chain():
    """The Nova step of a SHA-256 hash chain compiled for pallas
    (port_artifacts/sha256_chain_pallas.out.gz: u32[8] h -> sha256(h), the
    stdlib's one-block SHA-256 of a 32-byte message) and its R1CS."""
    import gzip

    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(os.path.join(ROOT, "port_artifacts", NOVA_ARTIFACT), "rb") as f:
        prog = deserialize(f.read())
    return prog, r1cs_from_prog(prog)


def nova_setup_job():
    """nova.setup on the chain's step, as `nova-setup` runs it: (params,
    seconds of the setup call). Host work only (65,536 hash-to-curve
    bases), so main() runs it in a child process beside the earlier
    phases."""
    sys.path.insert(0, ROOT)
    from zokrates_tpu_torch.schemes import nova

    prog, r1cs = load_sha256_chain()
    t0 = time.perf_counter()
    params = nova.setup(prog, r1cs)
    return params, time.perf_counter() - t0


def sha256_chain(words, n: int):
    """n rounds of hashlib's SHA-256 over the 32-byte big-endian state."""
    import hashlib

    for _ in range(n):
        d = hashlib.sha256(b"".join(w.to_bytes(4, "big") for w in words)).digest()
        words = [int.from_bytes(d[4 * i:4 * i + 4], "big") for i in range(8)]
    return words


class NovaGuard(PlainGuard):
    """PlainGuard with nova.prove and nova.verify as its stages, and
    besides, at any depth, every call of a kernel wrapper's plain version
    on a CUDA tensor and every Python scalar multiply of a G1 point; the
    two multiplies of each fold (nova._fold_instance: com_W + r*com_W2,
    com_E + r*com_T) are counted apart, in `folds`."""

    def __init__(self):
        super().__init__()
        from zokrates_tpu_torch.ec.curve import PointG1
        from zokrates_tpu_torch.kernels import msm_sorted, pallas_field
        from zokrates_tpu_torch.schemes import nova

        self.folding = 0
        self.folds = 0
        self.patches += [(nova, "prove", self._stage), (nova, "verify", self._stage),
                         (nova, "_fold_instance", self._fold),
                         (PointG1, "__mul__", self._mul), (PointG1, "__rmul__", self._mul)]
        for mod, names in ((msm_sorted, ("walk_plain", "suffix_plain", "suffix_fold_plain")),
                           (pallas_field, ("emul_plain", "ereduce_wide_plain"))):
            self.patches += [(mod, name, self._any) for name in names]

    def _fold(self, name, fn):
        def wrapped(*args, **kw):
            self.folding += 1
            try:
                return fn(*args, **kw)
            finally:
                self.folding -= 1
        return wrapped

    def _mul(self, name, fn):
        def wrapped(*args, **kw):
            if self.folding:
                self.folds += 1
            else:
                self.calls["G1 " + name] = self.calls.get("G1 " + name, 0) + 1
            return fn(*args, **kw)
        return wrapped


class NovaClock(Capture):
    """While active, splits every step of nova.prove into its stages by
    wall time: "witness" (the interpreter's execute, where a step starts),
    "cross term" (nova._cross_term_relaxed: six host matvecs), and
    "commitments" (nova._commit), of them "msm" (groth16._msm_packed_g1:
    the plan, the kernels and the host combine; it ends in a host read,
    so its wall time holds its device work) and "bases" (groth16._mont_elems:
    the points' limbs on the host, their upload and emul); the rest of the
    commitments is their host preparation, the rest of the step "fold"
    (the full assignment, the transcript, the folds of the instance, W and
    E). A step closes at the next one's witness or at end(). Also keeps
    (Capture) the walk, suffix and epilogue calls of the two MSMs of step
    PICK_STEP + 1 (picked["com_w"], picked["com_t"]) and their point
    counts (n_points)."""

    # the eighth step: on the SHA-256 chain from NOVA_Z0, com_t's MSM pads
    # to 2^15 points from step 4 on (2^13 at step 2, 2^14 at step 3)
    PICK_STEP = 7

    def __init__(self):
        super().__init__(self._keep)
        self.steps = []
        self.cur = self.tag = None
        self.picked = {tag: {n: [] for n in self.NAMES} for tag in ("com_w", "com_t")}
        self.n_points = {}

    def _picking(self) -> bool:
        return self.tag is not None and len(self.steps) == self.PICK_STEP

    def _keep(self, name, args):
        if self._picking():
            self.picked[self.tag][name].append(args)

    def end(self):
        if self.cur is not None:
            c = self.cur
            c["wall"] = time.perf_counter() - self.t_step
            c["fold"] = c["wall"] - c["witness"] - c["cross term"] - c["commitments"]
            self.steps.append(c)
            self.cur = None

    def _timed(self, key, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if self.cur is not None:
                    self.cur[key] += time.perf_counter() - t0
        return wrapped

    def _step(self, fn):
        def wrapped(*args, **kw):
            self.end()
            self.cur, self.commits, self.t_step = dict.fromkeys(NOVA_SPLIT, 0.0), 0, time.perf_counter()
            return fn(*args, **kw)
        return wrapped

    def _commit(self, fn):
        def wrapped(*args, **kw):
            self.tag = ("com_w", "com_t")[self.commits]
            self.commits += 1
            try:
                return fn(*args, **kw)
            finally:
                self.tag = None
        return wrapped

    def _bases(self, fn):
        def wrapped(q, ints, *args, **kw):
            if self._picking():
                self.n_points[self.tag] = len(ints)
            return fn(q, ints, *args, **kw)
        return wrapped

    def __enter__(self):
        from zokrates_tpu_torch.schemes import groth16, nova

        self.clock_saved = [(nova.Interpreter, "execute", nova.Interpreter.execute),
                            (nova, "_cross_term_relaxed", nova._cross_term_relaxed), (nova, "_commit", nova._commit),
                            (groth16, "_msm_packed_g1", groth16._msm_packed_g1),
                            (groth16, "_mont_elems", groth16._mont_elems)]
        nova.Interpreter.execute = self._timed("witness", self._step(nova.Interpreter.execute))
        nova._cross_term_relaxed = self._timed("cross term", nova._cross_term_relaxed)
        nova._commit = self._timed("commitments", self._commit(nova._commit))
        groth16._msm_packed_g1 = self._timed("msm", groth16._msm_packed_g1)
        groth16._mont_elems = self._timed("bases", self._bases(groth16._mont_elems))
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.end()
        for owner, name, fn in reversed(self.clock_saved):
            setattr(owner, name, fn)

    def report(self, steps):
        """Mean split over `steps` (indices into self.steps), in ms, logged."""
        mean = {k: sum(self.steps[i][k] for i in steps) / len(steps) * 1e3 for k in NOVA_SPLIT}
        mean["host prep"] = mean["commitments"] - mean["msm"]
        log(f"    {mean['wall']:8.1f} ms a step: witness {mean['witness']:.1f}, cross term (six host matvecs) "
            f"{mean['cross term']:.1f}, commitments {mean['commitments']:.1f} (MSMs {mean['msm']:.1f}, host "
            f"preparation {mean['host prep']:.1f}, of it the bases to Montgomery form {mean['bases']:.1f}), "
            f"fold {mean['fold']:.1f}")
        return mean


def nova_shapes(picked):
    """The kernels' shapes in a Nova step's two MSMs, read from their
    captured calls (NovaClock.picked): {tag: shapes for check_kernels over
    G1 only} with the mixed walk, the first merge walk, the suffix and the
    epilogue of com_w and of com_t."""
    out = {}
    for tag, calls in picked.items():
        mixed = next(a for a in calls["walk"] if a[3] == "mixed")
        merge = next(a for a in calls["walk"] if a[3] == "general")
        a = calls["suffix"][0][0]
        out[tag] = {"fq": {"walk_mixed": tuple(mixed[1].shape), "walk_general": tuple(merge[1].shape),
                           "suffix": (a.shape[0], a.shape[2]),
                           "fold": {"MSM": tuple(calls["suffix_fold"][0][2:5])}}}
    return out


def nova_forgeries(nova, r1cs, params, proof, dev):
    """The reference tests' tamperings of a proof must fail nova.verify:
    the final state, one step's x, the final W."""
    import copy

    for name, edit in (("final state", lambda pr: pr.zN.__setitem__(0, pr.zN[0] ^ 1)),
                       ("one step's x", lambda pr: pr.steps[1].x.__setitem__(0, (pr.steps[1].x[0] + 1) % 7)),
                       ("final W", lambda pr: pr.final_W.__setitem__(0, pr.final_W[0] + 1))):
        bad = copy.deepcopy(proof)
        edit(bad)
        t0 = time.perf_counter()
        ok = nova.verify(r1cs, params, bad, device=dev)
        log(f"  verify with a tampered {name}: {ok} ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
        if ok:
            raise AssertionError(f"a Nova proof with a tampered {name} verified")


def profile_nova_step(prog, r1cs, params, proof, dev):
    """One more step (nova.prove resuming `proof`: the replay of its
    records, then one step's witness, cross term, two commitments and
    fold) under torch.profiler: wall time, the card's busy time and idle
    share, the kernels that take most of it, and each kernel's launches as
    the profiler recorded them against the wrappers' counts
    (NOVA_PROFILED; suffix_fold's two kernels a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zokrates_tpu_torch.schemes import nova

    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nova.prove(prog, r1cs, params, proof.z0, 1, resume=proof, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    after = launch_counts()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in NOVA_KERNELS}
    counted = {"walk": delta["walk_mixed"] + delta["walk_general"], "suffix": delta["suffix"],
               "suffix_fold": 2 * delta["suffix_fold"], "emul": delta["emul"]}
    dev_ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    profiled = {k: sum(e.count for e in dev_ev if any(n in e.key for n in names))
                for k, names in NOVA_PROFILED.items()}
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    log(f"  profiled step: launches counted by the wrappers {counted}, recorded by the profiler {profiled}")
    if profiled != counted:
        log("  WARNING: the profiler missed launches of the step; its busy time is short by their device time")
    res = {"wall_ms": wall, "busy_ms": busy if busy > 0 else None, "counted": counted, "profiled": profiled}
    if busy <= 0:
        log(f"  profiled step: {wall:.1f} ms wall; device busy time not measured "
            "(the profiler recorded no device events)")
        return res
    res["idle_share"] = 1 - busy / wall
    log(f"  profiled step: {wall:.1f} ms wall (the replay of {len(proof.steps)} records included), device busy "
        f"{busy:.2f} ms (idle share {res['idle_share']:.4f}); top device time:")
    for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return res


def square_step(curve: str):
    """z' = z*z + z (one public argument, one return), the reference tests'
    square_step_prog, and its R1CS."""
    from zokrates_tpu_torch.ir.program import Constraint, LinComb, Parameter, Prog, QuadComb, var_new, var_public
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog

    a, t, out = var_new(0), var_new(1), var_public(0)
    stmts = [Constraint(QuadComb(LinComb.from_var(a), LinComb.from_var(a)), LinComb.from_var(t)),
             Constraint(QuadComb(LinComb.one(), LinComb.from_var(t) + LinComb.from_var(a)), LinComb.from_var(out))]
    prog = Prog(curve=curve, arguments=[Parameter(a, private=False)], return_count=1, statements=stmts)
    return prog, r1cs_from_prog(prog)


def run_nova_compress(dev):
    """compress and verify_compressed on the card on the square step, on
    Pallas and Vesta: 3 steps folded, compressed (the blinding pair's
    three commitments on the card, the sumchecks and the two IPAs on the
    host), verified (the IPAs' final MSMs on the card); a tampered final
    IPA scalar and a tampered evaluation fail. Returns ms by curve."""
    import dataclasses

    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes import nova
    from zokrates_tpu_torch.schemes.ipa import IpaProof

    out = {}
    for curve in ("pallas", "vesta"):
        p = P.SCALAR_FIELDS[curve].p
        prog, r1cs = square_step(curve)
        params = nova.setup(prog, r1cs)
        proof = nova.prove(prog, r1cs, params, [3], 3, device=dev)
        t0 = time.perf_counter()
        cproof = nova.compress(r1cs, params, proof, device=dev)
        t1 = time.perf_counter()
        ok = nova.verify_compressed(r1cs, params, cproof, device=dev)
        t2 = time.perf_counter()
        out[curve] = {"compress_ms": (t1 - t0) * 1e3, "verify_compressed_ms": (t2 - t1) * 1e3}
        log(f"  {curve} square step, 3 steps (n_half {len(params.ck_w)}, {len(params.ck_e)} rows): compress "
            f"{(t1 - t0) * 1e3:.1f} ms, verify_compressed {(t2 - t1) * 1e3:.1f} ms: {ok}")
        if not ok:
            raise AssertionError(f"the compressed Nova proof on {curve} failed to verify")
        w = cproof.ipa_w
        vA, vB, vC, vE = cproof.evals
        for name, bad in (("final IPA scalar", dataclasses.replace(cproof, ipa_w=IpaProof(w.Ls, w.Rs, (w.w0 + 1) % p))),
                          ("evaluation vA", dataclasses.replace(cproof, evals=((vA + 1) % p, vB, vC, vE)))):
            ok = nova.verify_compressed(r1cs, params, bad, device=dev)
            log(f"  verify_compressed with a tampered {name}: {ok}")
            if ok:
                raise AssertionError(f"a compressed Nova proof with a tampered {name} verified")
    return out


def run_nova_path(dev, smi, records, pending_setup):
    """Nova on the card, as a user's nova-setup / nova-prove / nova-prove
    --continue / nova-verify would drive it: the SHA-256 chain's step at
    full width, setup (pending_setup: the future of its result from the
    child process main() started), NOVA_STEPS steps from NOVA_Z0 and
    NOVA_RESUMED more resuming that proof, the final state against
    hashlib, verify, the forgeries; the launch counts set to 0 just before
    the first prove and read after the second, each step's split
    (NovaClock), no plain version on the card and no Python G1 scalar
    multiply but the folds' (NovaGuard); one more step under
    torch.profiler; then the kernels of one step's two MSMs
    (NovaClock.PICK_STEP) against their plain versions on their own
    inputs, and at their shapes on random tables near q on Pallas and
    Vesta, emul at Pasta q, full MSMs against the oracle on both curves
    (appended to `records`); and compress on the square step. Returns the
    launch counts over the 10 steps, per step, and the phase's results."""
    import torch
    from zokrates_tpu_torch.kernels import msm_sorted, pallas_field
    from zokrates_tpu_torch.schemes import nova

    log(f"== Nova: a SHA-256 hash chain on Pallas (port_artifacts/{NOVA_ARTIFACT})")
    t0 = time.perf_counter()
    prog, r1cs = load_sha256_chain()
    nnz = [sum(len(row) for row in m) for m in (r1cs.A, r1cs.B, r1cs.C)]
    log(f"  {r1cs.num_constraints} constraints, {r1cs.num_instance} instance and {r1cs.num_witness} witness "
        f"variables, nonzeros {nnz} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    params, t_setup = pending_setup.result(timeout=900)
    log(f"  setup: {len(params.ck_w)} + {len(params.ck_e)} + 1 hash-to-curve bases in {t_setup:.2f} s of host "
        f"Python (a child process started at the script's start, beside the earlier phases; waited "
        f"{time.perf_counter() - t0:.1f} s for it here); arguments at x{params.arg_pos}, returns at "
        f"x{params.out_pos}")
    if (params.arg_pos, params.out_pos) != (list(range(8)), list(range(8, 16))):
        raise AssertionError("the chain's state is not at x[0..7] / x[8..15]")

    clear_launches()
    with NovaGuard() as guard:
        with NovaClock() as clock, ShapeTally() as tally:
            t0 = time.perf_counter()
            first = nova.prove(prog, r1cs, params, NOVA_Z0, NOVA_STEPS, device=dev)
            torch.cuda.synchronize()
            clock.end()
            t1 = time.perf_counter()
            proof = nova.prove(prog, r1cs, params, NOVA_Z0, NOVA_RESUMED, resume=first, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = launch_counts()
        widths = {**msm_sorted.WIDTH_LAUNCHES, **pallas_field.WIDTH_LAUNCHES}
        ok = nova.verify(r1cs, params, proof, device=dev)
        t3 = time.perf_counter()
    steps = NOVA_STEPS + NOVA_RESUMED
    log(f"  prove {NOVA_STEPS} steps: {(t1 - t0) * 1e3:.1f} ms; prove --continue {NOVA_RESUMED} steps (replay "
        f"included): {(t2 - t1) * 1e3:.1f} ms; verify: {ok} ({(t3 - t2) * 1e3:.1f} ms); {smi}")
    want = sha256_chain(NOVA_Z0, steps)
    log(f"  z_{steps} = {[hex(v) for v in proof.zN]}; {steps} rounds of hashlib.sha256: equal={proof.zN == want}")
    if proof.zN != want or proof.num_steps != steps:
        raise AssertionError("the Nova chain's final state differs from the host's SHA-256 chain")
    if not ok:
        raise AssertionError("the Nova proof failed to verify")
    mults = 2 * (NOVA_STEPS + NOVA_STEPS + NOVA_RESUMED + steps)  # prove, replay, prove, verify
    log(f"  plain versions on the card and Python G1 scalar multiplies outside the folds: {guard.calls or 0}; "
        f"multiplies in the folds {guard.folds} (2 a fold: {mults})")
    if guard.calls or guard.folds != mults:
        raise AssertionError(f"plain versions or Python scalar multiplies ran on the Nova path: {guard.calls}, "
                             f"{guard.folds} in the folds")
    per_step = {k: v / steps for k, v in launches.items()}
    missing = [k for k in NOVA_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} were not launched by the Nova steps: {launches}")
    other = {k: v for k, v in widths.items() if k[1] != 8}
    if other:
        raise AssertionError(f"Nova kernels launched at another width than 8 limbs: {widths}")
    tally.report(steps, "Nova step")
    log(f"  launches over {steps} steps (2 x {steps} - 1 MSMs: step 1's cross term is zero) {launches}, "
        f"per step {per_step}; by (kernel, 32-bit limbs) {widths}")
    log(f"  split of step 1 (no cross-term MSM):")
    split1 = clock.report([0])
    log(f"  split, mean of steps 2..{steps} ({smi}):")
    split = clock.report(list(range(1, steps)))
    for i, st in enumerate(clock.steps):
        log(f"    step {i + 1}: " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st.items()) + " ms")
    nova_forgeries(nova, r1cs, params, proof, dev)
    prof = profile_nova_step(prog, r1cs, params, proof, dev)
    result = {"setup_s": t_setup, "ms_step": split["wall"], "split_ms": split, "split_step1_ms": split1,
              "prove_ms": (t1 - t0) * 1e3, "resume_ms": (t2 - t1) * 1e3, "verify_ms": (t3 - t2) * 1e3,
              "profile": prof}

    log("== Nova kernel checks (kernel vs plain version, bit-equal)")
    t0 = time.perf_counter()
    for tag, calls in clock.picked.items():
        if not calls["walk"]:
            raise AssertionError(f"no call of step {NovaClock.PICK_STEP + 1}'s {tag} MSM was captured")
        for name, recs in check_picked_msm(calls, f"nova step {NovaClock.PICK_STEP + 1} {tag}",
                                           curve="pallas").items():
            records[name] += recs
    shapes = nova_shapes(clock.picked)
    n_t = clock.n_points["com_t"]
    log(f"  step {NovaClock.PICK_STEP + 1}'s MSMs: points {clock.n_points}")
    del clock
    for i, curve in enumerate(("pallas", "vesta")):
        # com_t's shapes (the larger MSM; com_w's run the same walks on fewer lanes)
        for name, recs in check_kernels(shapes["com_t"], dev, f" nova com_t {curve}", SEED + 60 + i, curve,
                                       near=True, safe_mixed=False).items():
            records[name] += recs
        fr = {"emul": [(f"nova bases to Montgomery form, {curve}", "Fq", 1, n_t, "row")], "ereduce_wide": []}
        for name, recs in check_field_kernels(fr, dev, SEED + 62 + i, curve, near=0.25).items():
            records[name] += recs
        check_msm_oracle(dev, n_t, curve, g2=False)
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== Nova compress on the square step (Pallas, Vesta)")
    result["compress"] = run_nova_compress(dev)
    return launches, per_step, result


# ---------------------------------------------------------------------------
# The Groth16 phase-2 ceremony (run_mpc_path)
# ---------------------------------------------------------------------------

# the kernels whose path is the ceremony: its ladders and column sums
MPC_KERNELS = ("mixed_add_lm", "accumulate_lm")
MPC_SAMPLES = 64               # h/l points and columns held to the host oracle
MPC_PROOFS = 3                 # proofs with the BLS12-381 ceremony's key
MPC_BEACON = "00000000000000000003e5ad4bd06a37f2e7ec1d5eaf30a11f1b0a4e8f4d7c9e"  # a block hash
# Python scalar multiplies of a contribution (G1, G2): bellman's s, s_delta,
# delta_after and r_delta, delta_g2; schemes/mpc's delta_g1, pk_s_g1 and
# delta_g2, pk_s_g2
MPC_MULS = {"bellman_mpc.contribute": (3, 2), "mpc.contribute": (2, 2)}


class MpcGuard(PlainGuard):
    """While active: PlainGuard's count, every call of a kernel wrapper's
    plain version on a CUDA tensor at any depth, and the Python scalar
    multiplies of G1 and G2 points made inside the ceremony's stages
    (bellman_mpc.initialize / contribute / verify, mpc.contribute /
    verify), by stage and group, and the point kernels' launches by
    (kernel, 32-bit limbs, stage). Besides, it keeps for the checks: each
    point kernel's last widest call by (kernel, 32-bit limbs, stage) (its
    inputs cloned; a ladder's last step, whose accumulators have begun), every contribution's scaling (bellman_mpc._scale_points,
    mpc.scale_rows: arguments and result) and every initialize's column
    sums (bellman_mpc.TermSums.points: the sums, their terms and the
    seconds of the call)."""

    def __init__(self):
        super().__init__()
        from collections import Counter

        from zokrates_tpu_torch.ec.curve import PointG1, PointG2
        from zokrates_tpu_torch.interop import bellman_mpc
        from zokrates_tpu_torch.kernels import ladder, msm_sorted, pallas_field
        from zokrates_tpu_torch.schemes import mpc

        self.stack = []
        self.muls = Counter()
        self.kernel_calls = {}
        self.kernel_counts = Counter()
        self.scalings = []
        self.sums = []
        for owner, prefix, names in ((bellman_mpc, "bellman_mpc.", ("initialize", "contribute", "verify")),
                                     (mpc, "mpc.", ("contribute", "verify"))):
            self.patches += [(owner, name, self._named(prefix + name)) for name in names]
        self.patches += [(PointG1, "__mul__", self._mul("G1")), (PointG1, "__rmul__", self._mul("G1")),
                         (PointG2, "__mul__", self._mul("G2")), (PointG2, "__rmul__", self._mul("G2")),
                         (ladder, "mixed_add_lm", self._kernel), (ladder, "accumulate_lm", self._kernel),
                         (bellman_mpc, "_scale_points", self._scaling), (mpc, "scale_rows", self._scaling),
                         (bellman_mpc.TermSums, "points", self._sums)]
        for mod, names in ((msm_sorted, ("walk_plain", "suffix_plain", "suffix_fold_plain")),
                           (pallas_field, ("emul_plain", "ereduce_wide_plain", "mixed_add_lm_plain",
                                           "accumulate_lm_plain", "mulacc_walk_plain"))):
            self.patches += [(mod, name, self._any) for name in names]

    def _named(self, stage):
        def wrap(name, fn):
            def wrapped(*args, **kw):
                self.stack.append(stage)
                try:
                    return fn(*args, **kw)
                finally:
                    self.stack.pop()
            return wrapped
        return wrap

    def _mul(self, group):
        def wrap(name, fn):
            def wrapped(*args, **kw):
                if self.stack:
                    self.muls[(self.stack[-1], group)] += 1
                return fn(*args, **kw)
            return wrapped
        return wrap

    def _kernel(self, name, fn):
        def wrapped(p, *args, **kw):
            from zokrates_tpu_torch.fields.jfield import field_spec

            t = args[0]
            if t.is_cuda:
                key = (name, field_spec(p).nl // 2, self.stack[-1] if self.stack else "-")
                self.kernel_counts[key] += 1
                old = self.kernel_calls.get(key)
                if old is None or t.shape[-1] >= old[1][0].shape[-1]:
                    self.kernel_calls[key] = (p, tuple(a.clone() for a in args), dict(kw))
            return fn(p, *args, **kw)
        return wrapped

    def _scaling(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.scalings.append((name, args, out))
            return out
        return wrapped

    def _sums(self, name, fn):
        def wrapped(acc, *args, **kw):
            import torch

            t0 = time.perf_counter()
            out = fn(acc, *args, **kw)
            torch.cuda.synchronize()
            self.sums.append((acc, out, time.perf_counter() - t0))
            return out
        return wrapped


class StepClock:
    """Wall times of named steps, each ending in a device synchronize."""

    def __init__(self):
        self.ms = {}

    def __call__(self, label, fn):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[label] = (time.perf_counter() - t0) * 1e3
        log(f"  {label}: {self.ms[label]:.1f} ms")
        return out


def _file_bytes(obj) -> bytes:
    buf = io.BytesIO()
    obj.write(buf)
    return buf.getvalue()


def _expect_reject(what: str, fn, exc=ValueError):
    """fn() must raise exc (bellman verify) or return False (mpc verify)."""
    try:
        ok = fn()
    except exc as e:
        log(f"  forgery {what}: rejected ({e})")
        return
    if ok is not False:
        raise AssertionError(f"the forgery {what} was not rejected")
    log(f"  forgery {what}: rejected (verify False)")


def run_bellman_bn254(r1cs, wits, dev, smi, guard):
    """The bellman ceremony on BN254 sha256 as the CLI's mpc commands drive
    it: a radix for its 2^15 domain, the file written and read back,
    initialize, a contribution and a beacon, mpc.params written and
    read back, verify (the two hashes), export, prove_batch of the
    witnesses with the exported key (every proof verifies under its vk, in
    one weighted pairing product: verify_all),
    and four forgeries (a tampered h point, a swapped delta_g1, a wrong
    cs_hash, a PublicKey with another r_delta), each rejected; those
    verifies take initialize's result of the honest one (the same circuit
    and radix)."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.interop import bellman_mpc as bm
    from zokrates_tpu_torch.schemes import groth16 as g

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    n = 1 << max(1, (r1cs.num_constraints + r1cs.num_instance - 1).bit_length())
    rng = random.Random(SEED + 70)
    clock = StepClock()
    log(f"== bellman MPC on {curve} sha256: {r1cs.num_constraints} constraints, domain {n}")
    radix = clock("generate_radix", lambda: bm.generate_radix(curve, n, rng=lambda: rng.randrange(1, p), device=dev))
    data = _file_bytes(radix)
    radix = clock("radix file written and read back",
                  lambda: bm.Phase1Radix.read(curve, io.BytesIO(_file_bytes(radix)), n))
    if _file_bytes(radix) != data:
        raise AssertionError("the phase1radix file read back writes other bytes")
    log(f"  phase1radix2m{n.bit_length() - 1}: {len(data)} bytes, byte-equal after the read")
    mpcp = clock("initialize", lambda: bm.initialize(r1cs, radix, device=dev))
    for acc, _, sec in guard.sums[-2:]:
        log(f"    of it {acc.group}'s {len(acc.cols)} terms over {acc.ncols} columns scaled and summed: {sec:.2f} s")
    hashes = [clock("contribute 1", lambda: bm.contribute(mpcp, "alice", device=dev)),
              clock("beacon", lambda: bm.beacon(mpcp, MPC_BEACON, device=dev))]
    data = _file_bytes(mpcp)
    back = clock("mpc.params written and read back", lambda: bm.MPCParameters.read(curve, io.BytesIO(_file_bytes(mpcp))))
    if _file_bytes(back) != data:
        raise AssertionError("the mpc.params file read back writes other bytes")
    log(f"  mpc.params: {len(data)} bytes, byte-equal after the read; {len(mpcp.params.h)} h and "
        f"{len(mpcp.params.l)} l points, {sum(pt is None for pt in mpcp.params.a)} empty a columns")
    # verify runs initialize once here; the forgeries' verifies take its
    # result (the same circuit and radix)
    cached = {}
    orig = bm.initialize

    def memo(r1cs_, radix_, device="cuda"):
        if "mpc" not in cached:
            cached["mpc"] = orig(r1cs_, radix_, device=device)
        return cached["mpc"]

    vrng = random.Random(SEED + 71)
    bm.initialize = memo
    try:
        got = clock("verify", lambda: bm.verify(back, r1cs, radix, rng=lambda: vrng.randrange(p), device=dev))
        if got != hashes:
            raise AssertionError("verify returned other contribution hashes")
        log(f"  verify: the {len(got)} contribution hashes")
        pk, vk = clock("export_keypair", lambda: bm.export_keypair(back, r1cs, device=dev))
        draws = iter([(SEED + 72 + j) % p for j in range(2 * len(wits))])
        proofs = clock(f"prove_batch B={len(wits)}",
                       lambda: g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev))
        if not clock(f"verify {len(proofs)} proofs (verify_all)", lambda: verify_all(vk, proofs, SEED + 73)):
            raise AssertionError("the proofs of the exported key do not all verify")
        log(f"  {len(proofs)} proofs with the exported key verify ({smi})")
        prm, pub = back.params, back.contributions[1]
        forgeries = [("a tampered h point", lambda: setattr(prm, "h", [prm.h[0] * 3] + prm.h[1:])),
                     ("a swapped delta_g1", lambda: setattr(prm, "delta_g1", prm.delta_g1 * 7)),
                     ("a wrong circuit (cs_hash)", lambda: setattr(back, "cs_hash", bytes(64))),
                     ("a PublicKey with another r_delta", lambda: setattr(pub, "r_delta", pub.r_delta * 5))]
        for what, tamper in forgeries:
            saved = (prm.h, prm.delta_g1, back.cs_hash, pub.r_delta)
            tamper()
            _expect_reject(what, lambda: bm.verify(back, r1cs, radix, device=dev))
            prm.h, prm.delta_g1, back.cs_hash, pub.r_delta = saved
    finally:
        bm.initialize = orig
    return {"ms": clock.ms, "radix": radix, "params": mpcp}


def run_mpc_bls12_381(r1cs, wit, keys, dev, smi):
    """schemes/mpc on BLS12-381 sha256 as the CLI drives it: init on the
    key pair the BLS12-381 main path set up on the card (`keys`; mpc.init
    is groth16.setup and then mpc.from_keys, of which this times the
    second), a contribution and a beacon (12-limb ladders), verify,
    export, MPC_PROOFS proofs that verify, and a tampered h query that
    verify rejects."""
    from zokrates_tpu_torch.ec.curve import PointG1, g1_group
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes import groth16 as g, mpc

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    clock = StepClock()
    log(f"== schemes/mpc on {curve} sha256: {r1cs.num_constraints} constraints")
    params = clock("init (from_keys on the main path's setup)", lambda: mpc.from_keys(*keys))
    clock("contribute 1", lambda: mpc.contribute(params, "alice", device=dev))
    clock("beacon", lambda: mpc.beacon(params, MPC_BEACON, device=dev))
    ok = clock("verify", lambda: mpc.verify(params, r1cs))
    if not ok:
        raise AssertionError("the BLS12-381 ceremony failed to verify")
    pk, vk = mpc.export_keys(params)
    for i in range(MPC_PROOFS):
        draws = iter([(SEED + 74 + 2 * i) % p, (SEED + 75 + 2 * i) % p])
        proof = clock(f"prove {i}", lambda: g.prove(r1cs, pk, wit, rng=lambda: next(draws), device=dev))
        if not g.verify(vk, proof):
            raise AssertionError(f"proof {i} with the ceremony's key failed to verify")
    log(f"  {MPC_PROOFS} proofs with the exported key verify (h16_p128 {pk.h16_p128}: the dense h MSM; {smi})")
    saved = pk.h_p128.copy()
    hq = pk.h_query
    bad = PointG1(g1_group(curve), *hq[0]) * 3
    pk.h_query = [(bad.x, bad.y)] + hq[1:]
    _expect_reject("a tampered h query point", lambda: mpc.verify(params, r1cs))
    pk.set_h_rows(saved)
    return {"ms": clock.ms}


def run_bellman_toy(dev):
    """The bellman ceremony on BLS12-381's cube toy (domain 8): radix,
    initialize (accumulate_lm at 12 limbs), a contribution, verify,
    export, a proof that verifies."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.interop import bellman_mpc as bm
    from zokrates_tpu_torch.schemes import groth16 as g

    curve = "bls12_381"
    r1cs, wit = cube_r1cs(curve)
    p = P.SCALAR_FIELDS[curve].p
    rng = random.Random(SEED + 76)
    clock = StepClock()
    log(f"== bellman MPC on the {curve} cube toy")
    radix = clock("generate_radix", lambda: bm.generate_radix(curve, 8, rng=lambda: rng.randrange(1, p), device=dev))
    mpcp = clock("initialize", lambda: bm.initialize(r1cs, radix, device=dev))
    h = clock("contribute", lambda: bm.contribute(mpcp, "carol", device=dev))
    if clock("verify", lambda: bm.verify(mpcp, r1cs, radix, device=dev)) != [h]:
        raise AssertionError("the toy ceremony's verify returned another hash")
    pk, vk = bm.export_keypair(mpcp, r1cs, device=dev)
    proof = g.prove(r1cs, pk, wit, device=dev)
    if not g.verify(vk, proof):
        raise AssertionError("the toy ceremony's key gave a proof that does not verify")
    log("  the exported key's proof verifies")
    return {"ms": clock.ms, "radix": radix, "r1cs": r1cs}


def check_scalings(scalings, nrng):
    """MPC_SAMPLES points of every contribution's scaling against the host:
    Python k * P on the sampled inputs."""
    import torch
    from zokrates_tpu_torch.ec.curve import PointG1, g1_group
    from zokrates_tpu_torch.fields.jfield import field_ops

    t0 = time.perf_counter()
    for name, args, out in scalings:
        if name == "_scale_points":
            curve, pts, k = args[:3]
            live = [i for i, pt in enumerate(pts) if pt is not None and not pt.infinity]
            for i in nrng.choice(live, min(MPC_SAMPLES, len(live)), replace=False):
                want = pts[i] * k
                if out[i] is None or (out[i].x, out[i].y) != (want.x, want.y):
                    raise AssertionError(f"scaled point {i} differs from the host's k * P")
        else:
            curve, rows, k = args[:3]
            grp = g1_group(curve)
            f = field_ops(grp.q)
            idx = nrng.choice(rows.shape[0], min(MPC_SAMPLES, rows.shape[0]), replace=False)

            def affine(r):
                t = torch.as_tensor(r[idx][:, : 2 * f.nl].astype(np.int64))
                return list(zip(f.decode(t[:, : f.nl]), f.decode(t[:, f.nl :])))

            for i, a, b in zip(idx, affine(rows), affine(out)):
                want = PointG1(grp, *a) * k
                if (want.x, want.y) != b:
                    raise AssertionError(f"scaled row {i} differs from the host's k * P")
    log(f"  {len(scalings)} contributions' scalings: {MPC_SAMPLES} sampled points each equal the host's k * P "
        f"({time.perf_counter() - t0:.1f} s)")


def host_columns(r1cs):
    """Each variable's (row, coefficient) entries in A, B and C, read from
    the r1cs itself."""
    cols = {}
    for name in ("A", "B", "C"):
        c = [[] for _ in range(r1cs.num_variables)]
        for r, row in enumerate(getattr(r1cs, name)):
            for j, coef in row:
                c[j].append((r, coef))
        cols[name] = c
    return cols


def check_column_sums(acc, out, radix, r1cs, cols, nrng):
    """MPC_SAMPLES sampled columns of each accumulator of one initialize
    against the host's sum of coefficient * point, its terms rebuilt from
    the r1cs's A / B / C and the radix tables as the JAX package's
    _PointAccum takes them (Python ints): G1 a, b_g1, l/ic, and b_g2. A
    column without terms must be None."""
    from zokrates_tpu_torch.fields import params as P

    nc, ni, m = r1cs.num_constraints, r1cs.num_instance, r1cs.num_variables
    r_ord = P.SCALAR_FIELDS[r1cs.curve].p
    lag, beta, alpha = radix.coeffs_g1, radix.beta_coeffs_g1, radix.alpha_coeffs_g1
    bind = {j: [(nc + j, 1)] for j in range(ni)}  # the instance-binding rows

    def terms_of(name, j):
        if name == "a":
            return [(lag[r], c) for r, c in cols["A"][j] + bind.get(j, [])]
        if name == "b_g1":
            return [(lag[r], c) for r, c in cols["B"][j]]
        if name == "b_g2":
            return [(radix.coeffs_g2[r], c) for r, c in cols["B"][j]]
        return ([(beta[r], c) for r, c in cols["A"][j] + bind.get(j, [])]
                + [(alpha[r], c) for r, c in cols["B"][j]] + [(lag[r], c) for r, c in cols["C"][j]])

    def host_sum(terms):
        s = None
        for pt, coef in terms:
            coef %= r_ord
            if pt is None or not coef:
                continue
            t = pt * coef if coef != 1 else pt
            s = t if s is None else s + t
        return None if s is None or s.infinity else s

    names = (("a", 0), ("b_g1", m), ("l/ic", 2 * m)) if acc.group == "g1" else (("b_g2", 0),)
    for name, base in names:
        terms = [terms_of(name, j) for j in range(m)]
        empty = [j for j in range(m) if not terms[j]]
        if any(out[base + j] is not None for j in empty):
            raise AssertionError(f"a column of {name} without terms is not None")
        live = [j for j in range(m) if terms[j]]
        for j in nrng.choice(live, min(MPC_SAMPLES, len(live)), replace=False):
            want, got = host_sum(terms[j]), out[base + j]
            if (got is None) != (want is None) or (got is not None and (got.x, got.y) != (want.x, want.y)):
                raise AssertionError(f"column {j} of {name} differs from the host's sum")
    return [n for n, _ in names]


def check_mpc_kernels(calls):
    """Each point kernel's captured path call (the widest of each kernel,
    width and stage) against its plain version on the same inputs, bit for
    bit, with its device time, the plain version's and the bound. A mixed
    add costs 11 products but where P (the ladder's accumulator) is at
    infinity; an accumulation step 11 but where its bucket is still empty
    (the first point a bucket takes); bytes: inputs and outputs once, an
    accumulation's points only at the steps that name a bucket."""
    import torch
    from zokrates_tpu_torch.kernels import pallas_field as pf

    out = {name: [] for name in MPC_KERNELS}
    curves = {8: "bn128", 12: "bls12_381", 24: "bw6_761"}
    for (name, width, stage), (p, args, kw) in sorted(calls.items(), key=lambda kv: kv[0]):
        label = {"bellman_mpc.contribute": "mpc contribution", "mpc.contribute": "mpc contribution",
                 "bellman_mpc.initialize": "mpc term ladder" if name == "mixed_add_lm" else "mpc column sums"
                 }.get(stage, stage)
        if stage.startswith("mpc."):
            label += " (schemes/mpc)"
        cb = 2 * width * 4  # bytes of a coordinate: 2*width int32 rows of 16-bit limbs
        kern = getattr(pf, name)
        plain = getattr(pf, name + "_plain")
        got = kern(p, *args, **kw)
        torch.cuda.synchronize()
        want, ms_p = host_ms(lambda: plain(p, *args, **kw))
        ms_k = cuda_ms(lambda: kern(p, *args, **kw))
        if name == "mixed_add_lm":
            N = args[0].shape[1]
            live = int((args[2] != 0).any(0).sum())
            mults, nbytes, shape = MIXED_MULS * live, 8 * cb * N, (2 * width, N)
        else:
            d = args[0].to(torch.int64) & 0xFFFFFFFF
            steps, R = d.shape
            nb = kw.get("n_buckets", 16)
            hit = (d >= 1) & (d < nb)
            firsts = int(torch.unique((d * R + torch.arange(R, device=d.device))[hit]).numel())
            hits = int(hit.sum())
            mults = MIXED_MULS * (hits - firsts)
            nbytes = 4 * steps * R + 2 * cb * hits + 3 * cb * nb * R
            shape = (nb, steps, R)
        rec = _record(name, "Fq", label, shape, got, want, ms_k, ms_p, mults, nbytes, width, curves[width])
        out[name].append(rec)
        del got, want
    return out


def run_mpc_path(dev, smi, records, bn, bls):
    """The Groth16 phase-2 ceremony on the card: the bellman ceremony on
    BN254 sha256 (run_bellman_bn254), schemes/mpc on BLS12-381 sha256
    (run_mpc_bls12_381) and the bellman ceremony on BLS12-381's cube toy
    (run_bellman_toy), with the launch counts set to 0 just before and
    read just after; mixed_add_lm and accumulate_lm launched at 8 and 12
    limbs, no plain version on the card and no Python scalar multiply in
    initialize or verify, a contribution's only its named few (MpcGuard);
    then the host oracle on sampled scaled points and column sums, and the
    point kernels' path calls against their plain versions (appended to
    `records`). Returns the launch counts and the phase's results."""
    from zokrates_tpu_torch.kernels import pallas_field

    prog, r1cs, wits = bn
    r1cs_bls, wit_bls, keys_bls = bls
    clear_launches()
    with MpcGuard() as guard:
        bn_res = run_bellman_bn254(r1cs, wits, dev, smi, guard)
        n_bn = len(guard.sums)
        bls_res = run_mpc_bls12_381(r1cs_bls, wit_bls, keys_bls, dev, smi)
        toy_res = run_bellman_toy(dev)
    launches = launch_counts()
    widths = {k: v for k, v in pallas_field.WIDTH_LAUNCHES.items() if k[0] in MPC_KERNELS}
    log(f"  launches over the ceremony's path: {launches}; point kernels by width {widths}; by (kernel, "
        f"32-bit limbs, stage): {dict(guard.kernel_counts)}")
    missing = [(k, w) for k in MPC_KERNELS for w in (8, 12) if widths.get((k, w), 0) <= 0]
    if missing:
        raise AssertionError(f"the ceremony did not launch {missing}: {widths}")
    stages = {}
    for (stage, group), n in guard.muls.items():
        stages.setdefault(stage, {})[group] = n
    contribs = {"bellman_mpc.contribute": 3, "mpc.contribute": 2}
    want = {s: {"G1": contribs[s] * g1, "G2": contribs[s] * g2} for s, (g1, g2) in MPC_MULS.items()}
    log(f"  plain versions on the card: {guard.calls or 0}; Python scalar multiplies by stage {stages} "
        f"(allowed: {want})")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the ceremony's path: {guard.calls}")
    if stages != want:
        raise AssertionError(f"Python scalar multiplies on the ceremony's path: {stages}, allowed {want}")

    log("== MPC checks: sampled points and columns against the host, the point kernels against their plain versions")
    t0 = time.perf_counter()
    nrng = np.random.default_rng(SEED + 77)
    check_scalings(guard.scalings, nrng)
    bn_cols, toy_cols = host_columns(r1cs), host_columns(toy_res["r1cs"])
    for (acc, out, _), radix, rr, cols in ((guard.sums[0], bn_res["radix"], r1cs, bn_cols),
                                          (guard.sums[1], bn_res["radix"], r1cs, bn_cols),
                                          (guard.sums[n_bn], toy_res["radix"], toy_res["r1cs"], toy_cols),
                                          (guard.sums[n_bn + 1], toy_res["radix"], toy_res["r1cs"], toy_cols)):
        names = check_column_sums(acc, out, radix, rr, cols, nrng)
        log(f"  initialize's {', '.join(names)} sums ({acc.curve}): {MPC_SAMPLES} sampled columns each equal "
            f"the host's (or all, where fewer)")
    for name, recs in check_mpc_kernels(guard.kernel_calls).items():
        records[name] += recs
    log(f"  checks: {time.perf_counter() - t0:.1f} s")
    result = {"bellman_bn254_ms": bn_res["ms"], "mpc_bls12_381_ms": bls_res["ms"], "bellman_toy_ms": toy_res["ms"],
              "point_kernel_widths": {f"{k}@{w}": v for (k, w), v in widths.items()},
              "point_kernel_stages": {f"{k}@{w} {st}": v for (k, w, st), v in guard.kernel_counts.items()}}
    return launches, result


# ---------------------------------------------------------------------------
# BW6-761 recursion: Groth16 over BW6-761 on the stdlib's in-circuit
# BLS12-377 GM17 verifier
# ---------------------------------------------------------------------------

BW6_ARTIFACT = "snark_gm17_bw6_761.out.gz"
BW6_VECTOR = os.path.join("tests", "corpus", "stdlib", "snark", "gm17.json")
BW6_BATCH = 4                  # witnesses of the prove_batch call
BW6_PROOFS = 3                 # B = 1 proofs: a warm-up and two timed
BW6_KERNELS = ("walk_mixed", "walk_general", "suffix", "suffix_fold", "emul", "ereduce_wide", "ntt", "mulacc_walk")


def load_bw6_recursion():
    """The recursion circuit, the stdlib's snark/gm17 wrapper (a GM17 proof
    over BLS12-377 with 3 inner inputs, verified inside a BW6-761 circuit
    by the SnarkVerifyBls12377 directive) compiled for bw6_761
    (port_artifacts/BW6_ARTIFACT, read with gzip), and its R1CS."""
    import gzip

    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(os.path.join(ROOT, "port_artifacts", BW6_ARTIFACT), "rb") as f:
        prog = deserialize(f.read())
    return prog, r1cs_from_prog(prog)


def bw6_witnesses(prog, count: int = BW6_BATCH):
    """`count` witnesses of the recursion circuit from the port's
    interpreter, through the ABI (port_artifacts/snark_gm17_bw6_761.abi.json):
    witness 0 from the reference's test vector (BW6_VECTOR: a valid inner
    proof of inputs [1, 2, 3], output 1), witness b > 0 the same with inner
    input b - 1 raised by 1 (the inner proof fails: output 0, a witness as
    valid as the first), each written in the binary witness format and
    read back. Returns (witnesses, their flat inputs)."""
    import copy

    from zokrates_tpu_torch.abi import encode_inputs
    from zokrates_tpu_torch.fields.field import FIELDS
    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.ir.witness import Witness

    with open(os.path.join(ROOT, BW6_VECTOR)) as f:
        values = json.load(f)["tests"][0]["input"]["values"]
    with open(os.path.join(ROOT, "port_artifacts", BW6_ARTIFACT.replace(".out.gz", ".abi.json"))) as f:
        abi = json.load(f)
    field = FIELDS[prog.curve]
    out, flats = [], []
    for b in range(count):
        vals = copy.deepcopy(values)
        if b:
            inner = vals[0]["inputs"]
            inner[b - 1] = "0x%064x" % (int(inner[b - 1], 16) + 1)
        flats.append(encode_inputs(vals, abi["inputs"], field.P))
        buf = io.BytesIO()
        Interpreter().execute(prog, flats[-1]).write(buf, field)
        out.append(Witness.read(io.BytesIO(buf.getvalue()), field))
    return out, flats


# the recursion circuit as bw6_gm17_setup_job read it, for bw6_host_job,
# which runs next in the same child process
_BW6_READ = {}


def bw6_gm17_setup_job():
    """GM17 setup of the recursion circuit on the card, in a child process
    started with the script (the first of its two jobs): the artifact read,
    kept for bw6_host_job, and gm17.setup with a seeded rng (its
    fixed-base products are plain torch at 48 limbs: minutes). run_all
    waits for it after the CLI phase, so that it never runs beside a timed
    kernel. Returns (pk, vk, {stage: seconds})."""
    sys.path.insert(0, ROOT)
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes import gm17

    t0 = time.perf_counter()
    prog, r1cs = load_bw6_recursion()
    t1 = time.perf_counter()
    _BW6_READ.update(prog=prog, r1cs=r1cs, read=t1 - t0)
    p = P.SCALAR_FIELDS[r1cs.curve].p
    rng = random.Random(SEED + 40)
    pk, vk = gm17.setup(r1cs, rng=lambda: rng.randrange(1, p), device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    return pk, vk, {"read": t1 - t0, "setup": t2 - t1}


def bw6_host_job():
    """The recursion circuit's host work, run in a child process beside the
    earlier phases: the artifact read (deserialize, r1cs_from_prog; taken
    from bw6_gm17_setup_job where that ran first in this process),
    BW6_BATCH witnesses by the scalar interpreter and the levelized
    generator's plan (interp/vectorized.build_plan). Returns (r1cs,
    witnesses, {stage: seconds}, (head, plan, flat inputs)): head is the
    program without its statements (curve, arguments, solvers), for
    VectorizedInterpreter.adopt with the plan, so that the main process
    never reads the artifact nor receives its 4.7M terms twice."""
    sys.path.insert(0, ROOT)
    from zokrates_tpu_torch.interp.vectorized import build_plan
    from zokrates_tpu_torch.ir.program import Prog

    t0 = time.perf_counter()
    if _BW6_READ:
        prog, r1cs, read_s = _BW6_READ.pop("prog"), _BW6_READ.pop("r1cs"), _BW6_READ.pop("read")
    else:
        prog, r1cs = load_bw6_recursion()
        read_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    wits, flats = bw6_witnesses(prog)
    t2 = time.perf_counter()
    plan = build_plan(prog)
    head = Prog(prog.curve, prog.arguments, prog.return_count, [], prog.solvers)
    return r1cs, wits, {"read": read_s, "witnesses": t2 - t1, "plan": time.perf_counter() - t2}, (head, plan, flats)


def bw6_card_witnesses(wits, vec, records):
    """The recursion circuit's witnesses by the levelized generator on the
    card, on the plan bw6_host_job built (adopted): segment 0, the host
    segment (the SnarkVerifyBls12377 solver writes 123k variables) and the
    check batch of 4.7M terms at 12 limbs; each held value for value
    against the scalar interpreter's (outputs 1, 0, 0, 0: an inner input
    changed still satisfies the circuit); then the honest inputs with one
    variable the host solver wrote changed must raise
    UnsatisfiedConstraint. emul and ereduce_wide at the check batch's
    shapes against their plain versions, into `records`. Returns the
    stats."""
    from zokrates_tpu_torch.interp import vectorized
    from zokrates_tpu_torch.interp.interpreter import UnsatisfiedConstraint

    head, plan, flats = vec
    vi = vectorized.VectorizedInterpreter(device="cuda")
    vi.adopt(head, plan)
    label = "BW6-761 recursion witnesses"
    clear_launches()
    got, st = card_witnesses(head, flats, label, vi)
    st["kernel_launches"] = launch_counts()
    hold_to_scalar(head, flats, got, label, st, want=wits)
    outs = [w.return_values() for w in got]
    log(f"  {label}: outputs {outs}")
    if outs != [[1]] + [[0]] * (len(got) - 1):
        raise AssertionError(f"{label}: outputs {outs}, expected 1, 0, 0, 0")
    solve = vectorized.execute_solver

    def tampered(solver, ins, field, solvers=()):
        res = list(solve(solver, ins, field, solvers))
        res[len(res) // 2] = (res[len(res) // 2] + 1) % field.P
        return res

    vectorized.execute_solver = tampered
    try:
        with WitnessGuard() as guard:
            vi.execute(head, flats[0])
        raise AssertionError(f"{label}: a witness with a host-solved variable changed passed the checks")
    except UnsatisfiedConstraint as e:
        st["tampered"] = str(e)
        log(f"  {label}: one host-solved variable changed: UnsatisfiedConstraint ({e})")
    finally:
        vectorized.execute_solver = solve
    if guard.calls:
        raise AssertionError(f"plain field products or reductions ran on the card: {guard.calls}")
    log("== BW6-761 witness generator kernels: emul and ereduce_wide at the check batch's shapes (bit-equal)")
    for name, recs in check_field_kernels(st["shapes"], "cuda", SEED + 31, "bw6_761").items():
        records[name] += recs
    return st


def bw6_field_shapes(r1cs, rdev, walks, N: int):
    """The scalar-field kernels' shapes in this circuit's prove at B = 1, as
    check_field_kernels takes them (emul, ereduce_wide, the NTT; the matvec
    walk is check_mulacc's). prove_batch's B = 4 shapes run the same
    instantiations on more rows; they are not held here, to keep the
    script inside its time limit."""
    m = r1cs.num_variables
    n = rdev.n
    chunk = min(N, 1 << 15)
    return {"emul": [("to_mont", "Fr", 1, m, "row"), ("A*B", "Fr", 1, n, "strided"), ("coset", "Fr", 3, n, "shared"),
                     ("1/Z, n^-1, from_mont", "Fr", 1, n, "row"), ("corrections", "Fr", 3, N, "shared")],
            "ereduce_wide": walk_reduce_shapes(walks) + [("corrections", 3, -(-N // chunk))],
            "ntt": (n, [("forward x3", 3, False), ("inverse x3", 3, True), ("inverse x1", 1, True)])}


def check_bw6_msm_calls(calls, tag: str):
    """Each distinct walk, suffix and epilogue call of one BW6-761 proof
    (`calls`, as Capture keeps them) against its plain version, bit for
    bit, at 24 limbs: the walks on walk_blocks' blocks of their first
    64 lanes (the plain version steps a position at a time over every
    lane: the a/b1/l walk's 147,456 lanes take minutes), the suffix and the
    epilogue whole. Returns check records by kernel."""
    records = {"walk_mixed": [], "walk_general": [], "suffix": [], "suffix_fold": []}
    seen = set()
    for name, argl in calls.items():
        for args in argl:
            if name == "walk":
                key = (name, args[3], tuple(args[1].shape))
            elif name == "suffix":
                key = (name, args[0].shape[0], args[0].shape[2])
            else:
                key = (name,) + tuple(args[2:5])
            if key in seen:
                continue
            seen.add(key)
            label = " ".join(str(v) for v in key[1:]) + tag
            if name == "walk":
                records["walk_" + args[3]].append(check_walk_call(args, label, 24, "bw6_761", blocks=32,
                                                                  max_lanes=64))
            elif name == "suffix":
                records["suffix"].append(check_suffix_real(args, tag, 24, "bw6_761", label=label))
            else:
                records["suffix_fold"].append(check_fold_call(args, label, 24, "bw6_761"))
    return records


def run_bw6_path(dev, smi, records, pending):
    """Groth16 over BW6-761 on the card on the recursion circuit at full
    size (123,507 constraints, domain 2^17): the host work from the child
    process main() started (`pending`); setup; BW6_PROOFS proofs of the
    honest witness (a warm-up and two timed, each split into the prove's
    stages) with the launch counts set to 0 just before setup and read
    after the proofs: the MSM kernels at 24 limbs only, emul, ereduce_wide,
    the NTT and mulacc_walk at 12, no plain version on the card; each proof
    verified by the BW6-761 pairing, a proof with C swapped and one with
    its output flipped rejected; prove_batch of BW6_BATCH distinct
    witnesses (outputs 1, 0, 0, 0) with the counts set to 0 again, its
    proof 0 equal to the first proof byte for byte (same witness, r and
    s), all verified in one weighted pairing product and a false one
    caught; then every kernel of one proof against its plain version at
    the proof's shapes (check_bw6_msm_calls, check_field_kernels,
    check_mulacc), appended to `records`. Returns the launch counts of the
    proofs and of the batch, and the phase's results."""
    import contextlib
    import copy

    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted, ntt_pallas, pallas_field
    from zokrates_tpu_torch.schemes import groth16 as g
    from zokrates_tpu_torch.schemes.types import Proof, fr_to_json

    curve, tag = "bw6_761", " bw6_761"
    log(f"== BW6-761 recursion: Groth16 on the stdlib's in-circuit BLS12-377 GM17 verifier "
        f"(port_artifacts/{BW6_ARTIFACT})")
    t0 = time.perf_counter()
    r1cs, wits, host, vec = pending.result(timeout=900)
    nnz = [sum(len(row) for row in mat) for mat in (r1cs.A, r1cs.B, r1cs.C)]
    log(f"  {r1cs.num_constraints} constraints, {r1cs.num_variables} variables ({r1cs.num_instance} instance), "
        f"nonzeros {nnz}; read in {host['read']:.1f} s, {len(wits)} witnesses in {host['witnesses']:.1f} s and "
        f"the generator's plan in {host['plan']:.1f} s of host Python in a child process started with the script "
        f"(waited {time.perf_counter() - t0:.1f} s here)")
    result = {"host_s": host, "nnz": nnz}
    t0 = time.perf_counter()
    result["witness"] = bw6_card_witnesses(wits, vec, records)
    del vec
    log(f"  witness generator: {time.perf_counter() - t0:.1f} s")
    p = P.SCALAR_FIELDS[curve].p
    rng = random.Random(SEED + 20)
    rs = [((SEED + 3000 + 2 * i) % p, (SEED + 4001 + 2 * i) % p) for i in range(BW6_PROOFS + BW6_BATCH)]

    clear_launches()
    t0 = time.perf_counter()
    pk, vk = g.setup(r1cs, rng=lambda: rng.randrange(1, p), device=dev)
    torch.cuda.synchronize()
    result["setup_s"] = time.perf_counter() - t0
    log(f"  setup: {result['setup_s']:.2f} s (domain {pk.domain_size}, b2 rows {pk.b2_rows().shape[1]} words, h16 rows "
        f"{None if pk.h16_p128 is None else pk.h16_p128.shape})")

    proofs, walls, splits, calls = [], [], [], None
    with PlainGuard() as guard, ShapeTally() as tally:
        for i in range(BW6_PROOFS):
            draws = iter(rs[i])
            timings = {}
            with Capture() if i == 1 else contextlib.nullcontext() as cap:
                t0 = time.perf_counter()
                proofs.append(g.prove(r1cs, pk, wits[0], rng=lambda: next(draws), device=dev, timings=timings))
                walls.append(time.perf_counter() - t0)
            if cap is not None:
                calls = cap.calls
            splits.append(timings)
            log(f"  prove {i}: {walls[-1] * 1e3:.1f} ms  " + "  ".join(f"{k}={v * 1e3:.1f}ms"
                                                                      for k, v in timings.items()))
    launches = launch_counts()
    widths = {**msm_sorted.WIDTH_LAUNCHES, **pallas_field.WIDTH_LAUNCHES, **ntt_pallas.WIDTH_LAUNCHES}
    shapes = tally.report(BW6_PROOFS, "BW6-761 proof")
    log(f"  launches over setup and {BW6_PROOFS} proofs: {launches}; by (kernel, 32-bit limbs) {widths}")
    log(f"  plain versions on the card in the h stage, corrections and MSMs: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the BW6-761 path: {guard.calls}")
    check_launches(launches, BW6_PROOFS, "the BW6-761 path")
    check_width(24, "the BW6-761 path")
    field_widths = {k: v for k, v in widths.items() if k[0] in ("emul", "ereduce_wide", "ntt", "mulacc_walk")}
    if any(k[1] != 12 for k in field_widths) or len(field_widths) != 4:
        raise AssertionError(f"the BW6-761 prove's scalar-field kernels must launch at 12 limbs only: {widths}")
    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = g.verify(vk, proof)
        log(f"  verify {i}: {ok} ({time.perf_counter() - t0:.2f} s); output {int(proof.inputs[-1], 16)}")
        if not ok or int(proof.inputs[-1], 16) != 1:
            raise AssertionError(f"BW6-761 proof {i} failed to verify or its output is not 1")
    if len({json.dumps(pr.points, sort_keys=True) for pr in proofs}) != len(proofs):
        raise AssertionError("BW6-761 proofs with distinct r, s are not distinct")
    swapped = Proof.from_json(copy.deepcopy(proofs[0].to_json()))  # to_json shares the proof's lists
    swapped.points["c"] = proofs[0].points["a"]
    flipped = Proof.from_json(copy.deepcopy(proofs[0].to_json()))
    flipped.inputs[-1] = fr_to_json(0, curve)
    for name, bad in (("C swapped for A", swapped), ("output flipped to 0", flipped)):
        ok = g.verify(vk, bad)
        log(f"  verify with {name}: {ok}")
        if ok:
            raise AssertionError(f"a BW6-761 proof with {name} verified")
    steady = walls[1:]
    result.update(prove_ms=[w * 1e3 for w in walls], split_ms=[{k: v * 1e3 for k, v in t.items()} for t in splits],
                  shapes=shapes)
    log(f"  steady state: {sum(steady) / len(steady) * 1e3:.1f} ms/proof over proofs 1..{len(walls) - 1} ({smi})")

    log(f"== BW6-761 prove_batch, B={BW6_BATCH} distinct witnesses (outputs 1, 0, 0, 0)")
    clear_launches()
    draws = iter([v for pair in [rs[0]] + rs[BW6_PROOFS + 1:] for v in pair])
    timings = {}
    with PlainGuard() as guard:
        t0 = time.perf_counter()
        batch = g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev, timings=timings)
        wall = time.perf_counter() - t0
    launches_batch = launch_counts()
    log(f"  prove_batch: {wall * 1e3:.1f} ms ({BW6_BATCH / wall:.3f} proofs/s)  "
        + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in timings.items()))
    log(f"  launches {launches_batch}; plain versions on the card: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors in the BW6-761 batch: {guard.calls}")
    check_launches(launches_batch, 1, "the BW6-761 batch")
    outs = [int(pr.inputs[-1], 16) for pr in batch]
    if outs != [1] + [0] * (BW6_BATCH - 1):
        raise AssertionError(f"the BW6-761 batch's outputs are {outs}, expected 1, 0, 0, 0")
    if json.dumps(batch[0].to_json()) != json.dumps(proofs[0].to_json()):
        raise AssertionError("prove_batch's proof 0 differs from prove() of the same witness, r and s")
    check_batch_verifies(vk, batch, SEED + 21, "BW6-761 batch")
    result.update(batch_ms=wall * 1e3, batch_split_ms={k: v * 1e3 for k, v in timings.items()})

    log("== BW6-761 kernel checks (kernel vs plain version at the proof's shapes, bit-equal)")
    t0 = time.perf_counter()
    pk._dev.clear()  # the key's device copies: the plain versions below need the room
    torch.cuda.empty_cache()
    for name, recs in check_bw6_msm_calls(calls, tag).items():
        records[name] += recs
    del calls
    n = pk.domain_size
    rdev = g._r1cs_device(r1cs, n, dev)
    walks = path_walks(rdev, (1,))
    N = max(g._msm_tier(r1cs.num_variables), g._msm_tier(n - 1))
    for got in (check_field_kernels(bw6_field_shapes(r1cs, rdev, walks, N), dev, SEED + 22, curve, tag, near=0.25),
                check_mulacc(rdev, dev, curve, tag, near=0.25, batches=(1,), reference=False)):
        for name, recs in got.items():
            records[name] += recs
    result["checks_s"] = time.perf_counter() - t0
    log(f"  checks: {result['checks_s']:.1f} s")
    return launches, launches_batch, result, (r1cs, wits, (pk, vk))


BW6_GM17_PROOFS = 2            # GM17 proofs of the recursion circuit: witnesses 0 and 1


def run_bw6_gm17_path(r1cs, wits, keys, dev, smi, records):
    """GM17 over BW6-761 on the recursion circuit at full size, the key
    from bw6_gm17_setup_job (`keys`: pk, vk, its seconds): the key's
    queries to Montgomery form on the card (pk.dev: emul at 24 limbs) and
    BW6_GM17_PROOFS proofs of witnesses 0 and 1 with fixed r, each split
    into its stages, with the launch counts set to 0 just before: the MSM
    kernels at 24 limbs only, emul at 24 and 12, the NTT at 12, no plain
    version on the card in the h stage or the MSMs (PlainGuard); each
    proof verified by the BW6-761 pairing (outputs 1 and 0), a tampered
    proof (a <-> c) and a wrong public input rejected; then emul and the
    NTT at that prove's shapes against their plain versions (appended to
    `records`). Returns the launch counts and the phase's results."""
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import msm_sorted, ntt_pallas, pallas_field
    from zokrates_tpu_torch.schemes import gm17

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    pk, vk, child_s = keys
    log(f"== GM17 BW6-761: the recursion circuit as a SAP of {len(pk.sap_U)} rows, domain {pk.domain_size}, "
        f"{len(pk.a_query)} variables; setup {child_s['setup']:.1f} s in a child process (read "
        f"{child_s['read']:.1f} s)")
    result = {"setup_s": child_s["setup"], "read_s": child_s["read"]}
    clear_launches()
    proofs, walls, splits = [], [], []
    with PlainGuard() as guard, ShapeTally() as tally:
        t0 = time.perf_counter()
        pkd = pk.dev(dev)
        torch.cuda.synchronize()
        result["key_encoding_s"] = time.perf_counter() - t0
        log(f"  the key's queries to Montgomery form on the card: {result['key_encoding_s']:.2f} s (a, c, h "
            f"{tuple(pkd['a'].shape)}, b {tuple(pkd['bx'].shape)} over Fq)")
        for i in range(BW6_GM17_PROOFS):
            r = (SEED + 5000 + i) % p
            timings = {}
            t0 = time.perf_counter()
            proofs.append(gm17.prove(r1cs, pk, wits[i], rng=lambda: r, device=dev, timings=timings))
            walls.append(time.perf_counter() - t0)
            splits.append(timings)
            log(f"  prove {i}: {walls[-1] * 1e3:.1f} ms  "
                + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in timings.items()))
    launches = launch_counts()
    widths = {**msm_sorted.WIDTH_LAUNCHES, **pallas_field.WIDTH_LAUNCHES, **ntt_pallas.WIDTH_LAUNCHES}
    result["shapes"] = tally.report(BW6_GM17_PROOFS, "GM17 BW6-761 proof")
    log(f"  launches over the encoding and {BW6_GM17_PROOFS} proofs: {launches}; by (kernel, 32-bit limbs) "
        f"{widths}; plain versions on the card in the h stage and MSMs: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors on the GM17 BW6-761 path: {guard.calls}")
    missing = [k for k in GM17_KERNELS if launches.get(k, 0) <= 0]
    check_width(24, "the GM17 BW6-761 path")
    field = {k: v for k, v in widths.items() if k[0] in ("emul", "ntt")}
    if missing or set(field) != {("emul", 24), ("emul", 12), ("ntt", 12)}:
        raise AssertionError(f"the GM17 BW6-761 path must launch {GM17_KERNELS}, emul at 24 and 12 limbs and "
                             f"the NTT at 12 only: {widths}")
    result["verify_s"] = []
    for i, proof in enumerate(proofs):
        t0 = time.perf_counter()
        ok = gm17.verify(vk, proof)
        result["verify_s"].append(time.perf_counter() - t0)
        out = int(proof.inputs[-1], 16)
        log(f"  verify {i}: {ok} ({result['verify_s'][-1]:.2f} s); output {out}")
        if not ok or out != (1 if i == 0 else 0):
            raise AssertionError(f"GM17 BW6-761 proof {i} failed to verify or has output {out}")
    check_forgeries(gm17, vk, proofs[0], curve)
    result.update(prove_ms=[w * 1e3 for w in walls], split_ms=[{k: v * 1e3 for k, v in t.items()} for t in splits])
    log(f"  GM17 BW6-761: {walls[-1] * 1e3:.1f} ms the second proof ({smi})")

    log("== GM17 BW6-761 field kernel checks (emul at 24 limbs over Fq, 12 over r; the NTT at 2^18; bit-equal)")
    t0 = time.perf_counter()
    for name, recs in check_field_kernels(gm17_shapes(pk, dev, curve)["fr"], dev, SEED + 41, curve, " gm17 bw6",
                                          near=0.25).items():
        records[name] += recs
    pk._dev.clear()
    torch.cuda.empty_cache()
    result["checks_s"] = time.perf_counter() - t0
    log(f"  checks: {result['checks_s']:.1f} s")
    return launches, result


class LadderClock:
    """While active, the wall time of a contribution's ladder apart: its
    doublings (jec's CurveOps.double, plain products) and its mixed_add_lm
    calls (the kernel, with its layout), each call ended by a device
    synchronize, and the calls counted."""

    def __init__(self):
        self.s = {"double": 0.0, "mixed_add_lm": 0.0}
        self.n = {"double": 0, "mixed_add_lm": 0}

    def _timed(self, name, fn):
        def wrapped(*args, **kw):
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[name] += time.perf_counter() - t0
            self.n[name] += 1
            return out
        return wrapped

    def __enter__(self):
        from zokrates_tpu_torch.kernels import jec, ladder

        self.saved = [(jec.CurveOps, "double", jec.CurveOps.double), (ladder, "mixed_add_lm", ladder.mixed_add_lm)]
        jec.CurveOps.double = self._timed("double", jec.CurveOps.double)
        ladder.mixed_add_lm = self._timed("mixed_add_lm", ladder.mixed_add_lm)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def run_bw6_mpc(r1cs, wit, keys, dev, smi, records):
    """A contribution to the recursion circuit's Groth16 key (`keys`,
    run_bw6_path's pair after its proofs: mpc.from_keys takes the key over
    and contribute changes it in place), as the CLI's mpc commands drive
    it: one contribute (its ladder over the h query's 2^17 rows and the l
    query's real rows: mixed_add_lm at 24 limbs, the doublings timed
    apart, LadderClock), verify, a contribution whose published [s]G1 was
    changed rejected, export and a Groth16 proof of `wit` with the
    exported key that verifies; the launch counts set to 0 just before:
    mixed_add_lm at 24 limbs, no plain version on the card and only the
    contribution's named Python scalar multiplies (MpcGuard; BW6-761's G2
    points are G1's type, so its two G2 multiplies count as G1); then
    MPC_SAMPLES sampled h and l rows against the host's s^-1 * P
    (check_scalings) and the ladder's widest mixed_add_lm call against its
    plain version (appended to `records`). Returns the launch counts and
    the phase's results."""
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import pallas_field
    from zokrates_tpu_torch.schemes import groth16 as g, mpc

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    clock = StepClock()
    log(f"== schemes/mpc on {curve}: a contribution to the recursion circuit's Groth16 key (h "
        f"{keys[0].h_p128.shape[0]} rows, l {int(keys[0].l_mask.sum())} real rows)")
    clear_launches()
    with MpcGuard() as guard:
        params = clock("init (from_keys on the BW6-761 phase's key pair)", lambda: mpc.from_keys(*keys))
        with LadderClock() as ladder_clock:
            clock("contribute", lambda: mpc.contribute(params, "bw6", device=dev))
        log(f"  the ladder: {ladder_clock.n['double']} doublings {ladder_clock.s['double']:.2f} s (plain products "
            f"at 48 limbs), {ladder_clock.n['mixed_add_lm']} mixed_add_lm calls "
            f"{ladder_clock.s['mixed_add_lm']:.2f} s (the kernel at 24 limbs and its layout)")
        if not clock("verify", lambda: mpc.verify(params, r1cs)):
            raise AssertionError("the BW6-761 ceremony failed to verify")
        contrib = params.contributions[0]
        honest = contrib.pk_s_g1
        contrib.pk_s_g1 = honest + honest
        _expect_reject("a contribution whose published [s]G1 was changed", lambda: mpc.verify(params, r1cs))
        contrib.pk_s_g1 = honest
        pk, vk = mpc.export_keys(params)
        draws = iter([(SEED + 90) % p, (SEED + 91) % p])
        proof = clock("prove with the exported key", lambda: g.prove(r1cs, pk, wit, rng=lambda: next(draws),
                                                                     device=dev))
        if not g.verify(vk, proof):
            raise AssertionError("a proof with the BW6-761 ceremony's key failed to verify")
    launches = launch_counts()
    widths = {k: v for k, v in pallas_field.WIDTH_LAUNCHES.items() if k[0] in MPC_KERNELS}
    stages = {}
    for (stage, group), n in guard.muls.items():
        stages.setdefault(stage, {})[group] = n
    want = {"mpc.contribute": {"G1": sum(MPC_MULS["mpc.contribute"])}}
    log(f"  launches: {launches}; point kernels by width {widths}; plain versions on the card: "
        f"{guard.calls or 0}; Python scalar multiplies by stage {stages} (allowed: {want}) ({smi})")
    if widths.get(("mixed_add_lm", 24), 0) <= 0 or set(widths) != {("mixed_add_lm", 24)}:
        raise AssertionError(f"the BW6-761 contribution must launch mixed_add_lm at 24 limbs only: {widths}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors in the BW6-761 ceremony: {guard.calls}")
    if stages != want:
        raise AssertionError(f"Python scalar multiplies in the BW6-761 ceremony: {stages}, allowed {want}")
    log("== BW6-761 ceremony checks: sampled h and l rows against the host, mixed_add_lm at 24 limbs against its "
        "plain version")
    t0 = time.perf_counter()
    check_scalings(guard.scalings, np.random.default_rng(SEED + 92))
    for name, recs in check_mpc_kernels(guard.kernel_calls).items():
        records[name] += recs
    log(f"  checks: {time.perf_counter() - t0:.1f} s")
    return launches, {"ms": clock.ms, "ladder_s": ladder_clock.s, "ladder_calls": ladder_clock.n,
                      "point_kernel_widths": {f"{k}@{w}": v for (k, w), v in widths.items()}}

# ---------------------------------------------------------------------------
# phase 2b: the CLI (python -m zokrates_tpu_torch), as a user drives it
# ---------------------------------------------------------------------------

CLI_MAIN = ('import "hashes/sha256/sha256";\n\n'
            "def main(private u32[1][16] preimage) -> u32[8] {\n    return sha256(preimage);\n}\n")
# the toy matrix's programs: 20 squarings and an asm block whose `<--`
# assignments compile to Zir directives (every curve and scheme), and a
# Nova step
CLI_TOY = ("def main(private field x, field y) -> field {\n    field mut acc = x;\n"
           "    for u32 i in 0..20 {\n        acc = acc * acc + y;\n    }\n"
           "    field mut q = 0;\n    asm {\n        q <-- acc / y;\n        q * y === acc;\n    }\n"
           "    return acc + q;\n}\n")
CLI_NOVA_STEP = "def main(public field z) -> field {\n    return z * z + z;\n}\n"
# the toy matrix's cells, in the child processes that run them side by
# side (about equal times: a toy Groth16 setup takes 30-50 s on the card,
# its plain field products launch-bound; GM17's 9 s on the BLS12 curves
# and BN254, more over BW6-761's 48 limbs)
CLI_TOY_JOBS = ((("g16", "bn128"),), (("g16", "bls12_381"),), (("g16", "bls12_377"),),
                (("g16", "bw6_761"), ("gm17", "bw6_761")),
                (("gm17", "bn128"), ("gm17", "bls12_381"), ("marlin", "bn128"), ("nova", "pallas")),
                (("mpc", "bn128"),))
CLI_MARLIN_SIZE = 9            # universal-setup -n for the toy: 2^9 powers of tau (it needs 377)


def cli_argv(*args):
    return [sys.executable, "-m", "zokrates_tpu_torch"] + [str(a) for a in args]


def cli_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))


def cli_compile_job(wd: str, overlap: bool = True):
    """The CLI phase's host side, in a child process started with the
    script: `python -m zokrates_tpu_torch compile -i main.zok` of CLI_MAIN
    in `wd`, then `setup` (no kernel of the port runs in a setup: it
    overlaps the build and the reads) and, once the kernels are built
    (built.ok, written by the parent), `compute-witness --vectorized` on
    the first preimage (the card's generator forced: witness.vec), each a
    process of its own timed by wall clock with its start; compile and
    setup are marked done by a file (compile.ok, setup.ok). Meanwhile the
    compiled R1CS (A, B, C, instance and variable counts) against
    bench_artifacts/sha256.out's, abi.json against
    bench_artifacts/sha256.abi.json, and the scalar interpreter's witness
    of the second preimage as witness-file bytes. overlap=False runs the
    three processes one after another and the checks last, each alone."""
    import threading

    from zokrates_tpu_torch.fields.field import FIELDS
    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with open(os.path.join(wd, "main.zok"), "w") as f:
        f.write(CLI_MAIN)
    res = {}
    pre = json.dumps([[list(range(16))]])
    steps = {"compile": ("compile", "-i", "main.zok"), "setup": ("setup",),
             "compute-witness --vectorized": ("compute-witness", "--abi", "-a", pre, "-o", "witness.vec",
                                              "--vectorized")}

    def run(step):
        log_path = os.path.join(wd, step.split()[0] + ".log")
        t0 = time.perf_counter()
        with open(log_path + ".out", "w") as out, open(log_path + ".err", "w") as err:
            rc = subprocess.run(cli_argv(*steps[step]), cwd=wd, env=cli_env(), stdout=out, stderr=err).returncode
        wall = time.perf_counter() - t0
        with open(log_path + ".out") as out, open(log_path + ".err") as err:
            res[step] = {"wall_s": wall, "rc": rc, "stdout": out.read()[-4000:], "stderr": err.read()[-4000:]}
        if rc == 0 and step in ("compile", "setup"):
            open(os.path.join(wd, step + ".ok"), "w").close()

    def witness_after_build():
        # the parent writes `stop` when it ends before the build does
        if wait_for_file(os.path.join(wd, "built.ok"), os.path.join(wd, "stop")):
            run("compute-witness --vectorized")

    run("compile")
    if res["compile"]["rc"]:
        return res
    threads = [threading.Thread(target=run, args=("setup",)), threading.Thread(target=witness_after_build)]
    for t in threads:
        t.start()
        if not overlap:
            t.join()
    t0 = time.perf_counter()
    with open(os.path.join(wd, "out"), "rb") as f:
        prog = deserialize(f.read())
    with open(os.path.join(ROOT, "bench_artifacts", "sha256.out"), "rb") as f:
        ref = deserialize(f.read())
    mine, theirs = r1cs_from_prog(prog), r1cs_from_prog(ref)
    res["r1cs_equal"] = {k: getattr(mine, k) == getattr(theirs, k)
                         for k in ("A", "B", "C", "num_instance", "num_variables")}
    res["constraints"], res["variables"] = mine.num_constraints, mine.num_variables
    with open(os.path.join(wd, "abi.json")) as f, open(os.path.join(ROOT, "bench_artifacts", "sha256.abi.json")) as g:
        res["abi_equal"] = json.load(f) == json.load(g)
    buf = io.BytesIO()
    Interpreter().execute(prog, sha256_inputs(prog, 2)[1]).write(buf, FIELDS[prog.curve])
    res["scalar_witness_1"] = buf.getvalue()
    res["check_s"] = time.perf_counter() - t0
    for t in threads:
        t.join()
    return res


def wait_for_file(path: str, stop: str = "", timeout: float = 900.0) -> bool:
    """Wait until `path` exists (True), or `stop` does (False)."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if stop and os.path.exists(stop):
            return False
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{path} did not appear in {timeout:.0f} s")
        time.sleep(0.2)
    return True


def wait_for_step(wd: str, step: str, job, timeout: float = 900.0):
    """Wait until cli_compile_job has marked `step` done; raise with the
    step's output if the job ended without it."""
    t0 = time.perf_counter()
    path = os.path.join(wd, step + ".ok")
    while not os.path.exists(path):
        if job.done():
            res = job.result().get(step) or {}
            raise AssertionError(f"python -m zokrates_tpu_torch {step} failed:\n{res.get('stdout')}\n"
                                 f"{res.get('stderr')}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"python -m zokrates_tpu_torch {step} did not end in {timeout:.0f} s")
        time.sleep(0.2)


class CliRunner:
    """Subcommands of the CLI, as child processes (`python -m
    zokrates_tpu_torch` in `wd`, timed by wall clock with the process's
    start) or in this process (cli.main with `--device`, files named in
    `wd`), each held to its exit code."""

    def __init__(self, wd: str, dev):
        self.wd, self.dev, self.walls = wd, dev, {}

    def path(self, name: str) -> str:
        return os.path.join(self.wd, name)

    def sub(self, label: str, *args, expect: int = 0):
        t0 = time.perf_counter()
        proc = subprocess.run(cli_argv(*args), cwd=self.wd, env=cli_env(), capture_output=True, text=True)
        self.walls[label] = time.perf_counter() - t0
        if proc.returncode != expect:
            raise AssertionError(f"cli {label}: exit {proc.returncode}, want {expect}\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        return proc.stdout, proc.stderr

    def inproc(self, label: str, *args, expect: int = 0):
        import contextlib

        from zokrates_tpu_torch import cli

        out, err = io.StringIO(), io.StringIO()
        rc = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                cli.main(["--device", str(self.dev)] + [str(a) for a in args])
            except SystemExit as e:
                rc = e.code
        self.walls[label] = self.walls.get(label, 0.0) + time.perf_counter() - t0
        if rc != expect:
            raise AssertionError(f"cli.main {label}: exit {rc}, want {expect}\n{out.getvalue()[-2000:]}\n"
                                 f"{err.getvalue()[-4000:]}")
        return out.getvalue(), err.getvalue()


# how compute-witness names its choice on stderr (pick_interpreter)
GEN_FIRST = "scalar (the first call"   # sha256's first call in a process
GEN_CARD = "vectorized on cuda"


def took_generator(err: str, what: str, want: str) -> str:
    """The generator compute-witness named on stderr, which must start
    with `want`."""
    line = next((ln for ln in err.splitlines() if ln.startswith("witness generator:")), "")
    if not line.startswith("witness generator: " + want):
        raise AssertionError(f"{what} did not take {want}...: {line or err[-2000:]}")
    return line[len("witness generator: "):]


def run_cli_user_flow(run: CliRunner, pending, smi: str, alone: bool = False):
    """compute-witness (the scalar interpreter: a first call), generate-proof,
    verify, export-verifier and print-proof on the compiled sha256, each a
    child process (setup and compute-witness --vectorized run in the
    compile's child: cli_compile_job); a proof with a coordinate changed
    (verify: FAILED, exit 1) and print-proof's remix format through
    cli.main. The generator's witness file (the child's witness.vec) must
    equal the scalar one. Returns the compile job's record."""
    pre = json.dumps([[list(range(16))]])
    _, err = run.sub("compute-witness", "compute-witness", "--abi", "-a", pre)
    scalar = took_generator(err, "compute-witness", GEN_FIRST)
    wait_for_step(run.wd, "setup", pending)
    run.sub("generate-proof", "generate-proof")
    out, _ = run.sub("verify", "verify")
    if out.strip() != "PASSED":
        raise AssertionError(f"verify: {out}")
    with open(run.path("proof.json")) as f:
        proof = json.load(f)
    x = proof["proof"]["a"][0]
    proof["proof"]["a"][0] = "0x" + format(int(x, 16) ^ 1, "0{}x".format(len(x) - 2))
    with open(run.path("tampered.json"), "w") as f:
        json.dump(proof, f)
    out, _ = run.inproc("verify tampered", "verify", "-v", run.path("verification.key"),
                        "-j", run.path("tampered.json"), expect=1)
    if out.strip() != "FAILED":
        raise AssertionError(f"verify of a tampered proof: {out}")
    run.sub("export-verifier", "export-verifier")
    with open(run.path("verifier.sol")) as f:
        sol = f.read()
    out, _ = run.sub("print-proof", "print-proof")
    with open(run.path("proof.json")) as f:
        if json.loads(out) != json.load(f)["proof"]:
            raise AssertionError("print-proof does not print proof.json's points")
    run.inproc("print-proof remix", "print-proof", "-j", run.path("proof.json"), "-f", "remix")
    job = pending.result(timeout=900)
    for step in ("compile", "setup", "compute-witness --vectorized"):
        if step not in job or job[step]["rc"]:
            raise AssertionError(f"python -m zokrates_tpu_torch {step} failed: {job.get(step)}")
        run.walls[step] = job[step]["wall_s"]
    vec = took_generator(job["compute-witness --vectorized"]["stderr"], "compute-witness --vectorized",
                         GEN_CARD + " (forced)")
    log(f"  compile of main.zok, then setup, in a child process started with the script: "
        f"{job['compile']['stdout'].strip()!r}; {job['constraints']} constraints, {job['variables']} variables; "
        f"R1CS equal to bench_artifacts/sha256.out's: {job['r1cs_equal']}; abi.json equal: {job['abi_equal']} "
        f"(checks {job['check_s']:.1f} s)")
    if not all(job["r1cs_equal"].values()) or not job["abi_equal"]:
        raise AssertionError("the CLI's compile of sha256 differs from bench_artifacts/sha256.out")
    with open(run.path("witness"), "rb") as f, open(run.path("witness.vec"), "rb") as g:
        same = f.read() == g.read()
    log(f"  compute-witness: {scalar}; compute-witness --vectorized: {vec}; the generator's witness file equal "
        f"to the scalar interpreter's: {same}")
    if not same:
        raise AssertionError("the card generator's witness file differs from the scalar interpreter's")
    log(f"  verify: PASSED; with a coordinate of a changed: FAILED, exit 1; verifier.sol {len(sol)} bytes")
    where = ("each alone" if alone else "under contention: compile, setup and compute-witness --vectorized in "
             "the compile's child beside the build and each other, the rest beside the toy matrix's processes")
    log(f"  {smi}; wall s a subcommand, process start included ({where}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.walls.items()))
    return job


def run_cli_batch(run: CliRunner, dev, job):
    """BATCH witnesses by cli.main compute-witness in this process (the
    program read once; the first by the scalar interpreter, the rest by
    the card's generator, planned and captured once), then generate-proof
    -w ... --also-witness ... on all of them (groth16.prove_batch) with the
    launch counts set to 0 just before and read just after, under a
    PlainGuard; every proof verifies."""
    import torch
    from zokrates_tpu_torch import cli
    from zokrates_tpu_torch.schemes.types import Proof, VerificationKey

    ms = []
    for b in range(BATCH):
        t0 = time.perf_counter()
        _, err = run.inproc("compute-witness x16", "compute-witness", "-i", run.path("out"), "-s",
                            run.path("abi.json"), "-o", run.path(f"w{b}"), "--abi",
                            "-a", json.dumps([[[16 * b + j for j in range(16)]]]))
        ms.append((time.perf_counter() - t0) * 1e3)
        took_generator(err, f"cli.main compute-witness {b}", GEN_FIRST if b == 0 else GEN_CARD)
    gen = cli._LAST["generators"][torch.device(dev)]
    with open(run.path("w0"), "rb") as f, open(run.path("witness"), "rb") as g:
        same = f.read() == g.read()
    with open(run.path("w1"), "rb") as f:
        same1 = f.read() == job["scalar_witness_1"]
    rest = ms[2:]
    log(f"  {BATCH} witnesses by cli.main: the first {ms[0]:.1f} ms (read, the scalar interpreter), the second "
        f"{ms[1]:.1f} ms (the generator's plan, eager run and capture), then {sum(rest) / len(rest):.1f} ms each "
        f"({min(rest):.1f}-{max(rest):.1f}, replays); plans built: {len(gen._plans)}; witness 0 equal to the "
        f"child process's: {same}; witness 1 (the generator's) equal to the scalar interpreter's: {same1}")
    if len(gen._plans) != 1 or not same or not same1:
        raise AssertionError("the in-process witnesses did not share one plan, or differ from the scalar ones")
    extra = [a for b in range(1, BATCH) for a in ("--also-witness", run.path(f"w{b}"))]
    clear_launches()
    with PlainGuard() as guard:
        out, _ = run.inproc("generate-proof --also-witness", "generate-proof", "-i", run.path("out"),
                            "-w", run.path("w0"), *extra, "-p", run.path("proving.key"),
                            "-j", run.path("batch.json"))
    launches = launch_counts()
    log(f"  generate-proof --also-witness x{BATCH - 1}: {run.walls['generate-proof --also-witness']:.2f} s; "
        f"{out.strip()}; launches {launches}; plain versions on the card: {guard.calls or 0}")
    if guard.calls:
        raise AssertionError(f"plain versions ran on CUDA tensors in the CLI's batch: {guard.calls}")
    check_launches(launches, 1, "the CLI's --also-witness batch")
    with open(run.path("verification.key")) as f:
        vk = VerificationKey.from_json(json.load(f))
    proofs = []
    for i in range(BATCH):
        with open(run.path(f"batch.json.{i}")) as f:
            proofs.append(Proof.from_json(json.load(f)))
    check_batch_verifies(vk, proofs, SEED + 90, "the CLI's batch")
    out, _ = run.inproc("verify batch.json.15", "verify", "-v", run.path("verification.key"),
                        "-j", run.path(f"batch.json.{BATCH - 1}"))
    if out.strip() != "PASSED":
        raise AssertionError(f"verify of the batch's last proof: {out}")
    return launches, {"witness_ms": ms}


def toy_cell(run: CliRunner, scheme: str, curve: str, ms: dict):
    """One cell of the toy matrix through cli.main: CLI_TOY compiled for
    `curve` and its witness (x = 3, y = 7), then `scheme`'s setup,
    generate-proof and verify (g16: the proof's MSM kernels at the curve's
    width only; on bn128 also the witness by the card's generator, forced,
    with the Zir solvers in its host segment, equal to the scalar one; on
    bls12_377 a tampered proof and a wrong public input rejected); "mpc":
    the bellman ceremony from a phase-1 radix (mpc-init, mpc-contribute,
    mpc-verify, mpc-export) and a proof with the exported key, the launch
    counts set to 0 just before it; "nova": CLI_NOVA_STEP's nova-setup,
    nova-prove (3 steps) and nova-verify. Returns the launch counts of
    the cell's last stage."""
    from zokrates_tpu_torch import cli
    from zokrates_tpu_torch.interop import bellman_mpc as bm
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.schemes import groth16 as g
    from zokrates_tpu_torch.schemes.types import Proof, VerificationKey

    p = run.path
    tag = f"{scheme} {curve}"

    def step(label, *args):
        t0 = time.perf_counter()
        out = run.inproc(label, *args)[0]
        ms[label] = (time.perf_counter() - t0) * 1e3
        return out

    def prove(out, wit, pk, vk, s="g16"):
        step(f"{tag} generate-proof", "generate-proof", "-i", out, "-w", wit, "-p", pk, "-j", p(tag + ".proof"),
             "-s", s)
        if step(f"{tag} verify", "verify", "-v", vk, "-j", p(tag + ".proof")).strip() != "PASSED":
            raise AssertionError(f"the toy's {tag} proof failed to verify")

    if scheme == "nova":
        with open(p("nova.zok"), "w") as f:
            f.write(CLI_NOVA_STEP)
        step("nova compile", "compile", "-i", p("nova.zok"), "-c", curve, "-o", p("nova.out"), "-s", p("nova.abi"))
        step("nova-setup", "nova-setup", "-i", p("nova.out"), "-o", p("nova.params"))
        step("nova-prove", "nova-prove", "-i", p("nova.out"), "-p", p("nova.params"), "-a", "3", "-n", "3",
             "-o", p("nova.proof"))
        if not step("nova-verify", "nova-verify", "-i", p("nova.out"), "-p", p("nova.params"),
                    "-j", p("nova.proof")).startswith("PASSED"):
            raise AssertionError("nova-verify failed on the toy step")
        return {}
    out, wit = p(f"toy_{curve}.out"), p(f"toy_{curve}.wit")
    if not os.path.exists(out):
        with open(p("toy.zok"), "w") as f:
            f.write(CLI_TOY)
        step(f"{tag} compile", "compile", "-i", p("toy.zok"), "-c", curve, "-o", out, "-s", p(f"toy_{curve}.abi"))
        step(f"{tag} compute-witness", "compute-witness", "-i", out, "-o", wit, "-a", "3 7")
    if tag == "g16 bn128":
        step("compute-witness --vectorized", "compute-witness", "-i", out, "-o", p("toy_vec.wit"), "-a", "3 7",
             "--vectorized")
        plan = cli._generator(run.dev).plan(cli._load_prog(out))
        hosts = sum(h is not None for h in plan.host_groups)
        with open(p("toy_vec.wit"), "rb") as f, open(wit, "rb") as g_:
            same = f.read() == g_.read()
        if not same or not hosts:
            raise AssertionError(f"the toy's card witness equal to the scalar one: {same}; host groups {hosts}")
    if scheme == "mpc":
        r1cs = r1cs_from_prog(cli._load_prog(out))
        radix = bm.generate_radix(curve, cli._radix_size(r1cs), device=run.dev)
        with open(p("radix"), "wb") as f:
            radix.write(f)
        clear_launches()
        step("mpc-init", "mpc-init", "-i", out, "-o", p("mpc.params"), "-r", p("radix"))
        step("mpc-contribute", "mpc-contribute", "-i", p("mpc.params"), "-o", p("mpc.params"), "-e", "chip smoke")
        if "Contributions verified" not in step("mpc-verify", "mpc-verify", "-i", p("mpc.params"), "-c", out,
                                                "-r", p("radix")):
            raise AssertionError("mpc-verify did not verify the toy ceremony")
        step("mpc-export", "mpc-export", "-i", p("mpc.params"), "-p", p("mpc.pk"), "-v", p("mpc.vk"),
             "--circuit", out)
        launches = launch_counts()
        if any(launches.get(k, 0) <= 0 for k in MPC_KERNELS):
            raise AssertionError(f"the point kernels did not launch in the CLI's ceremony: {launches}")
        prove(out, wit, p("mpc.pk"), p("mpc.vk"))
        return launches
    setup = ["setup", "-i", out, "-s", scheme, "-p", p(tag + ".pk"), "-v", p(tag + ".vk")]
    if scheme == "marlin":
        step("universal-setup", "universal-setup", "-c", curve, "-n", CLI_MARLIN_SIZE, "-u", p("srs"))
        setup += ["-u", p("srs")]
    step(f"{tag} setup", *setup)
    clear_launches()
    prove(out, wit, p(tag + ".pk"), p(tag + ".vk"), scheme)
    launches = launch_counts()
    if scheme == "g16" or tag == "gm17 bw6_761":
        check_width({"bn128": 8, "bls12_381": 12, "bls12_377": 12, "bw6_761": 24}[curve], f"the CLI's {tag} proof")
    if tag == "gm17 bw6_761":
        from zokrates_tpu_torch.kernels import pallas_field

        if pallas_field.WIDTH_LAUNCHES.get(("emul", 24), 0) <= 0:
            raise AssertionError(f"the CLI's {tag} proof did not launch emul at 24 limbs (the key's queries)")
    if tag == "g16 bls12_377":
        with open(p(tag + ".vk")) as f, open(p(tag + ".proof")) as g_:
            check_forgeries(g, VerificationKey.from_json(json.load(f)), Proof.from_json(json.load(g_)), curve)
    return launches


def cli_toy_job(wd: str, cells):
    """Cells of the toy matrix (toy_cell) in this child process, on the
    card, in the directory `wd`: the launch counts of each cell's last
    stage and each step's ms."""
    import torch
    from zokrates_tpu_torch.kernels import cuda

    t0 = time.perf_counter()
    cuda.load()
    os.makedirs(wd, exist_ok=True)
    run = CliRunner(wd, torch.device("cuda"))
    ms, launches = {}, {}
    for scheme, curve in cells:
        launches[f"{scheme} {curve}"] = toy_cell(run, scheme, curve, ms)
    return {"ms": ms, "launches": launches, "wall_s": time.perf_counter() - t0}


def run_cli_path(dev, smi, pending_compile, wd: str, alone: bool = False):
    """The CLI phase (before the kernel checks: nothing of it is timed
    beside them): the compile's and setup's child, the user's flow as
    child processes while the toy matrix's cells run in child processes
    side by side (CLI_TOY_JOBS, each through cli.main in its process), then
    the batch in this one. alone=True: no toy matrix, and the flow starts
    once the compile's child has ended, so that each subcommand's wall
    time is its own. Returns the runner (its files), the launches (rows
    1-7: the batch's; the point kernels: the ceremony's; the batch's alone
    where `alone`) and the phase's record."""
    import torch

    torch.cuda.empty_cache()  # the child processes need the card's memory
    wait_for_step(wd, "compile", pending_compile)
    run = CliRunner(wd, dev)
    t0 = time.perf_counter()
    if alone:
        pending_compile.result(timeout=900)
        t0 = time.perf_counter()
        job = run_cli_user_flow(run, pending_compile, smi, alone=True)
        t1 = time.perf_counter()
        launches, batch = run_cli_batch(run, dev, job)
        t2 = time.perf_counter()
        return run, launches, {"device": smi, "constraints": job["constraints"], "walls_s": run.walls,
                               "batch": batch, "flow_s": t1 - t0, "batch_s": t2 - t1}
    with ProcessPoolExecutor(len(CLI_TOY_JOBS), mp_context=multiprocessing.get_context("spawn")) as pool:
        toys = [pool.submit(cli_toy_job, run.path(f"toys{i}"), cells) for i, cells in enumerate(CLI_TOY_JOBS)]
        job = run_cli_user_flow(run, pending_compile, smi)
        t1 = time.perf_counter()
        launches, batch = run_cli_batch(run, dev, job)
        t2 = time.perf_counter()
        done = [f.result(timeout=900) for f in toys]
    ms = {k: v for d in done for k, v in d["ms"].items()}
    cells = {k: v for d in done for k, v in d["launches"].items()}
    log(f"  the flow {t1 - t0:.1f} s, the batch {t2 - t1:.1f} s; the toy processes' own walls "
        + ", ".join(f"{'+'.join(' '.join(c) for c in j)} {d['wall_s']:.1f} s" for j, d in zip(CLI_TOY_JOBS, done)))
    log(f"  toy matrix in {len(toys)} child processes ({time.perf_counter() - t0:.1f} s from the flow's start), "
        f"every proof verified: {', '.join(' '.join(c) for j in CLI_TOY_JOBS for c in j)}; the bn128 toy's card "
        f"witness equal to the scalar one, its Zir solvers in a host segment; each g16 proof's MSM kernels at its "
        f"curve's width; bls12_377 forgeries rejected; the ceremony's point kernel launches "
        f"{({k: cells['mpc bn128'].get(k, 0) for k in MPC_KERNELS})}")
    log("  ms a step: " + ", ".join(f"{k} {v:.0f}" for k, v in ms.items()))
    merged = dict(launches)
    merged.update({k: cells["mpc bn128"].get(k, 0) for k in MPC_KERNELS})
    result = {"device": smi, "constraints": job["constraints"], "walls_s": run.walls, "batch": batch,
              "toy_ms": ms, "toy_launches": cells, "flow_s": t1 - t0, "batch_s": t2 - t1,
              "phase_s": time.perf_counter() - t0}
    return run, merged, result


def cli_keys(run: CliRunner):
    """The CLI's proving.key and verification.key."""
    from zokrates_tpu_torch import cli
    from zokrates_tpu_torch.schemes.types import VerificationKey

    with open(run.path("proving.key"), "rb") as f:
        pk = cli.load_pickle(f)
    with open(run.path("verification.key")) as f:
        return pk, VerificationKey.from_json(json.load(f))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    # Nova's setup, the BW6-761 recursion circuit's read and witnesses and
    # the CLI's compile of sha256 are host work alone: each runs in a child
    # process beside the phases before its own, which takes it out of the
    # script's wall time (a child that dies fails the result with
    # BrokenProcessPool). The recursion circuit's child first reads it and
    # runs its GM17 setup on the card (bw6_gm17_setup_job), then its host
    # work (bw6_host_job): one worker, so the second job finds the read
    wd = tempfile.mkdtemp(prefix="zkt_cli_")
    spawn = multiprocessing.get_context("spawn")
    try:
        with ProcessPoolExecutor(2, mp_context=spawn) as host_jobs, \
                ProcessPoolExecutor(1, mp_context=spawn) as bw6_jobs:
            pending = [host_jobs.submit(nova_setup_job), bw6_jobs.submit(bw6_gm17_setup_job),
                       bw6_jobs.submit(bw6_host_job), host_jobs.submit(cli_compile_job, wd)]
            try:
                run_all(dev, t_all, *pending, wd)
            finally:
                open(os.path.join(wd, "stop"), "w").close()
                for job in pending:
                    job.cancel()
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def run_all(dev, t_all, pending_setup, pending_gm17_bw6, pending_bw6, pending_compile, wd):
    """Every phase, then the kernels line, the card's line and the result."""
    import torch
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.native import available as native_available
    from zokrates_tpu_torch.schemes import groth16 as g

    log("== device")
    smi = nvidia_smi()
    log(f"  {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("== build")
    t0 = time.perf_counter()
    built = cuda.build()
    log(f"  nvcc, {len(built)} sources in parallel: {time.perf_counter() - t0:.1f} s")
    for so, output in built.values():
        log(f"  -> {os.path.relpath(so, ROOT)}")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("    " + line.strip())
    cuda.load()
    t0 = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native host library did not build")
    log(f"  native host library: {time.perf_counter() - t0:.1f} s")
    open(os.path.join(wd, "built.ok"), "w").close()  # cli_compile_job's witness waits for it

    log("== load sha256")
    t0 = time.perf_counter()
    prog, r1cs, wit = load_sha256()
    shapes, info = main_path_shapes(r1cs, wit)
    # the h16 MSM's walks, suffix and epilogue are held on a proof's own
    # plan and table after the main path (check_h16_real), not here on
    # random tables at the same shapes
    del shapes["fq"]["extra"][" h16"], shapes["fq"]["fold"]["h16 MSM"]
    rdev = g._r1cs_device(r1cs, info["n"], dev)
    walks = path_walks(rdev)
    shapes["fr"]["ereduce_wide"] += walk_reduce_shapes(walks)
    log(f"  {r1cs.num_constraints} constraints, {r1cs.num_variables} variables "
        f"({time.perf_counter() - t0:.1f} s); MSM {info}; {walk_summary(walks)}")

    log("== the CLI: python -m zokrates_tpu_torch compile and setup (a child process since the start), "
        "compute-witness / generate-proof / verify / export-verifier / print-proof on sha256 beside the toy "
        "matrix's processes, then a 16-witness batch through cli.main")
    cli_run, launches_cli, cli_result = run_cli_path(dev, smi, pending_compile, wd)
    log(f"  CLI phase: {cli_result['phase_s']:.1f} s")
    print(json.dumps({"cli": cli_result}), flush=True)
    t0 = time.perf_counter()
    bls_loaded = (load_sha256_bls12_381(), time.perf_counter() - t0)  # host work, while the child ends its setup
    t1 = time.perf_counter()
    gm17_bw6_keys = pending_gm17_bw6.result(timeout=1100)
    log(f"== GM17 BW6-761 setup in its child process: {gm17_bw6_keys[2]['setup']:.1f} s (the BLS12-381 sha256 "
        f"artifact read meanwhile, {bls_loaded[1]:.1f} s; then waited {time.perf_counter() - t1:.1f} s: the "
        f"setup runs beside no timed kernel)")

    log("== kernel checks (kernel vs plain version, bit-equal)")
    t0 = time.perf_counter()
    records = check_kernels(shapes, dev)
    records.update(check_field_kernels(shapes["fr"], dev))
    records.update(check_mulacc(rdev, dev))
    check_msm_oracle(dev)
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== main path: prove, verify (sha256, 2^15) with the CLI's proving key")
    launches, pk, vk = run_main_path(r1cs, wit, dev, keys=cli_keys(cli_run))

    log("== h MSM: shared-bucket (the prove's) vs dense, same h scalars")
    _, h16_calls = compare_h_msm(r1cs, wit, pk, dev)
    log("== the h16 walks, suffix and epilogue on that proof's own plan (kernel vs plain version, bit-equal)")
    for name, recs in check_h16_real(h16_calls).items():
        records[name] += recs
    del h16_calls

    log(f"== witness generator: B={BATCH} distinct sha256 witnesses on the card (interp/vectorized.py)")
    witness_result = {"bn128": {}}
    clear_launches()
    wits = batch_witnesses(prog, stats=witness_result["bn128"])
    witness_result["bn128"]["kernel_launches"] = launch_counts()
    log("== witness generator kernels: emul and ereduce_wide at its widest sha256 calls (bit-equal)")
    for name, recs in check_field_kernels(witness_result["bn128"]["shapes"], dev, SEED + 30).items():
        records[name] += recs
    log("== witness generator: Pedersen-512 and the solver program")
    t0 = time.perf_counter()
    run_witness_path(witness_result)
    log(f"  witness phase: {time.perf_counter() - t0:.1f} s")
    log(f"== batched path: prove_batch, B={BATCH} distinct sha256 witnesses")
    launches_batch = run_batch_path(r1cs, pk, vk, wits, dev, smi)
    log_matvec(r1cs, dev, "bn128")

    launches_bls, launches_bls_batch, r1cs_bls, wit_bls, keys_bls = run_bls12_381_path(dev, smi, records,
                                                                                       witness_result, bls_loaded)
    del bls_loaded

    log("== GM17 BLS12-381 path: setup, prove, verify (sha256 as a SAP, 2^16)")
    launches_gm17_bls, widths, gm17_bls_pk = run_gm17_path(r1cs_bls, wit_bls, dev, smi)
    log(f"  12-limb MSM launches over setup and proofs: {check_width(12, 'the GM17 BLS12-381 path')}")
    if widths.get(("emul", 12), 0) <= 0:
        raise AssertionError(f"emul did not launch at 12 limbs on the GM17 BLS12-381 path: {widths}")
    log("== GM17 BLS12-381 field kernel checks (emul at 12 limbs over Fq, the h stage over r; bit-equal)")
    t0 = time.perf_counter()
    got = check_field_kernels(gm17_shapes(gm17_bls_pk, dev, "bls12_381")["fr"], dev, SEED + 10, "bls12_381",
                              " gm17 bls12_381", near=0.25)
    for name, recs in got.items():
        records[name] += recs
    del gm17_bls_pk
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== GM17 path: setup, prove, verify (sha256 as a SAP, 2^16)")
    launches_gm17, _, gm17_pk = run_gm17_path(r1cs, wit, dev, smi)

    log("== GM17 kernel checks (the Fq2 MSM's walks, suffix and epilogue, emul and the NTT at the GM17 prove's "
        "shapes, bit-equal)")
    t0 = time.perf_counter()
    gshapes = gm17_shapes(gm17_pk, dev)
    for got in (check_kernels({"fq2": gshapes["fq2"]}, dev, " gm17", SEED + 6, safe_mixed=False,
                              plain_lanes=GM17_PLAIN_LANES),
                check_field_kernels(gshapes["fr"], dev, SEED + 7)):
        for name, recs in got.items():
            records[name] += recs
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    log("== point kernels on random inputs with every edge case, and the throughput probe")
    t0 = time.perf_counter()
    records.update(check_point_kernels(dev))
    probe_rates(dev)
    log(f"  checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches_marlin, marlin_per_proof, marlin_result = run_marlin_path(dev, smi, records)
    log(f"  Marlin phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"marlin": marlin_result}), flush=True)

    t0 = time.perf_counter()
    launches_nova, nova_per_step, nova_result = run_nova_path(dev, smi, records, pending_setup)
    log(f"  Nova phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"nova": nova_result}), flush=True)

    t0 = time.perf_counter()
    launches_mpc, mpc_result = run_mpc_path(dev, smi, records, (prog, r1cs, wits), (r1cs_bls, wit_bls, keys_bls))
    del wits
    mpc_result["phase_s"] = time.perf_counter() - t0
    log(f"  MPC phase: {mpc_result['phase_s']:.1f} s")
    print(json.dumps({"mpc": mpc_result}), flush=True)

    t0 = time.perf_counter()
    launches_bw6, launches_bw6_batch, bw6_result, (r1cs_bw6, wits_bw6, keys_bw6) = run_bw6_path(
        dev, smi, records, pending_bw6)
    bw6_result["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches_gm17_bw6, bw6_result["gm17"] = run_bw6_gm17_path(r1cs_bw6, wits_bw6, gm17_bw6_keys, dev, smi, records)
    del gm17_bw6_keys
    bw6_result["gm17"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches_mpc_bw6, bw6_result["mpc"] = run_bw6_mpc(r1cs_bw6, wits_bw6[0], keys_bw6, dev, smi, records)
    bw6_result["mpc"]["phase_s"] = time.perf_counter() - t0
    log(f"  BW6-761 phases: Groth16 {bw6_result['phase_s']:.1f} s, GM17 {bw6_result['gm17']['phase_s']:.1f} s, "
        f"the contribution {bw6_result['mpc']['phase_s']:.1f} s")
    print(json.dumps({"bw6_761": bw6_result}), flush=True)
    print(json.dumps({"witness": witness_result}), flush=True)


    kernels = []
    for name, recs in records.items():
        head = next(r for r in recs if (r["field"], r["mode"]) == MAIN_VARIANT[name])
        lib, replaces = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": os.path.relpath(cuda.SOURCES[lib], ROOT),
            "replaces": replaces,
            "launches": (launches_mpc if name in MPC_KERNELS else launches).get(name, 0),
            "launches_mpc": launches_mpc.get(name, 0),
            "launches_batch": launches_batch.get(name, 0),
            "launches_gm17": launches_gm17.get(name, 0),
            "launches_bls12_381": launches_bls.get(name, 0),
            "launches_bls12_381_batch": launches_bls_batch.get(name, 0),
            "launches_gm17_bls12_381": launches_gm17_bls.get(name, 0),
            "launches_marlin": launches_marlin.get(name, 0),
            "launches_marlin_per_proof": marlin_per_proof.get(name, 0),
            "launches_nova": launches_nova.get(name, 0),
            "launches_nova_per_step": nova_per_step.get(name, 0),
            "launches_bw6_761": launches_bw6.get(name, 0),
            "launches_bw6_761_batch": launches_bw6_batch.get(name, 0),
            "launches_gm17_bw6_761": launches_gm17_bw6.get(name, 0),
            "launches_mpc_bw6_761": launches_mpc_bw6.get(name, 0),
            "launches_witness": witness_result["bn128"]["kernel_launches"].get(name, 0),
            "launches_witness_bls12_381": witness_result["bls12_381"]["kernel_launches"].get(name, 0),
            "launches_witness_pedersen512": witness_result["pedersen512"]["kernel_launches"].get(name, 0),
            "launches_witness_solvers": witness_result["solvers"]["kernel_launches"].get(name, 0),
            "launches_witness_bw6_761": bw6_result["witness"]["kernel_launches"].get(name, 0),
            "launches_cli": launches_cli.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "checks": recs,
        })
    log(f"  total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
