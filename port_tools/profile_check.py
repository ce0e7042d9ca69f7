"""Busy time of a profiled prove_batch, and does torch.profiler record
every kernel launch of it?

On a CUDA card: sha256 on BLS12-381 (port_artifacts/) or BN254
(bench_artifacts/), Groth16 setup, 16 witnesses from the port's
interpreter, two warm batches (with --after-matvec, then
chip_smoke.log_matvec: the matvec's timings and one B = 16 h stage's
peak-memory reading, as chip_smoke.py runs it after each batch path, and
two more batches), then --runs batches under the profiler
through chip_smoke.profile_batch: each logs its busy time and the
launches of the h stage's kernels that their wrappers counted in the
batch beside those the profiler recorded. The package is imported from
--root (this checkout by default, or another tree of the repository
unpacked beside it, e.g. a parent commit from `git archive`); the
profiling and the inputs are this checkout's, the same for every tree.
The last line is one JSON object of all runs.

Usage: python3 port_tools/profile_check.py [--root DIR] [--curve bls12_381|bn128] [--runs 4] [--label NAME]
       [--after-matvec]
"""
import argparse
import importlib.util
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--curve", default="bls12_381", choices=("bls12_381", "bn128"))
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--label", default="")
    ap.add_argument("--after-matvec", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke_profile", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_check: no CUDA device")
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.schemes import groth16 as g

    smi = cs.nvidia_smi()
    print(f"{args.label}: {smi}; package {os.path.abspath(args.root)}", flush=True)
    cuda.load()
    dev = torch.device("cuda")
    prog, r1cs = cs.load_sha256_bls12_381() if args.curve == "bls12_381" else cs.load_sha256()[:2]
    wits = cs.batch_witnesses(prog)
    p = P.SCALAR_FIELDS[r1cs.curve].p
    rng = random.Random(cs.SEED)
    pk, _ = g.setup(r1cs, rng=lambda: rng.randrange(1, p), device=dev)
    draws = (rng.randrange(1, p) for _ in iter(int, 1))
    for _ in range(2):
        g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev)
    if args.after_matvec:
        cs.log_matvec(r1cs, dev, r1cs.curve)
        for _ in range(2):
            g.prove_batch(r1cs, pk, wits, rng=lambda: next(draws), device=dev)
    torch.cuda.synchronize()
    runs = [cs.profile_batch(r1cs, pk, wits, dev, [next(draws) for _ in range(2 * len(wits))])
            for _ in range(args.runs)]
    print(json.dumps({"label": args.label, "curve": args.curve, "after_matvec": args.after_matvec, "smi": smi,
                      "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
