"""chip_smoke.py's witness generator checks alone, on a CUDA card.

The levelized generator (zokrates_tpu_torch/interp/vectorized.py) as
chip_smoke.py drives it: the 16 sha256 witnesses of the BN254 batch and
emul / ereduce_wide at that plan's widest calls (chip_smoke.batch_witnesses,
witness_shapes), Pedersen-512 and the solver program
(chip_smoke.run_witness_path), the 16 sha256 witnesses over BLS12-381,
and with --bw6 the recursion circuit (its read, scalar witnesses and plan
in a spawned child process, chip_smoke.bw6_host_job; then
chip_smoke.bw6_card_witnesses). Every witness is held value for value
against the scalar interpreter. Prints one JSON line of the stats.

    python3 port_tools/witness_phase.py [--bw6]
"""

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from zokrates_tpu_torch.kernels import cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--bw6", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("witness_phase: no CUDA device")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = pool.submit(cs.bw6_host_job) if args.bw6 else None
        cuda.build()
        cuda.load()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        records = {"emul": [], "ereduce_wide": [], "ntt": []}
        result = {"bn128": {}}
        prog = cs.load_sha256()[0]
        cs.batch_witnesses(prog, stats=result["bn128"])
        for name, recs in cs.check_field_kernels(result["bn128"]["shapes"], "cuda", cs.SEED + 30).items():
            records[name] += recs
        cs.run_witness_path(result)
        result["bls12_381"] = {}
        cs.batch_witnesses(cs.load_sha256_bls12_381()[0], stats=result["bls12_381"])
        if pending is not None:
            r1cs, wits, host, vec = pending.result(timeout=900)
            cs.log(f"recursion host job: {host}")
            result["bw6_761"] = cs.bw6_card_witnesses(wits, vec, records)
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"witness": result, "records": records}))


if __name__ == "__main__":
    main()
