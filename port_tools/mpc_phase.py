"""chip_smoke.py's MPC phase alone, on a CUDA card.

Builds the kernels, reads the BN254 sha256 program and the BLS12-381 one,
makes the 16 BN254 witnesses and one BLS12-381 witness with the port's
interpreter, runs groth16.setup on the BLS12-381 circuit (as
chip_smoke.py's BLS12-381 main path does; the phase starts its ceremony on
that key pair), then runs chip_smoke.run_mpc_path: the bellman ceremony on
BN254 sha256, schemes/mpc on BLS12-381 sha256, the bellman ceremony on
BLS12-381's cube toy, the host oracle and the point kernels' path calls
against their plain versions. Logs as chip_smoke.py does; the last line
is one JSON object of the phase's results, launch counts and check
records.

Usage: python3 port_tools/mpc_phase.py
"""
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.schemes import groth16

    if not torch.cuda.is_available():
        raise SystemExit("mpc_phase: no CUDA device")
    t0 = time.perf_counter()
    cuda.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cuda.load()
    prog, r1cs, _ = cs.load_sha256()
    wits = cs.batch_witnesses(prog)
    prog_bls, r1cs_bls = cs.load_sha256_bls12_381()
    wit_bls = cs.batch_witnesses(prog_bls, 1)[0]
    cs.log(f"artifacts and witnesses {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    p = P.SCALAR_FIELDS[r1cs_bls.curve].p
    rng = random.Random(cs.SEED)
    keys = groth16.setup(r1cs_bls, rng=lambda: rng.randrange(1, p), device=dev)
    records = {k: [] for k in cs.MPC_KERNELS}
    t1 = time.perf_counter()
    launches, result = cs.run_mpc_path(dev, cs.nvidia_smi(), records, (prog, r1cs, wits),
                                       (r1cs_bls, wit_bls, keys))
    cs.log(f"MPC phase {time.perf_counter() - t1:.1f} s; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"mpc": result, "launches": launches, "records": records}))


if __name__ == "__main__":
    main()
