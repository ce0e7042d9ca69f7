"""chip_smoke.py's BW6-761 recursion phase alone, on a CUDA card.

Starts the phase's host work (chip_smoke.bw6_host_job: the recursion
circuit's read and witnesses) in a spawned child process, as chip_smoke.py
does, builds the kernels meanwhile, then runs chip_smoke.run_bw6_path:
Groth16 setup on the 123,507-constraint circuit at domain 2^17, 3 proofs,
prove_batch of 4 witnesses, verification by the BW6-761 pairing, the
forgeries, and every kernel of one proof against its plain version. Logs as
chip_smoke.py does, and setup's parts (the QAP evaluation, each
fixed-base evaluation, the shared-bucket h query) by wall time; the last
line is one JSON object of the phase's results, setup's parts, launch
counts and check records.

With --h16, after the phase: the shared-bucket h query of the phase's key
(groth16._h16_p128, which setup skips for BW6-761's 48-limb Fq), its build
time, and the h MSM of one proof's h scalars in both forms
(chip_smoke.compare_h_msm: shared-bucket against dense, equal as points,
each timed).

With --beyond, chip_smoke.py's phases 13b and 13c after it: the child
process first runs GM17's setup on the card (chip_smoke.bw6_gm17_setup_job;
this script waits for it before the Groth16 phase, so that the setup runs
alone but for the build), then the host work; after the Groth16 phase,
chip_smoke.run_bw6_gm17_path (the key's encoding, 2 proofs, verification,
the forgeries, emul and the NTT at that prove's shapes) and
chip_smoke.run_bw6_mpc (a contribution to the phase's Groth16 key, verify,
a tampered contribution, a proof with the exported key, the sampled rows
and mixed_add_lm at 24 limbs against their references).

Usage: python3 port_tools/bw6_phase.py [--h16] [--beyond]
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
    from zokrates_tpu_torch.schemes import groth16

    ap = argparse.ArgumentParser()
    ap.add_argument("--h16", action="store_true")
    ap.add_argument("--beyond", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bw6_phase: no CUDA device")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending_gm17 = pool.submit(cs.bw6_gm17_setup_job) if args.beyond else None
        pending = pool.submit(cs.bw6_host_job)
        built = cuda.build()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        for so, output in built.values():
            if "msm" in so or "point" in so or "field" in so:
                for line in output.splitlines():
                    if "registers" in line or "spill" in line or "Compiling entry" in line:
                        cs.log("    " + line.strip())
        cuda.load()
        if args.beyond:
            gm17_keys = pending_gm17.result()
            cs.log(f"GM17 setup in the child process: {gm17_keys[2]} s; waited until "
                   f"{time.perf_counter() - t0:.1f} s")
        parts = {}

        def timed(name, fn):
            def wrapped(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
                return out
            return wrapped

        for name in ("_lagrange_at_tau", "_qap_evals_at_tau", "_fb_g1", "_fb_g2", "_fb_g1_points", "_h16_p128"):
            setattr(groth16, name, timed(name, getattr(groth16, name)))
        seen = {}
        setup, prove = groth16.setup, groth16.prove

        def keep_setup(r1cs, *a, **kw):
            seen["r1cs"] = r1cs
            seen["keys"] = setup(r1cs, *a, **kw)
            return seen["keys"]

        def keep_prove(r1cs, pk, wit, *a, **kw):
            seen.setdefault("wit", wit)
            return prove(r1cs, pk, wit, *a, **kw)

        groth16.setup, groth16.prove = keep_setup, keep_prove
        records = {k: [] for k in cs.REPLACES}
        t1 = time.perf_counter()
        dev, smi = torch.device("cuda"), cs.nvidia_smi()
        try:
            launches, launches_batch, result, (r1cs, wits, keys) = cs.run_bw6_path(dev, smi, records, pending)
        finally:
            cs.log("setup's parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    cs.log(f"BW6-761 phase {time.perf_counter() - t1:.1f} s; total {time.perf_counter() - t0:.1f} s")
    if args.beyond:
        groth16.setup, groth16.prove = setup, prove
        t2 = time.perf_counter()
        launches_gm17, result["gm17"] = cs.run_bw6_gm17_path(r1cs, wits, gm17_keys, dev, smi, records)
        result["gm17"]["phase_s"] = time.perf_counter() - t2
        t2 = time.perf_counter()
        launches_mpc, result["mpc"] = cs.run_bw6_mpc(r1cs, wits[0], keys, dev, smi, records)
        result["mpc"]["phase_s"] = time.perf_counter() - t2
        result.update(launches_gm17=launches_gm17, launches_mpc=launches_mpc)
        cs.log(f"GM17 {result['gm17']['phase_s']:.1f} s, the contribution {result['mpc']['phase_s']:.1f} s; "
               f"total {time.perf_counter() - t0:.1f} s")
    if args.h16:
        pk, r1cs = seen["keys"][0], seen["r1cs"]
        t2 = time.perf_counter()
        pk.h16_p128 = groth16._h16_p128(r1cs.curve, pk.h_p128, groth16._hw_fused_tier(r1cs.num_variables,
                                                                                      pk.domain_size), "cuda")
        pk._dev.clear()
        result["h16_build_s"] = time.perf_counter() - t2
        cs.log(f"h16 table {pk.h16_p128.shape} built in {result['h16_build_s']:.2f} s")
        result["h_msm_ms"] = cs.compare_h_msm(r1cs, seen["wit"], pk, torch.device("cuda"))[0]
    print(json.dumps({"bw6_761": result, "setup_parts_s": parts, "launches": launches,
                      "launches_batch": launches_batch, "records": records}))


if __name__ == "__main__":
    main()
