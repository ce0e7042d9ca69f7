"""chip_smoke.py's Nova phase alone, on a CUDA card.

Starts nova.setup on the SHA-256 chain's step (chip_smoke.nova_setup_job)
in a child process, builds the kernels meanwhile, then runs
chip_smoke.run_nova_path: 8 + 2 steps, verify, forgeries, the per-step
split, one profiled step, the kernel checks at Pasta q and compress on
the square step. Logs as chip_smoke.py does; the last line is one JSON
object of the phase's results, launch counts and check records.

Usage: python3 port_tools/nova_phase.py
"""
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

    if not torch.cuda.is_available():
        raise SystemExit("nova_phase: no CUDA device")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = pool.submit(cs.nova_setup_job)
        cuda.build()
        cs.log(f"build {time.perf_counter() - t0:.1f} s")
        cuda.load()
        records = {k: [] for k in ("walk_mixed", "walk_general", "suffix", "suffix_fold", "emul", "ereduce_wide",
                                   "ntt")}
        launches, per_step, result = cs.run_nova_path(torch.device("cuda"), cs.nvidia_smi(), records, pending)
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"nova": result, "launches": launches, "per_step": per_step, "records": records}))


if __name__ == "__main__":
    main()
