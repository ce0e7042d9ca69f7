"""Variants of the matvec walk kernel (csrc/mulacc.cu), timed on a CUDA card
against the kernel as it is: what each part of its design buys, and where
its time goes.

Each variant is the source with one or two lines replaced, built by nvcc
into its own library under zokrates_tpu_torch/_build/variants/ (all in
parallel) and called through its zkt_mulacc_walk entry point on the
sha256 circuit's walk plans (bench_artifacts/sha256.out, BN254's r) at B =
1 and 16 and lanes 8192 to 32768, with seeded canonical z, three readings
of chip_smoke.cuda_ms each. Variants:

  kernel          the source as it is
  one proof       a block's warps on 128 lanes of one proof (no sharing of
                  the plan's words between proofs in L1)
  thread stores   each flushing thread stores its 16 words itself, 8
                  16-byte stores to its slot (no staging in shared memory)
  no stores       flushes never stored (timing only: the output is wrong)
  no product      the product replaced by an XOR (timing only)

The first three must equal the wrapper's output bit for bit. Prints the
card (nvidia-smi), the ptxas lines of each build, and one JSON object a
(variant, B, lanes); --out appends them to a file.

Usage: python3 port_tools/mulacc_variants.py [--out FILE]
"""
import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH = "    flush_warp<N>(flush != 0, acc, slot, stage_sums[warp], stage_slot[warp], ob);\n"
VARIANTS = {  # name -> ((old, new) replacements, output must equal the kernel's)
    "kernel": ((), True),
    "one proof": ((("constexpr int kMaxProofsPerBlock = 4;", "constexpr int kMaxProofsPerBlock = 1;"),), True),
    "thread stores": (((FLUSH, "    if (flush) {\n      store_sums<N>(ob + slot * kWords, acc);\n"
                               "      for (int i = 0; i < kWords; ++i) acc[i] = 0;\n    }\n"),), True),
    "no stores": (((FLUSH, FLUSH.replace("flush != 0,", "flush != 0 && acc[0] == 0xFFFFFFFFu,")),), False),
    "no product": ((("const Fq<N> prod = mont_mul(x, c, Pm);",
                     "Fq<N> prod;\n      for (int i = 0; i < N; ++i) prod.v[i] = x.v[i] ^ c.v[i];"),), False),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mulacc_variants: no CUDA device")
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.schemes import groth16 as g

    smi = cs.nvidia_smi()
    print(smi, flush=True)
    src = open(cuda.SOURCES["zkt_mulacc"]).read()
    out_dir = os.path.join(ROOT, "zokrates_tpu_torch", "_build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (reps, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: its line is not in csrc/mulacc.cu")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"mulacc_v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [cuda.nvcc_path(), "-gencode", cuda.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", cuda.CSRC, "-o", path[:-3] + ".so", path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       path[:-3] + ".so")
    fns = {}
    Pp, I, U, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    Lm = ctypes.POINTER(ctypes.c_uint32)
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        print(f"{name}: " + "; ".join(line.strip() for line in log.splitlines()
                                      if "mulacc_kernel" in line or "registers" in line or "spill" in line
                                      or "error" in line), flush=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} did not build")
        f = ctypes.CDLL(so).zkt_mulacc_walk
        f.argtypes = [Pp, Pp, LL, Pp, Pp, Pp, Pp, Pp, I, I, I, LL, I, I, I, Lm, Lm, U, Pp]
        f.restype = I
        fns[name] = f

    dev = torch.device("cuda")
    cuda.load()
    r1cs = cs.load_sha256()[1]
    p = P.SCALAR_FIELDS["bn128"].p
    n = 1 << (r1cs.num_constraints + r1cs.num_instance - 1).bit_length()
    rdev = g._r1cs_device(r1cs, n, dev)
    _, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32_FIELD)
    nrng = np.random.default_rng(3)
    out_file = open(args.out, "a") if args.out else None
    for B in (1, 16):
        Z = cs.fr_elems((B, r1cs.num_variables), nrng, p).to(dev)
        zp = torch.empty((B, Z.shape[1], 8), dtype=torch.int32, device=dev)
        for lanes in (8192, 16384, 32768):
            w = build_mulacc_walk(rdev, lanes)
            want = pf.mulacc_walk(p, Z, w)
            for name, f in fns.items():
                out = torch.full_like(want, -1)

                def run():
                    rc = f(Z.data_ptr(), zp.data_ptr(), Z.shape[1], w.cols_walk.data_ptr(),
                           w.coeff_packed.data_ptr(), w.flags_walk.data_ptr(), w.lane_base.data_ptr(),
                           out.data_ptr(), B, w.K, w.M, w.n_records, w.n_flush, out.shape[1], 8, pl, one, n0,
                           torch.cuda.current_stream().cuda_stream)
                    cuda.check(rc, "mulacc_walk variant")
                run()
                torch.cuda.synchronize()
                equal = bool(torch.equal(out, want))
                ms = [cs.cuda_ms(run) for _ in range(3)]
                rec = dict(variant=name, B=B, lanes=lanes, equal=equal, ms=ms, ms_median=statistics.median(ms),
                           smi=smi)
                print(json.dumps(rec), flush=True)
                if out_file:
                    out_file.write(json.dumps(rec) + "\n")
                if VARIANTS[name][1] and not equal:
                    raise AssertionError(f"variant {name!r} differs from the wrapper's output")
        del Z, zp
    if out_file:
        out_file.close()


if __name__ == "__main__":
    main()
