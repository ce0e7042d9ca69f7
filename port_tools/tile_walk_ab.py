"""A/B of csrc/field_elementwise.cu against another version of it, both
loaded in one process on a CUDA card and called in alternation: what a
change to the tile walk of emul and ereduce_wide does, apart from the
spread between runs and processes.

The other version is a source file (e.g. a parent's, from `git show
REV:zokrates_tpu_torch/csrc/field_elementwise.cu > FILE`), built by nvcc
into zokrates_tpu_torch/_build/ab/ with this tree's field.cuh; this
tree's is the package's own build. Each prints its ptxas lines. Shapes:
port_tools/field_ab.py's EMUL and EREDUCE lists (the prove's), seeded
inputs; both outputs must be equal bit for bit. For each shape, --rounds
rounds of four readings, this / other / other / this, each
chip_smoke.cuda_ms (CUDA events around 20 calls behind a spin kernel):
the median ms of each side, and the median, min and max over the rounds
of this / other within a round. ereduce_wide is compared only when the
other file's entry point takes the limb count, as this tree's does.

Usage: python3 port_tools/tile_walk_ab.py --other FILE [--rounds 10] [--out FILE]
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
EREDUCE_N32 = "int zkt_ereduce_wide(const int64_t* t, int64_t* out, long long total, int n32,"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    cs = _module("chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    fab = _module("field_ab_shapes", os.path.join(ROOT, "port_tools", "field_ab.py"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tile_walk_ab: no CUDA device")
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.fields.jfield import field_spec
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.kernels import pallas_field as pf

    smi = cs.nvidia_smi()
    print(f"{smi}; other: {args.other}", flush=True)
    out_dir = os.path.join(ROOT, "zokrates_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "field_other.so")
    cmd = [cuda.nvcc_path(), "-gencode", cuda.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-I", cuda.CSRC, "-o", so, "-x", "cu", args.other]
    other_build = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (_, output) in cuda.build().items():
        if name == "zkt_field":
            print("this: " + "; ".join(line.strip() for line in output.splitlines()
                                       if "registers" in line or "spill" in line or "Compiling entry" in line))
    lib = cuda.load()
    log = other_build.communicate()[0]
    print("other: " + "; ".join(line.strip() for line in log.splitlines()
                                if "registers" in line or "spill" in line or "Compiling entry" in line
                                or "error" in line), flush=True)
    if other_build.returncode:
        raise RuntimeError("the other source did not build")
    other = ctypes.CDLL(so)
    Pp, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    Lm = ctypes.POINTER(ctypes.c_uint32)
    other.zkt_emul.argtypes = [Pp, Pp, Pp, LL, LL, LL, LL, LL, I, Lm, Lm, U, Pp]
    other.zkt_emul.restype = I
    ereduce_n32 = EREDUCE_N32 in open(args.other).read()
    other.zkt_ereduce_wide.argtypes = [Pp, Pp, LL, I, Lm, Lm, Lm, U, Pp]
    other.zkt_ereduce_wide.restype = I

    dev = torch.device("cuda")
    r = P.SCALAR_FIELDS["bn128"].p
    moduli = {"r": r, "q": P.BASE_FIELDS["bn128"].p, "q381": P.BASE_FIELDS["bls12_381"].p}
    nrng = np.random.default_rng(7)
    out_file = open(args.out, "a") if args.out else None
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def compare(kernel, label, shape, this_fn, other_fn):
        a, b = this_fn(), other_fn()
        torch.cuda.synchronize()
        equal = bool(torch.equal(a, b))
        del a, b
        rounds = []
        for _ in range(args.rounds):
            t1, o1, o2, t2 = (cs.cuda_ms(f) for f in (this_fn, other_fn, other_fn, this_fn))
            rounds.append((t1, t2, o1, o2))
        this_ms = [x for rd in rounds for x in rd[:2]]
        other_ms = [x for rd in rounds for x in rd[2:]]
        ratio = [(rd[0] + rd[1]) / (rd[2] + rd[3]) for rd in rounds]
        rec = dict(kernel=kernel, mode=label, shape=shape, equal=equal, rounds=args.rounds,
                   this_ms=statistics.median(this_ms), other_ms=statistics.median(other_ms),
                   ratio_median=statistics.median(ratio), ratio_min=min(ratio), ratio_max=max(ratio), smi=smi)
        print(json.dumps(rec), flush=True)
        if out_file:
            out_file.write(json.dumps(rec) + "\n")
        if not equal:
            raise AssertionError(f"{kernel} {label}: the two versions differ")

    for label, fname, B, L, kind in fab.EMUL:
        m = moduli[fname]
        nl = cs.nl_of(m)
        if kind == "strided":
            abc = cs.fr_elems((B, 3, L), nrng, m).to(dev)
            a, b = abc[:, 0], abc[:, 1]
        else:
            a = cs.fr_elems((B, L), nrng, m).to(dev)
            b = {"shared": lambda: cs.fr_elems((L,), nrng, m), "full": lambda: cs.fr_elems((B, L), nrng, m),
                 "row": lambda: cs.fr_elems((), nrng, m).expand(L, nl)}[kind]().to(dev)
        n32, pl, one, n0, _ = cuda.field_params(m, None, cuda.NL32)
        a_bs = a.stride(0) if B > 1 else 0
        b_bs = b.stride(0) if b.dim() == 3 and B > 1 else 0
        b_rs = b.stride(-2) if L > 1 else nl

        def other_emul():
            out = torch.empty((B, L, nl), dtype=torch.int64, device=dev)
            cuda.check(other.zkt_emul(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L, a_bs, b_bs, b_rs, n32,
                                      pl, one, n0, stream()), "emul (other)")
            return out
        compare("emul", label, [B, L, kind, n32], lambda: pf.emul(m, a, b), other_emul)
        del a, b
    if not ereduce_n32:
        print("ereduce_wide: the other entry point does not take the limb count; not compared", flush=True)
    for label, B, L in fab.EREDUCE if ereduce_n32 else ():
        t = torch.as_tensor(nrng.integers(0, 1 << 31, (B, L, 16), dtype=np.int64)).to(dev)
        n32, pl, one, n0, _ = cuda.field_params(r, None, cuda.NL32_FIELD)
        r2 = cuda.limbs32(field_spec(r).r2, n32)

        def other_ereduce():
            out = torch.empty_like(t)
            cuda.check(other.zkt_ereduce_wide(t.data_ptr(), out.data_ptr(), B * L, n32, r2, pl, one, n0,
                                              stream()), "ereduce_wide (other)")
            return out
        compare("ereduce_wide", label, [B, L], lambda: pf.ereduce_wide(r, t), other_ereduce)
        del t
    if out_file:
        out_file.close()


if __name__ == "__main__":
    main()
