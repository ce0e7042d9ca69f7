"""A/B of the scalar-field kernels (emul, ereduce_wide, the NTT) on a CUDA
card, at the shapes the prove launches them with.

Imports the port's package from --root (this checkout by default, or
another tree of the repository unpacked beside it, e.g. a parent commit
from `git archive`), builds its kernels (chip_smoke.py's build: one nvcc
per source, cached in the tree's zokrates_tpu_torch/_build/) and times each
wrapper with chip_smoke.cuda_ms (CUDA events around 20 calls behind a spin
kernel), three readings a shape, after checking its output bit-equal to
the plain version's. Shapes: BN254's B = 1 prove and the B = 16 batch
(emul to_mont, n^-1, coset tables, A*B as slices of the coset values and
contiguous, 1/Z and from_mont; ereduce_wide on the walk matvec's snapshot
and row sums; transforms of 3, 1, 48 and 16 arrays of 2^15), GM17's
(2^16), and emul at 12 limbs over BLS12-381's base field, which a tree
without that width reports as refused. Inputs are seeded (numpy), the
same in every tree. Prints the card (nvidia-smi) and one JSON object a
shape; --out appends them to a file.

Usage: python3 port_tools/field_ab.py [--root DIR] [--label NAME] [--out FILE]
"""
import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_SHA256, N_SHA256 = 27281, 1 << 15  # sha256's variables and QAP domain
SNAP, ROWS = 90112, 3 * N_SHA256     # the walk matvec's flush slots and rows
EMUL = [  # (label, field, B, L, b)
    ("to_mont", "r", 1, M_SHA256, "row"), ("A*B", "r", 1, N_SHA256, "full"),
    ("corrections", "r", 3, N_SHA256, "shared"),
    ("B=16 to_mont", "r", 16, M_SHA256, "row"), ("B=16 n^-1", "r", 48, N_SHA256, "row"),
    ("B=16 coset", "r", 48, N_SHA256, "shared"), ("B=16 A*B", "r", 16, N_SHA256, "strided"),
    ("B=16 A*B full", "r", 16, N_SHA256, "full"), ("B=16 1/Z, n^-1, from_mont", "r", 16, N_SHA256, "row"),
    ("B=16 coset^-1", "r", 16, N_SHA256, "shared"),
    ("gm17 coset x2", "r", 2, 1 << 16, "shared"), ("gm17 1/t", "r", 1, 1 << 16, "row"),
    ("gm17 G2 query", "q", 1, 4 * (1 << 15), "row"),
    ("12 limbs q381 G1 query", "q381", 1, 1 << 15, "row"), ("12 limbs q381 shared", "q381", 16, N_SHA256, "shared"),
]
EREDUCE = [("walk snapshot", 1, SNAP), ("row sums", 1, ROWS), ("B=16 walk snapshot", 16, SNAP),
           ("B=16 row sums", 16, ROWS)]
NTT = [  # (label, log2 n, batch, inverse)
    ("forward x3", 15, 3, False), ("inverse x3", 15, 3, True), ("inverse x1", 15, 1, True),
    ("B=16 forward x48", 15, 48, False), ("B=16 inverse x48", 15, 48, True), ("B=16 inverse x16", 15, 16, True),
    ("gm17 inverse x2", 16, 2, True), ("gm17 forward x2", 16, 2, False), ("gm17 inverse x1", 16, 1, True),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("field_ab: no CUDA device")
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.kernels import ntt_pallas as nk
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.kernels.ntt import domain_for_curve

    smi = cs.nvidia_smi()
    print(f"{args.label}: {smi}; package {root}", flush=True)
    t0 = time.perf_counter()
    for name, (so, output) in cuda.build().items():
        if name in ("zkt_field", "zkt_ntt"):
            for line in output.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print("  " + line.strip())
    cuda.load()
    print(f"  build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    r = P.SCALAR_FIELDS["bn128"].p
    moduli = {"r": r, "q": P.BASE_FIELDS["bn128"].p, "q381": P.BASE_FIELDS["bls12_381"].p}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec.update(label=args.label, smi=smi)
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")

    def timed(run, plain, **rec):
        try:
            got = run()
        except (ValueError, RuntimeError) as e:
            emit(dict(rec, refused=str(e)[:120]))
            return
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, plain()))
        del got
        ms = [cs.cuda_ms(run) for _ in range(3)]
        emit(dict(rec, equal=equal, ms=ms, ms_median=statistics.median(ms)))
        if not equal:
            raise AssertionError(f"{rec} differs from its plain version")

    nrng = np.random.default_rng(7)
    for label, fname, B, L, kind in EMUL:
        m = moduli[fname]
        nl = cs.nl_of(m)
        if kind == "strided":
            abc = cs.fr_elems((B, 3, L), nrng, m).to(dev)
            a, b = abc[:, 0], abc[:, 1]
        else:
            a = cs.fr_elems((B, L), nrng, m).to(dev)
            b = {"shared": lambda: cs.fr_elems((L,), nrng, m), "full": lambda: cs.fr_elems((B, L), nrng, m),
                 "row": lambda: cs.fr_elems((), nrng, m).expand(L, nl)}[kind]().to(dev)
        b_elems = {"shared": L, "full": B * L, "strided": B * L, "row": 1}[kind]
        bms, _ = cs.bound(B * L, cs.ELEM_BYTES * nl // 16 * (2 * B * L + b_elems), nl // 2)
        timed(lambda: pf.emul(m, a, b), lambda: pf.emul_plain(m, a, b), kernel="emul", mode=label,
              shape=[B, L], b=kind, width=nl // 2, bound_ms=bms)
        del a, b
    for label, B, L in EREDUCE:
        t = torch.as_tensor(nrng.integers(0, 1 << 31, (B, L, 16), dtype=np.int64)).to(dev)
        bms, _ = cs.bound(2 * B * L, 2 * cs.ELEM_BYTES * B * L)
        timed(lambda: pf.ereduce_wide(r, t), lambda: pf.ereduce_wide_plain(r, t), kernel="ereduce_wide",
              mode=label, shape=[B, L], width=8, bound_ms=bms)
        del t
    for label, k, B, inverse in NTT:
        n = 1 << k
        dom = domain_for_curve("bn128", n)
        x = cs.fr_elems((B, n), nrng, r).to(dev)
        bms, by = cs.bound(B * (n // 2) * k, 2 * cs.ELEM_BYTES * B * n + 32 * (n - 1))
        timed(lambda: nk.fft_core(dom, x, inverse), lambda: nk.fft_core_plain(dom, x, inverse), kernel="ntt",
              mode=label, shape=[B, n], width=8, bound_ms=bms, bound_by=by)
        del x
    if out:
        out.close()


if __name__ == "__main__":
    main()
