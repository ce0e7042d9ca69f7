"""A/B of the scalar-field kernels (emul, ereduce_wide, the NTT) and of
the h stage's matvec (mulacc_walk, groth16._matvec_walk, groth16._h_stage)
on a CUDA card, at the shapes the prove launches them with.

Imports the port's package from --root (this checkout by default, or
another tree of the repository unpacked beside it, e.g. a parent commit
from `git archive`), builds its kernels (chip_smoke.py's build: one nvcc
per source, cached in the tree's zokrates_tpu_torch/_build/) and times each
wrapper with chip_smoke.cuda_ms (CUDA events around 20 calls behind a spin
kernel), three readings a shape, after checking its output bit-equal to
the plain version's. Shapes: BN254's B = 1 prove and the B = 16 batch
(emul to_mont, n^-1, coset tables, A*B as slices of the coset values and
contiguous, 1/Z and from_mont; ereduce_wide on the walk matvec's flush
slots at the reference's 1024 lanes (P = 90,112) and at the lanes
groth16.walk_lanes takes (B = 1: P = 114,688; B = 16: P = 98,304, the
row sums' size), the row sums, and the corrections' (3, 1) and (1, 3);
transforms of 3, 1, 48 and 16 arrays of 2^15), GM17's (2^16), and emul at
12 limbs over BLS12-381's base field, which a tree without that width
reports as refused. Inputs are seeded (numpy), the same in every tree.

Then, on the sha256 circuit over BN254 and BLS12-381 (bench_artifacts/,
port_artifacts/), with random canonical z at B = 1 and 16: mulacc_walk
on the tree's walk plans (a tree whose mulacc_walk takes (p, Z_mont,
walk): at 1024 to 32768 lanes, each with _matvec_walk on that plan; one
that takes the gathered z: its 1024 lanes), each against its plain
version; groth16._matvec_walk at the tree's own lanes from entry
to return (cuda_ms, and the host's wall clock around one synchronized
call, median of 5), with a CUDA-event breakdown of its steps, replayed
(chip_smoke.matvec_steps for a tree with the new mulacc_walk; else the
z gather, mulacc, the flushed records' gather, the two ereduce_wide
calls, index_add_); and one B = 16 groth16._h_stage: its time and
torch.cuda.max_memory_allocated above what was allocated before it.

Prints the card (nvidia-smi) and one JSON object a shape; --out appends
them to a file.

Usage: python3 port_tools/field_ab.py [--root DIR] [--label NAME] [--out FILE] [--matvec-only]
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
SNAP, ROWS = 90112, 3 * N_SHA256     # the walk matvec's flush slots at 1024 lanes, and rows
LANES = [1 << k for k in range(10, 16)]  # the walk's lane counts timed
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
EREDUCE = [  # (label, B, L): the flush slots at the reference's 1024 lanes and at the lanes
    # groth16.walk_lanes takes (B = 1: 32768 lanes, P = 114688; B = 16: 16384 lanes, P = 98304 = 3n), the row sums
    ("walk slots, 1024 lanes", 1, SNAP), ("walk slots, 32768 lanes", 1, 114688), ("row sums", 1, ROWS),
    ("B=16 walk slots, 1024 lanes", 16, SNAP), ("B=16 row sums; walk slots, 16384 lanes", 16, ROWS),
    ("corrections (3, 1)", 3, 1), ("corrections (1, 3)", 1, 3)]
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
    ap.add_argument("--matvec-only", action="store_true", help="only the matvec and h stage part")
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
        if name in ("zkt_field", "zkt_ntt", "zkt_mulacc"):
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
    matvec_ab(cs, dev, emit, timed)
    if args.matvec_only:
        return
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


def matvec_ab(cs, dev, emit, timed):
    """The matvec and h stage part (see the module docstring)."""
    import inspect

    import torch
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.schemes import groth16 as g

    new_api = "walk" in inspect.signature(pf.mulacc_walk).parameters
    for curve, load in (("bn128", cs.load_sha256), ("bls12_381", cs.load_sha256_bls12_381)):
        r1cs = load()[1]
        p = P.SCALAR_FIELDS[curve].p
        n = 1 << (r1cs.num_constraints + r1cs.num_instance - 1).bit_length()
        m = r1cs.num_variables
        rdev = g._r1cs_device(r1cs, n, dev)
        nrng = np.random.default_rng(11)
        for B in (1, 16):
            Z = cs.fr_elems((B, m), nrng, p).to(dev)
            if new_api:
                runs_ref = build_mulacc_walk(rdev).n_row_flush
                for lanes in LANES:
                    w = build_mulacc_walk(rdev, lanes)
                    timed(lambda: pf.mulacc_walk(p, Z, w), lambda: pf.mulacc_walk_plain(p, Z, w),
                          kernel="mulacc_walk", mode=f"{curve} B={B}", shape=[B, w.K, w.M], lanes=lanes,
                          slots=w.pos.numel(), n_flush=w.n_flush,
                          bound_ms=cs.bound(B * w.n_records,
                                            cs.mulacc_bytes(w, B, m, min(w.n_row_flush, runs_ref)))[0],
                          path=lanes == g.walk_lanes(B, w.n_records))
                    ms = [cs.cuda_ms(lambda: g._matvec_walk(p, rdev, Z, lanes)) for _ in range(3)]
                    emit(dict(kernel="_matvec_walk by lanes", mode=f"{curve} B={B}", lanes=lanes, ms=ms,
                              ms_median=statistics.median(ms)))
            else:
                w = build_mulacc_walk(rdev)
                zw = gather_walk(Z, w)
                timed(lambda: pf.mulacc_walk(p, zw, w.coeff_walk, w.flags_walk),
                      lambda: pf.mulacc_walk_plain(p, zw, w.coeff_walk, w.flags_walk),
                      kernel="mulacc_walk", mode=f"{curve} B={B}", shape=[B, w.K, w.M], lanes=w.M)
                del zw
            Z_mont = Z
            want = g._matvec_coo(p, rdev, Z_mont)
            got = g._matvec_walk(p, rdev, Z_mont)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want))
            del got, want
            ms = [cs.cuda_ms(lambda: g._matvec_walk(p, rdev, Z_mont)) for _ in range(3)]
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g._matvec_walk(p, rdev, Z_mont)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            emit(dict(kernel="_matvec_walk", mode=f"{curve} B={B}", equal=equal, ms=ms,
                      ms_median=statistics.median(ms), wall_ms=statistics.median(walls),
                      parts=matvec_parts(cs, p, rdev, Z_mont, g, pf, new_api)))
            if not equal:
                raise AssertionError(f"_matvec_walk {curve} B={B} differs from _matvec_coo")
            if B == 16:
                Zc = cs.fr_elems((B, m), nrng, p).to(dev)
                g._h_stage(curve, rdev, Zc)  # warm: plans, constants, builds
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                g._h_stage(curve, rdev, Zc)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated() - base
                emit(dict(kernel="_h_stage", mode=f"{curve} B=16", wall_ms=wall, peak_bytes=peak,
                          base_bytes=base, ms_median=statistics.median(
                              [cs.cuda_ms(lambda: g._h_stage(curve, rdev, Zc), reps=5) for _ in range(3)])))
                del Zc
            del Z


def gather_walk(Z, w):
    """A tree with the gathered-z mulacc_walk: zw[b, k, l, m] = Z[b,
    cols[m*K + k], l], as its _matvec_walk gathers it."""
    import torch

    B, _, nl = Z.shape
    bi = torch.arange(B, device=Z.device)
    li = torch.arange(nl, device=Z.device)
    return Z[bi[:, None, None, None], w.cols.view(w.M, w.K).T[None, :, None, :],
             li[None, None, :, None]].contiguous()


def matvec_parts(cs, p, rdev, Z, g, pf, new_api, reps=5):
    """Median ms of each step of _matvec_walk over `reps` runs of its steps
    replayed between CUDA events: chip_smoke.matvec_steps for a tree with
    the new mulacc_walk, else the gathered-z pipeline's steps."""
    import torch
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk

    if new_api:
        return cs.matvec_steps(p, rdev, Z, reps)
    w = build_mulacc_walk(rdev)
    B, _, nl = Z.shape
    K = w.K
    bi = torch.arange(B, device=Z.device)
    li = torch.arange(nl, device=Z.device)
    runs = []
    for _ in range(reps):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        evs[0].record()
        zw = gather_walk(Z, w)
        evs[1].record()
        out = pf.mulacc_walk(p, zw, w.coeff_walk, w.flags_walk)
        evs[2].record()
        del zw
        snap = out[bi[:, None, None], (w.pos % K)[None, :, None], li[None, None, :],
                   (w.pos // K)[None, :, None]].contiguous()
        evs[3].record()
        del out
        part = pf.ereduce_wide(p, snap)
        evs[4].record()
        sums = torch.zeros((B, w.n_rows + 1, nl), dtype=torch.int64, device=Z.device)
        sums.index_add_(1, w.seg, part)
        evs[5].record()
        pf.ereduce_wide(p, sums[:, : w.n_rows].contiguous())
        evs[6].record()
        torch.cuda.synchronize()
        runs.append([evs[i].elapsed_time(evs[i + 1]) for i in range(6)])
    names = ("gather z", "mulacc", "gather snap", "ereduce snap", "index_add", "ereduce rows")
    return {name: statistics.median(r[i] for r in runs) for i, name in enumerate(names)}


if __name__ == "__main__":
    main()
