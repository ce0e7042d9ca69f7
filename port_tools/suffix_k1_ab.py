"""A/B of the sorted-MSM suffix kernel at k = 1 on a CUDA card.

The port launches suffix_kernel (one thread a lane, its complete adds
inlined) where msm_sorted.suffix_split gives k = 1, and suffix_split_kernel
at k > 1. This script times the port's launch ("A") against two copies of
the package built in a temporary directory: "B", the k = 1 branch of
launch_suffix taken out, so suffix_split_kernel runs at every k (its scan,
ladder and tree empty at k = 1, its adds out of line); and "C", as B with
the split kernel storing its lane's sums right after the walk at k = 1 and
launched without shared memory. Each tree runs the suffix wrapper on the
same random tables (chip_smoke.Points, seed 7) at the prove's Lb = 1
shapes, at (4, 16384) (k = 1 because the lanes alone fill the card) and
at the h16 shape (32, 1024) (k = 16 in all three: a control), on BN254 (8
limbs) and BLS12-381 (12 limbs), over Fq and Fq2; five CUDA-event readings
a shape (chip_smoke.cuda_ms), in processes A, B, C, C, B, A. Every output
must be bit-equal to A's first.

Usage: python3 port_tools/suffix_k1_ab.py [--out DIR]
"""
import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 128), (1, 384), (1, 4096), (4, 16384), (32, 1024))
BRANCH = """  if (k == 1) {
    suffix_kernel<E><<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, b, out, Lb, M, P);
    return (int)cudaGetLastError();
  }
"""
WALKED = """  sm_put_jac(part, tot);
  sm_put_jac(scan, acc);
  __syncthreads();"""
EARLY = """  if (k == 1) {
    if (live) {
      store_jac(out, 0, Ms, lane, acc);
      store_jac(out, 3 * ER, Ms, lane, tot);
    }
    return;
  }
"""
SMEM = "  const size_t smem = 2 * sizeof(Jac<E>) * kSplitThreads;"


def variant(dst: str, early: bool) -> str:
    """A copy of the package and chip_smoke.py in dst, its launch_suffix
    without the k = 1 branch (and, with `early`, the split kernel's k = 1
    exit)."""
    shutil.copytree(os.path.join(ROOT, "zokrates_tpu_torch"), os.path.join(dst, "zokrates_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    src = os.path.join(dst, "zokrates_tpu_torch", "csrc", "msm_sorted.cu")
    s = open(src).read()
    for anchor in (BRANCH,) + ((WALKED, SMEM) if early else ()):
        if s.count(anchor) != 1:
            raise RuntimeError(f"msm_sorted.cu: anchor not found once: {anchor.splitlines()[0]!r}")
    s = s.replace(BRANCH, "")
    if early:
        s = s.replace(WALKED, EARLY + WALKED)
        s = s.replace(SMEM, "  const size_t smem = k > 1 ? 2 * sizeof(Jac<E>) * kSplitThreads : 0;")
    open(src, "w").write(s)
    return dst


def child(tree: str, tag: str, out_dir: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from zokrates_tpu_torch.kernels import msm_sorted as ms

    if not ms.__file__.startswith(tree):
        raise RuntimeError(f"imported {ms.__file__}, not from {tree}")
    dev = torch.device("cuda")
    ref_path = os.path.join(out_dir, "ref.pt")
    ref = torch.load(ref_path) if os.path.exists(ref_path) else None
    outs, times = {}, {}
    for curve in ("bn128", "bls12_381"):
        for ext in (False, True):
            rng = random.Random(7)
            nrng = np.random.default_rng(7)
            pool = cs.Points(ext, rng, curve=curve)
            for Lb, M in SHAPES:
                ia = nrng.integers(0, pool.jac.shape[0], (Lb, M))
                ib = nrng.integers(0, pool.jac.shape[0], (Lb, M))
                A = pool.jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous().to(dev)
                B = pool.jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous().to(dev)
                key = f"{curve} {'Fq2' if ext else 'Fq'} ({Lb}, {M}) k={ms.suffix_split(Lb, M)}"
                outs[key] = ms.suffix(A, B, pool.q, pool.beta).cpu()
                times[key] = [cs.cuda_ms(lambda: ms.suffix(A, B, pool.q, pool.beta)) for _ in range(5)]
    if ref is None:
        torch.save(outs, ref_path)
        bad = []
    else:
        bad = [k for k in outs if not torch.equal(outs[k], ref[k])]
    with open(os.path.join(out_dir, "times.jsonl"), "a") as f:
        f.write(json.dumps({"tag": tag, "differs": bad, "times": times}) + "\n")
    if bad:
        raise AssertionError(f"{tag}: output differs from A's at {bad}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the outputs and readings (default: a temporary one)")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child[0]), args.child[1], args.out)
        return 0
    tmp = tempfile.mkdtemp(prefix="suffix_k1_")
    out_dir = args.out or tmp
    try:
        os.makedirs(out_dir, exist_ok=True)
        for name in ("ref.pt", "times.jsonl"):
            if os.path.exists(os.path.join(out_dir, name)):
                os.remove(os.path.join(out_dir, name))
        trees = {"A": ROOT, "B": variant(os.path.join(tmp, "B"), False), "C": variant(os.path.join(tmp, "C"), True)}
        for tag in "ABCCBA":
            rc = subprocess.call([sys.executable, os.path.abspath(__file__), "--out", out_dir,
                                  "--child", trees[tag], tag], timeout=600)
            if rc:
                print(f"{tag}: exit {rc}")
                return 1
        runs = [json.loads(line) for line in open(os.path.join(out_dir, "times.jsonl"))]
        best = {}
        for r in runs:
            for key, t in r["times"].items():
                med = sorted(t)[len(t) // 2]
                best[r["tag"], key] = min(best.get((r["tag"], key), med), med)
        print("suffix at k = 1, ms per call (the lower median of the two processes a tree); B, C against A; "
              "every output bit-equal to A's")
        for key in runs[0]["times"]:
            a, b, c = (best[t, key] for t in "ABC")
            print(f"  {key:36s} A {a:.4f}  B {b:.4f} ({100 * (b / a - 1):+.1f}%)  C {c:.4f} ({100 * (c / a - 1):+.1f}%)")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
