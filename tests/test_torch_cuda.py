"""The port's CUDA kernels (zokrates_tpu_torch/csrc/: msm_sorted.cu's walk,
suffix and suffix epilogue, field_elementwise.cu's emul and ereduce_wide,
ntt.cu's transform passes, mulacc.cu's matvec walk, point_elementwise.cu's
mixed_add_lm and accumulate_lm) against their plain PyTorch versions, on
the card; the shared-bucket sorted MSM on the card against the Python-int
oracle; the c = 8 sorted MSM at 2^17 points (Marlin's largest commitments),
each of its kernel launches against its plain version and the whole MSM
against the oracle; GM17 setup -> prove -> verify on a toy circuit on the card;
and Nova's commitments at Pasta q (Pallas and Vesta Fq, 8 limbs, a quarter
of the points with x within 2^8 of q and half the Jacobian Z within 2^8 of
q): the walk in its three modes at every S, the suffix at k = 1 and k > 1,
the epilogue and emul against their plain versions, and groth16._msm_g1 at
2^15 points against the oracle.

Marked `cuda`: every test skips where torch.cuda is unavailable (this is
decided in a fixture, never at import). On a machine with an NVIDIA GPU
and nvcc, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: the repository's conftest imports jax, which the card's
machine need not have; this file imports nothing of the JAX package.)

The sorted MSM's kernels also at 12 limbs, over Fq and Fq2 of BLS12-381
(u^2 = -1) and BLS12-377 (u^2 = -5): the walk at every S through its C
entry point, the suffix walk and the epilogue up to lw = 1024; and the C
entry points' refusal of a width they have no instantiation of. The
suffix walk at 8 and 12 limbs, over Fq and Fq2, at Lb = 1, 3 and 32 on
203 lanes, through the wrapper and through its C entry point at every
split k of a lane into sub-chunks (each against suffix_plain at that k),
with lanes planted at infinity, with doublings and with cancellations;
and the entry point's refusal of a k it cannot run.

Inputs: real curve points from seeded generators (with points at
infinity), lane counts that are not multiples of the kernels' block size,
the walk split into sub-chunks (many on few lanes, and every S through
the C entry point) over the flag patterns of test_torch_walk_split, with a
collision planted in one lane's second segment; the epilogue at lw = 1,
2, 128 and 1024 over one and three windows;
canonical field elements and lazy sums near 2^31 and 2^47 (ragged
lengths, one-tile totals) from seeded numpy; emul
at 8, 12 and 24 limbs (BN254's r, BLS12-381's q, BW6-761's q: tiles of
64 elements at 24, and GM17's key encoding over it at 2^19 one row) with
b shared, full, one row
and a strided a and b, rows that leave the last tile short, and the
batched prove's shapes ((48, 2^15) shared and one row, (16, 2^15) full,
strided and one row, (16, 27281) one row), and the C entry point's refusal
of a width it has no instantiation of; the NTT at 2^1, 2^2 and 2^5
(blocks of many tiles, padding past the batch), 2^10 (one pass), 2^11,
the prove's 2^15 and 2^16 (two), Marlin's 2^17 and 2^21 (three), batches of 1, 2, 3, 16
and 48; the epilogue also at the shared-bucket h MSM's shape
(one window of 1024 lanes); the matvec walk on toy and sha256-sized
random plans at 1024 to 32768 lanes (runs that end at row changes and
at lane ends, lanes of padding), B = 1, 3 and 16, over BN254's and
BLS12-381's r, and groth16._matvec_walk against the COO matvec; the point kernels with P at infinity, P == Q,
P == -Q, digits 0 and >= n_buckets and buckets hit several times, at 8
and 12 limbs (BLS12-381 and BLS12-377 Fq, Z within 2^8 of q), the mixed
add also at 24 (BW6-761's Fq), and their C entry points' refusal of
another width (the accumulation's of 24, and of 48 16-bit limbs by
ereduce_wide, accumulate_lm and the field check of the NTT and the
matvec walk, cuda.NL32_FIELD); the ceremony's ladders
(kernels/ladder: one scalar for all points, a scalar a point, the column
sums through accumulate_lm and over G2) on a few hundred points against
Python-int point arithmetic, on BN254 and BLS12-381. The levelized
witness generator (interp/vectorized) on the card: the solver program
(port_artifacts/solvers_bn128.out.gz), Pedersen-512 and the bench's
sha256 against the scalar interpreter (and the CPU generator where its
plain versions are quick), a replay against the eager first call, other
inputs replayed with no new capture, emul and ereduce_wide launched on
every call; a failed assert and a division by zero raise the scalar
interpreter's errors. The CLI on the card: a toy program compiled,
its witness computed, set up and proved through cli.main under
`--device cuda` and under `--device cpu` with one fixed sequence of
secrets.randbelow draws: the same verification key, proving key and proof;
the CLI's generator rule on the card (the scalar interpreter on a first
call, the card's generator from the second, the same witness).
Tolerance: bit equality of every output limb; exact witness values and
files.
"""

import random

import numpy as np
import pytest
import torch

from zokrates_tpu_torch.ec.curve import g1_group, g2_group
from zokrates_tpu_torch.ec.tower import Fq2
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.fields.jfield2 import field_ops2
from zokrates_tpu_torch.kernels import msm_sorted as ms

pytestmark = pytest.mark.cuda
Q = g1_group("bn128").q


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rows(ext, seed, n=8):
    """(affine rows, Jacobian rows with random Z and a point at infinity)."""
    rng = random.Random(seed)
    grp = g2_group("bn128") if ext else g1_group("bn128")
    f = field_ops2(Q, -1) if ext else field_ops(Q)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
    pts += [-p for p in pts]
    co = (lambda v: (v.c0, v.c1)) if ext else (lambda v: v)

    def enc(vals):
        return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    X, Y, Z = [], [], []
    for p in pts:
        z = Fq2(grp.tower, rng.randrange(1, Q), rng.randrange(Q)) if ext else rng.randrange(1, Q)
        X.append(co(p.x * z * z) if ext else p.x * z * z % Q)
        Y.append(co(p.y * z * z * z) if ext else p.y * z ** 3 % Q)
        Z.append(co(z) if ext else z)
    X.append(co(pts[0].x))
    Y.append(co(pts[0].y))
    Z.append((0, 0) if ext else 0)
    affine = torch.cat([enc([co(p.x) for p in pts]), enc([co(p.y) for p in pts])], 1)
    return affine, torch.cat([enc(X), enc(Y), enc(Z)], 1)


def _gather(src, shape, rng):
    idx = torch.as_tensor(rng.integers(0, src.shape[0], shape))
    return src[idx].permute(0, 2, 1).contiguous()


@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
def test_walk_kernel_equals_plain(dev, ext, mode, safe):
    affine, jac = _rows(ext, seed=1)
    rng = np.random.default_rng(2)
    K, L = 12, 300
    q = _gather(affine if mode == "mixed" else jac, (K, L), rng).to(dev)
    flags = torch.as_tensor((rng.random((K, L)) < 0.3).astype(np.int32)
                            | ((rng.random((K, L)) < 0.1).astype(np.int32) << 1)).to(dev)
    beta = -1 if ext else None
    before = ms.LAUNCHES["walk_" + mode]
    out, coll = ms.walk(q, flags, Q, mode, safe, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["walk_" + mode] == before + 1
    ref_out, ref_coll = ms.walk_plain(q, flags, Q, mode, safe, beta)
    assert torch.equal(out, ref_out)
    assert torch.equal(coll, ref_coll)


def _split_inputs(ext, mode, K, L, seed, negatives=True):
    """Walk rows and flags for the split walk: where K >= 10 the first
    lanes take the flag patterns of test_torch_walk_split (no flush, a
    flush everywhere, skips after a flush, all-skip lanes, leading skips,
    skips carrying the flush, random), the others seeded random flags with
    segments about 16 long; below K = 10 random flags. No point twice in a
    row among a lane's non-skipped positions (mixed), without the negated points if not `negatives` (so no
    partial sum meets a pool point again); points at infinity at about 10%
    of positions (general)."""
    from test_torch_walk_split import _patterns

    affine, jac = _rows(ext, seed)
    rng = np.random.default_rng(seed)
    flush, skip = (0.06, 0.1) if K >= 10 else (0.3, 0.1)
    flags = ((rng.random((K, L)) < flush).astype(np.int32)
             | ((rng.random((K, L)) < skip).astype(np.int32) << 1))
    if K >= 10:
        cols = list(_patterns(K, rng).values())[:L]
        flags[:, : len(cols)] = np.stack(cols, 1)
    src = affine if mode == "mixed" else jac
    if not negatives:
        src = src[: affine.shape[0] // 2]
    idx = rng.integers(0, src.shape[0] - (mode != "mixed"), (K, L))
    if mode == "mixed":
        last = np.full(L, -1)
        for k in range(K):
            rep = idx[k] == last
            idx[k, rep] = (idx[k, rep] + 1) % src.shape[0]
            last = np.where(flags[k] & 2, last, idx[k])
    else:
        idx[rng.random((K, L)) < 0.1] = src.shape[0] - 1
    q = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    return q, torch.as_tensor(flags)


@pytest.mark.parametrize("K,L", [(512, 64), (1, 300), (40, 200)])
@pytest.mark.parametrize("ext,mode,safe", [(False, "mixed", True), (False, "mixed", False),
                                           (False, "general", True), (True, "mixed", True),
                                           (True, "general", True)],
                         ids=["Fq-mixed-safe", "Fq-mixed-unsafe", "Fq-general", "Fq2-mixed-safe",
                              "Fq2-general"])
def test_split_walk_kernel_equals_plain(dev, ext, mode, safe, K, L):
    """The walk kernel as the wrapper launches it (S = walk_split(K, L):
    2 at (512, 64), 256 sub-chunks on few lanes) against walk_plain on
    the flag patterns; lane counts that are not multiples of the block."""
    if ext and K == 512:
        K = 128  # the Fq2 plain walk at 512 positions takes minutes
    q, flags = _split_inputs(ext, mode, K, L, seed=40 + K)
    q, flags = q.to(dev), flags.to(dev)
    beta = -1 if ext else None
    before = ms.LAUNCHES["walk_" + mode]
    out, coll = ms.walk(q, flags, Q, mode, safe, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["walk_" + mode] == before + 1
    ref_out, ref_coll = ms.walk_plain(q, flags, Q, mode, safe, beta)
    assert torch.equal(out, ref_out)
    assert torch.equal(coll, ref_coll)


@pytest.mark.parametrize("ext,mode,safe", [(False, "mixed", False), (False, "general", True),
                                           (True, "mixed", True)],
                         ids=["Fq-mixed-unsafe", "Fq-general", "Fq2-mixed-safe"])
def test_walk_kernel_at_every_split(dev, ext, mode, safe):
    """The kernel's C entry point at S = 1, 3, 7, 16 and K on the same
    inputs (the wrapper picks one S per shape), each bit-equal to
    walk_plain; the unsafe walk with a collision planted in the second
    segment of one lane, which sets coll for that lane only."""
    from zokrates_tpu_torch.kernels import cuda

    K, L = 40, 200
    q, flags = _split_inputs(ext, mode, K, L, seed=60, negatives=mode != "mixed")
    lane = 2  # "skips after a flush": segments [0, 3), [5, 8), ...
    if mode == "mixed" and not safe:
        q[6, :, lane] = q[5, :, lane]
    q, flags = q.to(dev), flags.to(dev)
    beta = -1 if ext else None
    ref_out, ref_coll = ms.walk_plain(q, flags, Q, mode, safe, beta)
    if mode == "mixed" and not safe:
        assert ref_coll.tolist() == [int(l == lane) for l in range(L)]
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(Q, beta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    en = 32 if ext else 16
    for S in (1, 3, 7, 16, K):
        out = torch.full((K, 3 * en, L), -1, dtype=torch.int32, device=dev)
        coll = torch.zeros(L, dtype=torch.int32, device=dev)
        rc = lib.zkt_msm_walk(q.data_ptr(), flags.data_ptr(), out.data_ptr(), coll.data_ptr(), K, L, S,
                              nl, int(ext), int(mode == "mixed"), int(safe), pl, one, n0, babs, stream)
        cuda.check(rc, "walk")
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out), f"S={S}"
        assert torch.equal(coll, ref_coll), f"S={S}"


@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
def test_suffix_kernel_equals_plain(dev, ext):
    _, jac = _rows(ext, seed=3)
    rng = np.random.default_rng(4)
    Lb, M = 5, 200
    a, b = _gather(jac, (Lb, M), rng).to(dev), _gather(jac, (Lb, M), rng).to(dev)
    beta = -1 if ext else None
    before = ms.LAUNCHES["suffix"]
    out = ms.suffix(a, b, Q, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix"] == before + 1
    assert torch.equal(out, ms.suffix_plain(a, b, Q, beta))


# ---------------------------------------------------------------------------
# the sorted MSM's kernels at 12 limbs (BLS12-381, BLS12-377)
# ---------------------------------------------------------------------------

BLS12 = ("bls12_381", "bls12_377")


def _rows12(curve, ext, seed, n=6):
    """As _rows for a BLS12 curve: (affine rows, Jacobian rows with Z
    within 2^8 of q and a point at infinity last), its q and beta."""
    rng = random.Random(seed)
    grp = g2_group(curve) if ext else g1_group(curve)
    q = grp.q
    beta = grp.tower.beta - q if ext else None
    f = field_ops2(q, beta) if ext else field_ops(q)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
    pts += [-p for p in pts]
    co = (lambda v: (v.c0, v.c1)) if ext else (lambda v: v)

    def enc(vals):
        return f.encode([co(v) for v in vals]).reshape(len(vals), -1).to(torch.int32)

    X, Y, Z = [], [], []
    for p in pts:
        z = q - rng.randrange(1, 1 << 8)
        z = Fq2(grp.tower, z, rng.randrange(q)) if ext else z
        X.append(p.x * z * z if ext else p.x * z * z % q)
        Y.append(p.y * z * z * z if ext else p.y * z ** 3 % q)
        Z.append(z)
    X.append(pts[0].x)
    Y.append(pts[0].y)
    Z.append(Fq2(grp.tower, 0, 0) if ext else 0)
    affine = torch.cat([enc([p.x for p in pts]), enc([p.y for p in pts])], 1)
    return affine, torch.cat([enc(X), enc(Y), enc(Z)], 1), q, beta


@pytest.mark.parametrize("ext,mode,safe", [(False, "mixed", False), (False, "mixed", True), (False, "general", True),
                                           (True, "mixed", False), (True, "mixed", True), (True, "general", True)],
                         ids=["Fq-mixed-unsafe", "Fq-mixed-safe", "Fq-general", "Fq2-mixed-unsafe",
                              "Fq2-mixed-safe", "Fq2-general"])
@pytest.mark.parametrize("curve", BLS12)
def test_walk_kernel_12_limbs_at_every_split(dev, curve, ext, mode, safe):
    """The 12-limb walk through the wrapper (one launch, counted) and through
    its C entry point at S = 1, 3, 7, 16 and K, each bit-equal to
    walk_plain, over the flag patterns of test_torch_walk_split; in the
    unsafe walks a doubling planted in lane 0 sets coll there."""
    from test_torch_walk_split import _patterns

    from zokrates_tpu_torch.kernels import cuda

    K, L = 24, 160
    affine, jac, q, beta = _rows12(curve, ext, seed=70 + ext)
    rng = np.random.default_rng(71)
    flags = ((rng.random((K, L)) < 0.15).astype(np.int32) | ((rng.random((K, L)) < 0.1).astype(np.int32) << 1))
    cols = list(_patterns(K, rng).values())
    flags[:, 1 : 1 + len(cols)] = np.stack(cols, 1)
    src = affine if mode == "mixed" else jac
    idx = rng.integers(0, src.shape[0], (K, L))
    flags[:2, 0] = 0
    idx[:2, 0] = 0  # a doubling in lane 0
    qrows = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous().to(dev)
    fl = torch.as_tensor(flags).to(dev)
    ref_out, ref_coll = ms.walk_plain(qrows, fl, q, mode, safe, beta)
    assert bool(ref_coll[0]) == (mode == "mixed" and not safe)
    before = ms.LAUNCHES["walk_" + mode]
    out, coll = ms.walk(qrows, fl, q, mode, safe, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["walk_" + mode] == before + 1
    assert torch.equal(out, ref_out) and torch.equal(coll, ref_coll)
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, beta)
    assert nl == 12
    stream = torch.cuda.current_stream(dev).cuda_stream
    for S in (1, 3, 7, 16, K):
        out = torch.full_like(ref_out, -1)
        coll = torch.zeros(L, dtype=torch.int32, device=dev)
        rc = lib.zkt_msm_walk(qrows.data_ptr(), fl.data_ptr(), out.data_ptr(), coll.data_ptr(), K, L, S,
                              nl, int(ext), int(mode == "mixed"), int(safe), pl, one, n0, babs, stream)
        cuda.check(rc, "walk")
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out), f"S={S}"
        assert torch.equal(coll, ref_coll), f"S={S}"


@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
@pytest.mark.parametrize("curve", BLS12)
def test_suffix_kernel_12_limbs_equals_plain(dev, curve, ext):
    _, jac, q, beta = _rows12(curve, ext, seed=72 + ext)
    rng = np.random.default_rng(73)
    Lb, M = 5, 200
    a, b = _gather(jac, (Lb, M), rng).to(dev), _gather(jac, (Lb, M), rng).to(dev)
    before = ms.LAUNCHES["suffix"]
    out = ms.suffix(a, b, q, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix"] == before + 1
    assert torch.equal(out, ms.suffix_plain(a, b, q, beta))


@pytest.mark.parametrize("Lb", [1, 3, 32])
@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
@pytest.mark.parametrize("curve", ["bn128", "bls12_381"])
def test_suffix_kernel_at_every_split(dev, curve, ext, Lb):
    """The suffix kernel at 8 (BN254) and 12 limbs (BLS12-381) on M = 203
    lanes, a multiple of no block (128 lanes at k = 1, 128/k at k > 1):
    through the wrapper (k = suffix_split(Lb, M), one launch, counted) and
    through the C entry point at every power of two k that divides Lb, each
    bit-equal to suffix_plain at that k. Lanes 0-3 planted: the same point
    in both slots everywhere (every add of the walk and, at c = 1, of the
    scan doubles), all at infinity, A = -B (each T cancels), slot a at
    infinity."""
    from zokrates_tpu_torch.kernels import cuda

    if curve == "bn128":
        (_, jac), q, beta, n = _rows(ext, seed=80 + ext), Q, (-1 if ext else None), 8
    else:
        (_, jac, q, beta), n = _rows12(curve, ext, seed=82 + ext), 6
    inf = jac.shape[0] - 1
    rng = np.random.default_rng(81 + Lb)
    M = 203
    ia = rng.integers(0, jac.shape[0], (Lb, M))
    ib = rng.integers(0, jac.shape[0], (Lb, M))
    ia[:, 0] = ib[:, 0] = 2
    ia[:, 1] = ib[:, 1] = inf
    ia[:, 2] %= n
    ib[:, 2] = ia[:, 2] + n
    ia[:, 3] = inf
    a = jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous().to(dev)
    b = jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous().to(dev)
    want = {k: ms.suffix_plain(a, b, q, beta, k) for k in (1, 2, 4, 8, 16, 32) if Lb % k == 0}
    before = ms.LAUNCHES["suffix"]
    out = ms.suffix(a, b, q, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix"] == before + 1
    assert ms.suffix_split(Lb, M) == (32 if Lb == 32 else 1)
    assert torch.equal(out, want[ms.suffix_split(Lb, M)])
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, beta)
    assert nl == (8 if curve == "bn128" else 12)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, ref in want.items():
        got = torch.full_like(out, -1)
        rc = lib.zkt_msm_suffix(a.data_ptr(), b.data_ptr(), got.data_ptr(), Lb, M, k, nl, int(ext), pl, one, n0,
                                babs, stream)
        cuda.check(rc, "suffix")
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"k={k}"


def test_suffix_entry_point_refuses_bad_splits(dev):
    """A k that is not a power of two, exceeds a block (128 threads) or
    does not divide Lb launches nothing: the C entry point returns an error
    code, which cuda.check raises, and the output stays as it was."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(Q, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    M = 8
    a = torch.zeros((256, 48, M), dtype=torch.int32, device=dev)
    out = torch.full((96, M), -1, dtype=torch.int32, device=dev)
    for Lb, k in ((12, 0), (12, 3), (12, 8), (256, 256)):
        with pytest.raises(RuntimeError, match="suffix launch failed"):
            cuda.check(lib.zkt_msm_suffix(a.data_ptr(), a.data_ptr(), out.data_ptr(), Lb, M, k, nl, 0, pl, one, n0,
                                          babs, stream), "suffix")
    torch.cuda.synchronize()
    assert bool((out == -1).all())


@pytest.mark.parametrize("lw,W,L", [(1, 3, 5), (8, 3, 5), (128, 2, 1), (1024, 1, 32)])
@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
@pytest.mark.parametrize("curve", BLS12)
def test_suffix_fold_kernel_12_limbs_equals_plain(dev, curve, ext, lw, W, L):
    """The 12-limb epilogue at lw = 1 (no tree) up to 1024 (the tree's
    widest level: 256 threads, two adds each, at the Fq2 instantiation's
    255 registers a thread), with about a fifth of the lanes' acc and tot
    at infinity."""
    _, jac, q, beta = _rows12(curve, ext, seed=74 + ext)
    rng = np.random.default_rng(75 + lw)
    inf = jac.shape[0] - 1
    idx = rng.integers(0, jac.shape[0], (2, W * lw))
    idx[rng.random((2, W * lw)) < 0.2] = inf
    out6 = torch.cat([jac[torch.as_tensor(idx[0])], jac[torch.as_tensor(idx[1])]], 1).T.contiguous().to(dev)
    before = ms.LAUNCHES["suffix_fold"]
    got = ms.suffix_fold(out6, q, W, lw, L, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix_fold"] == before + 1
    want = ms.suffix_fold_plain(out6, q, W, lw, L, beta)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# a 512-bit prime: 32 16-bit limbs, 16 32-bit limbs, a width no kernel has
P512 = (1 << 512) - 569


def test_msm_entry_points_refuse_unknown_widths(dev):
    """A limb count with no instantiation (10) launches nothing: each C
    entry point returns an error code, which cuda.check raises; and the
    wrappers refuse a 512-bit field (32 16-bit limbs) before any launch."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    _, pl, one, n0, babs = cuda.field_params(Q, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    wide = torch.zeros(1 << 14, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    calls = {
        "walk": lambda: lib.zkt_msm_walk(p, p, p, p, 1, 1, 1, 10, 0, 1, 1, pl, one, n0, babs, stream),
        "suffix": lambda: lib.zkt_msm_suffix(p, p, p, 1, 1, 1, 10, 0, pl, one, n0, babs, stream),
        "suffix_fold": lambda: lib.zkt_msm_suffix_fold(p, p, wide.data_ptr(), 1, 1, 1, 10, 0, pl, one, n0, babs,
                                                       stream),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} launch failed"):
            cuda.check(call(), name)
    torch.cuda.synchronize()
    before = dict(ms.LAUNCHES)
    with pytest.raises(ValueError, match="16 or 24 or 48 16-bit limbs, got nl=32"):
        ms.walk(torch.zeros((1, 64, 4), dtype=torch.int32, device=dev),
                torch.zeros((1, 4), dtype=torch.int32, device=dev), P512, "mixed", True)
    assert dict(ms.LAUNCHES) == before


def test_wrappers_refuse_mixed_devices(dev):
    q = torch.zeros((2, 32, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ms.walk(q, torch.zeros((2, 4), dtype=torch.int32), Q, "mixed", True)
    with pytest.raises(ValueError):
        ms.suffix(torch.zeros((1, 48, 4), dtype=torch.int32, device=dev),
                  torch.zeros((1, 48, 4), dtype=torch.int32), Q)


# ---------------------------------------------------------------------------
# the h stage's kernels and the suffix epilogue
# ---------------------------------------------------------------------------

R_MOD = g1_group("bn128").r
Q381 = g1_group("bls12_381").q
QBW6 = g1_group("bw6_761").q


def _nl(p):
    """16-bit limbs of an element: 16 for a 254/255-bit p, 24 for a
    377/381-bit one, 48 for BW6-761's 761-bit q."""
    return field_ops(p).nl


def _elems(shape, seed, p=R_MOD):
    """Canonical residues mod p as (..., nl) int64 16-bit limbs (_nl)."""
    nl = _nl(p)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, tuple(shape) + (nl,), dtype=np.int64)
    x[..., -1] = rng.integers(0, p >> (16 * nl - 16), tuple(shape))
    return torch.as_tensor(x)


def _emul_operands(kind, B, L, seed, p, dev):
    """(a, b) for emul: b "shared" (L, nl), "full" (B, L, nl), "row" (one
    element, row stride 0), or "strided" (a and b slices [:, 0], [:, 2] of a
    (B, 3, L, nl) tensor, as the h stage's A*B)."""
    nl = _nl(p)
    a = _elems((B, L), seed, p).to(dev)
    if kind == "shared":
        return a, _elems((L,), seed + 1, p).to(dev)
    if kind == "full":
        return a, _elems((B, L), seed + 2, p).to(dev)
    if kind == "row":
        return a, _elems((), seed + 3, p).to(dev).expand(L, nl)
    abc = _elems((B, 3, L), seed + 4, p).to(dev)
    return abc[:, 0], abc[:, 2]


@pytest.mark.parametrize("p", [R_MOD, Q381, QBW6], ids=["8limbs", "12limbs", "24limbs"])
@pytest.mark.parametrize("kind", ["shared", "full", "row", "strided"])
@pytest.mark.parametrize("B,L", [(3, 1000), (1, 1), (2, 129)])
def test_emul_kernel_equals_plain(dev, kind, p, B, L):
    """At 8, 12 and 24 limbs (24: BW6-761's Fq, tiles of 64 elements, so
    129 is two full tiles and one of 1)."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    a, b = _emul_operands(kind, B, L, 1, p, dev)
    before = pf.LAUNCHES["emul"]
    out = pf.emul(p, a, b)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["emul"] == before + 1
    assert torch.equal(out, pf.emul_plain(p, a, b))


@pytest.mark.parametrize("kind,B,L", [("shared", 48, 32768), ("row", 48, 32768), ("full", 16, 32768),
                                      ("strided", 16, 32768), ("row", 16, 32768), ("row", 16, 27281)])
def test_emul_kernel_batch_shapes(dev, kind, B, L):
    """The batched prove's h-stage products (B = 16 witnesses, 3B transforms)."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    a, b = _emul_operands(kind, B, L, 40, R_MOD, dev)
    out = pf.emul(R_MOD, a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, pf.emul_plain(R_MOD, a, b))


@pytest.mark.parametrize("kind,B,L", [("row", 1, 1 << 19), ("shared", 2, 4097), ("full", 1, 65)])
def test_emul_kernel_24_limbs_gm17_shapes(dev, kind, B, L):
    """emul at 24 limbs at GM17's key encoding over BW6-761's Fq (the
    a, c and h queries' 2^18 points: x and y, one R^2 row), a shared b, a
    full one and a row of one tile and one element."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    a, b = _emul_operands(kind, B, L, 60, QBW6, dev)
    before = pf.WIDTH_LAUNCHES[("emul", 24)]
    out = pf.emul(QBW6, a, b)
    torch.cuda.synchronize()
    assert pf.WIDTH_LAUNCHES[("emul", 24)] == before + 1
    assert torch.equal(out, pf.emul_plain(QBW6, a, b))


def test_emul_entry_point_refuses_unknown_widths(dev):
    """zkt_emul launches nothing for a limb count it has no instantiation
    of (10), nor for a b row stride other than 0 or 2 * limbs."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    _, pl, one, n0, _ = cuda.field_params(R_MOD, None)
    buf = torch.zeros(1 << 12, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n32, b_rs in ((10, 20), (8, 8)):
        with pytest.raises(RuntimeError, match="emul launch failed"):
            cuda.check(lib.zkt_emul(p, p, p, 1, 4, 0, 0, b_rs, n32, pl, one, n0, stream), "emul")
    torch.cuda.synchronize()


@pytest.mark.parametrize("B,L,top", [(2, 777, 1 << 31), (3, 1, 1 << 31), (1, 3, 1 << 31), (2, 777, 1 << 47),
                                     (1, 128, 1 << 31), (1, 129, 1 << 31), (16, 90112, 1 << 31),
                                     (16, 98304, 1 << 31), (16, 95233, 1 << 31)])
def test_ereduce_wide_kernel_equals_plain(dev, B, L, top):
    """Ragged L (777 = 6 tiles and 9 elements, 95233), the corrections'
    shapes and 128 elements (one thread an element, ereduce_lane_kernel),
    129 (the tile walk's two tiles, the last of one element), the walk
    matvec's shapes at B = 16, sums up to 2^31 and 2^47, the largest and 0
    in every column of some elements."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    rng = np.random.default_rng(6)
    t = torch.as_tensor(rng.integers(top - (1 << 20), top, (B, L, 16), dtype=np.int64))
    t[0, :5] = top - 1
    t[-1, -1] = 0
    t = t.to(dev)
    before = pf.LAUNCHES["ereduce_wide"]
    out = pf.ereduce_wide(R_MOD, t)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["ereduce_wide"] == before + 1
    assert torch.equal(out, pf.ereduce_wide_plain(R_MOD, t))


def test_ereduce_entry_point_refuses_unknown_widths(dev):
    """zkt_ereduce_wide launches nothing for a limb count it has no
    instantiation of (16)."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    _, pl, one, n0, _ = cuda.field_params(R_MOD, None, cuda.NL32_FIELD)
    buf = torch.zeros(1 << 12, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    rc = lib.zkt_ereduce_wide(p, p, 4, 16, pl, pl, one, n0, torch.cuda.current_stream(dev).cuda_stream)
    with pytest.raises(RuntimeError, match="ereduce_wide launch failed"):
        cuda.check(rc, "ereduce_wide")
    torch.cuda.synchronize()


@pytest.mark.parametrize("logn,batch", [(1, 1), (2, 3), (5, 2), (10, 1), (10, 3), (11, 1), (15, 3), (15, 16),
                                        (15, 48), (16, 1), (16, 2), (17, 1), (21, 1)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_kernel_equals_plain(dev, logn, batch, inverse):
    from zokrates_tpu_torch.kernels import ntt_pallas as nk
    from zokrates_tpu_torch.kernels.ntt import domain_for_curve

    dom = domain_for_curve("bn128", 1 << logn)
    x = _elems((batch, 1 << logn), 7 + logn).to(dev)
    before = nk.LAUNCHES["ntt"]
    out = nk.fft_core(dom, x, inverse)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["ntt"] == before + len(nk.pass_plan(logn, batch))
    assert torch.equal(out, nk.fft_core_plain(dom, x, inverse))


def test_ntt_entry_point_refuses_bad_plans(dev):
    """zkt_ntt_pass launches nothing for a thread map that sets one bit of
    a block's elements twice, or a block of more than 1024 elements."""
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.kernels import ntt_pallas as nk

    lib = cuda.load()
    _, pl, one, n0, _ = cuda.field_params(R_MOD, None, cuda.NL32_FIELD)
    buf = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    good = nk._thread_map_ints(8, 0)
    twice = (type(good))(*good)
    twice[1] = twice[0]  # stage 0's thread bits 0 and 1 on one bit of E
    for tpos, log_slots in ((twice, 0), (good, 3)):
        rc = lib.zkt_ntt_pass(p, p, p, p, 1, 8, 0, 8, log_slots, tpos, 8, pl, one, n0, stream)
        with pytest.raises(RuntimeError, match="ntt launch failed"):
            cuda.check(rc, "ntt")
    torch.cuda.synchronize()


@pytest.mark.parametrize("lw,W,L", [(8, 5, 3), (128, 4, 1), (128, 2, 2), (1024, 1, 32)])
@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
def test_suffix_fold_kernel_equals_plain(dev, ext, lw, W, L):
    _, jac = _rows(ext, seed=8)
    rng = np.random.default_rng(9)
    inf = jac.shape[0] - 1
    idx = rng.integers(0, jac.shape[0], (2, W * lw))
    idx[:, : lw // 2] = inf  # window 0: half of its lanes' acc and tot at infinity
    out6 = torch.cat([jac[torch.as_tensor(idx[0])], jac[torch.as_tensor(idx[1])]], 1).T.contiguous().to(dev)
    beta = -1 if ext else None
    before = ms.LAUNCHES["suffix_fold"]
    got = ms.suffix_fold(out6, Q, W, lw, L, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix_fold"] == before + 1
    want = ms.suffix_fold_plain(out6, Q, W, lw, L, beta)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lw", [1, 2, 128, 1024])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("ext", [False, True], ids=["Fq", "Fq2"])
def test_suffix_fold_kernel_window_shapes(dev, ext, W, lw):
    """The two-pass epilogue (ladders, then each window's tree) at lw = 1
    (no tree), 2, 128 and 1024 (two adds a thread at the top level), one
    and three windows, L = 5, with about a quarter of the lanes' acc and
    tot at infinity and the last window's at infinity throughout."""
    _, jac = _rows(ext, seed=21)
    rng = np.random.default_rng(22 + lw + W)
    inf = jac.shape[0] - 1
    idx = rng.integers(0, jac.shape[0], (2, W * lw))
    idx[rng.random((2, W * lw)) < 0.2] = inf
    if W > 1:
        idx[:, (W - 1) * lw :] = inf
    out6 = torch.cat([jac[torch.as_tensor(idx[0])], jac[torch.as_tensor(idx[1])]], 1).T.contiguous().to(dev)
    beta = -1 if ext else None
    before = ms.LAUNCHES["suffix_fold"]
    got = ms.suffix_fold(out6, Q, W, lw, 5, beta)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix_fold"] == before + 1
    want = ms.suffix_fold_plain(out6, Q, W, lw, 5, beta)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_new_wrappers_refuse_mixed_devices(dev):
    from zokrates_tpu_torch.kernels import pallas_field as pf

    a = _elems((1, 4), 10).to(dev)
    with pytest.raises(ValueError):
        pf.emul(R_MOD, a, _elems((4,), 11))


def _walk_dev(dev, n, m, L, seed, p=R_MOD):
    """An R1CSDevice on the card over a random row-sorted stream of L
    records on 3n rows and m variables (its three matrix blocks)."""
    from zokrates_tpu_torch.ir import r1cs_device as rd

    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, 3 * n, size=L)).astype(np.int64)
    cols = rng.integers(0, m, size=L).astype(np.int64)
    coeff = _elems((L,), seed + 1, p).numpy()
    blocks = [(rows >= k * n) & (rows < (k + 1) * n) for k in range(3)]
    coo = [rd.COOMatrix(torch.as_tensor(rows[b] - k * n, device=dev), torch.as_tensor(cols[b], device=dev),
                        torch.as_tensor(coeff[b], device=dev), n, rows_np=rows[b] - k * n, cols_np=cols[b],
                        coeff_np=coeff[b])
           for k, b in enumerate(blocks)]
    return rd.R1CSDevice("bn128" if p == R_MOD else "bls12_381", n, 1, m - 1, *coo)


R381 = g1_group("bls12_381").r


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("size,lanes", [("toy", 1024), ("toy", 2048), ("sha256", 1024), ("sha256", 4096),
                                        ("sha256", 32768)])
@pytest.mark.parametrize("p", [R_MOD, R381], ids=["bn128", "bls12_381"])
def test_mulacc_walk_kernel_equals_plain(dev, B, size, lanes, p):
    """The toy's 3000 records over 64 rows a block and 40 variables, and
    sha256's sizes (405,504 records over 3 x 2^15 rows, 27,281 variables:
    no padding at 1024 lanes, lanes ending in padding at 32768), at
    several lane counts, on BN254's and BLS12-381's r; B = 1 (a proof a
    block), 3 (two a block, the second block's second proof absent) and
    16 (four a block)."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    n, m, L = (64, 40, 3000) if size == "toy" else (1 << 15, 27281, 405504)
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk

    w = build_mulacc_walk(_walk_dev(dev, n, m, L, 30 + lanes, p), lanes)
    z = _elems((B, m), 31, p).to(dev)
    before = pf.LAUNCHES["mulacc_walk"]
    out = pf.mulacc_walk(p, z, w)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["mulacc_walk"] == before + 2  # the pack, then the walk
    assert torch.equal(out, pf.mulacc_walk_plain(p, z, w))
    assert not out[:, w.n_flush:].any()


def test_mulacc_entry_point_refuses_bad_plans(dev):
    """zkt_mulacc_walk launches nothing for lanes that are not a multiple
    of its block, nor for K above 2^16 records a lane."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    _, pl, one, n0, _ = cuda.field_params(R_MOD, None, cuda.NL32_FIELD)
    buf = torch.zeros(1 << 12, dtype=torch.int64, device=dev)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for K, M in ((4, 200), ((1 << 16) + 1, 128)):
        rc = lib.zkt_mulacc_walk(p, p, 4, p, p, p, p, p, 1, K, M, 10, 1, 8, 8, pl, one, n0, stream)
        with pytest.raises(RuntimeError, match="mulacc_walk launch failed"):
            cuda.check(rc, "mulacc_walk")
    torch.cuda.synchronize()


def test_walk_matvec_on_card(dev):
    """groth16._matvec_walk on the card at the toy's shapes, B = 2, at the
    lanes walk_lanes picks and at 4096, equals _matvec_coo."""
    from zokrates_tpu_torch.schemes import groth16 as g

    rdev = _walk_dev(dev, 64, 40, 3000, 33)
    z = _elems((2, 40), 35).to(dev)
    want = g._matvec_coo(R_MOD, rdev, z)
    for lanes in (None, 4096):
        assert torch.equal(g._matvec_walk(R_MOD, rdev, z, lanes), want)


def test_shared_bucket_msm_on_card(dev):
    """The shared-bucket h MSM on the card as the prove runs it (c = 16, one
    window of Wc*N slots, lw2 = 1024) at N = 4096, against the oracle:
    points k_i*G from the fixed-base MSM, their shifted copies from
    groth16._h16_p128, so the MSM is (sum k_i s_i)*G."""
    from zokrates_tpu_torch.fields.limbs import ints_to_limbs
    from zokrates_tpu_torch.schemes import groth16 as g

    rng = random.Random(15)
    N = 4096
    ks = [rng.randrange(1, R_MOD) for _ in range(N)]
    sc = [rng.randrange(R_MOD) for _ in range(N)]
    rows, _ = g._fb_g1("bn128", ks, dev)
    h16 = torch.as_tensor(g._h16_p128("bn128", rows, N, dev).astype(np.int32)).to(dev)
    cfg = g._shared_h_cfg(ms.default_config(N))
    Wc = ms.shared_window_count(R_MOD, 16)
    S = torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64)).to(dev)
    before = ms.LAUNCHES["walk_mixed"]
    out, _ = ms._msm_from_plan(Q, 1, cfg, h16[None], ms._msm_plan_shared(Wc, N, cfg, S), True)
    assert ms.LAUNCHES["walk_mixed"] == before + 1
    jx, jy, jz = ms.combine_windows(Q, R_MOD, tuple(a[0].cpu().numpy() for a in out), 1, 16, native=False)
    want = g1_group("bn128").generator() * (sum(k * s for k, s in zip(ks, sc)) % R_MOD)
    zi = pow(jz, -1, Q)
    assert (jx * zi * zi % Q, jy * zi ** 3 % Q) == (want.x, want.y)


# ---------------------------------------------------------------------------
# the standalone point kernels, and GM17 on the card
# ---------------------------------------------------------------------------


def _g1_pool(seed, n=4):
    """Affine G1 rows (2n, 32) of n points and their negatives, int64
    Montgomery limbs [x | y]: row j + n is -row j."""
    rng = random.Random(seed)
    grp = g1_group("bn128")
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
    pts += [-p for p in pts]
    f = field_ops(Q)
    return torch.cat([f.encode([p.x for p in pts]), f.encode([p.y for p in pts])], 1), rng


def test_mixed_add_lm_kernel_equals_plain(dev):
    from zokrates_tpu_torch.kernels import pallas_field as pf

    pool, rng = _g1_pool(16)
    n, N = pool.shape[0] // 2, 512
    nrng = np.random.default_rng(17)
    qi = nrng.integers(0, 2 * n, N)
    pi = nrng.integers(0, 2 * n, N)
    pi[0::4] = qi[0::4]                    # P == Q
    pi[1::4] = (qi[1::4] + n) % (2 * n)    # P == -Q
    f = field_ops(Q)
    z = f.encode([rng.randrange(1, Q) for _ in range(N)])
    z[2::8] = 0                            # P at infinity
    z2 = f.mul(z, z)
    P = (f.mul(pool[pi, :16], z2), f.mul(pool[pi, 16:], f.mul(z2, z)), z)
    args = [t.T.to(torch.int32).contiguous().to(dev) for t in (*P, pool[qi, :16], pool[qi, 16:])]
    before = pf.LAUNCHES["mixed_add_lm"]
    got = pf.mixed_add_lm(Q, *args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["mixed_add_lm"] == before + 1
    want = pf.mixed_add_lm_plain(Q, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cancel = (pi % n == qi % n) & (pi != qi) & ~f.is_zero(z).numpy()
    assert torch.equal((got[2] == 0).all(0).cpu(), torch.as_tensor(cancel)) and cancel.any()


def test_accumulate_lm_kernel_equals_plain(dev):
    from zokrates_tpu_torch.kernels import pallas_field as pf

    pool, _ = _g1_pool(18)
    n = pool.shape[0] // 2
    nb, chunk_len, R = 16, 8, 512
    nrng = np.random.default_rng(19)
    digits = nrng.integers(0, nb + 3, (chunk_len, R)).astype(np.int64)
    qi = nrng.integers(0, 2 * n, (chunk_len, R))
    digits[:3, 0], qi[:3, 0] = 5, [1, 1, 1 + n]          # P, P (doubles), -P
    digits[:2, 1], qi[:2, 1] = 7, [2, 2 + n]             # P, -P (cancels)
    digits[:, 2] = [0, nb, 0x7FFFFFFF, 0xFFFFFFFF] * 2   # touch nothing
    qt = torch.as_tensor(qi)

    def rows(c):  # (chunk_len, R, 16) -> (chunk_len * 16, R) int32
        return c.permute(0, 2, 1).reshape(chunk_len * 16, R).to(torch.int32).contiguous().to(dev)

    args = (torch.as_tensor(digits.astype(np.uint32).view(np.int32)).to(dev),
            rows(pool[qt][..., :16]), rows(pool[qt][..., 16:]))
    before = pf.LAUNCHES["accumulate_lm"]
    got = pf.accumulate_lm(Q, *args, n_buckets=nb)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["accumulate_lm"] == before + 1
    want = pf.accumulate_lm_plain(Q, *args, n_buckets=nb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2][0] == 0).all() and (got[2][:, :, 2] == 0).all()   # untouched buckets
    assert (got[2][7, :, 1] == 0).all()                             # cancelled


@pytest.mark.parametrize("curve", BLS12)
def test_mixed_add_lm_12_limbs_equals_plain(dev, curve):
    """mixed_add_lm at 12 limbs (the BLS12 base fields): P == Q, P == -Q,
    P at infinity and Z within 2^8 of q, against the plain version."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    affine, jac, q, _ = _rows12(curve, False, 41)
    nl = 24
    nrng = np.random.default_rng(42)
    n, N = affine.shape[0], 768
    qi = nrng.integers(0, n, N)
    pi = nrng.integers(0, jac.shape[0], N)
    pi[0::4] = qi[0::4]                        # P == Q (the row with its Z near q)
    pi[1::4] = (qi[1::4] + n // 2) % n         # P == -Q
    pi[2::8] = jac.shape[0] - 1                # P at infinity

    def rows(t, lo):
        return t[:, lo : lo + nl].T.contiguous().to(dev)

    args = [rows(jac[pi], 0), rows(jac[pi], nl), rows(jac[pi], 2 * nl), rows(affine[qi], 0), rows(affine[qi], nl)]
    before = pf.LAUNCHES["mixed_add_lm"]
    got = pf.mixed_add_lm(q, *args)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["mixed_add_lm"] == before + 1
    want = pf.mixed_add_lm_plain(q, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2] == 0).all(0).any()  # the cancellations


@pytest.mark.parametrize("curve", BLS12)
def test_accumulate_lm_12_limbs_equals_plain(dev, curve):
    from zokrates_tpu_torch.kernels import pallas_field as pf

    affine, _, q, _ = _rows12(curve, False, 43)
    nl, n = 24, affine.shape[0]
    nb, chunk_len, R = 16, 6, 512
    nrng = np.random.default_rng(44)
    digits = nrng.integers(0, nb + 3, (chunk_len, R)).astype(np.int64)
    qi = nrng.integers(0, n, (chunk_len, R))
    digits[:3, 0], qi[:3, 0] = 5, [1, 1, 1 + n // 2]      # P, P (doubles), -P
    digits[:2, 1], qi[:2, 1] = 7, [2, 2 + n // 2]         # P, -P (cancels)
    digits[:, 2] = [0, nb, 0x7FFFFFFF, 0xFFFFFFFF, 0, 0]  # touch nothing
    qt = torch.as_tensor(qi)

    def rows(c):  # (chunk_len, R, nl) -> (chunk_len * nl, R)
        return c.permute(0, 2, 1).reshape(chunk_len * nl, R).contiguous().to(dev)

    args = (torch.as_tensor(digits.astype(np.uint32).view(np.int32)).to(dev),
            rows(affine[qt][..., :nl]), rows(affine[qt][..., nl:]))
    before = pf.LAUNCHES["accumulate_lm"]
    got = pf.accumulate_lm(q, *args, n_buckets=nb)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["accumulate_lm"] == before + 1
    want = pf.accumulate_lm_plain(q, *args, n_buckets=nb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2][7, :, 1] == 0).all() and (got[2][:, :, 2] == 0).all()


def test_point_entry_points_refuse_unknown_widths(dev):
    """The C entry points launch nothing at a width they have no
    instantiation of: 4 and 16 limbs, and 24 for the accumulation (no path
    accumulates over BW6-761's Fq)."""
    from zokrates_tpu_torch.kernels import cuda

    lib = cuda.load()
    n = 256
    t = torch.zeros((48, n), dtype=torch.int32, device=dev)
    _, pl, one, n0, _ = cuda.field_params(Q, None, cuda.NL32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for nl in (4, 16, 24):
        if nl != 24:
            rc = lib.zkt_mixed_add_lm(*(t.data_ptr() for _ in range(8)), n, 256, nl, pl, one, n0, stream)
            assert rc != 0
        rc = lib.zkt_accumulate_lm(t.data_ptr(), t.data_ptr(), t.data_ptr(), t.data_ptr(), t.data_ptr(),
                                   t.data_ptr(), 1, n, 4, 256, nl, pl, one, n0, stream)
        assert rc != 0


@pytest.mark.parametrize("curve", ["bn128", "bls12_381"])
def test_ceremony_ladders_on_card(dev, curve):
    """kernels/ladder on the card against Python-int point arithmetic on a
    few hundred points: one scalar for all (a contribution), a scalar a
    point (coefficients 1, small, negated small and full width), the
    column sums through accumulate_lm (a cancelling column, an empty one,
    a column of 40 terms, more than a piece) and over G2 through jec."""
    from zokrates_tpu_torch.kernels import ladder, pallas_field as pf
    from zokrates_tpu_torch.kernels.jec import curve_ops, curve_ops_g2

    rng = random.Random(45)
    grp = g1_group(curve)
    q, r = grp.q, grp.r
    ops = curve_ops(q)
    base = [grp.generator() * rng.randrange(1, r) for _ in range(12)]
    pts = [base[i % 12] * (i + 1) for i in range(300)]
    ax = ops.f.encode([p.x for p in pts], device=dev)
    ay = ops.f.encode([p.y for p in pts], device=dev)
    k = rng.randrange(1, r)
    before = dict(pf.LAUNCHES)
    got = ops.to_affine_ints(ladder.scale_affine(curve, ax, ay, k))
    assert got == [((p * k).x, (p * k).y) for p in pts]
    ks = [rng.choice([1, 2, r - 1, rng.randrange(1, 1 << 64), r - rng.randrange(1, 1 << 64),
                      rng.randrange(1, r)]) for _ in pts]
    terms = ops.to_affine_ints(ladder.scale_terms(ops, ladder.g1_adder(q), ax, ay, ks, r))
    assert terms == [((p * c).x, (p * c).y) for p, c in zip(pts, ks)]
    cols = np.asarray([rng.randrange(0, 80) for _ in pts] + [80, 80] + [81] * 40)
    extra = [pts[0], -pts[0]] + [pts[j] for j in range(40)]
    allp = pts + extra
    bx = ops.f.encode([p.x for p in allp], device=dev)
    by = ops.f.encode([p.y for p in allp], device=dev)
    sums, (R, steps) = ladder.column_sums_g1(q, bx, by, cols, 83)
    got = ops.to_affine_ints(sums)
    for c in range(83):
        acc = grp.zero()
        for p, cc in zip(allp, cols):
            if cc == c:
                acc = acc + p
        assert got[c] == (None if acc.infinity else (acc.x, acc.y)), c
    assert got[80] is None and got[82] is None
    assert steps < 40  # the 40-term column is summed in pieces of ladder.PIECE
    assert pf.LAUNCHES["accumulate_lm"] == before.get("accumulate_lm", 0) + 1
    assert pf.LAUNCHES["mixed_add_lm"] > before.get("mixed_add_lm", 0) + 100
    g2 = g2_group(curve)
    o2 = curve_ops_g2(curve)
    p2 = [g2.generator() * rng.randrange(1, r) for _ in range(24)]
    c2x = o2.f.encode([(p.x.c0, p.x.c1) for p in p2], device=dev)
    c2y = o2.f.encode([(p.y.c0, p.y.c1) for p in p2], device=dev)
    k2 = [rng.choice([1, r - 3, rng.randrange(1, r)]) for _ in p2]
    t2 = ladder.scale_terms(o2, o2.mixed_add, c2x, c2y, k2, r)
    from zokrates_tpu_torch.kernels.fixed_base import batch_normalize

    tx, ty, _ = batch_normalize(o2, t2)
    cols2 = np.asarray([i % 5 for i in range(24)])
    got2 = o2.to_affine_ints(ladder.column_sums_ext(o2, tx, ty, cols2, 6))
    for c in range(6):
        acc = g2.zero()
        for p, kk, cc in zip(p2, k2, cols2):
            if cc == c:
                acc = acc + p * kk
        want = None if acc.infinity else ((acc.x.c0, acc.x.c1), (acc.y.c0, acc.y.c1))
        assert got2[c] == want, c


def _toy_r1cs():
    """x_{i+1} = x_i^2 + y for 20 steps, out = x_20: instance [one, y,
    out], witness [x_0, ..., x_20] (dense index = IR variable), as a port
    R1CS and the witness of x_0 = 3, y = 7."""
    from zokrates_tpu_torch.ir.r1cs import R1CS
    from zokrates_tpu_torch.ir.witness import Witness

    p = R_MOD
    y, out, x = 1, 2, [3 + i for i in range(21)]
    A = [[(x[i], 1)] for i in range(20)] + [[(x[20], 1)]]
    B = [[(x[i], 1)] for i in range(20)] + [[(0, 1)]]
    C = [[(x[i + 1], 1), (y, p - 1)] for i in range(20)] + [[(out, 1)]]
    vals = {y: 7, x[0]: 3}
    for i in range(20):
        vals[x[i + 1]] = (vals[x[i]] ** 2 + 7) % p
    vals[out] = vals[x[20]]
    r1cs = R1CS("bn128", 3, 21, A, B, C, {v: v for v in range(1, 24)})
    return r1cs, Witness(vals)


def test_gm17_prove_verify_on_card(dev):
    """GM17 setup -> prove -> verify on the toy circuit with the card's
    kernels, the same proof as on the CPU, and a forgery rejected."""
    import json

    from zokrates_tpu_torch.kernels import ntt_pallas as nk
    from zokrates_tpu_torch.kernels import pallas_field as pf
    from zokrates_tpu_torch.schemes import gm17

    r1cs, wit = _toy_r1cs()
    draws = iter([random.Random(20).randrange(1, R_MOD) for _ in range(4)])
    pk, vk = gm17.setup(r1cs, rng=lambda: next(draws), device=dev)
    before = (ms.LAUNCHES["walk_mixed"], nk.LAUNCHES["ntt"], pf.LAUNCHES["emul"])
    proof = gm17.prove(r1cs, pk, wit, rng=lambda: 12345, device=dev)
    assert all(a > b for a, b in zip((ms.LAUNCHES["walk_mixed"], nk.LAUNCHES["ntt"], pf.LAUNCHES["emul"]),
                                     before))
    assert gm17.verify(vk, proof)
    on_cpu = gm17.prove(r1cs, pk, wit, rng=lambda: 12345, device="cpu")
    assert json.dumps(proof.to_json()) == json.dumps(on_cpu.to_json())
    proof.points["a"], proof.points["c"] = proof.points["c"], proof.points["a"]
    assert not gm17.verify(vk, proof)


def test_msm_c8_at_2_17_kernels_equal_plain(dev, monkeypatch):
    """The sorted MSM at N = 2^17 in default_config's c = 8, M1 = 1024,
    lw2 = 128 configuration (the largest of Marlin's KZG commitments) on
    the card: every walk, suffix and epilogue launch bit-equal to its plain
    version on the same inputs, and the MSM equal to the oracle (points
    drawn from 8 multiples of G, so the MSM is sum_k (sum s_i) * P_k)."""
    from collections import Counter

    from zokrates_tpu_torch.fields.limbs import ints_to_limbs

    N = 1 << 17
    rng = random.Random(17)
    grp = g1_group("bn128")
    base = [grp.generator() * rng.randrange(1, R_MOD) for _ in range(8)]
    ks = [rng.randrange(8) for _ in range(N)]
    sc = [rng.randrange(R_MOD) if i % 5 else 0 for i in range(N)]
    f = field_ops(Q)
    P128 = ms.pack_points(Q, f.encode([base[k].x for k in ks], device=dev), f.encode([base[k].y for k in ks],
                                                                                       device=dev))
    S = torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64)).to(dev)
    cfg = ms.default_config(N)
    assert (cfg.c, cfg.M1, cfg.lw2) == (8, 1024, 128)
    checked = Counter()
    plain = {"walk": ms.walk_plain, "suffix": ms.suffix_plain, "suffix_fold": ms.suffix_fold_plain}

    def held(name, fn):
        def wrapped(*args):
            out = fn(*args)
            ref = plain[name](*args)
            got = out if isinstance(out, (tuple, list)) else (out,)
            want = ref if isinstance(ref, (tuple, list)) else (ref,)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            checked[name] += 1
            return out
        return wrapped

    for name in plain:
        monkeypatch.setattr(ms, name, held(name, getattr(ms, name)))
    jx, jy, jz = ms.msm_sorted_host(Q, R_MOD, P128, S, cfg)
    assert checked["walk"] >= 2 and checked["suffix"] >= 1 and checked["suffix_fold"] >= 1
    want = grp.zero()
    for k in range(8):
        want = want + base[k] * (sum(s for kk, s in zip(ks, sc) if kk == k) % R_MOD)
    zi = pow(jz, -1, Q)
    assert (jx * zi * zi % Q, jy * zi ** 3 % Q) == (want.x, want.y)


# ---------------------------------------------------------------------------
# Nova's commitments: the sorted MSM's kernels and emul at Pasta q
# ---------------------------------------------------------------------------

PASTA = ("pallas", "vesta")


def _rows_pasta(curve, seed, n=8):
    """G1 rows of a Pasta curve (255-bit q, 8 limbs) near q: affine rows of
    n points, a quarter of them with x within 2^8 of q, and their
    negatives; Jacobian rows of the same with Z within 2^8 of q on every
    other row, a point at infinity last. Returns (affine, jac, q)."""
    from zokrates_tpu_torch.schemes.nova import _sqrt_mod

    rng = random.Random(seed)
    grp = g1_group(curve)
    q = grp.q
    pts, k = [], 1
    while len(pts) < n // 4:
        x = q - k
        y = _sqrt_mod(x * x % q * x + grp.a * x + grp.b, q)
        if y is not None:
            pts.append(grp.point(x, y))
        k += 1
    assert k < 1 << 8
    pts += [grp.generator() * rng.randrange(1, grp.r) for _ in range(n - len(pts))]
    pts += [-p for p in pts]
    f = field_ops(q)

    def enc(vals):
        return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    X, Y, Z = [], [], []
    for i, p in enumerate(pts):
        z = q - rng.randrange(1, 1 << 8) if i % 2 == 0 else rng.randrange(1, q)
        X.append(p.x * z * z % q)
        Y.append(p.y * z ** 3 % q)
        Z.append(z)
    X.append(pts[0].x)
    Y.append(pts[0].y)
    Z.append(0)
    affine = torch.cat([enc([p.x for p in pts]), enc([p.y for p in pts])], 1)
    return affine, torch.cat([enc(X), enc(Y), enc(Z)], 1), q


@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
@pytest.mark.parametrize("curve", PASTA)
def test_walk_kernel_pasta_at_every_split(dev, curve, mode, safe):
    """The walk at Pallas and Vesta Fq (8 limbs) through the wrapper (one
    launch, counted) and through its C entry point at S = 1, 3, 7, 16 and
    K, each bit-equal to walk_plain, over the flag patterns of
    test_torch_walk_split; a doubling planted in lane 0."""
    from test_torch_walk_split import _patterns

    from zokrates_tpu_torch.kernels import cuda

    K, L = 24, 160
    affine, jac, q = _rows_pasta(curve, seed=90)
    rng = np.random.default_rng(91)
    flags = ((rng.random((K, L)) < 0.15).astype(np.int32) | ((rng.random((K, L)) < 0.1).astype(np.int32) << 1))
    cols = list(_patterns(K, rng).values())
    flags[:, 1 : 1 + len(cols)] = np.stack(cols, 1)
    src = affine if mode == "mixed" else jac
    idx = rng.integers(0, src.shape[0], (K, L))
    flags[:2, 0] = 0
    idx[:2, 0] = 0
    qrows = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous().to(dev)
    fl = torch.as_tensor(flags).to(dev)
    ref_out, ref_coll = ms.walk_plain(qrows, fl, q, mode, safe)
    assert bool(ref_coll[0]) == (mode == "mixed" and not safe)
    before = ms.LAUNCHES["walk_" + mode]
    out, coll = ms.walk(qrows, fl, q, mode, safe)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["walk_" + mode] == before + 1
    assert torch.equal(out, ref_out) and torch.equal(coll, ref_coll)
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, None)
    assert nl == 8
    stream = torch.cuda.current_stream(dev).cuda_stream
    for S in (1, 3, 7, 16, K):
        out = torch.full_like(ref_out, -1)
        coll = torch.zeros(L, dtype=torch.int32, device=dev)
        rc = lib.zkt_msm_walk(qrows.data_ptr(), fl.data_ptr(), out.data_ptr(), coll.data_ptr(), K, L, S,
                              nl, 0, int(mode == "mixed"), int(safe), pl, one, n0, babs, stream)
        cuda.check(rc, "walk")
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out), f"S={S}"
        assert torch.equal(coll, ref_coll), f"S={S}"


@pytest.mark.parametrize("Lb", [1, 3, 32])
@pytest.mark.parametrize("curve", PASTA)
def test_suffix_kernel_pasta_at_every_split(dev, curve, Lb):
    """The suffix walk at Pasta q on 203 lanes through the wrapper (k =
    suffix_split(Lb, M): 1 at Lb = 1 and 3, 32 at Lb = 32) and through its C
    entry point at every k that divides Lb, each bit-equal to suffix_plain
    at that k; lanes 0-2 planted: the same point in both slots, all at
    infinity, A = -B."""
    from zokrates_tpu_torch.kernels import cuda

    _, jac, q = _rows_pasta(curve, seed=92)
    inf, n = jac.shape[0] - 1, 8
    rng = np.random.default_rng(93 + Lb)
    M = 203
    ia = rng.integers(0, jac.shape[0], (Lb, M))
    ib = rng.integers(0, jac.shape[0], (Lb, M))
    ia[:, 0] = ib[:, 0] = 2
    ia[:, 1] = ib[:, 1] = inf
    ia[:, 2] %= n
    ib[:, 2] = ia[:, 2] + n
    a = jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous().to(dev)
    b = jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous().to(dev)
    want = {k: ms.suffix_plain(a, b, q, None, k) for k in (1, 2, 4, 8, 16, 32) if Lb % k == 0}
    before = ms.LAUNCHES["suffix"]
    out = ms.suffix(a, b, q)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix"] == before + 1
    assert torch.equal(out, want[ms.suffix_split(Lb, M)])
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, ref in want.items():
        got = torch.full_like(out, -1)
        rc = lib.zkt_msm_suffix(a.data_ptr(), b.data_ptr(), got.data_ptr(), Lb, M, k, nl, 0, pl, one, n0,
                                babs, stream)
        cuda.check(rc, "suffix")
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"k={k}"


@pytest.mark.parametrize("lw,W,L", [(1, 3, 5), (128, 32, 1), (1024, 1, 32)])
@pytest.mark.parametrize("curve", PASTA)
def test_suffix_fold_kernel_pasta_equals_plain(dev, curve, lw, W, L):
    """The epilogue at Pasta q, (128, 32, 1) being a Nova commitment's (32
    windows of 128 lanes), with about a fifth of acc and tot at infinity."""
    _, jac, q = _rows_pasta(curve, seed=94)
    rng = np.random.default_rng(95 + lw)
    inf = jac.shape[0] - 1
    idx = rng.integers(0, jac.shape[0], (2, W * lw))
    idx[rng.random((2, W * lw)) < 0.2] = inf
    out6 = torch.cat([jac[torch.as_tensor(idx[0])], jac[torch.as_tensor(idx[1])]], 1).T.contiguous().to(dev)
    before = ms.LAUNCHES["suffix_fold"]
    got = ms.suffix_fold(out6, q, W, lw, L)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix_fold"] == before + 1
    for g, w in zip(got, ms.suffix_fold_plain(out6, q, W, lw, L)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,B,L", [("row", 1, 32768), ("row", 1, 1000), ("shared", 3, 1000)])
@pytest.mark.parametrize("curve", PASTA)
def test_emul_kernel_pasta_equals_plain(dev, curve, kind, B, L):
    """emul at Pasta q, (1, 32768) by one row being _mont_elems' conversion
    of a Nova commitment's bases, with a quarter of a's elements within 2^8
    of q (and b = q - 1 for the row)."""
    from zokrates_tpu_torch.fields.limbs import ints_to_limbs
    from zokrates_tpu_torch.kernels import pallas_field as pf

    q = g1_group(curve).q
    a, b = _emul_operands(kind, B, L, 96, q, dev)
    near = np.random.default_rng(97).random((B, L)) < 0.25
    k = np.random.default_rng(98).integers(1, 1 << 8, int(near.sum()))
    a[torch.as_tensor(near)] = torch.as_tensor(ints_to_limbs([q - int(v) for v in k], 16).astype(np.int64)).to(dev)
    if kind == "row":
        b = torch.as_tensor(ints_to_limbs([q - 1], 16).astype(np.int64)).to(dev).expand(L, 16)
    before = pf.LAUNCHES["emul"]
    out = pf.emul(q, a, b)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["emul"] == before + 1
    assert torch.equal(out, pf.emul_plain(q, a, b))


@pytest.mark.parametrize("curve", PASTA)
def test_msm_g1_pasta_at_2_15_equals_oracle(dev, curve):
    """groth16._msm_g1, Nova's commitment entry point, at 2^15 points on the
    card against the oracle: points drawn from 8 multiples of G, a third of
    the scalars 0 or 1 (a step's witness bits), the rest full (a cross
    term), so the MSM is sum_k (sum s_i) * P_k."""
    from zokrates_tpu_torch.schemes import groth16 as g

    rng = random.Random(99)
    grp = g1_group(curve)
    N = 1 << 15
    base = [grp.generator() * rng.randrange(1, grp.r) for _ in range(8)]
    ks = [rng.randrange(8) for _ in range(N)]
    sc = [rng.randrange(2) if i % 3 == 0 else rng.randrange(grp.r) for i in range(N)]
    before = ms.LAUNCHES["walk_mixed"]
    got = g._msm_g1(curve, [(base[k].x, base[k].y) for k in ks], sc, device=dev)
    assert ms.LAUNCHES["walk_mixed"] > before
    want = grp.zero()
    for k in range(8):
        want = want + base[k] * (sum(s for kk, s in zip(ks, sc) if kk == k) % grp.r)
    assert (got.x, got.y) == (want.x, want.y)


# ---------------------------------------------------------------------------
# BW6-761: the MSM kernels at 24 limbs over Fq (both of its groups), and
# ereduce_wide, mulacc_walk and the NTT at 12 over its 377-bit r
# ---------------------------------------------------------------------------

BW6 = "bw6_761"
R_BW6 = g1_group(BW6).r


def _rows_bw6(group, seed, n=6):
    """Rows of BW6-761's G1 or G2 (both over its 761-bit Fq, 48 16-bit
    limbs): affine rows of n seeded points and their negatives; Jacobian
    rows of the same with Z within 2^8 of q on every other row, a point at
    infinity last. Returns (affine, jac, q)."""
    rng = random.Random(seed)
    grp = g1_group(BW6) if group == "G1" else g2_group(BW6)
    q = grp.q
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
    pts += [-p for p in pts]
    f = field_ops(q)

    def enc(vals):
        return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    X, Y, Z = [], [], []
    for i, p in enumerate(pts):
        z = q - rng.randrange(1, 1 << 8) if i % 2 == 0 else rng.randrange(1, q)
        X.append(p.x * z * z % q)
        Y.append(p.y * z ** 3 % q)
        Z.append(z)
    X.append(pts[0].x)
    Y.append(pts[0].y)
    Z.append(0)
    affine = torch.cat([enc([p.x for p in pts]), enc([p.y for p in pts])], 1)
    return affine, torch.cat([enc(X), enc(Y), enc(Z)], 1), q


@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_walk_kernel_24_limbs_at_every_split(dev, group, mode, safe):
    """The walk at BW6-761's Fq (24 32-bit limbs) through the wrapper (one
    launch, counted, at width 24) and through its C entry point at S = 1,
    3, 7, 16 and K, each bit-equal to walk_plain, over the flag patterns
    of test_torch_walk_split; a doubling planted in lane 0."""
    from test_torch_walk_split import _patterns

    from zokrates_tpu_torch.kernels import cuda

    K, L = 24, 160
    affine, jac, q = _rows_bw6(group, seed=110 + (group == "G2"))
    rng = np.random.default_rng(111)
    flags = ((rng.random((K, L)) < 0.15).astype(np.int32) | ((rng.random((K, L)) < 0.1).astype(np.int32) << 1))
    cols = list(_patterns(K, rng).values())
    flags[:, 1 : 1 + len(cols)] = np.stack(cols, 1)
    src = affine if mode == "mixed" else jac
    idx = rng.integers(0, src.shape[0], (K, L))
    flags[:2, 0] = 0
    idx[:2, 0] = 0
    qrows = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous().to(dev)
    fl = torch.as_tensor(flags).to(dev)
    ref_out, ref_coll = ms.walk_plain(qrows, fl, q, mode, safe)
    assert bool(ref_coll[0]) == (mode == "mixed" and not safe)
    before = ms.WIDTH_LAUNCHES[("walk_" + mode, 24)]
    out, coll = ms.walk(qrows, fl, q, mode, safe)
    torch.cuda.synchronize()
    assert ms.WIDTH_LAUNCHES[("walk_" + mode, 24)] == before + 1
    assert torch.equal(out, ref_out) and torch.equal(coll, ref_coll)
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, None)
    assert nl == 24
    stream = torch.cuda.current_stream(dev).cuda_stream
    for S in (1, 3, 7, 16, K):
        out = torch.full_like(ref_out, -1)
        coll = torch.zeros(L, dtype=torch.int32, device=dev)
        rc = lib.zkt_msm_wide_walk(qrows.data_ptr(), fl.data_ptr(), out.data_ptr(), coll.data_ptr(), K, L, S,
                                   nl, 0, int(mode == "mixed"), int(safe), pl, one, n0, babs, stream)
        cuda.check(rc, "walk")
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out), f"S={S}"
        assert torch.equal(coll, ref_coll), f"S={S}"


@pytest.mark.parametrize("Lb", [1, 3, 32])
def test_suffix_kernel_24_limbs_at_every_split(dev, Lb):
    """The suffix walk at BW6-761's Fq on 203 lanes through the wrapper and
    through its C entry point at every k that divides Lb, each bit-equal to
    suffix_plain at that k; lanes 0-2 planted: the same point in both
    slots, all at infinity, A = -B."""
    from zokrates_tpu_torch.kernels import cuda

    _, jac, q = _rows_bw6("G1", seed=112)
    inf, n = jac.shape[0] - 1, 6
    rng = np.random.default_rng(113 + Lb)
    M = 203
    ia = rng.integers(0, jac.shape[0], (Lb, M))
    ib = rng.integers(0, jac.shape[0], (Lb, M))
    ia[:, 0] = ib[:, 0] = 2
    ia[:, 1] = ib[:, 1] = inf
    ia[:, 2] %= n
    ib[:, 2] = ia[:, 2] + n
    a = jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous().to(dev)
    b = jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous().to(dev)
    want = {k: ms.suffix_plain(a, b, q, None, k) for k in (1, 2, 4, 8, 16, 32) if Lb % k == 0}
    before = ms.WIDTH_LAUNCHES[("suffix", 24)]
    out = ms.suffix(a, b, q)
    torch.cuda.synchronize()
    assert ms.WIDTH_LAUNCHES[("suffix", 24)] == before + 1
    assert torch.equal(out, want[ms.suffix_split(Lb, M)])
    lib = cuda.load()
    nl, pl, one, n0, babs = cuda.field_params(q, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, ref in want.items():
        got = torch.full_like(out, -1)
        rc = lib.zkt_msm_wide_suffix(a.data_ptr(), b.data_ptr(), got.data_ptr(), Lb, M, k, nl, 0, pl, one, n0,
                                     babs, stream)
        cuda.check(rc, "suffix")
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"k={k}"


@pytest.mark.parametrize("lw,W,L", [(1, 3, 5), (8, 3, 5), (128, 2, 1), (1024, 1, 32)])
def test_suffix_fold_kernel_24_limbs_equals_plain(dev, lw, W, L):
    """The epilogue at BW6-761's Fq, up to the shared-bucket h MSM's one
    window of 1024 lanes (the fold tree's 512 lane sums: 144 KB of shared
    memory), about a fifth of acc and tot at infinity."""
    _, jac, q = _rows_bw6("G2", seed=114)
    rng = np.random.default_rng(115 + lw)
    inf = jac.shape[0] - 1
    idx = rng.integers(0, jac.shape[0], (2, W * lw))
    idx[rng.random((2, W * lw)) < 0.2] = inf
    out6 = torch.cat([jac[torch.as_tensor(idx[0])], jac[torch.as_tensor(idx[1])]], 1).T.contiguous().to(dev)
    before = ms.LAUNCHES["suffix_fold"]
    got = ms.suffix_fold(out6, q, W, lw, L)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["suffix_fold"] == before + 1
    for g, w in zip(got, ms.suffix_fold_plain(out6, q, W, lw, L)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("z", ["random", "near_q"])
def test_mixed_add_lm_24_limbs_equals_plain(dev, z):
    """mixed_add_lm at 24 limbs (BW6-761's Fq, a contribution's ladder):
    P == Q (the doubling), P == -Q (the cancellation) and P at infinity,
    Z random or within 2^8 of q on every other row, N = 768 (three blocks
    of 256), against the plain version."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    affine, jac, q = _rows_bw6("G1", seed=120)
    nl = 48
    nrng = np.random.default_rng(121)
    n, N = affine.shape[0], 768
    qi = nrng.integers(0, n, N)
    pi = nrng.integers(0, jac.shape[0] - 1, N)
    if z == "near_q":
        pi = pi - pi % 2                       # the rows with Z within 2^8 of q
    pi[0::4] = qi[0::4]                        # P == Q
    pi[1::4] = (qi[1::4] + n // 2) % n         # P == -Q
    pi[2::8] = jac.shape[0] - 1                # P at infinity

    def rows(t, lo):
        return t[:, lo : lo + nl].T.contiguous().to(dev)

    args = [rows(jac[pi], 0), rows(jac[pi], nl), rows(jac[pi], 2 * nl), rows(affine[qi], 0), rows(affine[qi], nl)]
    before = pf.WIDTH_LAUNCHES[("mixed_add_lm", 24)]
    got = pf.mixed_add_lm(q, *args)
    torch.cuda.synchronize()
    assert pf.WIDTH_LAUNCHES[("mixed_add_lm", 24)] == before + 1
    want = pf.mixed_add_lm_plain(q, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    zero = (got[2] == 0).all(0).cpu()
    assert zero[1::4].all() and not zero[0::4].any()  # cancellations, doublings
    one = torch.as_tensor(field_ops(q).encode([1])[0], dtype=torch.int32)
    assert (got[2][:, 2::8].cpu() == one[:, None]).all()  # P at infinity: Z = one


@pytest.mark.parametrize("B,L,top", [(2, 777, 1 << 31), (3, 1, 1 << 31), (2, 777, 1 << 47), (1, 128, 1 << 31),
                                     (1, 129, 1 << 31), (4, 98304, 1 << 31)])
def test_ereduce_wide_kernel_12_limbs_equals_plain(dev, B, L, top):
    """ereduce_wide over BW6-761's r (24 16-bit limbs): ragged L, one tile
    and one thread an element (128), two tiles (129), the h stage's row
    sums of 3 x 2^15 at B = 4, sums up to 2^31 and 2^47."""
    from zokrates_tpu_torch.kernels import pallas_field as pf

    rng = np.random.default_rng(116)
    t = torch.as_tensor(rng.integers(top - (1 << 20), top, (B, L, 24), dtype=np.int64))
    t[0, :5] = top - 1
    t[-1, -1] = 0
    t = t.to(dev)
    before = pf.LAUNCHES["ereduce_wide"]
    out = pf.ereduce_wide(R_BW6, t)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["ereduce_wide"] == before + 1
    assert torch.equal(out, pf.ereduce_wide_plain(R_BW6, t))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("size,lanes", [("toy", 1024), ("toy", 2048), ("large", 4096), ("large", 32768)])
def test_mulacc_walk_kernel_12_limbs_equals_plain(dev, B, size, lanes):
    """The matvec walk over BW6-761's r: the toy's 3000 records and a
    plan of 600,000 records over 3 x 2^15 rows and 40,000 variables (runs
    that end at row changes and lane ends, lanes of padding at 32768); B =
    1 and 4 (four proofs a block)."""
    from zokrates_tpu_torch.ir.r1cs_device import build_mulacc_walk
    from zokrates_tpu_torch.kernels import pallas_field as pf

    n, m, L = (64, 40, 3000) if size == "toy" else (1 << 15, 40000, 600000)
    w = build_mulacc_walk(_walk_dev(dev, n, m, L, 130 + lanes, R_BW6), lanes)
    z = _elems((B, m), 131, R_BW6).to(dev)
    before = pf.LAUNCHES["mulacc_walk"]
    out = pf.mulacc_walk(R_BW6, z, w)
    torch.cuda.synchronize()
    assert pf.LAUNCHES["mulacc_walk"] == before + 2
    assert torch.equal(out, pf.mulacc_walk_plain(R_BW6, z, w))
    assert not out[:, w.n_flush:].any()


@pytest.mark.parametrize("logn,batch", [(1, 1), (2, 3), (5, 2), (10, 1), (11, 3), (15, 3), (17, 1), (17, 4)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_kernel_12_limbs_equals_plain(dev, logn, batch, inverse):
    """The NTT pass kernel over BW6-761's r (12 32-bit limbs): blocks of
    many tiles and padding past the batch, one pass, two passes (2^11 to
    2^17, the recursion circuit's domain at B = 1 and 4)."""
    from zokrates_tpu_torch.kernels import ntt_pallas as nk
    from zokrates_tpu_torch.kernels.ntt import domain_for_curve

    dom = domain_for_curve(BW6, 1 << logn)
    x = _elems((batch, 1 << logn), 117 + logn, R_BW6).to(dev)
    before = nk.LAUNCHES["ntt"]
    out = nk.fft_core(dom, x, inverse)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["ntt"] == before + len(nk.pass_plan(logn, batch))
    assert torch.equal(out, nk.fft_core_plain(dom, x, inverse))


def test_wrappers_refuse_unbuilt_widths(dev):
    """A CUDA tensor at a width no kernel is built for raises before any
    launch: 16 32-bit limbs (a 512-bit field) in the walk, the suffix, the
    epilogue, ereduce_wide, emul and the NTT's field check; 24 limbs
    (BW6-761's Fq, where emul and mixed_add_lm run) in ereduce_wide,
    accumulate_lm and the field check of the NTT and mulacc_walk
    (cuda.NL32_FIELD); 24 limbs over Fq2 (no curve has one) at the wide
    walk's C entry point, and 24 limbs at the 8- and 12-limb one
    (msm_sorted.cu's)."""
    from zokrates_tpu_torch.kernels import cuda
    from zokrates_tpu_torch.kernels import pallas_field as pf

    before = (dict(ms.LAUNCHES), dict(pf.LAUNCHES))
    z32 = torch.zeros((1, 96, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="got nl=32"):
        ms.suffix(z32, z32, P512)
    with pytest.raises(ValueError, match="got nl=32"):
        ms.suffix_fold(torch.zeros((192, 4), dtype=torch.int32, device=dev), P512, 1, 4, 1)
    t = torch.zeros((1, 3, 32), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="got nl=32"):
        pf.ereduce_wide(P512, t)
    with pytest.raises(ValueError, match="got nl=32"):
        pf.emul(P512, t, t)
    qbw6 = g1_group(BW6).q
    with pytest.raises(ValueError, match="16 or 24 16-bit limbs, got nl=48"):
        cuda.field_params(qbw6, None, cuda.NL32_FIELD)
    with pytest.raises(ValueError, match="16 or 24 16-bit limbs, got nl=48"):
        pf.ereduce_wide(qbw6, torch.zeros((1, 3, 48), dtype=torch.int64, device=dev))
    rows = torch.zeros((2 * 48, 256), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16 or 24 16-bit limbs, got nl=48"):
        pf.accumulate_lm(qbw6, torch.zeros((2, 256), dtype=torch.int32, device=dev), rows, rows)
    assert (dict(ms.LAUNCHES), dict(pf.LAUNCHES)) == before
    lib = cuda.load()
    q = g1_group(BW6).q
    nl, pl, one, n0, _ = cuda.field_params(q, None)
    buf = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for fn, ext in ((lib.zkt_msm_wide_walk, 1), (lib.zkt_msm_walk, 0)):
        rc = fn(p, p, p, p, 1, 1, 1, nl, ext, 1, 1, pl, one, n0, 1, stream)
        with pytest.raises(RuntimeError, match="walk launch failed"):
            cuda.check(rc, "walk")
    torch.cuda.synchronize()



# -- the levelized witness generator (interp/vectorized) on the card ---------

def _artifact(name):
    import gzip
    import os

    from zokrates_tpu_torch.ir.serialize import deserialize

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if name.endswith(".gz"):
        with gzip.open(os.path.join(root, "port_artifacts", name), "rb") as f:
            return deserialize(f.read())
    with open(os.path.join(root, "bench_artifacts", name), "rb") as f:
        return deserialize(f.read())


# program -> input vectors: solvers_bn128 (ConditionEq, Or, EuclideanDiv,
# Bits: main(field a, bool b, u32 x, u32 y)), Pedersen-512 (Div chains,
# 855 levels), the bench's sha256 (Xor, ShaCh, ShaAndXorAndXorAnd, Bits)
WITNESS_CASES = {
    "solvers_bn128.out.gz": [[5, 0, 1000003, 97], [42, 1, 0xFFFFFFFF, 1], [0, 0, 12, 5]],
    "pedersen512_bn128.out.gz": [list(range(16)), [0xFFFFFFFF - i for i in range(16)]],
    "sha256.out": [list(range(16)), [16 + i for i in range(16)]],
}


@pytest.mark.parametrize("name", sorted(WITNESS_CASES))
def test_vectorized_witness_on_card(dev, name):
    """The card's witness equals the scalar interpreter's (and, where the
    plain versions are quick, the CPU generator's); the first call runs
    every segment eagerly and captures it, the next calls replay the
    graphs with no new capture (the same inputs again: the replay equals
    the eager run; other inputs: their own witness); emul and ereduce_wide
    launch on every call, the replays' counts added."""
    from zokrates_tpu_torch.interp import vectorized as vz
    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.kernels import pallas_field as pf

    prog = _artifact(name)
    cases = WITNESS_CASES[name]
    vi = vz.VectorizedInterpreter(device=dev)
    want = [Interpreter().execute(prog, inp).values for inp in cases]
    first = vi.execute(prog, cases[0]).values
    assert first == want[0]
    dp = vi.plan(prog)._exec[dev]
    captured = dict(dp.graphs)
    steps = len(captured)
    assert steps == len(vi.plan(prog).segments) + (vi.plan(prog).checks is not None)
    for inp, w in [(cases[0], first)] + list(zip(cases[1:], want[1:])):
        before, replays = dict(pf.LAUNCHES), sum(vz.REPLAYS.values())
        assert vi.execute(prog, inp).values == w
        assert dp.graphs == captured
        assert sum(vz.REPLAYS.values()) - replays == steps
        for k in ("emul", "ereduce_wide"):
            assert pf.LAUNCHES[k] > before.get(k, 0), k
    if name != "pedersen512_bn128.out.gz":  # 855 levels of Fermat chains: minutes in the plain versions
        assert vz.VectorizedInterpreter(device="cpu").execute(prog, cases[-1]).values == want[-1]


def test_vectorized_errors_on_card(dev):
    """A failed assert (a = 7) and a division by zero raise the scalar
    interpreter's UnsatisfiedConstraint on the card, eagerly and on replay;
    a wrong input count raises WrongInputCount."""
    from zokrates_tpu_torch.interp import vectorized as vz
    from zokrates_tpu_torch.interp.interpreter import Interpreter, UnsatisfiedConstraint, WrongInputCount

    prog = _artifact("solvers_bn128.out.gz")
    vi = vz.VectorizedInterpreter(device=dev)
    for bad in ([7, 0, 1, 1], [0, 0, 12, 0]):
        with pytest.raises(UnsatisfiedConstraint) as want:
            Interpreter().execute(prog, bad)
        for _ in range(2):
            with pytest.raises(UnsatisfiedConstraint) as got:
                vi.execute(prog, bad)
            assert str(got.value) == str(want.value)
    with pytest.raises(WrongInputCount):
        vi.execute(prog, [1, 2])


CLI_TOY = ("def main(private field x, field y) -> field {\n    field mut acc = x;\n"
           "    for u32 i in 0..20 {\n        acc = acc * acc + y;\n    }\n    return acc;\n}\n")


def test_cli_toy_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """compile, compute-witness, setup, generate-proof and verify through
    cli.main on each device, setup and prove under the same draws: the
    same verification key and proof byte for byte, the same proving key
    but for the card's shared-bucket h query (h16_p128, built on a CUDA
    device only); each device's proving key proves on the other device
    (pickles hold host values), to the same proof."""
    import itertools
    import secrets

    from zokrates_tpu_torch import cli

    src = tmp_path / "toy.zok"
    src.write_text(CLI_TOY)

    def run(device, *args, draws=False):
        if draws:
            c = itertools.count(1)
            monkeypatch.setattr(secrets, "randbelow", lambda n: (next(c) * 0x9E3779B97F4A7C15 + 12345) % n)
        cli.main(["--device", device] + [str(a) for a in args])

    for device in ("cuda", "cpu"):
        d = tmp_path / device
        d.mkdir()
        run(device, "compile", "-i", src, "-o", d / "out", "-s", d / "abi.json")
        run(device, "compute-witness", "-i", d / "out", "-o", d / "witness", "-a", "3 7")
        run(device, "setup", "-i", d / "out", "-p", d / "pk", "-v", d / "vk", draws=True)
        run(device, "generate-proof", "-i", d / "out", "-w", d / "witness", "-p", d / "pk", "-j", d / "proof",
            draws=True)
        run(device, "verify", "-v", d / "vk", "-j", d / "proof")
    for name in ("out", "witness", "vk", "proof"):
        assert (tmp_path / "cuda" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes(), name
    for device, other in (("cuda", "cpu"), ("cpu", "cuda")):
        d = tmp_path / device
        run(device, "generate-proof", "-i", d / "out", "-w", d / "witness", "-p", tmp_path / other / "pk",
            "-j", d / "cross", draws=True)
        assert (d / "cross").read_bytes() == (d / "proof").read_bytes(), device
    keys = []
    for device in ("cuda", "cpu"):
        with open(tmp_path / device / "pk", "rb") as f:
            keys.append(vars(cli.load_pickle(f)))
    assert keys[0].keys() == keys[1].keys()
    assert keys[0]["h16_p128"] is not None and keys[1]["h16_p128"] is None
    for k, v in keys[0].items():
        if k == "h16_p128":
            continue
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, keys[1][k], err_msg=k)
        else:
            assert v == keys[1][k], k


def test_cli_generator_from_second_call(dev):
    """pick_interpreter on the card with one generator, as cli.main keeps
    it: 4096 independent squares take the scalar interpreter on the first
    call and the card's generator from the second, with the same witness;
    a forced first call takes the generator at once."""
    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.interp.vectorized import VectorizedInterpreter, pick_interpreter
    from zokrates_tpu_torch.ir.program import Constraint, LinComb, Parameter, Prog, QuadComb

    stmts = [Constraint(QuadComb(LinComb.from_var(1), LinComb.from_var(1)), LinComb.from_var(2 + i))
             for i in range(4096)]
    prog = Prog("bn128", [Parameter(1, True)], 1, stmts)
    gen = VectorizedInterpreter(dev)
    first, why = pick_interpreter(prog, dev, None, gen)
    assert isinstance(first, Interpreter) and "first call" in why, why
    want = first.execute(prog, [12345])
    for _ in range(2):
        interp, why = pick_interpreter(prog, dev, None, gen)
        assert interp is gen and why.startswith("vectorized on cuda"), why
        assert interp.execute(prog, [12345]).values == want.values
    other = Prog("bn128", [Parameter(1, True)], 1, list(stmts))
    assert pick_interpreter(other, dev, True, gen)[0] is gen
