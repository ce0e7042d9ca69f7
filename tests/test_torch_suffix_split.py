"""The split suffix walk of the port's sorted MSM
(zokrates_tpu_torch.kernels.msm_sorted: suffix_split, suffix_plain) on the
CPU, where the suffix wrapper runs its plain version.

The CUDA kernel cuts each lane's Lb buckets into k sub-chunks, walks each
from the zero triple and combines the sub-chunk sums by a scan
(csrc/msm_sorted.cu, suffix_split_kernel); suffix_plain replays that
association add for add. Here:

  * the rule suffix_split(Lb, M): k a power of two that divides Lb, at most
    SUFFIX_BLOCK, with M*k within FILL_THREADS, the largest such;
    k = 1 at Lb = 1;
  * suffix_plain at every k the rule admits for the shape against the JAX
    package's Python-int point oracle (zokrates_tpu.ec), as group elements,
    for BN254 G1 and G2 and for BLS12-381 G1, with lanes planted at
    infinity, with A = B (doublings in every add of the walk and the scan)
    and with A = -B (cancellations);
  * at k = 1, suffix_plain equal limb for limb to the sequential loop of
    one thread a lane, kept in this file as the pin;
  * one small sorted MSM through msm_sorted_host whose suffix runs split
    (k = 16 sub-chunks of one bucket), against the oracle's sum as affine
    points.

Inputs from seeded random / numpy generators. Tolerance: exact equality
(points, limbs).
"""

import random

import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import g1_group, g2_group
from zokrates_tpu.ec.tower import Fq2
from zokrates_tpu_torch.fields.jfield import field_ops, field_spec
from zokrates_tpu_torch.fields.jfield2 import field_ops2
from zokrates_tpu_torch.fields.limbs import ints_to_limbs
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.kernels.pallas_field import _general_add, field_for


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pool:
    """n random points of one group, their negatives and infinity (last),
    as host points and as Jacobian limb rows with random Z."""

    def __init__(self, curve, ext, seed, n=4):
        rng = random.Random(seed)
        grp = g2_group(curve) if ext else g1_group(curve)
        q = grp.q
        self.grp, self.ext, self.q = grp, ext, q
        self.beta = grp.tower.beta - q if ext else None
        self.f = field_ops2(q, self.beta) if ext else field_ops(q)
        pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
        self.pts = pts + [-p for p in pts] + [grp.zero()]
        X, Y, Z = [], [], []
        for p in self.pts[:-1]:
            z = Fq2(grp.tower, rng.randrange(1, q), rng.randrange(q)) if ext else rng.randrange(1, q)
            X.append(p.x * z * z if ext else p.x * z * z % q)
            Y.append(p.y * z * z * z if ext else p.y * z ** 3 % q)
            Z.append(z)
        X.append(pts[0].x)
        Y.append(pts[1].y)
        Z.append(Fq2(grp.tower, 0, 0) if ext else 0)
        self.jac = torch.cat([self.rows(X), self.rows(Y), self.rows(Z)], 1)
        self.inf = len(self.pts) - 1
        self.neg = n  # self.pts[i + n] = -self.pts[i]

    def rows(self, vals):
        vals = [(v.c0, v.c1) for v in vals] if self.ext else vals
        return self.f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    def point(self, col):
        """One lane's Jacobian column (3*en,) of Montgomery limbs -> host point."""
        nl = field_spec(self.q).nl
        rinv = pow(field_spec(self.q).r, -1, self.q)
        vals = [int(v) for v in col]
        ints = [sum(v << (16 * i) for i, v in enumerate(vals[h:h + nl])) * rinv % self.q
                for h in range(0, len(vals), nl)]
        if self.ext:
            X, Y, Z = (Fq2(self.grp.tower, *ints[2 * i:2 * i + 2]) for i in range(3))
            if Z == Fq2(self.grp.tower, 0, 0):
                return self.grp.zero()
            zi = Z.inv()
            x, y = X * zi * zi, Y * zi * zi * zi
            return self.grp.point((x.c0, x.c1), (y.c0, y.c1))
        X, Y, Z = ints
        if Z == 0:
            return self.grp.zero()
        zi = pow(Z, -1, self.q)
        return self.grp.point(X * zi * zi % self.q, Y * zi ** 3 % self.q)


def _table(pool, Lb, M, seed):
    """Slot indices (Lb, M) into the pool and the (Lb, 3*en, M) rows:
    random, except lane 0 (the same point in both slots everywhere: every
    add of the walk and of the scan at c = 1 doubles), lane 1 (all at
    infinity), lane 2 (A = -B: each T cancels) and lane 3 (slot a at
    infinity)."""
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, len(pool.pts), (Lb, M))
    ib = rng.integers(0, len(pool.pts), (Lb, M))
    ia[:, 0] = ib[:, 0] = 2
    ia[:, 1] = ib[:, 1] = pool.inf
    ib[:, 2] = (ia[:, 2] % pool.neg + pool.neg) % (2 * pool.neg)
    ia[:, 2] %= pool.neg
    ia[:, 3] = pool.inf

    def rows(idx):
        return pool.jac[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()

    return ia, ib, rows(ia), rows(ib)


def _oracle(pool, ia, ib, lane):
    acc = tot = pool.grp.zero()
    for t in range(ia.shape[0]):
        acc = acc + pool.pts[ia[t, lane]] + pool.pts[ib[t, lane]]
        tot = tot + acc
    return acc, tot


def _sequential(a, b, p, beta):
    """The suffix walk of one thread a lane, position after position: the
    plain version before the kernel split each lane (the pin for k = 1)."""
    F = field_for(p, beta)
    nl = field_spec(p).nl
    en = ms._rows_per_coord(p, beta)
    Lb, _, M = a.shape
    zero = F.zeros((M,), a.device)
    acc = (zero, zero, zero)
    tot = acc
    for t in range(Lb):
        A = tuple(ms._coords(a[t], en, nl, beta))
        B = tuple(ms._coords(b[t], en, nl, beta))
        acc = _general_add(F, acc, _general_add(F, A, B))
        tot = _general_add(F, tot, acc)
    return ms._rows(acc + tot, M).contiguous()


@pytest.mark.parametrize("Lb,M,k", [(1, 384, 1), (1, 4096, 1), (32, 1024, 16), (32, 2048, 8), (32, 1 << 14, 1),
                                    (3, 8, 1), (4, 12, 4), (12, 5, 4), (16, 256, 16), (256, 2048, 8),
                                    (1024, 8, 128), (0, 8, 1)])
def test_suffix_split_rule(Lb, M, k):
    """The largest power of two dividing Lb within the block and the fill
    target; the h16 shape (32, 1024) takes 16, every Lb = 1 shape 1."""
    got = ms.suffix_split(Lb, M)
    assert got == k
    assert got & (got - 1) == 0 and got <= ms.SUFFIX_BLOCK
    if Lb:
        assert Lb % got == 0
    assert got == 1 or got * M <= ms.FILL_THREADS
    bigger = 2 * got
    assert not (Lb >= 2 and Lb % bigger == 0 and bigger <= ms.SUFFIX_BLOCK and bigger * M <= ms.FILL_THREADS)


@pytest.mark.parametrize("curve,ext,Lb,M", [("bn128", False, 8, 7), ("bn128", True, 4, 5), ("bls12_381", False, 6, 5)],
                         ids=["bn128-G1", "bn128-G2", "bls12_381-G1"])
def test_suffix_plain_at_every_split_matches_oracle(curve, ext, Lb, M):
    """[acc | tot] at every k that divides Lb (powers of two), each lane
    against the oracle; suffix() takes k = suffix_split(Lb, M) and equals
    suffix_plain at that k, limb for limb."""
    pool = Pool(curve, ext, seed=40 + ext)
    ia, ib, A, B = _table(pool, Lb, M, seed=41 + Lb)
    want = [_oracle(pool, ia, ib, m) for m in range(M)]
    en = A.shape[1] // 3
    ks = [k for k in (1, 2, 4, 8) if Lb % k == 0]
    assert ms.suffix_split(Lb, M) == ks[-1]
    outs = {}
    for k in ks:
        out = ms.suffix_plain(A, B, pool.q, pool.beta, k)
        assert out.shape == (6 * en, M) and out.dtype == torch.int32
        for m in range(M):
            got = (pool.point(out[:3 * en, m]), pool.point(out[3 * en:, m]))
            assert got == want[m], (k, m)
        outs[k] = out
    assert torch.equal(ms.suffix(A, B, pool.q, pool.beta), outs[ks[-1]])
    with pytest.raises(ValueError):
        ms.suffix_plain(A, B, pool.q, pool.beta, 3)


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
def test_suffix_plain_k1_equals_sequential_loop(ext):
    """At k = 1 the plain version is the one-thread-a-lane loop, limb for
    limb, and so is suffix() where suffix_split gives 1 (Lb = 3); over G1
    also at Lb = 4, where suffix() would split."""
    pool = Pool("bn128", ext, seed=50 + ext)
    for Lb, M in ((3, 6),) if ext else ((3, 6), (4, 6)):
        _, _, A, B = _table(pool, Lb, M, seed=51 + Lb)
        want = _sequential(A, B, pool.q, pool.beta)
        assert torch.equal(ms.suffix_plain(A, B, pool.q, pool.beta, 1), want)
        if Lb == 3:
            assert ms.suffix_split(Lb, M) == 1
            assert torch.equal(ms.suffix(A, B, pool.q, pool.beta), want)


def test_msm_sorted_host_with_split_suffix(monkeypatch):
    """A sorted G1 MSM at N = 256 over 24-bit scalars (c = 8, max_bits 24:
    4 windows; 8 suffix lanes a window of 16 buckets each: suffix_split
    gives k = 16) through msm_sorted_host on the CPU, against the oracle's
    sum_i s_i * P_i as affine points."""
    grp = g1_group("bn128")
    q, r = grp.q, grp.r
    rng = random.Random(60)
    N = 256
    base = [grp.generator() * rng.randrange(1, r) for _ in range(4)]
    ks = [rng.randrange(4) for _ in range(N)]
    sc = [rng.randrange(1 << 24) if i % 3 else rng.randrange(4) for i in range(N)]
    f = field_ops(q)
    pts = [base[k] for k in ks]
    P128 = ms.pack_points(q, f.encode([p.x for p in pts]), f.encode([p.y for p in pts]))
    shapes = []
    real = ms.suffix

    def suffix(a, b, p, beta=None):
        shapes.append((a.shape[0], a.shape[2]))
        return real(a, b, p, beta)

    monkeypatch.setattr(ms, "suffix", suffix)
    X, Y, Z = ms.msm_sorted_host(q, r, P128, torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64)), max_bits=24)
    assert shapes and all(ms.suffix_split(*s) == 16 for s in shapes), shapes
    want = grp.zero()
    for k in range(4):
        want = want + base[k] * (sum(s for kk, s in zip(ks, sc) if kk == k) % r)
    zi = pow(Z, -1, q)
    assert (X * zi * zi % q, Y * zi ** 3 % q) == (want.x, want.y)
