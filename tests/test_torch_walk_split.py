"""The walk kernel's split of a lane into sub-chunks (csrc/msm_sorted.cu
walk_kernel), replayed on the CPU: msm_sorted.walk_owners gives each
thread's range of positions for given flags and sub-chunk length S, and
msm_sorted.walk_split picks S for a launch shape.

Checks: the ranges cover every position of every lane exactly once, and
walking each range with walk_plain from the zero triple gives, limb for
limb, the snapshots of one walk_plain over the whole lane at the same
positions, with the OR of the ranges' collision flags equal to the lane's.
Cases: Fq mixed (safe and unsafe), Fq general (complete add, with points at
infinity, which the rule treats as skips) and Fq2 mixed-safe. Flag
patterns, one per group of lanes: no flush, a flush at every position,
skips right after a flush, all-skip lanes (with and without flushes),
leading skips, skips that carry the flush, and seeded random flags; S
values that divide K, that do not, S = 1 and S >= K. The unsafe walk gets
a collision (P == Q) inside a lane's second segment, which must set coll
for that lane only. Tolerance: bit equality.
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

Q = g1_group("bn128").q
S_VALUES = (1, 3, 7, 24)  # at K = 16: S = 1, S not dividing K, S >= K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(ext, seed, n=6):
    """(affine rows (n, 2*en), Jacobian rows (2n+1, 3*en) with random Z:
    the points, their negatives and infinity last), int32."""
    rng = random.Random(seed)
    grp = g2_group("bn128") if ext else g1_group("bn128")
    f = field_ops2(Q, -1) if ext else field_ops(Q)
    co = (lambda v: (v.c0, v.c1)) if ext else (lambda v: v)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]

    def enc(vals):
        return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    X, Y, Z = [], [], []
    for p in pts + [-p for p in pts]:
        z = Fq2(grp.tower, rng.randrange(1, Q), rng.randrange(Q)) if ext else rng.randrange(1, Q)
        X.append(co(p.x * z * z) if ext else p.x * z * z % Q)
        Y.append(co(p.y * z * z * z) if ext else p.y * z ** 3 % Q)
        Z.append(co(z) if ext else z)
    X.append(co(pts[0].x))
    Y.append(co(pts[1].y))
    Z.append((0, 0) if ext else 0)
    affine = torch.cat([enc([co(p.x) for p in pts]), enc([co(p.y) for p in pts])], 1)
    return affine, torch.cat([enc(X), enc(Y), enc(Z)], 1)


def _patterns(K, rng):
    """Named (K,) flag columns (K >= 10): bit0 flush after the position,
    bit1 skip."""
    F, SK = 1, 2
    pats = {"no flush": np.zeros(K, np.int32), "flush everywhere": np.full(K, F, np.int32)}
    p = np.zeros(K, np.int32)
    for k in range(2, K - 1, 5):  # flush at 2, skips at 3 and 4; segment [5, 8) ...
        p[k] = F
        p[k + 1 : k + 3] = SK
    pats["skips after a flush"] = p
    pats["all skip"] = np.full(K, SK, np.int32)
    p = np.full(K, SK, np.int32)
    p[[3, K - 4]] |= F
    pats["all skip, flushes"] = p
    p = np.zeros(K, np.int32)
    p[: K // 3] = SK
    p[K // 3 + 2 :: 3] = F
    pats["leading skips"] = p
    p = np.zeros(K, np.int32)
    p[[3, 4, K - 3, K - 2]] = SK
    p[[4, K - 2]] |= F
    pats["skips carry the flush"] = p
    pats["random"] = ((rng.random(K) < 0.25).astype(np.int32)
                      | ((rng.random(K) < 0.15).astype(np.int32) << 1))
    return pats


def _inputs(ext, mode, K, seed):
    """q (K, width, L), flags (K, L), qinf (K, L): every pattern on 3 lanes
    with their own points; general mode puts points at infinity at about
    10% of positions, some right after a flush."""
    affine, jac = _pool(ext, seed)
    rng = np.random.default_rng(seed)
    cols = [c for c in _patterns(K, rng).values() for _ in range(3)]
    flags = np.stack(cols, 1)
    L = flags.shape[1]
    src = affine if mode == "mixed" else jac
    idx = rng.integers(0, affine.shape[0] if mode == "mixed" else jac.shape[0] - 1, (K, L))
    if mode == "mixed":  # no point twice in a row among non-skipped positions
        last = np.full(L, -1)
        for k in range(K):
            rep = idx[k] == last
            idx[k, rep] = (idx[k, rep] + 1) % affine.shape[0]
            last = np.where(flags[k] & 2, last, idx[k])
    if mode == "general":
        idx[rng.random((K, L)) < 0.1] = jac.shape[0] - 1
        idx[5, :] = jac.shape[0] - 1  # first after the flush and skips of "skips after a flush"
    q = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    qinf = idx == jac.shape[0] - 1 if mode == "general" else np.zeros((K, L), bool)
    return q, torch.as_tensor(flags), qinf


def _check_split(q, flags, qinf, mode, safe, beta, s_values=S_VALUES):
    K, _, L = q.shape
    full, coll = ms.walk_plain(q, flags, Q, mode, safe, beta)
    for S in s_values:
        rng_ = ms.walk_owners(flags.numpy(), S, qinf if mode == "general" else None)
        assert rng_.shape == (-(-K // S), L, 2)
        cover = np.zeros((K, L), np.int64)
        for t in range(rng_.shape[0]):
            for lane in range(L):
                a, b = rng_[t, lane]
                assert a <= b
                cover[a:b, lane] += 1
        assert (cover == 1).all(), f"S={S}: positions not covered exactly once"
        # every non-empty range as a lane of its own, padded with skips
        runs = [(t, lane, a, b) for t in range(rng_.shape[0]) for lane in range(L)
                for a, b in [rng_[t, lane]] if b > a]
        n = max(b - a for _, _, a, b in runs)
        sq = torch.empty((n, q.shape[1], len(runs)), dtype=q.dtype)
        sf = torch.full((n, len(runs)), 2, dtype=flags.dtype)
        for j, (_, lane, a, b) in enumerate(runs):
            sq[:, :, j] = q[a, :, lane][None, :]
            sq[: b - a, :, j] = q[a:b, :, lane]
            sf[: b - a, j] = flags[a:b, lane]
        out, scoll = ms.walk_plain(sq, sf, Q, mode, safe, beta)
        got_coll = torch.zeros(L, dtype=torch.int32)
        for j, (_, lane, a, b) in enumerate(runs):
            assert torch.equal(out[: b - a, :, j], full[a:b, :, lane]), f"S={S}, lane {lane}, [{a}, {b})"
            got_coll[lane] |= scoll[j]
        assert torch.equal(got_coll, coll), f"S={S}: collision flags differ"
    return coll


@pytest.mark.parametrize("mode,safe", [("mixed", True), ("mixed", False), ("general", True)],
                         ids=["mixed-safe", "mixed-unsafe", "general"])
def test_split_walk_equals_plain_fq(mode, safe):
    K = 16
    q, flags, qinf = _inputs(False, mode, K, seed=31)
    if not safe:
        # lane 6 ("skips after a flush") has segments [0, 3), [5, 8), ...:
        # position 6 repeats position 5, a doubling in its second segment
        q[6, :, 6] = q[5, :, 6]
    coll = _check_split(q, flags, qinf, mode, safe, None)
    if not safe:
        assert coll.tolist() == [int(i == 6) for i in range(q.shape[2])]


def test_split_walk_equals_plain_fq2():
    K = 10
    q, flags, qinf = _inputs(True, "mixed", K, seed=32)
    _check_split(q, flags, qinf, "mixed", True, -1, s_values=(1, 4, 10))


def test_walk_split_rule():
    """S = K where the lanes alone give FILL_THREADS threads, else the
    smallest S that cuts a lane into at most ceil(FILL_THREADS / L)
    sub-chunks; the grid's sub-chunk count stays <= 65535."""
    fill = ms.FILL_THREADS
    assert ms.walk_split(32, 32768) == 32
    assert ms.walk_split(512, 1024) == 32  # the h16 walk: 16 sub-chunks
    assert ms.walk_split(16, 1024) == 1
    assert ms.walk_split(12, 4096) == 3
    assert ms.walk_split(0, 10) == 1 and ms.walk_split(1, 10) == 1
    for K, L in [(512, 1024), (16, 1024), (12, 128), (36, 1024), (7, 3), (100000, 1), (396, 1024)]:
        S = ms.walk_split(K, L)
        T = -(-K // S)
        nsub = min(-(-fill // L), 65535)
        assert 1 <= S <= K and T <= nsub
        assert S == 1 or -(-K // (S - 1)) > nsub
