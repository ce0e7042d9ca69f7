"""The port's standalone point kernels (zokrates_tpu_torch.kernels.
pallas_field.mixed_add_lm and accumulate_lm) on the CPU, where the wrappers
run their plain versions, against the JAX package's complete mixed add
(zokrates_tpu.kernels.jec.CurveOps.mixed_add, whose formulas the Pallas
kernels mixed_add_lm and accumulate_lm state they share).

  * mixed_add_lm over (nl, N) limb-major rows: P and Q random, P at
    infinity, P == Q (the doubling), P == -Q (the cancellation);
  * accumulate_lm against a bucket-by-bucket fold of the same JAX mixed
    add: digits 0, digits >= n_buckets (and 0xFFFFFFFF, read unsigned),
    buckets hit several times within the chunk, a repeated point (the
    doubling) and a negated one (the cancellation);
  * both again at 12 32-bit limbs (BLS12-381's Fq, 24 16-bit limbs), the
    mixed add also with every Jacobian Z within 2^8 of q, the
    accumulation at 4 and 16 buckets;
  * the mixed add at 24 32-bit limbs (BW6-761's Fq, 48 16-bit limbs, the
    width of a contribution's ladder on BW6-761), with the same edge cases
    and Z random or within 2^8 of q;
  * the wrappers' checks of dtype, shape, block and device, and that CPU
    calls count no launch.

The Pallas kernels themselves are not run: in interpret mode on a CPU
they take 37 s (mixed_add_lm, N = 8) and 82 s (accumulate_lm, chunk_len 2,
R = 8). The JAX mixed add is jitted once at the one shape (N, nl) both
tests use. Inputs: real BN254 G1 points from a seeded generator, Jacobian
with random Z. Tolerance: exact equality of every limb.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import g1_group
from zokrates_tpu.kernels.jec import curve_ops
from zokrates_tpu_torch.fields.limbs import ints_to_limbs
from zokrates_tpu_torch.kernels import pallas_field as pf

GRP = g1_group("bn128")
Q = GRP.q
NL = 16
N = 16  # points (mixed add) and lanes (accumulation): one compiled JAX add
RMONT = (1 << 256) % Q


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jadd():
    """The JAX complete mixed add on (N, nl) uint32 Montgomery limbs."""
    ops = curve_ops(Q)
    fn = jax.jit(lambda X, Y, Z, qx, qy: ops.mixed_add((X, Y, Z), qx, qy))

    def add(P, qx, qy):
        out = fn(*(jnp.asarray(a.astype(np.uint32)) for a in (*P, qx, qy)))
        return tuple(np.asarray(o).astype(np.int64) for o in out)

    return add


def _mont(xs):
    """Host ints -> (len, nl) int64 Montgomery limbs."""
    return ints_to_limbs([x * RMONT % Q for x in xs], NL).astype(np.int64)


def _lm(a):
    """(N, nl) element-major -> (nl, N) int32 limb-major tensor."""
    return torch.as_tensor(np.ascontiguousarray(a.T).astype(np.int32))


def _pool(seed, n=6):
    rng = random.Random(seed)
    return rng, [GRP.generator() * rng.randrange(1, GRP.r) for _ in range(n)]


def _jac(rng, pt):
    """(X, Y, Z) ints of pt with a random Z; for None, infinity: Z = 0, X and Y random."""
    if pt is None:
        return (rng.randrange(Q), rng.randrange(Q), 0)
    z = rng.randrange(1, Q)
    return (pt.x * z * z % Q, pt.y * z ** 3 % Q, z)


def test_mixed_add_lm_matches_reference(jadd):
    rng, pts = _pool(1)
    P, Qa, cases = [], [], []
    for i in range(N):
        kind = ("general", "infinity", "double", "cancel")[i % 4]
        qpt = pts[i % len(pts)]
        ppt = {"general": pts[(i + 1) % len(pts)], "infinity": None, "double": qpt, "cancel": -qpt}[kind]
        P.append(_jac(rng, ppt))
        Qa.append(qpt)
        cases.append(kind)
    Pm = tuple(_mont([p[c] for p in P]) for c in range(3))
    qx, qy = _mont([q.x for q in Qa]), _mont([q.y for q in Qa])
    want = jadd(Pm, qx, qy)
    before = pf.LAUNCHES["mixed_add_lm"]
    got = pf.mixed_add_lm(GRP.q, *(_lm(a) for a in (*Pm, qx, qy)), block=8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (NL, N)
        np.testing.assert_array_equal(g.numpy().T.astype(np.int64), w)
    z = got[2].numpy().T
    for i, kind in enumerate(cases):  # the edge cases were reached
        assert (z[i] == 0).all() == (kind == "cancel")
        if kind == "infinity":
            assert (z[i] == _mont([1])[0]).all()
    assert pf.LAUNCHES["mixed_add_lm"] == before  # the CPU call ran the plain version


def test_accumulate_lm_matches_bucket_fold(jadd):
    nb, chunk_len = 4, 6
    rng, pts = _pool(2, n=3)
    nrng = np.random.default_rng(3)
    pool = pts + [-p for p in pts]
    digits = nrng.integers(0, nb + 2, (chunk_len, N)).astype(np.int64)
    idx = nrng.integers(0, len(pool), (chunk_len, N))
    digits[:, 0] = [1, 1, 0, 1, nb, 1]          # bucket 1 hit four times
    idx[:, 0] = [0, 0, 1, 3, 2, 1]              # P, then P again (doubles), ...
    digits[:, 1] = [2, 2, 0xFFFFFFFF, 3, 0, 3]  # ..., P then -P (cancels)
    idx[:, 1] = [1, 4, 0, 2, 0, 0]
    qx = np.stack([_mont([pool[j].x for j in row]) for row in idx])  # (chunk_len, N, nl)
    qy = np.stack([_mont([pool[j].y for j in row]) for row in idx])

    one = _mont([1])[0]
    B = [np.broadcast_to(one, (nb, N, NL)).copy(), np.broadcast_to(one, (nb, N, NL)).copy(),
         np.zeros((nb, N, NL), np.int64)]
    lanes = np.arange(N)
    for t in range(chunk_len):
        d = digits[t]
        hit = (d >= 1) & (d < nb)
        b = np.where(hit, d, 0)
        new = jadd(tuple(c[b, lanes] for c in B), qx[t], qy[t])
        for c, v in zip(B, new):
            c[b[hit], lanes[hit]] = v[hit]

    before = pf.LAUNCHES["accumulate_lm"]
    got = pf.accumulate_lm(
        GRP.q, torch.as_tensor(digits.astype(np.uint32).view(np.int32)),
        torch.as_tensor(np.ascontiguousarray(qx.transpose(0, 2, 1)).reshape(chunk_len * NL, N).astype(np.int32)),
        torch.as_tensor(np.ascontiguousarray(qy.transpose(0, 2, 1)).reshape(chunk_len * NL, N).astype(np.int32)),
        n_buckets=nb, block=8,
    )
    for g, w in zip(got, B):
        assert g.dtype == torch.int32 and g.shape == (nb, NL, N)
        np.testing.assert_array_equal(g.numpy().transpose(0, 2, 1).astype(np.int64), w)
    Z = got[2].numpy()
    assert (Z[0] == 0).all()             # bucket 0 is never touched
    assert (Z[2, :, 1] == 0).all()       # lane 1's bucket 2: P + (-P)
    assert not (Z[1, :, 0] == 0).all()   # lane 0's bucket 1: P + P + (-P) + P'
    assert pf.LAUNCHES["accumulate_lm"] == before  # the CPU call ran the plain version


@pytest.mark.parametrize("case", ["dtype", "shape", "block", "device"])
def test_point_kernel_wrappers_check_inputs(case):
    rows = torch.zeros((NL, N), dtype=torch.int32)
    args = [rows] * 5
    kw = {"block": 8}
    if case == "dtype":
        args = [rows.to(torch.int64)] + args[1:]
    elif case == "shape":
        args = args[:4] + [torch.zeros((NL, N // 2), dtype=torch.int32)]
    elif case == "block":
        kw = {"block": 12}
    else:
        args = [rows.to("meta")] + args[1:]
    with pytest.raises((TypeError, ValueError)):
        pf.mixed_add_lm(Q, *args, **kw)
    digits = torch.zeros((2, N), dtype=torch.int32)
    qrows = torch.zeros((2 * NL, N), dtype=torch.int32)
    acc = [digits, qrows, qrows]
    if case == "dtype":
        acc[0] = digits.to(torch.int64)
    elif case == "shape":
        acc[2] = torch.zeros((NL, N), dtype=torch.int32)
    elif case == "device":
        acc[1] = qrows.to("meta")
    with pytest.raises((TypeError, ValueError)):
        pf.accumulate_lm(Q, *acc, n_buckets=4, **kw)


# ---------------------------------------------------------------------------
# 12 limbs: BLS12-381's base field (24 16-bit limbs), the width the phase-2
# ceremony's contributions and column sums run at on BLS12-381
# ---------------------------------------------------------------------------

GRP12 = g1_group("bls12_381")
Q12 = GRP12.q
NL12 = 24
RMONT12 = (1 << (16 * NL12)) % Q12


@pytest.fixture(scope="module")
def jadd12():
    """The JAX complete mixed add over BLS12-381's Fq, (N, 24) limbs."""
    ops = curve_ops(Q12)
    fn = jax.jit(lambda X, Y, Z, qx, qy: ops.mixed_add((X, Y, Z), qx, qy))

    def add(P, qx, qy):
        out = fn(*(jnp.asarray(a.astype(np.uint32)) for a in (*P, qx, qy)))
        return tuple(np.asarray(o).astype(np.int64) for o in out)

    return add


def _mont12(xs):
    return ints_to_limbs([x * RMONT12 % Q12 for x in xs], NL12).astype(np.int64)


def _jac12(rng, pt, near):
    """(X, Y, Z) ints of pt with Z random or within 2^8 of q (near); for
    None, infinity."""
    if pt is None:
        return (rng.randrange(Q12), rng.randrange(Q12), 0)
    z = Q12 - rng.randrange(1, 1 << 8) if near else rng.randrange(1, Q12)
    return (pt.x * z * z % Q12, pt.y * z ** 3 % Q12, z)


@pytest.mark.parametrize("z", ["random", "near_q"])
def test_mixed_add_lm_12_limbs_matches_reference(jadd12, z):
    rng = random.Random(21)
    pts = [GRP12.generator() * rng.randrange(1, GRP12.r) for _ in range(6)]
    P, Qa, cases = [], [], []
    for i in range(N):
        kind = ("general", "infinity", "double", "cancel")[i % 4]
        qpt = pts[i % len(pts)]
        ppt = {"general": pts[(i + 1) % len(pts)], "infinity": None, "double": qpt, "cancel": -qpt}[kind]
        P.append(_jac12(rng, ppt, z == "near_q"))
        Qa.append(qpt)
        cases.append(kind)
    Pm = tuple(_mont12([p[c] for p in P]) for c in range(3))
    qx, qy = _mont12([q.x for q in Qa]), _mont12([q.y for q in Qa])
    want = jadd12(Pm, qx, qy)
    before = pf.LAUNCHES["mixed_add_lm"]
    got = pf.mixed_add_lm(Q12, *(_lm(a) for a in (*Pm, qx, qy)), block=8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (NL12, N)
        np.testing.assert_array_equal(g.numpy().T.astype(np.int64), w)
    zrows = got[2].numpy().T
    for i, kind in enumerate(cases):
        assert (zrows[i] == 0).all() == (kind == "cancel")
    assert pf.LAUNCHES["mixed_add_lm"] == before


@pytest.mark.parametrize("nb", [4, 16])
def test_accumulate_lm_12_limbs_matches_bucket_fold(jadd12, nb):
    """accumulate_lm at 24 limbs against the JAX mixed add folded bucket
    by bucket, at 4 buckets and at the ceremony's 16."""
    chunk_len = 5
    rng = random.Random(22)
    pts = [GRP12.generator() * rng.randrange(1, GRP12.r) for _ in range(3)]
    pool = pts + [-p for p in pts]
    nrng = np.random.default_rng(23)
    digits = nrng.integers(0, nb + 2, (chunk_len, N)).astype(np.int64)
    idx = nrng.integers(0, len(pool), (chunk_len, N))
    digits[:, 0] = [1, 1, 0, 1, nb]        # P, P (doubles), ..., -P
    idx[:, 0] = [0, 0, 1, 3, 2]
    digits[:, 1] = [2, 2, 0xFFFFFFFF, 3, 0]  # P then -P (cancels)
    idx[:, 1] = [1, 4, 0, 2, 0]
    qx = np.stack([_mont12([pool[j].x for j in row]) for row in idx])
    qy = np.stack([_mont12([pool[j].y for j in row]) for row in idx])
    one = _mont12([1])[0]
    B = [np.broadcast_to(one, (nb, N, NL12)).copy(), np.broadcast_to(one, (nb, N, NL12)).copy(),
         np.zeros((nb, N, NL12), np.int64)]
    lanes = np.arange(N)
    for t in range(chunk_len):
        d = digits[t]
        hit = (d >= 1) & (d < nb)
        b = np.where(hit, d, 0)
        new = jadd12(tuple(c[b, lanes] for c in B), qx[t], qy[t])
        for c, v in zip(B, new):
            c[b[hit], lanes[hit]] = v[hit]
    before = pf.LAUNCHES["accumulate_lm"]
    got = pf.accumulate_lm(
        Q12, torch.as_tensor(digits.astype(np.uint32).view(np.int32)),
        torch.as_tensor(np.ascontiguousarray(qx.transpose(0, 2, 1)).reshape(chunk_len * NL12, N).astype(np.int32)),
        torch.as_tensor(np.ascontiguousarray(qy.transpose(0, 2, 1)).reshape(chunk_len * NL12, N).astype(np.int32)),
        n_buckets=nb, block=8,
    )
    for g, w in zip(got, B):
        assert g.dtype == torch.int32 and g.shape == (nb, NL12, N)
        np.testing.assert_array_equal(g.numpy().transpose(0, 2, 1).astype(np.int64), w)
    assert (got[2].numpy()[2, :, 1] == 0).all()  # lane 1's bucket 2: P + (-P)
    assert pf.LAUNCHES["accumulate_lm"] == before


# ---------------------------------------------------------------------------
# 24 limbs: BW6-761's base field (48 16-bit limbs), the width of a
# contribution's ladder to a BW6-761 key (no path accumulates at 24 limbs)
# ---------------------------------------------------------------------------

GRP24 = g1_group("bw6_761")
Q24 = GRP24.q
NL24 = 48


@pytest.fixture(scope="module")
def jadd24():
    """The JAX complete mixed add over BW6-761's Fq, (N, 48) limbs."""
    ops = curve_ops(Q24)
    fn = jax.jit(lambda X, Y, Z, qx, qy: ops.mixed_add((X, Y, Z), qx, qy))

    def add(P, qx, qy):
        out = fn(*(jnp.asarray(a.astype(np.uint32)) for a in (*P, qx, qy)))
        return tuple(np.asarray(o).astype(np.int64) for o in out)

    return add


def _mont24(xs):
    rm = (1 << (16 * NL24)) % Q24
    return ints_to_limbs([x * rm % Q24 for x in xs], NL24).astype(np.int64)


@pytest.mark.parametrize("z", ["random", "near_q"])
def test_mixed_add_lm_24_limbs_matches_reference(jadd24, z):
    rng = random.Random(31)
    pts = [GRP24.generator() * rng.randrange(1, GRP24.r) for _ in range(4)]
    P, Qa, cases = [], [], []
    for i in range(N):
        kind = ("general", "infinity", "double", "cancel")[i % 4]
        qpt = pts[i % len(pts)]
        ppt = {"general": pts[(i + 1) % len(pts)], "infinity": None, "double": qpt, "cancel": -qpt}[kind]
        if ppt is None:
            P.append((rng.randrange(Q24), rng.randrange(Q24), 0))
        else:
            zz = Q24 - rng.randrange(1, 1 << 8) if z == "near_q" else rng.randrange(1, Q24)
            P.append((ppt.x * zz * zz % Q24, ppt.y * zz ** 3 % Q24, zz))
        Qa.append(qpt)
        cases.append(kind)
    Pm = tuple(_mont24([p[c] for p in P]) for c in range(3))
    qx, qy = _mont24([q.x for q in Qa]), _mont24([q.y for q in Qa])
    want = jadd24(Pm, qx, qy)
    before = pf.LAUNCHES["mixed_add_lm"]
    got = pf.mixed_add_lm(Q24, *(_lm(a) for a in (*Pm, qx, qy)), block=8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (NL24, N)
        np.testing.assert_array_equal(g.numpy().T.astype(np.int64), w)
    zrows = got[2].numpy().T
    for i, kind in enumerate(cases):  # the edge cases were reached
        assert (zrows[i] == 0).all() == (kind == "cancel")
        if kind == "infinity":
            assert (zrows[i] == _mont24([1])[0]).all()
    assert pf.LAUNCHES["mixed_add_lm"] == before
