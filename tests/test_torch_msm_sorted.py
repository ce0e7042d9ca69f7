"""The port's sorted MSM (zokrates_tpu_torch.kernels.msm_sorted) on the CPU,
where its wrappers run the kernels' plain PyTorch versions.

  * the walk (modes mixed-unsafe, mixed-safe, general) and the suffix walk,
    over G1 and G2, against the JAX package's Python-int point oracle
    (zokrates_tpu.ec), snapshot by snapshot;
  * the scalar plan (signed digits, stable per-window sort, walk flags,
    record compaction) against the JAX package's _msm_plan, dense and
    split, and its shared-bucket plan _msm_plan_shared at c = 8 and at the
    h16 configuration (c = 16, 1024 lanes);
  * the shared-bucket MSM (pre-shifted points 2^(cw) * P_j, one window)
    at N = 64 against the oracle;
  * the full sorted MSM at N = 1024 for G1 and G2, its window sums, the
    collision flag and the safe rerun, against the oracle;
  * the wrappers' argument checks.

Inputs come from seeded numpy / random generators. Tolerance: exact
equality of integers (limbs, point coordinates, plan arrays).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import g1_group, g2_group
from zokrates_tpu.ec.tower import Fq2
from zokrates_tpu.fields import params as JP
from zokrates_tpu.kernels import msm_sorted as jms
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.fields.jfield2 import field_ops2
from zokrates_tpu_torch.fields.limbs import ints_to_limbs
from zokrates_tpu_torch.kernels import msm_sorted as ms

Q = JP.BASE_FIELDS["bn128"].p
R_MOD = JP.SCALAR_FIELDS["bn128"].p
RINV = pow(1 << 256, -1, Q)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers: host points <-> kernel limb rows
# ---------------------------------------------------------------------------


def _group(ext):
    return g2_group("bn128") if ext else g1_group("bn128")


def _f(ext):
    return field_ops2(Q, -1) if ext else field_ops(Q)


def _coord(v, ext):
    return (v.c0, v.c1) if ext else v


def _rows(vals, ext):
    """Host coordinates -> (n, en) int32 Montgomery limb rows."""
    return _f(ext).encode(vals).reshape(len(vals), -1).to(torch.int32)


def _elem(limbs, ext, grp):
    """en 16-bit Montgomery limbs -> canonical int (or Fq2)."""
    vals = [int(v) for v in limbs]
    ints = []
    for h in range(0, len(vals), 16):
        ints.append(sum(v << (16 * i) for i, v in enumerate(vals[h:h + 16])) * RINV % Q)
    return Fq2(grp.tower, *ints) if ext else ints[0]


def _to_point(col, ext, grp):
    """One lane's Jacobian column (3*en,) -> host affine point."""
    en = col.shape[0] // 3
    X, Y, Z = (_elem(col[i * en:(i + 1) * en], ext, grp) for i in range(3))
    if (Z == Fq2(grp.tower, 0, 0)) if ext else Z == 0:
        return grp.zero()
    if ext:
        zi = Z.inv()
        return grp.point(_coord(X * zi * zi, ext), _coord(Y * zi * zi * zi, ext))
    zi = pow(Z, -1, Q)
    return grp.point(X * zi * zi % Q, Y * zi ** 3 % Q)


class Pool:
    """Random points of one group as affine rows and as Jacobian rows with
    random Z, with their negatives (cancellations) and one point at
    infinity as the last Jacobian row."""

    def __init__(self, ext, seed, n=6):
        rng = random.Random(seed)
        grp = _group(ext)
        self.grp, self.ext = grp, ext
        self.pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
        self.affine = torch.cat([_rows([_coord(p.x, ext) for p in self.pts], ext),
                                 _rows([_coord(p.y, ext) for p in self.pts], ext)], 1)
        self.jpts = self.pts + [-p for p in self.pts]
        X, Y, Z = [], [], []
        for p in self.jpts:
            z = Fq2(grp.tower, rng.randrange(1, Q), rng.randrange(Q)) if ext else rng.randrange(1, Q)
            X.append(_coord(p.x * z * z, ext) if ext else p.x * z * z % Q)
            Y.append(_coord(p.y * z * z * z, ext) if ext else p.y * z ** 3 % Q)
            Z.append(_coord(z, ext) if ext else z)
        X.append(_coord(self.pts[0].x, ext))
        Y.append(_coord(self.pts[0].y, ext))
        Z.append((0, 0) if ext else 0)
        self.jac = torch.cat([_rows(X, ext), _rows(Y, ext), _rows(Z, ext)], 1)
        self.jpts.append(grp.zero())


def _walk_case(pool, mode, K, L, seed):
    rng = np.random.default_rng(seed)
    src = pool.affine if mode == "mixed" else pool.jac
    idx = rng.integers(0, src.shape[0], (K, L))
    q = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    flags = (rng.random((K, L)) < 0.3).astype(np.int32) | ((rng.random((K, L)) < 0.15).astype(np.int32) << 1)
    return idx, q, torch.as_tensor(flags)


# ---------------------------------------------------------------------------
# walk and suffix vs the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
def test_walk_matches_oracle(ext, mode, safe):
    """Every snapshot of every lane equals the oracle's running bucket sum;
    the unsafe mixed walk flags exactly the lanes where a running sum met
    its own point (and is not compared after that)."""
    pool = Pool(ext, seed=1 + ext)
    K, L = 8, 24
    idx, q, flags = _walk_case(pool, mode, K, L, seed=3)
    out, coll = ms.walk(q, flags, Q, mode, safe, -1 if ext else None)
    assert out.shape == (K, q.shape[1] // (2 if mode == "mixed" else 3) * 3, L)
    pts = pool.pts if mode == "mixed" else pool.jpts
    fl = flags.numpy()
    met = set()
    for lane in range(L):
        acc, hit = pool.grp.zero(), False
        for k in range(K):
            if not fl[k, lane] & 2:
                pt = pts[idx[k, lane]]
                if not acc.infinity and not pt.infinity and acc.x == pt.x:
                    met.add("double" if acc == pt else "cancel")
                    hit |= acc == pt and mode == "mixed"
                acc = acc + pt
            if not (hit and not safe):
                assert _to_point(out[k, :, lane].numpy(), ext, pool.grp) == acc, (lane, k)
            if fl[k, lane] & 1:
                acc = pool.grp.zero()
        assert int(coll[lane]) == int(hit and not safe), lane
    # the inputs do meet the doubling case (and, with negated rows, the
    # cancellation case)
    assert met == ({"double"} if mode == "mixed" else {"double", "cancel"})


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
def test_suffix_matches_oracle(ext):
    """[acc | tot] = (sum of both slots over the lane's buckets, sum of the
    running sums)."""
    pool = Pool(ext, seed=5)
    Lb, M = 4, 12
    rng = np.random.default_rng(6)
    ia = rng.integers(0, pool.jac.shape[0], (Lb, M))
    ib = rng.integers(0, pool.jac.shape[0], (Lb, M))
    A = pool.jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous()
    B = pool.jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous()
    out = ms.suffix(A, B, Q, -1 if ext else None)
    en = A.shape[1] // 3
    assert out.shape == (6 * en, M)
    for lane in range(M):
        acc = tot = pool.grp.zero()
        for t in range(Lb):
            acc = acc + pool.jpts[ia[t, lane]] + pool.jpts[ib[t, lane]]
            tot = tot + acc
        col = out[:, lane].numpy()
        assert _to_point(col[:3 * en], ext, pool.grp) == acc
        assert _to_point(col[3 * en:], ext, pool.grp) == tot


# ---------------------------------------------------------------------------
# plans vs the JAX package
# ---------------------------------------------------------------------------


def _scalars(N, seed, bits_small=0.5):
    """Witness-like scalars: about half small (a few bits), the rest full."""
    rng = random.Random(seed)
    return [rng.randrange(R_MOD) if rng.random() > bits_small else rng.randrange(4) for _ in range(N)]


@pytest.mark.parametrize("split", [None, (1, 256)], ids=["dense", "split"])
def test_plan_matches_reference(split):
    N = 1024
    cfg = ms.default_config(N)
    jcfg = jms.default_config(N, interpret=True)
    assert (cfg.c, cfg.M1, cfg.R, cfg.lw2) == (jcfg.c, jcfg.M1, jcfg.R, jcfg.lw2)
    W = ms._windows(R_MOD, cfg.c)
    assert W == jms._windows(R_MOD, cfg.c)
    sc = _scalars(N, 7)
    limbs = ints_to_limbs(sc, 16)
    if split is None:
        mine = [ms._msm_plan(W, N, cfg, torch.as_tensor(limbs.astype(np.int64)))]
        ref = [jms._msm_plan(W, N, jcfg, jnp.asarray(limbs))]
    else:
        w0, Ks = split
        # windows >= w0 must have at most Ks nonzero digits: keep them sparse
        sc = [s if i < Ks else s % (1 << 8) for i, s in enumerate(sc)]
        limbs = ints_to_limbs(sc, 16)
        mine = ms._msm_plan_split(W, N, cfg, torch.as_tensor(limbs.astype(np.int64)), w0, Ks)
        ref = jms._msm_plan_split(W, N, jcfg, jnp.asarray(limbs), w0, Ks)
    for m_plan, r_plan in zip(mine, ref):
        for got, want in zip(m_plan, r_plan):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("c,M1,R,lw2,N", [(8, 32, 2, 8, 64), (16, 1024, 4, 1024, 256)],
                         ids=["c8", "h16"])
def test_plan_shared_matches_reference(c, M1, R, lw2, N):
    cfg = ms.MSMConfig(c=c, M1=M1, R=R, lw2=lw2)
    jcfg = jms.MSMConfig(c=c, M1=M1, R=R, lw2=lw2, interpret=True)
    Wc = ms.shared_window_count(R_MOD, c)
    assert Wc == jms.shared_window_count(R_MOD, c)
    limbs = ints_to_limbs(_scalars(N, 21, bits_small=0.2), 16)
    mine = ms._msm_plan_shared(Wc, N, cfg, torch.as_tensor(limbs.astype(np.int64)))
    ref = jms._msm_plan_shared(Wc, N, jcfg, jnp.asarray(limbs))
    for got, want in zip(mine, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_signed_digits_match_reference():
    sc = _scalars(256, 8, bits_small=0.1) + [R_MOD - 1, 0, 1, (1 << 253) + 12345]
    limbs = ints_to_limbs(sc, 16)
    for c in (4, 8, 16):
        W = ms._windows(R_MOD, c)
        got = ms._signed_digits(torch.as_tensor(limbs.astype(np.int64)), W, c)
        want = jms._signed_digits(jnp.asarray(limbs), W, c)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        # the digits reassemble the scalars
        b, s = (t.numpy() for t in got)
        vals = [sum(int((-1) ** s[w, i] * b[w, i]) << (c * w) for w in range(W)) for i in range(len(sc))]
        assert vals == sc


def test_compact_positions_drops_beyond_cap():
    rng = np.random.default_rng(9)
    valid = rng.random((3, 40)) < 0.6
    cap = int(valid.sum(1).max()) - 2  # some rows have more Trues than fit
    got = ms._compact_positions(torch.as_tensor(valid), cap).numpy()
    want = np.asarray(jms._compact_positions(jnp.asarray(valid), cap)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# full MSM vs the oracle
# ---------------------------------------------------------------------------


def _msm_case(ext, N, seed):
    """Points P_i = k_i * G with k_0 random and k_(i+1) = 2 k_i + kB, made
    by one doubling and one addition each, so the oracle for any scalars
    is one scalar multiplication of G; witness-like scalars. (An
    arithmetic progression would not do: P_a + P_b - P_c = P_(a+b-c)
    puts a bucket's running sum on its next point, and the doubling-free
    walk would flag it.)"""
    rng = random.Random(seed)
    grp = _group(ext)
    k, kB = rng.randrange(1, grp.r), rng.randrange(1, grp.r)
    g = grp.generator()
    pt, step = g * k, g * kB
    xs, ys, ks = [], [], []
    for _ in range(N):
        xs.append(_coord(pt.x, ext))
        ys.append(_coord(pt.y, ext))
        ks.append(k)
        pt, k = pt + pt + step, (2 * k + kB) % grp.r
    sc = _scalars(N, seed + 1)
    f = _f(ext)
    if ext:
        P128 = ms.pack_points_g2(Q, f.encode(xs), f.encode(ys))
    else:
        P128 = ms.pack_points(Q, f.encode(xs), f.encode(ys))
    S = torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64))
    return grp, ks, sc, P128, S


def _host_point(jac, ext, grp):
    jx, jy, jz = jac
    if ext:
        if jz == (0, 0):
            return grp.zero()
        zi = Fq2(grp.tower, *jz).inv()
        return grp.point(_coord(Fq2(grp.tower, *jx) * zi * zi, ext), _coord(Fq2(grp.tower, *jy) * zi * zi * zi, ext))
    if jz == 0:
        return grp.zero()
    zi = pow(jz, -1, Q)
    return grp.point(jx * zi * zi % Q, jy * zi ** 3 % Q)


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
def test_msm_sorted_host_matches_oracle(ext, monkeypatch):
    N = 1024
    grp, ks, sc, P128, S = _msm_case(ext, N, 11 + ext)
    runs = []
    real = ms._msm_from_plan

    def spy(*args, **kw):
        out = real(*args, **kw)
        runs.append(int(out[1]))
        return out

    monkeypatch.setattr(ms, "_msm_from_plan", spy)
    got = _host_point(ms.msm_sorted_host(Q, R_MOD, P128, S, beta=-1 if ext else None), ext, grp)
    assert got == grp.generator() * (sum(s * k for s, k in zip(sc, ks)) % R_MOD)
    assert runs == [0]  # no collision, so no safe rerun


def test_window_sums_and_combine_match_oracle():
    """Each window sum of the G1 MSM is sum_i digit_w(s_i) * P_i, and the
    native and Python window combines both give the MSM."""
    N = 1024
    grp, ks, sc, P128, S = _msm_case(False, N, 13)
    g = grp.generator()
    cfg = ms.default_config(N)
    W = ms._windows(R_MOD, cfg.c)
    out, _ = ms._msm_from_plan(Q, W, cfg, P128[None], ms._msm_plan(W, N, cfg, S), True)
    wX, wY, wZ = out
    b, s = (t.numpy() for t in ms._signed_digits(S, W, cfg.c))
    en = wX.shape[-1]
    for w in range(W):
        col = torch.cat([wX[0, w], wY[0, w], wZ[0, w]]).numpy()
        assert col.shape == (3 * en,)
        k_tot = sum(int(b[w, i]) * (-1 if s[w, i] else 1) * ks[i] for i in range(N))
        assert _to_point(col, False, grp) == g * (k_tot % R_MOD), w
    wins = tuple(a[0].numpy() for a in out)
    want = g * (sum(x * k for x, k in zip(sc, ks)) % R_MOD)
    for native in (False, True):
        assert _host_point(ms.combine_windows(Q, R_MOD, wins, W, cfg.c, native=native), False, grp) == want


def test_collision_flag_and_safe_rerun(monkeypatch):
    """All points equal and all digits in one bucket: the doubling-free walk
    must flag the collision, and msm_sorted_host must rerun with the
    complete add and return the right sum."""
    N = 64
    grp = g1_group("bn128")
    g = grp.generator()
    f = field_ops(Q)
    P128 = ms.pack_points(Q, f.encode([g.x] * N), f.encode([g.y] * N))
    S = torch.as_tensor(ints_to_limbs([3] * N, 16).astype(np.int64))
    runs = []
    real = ms._msm_from_plan

    def spy(p, W, cfg, P, plan, safe, beta=None, mark=None):
        out = real(p, W, cfg, P, plan, safe, beta, mark)
        runs.append((safe, int(out[1])))
        return out

    monkeypatch.setattr(ms, "_msm_from_plan", spy)
    got = _host_point(ms.msm_sorted_host(Q, R_MOD, P128, S), False, grp)
    assert runs[0] == (False, 1)
    assert runs[1][0] is True
    assert got == g * (3 * N)


# ---------------------------------------------------------------------------
# wrapper checks
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_arguments():
    q = torch.zeros((4, 32, 8), dtype=torch.int32)
    fl = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ms.walk(q.to(torch.int64), fl, Q, "mixed", True)
    with pytest.raises(ValueError):
        ms.walk(q, fl[:3], Q, "mixed", True)
    with pytest.raises(ValueError):
        ms.walk(q, fl, Q, "general", True)  # general rows are [X|Y|Z]
    with pytest.raises(ValueError):
        ms.walk(torch.zeros((4, 48, 8), dtype=torch.int32), fl, Q, "general", False)
    with pytest.raises(ValueError):
        ms.walk(q, fl, Q, "sideways", True)
    with pytest.raises(ValueError):
        ms.walk(q[:, :, ::2], fl[:, ::2], Q, "mixed", True)  # not contiguous
    with pytest.raises(ValueError):
        ms.suffix(torch.zeros((2, 48, 8), dtype=torch.int32), torch.zeros((2, 48, 4), dtype=torch.int32), Q)
    with pytest.raises(ValueError):
        ms.walk(q.to("meta"), fl.to("meta"), Q, "mixed", True)


def test_shared_bucket_msm_matches_oracle():
    """The shared-bucket fixed-base form: the Wc window copies 2^(cw) * P_j
    fall into ONE bucket space, and the single window's sum is the whole
    MSM (no window combine). Full-width scalars, c = 8."""
    N = 64
    rng = random.Random(22)
    grp = g1_group("bn128")
    ks = [rng.randrange(1, R_MOD) for _ in range(N)]
    sc = [rng.randrange(R_MOD) for _ in range(N)]
    cfg = ms.MSMConfig(c=8, M1=32, R=2, lw2=8)
    Wc = ms.shared_window_count(R_MOD, cfg.c)
    g = grp.generator()
    rows = [[g * k for k in ks]]  # window w+1: window w doubled c times
    for _ in range(Wc - 1):
        rows.append(rows[-1])
        for _ in range(cfg.c):
            rows[-1] = [p + p for p in rows[-1]]
    shifted = [p for row in rows for p in row]
    f = field_ops(Q)
    P128 = ms.pack_points(Q, f.encode([p.x for p in shifted]), f.encode([p.y for p in shifted]))
    S = torch.as_tensor(ints_to_limbs(sc, 16).astype(np.int64))
    out, _ = ms._msm_from_plan(Q, 1, cfg, P128[None], ms._msm_plan_shared(Wc, N, cfg, S), True)
    wins = tuple(a[0].numpy() for a in out)
    assert wins[0].shape == (1, 16)
    got = _host_point(ms.combine_windows(Q, R_MOD, wins, 1, cfg.c, native=False), False, grp)
    assert got == g * (sum(k * s for k, s in zip(ks, sc)) % R_MOD)
