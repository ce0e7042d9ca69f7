"""The port's suffix epilogue (zokrates_tpu_torch.kernels.msm_sorted.
suffix_fold) on the CPU, where the wrapper runs its plain version, for G1
and G2 and lw in {8, 128}: each window sum sum_i tot_i + (lw-1-i)*L*acc_i
against the JAX package's Python-int point oracle (zokrates_tpu.ec),
compared as affine points (infinity included). The TPU's fold kernel adds
in another order than the port, so equality is the group law's. (The JAX
package's XLA epilogue, msm_sorted._suffix_post, computes the same sums;
on the CPU its first jitted call takes 95 s for the smallest shape here,
G1 with lw 8, over this file's 30 s budget.)

Inputs: suffix-walk outputs [acc | tot] (6*en, W*lw) drawn from a seeded
pool of real curve points with random Jacobian Z, their negatives and a
point at infinity (X, Y arbitrary, Z = 0). Also: the wrapper's argument
checks, and that a CPU call counts no launch.
"""

import random

import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import g1_group, g2_group
from zokrates_tpu.ec.tower import Fq2
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.fields.jfield2 import field_ops2
from zokrates_tpu_torch.kernels import msm_sorted as ms

Q = g1_group("bn128").q
RINV = pow(1 << 256, -1, Q)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(ext, seed, n=5):
    """(Jacobian rows (2n+1, 3*en) int32, host points): n random points,
    their negatives, and infinity last."""
    rng = random.Random(seed)
    grp = g2_group("bn128") if ext else g1_group("bn128")
    f = field_ops2(Q, -1) if ext else field_ops(Q)
    co = (lambda v: (v.c0, v.c1)) if ext else (lambda v: v)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
    pts += [-p for p in pts]
    X, Y, Z = [], [], []
    for p in pts:
        z = Fq2(grp.tower, rng.randrange(1, Q), rng.randrange(Q)) if ext else rng.randrange(1, Q)
        X.append(co(p.x * z * z) if ext else p.x * z * z % Q)
        Y.append(co(p.y * z * z * z) if ext else p.y * z ** 3 % Q)
        Z.append(co(z) if ext else z)
    X.append(co(pts[0].x))
    Y.append(co(pts[1].y))
    Z.append((0, 0) if ext else 0)

    def enc(vals):
        return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    return torch.cat([enc(X), enc(Y), enc(Z)], 1), grp


def _out6(jac, W, lw, seed):
    """(6*en, W*lw) [acc | tot] rows; about one lane in six at infinity."""
    rng = np.random.default_rng(seed)
    M = W * lw
    inf = jac.shape[0] - 1
    ia = rng.integers(0, inf, M)
    it = rng.integers(0, inf, M)
    ia[rng.random(M) < 0.15] = inf
    it[rng.random(M) < 0.15] = inf
    return torch.cat([jac[torch.as_tensor(ia)], jac[torch.as_tensor(it)]], 1).T.contiguous()


def _affine(X, Y, Z, ext, grp):
    """One window's Montgomery limb coordinates -> host affine point."""
    def elem(limbs):
        vals = [int(v) for v in limbs]
        ints = [sum(v << (16 * i) for i, v in enumerate(vals[h:h + 16])) * RINV % Q
                for h in range(0, len(vals), 16)]
        return Fq2(grp.tower, *ints) if ext else ints[0]

    x, y, z = elem(X), elem(Y), elem(Z)
    if z == (Fq2(grp.tower, 0, 0) if ext else 0):
        return None
    if ext:
        zi = z.inv()
        return (x * zi * zi, y * zi * zi * zi)
    zi = pow(z, -1, Q)
    return (x * zi * zi % Q, y * zi ** 3 % Q)


def _point(col, ext, grp):
    """One lane's Jacobian column (3*en,) -> host point."""
    en = col.shape[0] // 3
    a = _affine(col[:en], col[en:2 * en], col[2 * en:], ext, grp)
    if a is None:
        return grp.zero()
    return grp.point(*[(c.c0, c.c1) for c in a]) if ext else grp.point(*a)


@pytest.mark.parametrize("lw,W,L", [(8, 3, 5), (128, 2, 1)], ids=["lw8", "lw128"])
@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
def test_suffix_fold_matches_reference(ext, lw, W, L):
    jac, grp = _pool(ext, seed=20 + ext)
    out6 = _out6(jac, W, lw, seed=lw + ext)
    before = dict(ms.LAUNCHES)
    got = [t.numpy() for t in ms.suffix_fold(out6, Q, W, lw, L, -1 if ext else None)]
    assert dict(ms.LAUNCHES) == before  # the plain version: no launch
    en = jac.shape[1] // 3
    assert all(t.shape == (W, en) and t.dtype == np.int64 for t in got)
    cols = out6.T.numpy()
    for w in range(W):
        want = grp.zero()
        for i in range(lw):
            col = cols[w * lw + i]
            want = want + _point(col[3 * en:], ext, grp) + _point(col[:3 * en], ext, grp) * ((lw - 1 - i) * L)
        assert _point(np.concatenate([t[w] for t in got]), ext, grp) == want, w


def test_suffix_fold_rejects_bad_arguments():
    out6 = torch.zeros((96, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ms.suffix_fold(out6, Q, 2, 6, 1)  # lw not a power of two
    with pytest.raises(ValueError):
        ms.suffix_fold(out6, Q, 2, 8, 0)  # L < 1
    with pytest.raises(ValueError):
        ms.suffix_fold(out6, Q, 3, 8, 1)  # 16 lanes are not 3 windows of 8
    with pytest.raises(TypeError):
        ms.suffix_fold(out6.to(torch.int64), Q, 2, 8, 1)
    with pytest.raises(ValueError):
        ms.suffix_fold(out6.T.contiguous().T, Q, 2, 8, 1)  # not contiguous
    with pytest.raises(ValueError):
        ms.suffix_fold(out6.to("meta"), Q, 2, 8, 1)
