"""Scalar ladders and column sums of affine curve points, batched on the
device: the card-side work of the Groth16 phase-2 ceremony
(schemes/mpc.py, interop/bellman_mpc.py).

The JAX package runs these as host loops of Python-int point arithmetic:
a contribution multiplies every h and l query point by one scalar, and
bellman's `initialize` sums coefficient * point terms per variable. Here:

  * scale_affine: k * P for a batch of affine G1 points and one scalar k,
    left to right over the bits of k's two GLV halves (k = k1 + k2 lam,
    lam * P = (beta x, y)): each step doubles the Jacobian accumulator
    (kernels/jec, batched) and, where a half's bit is set, adds the affine
    base points (P or their image) with one mixed_add_lm launch (CUDA
    kernel mixed_add_kernel). Every lane takes the same branch.
  * scale_terms: k_t * P_t with a scalar per point. A scalar c with r - c
    < c is folded to r - c on the negated point, so a coefficient that is
    the negation of a small number costs what the small number does. The
    points are sorted by their scalar's bit length, longest first, so a
    step of the ladder runs only over the prefix of lanes whose scalar has
    begun; each step adds through `add` (mixed_add_lm for G1, jec's mixed
    add for G2) and keeps the sum with a per-lane select.
  * column_sums_g1: the sum of each column's affine G1 points through one
    accumulate_lm launch (CUDA kernel accumulate_kernel): a column's points
    are cut into pieces of at most PIECE, every piece gets one bucket slot
    (1..15) of a lane, the lane's steps are its pieces' points one after
    another, and the pieces are dealt to the lanes largest first, in
    snake order, so the lanes' step counts balance; a column's pieces are
    then added pairwise with jec's complete add.
  * column_sums_ext: the same sums over G2 (Fq2), one lane a column, with
    jec's mixed add: rows 8-9 of the kernels are G1 only.

Results are Jacobian batches; jec's CurveOps.to_affine_ints takes them to
host coordinates.

A sum at infinity has Z = 0. Points are (n, nl) int64 Montgomery limbs
((n, 2, nl) over Fq2), canonical, on one device; on a CPU tensor the
kernel wrappers run their plain versions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields.limbs import LIMB_BITS, ints_to_limbs
from .jec import CurveOps, PointBatch, curve_ops
from .pallas_field import accumulate_lm, mixed_add_lm

# threads a block of the point kernels; lane counts are padded to a
# multiple of it (below one block: to a multiple of 32, one block of that
# many threads)
BLOCK = 256
# bucket slots a lane of accumulate_lm holds (slot 0 is never touched)
N_BUCKETS = 16
# the most terms of a column that one bucket slot sums (column_sums_g1)
PIECE = 32


def _padded(n: int) -> int:
    if n <= BLOCK:
        return max(32, -(-n // 32) * 32)
    return -(-n // BLOCK) * BLOCK


def _block(n: int) -> int:
    """The point kernels' threads a block for a padded lane count n."""
    return min(n, BLOCK)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(n, nl) int64 elements -> (nl, n) int32 limb-major rows."""
    return t.T.to(torch.int32).contiguous()


def _elems(t: torch.Tensor) -> torch.Tensor:
    """(nl, n) int32 limb-major rows -> (n, nl) int64 elements."""
    return t.T.to(torch.int64).contiguous()


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def g1_adder(q: int):
    """P + (qx, qy) over G1 through the mixed_add_lm kernel, on element-major
    tensors whose row count is a multiple of BLOCK."""
    def add(P: PointBatch, qx, qy) -> PointBatch:
        X, Y, Z = mixed_add_lm(q, *(_rows(t) for t in (*P, qx, qy)), block=_block(qx.shape[0]))
        return _elems(X), _elems(Y), _elems(Z)
    return add


_GLV = {}


def _round_div(a: int, b: int) -> int:
    """The integer nearest a / b."""
    if b < 0:
        a, b = -a, -b
    return (2 * a + b) // (2 * b)


def glv(curve: str):
    """The curve's G1 endomorphism phi(x, y) = (beta x, y) = lam * P (beta
    a cube root of unity in Fq, lam one in Fr; every curve here has a = 0
    and q, r = 1 mod 3) and a short basis (v1, v2) of the lattice {(a, b):
    a + b lam = 0 mod r}, by the extended Euclidean algorithm on (r, lam)
    (Gallant, Lambert and Vanstone)."""
    if curve not in _GLV:
        from ..ec.curve import g1_group
        from ..ec.jacobian import jac_mul, jac_to_affine

        grp = g1_group(curve)
        q, r, g = grp.q, grp.r, grp.generator()

        def cube_root(p):
            return next(w for w in (pow(x, (p - 1) // 3, p) for x in range(2, 64)) if w != 1)

        beta, lam = cube_root(q), cube_root(r)
        if jac_to_affine(q, jac_mul(q, (g.x, g.y, 1), lam)) != (beta * g.x % q, g.y):
            lam = lam * lam % r
        r0, r1, t0, t1 = r, lam, 0, 1
        while r1 * r1 >= r:
            k = r0 // r1
            r0, r1, t0, t1 = r1, r0 - k * r1, t1, t0 - k * t1
        k = r0 // r1
        r2, t2 = r0 - k * r1, t0 - k * t1
        v2 = (r0, -t0) if r0 * r0 + t0 * t0 <= r2 * r2 + t2 * t2 else (r2, -t2)
        _GLV[curve] = (beta, lam, (r1, -t1), v2)
    return _GLV[curve]


def glv_split(curve: str, k: int):
    """k -> (k1, k2), k1 + k2 lam = k mod r, each about sqrt(r) in size."""
    from ..ec.curve import g1_group

    r = g1_group(curve).r
    _, lam, (a1, b1), (a2, b2) = glv(curve)
    det = a1 * b2 - a2 * b1
    c1, c2 = _round_div(b2 * k, det), _round_div(-b1 * k, det)
    k1, k2 = k - c1 * a1 - c2 * a2, -c1 * b1 - c2 * b2
    if (k1 + k2 * lam - k) % r:
        raise AssertionError("glv_split: the decomposition does not recombine")
    return k1, k2


def scale_affine(curve: str, ax: torch.Tensor, ay: torch.Tensor, k: int) -> PointBatch:
    """k * (ax, ay) for every affine G1 point of `curve`, one host scalar k
    in [1, r): the Jacobian result (n, nl). k splits as k1 + k2 lam
    (glv_split), and one ladder walks both halves' bits together over P
    and phi(P) = (beta x, y), each negated where its half is: about half
    the doublings of k's own bits. The bases must be affine points of the
    curve (no point at infinity)."""
    from ..ec.curve import g1_group

    if k < 1:
        raise ValueError(f"scale_affine: the scalar must be positive, got {k}")
    q = g1_group(curve).q
    ops = curve_ops(q)
    f = ops.f
    n = ax.shape[0]
    Np = _padded(n)
    beta = glv(curve)[0]
    k1, k2 = glv_split(curve, k)
    x1, y1 = _pad(ax, Np), _pad(ay, Np)
    x2 = f.mul(x1, f.encode_scalar(beta, device=ax.device))
    bases = [(x, f.neg(y1) if kk < 0 else y1, abs(kk)) for x, kk in ((x1, k1), (x2, k2))]
    add = g1_adder(q)
    acc = ops.infinity((Np,), ax.device)
    started = False
    for i in range(max(abs(k1), abs(k2)).bit_length() - 1, -1, -1):
        if started:
            acc = ops.double(acc)
        for x, y, kk in bases:
            if kk >> i & 1:
                acc = add(acc, x, y)
                started = True
    return tuple(c[:n] for c in acc)


def scale_terms(ops: CurveOps, add, ax: torch.Tensor, ay: torch.Tensor, ks: Sequence[int],
                r: int) -> PointBatch:
    """k_t * (ax, ay)_t for per-point host scalars ks in [1, r), through the
    adder `add` (g1_adder, or jec's ops.mixed_add): the Jacobian results, in
    the input order. The bases must be affine points of the curve. A scalar
    c with r - c < c becomes r - c on the negated point."""
    f = ops.f
    n = len(ks)
    if n == 0:
        return ops.infinity((0,), ax.device)
    neg = np.fromiter((r - k < k for k in ks), bool, n)
    kk = [r - k if ng else k for k, ng in zip(ks, neg)]
    bl = np.fromiter((k.bit_length() for k in kk), np.int64, n)
    order = np.argsort(-bl, kind="stable")
    Np = _padded(n)
    dev = ax.device
    idx = torch.as_tensor(order, device=dev)
    negd = torch.as_tensor(neg[order], device=dev)
    qx = _pad(ax[idx], Np)
    qy = ay[idx]
    qy = _pad(f.select(negd, f.neg(qy), qy), Np)
    bl = np.concatenate([bl[order], np.zeros(Np - n, np.int64)])
    nls = -(-max(1, int(bl.max())) // LIMB_BITS)
    S = torch.as_tensor(ints_to_limbs([kk[i] for i in order] + [0] * (Np - n), nls).astype(np.int64),
                        device=dev)
    acc = ops.infinity((Np,), dev)
    top = int(bl[0])
    for i in range(top - 1, -1, -1):
        L = min(Np, _padded(int(np.count_nonzero(bl > i))))  # the lanes whose scalar has begun
        cur = tuple(c[:L] for c in acc)
        if i < top - 1:
            cur = ops.double(cur)
        bit = ((S[:L, i // LIMB_BITS] >> (i % LIMB_BITS)) & 1).bool()
        new = ops.select(bit, add(cur, qx[:L], qy[:L]), cur)
        for c, v in zip(acc, new):
            c[:L] = v
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(n, device=dev)
    return tuple(c[inv] for c in acc)


def snake_plan(counts: np.ndarray):
    """Deal the columns with counts > 0 to lanes: largest first, in snake
    order over R lanes (R padded as the ladders' lanes, at least
    ceil(columns / 15) and ceil(terms / largest column)), slot i // R + 1
    for the i-th column dealt. Returns (lane, slot, offset) per column (-1 where the
    column is empty; offset: the column's first step in its lane), R and
    the steps of the longest lane."""
    ncols = counts.shape[0]
    live = np.flatnonzero(counts > 0)
    lane = np.full(ncols, -1, np.int64)
    slot = np.full(ncols, -1, np.int64)
    offset = np.full(ncols, -1, np.int64)
    if live.size == 0:
        return lane, slot, offset, _padded(0), 0
    order = live[np.argsort(-counts[live], kind="stable")]
    big, total = int(counts[order[0]]), int(counts[live].sum())
    R = _padded(max(-(-live.size // (N_BUCKETS - 1)), -(-total // big)))
    i = np.arange(order.size)
    rnd, pos = i // R, i % R
    lane[order] = np.where(rnd % 2 == 0, pos, R - 1 - pos)
    slot[order] = rnd + 1
    # offsets: the column's lane's load before it (columns dealt in order)
    by_lane = order[np.lexsort((rnd, lane[order]))]
    c = counts[by_lane]
    ends = np.cumsum(c)
    first = np.r_[True, lane[by_lane][1:] != lane[by_lane][:-1]]
    base = np.maximum.accumulate(np.where(first, ends - c, 0))
    offset[by_lane] = ends - c - base
    loads = np.bincount(lane[live], weights=counts[live], minlength=R)
    return lane, slot, offset, R, int(loads.max())


def _ranks(cols: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Each term's rank among the terms of its column, in input order."""
    order = np.argsort(cols, kind="stable")
    rank = np.empty_like(cols)
    rank[order] = np.arange(cols.size) - (np.cumsum(counts) - counts)[cols[order]]
    return rank


def _segment_sums(ops: CurveOps, P: PointBatch, n: np.ndarray) -> PointBatch:
    """Segment i of P (n[i] >= 1 consecutive Jacobian points) -> its sum,
    pairwise in ceil(log2(max n)) rounds of jec's complete add."""
    dev = P[0].device
    while n.max() > 1:
        half = (n + 1) // 2
        seg = np.repeat(np.arange(n.size), half)
        j = np.arange(seg.size) - (np.cumsum(half) - half)[seg]
        left = (np.cumsum(n) - n)[seg] + 2 * j
        pair = 2 * j + 1 < n[seg]
        lt = torch.as_tensor(left, device=dev)
        rt = torch.as_tensor(np.where(pair, left + 1, left), device=dev)
        Lp = tuple(c[lt] for c in P)
        P = ops.select(torch.as_tensor(pair, device=dev), ops.add(Lp, tuple(c[rt] for c in P)), Lp)
        n = half
    return P


def column_sums_g1(q: int, ax: torch.Tensor, ay: torch.Tensor, cols: np.ndarray, ncols: int):
    """For every column c < ncols, the sum of the affine G1 points t with
    cols[t] == c: the Jacobian sums (ncols, nl) (Z = 0 for an empty column
    or a sum at infinity) and the plan (lanes, steps). A column's terms go
    in pieces of at most PIECE terms, a piece a bucket slot of a lane
    (snake_plan), so that one accumulate_lm launch takes about PIECE steps
    whatever the largest column; a column's pieces are then added pairwise
    (_segment_sums)."""
    ops = curve_ops(q)
    f = ops.f
    nl, dev = f.nl, ax.device
    cols = np.asarray(cols, np.int64)
    counts = np.bincount(cols, minlength=ncols)
    out = ops.infinity((ncols,), dev)
    if cols.size == 0:
        return out, (_padded(0), 0)
    rank = _ranks(cols, counts)
    npieces = -(-counts // PIECE)
    pc = (np.cumsum(npieces) - npieces)[cols] + rank // PIECE  # each term's piece
    lane, slot, offset, R, steps = snake_plan(np.bincount(pc))
    step = torch.as_tensor(offset[pc] + rank % PIECE, device=dev)
    ln = torch.as_tensor(lane[pc], device=dev)
    digits = torch.zeros((steps, R), dtype=torch.int32, device=dev)
    digits[step, ln] = torch.as_tensor(slot[pc], dtype=torch.int32, device=dev)
    Q = torch.zeros((2, steps, R, nl), dtype=torch.int32, device=dev)
    Q[0, step, ln] = ax.to(torch.int32)
    Q[1, step, ln] = ay.to(torch.int32)
    Qr = Q.permute(0, 1, 3, 2).reshape(2, steps * nl, R).contiguous()
    B = accumulate_lm(q, digits, Qr[0], Qr[1], n_buckets=N_BUCKETS, block=_block(R))
    sl, la = torch.as_tensor(slot, device=dev), torch.as_tensor(lane, device=dev)
    pieces = tuple(b[sl, :, la].to(torch.int64) for b in B)  # b: (N_BUCKETS, nl, R)
    live = counts > 0
    sums = _segment_sums(ops, pieces, npieces[live])
    lt = torch.as_tensor(np.flatnonzero(live), device=dev)
    for o, v in zip(out, sums):
        o[lt] = v
    return out, (R, steps)


def column_sums_ext(ops: CurveOps, ax: torch.Tensor, ay: torch.Tensor, cols: np.ndarray, ncols: int):
    """column_sums_g1 over any group with jec's batched mixed add (here
    G2): one lane a column, step s adding each column's s-th point."""
    dev = ax.device
    cols = np.asarray(cols, np.int64)
    counts = np.bincount(cols, minlength=ncols)
    acc = ops.infinity((ncols,), dev)
    if cols.size == 0:
        return acc
    rank = _ranks(cols, counts)
    steps = int(counts.max())
    table = np.full((steps, ncols), -1, np.int64)  # table[s, c]: column c's s-th point
    table[rank, cols] = np.arange(cols.size)
    for s in range(steps):
        t = torch.as_tensor(table[s], device=dev)
        miss = t < 0
        t = torch.where(miss, 0, t)
        acc = ops.mixed_add(acc, ax[t], ay[t], q_inf=miss)
    return acc
