"""Sort-based Pippenger MSM: plans in PyTorch, bucket walks in CUDA.

The counterpart of the JAX package's kernels/msm_sorted.py in its hardware
configuration (the suffix kernel with its fold=True epilogue). Per window:
signed c-bit digits, a stable sort of the point indices by |digit|, a
gather of the affine points into sorted order, then

  * the accumulation walk: lane m owns sorted positions [m*K, (m+1)*K)
    and adds them into a running Jacobian sum, flushing a partial-sum
    record whenever the bucket changes (flags precomputed from the sorted
    keys — the walk has no data-dependent addressing),
  * records are compacted and merged by further walk passes with complete
    adds until every bucket holds at most 2 records (a provable bound),
    then scattered into a 2-slot dense table,
  * the suffix walk folds the table into per-lane running sums and sums
    of running sums; the suffix epilogue (the reference's fold=True
    branch) combines each lane's pair with its static weight and sums the
    lanes of each window,
  * the W window sums are combined on the host (native/zkt_native.c).

The walk, suffix and epilogue passes are the CUDA kernels of
csrc/msm_sorted.cu (walk, suffix, suffix_fold); beside each is its plain
PyTorch version (walk_plain, suffix_plain, suffix_fold_plain), which the
wrapper runs only for tensors on the CPU. Several point sets that share a
plan (Groth16's a/b1/l queries) go through one plan as a leading query
axis, and all windows of all queries share each kernel launch.

Safety: the accumulation walk may use the doubling-free mixed add, which
raises a collision flag if a bucket's partial sum ever equals the
incoming point; the caller then reruns with the complete add
(msm_sorted_host).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..fields.jfield import field_spec
from ..fields.jfield2 import small_beta
from ..fields.limbs import LIMB_BITS
from .pallas_field import _double_inline, _general_add, _mixed_add_inline, field_for

# launches of each CUDA kernel, counted by its wrapper (plain-version runs
# on CPU tensors are not launches), and the same by (kernel, 32-bit limbs
# of the instantiation launched)
LAUNCHES: Counter = Counter()
WIDTH_LAUNCHES: Counter = Counter()


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MSMConfig:
    """Shape parameters of one MSM instantiation.

    c must divide LIMB_BITS. M1 is the accumulation-walk lane count per
    window (must divide the padded point count), R the walk granularity
    the record capacities round to (the reference's points per grid step),
    lw2 the lanes per window of the record-merge and suffix walks."""

    c: int = 16
    M1: int = 1024
    R: int = 4
    lw2: int = 64

    @property
    def hb(self) -> int:
        return 1 << (self.c - 1)


def default_config(n: int) -> MSMConfig:
    """The reference's configurations: small shapes up to 2^12 points, else
    c=8 digits (a 2^7-bucket table) with 1024 walk lanes per window up to
    2^17, c=16 above."""
    if n <= (1 << 12):
        return MSMConfig(c=8, M1=32, R=2, lw2=8)
    if n <= (1 << 17):
        return MSMConfig(c=8, M1=1024, R=4, lw2=128)
    return MSMConfig(c=16, M1=1024, R=4, lw2=128)


def _windows(r_mod: int, c: int) -> int:
    """Window count for scalars < r_mod with c-bit signed digits (the
    carry out of the top window must be representable)."""
    bits = (r_mod - 1).bit_length()
    w = -(-bits // c)
    top = (r_mod - 1) >> (c * (w - 1))
    if top + 1 >= (1 << (c - 1)):
        w += 1
    return w


def _rows_per_coord(p: int, beta) -> int:
    nl = field_spec(p).nl
    return nl if beta is None else 2 * nl


# ---------------------------------------------------------------------------
# Kernels: plain versions and wrappers
# ---------------------------------------------------------------------------


def _coords(rows: torch.Tensor, en: int, nl: int, beta):
    """(k*en, L) int32 limb rows -> k coordinates as (L, nl) / (L, 2, nl) int64."""
    L = rows.shape[-1]
    t = rows.to(torch.int64).T
    out = []
    for i in range(rows.shape[0] // en):
        c = t[:, i * en : (i + 1) * en]
        out.append(c if beta is None else c.reshape(L, 2, nl))
    return out


def _rows(coords, L: int) -> torch.Tensor:
    """Coordinates (L, ...) int64 -> (k*en, L) int32 limb rows."""
    return torch.cat([c.reshape(L, -1) for c in coords], dim=1).T.to(torch.int32)


def walk_plain(q, flags, p: int, mode: str, safe: bool, beta=None):
    """Plain version of the walk kernel (one position at a time, all
    lanes at once). Same arguments and results as walk()."""
    F = field_for(p, beta)
    nl = field_spec(p).nl
    en = _rows_per_coord(p, beta)
    K, _, L = q.shape
    zero = F.zeros((L,), q.device)
    X, Y, Z = zero, zero, zero
    coll = torch.zeros(L, dtype=torch.bool, device=q.device)
    out = torch.empty((K, 3 * en, L), dtype=torch.int32, device=q.device)
    for k in range(K):
        fl = flags[k]
        skip = (fl & 2) != 0
        if mode == "mixed":
            Qx, Qy = _coords(q[k], en, nl, beta)
            nX, nY, nZ, is_dbl = _mixed_add_inline(F, (X, Y, Z), Qx, Qy, with_double=safe)
            if not safe:
                coll |= is_dbl & ~skip
        else:
            nX, nY, nZ = _general_add(F, (X, Y, Z), tuple(_coords(q[k], en, nl, beta)))
        X = F.select(skip, X, nX)
        Y = F.select(skip, Y, nY)
        Z = F.select(skip, Z, nZ)
        out[k] = _rows((X, Y, Z), L)
        Z = F.select((fl & 1) != 0, zero, Z)
    return out, coll.to(torch.int32)


# the walk and suffix kernels' grids aim at this many threads where the
# lanes alone fall short: about one block of 128 on each of an H100's 132
# SMs. Smaller walk sub-chunks give more threads but longer idle spans in
# each warp (its threads' ranges start and end unevenly); twice the
# suffix threads (two blocks an SM, shorter chains) take longer at both
# widths. chip_smoke.py's sweeps of S on the h16 walks and of k on the
# h16 suffix time the trade.
FILL_THREADS = 1 << 14


def walk_split(K: int, L: int) -> int:
    """Positions per sub-chunk S of the walk kernel for K positions on L
    lanes: K where the lanes alone give FILL_THREADS threads (one
    thread per lane), else the smallest S that cuts a lane into at most
    ceil(FILL_THREADS / L) sub-chunks (and at most 65535, the grid's
    y limit). The kernel runs one thread per (lane, sub-chunk)."""
    if K <= 1 or L >= FILL_THREADS:
        return max(K, 1)
    nsub = min(-(-FILL_THREADS // L), K, 65535)
    return -(-K // nsub)


def walk_owners(flags, S: int, qinf=None) -> np.ndarray:
    """Replay of the walk kernel's ownership rule (csrc/msm_sorted.cu).

    flags: (K, L) walk flags (bit0 flush after, bit1 skip); qinf: (K, L)
    bool, for the complete-add walk, where the incoming point is at
    infinity (the add then returns the accumulator, as a skip does). A
    position is effective if it is neither; a start is position 0, or an
    effective position with a flush after the lane's last effective
    position before it (or none before it). The thread of sub-chunk t owns
    the starts in [tS, (t+1)S) and walks from the first of them to the
    first start at or after (t+1)S (or K). Returns (T, L, 2) int64
    ranges [a, b) for T = ceil(K/S) sub-chunks, a == b where the thread
    writes nothing."""
    flags = np.asarray(flags)
    K, L = flags.shape
    eff = (flags & 2) == 0
    if qinf is not None:
        eff &= ~np.asarray(qinf, bool)
    flush = (flags & 1) != 0
    start = np.zeros((K, L), bool)
    reset = np.ones(L, bool)
    for k in range(K):
        start[k] = eff[k] & reset
        reset = np.where(flush[k], True, np.where(eff[k], False, reset))
    start[0] = True
    nxt = np.full((K + 1, L), K, dtype=np.int64)  # first start at or after k
    for k in range(K - 1, -1, -1):
        nxt[k] = np.where(start[k], k, nxt[k + 1])
    T = -(-K // S)
    out = np.zeros((T, L, 2), dtype=np.int64)
    for t in range(T):
        lo, hi = t * S, min((t + 1) * S, K)
        has = nxt[lo] < hi
        out[t, :, 0] = np.where(has, nxt[lo], lo)
        out[t, :, 1] = np.where(has, nxt[hi], lo)
    return out


# threads of a suffix block, which holds all k sub-chunks of its lanes
# (csrc/msm_sorted.cu's kSplitThreads; cuda.load checks that they agree)
SUFFIX_BLOCK = 128


def suffix_split(Lb: int, M: int) -> int:
    """Sub-chunks k of each lane's Lb positions in the suffix kernel on M
    lanes: the largest power of two that divides Lb with k <= SUFFIX_BLOCK
    and M*k <= FILL_THREADS; 1 (one thread a lane, no combine)
    where Lb < 2 or the lanes alone reach the target. The kernel runs one
    thread per (lane, sub-chunk)."""
    k = 1
    while Lb >= 2 and Lb % (2 * k) == 0 and 2 * k <= SUFFIX_BLOCK and 2 * k * M <= FILL_THREADS:
        k *= 2
    return k


def suffix_plain(a, b, p: int, beta=None, k: Optional[int] = None):
    """Plain version of the suffix kernel at k sub-chunks a lane (default
    suffix_split(Lb, M)). Same arguments and result as suffix().

    Sub-chunk j of a lane (positions [j*c, (j+1)*c), c = Lb/k) runs the
    sequential loop from the zero triple, all (sub-chunk, lane) columns at
    once, giving its sum a_j and sum of running sums u_j; _suffix_combine
    then replays the kernel's combine add for add. At k = 1 this is the
    sequential loop alone."""
    F = field_for(p, beta)
    nl = field_spec(p).nl
    en = _rows_per_coord(p, beta)
    Lb, R, M = a.shape
    k = suffix_split(Lb, M) if k is None else k
    if k < 1 or Lb % k or k & (k - 1):
        raise ValueError(f"suffix: k must be a power of two dividing Lb = {Lb}, got {k}")
    c = Lb // k

    def chunks(x):  # (Lb, R, M) -> (c, R, k*M), column j*M + m: sub-chunk j of lane m
        return x.reshape(k, c, R, M).permute(1, 2, 0, 3).reshape(c, R, k * M)

    a, b = chunks(a), chunks(b)
    zero = F.zeros((k * M,), a.device)
    acc = (zero, zero, zero)
    tot = acc
    for t in range(c):
        A = tuple(_coords(a[t], en, nl, beta))
        B = tuple(_coords(b[t], en, nl, beta))
        acc = _general_add(F, acc, _general_add(F, A, B))
        tot = _general_add(F, tot, acc)
    if k > 1:
        acc, tot = _suffix_combine(F, acc, tot, k, c, M)
    return _rows(acc + tot, M).contiguous()


def _suffix_combine(F, acc, tot, k: int, c: int, M: int):
    """The split suffix kernel's combine of a lane's sub-chunk sums: acc,
    tot hold (a_j, u_j) at rows j*M + m. An inclusive scan S_j = a_0 + ...
    + a_j by Hillis-Steele levels (S_j <- S_{j-d} + S_j for j >= d, d = 1,
    2, 4, ...); w_j = u_j + c*S_{j-1} for j >= 1 (c*S_{j-1} by the
    double-and-add ladder from infinity over c's bits), w_0 = u_0; then tot
    = sum_j w_j by the halving tree w_j <- w_j + w_{j+s}, s = k/2, ..., 1.
    Returns (S_{k-1}, tot) for the M lanes."""
    def rows(P, j0, j1):
        return tuple(x[j0 * M : j1 * M] for x in P)

    def cat(*parts):
        return tuple(torch.cat(xs) for xs in zip(*parts))

    S, d = acc, 1
    while d < k:
        S = cat(rows(S, 0, d), _general_add(F, rows(S, 0, k - d), rows(S, d, k)))
        d *= 2
    tmp = rows(S, 0, k - 1)
    one = F.ones_mont(((k - 1) * M,), tmp[0].device)
    res = (one, one.clone(), F.zeros(((k - 1) * M,), tmp[0].device))
    i = 0
    while c >> i:
        if (c >> i) & 1:
            res = _general_add(F, res, tmp)
        if c >> (i + 1):
            tmp = _double_inline(F, tmp)
        i += 1
    w = cat(rows(tot, 0, 1), _general_add(F, rows(tot, 1, k), res))
    s = k // 2
    while s >= 1:
        w = _general_add(F, rows(w, 0, s), rows(w, s, 2 * s))
        s //= 2
    return rows(S, k - 1, k), w


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor, got {getattr(t, 'dtype', type(t))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def walk(q, flags, p: int, mode: str, safe: bool, beta=None):
    """Segmented accumulation walk (CUDA kernel walk_kernel).

    q: (K, 2*en, L) affine [x|y] rows (mode "mixed") or (K, 3*en, L)
    Jacobian [X|Y|Z] rows (mode "general"); flags: (K, L), bit0 flush
    after the position, bit1 skip it. en = nl rows of 16-bit Montgomery
    limbs per Fq coordinate (16 for BN254, 24 for the BLS12 curves), 2*nl
    per Fq2 coordinate ([c0|c1], beta = the small negative non-residue).
    Returns the accumulator snapshot after every position (K, 3*en, L) and
    the per-lane collision flag (L,) (set only by the doubling-free mixed
    add, safe=False). All int32.
    CPU tensors take walk_plain; CUDA tensors launch the kernel at the
    field's width (cuda.NL32; another width raises), one thread per lane
    and sub-chunk of walk_split(K, L) positions (walk_owners)."""
    if mode not in ("mixed", "general"):
        raise ValueError(f"unknown walk mode {mode!r}")
    if mode == "general" and not safe:
        raise ValueError("the general walk always uses complete adds (safe=True)")
    beta = None if beta is None else small_beta(p, beta)
    en = _rows_per_coord(p, beta)
    K, _, L = q.shape
    _check("q", q, (K, (2 if mode == "mixed" else 3) * en, L), q.device)
    _check("flags", flags, (K, L), q.device)
    if q.device.type == "cpu":
        return walk_plain(q, flags, p, mode, safe, beta)
    if q.device.type != "cuda":
        raise ValueError(f"walk: unsupported device {q.device}")
    from . import cuda

    lib = cuda.load()
    nl32, pl, one, n0, babs = cuda.field_params(p, beta)
    out = torch.empty((K, 3 * en, L), dtype=torch.int32, device=q.device)
    coll = torch.zeros((L,), dtype=torch.int32, device=q.device)  # threads only set it
    if L == 0 or K == 0:
        return out, coll
    with torch.cuda.device(q.device):
        rc = (lib.zkt_msm_wide_walk if nl32 == 24 else lib.zkt_msm_walk)(
            q.data_ptr(), flags.data_ptr(), out.data_ptr(), coll.data_ptr(), K, L, walk_split(K, L),
            nl32, int(beta is not None), int(mode == "mixed"), int(safe), pl, one, n0, babs,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    cuda.check(rc, "walk")
    LAUNCHES["walk_" + mode] += 1
    WIDTH_LAUNCHES["walk_" + mode, nl32] += 1
    return out, coll


def suffix(a, b, p: int, beta=None):
    """Suffix walk over the 2-slot dense bucket table (CUDA kernels
    suffix_kernel and suffix_split_kernel, the reference's fold=False
    form).

    a, b: (Lb, 3*en, M) Jacobian rows, slot 0 and slot 1; lane m folds its
    Lb entries, in order, into a running sum acc and a sum of running sums
    tot. Returns (6*en, M) = [acc | tot], int32: the reference's group
    elements, in the Jacobian limbs of the association suffix_plain
    replays (k = suffix_split(Lb, M) sub-chunks a lane, combined by a
    scan). CPU tensors take suffix_plain; CUDA tensors launch the kernel,
    one thread per lane and sub-chunk."""
    beta = None if beta is None else small_beta(p, beta)
    en = _rows_per_coord(p, beta)
    Lb, _, M = a.shape
    _check("a", a, (Lb, 3 * en, M), a.device)
    _check("b", b, (Lb, 3 * en, M), a.device)
    if a.device.type == "cpu":
        return suffix_plain(a, b, p, beta)
    if a.device.type != "cuda":
        raise ValueError(f"suffix: unsupported device {a.device}")
    from . import cuda

    lib = cuda.load()
    nl32, pl, one, n0, babs = cuda.field_params(p, beta)
    out = torch.empty((6 * en, M), dtype=torch.int32, device=a.device)
    if M == 0:
        return out
    with torch.cuda.device(a.device):
        rc = (lib.zkt_msm_wide_suffix if nl32 == 24 else lib.zkt_msm_suffix)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), Lb, M, suffix_split(Lb, M), nl32, int(beta is not None),
            pl, one, n0, babs, torch.cuda.current_stream(a.device).cuda_stream,
        )
    cuda.check(rc, "suffix")
    LAUNCHES["suffix"] += 1
    WIDTH_LAUNCHES["suffix", nl32] += 1
    return out


def suffix_fold_plain(out6, p: int, W: int, lw: int, L: int, beta=None):
    """Plain version of the suffix epilogue kernel: the per-lane weighted
    combine (tot + base*acc with the static per-lane multiplier base =
    (lw-1-(lane%lw))*L) by a double-and-add ladder, then the lw-lane
    pairwise tree per window. Same arguments and result as suffix_fold()."""
    from .jec import CurveOps

    ops = CurveOps(field_for(p, beta))
    nl = field_spec(p).nl
    en = _rows_per_coord(p, beta)
    M = out6.shape[1]
    acc = tuple(_coords(out6[: 3 * en], en, nl, beta))
    tot = tuple(_coords(out6[3 * en :], en, nl, beta))
    mult = ((lw - 1) - (np.arange(M) % lw)) * L
    nbits = max(1, int(mult.max())).bit_length()
    res = ops.infinity((M,), out6.device)
    tmp = acc
    for k in range(nbits):
        bit = torch.as_tensor((mult >> k) & 1, dtype=torch.bool, device=out6.device)
        res = ops.select(bit, ops.add(res, tmp), res)
        if k + 1 < nbits:
            tmp = ops.double(tmp)
    lane_sum = ops.add(tot, res)
    Pt = tuple(a.reshape((W, lw) + a.shape[1:]) for a in lane_sum)
    s = lw
    while s > 1:
        s //= 2
        Pt = ops.add(tuple(a[:, :s] for a in Pt), tuple(a[:, s : 2 * s] for a in Pt))
    return tuple(a.reshape(W, en) for a in Pt)


def suffix_fold(out6, p: int, W: int, lw: int, L: int, beta=None):
    """Suffix epilogue (CUDA kernels fold_ladder_kernel and
    fold_tree_kernel; the reference's fold=True branch of the suffix
    kernel).

    out6: (6*en, W*lw) int32 [acc | tot] rows of the suffix walk, lanes
    [w*lw, (w+1)*lw) of window w, each lane covering L buckets; lw a power
    of two <= 1024. Returns window w's sum sum_i (tot_i + base_i*acc_i),
    base_i = (lw-1-i)*L, as Jacobian (W, en) int64 limb tensors X, Y, Z
    ([c0|c1] per Fq2 coordinate). CPU tensors take suffix_fold_plain; CUDA
    tensors launch the kernel (two passes: the ladders, one thread per
    lane, then each window's tree)."""
    beta = None if beta is None else small_beta(p, beta)
    en = _rows_per_coord(p, beta)
    if lw < 1 or lw > 1024 or lw & (lw - 1):
        raise ValueError(f"suffix_fold: lw must be a power of two <= 1024, got {lw}")
    if L < 1:
        raise ValueError(f"suffix_fold: L must be positive, got {L}")
    _check("out6", out6, (6 * en, W * lw), out6.device)
    if out6.device.type == "cpu":
        return suffix_fold_plain(out6, p, W, lw, L, beta)
    if out6.device.type != "cuda":
        raise ValueError(f"suffix_fold: unsupported device {out6.device}")
    from . import cuda

    lib = cuda.load()
    nl32, pl, one, n0, babs = cuda.field_params(p, beta)
    out = torch.empty((3, W, en), dtype=torch.int64, device=out6.device)
    if W == 0:
        return out[0], out[1], out[2]
    sums = torch.empty((3 * en, W * lw), dtype=torch.int32, device=out6.device)
    with torch.cuda.device(out6.device):
        rc = (lib.zkt_msm_wide_suffix_fold if nl32 == 24 else lib.zkt_msm_suffix_fold)(
            out6.data_ptr(), sums.data_ptr(), out.data_ptr(), W, lw, L, nl32, int(beta is not None), pl, one,
            n0, babs, torch.cuda.current_stream(out6.device).cuda_stream,
        )
    cuda.check(rc, "suffix_fold")
    LAUNCHES["suffix_fold"] += 1
    WIDTH_LAUNCHES["suffix_fold", nl32] += 1
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Plans (PyTorch)
# ---------------------------------------------------------------------------


def _signed_digits(scalars: torch.Tensor, W: int, c: int):
    """(N, nls) canonical 16-bit-limb scalars -> bucket ids (W, N) in
    [0, 2^(c-1)] (0 = skip) and sign bits (W, N) in {0, 1}, int64."""
    N, nls = scalars.shape
    s = scalars.to(torch.int64)
    mask, half, full = (1 << c) - 1, 1 << (c - 1), 1 << c
    carry = torch.zeros(N, dtype=torch.int64, device=s.device)
    buckets, signs = [], []
    for w in range(W):
        limb = (w * c) // LIMB_BITS
        sh = (w * c) % LIMB_BITS
        raw = (s[:, limb] >> sh) & mask if limb < nls else torch.zeros_like(carry)
        t = raw + carry
        neg = t >= half
        buckets.append(torch.where(neg, full - t, t))
        carry = neg.to(torch.int64)
        signs.append(carry)
    return torch.stack(buckets), torch.stack(signs)


def _plan_shapes(N: int, W: int, cfg: MSMConfig):
    hb = cfg.hb
    M1, R, lw2 = cfg.M1, cfg.R, cfg.lw2
    K1 = N // M1
    if K1 * M1 != N or K1 % R:
        raise ValueError(f"point count {N} is not a multiple of M1*R = {M1 * R}")
    step = lw2 * R
    cap1 = -(-(min(N, hb + M1)) // step) * step
    if cap1 > N:
        # compaction would pad with position 0 and could take its record
        # twice (the reference has no such check)
        raise ValueError(f"record capacity {cap1} exceeds the {N} sorted positions (lw2*R = {step})")
    return dict(hb=hb, K1=K1, cap1=cap1, cap2=cap1, L4=hb // lw2)


def _compact_positions(valid: torch.Tensor, cap: int) -> torch.Tensor:
    """valid (W, Ncols) bool -> (W, cap) positions of True (ascending),
    padded with positions of False entries. Cumsum-rank scatter (O(N)):
    True j lands at its rank among Trues, False j after all Trues at its
    rank among Falses. The ranks are a permutation of each row, so the
    scatter fills a full row and slots >= cap are cut off (the JAX
    version drops them with mode="drop")."""
    Wn, Ncols = valid.shape
    v = valid.to(torch.int64)
    rank_t = torch.cumsum(v, dim=1) - v
    n_true = rank_t[:, -1:] + v[:, -1:]
    rank_f = torch.cumsum(1 - v, dim=1) - (1 - v)
    slot = torch.where(valid, rank_t, n_true + rank_f)
    g = torch.arange(Ncols, device=valid.device).expand(Wn, Ncols)
    out = torch.zeros((Wn, max(Ncols, cap)), dtype=torch.int64, device=valid.device)
    out.scatter_(1, slot, g)
    return out[:, :cap]


def _walk_flags(sorted_keys: torch.Tensor, chunk: int):
    """Flush/skip flags for a walk over per-window sorted key rows (W,
    Ncols), key 0 = skip: flush when the key changes, at each chunk end,
    and at the row end. Returns (int32 flags, bool valid-record mask)."""
    Wn, Ncols = sorted_keys.shape
    nxt = torch.cat(
        [sorted_keys[:, 1:], torch.zeros((Wn, 1), dtype=sorted_keys.dtype, device=sorted_keys.device)],
        dim=1,
    )
    g = torch.arange(Ncols, device=sorted_keys.device)
    flush = (sorted_keys != nxt) | ((g % chunk) == (chunk - 1))[None, :]
    skip = sorted_keys == 0
    flags = flush.to(torch.int32) | (skip.to(torch.int32) << 1)
    return flags, flush & ~skip


def _to_walk(arr: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """(G, M*K, width) per-group rows -> walk layout (K, width, G*M), where
    lane g*M + m owns rows [m*K, (m+1)*K) of group g."""
    G, _, width = arr.shape
    return arr.reshape(G, M, K, width).permute(2, 3, 0, 1).reshape(K, width, G * M).contiguous()


def _flags_to_walk(flags: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """Per-sorted-position flags (G, M*K) -> walk input (K, G*M)."""
    G = flags.shape[0]
    return flags.reshape(G, M, K).permute(2, 0, 1).reshape(K, G * M).contiguous()


def _take_records(O: torch.Tensor, pos: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """Walk output (K, width, G*M) -> (G, cap, width) snapshot rows at the
    per-group positions pos (G, cap): position j of group g was walked
    by lane g*M + j//K at step j%K."""
    lane = torch.arange(pos.shape[0], device=pos.device)[:, None] * M + pos // K
    return O[pos % K, :, lane]


def _merge_level(p, recs, rbuck, cap_out: int, lw2: int, beta=None):
    """One record-merge walk level: (G, cap_in, 3en) records sorted by
    bucket per group (bucket 0 = pad) -> (G, cap_out, 3en), new buckets."""
    G, cap_in, _ = recs.shape
    K2 = cap_in // lw2
    flags, valid = _walk_flags(rbuck, K2)
    O, _ = walk(_to_walk(recs, lw2, K2), _flags_to_walk(flags, lw2, K2), p, "general", True, beta)
    gpos = _compact_positions(valid, cap_out)
    new_buck = torch.where(valid.gather(1, gpos), rbuck.gather(1, gpos), 0)
    return _take_records(O, gpos, lw2, K2), new_buck


def _msm_plan(W: int, N: int, cfg: MSMConfig, scalars: torch.Tensor, Ks: Optional[int] = None):
    """Scalar-only part of the sorted MSM: signed digits, per-window stable
    sort, walk flags, record compaction positions and record buckets.
    Point-independent, so MSMs over different point sets with the same
    scalars share one plan.

    Ks < N gives a SPARSE plan: the sort puts bucket 0 (zero digits) first,
    so every nonzero digit lives in the LAST nnz(w) sorted positions — if
    max_w nnz(w) <= Ks, walking only the last Ks positions is exact."""
    Ks = N if Ks is None else Ks
    sb, sidx = _sorted_keys(W, N, cfg, scalars)
    return _plan_finish(W, cfg, sb[:, N - Ks :], sidx[:, N - Ks :])


def _sorted_keys(W: int, N: int, cfg: MSMConfig, scalars: torch.Tensor):
    """Per-window buckets sorted ascending (stable) and the payload
    point index | sign << 31, int64."""
    buckets, signs = _signed_digits(scalars, W, cfg.c)
    idx = torch.arange(N, device=scalars.device).expand(W, N)
    payload = idx | (signs << 31)
    sb, order = torch.sort(buckets, dim=1, stable=True)
    return sb, payload.gather(1, order)


def _plan_finish(W: int, cfg: MSMConfig, sb, sidx):
    sh = _plan_shapes(sb.shape[1], W, cfg)
    flags2d, valid = _walk_flags(sb, sh["K1"])
    gpos = _compact_positions(valid, sh["cap1"])
    rec_buck = torch.where(valid.gather(1, gpos), sb.gather(1, gpos), 0)
    return sidx, flags2d, gpos, rec_buck


def shared_window_count(r_mod: int, c: int = 16) -> int:
    """Window count for the shared-bucket fixed-base form (see
    _msm_plan_shared)."""
    return _windows(r_mod, c)


def _msm_plan_shared(Wc: int, N: int, cfg: MSMConfig, scalars):
    """Shared-bucket fixed-base plan: one stable sort over all (window,
    point) pairs.

    For fixed bases (the Groth16 h query) the proving key can store the
    pre-shifted copies 2^(c*w) * P_j; every window's digits then fall into
    ONE shared bucket space, so the whole Wc-window MSM is a single-window
    walk over Wc*N sorted slots with one suffix and epilogue over 2^(c-1)
    buckets, and no window combine (the shifts live in the bases).

    scalars: (N, nls) canonical limbs. Returns a plan for _msm_from_plan
    with W = 1 and a point array of Wc*N packed rows, row w*N + j holding
    2^(c*w) * P_j."""
    buckets, signs = _signed_digits(scalars, Wc, cfg.c)                # (Wc, N)
    idx = torch.arange(Wc * N, device=scalars.device).reshape(Wc, N)  # rows w*N + j
    payload = (idx | (signs << 31)).reshape(1, Wc * N)
    sb, order = torch.sort(buckets.reshape(1, Wc * N), dim=1, stable=True)
    return _plan_finish(1, cfg, sb, payload.gather(1, order))


def _msm_plan_split(W: int, N: int, cfg: MSMConfig, scalars, w0: int, Ks: int):
    """Two-group sparse plan: windows [0, w0) walk all N sorted positions,
    windows [w0, W) only the last Ks (the caller guarantees nnz(w) <= Ks
    for w >= w0). Returns (dense_plan, sparse_plan), either None when its
    group is empty."""
    sb, sidx = _sorted_keys(W, N, cfg, scalars)
    pd = _plan_finish(w0, cfg, sb[:w0], sidx[:w0]) if w0 > 0 else None
    ps = _plan_finish(W - w0, cfg, sb[w0:, N - Ks :], sidx[w0:, N - Ks :]) if w0 < W else None
    return pd, ps


def _msm_from_plan(p: int, W: int, cfg: MSMConfig, P128: torch.Tensor, plan, safe: bool,
                   beta=None, mark=None):
    """Point part of the sorted MSM over a precomputed plan.

    P128: (Q, N, packed_width(en)) int32 packed rows of Q point sets
    sharing the plan.
    Returns ((Q, W, en) int64 Jacobian window sums X, Y, Z in Montgomery
    limbs, collision flag as a 0-dim tensor). mark(label), if given, is
    called after the walks, the suffix kernel and the suffix epilogue."""
    mark = mark or (lambda label: None)
    beta = None if beta is None else small_beta(p, beta)
    en = _rows_per_coord(p, beta)
    sidx, flags2d, gpos, rec_buck = plan
    Q = P128.shape[0]
    G = Q * W
    Ks = sidx.shape[1]
    sh = _plan_shapes(Ks, W, cfg)
    hb, K1, cap1, L4 = sh["hb"], sh["K1"], sh["cap1"], sh["L4"]
    M1, lw2 = cfg.M1, cfg.lw2

    # gather the sorted affine points, negated y where the digit is negative
    pidx = sidx & 0x7FFFFFFF
    neg = (sidx >> 31).bool()[None, :, :, None]
    rows = P128[:, :, : 3 * en][:, pidx]                    # (Q, W, Ks, 3en)
    pts = torch.cat([rows[..., :en], torch.where(neg, rows[..., 2 * en :], rows[..., en : 2 * en])], -1)
    flags = flags2d.repeat(Q, 1)
    O1, coll = walk(
        _to_walk(pts.reshape(G, Ks, 2 * en), M1, K1), _flags_to_walk(flags, M1, K1),
        p, "mixed", safe, beta,
    )
    recs = _take_records(O1, gpos.repeat(Q, 1), M1, K1)    # (G, cap1, 3en)
    rbuck = rec_buck.repeat(Q, 1)

    # Merge until the provable per-bucket record bound reaches <= 2 (the
    # dense table has 2 slots). After walk 1 a bucket's run spans at most
    # ceil((Ks-1)/K1)+1 (<= M1) lanes -> that many records; each merge level
    # (lanes own K2 = cap/lw2 consecutive records) shrinks a run of R_b
    # records to at most ceil((R_b-1)/K2)+1.
    K2 = cap1 // lw2
    if K2 < 2:
        raise ValueError(f"merge walk needs >= 2 records per lane (cap {cap1}, lw2 {lw2})")
    bound = min(M1, -(-(Ks - 1) // K1) + 1)
    recs, rbuck = _merge_level(p, recs, rbuck, cap1, lw2, beta)
    bound = -(-(bound - 1) // K2) + 1
    while bound > 2:
        recs, rbuck = _merge_level(p, recs, rbuck, cap1, lw2, beta)
        bound = -(-(bound - 1) // K2) + 1
    mark("walks")

    # 2-slot dense table, built as an index scatter + one row gather. Bucket
    # b of group g, slot s sits at s*G*hb + g*hb + (hb - b): descending order.
    cap2 = recs.shape[1]
    prev = torch.cat([torch.zeros((G, 1), dtype=rbuck.dtype, device=rbuck.device), rbuck[:, :-1]], 1)
    slot = ((rbuck == prev) & (rbuck != 0)).to(torch.int64)
    gi = torch.arange(G, device=rbuck.device)[:, None]
    dense_pos = slot * (G * hb) + gi * hb + (hb - rbuck)
    # padding records (bucket 0) go to one dump slot past the table
    pos = torch.where(rbuck != 0, dense_pos, 2 * G * hb).reshape(-1)
    ridx = torch.full((2 * G * hb + 1,), G * cap2, dtype=torch.int64, device=rbuck.device)
    ridx.scatter_(0, pos, torch.arange(G * cap2, device=rbuck.device))
    recs_pad = torch.cat([recs.reshape(G * cap2, 3 * en), recs.new_zeros((1, 3 * en))])
    table = recs_pad[ridx[:-1]]
    A = _to_walk(table[: G * hb].reshape(G, hb, 3 * en), lw2, L4)
    B = _to_walk(table[G * hb :].reshape(G, hb, 3 * en), lw2, L4)
    out6 = suffix(A, B, p, beta)
    mark("suffix")
    wX, wY, wZ = suffix_fold(out6, p, G, lw2, L4, beta)
    mark("suffix_post")
    return tuple(t.reshape(Q, W, en) for t in (wX, wY, wZ)), coll.max()


# ---------------------------------------------------------------------------
# Host-side combine and full-MSM API
# ---------------------------------------------------------------------------


def _host_jac_double(p, P):
    X1, Y1, Z1 = P
    if Z1 == 0:
        return P
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = B * B % p
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
    E = 3 * A % p
    F = E * E % p
    X3 = (F - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y1 * Z1 % p
    return (X3, Y3, Z3)


def _host_jac_add(p, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    if U1 == U2:
        if S1 == S2:
            return _host_jac_double(p, P)
        return (1, 1, 0)
    H = (U2 - U1) % p
    Rr = (S2 - S1) % p
    H2 = 2 * H % p
    I = H2 * H2 % p
    J = H * I % p
    R2 = 2 * Rr % p
    V = U1 * I % p
    X3 = (R2 * R2 - J - 2 * V) % p
    Y3 = (R2 * (V - X3) - 2 * S1 * J) % p
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % p * H % p
    return (X3, Y3, Z3)


def _f2mul(p, beta, a, b):
    t0 = a[0] * b[0] % p
    t1 = a[1] * b[1] % p
    return ((t0 + beta * t1) % p, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % p)


def _f2addn(p, *xs):
    return (sum(x[0] for x in xs) % p, sum(x[1] for x in xs) % p)


def _f2sub(p, a, b):
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def _f2scale(p, k, a):
    return (k * a[0] % p, k * a[1] % p)


def _host_jac_double2(p, beta, P):
    X1, Y1, Z1 = P
    if Z1 == (0, 0):
        return P
    m = lambda a, b: _f2mul(p, beta, a, b)
    A = m(X1, X1)
    B = m(Y1, Y1)
    C = m(B, B)
    t = _f2addn(p, X1, B)
    D = _f2scale(p, 2, _f2sub(p, _f2sub(p, m(t, t), A), C))
    E = _f2scale(p, 3, A)
    F = m(E, E)
    X3 = _f2sub(p, F, _f2scale(p, 2, D))
    Y3 = _f2sub(p, m(E, _f2sub(p, D, X3)), _f2scale(p, 8, C))
    Z3 = _f2scale(p, 2, m(Y1, Z1))
    return (X3, Y3, Z3)


def _host_jac_add2(p, beta, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1 == (0, 0):
        return Q
    if Z2 == (0, 0):
        return P
    m = lambda a, b: _f2mul(p, beta, a, b)
    Z1Z1 = m(Z1, Z1)
    Z2Z2 = m(Z2, Z2)
    U1 = m(X1, Z2Z2)
    U2 = m(X2, Z1Z1)
    S1 = m(m(Y1, Z2), Z2Z2)
    S2 = m(m(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _host_jac_double2(p, beta, P)
        return ((1, 0), (1, 0), (0, 0))
    H = _f2sub(p, U2, U1)
    Rr = _f2sub(p, S2, S1)
    H2 = _f2scale(p, 2, H)
    I = m(H2, H2)
    J = m(H, I)
    R2 = _f2scale(p, 2, Rr)
    V = m(U1, I)
    X3 = _f2sub(p, _f2sub(p, m(R2, R2), J), _f2scale(p, 2, V))
    Y3 = _f2sub(p, m(R2, _f2sub(p, V, X3)), _f2scale(p, 2, m(S1, J)))
    Z3 = m(_f2sub(p, _f2sub(p, m(_f2addn(p, Z1, Z2), _f2addn(p, Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def _limbs_to_int(row) -> int:
    v = 0
    for i in range(len(row) - 1, -1, -1):
        v = (v << LIMB_BITS) | int(row[i])
    return v


def combine_windows(p, r_mod, wXYZ, W: int, c: int, beta=None, native: bool = True):
    """Window sums ((W, en) Montgomery limb arrays) -> host Jacobian ints
    sum_w 2^(c*w) S_w, canonical (Fq2 coordinates as (c0, c1) pairs).

    Runs in the native C backend when it is available and native=True; the
    Python loop is the fallback and the cross-check oracle."""
    from ..native import field_for as _native_field

    wX, wY, wZ = (np.asarray(a).astype(np.uint32) for a in wXYZ)
    nf = _native_field(p, beta) if native else None
    if nf is not None:
        if beta is not None:
            return nf.combine_windows2(wX[:W], wY[:W], wZ[:W], W, c)
        return nf.combine_windows(wX[:W], wY[:W], wZ[:W], W, c)
    spec = field_spec(p)
    rinv = pow(spec.r, -1, p)
    if beta is not None:
        nlb = spec.nl

        def dec2(row):
            return (_limbs_to_int(row[:nlb]) * rinv % p, _limbs_to_int(row[nlb:]) * rinv % p)

        acc = ((1, 0), (1, 0), (0, 0))
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                acc = _host_jac_double2(p, beta, acc)
            acc = _host_jac_add2(p, beta, acc, (dec2(wX[w]), dec2(wY[w]), dec2(wZ[w])))
        return acc
    acc = (1, 1, 0)
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            acc = _host_jac_double(p, acc)
        pt = tuple(_limbs_to_int(a[w]) * rinv % p for a in (wX, wY, wZ))
        acc = _host_jac_add(p, acc, pt)
    return acc


def msm_sorted_host(p, r_mod, P128, scalars, cfg: Optional[MSMConfig] = None,
                    max_bits: Optional[int] = None, beta=None):
    """Full sorted MSM: device plan + walks + host window combine.

    P128: (N, packed_width(en)) int32 packed points [x|y|-y|pad] in
    Montgomery limbs (G2 rows pack each Fq2 coordinate as [c0 limbs | c1
    limbs]).
    scalars: (N, nls) canonical limbs. Returns host Jacobian ints (X, Y, Z),
    canonical — Fq2 coordinates as (c0, c1) pairs when beta is given.

    Runs the doubling-free walk first and, if any lane flagged a bucket
    sum equal to its incoming point, reruns with the complete add."""
    N = P128.shape[0]
    cfg = cfg or default_config(N)
    W = _windows(r_mod, cfg.c)
    if max_bits is not None:
        W = min(W, -(-max_bits // cfg.c) + 1)
    plan = _msm_plan(W, N, cfg, scalars)
    out, coll = _msm_from_plan(p, W, cfg, P128[None], plan, False, beta)
    if int(coll):
        out, _ = _msm_from_plan(p, W, cfg, P128[None], plan, True, beta)
    return combine_windows(p, r_mod, tuple(a[0].cpu().numpy() for a in out), W, cfg.c, beta)


def packed_width(en: int) -> int:
    """Words of a packed point row for coordinates of en limbs: 128 where
    the three coordinates fit (BN254's rows, and the TPU's gather layout),
    else 3*en (BLS12 G2: 144; BW6-761 G1: 144)."""
    return max(128, 3 * en)


def pack_points(p, X, Y) -> torch.Tensor:
    """Montgomery limb tensors (N, nl) -> packed (N, packed_width(nl))
    int32 rows [x|y|-y|0-pad]."""
    from ..fields.jfield import field_ops

    f = field_ops(p)
    N = X.shape[0]
    pad = torch.zeros((N, packed_width(f.nl) - 3 * f.nl), dtype=torch.int64, device=X.device)
    return torch.cat([X, Y, f.neg(Y), pad], dim=1).to(torch.int32)


def pack_points_g2(p, X, Y) -> torch.Tensor:
    """Montgomery limb tensors (N, 2, nl) Fq2 coords -> packed (N,
    packed_width(2*nl)) int32 rows [x.c0|x.c1|y.c0|y.c1|-y.c0|-y.c1|0-pad]:
    128 words for BN254, 144 for the BLS12 curves."""
    from ..fields.jfield import field_ops

    f = field_ops(p)
    N = X.shape[0]
    nl = f.nl
    pad = torch.zeros((N, packed_width(2 * nl) - 6 * nl), dtype=torch.int64, device=X.device)
    return torch.cat(
        [X.reshape(N, 2 * nl), Y.reshape(N, 2 * nl), f.neg(Y).reshape(N, 2 * nl), pad], dim=1
    ).to(torch.int32)
