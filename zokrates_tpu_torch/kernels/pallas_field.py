"""Jacobian EC formulas shared by the MSM kernels' plain versions and the
batched curve ops (kernels/jec.py).

The counterpart of the helpers in the JAX package's kernels/pallas_field.py
that its MSM walk and suffix kernels use: the row-list field helpers _F
and _F2 (here: the jfield / jfield2 op objects over (..., nl) and
(..., 2, nl) limb tensors, see field_for), the complete Jacobian add
_general_add, the mixed add _mixed_add_inline, and msm_sorted's doubling
_double_inline. The same formulas exist as __device__ functions in
csrc/field.cuh; both compute canonical residues in the same order, so the
CUDA kernels and their plain versions agree bit for bit.

Every formula is generic over a field object with mul/add/sub/select/
is_zero/zero_like/one_like (all curves here have a = 0).

Beside them, the counterparts of the reference's elementwise field
kernels: emul (its _emul_call / emul) and ereduce_wide (its _ereduce_call
/ ereduce_wide), CUDA kernels in csrc/field_elementwise.cu, each with its
plain version (emul_plain, ereduce_wide_plain: jfield's mul and
reduce_wide), which the wrapper runs only for tensors on the CPU; and the
sparse matvec's multiply-accumulate walk mulacc_walk (its _mulacc_call /
mulacc_walk, with the gathers around it: z in, the flushed runs' sums
out), CUDA kernel in csrc/mulacc.cu, plain version mulacc_walk_plain;
and the standalone point kernels over limb-major
(nl, N) int32 coordinates, mixed_add_lm (the complete mixed add) and
accumulate_lm (bucket accumulation by digit), CUDA kernels in
csrc/point_elementwise.cu, plain versions mixed_add_lm_plain and
accumulate_lm_plain (_mixed_add_inline with the doubling branch).
"""

from __future__ import annotations

from collections import Counter

import torch

from ..fields.jfield import field_ops, field_spec
from ..fields.jfield2 import field_ops2

# launches of each CUDA kernel, counted by its wrapper (plain-version runs
# on CPU tensors are not launches)
LAUNCHES: Counter = Counter()
# launches of emul, ereduce_wide, mulacc_walk and the point kernels by
# width: (kernel, 32-bit limbs) -> launches
WIDTH_LAUNCHES: Counter = Counter()
# elements a tile of csrc/field_elementwise.cu's emul_kernel by width in
# 32-bit limbs (its zkt_emul_tile(n32); kernels/cuda.load checks that they
# agree): 64 at 24 limbs keeps a block's buffers at 96 KB of shared memory
EMUL_TILE = {8: 128, 12: 128, 24: 64}


def field_for(p: int, beta=None):
    """Field ops for the base field (beta=None) or Fq2 (small beta < 0)."""
    return field_ops(p) if beta is None else field_ops2(p, beta)


def _double_inline(F, P):
    """Jacobian doubling (dbl-2009-l), valid for a=0 curves."""
    X1, Y1, Z1 = P
    A = F.mul(X1, X1)
    Bv = F.mul(Y1, Y1)
    C = F.mul(Bv, Bv)
    t = F.add(X1, Bv)
    D = F.sub(F.sub(F.mul(t, t), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    Fq = F.mul(E, E)
    X3 = F.sub(Fq, F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y1, Z1)
    Z3 = F.add(YZ, YZ)
    return X3, Y3, Z3


def _general_add(F, P1, P2):
    """Complete Jacobian + Jacobian addition."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    Z1Z1 = F.mul(Z1, Z1)
    Z2Z2 = F.mul(Z2, Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    R = F.sub(S2, S1)
    same_x = F.is_zero(H)
    same_y = F.is_zero(R)
    is_double = same_x & same_y
    is_cancel = same_x & ~same_y
    H2 = F.add(H, H)
    I = F.mul(H2, H2)
    J = F.mul(H, I)
    R2 = F.add(R, R)
    V = F.mul(U1, I)
    R2sq = F.mul(R2, R2)
    X3 = F.sub(F.sub(R2sq, J), F.add(V, V))
    S1J = F.mul(S1, J)
    Y3 = F.sub(F.mul(R2, F.sub(V, X3)), F.add(S1J, S1J))
    Zs = F.add(Z1, Z2)
    Z3 = F.mul(F.sub(F.sub(F.mul(Zs, Zs), Z1Z1), Z2Z2), H)
    dX, dY, dZ = _double_inline(F, P1)
    X3 = F.select(is_double, dX, X3)
    Y3 = F.select(is_double, dY, Y3)
    Z3 = F.select(is_double, dZ, Z3)
    Z3 = F.select(is_cancel, F.zero_like(Z3), Z3)
    X3 = F.select(q_inf, X1, F.select(p_inf, X2, X3))
    Y3 = F.select(q_inf, Y1, F.select(p_inf, Y2, Y3))
    Z3 = F.select(q_inf, Z1, F.select(p_inf, Z2, Z3))
    return X3, Y3, Z3


def _mixed_add_inline(F, cur, Qx, Qy, with_double: bool = True):
    """Mixed Jacobian+affine add. with_double=False skips the 7-mul doubling
    branch (the select condition is still computed and returned as a flag):
    when P1 == (Qx, Qy) the result is WRONG — callers must check the flag
    and fall back to the complete form."""
    X1, Y1, Z1 = cur
    p_inf = F.is_zero(Z1)
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(Qx, Z1Z1)
    S2 = F.mul(F.mul(Qy, Z1), Z1Z1)
    H = F.sub(U2, X1)
    R = F.sub(S2, Y1)
    same_x = F.is_zero(H)
    same_y = F.is_zero(R)
    is_double = same_x & same_y
    is_cancel = same_x & ~same_y
    H2 = F.add(H, H)
    I = F.mul(H2, H2)
    J = F.mul(H, I)
    R2 = F.add(R, R)
    V = F.mul(X1, I)
    R2sq = F.mul(R2, R2)
    X3 = F.sub(F.sub(R2sq, J), F.add(V, V))
    Y1J = F.mul(Y1, J)
    Y3 = F.sub(F.mul(R2, F.sub(V, X3)), F.add(Y1J, Y1J))
    Z3 = F.mul(F.add(Z1, Z1), H)
    if with_double:
        dX, dY, dZ = _double_inline(F, cur)
        X3 = F.select(is_double, dX, X3)
        Y3 = F.select(is_double, dY, Y3)
        Z3 = F.select(is_double, dZ, Z3)
    is_double = is_double & ~p_inf
    Z3 = F.select(is_cancel, F.zero_like(Z3), Z3)
    X3 = F.select(p_inf, Qx, X3)
    Y3 = F.select(p_inf, Qy, Y3)
    Z3 = F.select(p_inf, F.one_like(Z3), Z3)
    return X3, Y3, Z3, is_double


# ---------------------------------------------------------------------------
# Elementwise field kernels: plain versions and wrappers
# ---------------------------------------------------------------------------


def emul_plain(p: int, a, b):
    """Plain version of the emul kernel (jfield's mul; a (L, nl) b
    broadcasts over the batch). Same arguments and result as emul()."""
    return field_ops(p).mul(a, b)


def ereduce_wide_plain(p: int, t):
    """Plain version of the ereduce_wide kernel (jfield's reduce_wide).
    Same arguments and result as ereduce_wide()."""
    return field_ops(p).reduce_wide(t)


def _check_elems(name, t, nl: int, ndims):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
        raise TypeError(f"{name}: expected an int64 tensor, got {getattr(t, 'dtype', type(t))}")
    if t.dim() not in ndims or t.shape[-1] != nl:
        raise ValueError(f"{name}: expected {' or '.join(f'{d}-d' for d in ndims)} (..., {nl}) limbs, "
                         f"got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: limbs must be contiguous")


def _check_aligned(name, t, batch_stride: int):
    """The kernels read an element's words as 16-byte vectors."""
    if t.data_ptr() % 16 or batch_stride % 2:
        raise ValueError(f"{name}: elements must start on 16-byte boundaries")


def emul(p: int, a, b):
    """Elementwise Montgomery product a*b*R^-1 mod p (CUDA kernel
    emul_kernel, the reference's emul), over a field of 16, 24 or 48 16-bit
    limbs (8, 12 or 24 32-bit limbs on the card).

    a: (B, L, nl) int64 16-bit limbs with packed rows (any batch stride, so
    a[:, i] of a larger array is taken in place); b: (L, nl), shared by the
    batch, or (B, L, nl), with packed rows or one row for all (row stride 0:
    a constant expanded to (L, nl) is never copied). Canonical inputs give
    the canonical product, as a new (B, L, nl) tensor. CPU tensors take
    emul_plain; CUDA tensors launch the kernel."""
    nl = field_spec(p).nl
    _check_elems("a", a, nl, (3,))
    _check_elems("b", b, nl, (2, 3))
    B, L, _ = a.shape
    if b.shape[-2] != L or (b.dim() == 3 and b.shape[0] != B):
        raise ValueError(f"b: shape {tuple(b.shape)} does not match a's {tuple(a.shape)}")
    if b.device != a.device:
        raise ValueError(f"b: on {b.device}, expected {a.device}")
    if L > 1 and a.stride(1) != nl:
        raise ValueError("a: rows must be packed")
    if L > 1 and b.stride(-2) not in (0, nl):
        raise ValueError("b: rows must be packed or all one row (stride 0)")
    if a.device.type == "cpu":
        return emul_plain(p, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"emul: unsupported device {a.device}")
    from . import cuda

    a_bs = a.stride(0) if B > 1 else 0
    b_bs = b.stride(0) if b.dim() == 3 and B > 1 else 0
    b_rs = b.stride(-2) if L > 1 else nl
    _check_aligned("a", a, a_bs)
    _check_aligned("b", b, b_bs)
    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32)
    out = torch.empty((B, L, nl), dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = lib.zkt_emul(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L, a_bs, b_bs, b_rs, n32,
                          pl, one, n0, torch.cuda.current_stream(a.device).cuda_stream)
    cuda.check(rc, "emul")
    LAUNCHES["emul"] += 1
    WIDTH_LAUNCHES[("emul", n32)] += 1
    return out


def ereduce_wide(p: int, t):
    """Lazy column sums -> the sum mod p, canonical (CUDA kernel
    ereduce_kernel, the reference's ereduce_wide; ereduce_lane_kernel for
    up to one tile of elements).

    t: (B, L, nl) int64 contiguous, each word a nonnegative column sum below
    2^47 (the plain version's range) of 16-bit-limb residues. Returns a new
    (B, L, nl) tensor. CPU tensors take ereduce_wide_plain; CUDA tensors
    launch the kernel."""
    spec = field_spec(p)
    _check_elems("t", t, spec.nl, (3,))
    if not t.is_contiguous():
        raise ValueError("t: must be contiguous")
    if t.device.type == "cpu":
        return ereduce_wide_plain(p, t)
    if t.device.type != "cuda":
        raise ValueError(f"ereduce_wide: unsupported device {t.device}")
    from . import cuda

    _check_aligned("t", t, 0)
    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32_FIELD)
    out = torch.empty_like(t)
    if out.numel() == 0:
        return out
    with torch.cuda.device(t.device):
        rc = lib.zkt_ereduce_wide(t.data_ptr(), out.data_ptr(), t.numel() // spec.nl, n32,
                                  cuda.limbs32(spec.r2, n32), pl, one, n0,
                                  torch.cuda.current_stream(t.device).cuda_stream)
    cuda.check(rc, "ereduce_wide")
    LAUNCHES["ereduce_wide"] += 1
    WIDTH_LAUNCHES[("ereduce_wide", n32)] += 1
    return out


def _check_packed(name, t, dtype, shape):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{name}: expected a {dtype} tensor, got {getattr(t, 'dtype', type(t))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# Fused multiply-accumulate segment walk (sparse matvec)
# ---------------------------------------------------------------------------

# records per lane the kernel's 32-bit limb sums hold exactly:
# 2^16 * (2^16 - 1) < 2^32
MULACC_MAX_K = 1 << 16


def mulacc_walk_plain(p: int, Z_mont, walk):
    """Plain version of the mulacc_walk kernel: every record's product at
    once (jfield's mul), one cumulative sum over the record stream, and
    each flush's run as the difference of the sums at its flush and at the
    flush before it (a lane's first run starts after the previous lane's
    last flush). Same arguments and result as mulacc_walk()."""
    B, _, nl = Z_mont.shape
    K, M, nf = walk.K, walk.M, walk.n_flush
    coeff = walk.coeff_walk.permute(2, 0, 1).reshape(M * K, nl)  # record j = m*K + k
    run = field_ops(p).mul(Z_mont[:, walk.cols], coeff).cumsum(1)
    ends = run[:, walk.pos[:nf]]
    out = torch.zeros((B, walk.pos.numel(), nl), dtype=torch.int64, device=Z_mont.device)
    out[:, :nf] = ends
    out[:, 1:nf] -= ends[:, :-1]
    return out


def mulacc_walk(p: int, Z_mont, walk):
    """Sparse-matvec walk (CUDA kernel mulacc_kernel, the reference's
    mulacc_walk, with the gathers of z before it and of the flushed
    records after it fused in): lane m of proof b walks its K records in
    order; record j adds the Montgomery product coeff[j] * Z_mont[b,
    cols[j]] limb by limb, without carries, into the lane's 16-bit-limb
    accumulator, and a record flagged to flush writes the accumulator to
    its slot and resets it to 0. Slot i holds the lazy sum of the run that
    ends at record walk.pos[i]: what the reference's per-record snapshot
    holds there. Pad slots (i >= walk.n_flush) hold 0.

    Z_mont: (B, m, nl) int64 Montgomery witness values, canonical,
    contiguous, m at least walk.n_cols (the kernel reads z[col] unchecked);
    walk: ir/r1cs_device.MulaccWalk on the same device.
    Returns (B, P, nl) int64 lazy sums, P = walk.pos.numel(), each limb
    below 2^16 * K (K <= MULACC_MAX_K). CPU tensors take mulacc_walk_plain;
    CUDA tensors launch the kernel."""
    nl = field_spec(p).nl
    _check_elems("Z_mont", Z_mont, nl, (3,))
    if not Z_mont.is_contiguous():
        raise ValueError("Z_mont: must be contiguous")
    if Z_mont.shape[1] < walk.n_cols:
        raise ValueError(f"Z_mont: {Z_mont.shape[1]} variables, the walk reads {walk.n_cols}")
    K, M = walk.K, walk.M
    _check_packed("cols_walk", walk.cols_walk, torch.int32, (K, M))
    _check_packed("coeff_packed", walk.coeff_packed, torch.int32, (K, nl // 2, M))
    _check_packed("flags_walk", walk.flags_walk, torch.int32, (K, M))
    _check_packed("lane_base", walk.lane_base, torch.int32, (M,))
    if K > MULACC_MAX_K:
        raise ValueError(f"mulacc_walk: {K} records per lane, at most {MULACC_MAX_K}")
    for name in ("cols_walk", "coeff_packed", "flags_walk", "lane_base", "pos"):
        t = getattr(walk, name)
        if t.device != Z_mont.device:
            raise ValueError(f"walk.{name}: on {t.device}, expected {Z_mont.device}")
    if Z_mont.device.type == "cpu":
        return mulacc_walk_plain(p, Z_mont, walk)
    if Z_mont.device.type != "cuda":
        raise ValueError(f"mulacc_walk: unsupported device {Z_mont.device}")
    from . import cuda

    _check_aligned("Z_mont", Z_mont, 0)
    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32_FIELD)
    B, m, _ = Z_mont.shape
    out = torch.empty((B, walk.pos.numel(), nl), dtype=torch.int64, device=Z_mont.device)
    if B == 0:
        return out
    zp = torch.empty((B, m, n32), dtype=torch.int32, device=Z_mont.device)  # z as 32-bit limbs
    with torch.cuda.device(Z_mont.device):
        rc = lib.zkt_mulacc_walk(Z_mont.data_ptr(), zp.data_ptr(), m, walk.cols_walk.data_ptr(),
                                 walk.coeff_packed.data_ptr(),
                                 walk.flags_walk.data_ptr(), walk.lane_base.data_ptr(), out.data_ptr(), B, K, M,
                                 walk.n_records, walk.n_flush, out.shape[1], n32, pl, one, n0,
                                 torch.cuda.current_stream(Z_mont.device).cuda_stream)
    cuda.check(rc, "mulacc_walk")
    LAUNCHES["mulacc_walk"] += 2  # two kernels: z packed, then the walk
    WIDTH_LAUNCHES[("mulacc_walk", n32)] += 2
    return out


# ---------------------------------------------------------------------------
# Standalone point kernels over limb-major coordinates
# ---------------------------------------------------------------------------


def _lm_coords(t: torch.Tensor, nl: int) -> torch.Tensor:
    """(k*nl, N) int32 limb-major rows -> (k, N, nl) int64 elements."""
    return t.to(torch.int64).reshape(-1, nl, t.shape[-1]).permute(0, 2, 1)


def _lm_rows(c: torch.Tensor) -> torch.Tensor:
    """(..., N, nl) int64 elements -> (..., nl, N) int32 limb-major rows."""
    return c.transpose(-1, -2).to(torch.int32).contiguous()


def mixed_add_lm_plain(p: int, X, Y, Z, Qx, Qy, block: int = 256):
    """Plain version of the mixed_add_lm kernel: _mixed_add_inline with the
    doubling branch, over all N points at once. Same arguments and results
    as mixed_add_lm()."""
    nl = field_spec(p).nl
    P1 = tuple(_lm_coords(t, nl)[0] for t in (X, Y, Z))
    X3, Y3, Z3, _ = _mixed_add_inline(field_ops(p), P1, _lm_coords(Qx, nl)[0], _lm_coords(Qy, nl)[0])
    return _lm_rows(X3), _lm_rows(Y3), _lm_rows(Z3)


def _check_lm(name, t, rows: int, N: int, device):
    _check_packed(name, t, torch.int32, (rows, N))
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_block(block: int, N: int):
    if not 1 <= block <= 1024:
        raise ValueError(f"block must be in [1, 1024], got {block}")
    if N % block:
        raise ValueError(f"N={N} not a multiple of block={block}")


def mixed_add_lm(p: int, X, Y, Z, Qx, Qy, block: int = 256):
    """Complete mixed Jacobian + affine add over limb-major coordinates
    (CUDA kernel mixed_add_kernel, the reference's mixed_add_lm).

    X, Y, Z (Jacobian, Z = 0 at infinity) and Qx, Qy (affine): (nl, N)
    int32 rows of canonical 16-bit Montgomery limbs, contiguous, nl 16, 24
    or 48 (the kernel's 8, 12 or 24 32-bit limbs; another raises); N a
    multiple of block (the kernel's threads per block). Returns the sum as
    new (X, Y, Z), same layout: P at infinity gives (Qx, Qy, one), P == Q
    the doubling, P == -Q Z = 0. CPU tensors take mixed_add_lm_plain; CUDA
    tensors launch the kernel."""
    nl = field_spec(p).nl
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise ValueError(f"X: expected a ({nl}, N) tensor")
    N = X.shape[1]
    for name, t in (("X", X), ("Y", Y), ("Z", Z), ("Qx", Qx), ("Qy", Qy)):
        _check_lm(name, t, nl, N, X.device)
    _check_block(block, N)
    if X.device.type == "cpu":
        return mixed_add_lm_plain(p, X, Y, Z, Qx, Qy, block)
    if X.device.type != "cuda":
        raise ValueError(f"mixed_add_lm: unsupported device {X.device}")
    from . import cuda

    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32)
    out = torch.empty((3, nl, N), dtype=torch.int32, device=X.device)
    if N == 0:
        return out[0], out[1], out[2]
    with torch.cuda.device(X.device):
        rc = lib.zkt_mixed_add_lm(X.data_ptr(), Y.data_ptr(), Z.data_ptr(), Qx.data_ptr(), Qy.data_ptr(),
                                  out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), N, block, n32,
                                  pl, one, n0, torch.cuda.current_stream(X.device).cuda_stream)
    cuda.check(rc, "mixed_add_lm")
    LAUNCHES["mixed_add_lm"] += 1
    WIDTH_LAUNCHES[("mixed_add_lm", n32)] += 1
    return out[0], out[1], out[2]


def accumulate_lm_plain(p: int, digits, Qx, Qy, n_buckets: int = 16, block: int = 256):
    """Plain version of the accumulate_lm kernel: per step, every lane's
    bucket gathered by its digit, one _mixed_add_inline (with the doubling
    branch) for all lanes, and the sums written back where the digit names
    a bucket in [1, n_buckets). Same arguments and results as
    accumulate_lm()."""
    F = field_ops(p)
    nl = F.nl
    chunk_len, R = digits.shape
    d = digits.to(torch.int64) & 0xFFFFFFFF  # the reference's digits are uint32
    lane = torch.arange(R, device=digits.device)
    one = F.ones_mont((n_buckets, R), digits.device)
    B = [one, one.clone(), F.zeros((n_buckets, R), digits.device)]
    qx, qy = _lm_coords(Qx, nl), _lm_coords(Qy, nl)  # (chunk_len, R, nl)
    for t in range(chunk_len):
        hit = (d[t] >= 1) & (d[t] < n_buckets)
        b = torch.where(hit, d[t], 0)
        X3, Y3, Z3, _ = _mixed_add_inline(F, tuple(c[b, lane] for c in B), qx[t], qy[t])
        for c, new in zip(B, (X3, Y3, Z3)):
            c[b, lane] = F.select(hit, new, c[b, lane])
    return tuple(_lm_rows(c) for c in B)


def accumulate_lm(p: int, digits, Qx, Qy, n_buckets: int = 16, block: int = 256):
    """Bucket accumulation over limb-major points (CUDA kernel
    accumulate_kernel, the reference's accumulate_lm).

    digits: (chunk_len, R) int32, read as unsigned; Qx, Qy: (chunk_len*nl,
    R) int32 affine limb rows, step t's at rows [t*nl, (t+1)*nl), nl 16 or
    24 (another raises on a CUDA tensor); all
    contiguous, R a multiple of block. Lane j's buckets start as (one, one,
    0); step t mixed-adds (Qx, Qy)[t, j] into bucket digits[t, j] when that
    is in [1, n_buckets) and touches nothing otherwise. Returns the bucket
    tables X, Y, Z, each (n_buckets, nl, R) int32. CPU tensors take
    accumulate_lm_plain; CUDA tensors launch the kernel."""
    nl = field_spec(p).nl
    if not isinstance(digits, torch.Tensor) or digits.dim() != 2:
        raise ValueError("digits: expected a (chunk_len, R) tensor")
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be positive, got {n_buckets}")
    chunk_len, R = digits.shape
    _check_lm("digits", digits, chunk_len, R, digits.device)
    _check_lm("Qx", Qx, chunk_len * nl, R, digits.device)
    _check_lm("Qy", Qy, chunk_len * nl, R, digits.device)
    _check_block(block, R)
    if digits.device.type == "cpu":
        return accumulate_lm_plain(p, digits, Qx, Qy, n_buckets, block)
    if digits.device.type != "cuda":
        raise ValueError(f"accumulate_lm: unsupported device {digits.device}")
    from . import cuda

    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(p, None, cuda.NL32_FIELD)
    out = torch.empty((3, n_buckets, nl, R), dtype=torch.int32, device=digits.device)
    if R == 0:
        return out[0], out[1], out[2]
    with torch.cuda.device(digits.device):
        rc = lib.zkt_accumulate_lm(digits.data_ptr(), Qx.data_ptr(), Qy.data_ptr(), out[0].data_ptr(),
                                   out[1].data_ptr(), out[2].data_ptr(), chunk_len, R, n_buckets, block, n32,
                                   pl, one, n0, torch.cuda.current_stream(digits.device).cuda_stream)
    cuda.check(rc, "accumulate_lm")
    LAUNCHES["accumulate_lm"] += 1
    WIDTH_LAUNCHES[("accumulate_lm", n32)] += 1
    return out[0], out[1], out[2]
