"""Device-resident R1CS: the COO constraint matrices of the QAP.

The counterpart of the JAX package's ir/r1cs_device.py. The matrices live
on the device as row-sorted COO tensors with Montgomery coefficients; the
prover's matvec (schemes/groth16._h_stage) takes one of two forms:

  * COO (the CPU):  gather z[col] -> Montgomery mul by coeff -> per-limb
    segment sum (lazy: 16-bit-limb products summed without carries) ->
    one reduce_wide per output row;
  * the mulacc walk (a CUDA device): the layout of build_mulacc_walk,
    walked by the mulacc_walk kernel (kernels/pallas_field.py), which
    gathers z, multiplies and accumulates each row's run of records in
    one pass and writes each run's lazy sum to its flush slot.

The instance-binding rows ark appends (A[nc + j] = z_j, binding public
inputs into the A polynomial) are ordinary COO entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..fields import params as P
from ..fields.jfield import field_ops
from ..fields.limbs import ints_to_limbs, n_limbs
from .r1cs import R1CS

# Row-term bound of the lazy column sums. The JAX package sums 16-bit
# limbs in uint32 and keeps a factor 2 of headroom below 2^16 terms; the
# same bound holds here although int64 sums would allow more.
MAX_ROW_TERMS = 1 << 15


@dataclass
class COOMatrix:
    rows: torch.Tensor  # (nnz,) int64, sorted ascending
    cols: torch.Tensor  # (nnz,) int64
    coeff: torch.Tensor  # (nnz, nl) int64 Montgomery
    n_rows: int
    # numpy copies of rows, cols and coeff, for host-side planning (the
    # mulacc-walk layout)
    rows_np: np.ndarray = None
    cols_np: np.ndarray = None
    coeff_np: np.ndarray = None


def _to_coo(rows_py: List[List[Tuple[int, int]]], extra, n_rows: int, p: int, device) -> COOMatrix:
    f = field_ops(p)
    nl = n_limbs(p)
    r_idx: List[int] = []
    c_idx: List[int] = []
    coeffs: List[int] = []
    for r, row in enumerate(rows_py):
        if len(row) > MAX_ROW_TERMS:
            raise ValueError(
                f"constraint row {r} has {len(row)} terms (> {MAX_ROW_TERMS}); "
                "lazy limb accumulation would exceed its headroom"
            )
        for col, coef in row:
            r_idx.append(r)
            c_idx.append(col)
            coeffs.append(coef % p)
    for r, col, coef in extra:
        r_idx.append(r)
        c_idx.append(col)
        coeffs.append(coef % p)
    if not r_idx:  # degenerate: keep one zero entry so shapes are non-empty
        r_idx, c_idx, coeffs = [0], [0], [0]
    order = np.argsort(np.asarray(r_idx, dtype=np.int64), kind="stable")
    r_arr = np.asarray(r_idx, dtype=np.int64)[order]
    c_arr = np.asarray(c_idx, dtype=np.int64)[order]
    co = ints_to_limbs([coeffs[i] for i in order], nl).astype(np.int64)
    co_mont = f.to_mont(torch.as_tensor(co, device=device))
    return COOMatrix(
        torch.as_tensor(r_arr, device=device),
        torch.as_tensor(c_arr, device=device),
        co_mont,
        n_rows,
        rows_np=r_arr,
        cols_np=c_arr,
        coeff_np=co_mont.cpu().numpy(),
    )


@dataclass
class R1CSDevice:
    """The three COO matrices over the padded QAP domain (size n), with
    ark's instance-binding rows included in A."""

    curve: str
    n: int  # domain size (power of two >= nc + ni)
    num_instance: int
    num_witness: int
    A: COOMatrix
    B: COOMatrix
    C: COOMatrix

    @property
    def num_variables(self) -> int:
        return self.num_instance + self.num_witness

    @staticmethod
    def build(r1cs: R1CS, n: int, device="cuda") -> "R1CSDevice":
        p = P.SCALAR_FIELDS[r1cs.curve].p
        nc, ni = r1cs.num_constraints, r1cs.num_instance
        if n < nc + ni:
            raise ValueError(f"domain {n} smaller than {nc} constraints + {ni} instance rows")
        binding = [(nc + j, j, 1) for j in range(ni)]
        return R1CSDevice(
            curve=r1cs.curve,
            n=n,
            num_instance=ni,
            num_witness=r1cs.num_witness,
            A=_to_coo(r1cs.A, binding, n, p, device),
            B=_to_coo(r1cs.B, [], n, p, device),
            C=_to_coo(r1cs.C, [], n, p, device),
        )


@dataclass
class MulaccWalk:
    """Walk-layout plan of the fused 3-matrix sparse matvec
    (kernels/pallas_field.mulacc_walk). All index structure is
    circuit-static: the records are the row-sorted concatenation of the A,
    B, C COO entries with rows offset into disjoint blocks of 3n segments;
    lane m of M = S*128 owns records [m*K, (m+1)*K).

    At M = 1024 lanes (S = 8) cols, coeff_walk, flags_walk, pos and seg
    equal the reference's arrays; coeff_walk and flags_walk merge its
    trailing (S, 128) lane axes into one axis of M lanes (lane-minor) and
    flags_walk its (T, R) axes into K. The kernel reads cols_walk,
    coeff_packed, flags_walk and lane_base: flush i of the stream (record
    pos[i]) is lane m's flush i - lane_base[m]."""

    cols: torch.Tensor          # (Lp,) int64 gather indices into z
    coeff_walk: torch.Tensor    # (K, nl, M) int64 Montgomery coefficients
    flags_walk: torch.Tensor    # (K, M) int32 flush flags
    pos: torch.Tensor           # (P,) int64 flush positions in record space
    seg: torch.Tensor           # (P,) int64 segment (row) ids, sorted
    K: int
    R: int
    S: int
    n_rows: int                 # 3n
    cols_walk: torch.Tensor     # (K, M) int32: cols, lane-minor
    coeff_packed: torch.Tensor  # (K, nl/2, M) int32: coeff_walk as 32-bit limbs
    lane_base: torch.Tensor     # (M,) int32: slot of each lane's first flush
    n_records: int              # L, the records before the padding
    n_flush: int                # flushes before pos's padding (its pad slots hold 0)
    n_row_flush: int            # flushes of the 3n rows: the slots before seg reaches 3n
    n_cols: int                 # variables the walk reads: the largest column + 1

    @property
    def M(self) -> int:
        return self.S * 128


MULACC_R = 4
REFERENCE_LANES = 1024  # the reference's M = S*128 lanes, S = 8


def build_mulacc_walk(dev: "R1CSDevice", lanes: int = REFERENCE_LANES) -> MulaccWalk:
    """Build (and cache on dev, per lane count) the walk plan from the
    numpy COO sidecars, on dev's device. `lanes`: a power of two >= 1024
    (1024 is the reference's layout); K is ceil(L / lanes) rounded up to a
    multiple of R.

    Raises ValueError when a lane's K records could overflow the lazy
    sums: a flushed run sums at most K 16-bit-limb products per limb, and
    ereduce_wide takes sums below 2^31, so K is bounded by MAX_ROW_TERMS as
    rows are on the COO path. (The reference asserts no such bound.)"""
    if lanes < REFERENCE_LANES or lanes & (lanes - 1):
        raise ValueError(f"mulacc walk: {lanes} lanes, expected a power of two >= {REFERENCE_LANES}")
    cache = dev.__dict__.setdefault("_mulacc_walks", {})
    if lanes in cache:
        return cache[lanes]
    n = dev.n
    nl = dev.A.coeff_np.shape[1]
    rows = np.concatenate(
        [dev.A.rows_np, dev.B.rows_np + n, dev.C.rows_np + 2 * n]
    ).astype(np.int64)
    cols = np.concatenate([dev.A.cols_np, dev.B.cols_np, dev.C.cols_np])
    coeff = np.concatenate([dev.A.coeff_np, dev.B.coeff_np, dev.C.coeff_np])
    L = rows.shape[0]
    M = lanes
    R = MULACC_R
    K = -(-L // M)
    K = -(-K // R) * R
    if K > MAX_ROW_TERMS:
        raise ValueError(
            f"mulacc walk: {K} records per lane (> {MAX_ROW_TERMS}); "
            "lazy limb accumulation would exceed its headroom"
        )
    Lp = M * K
    rows_pad = np.concatenate([rows, np.full(Lp - L, 3 * n, np.int64)])
    cols_pad = np.concatenate([cols, np.zeros(Lp - L, cols.dtype)])
    coeff_pad = np.concatenate(
        [coeff, np.zeros((Lp - L, nl), coeff.dtype)]
    )  # zero coeff -> zero product at padded records

    # flush after record j when the row changes or j is its lane's last
    nxt = np.concatenate([rows_pad[1:], np.asarray([-1], np.int64)])
    flush = rows_pad != nxt
    j = np.arange(Lp)
    flush |= (j % K) == (K - 1)

    pos = np.nonzero(flush)[0]
    seg = rows_pad[pos]  # ascending (rows sorted, lanes contiguous)
    # pos ascends and lane m's records are [m*K, (m+1)*K): its flushes are
    # consecutive slots from the first flush at or after m*K (every lane
    # flushes at its last record)
    lane_base = np.searchsorted(pos, np.arange(M) * K)
    # pad the flush set to a multiple of 8192, as the reference does
    P = pos.shape[0]
    Pp = -(-P // 8192) * 8192
    pos = np.concatenate([pos, np.full(Pp - P, Lp - 1, np.int64)])
    seg = np.concatenate([seg, np.full(Pp - P, 3 * n, np.int64)])

    cw = coeff_pad.reshape(M, K, nl).transpose(1, 2, 0)  # (K, nl, M)
    packed = (cw[:, 0::2] | (cw[:, 1::2] << 16)).astype(np.uint32).view(np.int32)
    fl = flush.astype(np.int32).reshape(M, K).T          # (K, M)
    device = dev.A.rows.device

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a).astype(dtype), device=device)

    walk = MulaccWalk(
        cols=t(cols_pad, np.int64),
        coeff_walk=t(cw, np.int64),
        flags_walk=t(fl, np.int32),
        pos=t(pos, np.int64),
        seg=t(seg, np.int64),
        K=K,
        R=R,
        S=M // 128,
        n_rows=3 * n,
        cols_walk=t(cols_pad.reshape(M, K).T, np.int32),
        coeff_packed=t(packed, np.int32),
        lane_base=t(lane_base, np.int32),
        n_records=L,
        n_flush=P,
        n_row_flush=int(np.searchsorted(seg, 3 * n)),
        n_cols=int(cols.max()) + 1 if L else 0,
    )
    cache[lanes] = walk
    return walk
