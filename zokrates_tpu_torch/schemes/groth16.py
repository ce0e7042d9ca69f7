"""Groth16 setup / prove / verify on PyTorch, with the prover's kernels in
CUDA.

The counterpart of the JAX package's schemes/groth16.py, in its sorted-MSM
configuration on hardware:

  * setup evaluates the QAP at tau on the host (sparse integer sums) and
    produces every pk/vk group element with the batched fixed-base MSM
    (kernels/fixed_base.py); the pk stores points pre-packed in the MSM
    layout ((m, 128) uint32 rows [x|y|-y|pad], Montgomery 16-bit limbs),
    bit-equal to the JAX package's pk for the same randomness,
  * proving evaluates A·z / B·z / C·z with the fused multiply-accumulate
    walk on a CUDA device (the mulacc_walk kernel over the layout of
    ir/r1cs_device.build_mulacc_walk) and as COO sparse matvecs on the
    CPU, computes h(X) = (A·B - C)/Z with coset NTTs (kernels/ntt.py), its
    elementwise products and lazy-sum reductions in the kernels of
    kernels/pallas_field.py, and runs the four witness MSMs and the h MSM
    through the sorted MSM (kernels/msm_sorted.py: plans in PyTorch,
    bucket walks, suffix and its epilogue in CUDA); on a CUDA device the h
    MSM takes the shared-bucket c=16 form over the pk's pre-shifted query
    h16_p128; the windows a witness barely touches, and the window combine
    and the A/B/C randomization, run in the native C host library
    (native/),
  * prove_batch proves B witnesses of one circuit with one batched h
    stage (one mulacc_walk call, one stacked NTT call per stage), the
    MSMs proof by proof, one fetch, and the host tails on threads,
  * the MSM entry points the other schemes call (_msm_g1 / _msm_g2 over
    host point lists, _msm_packed_g1 / _msm_dev_g2 over device rows) run
    the same sorted MSM,
  * verification uses the host pairing-product oracle (ec/pairing.py).

Proof/VK JSON is byte-compatible with the reference's {a,b,c} /
{alpha,beta,gamma,delta,gamma_abc}.

Entry points take a `device` argument: "cuda" unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run instead.
"""

from __future__ import annotations

import secrets
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ec.curve import PointG1, PointG2, g1_group, g2_group
from ..ec.pairing import pairing_product_is_one
from ..fields import params as P
from ..fields.jfield import field_ops
from ..fields.limbs import int_to_limbs, ints_to_limbs, limbs_to_ints, n_limbs
from ..ir.r1cs import R1CS
from ..ir.r1cs_device import MULACC_R, REFERENCE_LANES, R1CSDevice, build_mulacc_walk
from ..ir.witness import Witness
from ..kernels.ntt import domain_for_curve
from ..kernels.pallas_field import emul, ereduce_wide, mulacc_walk
from .types import (
    Proof,
    VerificationKey,
    fr_from_json,
    fr_to_json,
    g1_from_json,
    g1_to_json,
    g2_from_json,
    g2_to_json,
)


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _g2_beta(curve: str):
    """The Fq2 non-residue beta (u^2 = beta) of G2's coordinates, or None
    where G2 lies over Fq (BW6-761: y^2 = x^3 + 4 over its base field),
    whose MSMs run the Fq walks over rows packed as G1's (pack_points)."""
    grp = g2_group(curve)
    return grp.tower.beta if hasattr(grp, "tower") else None


# ---------------------------------------------------------------------------
# Proving key
# ---------------------------------------------------------------------------


class ProvingKey:
    """Groth16 proving key with queries pre-packed for the MSM.

    Layout per G1 query: (m, 128) uint32 rows [x | y | -y | zero-pad]
    (Montgomery limbs), one row per witness index — the a/b1/l/b2 queries
    are all z-ALIGNED so the four witness-scalar MSMs share one sorted
    plan. Where the reference has no query element (zero polynomial, or
    l's leading num_instance slots) the row holds the DISTINCT dummy point
    (i+1)*G and the mask is False; the prover runs the raw witness vector
    and subtracts the correction sum_masked z_i*(i+1) * G (see corr_w).
    The b2 query packs G2 rows [x.c0|x.c1|y.c0|y.c1|-y.c0|-y.c1] with the
    same mask as b1; where those rows exceed 128 words (6*nl > 128: the
    BLS12 curves, 144 words) the key keeps the coordinates instead, as the
    JAX package does (b2_p128 None, b2_xy = (x, y), each (m, 2, nl)), and
    b2_rows() packs the wide rows. BW6-761's G2 lies over Fq: its b2_xy
    are (m, nl) each, and b2_rows() packs them as G1 rows (144 words).
    The arrays are numpy, equal to the JAX package's; device copies are
    made per device on first prove.
    """

    def __init__(
        self,
        curve: str,
        domain_size: int,
        num_instance: int,
        alpha_g1: PointG1,
        beta_g1: PointG1,
        beta_g2,
        delta_g1: PointG1,
        delta_g2,
        a_p128: np.ndarray,
        a_mask: np.ndarray,
        b1_p128: np.ndarray,
        b1_mask: np.ndarray,
        b2_p128: np.ndarray,
        b2_mask: np.ndarray,
        h_p128: np.ndarray,
        l_p128: np.ndarray,
        l_mask: np.ndarray,
        corr_w: np.ndarray,
        b2_xy: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        h16_p128: Optional[np.ndarray] = None,
    ):
        self.curve = curve
        self.domain_size = domain_size
        self.num_instance = num_instance
        self.alpha_g1 = alpha_g1
        self.beta_g1 = beta_g1
        self.beta_g2 = beta_g2
        self.delta_g1 = delta_g1
        self.delta_g2 = delta_g2
        self.a_p128 = a_p128
        self.a_mask = a_mask
        self.b1_p128 = b1_p128
        self.b1_mask = b1_mask
        self.b2_p128 = b2_p128
        self.b2_mask = b2_mask
        self.h_p128 = h_p128
        self.l_p128 = l_p128
        self.l_mask = l_mask
        self.corr_w = corr_w  # (3, m, nl) Montgomery dummy weights: a, b, l
        # shared-bucket fixed-base h query: (Wc * N_hw, 128) rows, row
        # w*N_hw + j = 2^(16w) * h_j (see _h16_p128); None on the CPU and
        # for large domains
        self.h16_p128 = h16_p128
        self._b2_xy = b2_xy
        self._dev: Dict = {}

    @property
    def b2_x(self) -> np.ndarray:
        """The b2 query's x coordinates, (m, 2, nl) Montgomery limbs."""
        if self.b2_p128 is None:
            return self._b2_xy[0]
        nl = n_limbs(P.BASE_FIELDS[self.curve].p)
        return self.b2_p128[:, : 2 * nl].reshape(-1, 2, nl)

    @property
    def b2_y(self) -> np.ndarray:
        """The b2 query's y coordinates, (m, 2, nl) Montgomery limbs."""
        if self.b2_p128 is None:
            return self._b2_xy[1]
        nl = n_limbs(P.BASE_FIELDS[self.curve].p)
        return self.b2_p128[:, 2 * nl : 4 * nl].reshape(-1, 2, nl)

    def b2_rows(self) -> np.ndarray:
        """The b2 query as packed rows (m, packed_width(2*nl)) uint32, or
        (m, packed_width(nl)) for a G2 over Fq: b2_p128, or the wide rows
        packed from b2_xy (once; not pickled)."""
        if self.b2_p128 is not None:
            return self.b2_p128
        rows = self._dev.get("b2_rows")
        if rows is None:
            from ..kernels.msm_sorted import pack_points, pack_points_g2

            x, y = (torch.as_tensor(a.astype(np.int64)) for a in self._b2_xy)
            q = P.BASE_FIELDS[self.curve].p
            pack = pack_points_g2 if _g2_beta(self.curve) is not None else pack_points
            rows = self._dev["b2_rows"] = pack(q, x, y).numpy().astype(np.uint32)
        return rows

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_dev"] = {}
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.__dict__.setdefault("h16_p128", None)
        self.__dict__.setdefault("_b2_xy", None)
        self._dev = {}

    # -- host-point views (the MPC ceremony reads and writes these) --------
    def _unpack_g1(self, p128: np.ndarray, mask=None) -> List[Optional[Tuple[int, int]]]:
        """Packed rows -> host affine (x, y) ints, None where mask is False."""
        f = field_ops(P.BASE_FIELDS[self.curve].p)
        nl = f.nl
        arr = torch.as_tensor(np.asarray(p128)[:, : 2 * nl].astype(np.int64))
        xs = f.decode(arr[:, :nl])
        ys = f.decode(arr[:, nl : 2 * nl])
        return [None if mask is not None and not mask[i] else (xs[i], ys[i]) for i in range(len(xs))]

    @property
    def h_query(self) -> List[Tuple[int, int]]:
        return self._unpack_g1(self.h_p128)

    @h_query.setter
    def h_query(self, pts):
        self.set_h_query(pts, self._query_device())

    def _query_device(self):
        """Where the query setters pack: the device of the key's cached
        copies, else the card."""
        return next((key[0] for key in self._dev if isinstance(key, tuple)), "cuda")

    def set_h_query(self, pts, device="cuda") -> None:
        """New h query from host affine points, encoded and packed on
        `device`."""
        self.set_h_rows(_pack_query(self.curve, pts, device)[0])

    def set_h_rows(self, h_p128: np.ndarray) -> None:
        """New h query rows; the shifted copies h16_p128 and the device
        copies are stale after it, so they go (a key whose h query changed
        proves by the dense h MSM)."""
        self.h_p128 = h_p128
        self.h16_p128 = None
        self._dev.clear()

    @property
    def l_query(self) -> List[Optional[Tuple[int, int]]]:
        """Reference-shaped l query: one entry per witness index >= ni
        (the internal array is z-aligned with dummies at [0, ni))."""
        ni = self.num_instance
        return self._unpack_g1(self.l_p128[ni:], self.l_mask[ni:])

    @l_query.setter
    def l_query(self, pts):
        self.set_l_query(pts, self._query_device())

    def set_l_query(self, pts, device="cuda") -> None:
        """New l query from host affine points (None = absent), encoded and
        packed on `device`, its dummies (i+1)*G from the fixed-base
        evaluator there."""
        ni = self.num_instance
        self.l_p128, self.l_mask, self.corr_w[2] = _pack_query_dummied(self.curve, [None] * ni + list(pts), device)
        self._dev.clear()

    def set_l_rows(self, l_p128: np.ndarray) -> None:
        """New l query rows at the same mask (the dummy rows and their
        correction weights unchanged)."""
        self.l_p128 = l_p128
        self._dev.clear()

    def dev(self, device, N: int, m: int) -> Dict[str, torch.Tensor]:
        """Device copies padded to the MSM tier N (cached per device, N)."""
        key = (torch.device(device), N)
        d = self._dev.get(key)
        if d is None:
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)

            d = {
                "g1": t(np.stack([_pad_rows(self.a_p128, N), _pad_rows(self.b1_p128, N),
                                  _pad_rows(self.l_p128, N)])),
                "b2": t(_pad_rows(self.b2_rows(), N)[None]),
                "h": t(_pad_rows(self.h_p128, N)[None]),
                "corr": torch.as_tensor(
                    np.pad(self.corr_w, ((0, 0), (0, N - m), (0, 0))).astype(np.int64), device=device
                ),
            }
            if self.h16_p128 is not None:
                d["h16"] = t(self.h16_p128[None])
            self._dev[key] = d
        return d


def _pack_query(curve: str, pts: Sequence[Optional[Tuple[int, int]]], device="cuda"):
    """Host affine points (None = zero poly) -> packed numpy rows + mask."""
    from ..kernels.msm_sorted import pack_points

    q = P.BASE_FIELDS[curve].p
    f = field_ops(q)
    mask = np.asarray([pt is not None for pt in pts], dtype=bool)
    X = f.encode([pt[0] if pt else 0 for pt in pts], device=device)
    Y = f.encode([pt[1] if pt else 0 for pt in pts], device=device)
    return pack_points(q, X, Y).cpu().numpy().astype(np.uint32), mask


def _pack_query_dummied(curve: str, pts: Sequence[Optional[Tuple[int, int]]], device="cuda",
                        dummy_rows: Optional[np.ndarray] = None):
    """Host affine points (None = absent) -> z-aligned packed rows with
    DISTINCT dummy points (i+1)*G at absent slots, mask (False = dummy),
    and the (m, nl_r) Montgomery correction-weight rows (i+1 at dummies, 0
    elsewhere). The dummies come from the fixed-base evaluator on `device`
    (the reference multiplies them on the host), or from dummy_rows (row i
    packing (i+1)*G, at least m rows); the rows are the same."""
    mask = np.asarray([pt is not None for pt in pts], dtype=bool)
    dummies = np.flatnonzero(~mask)
    p128, _ = _pack_query(curve, [pt if pt is not None else (0, 0) for pt in pts], device)
    if dummies.size and dummy_rows is not None:
        p128[dummies] = dummy_rows[dummies]
    elif dummies.size:
        p128[dummies], _ = _fb_g1(curve, [int(i) + 1 for i in dummies], device)
    weights = [0 if ok else i + 1 for i, ok in enumerate(mask)]
    corr_w = field_ops(P.SCALAR_FIELDS[curve].p).encode(weights).numpy().astype(np.uint32)
    return p128, mask, corr_w


def _pack_from_device(curve: str, ax, ay, inf):
    """Affine Montgomery coords + inf mask -> packed numpy rows + mask."""
    from ..kernels.msm_sorted import pack_points

    q = P.BASE_FIELDS[curve].p
    p128 = pack_points(q, ax, ay).cpu().numpy().astype(np.uint32)
    return p128, ~inf.cpu().numpy()


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _lagrange_at_tau(p: int, n: int, omega: int, tau: int) -> List[int]:
    """L_r(tau) for r in 0..n over the size-n domain: Z(tau) w^r / (n (tau - w^r)).
    The n inverses come from one batch inversion (prefix products and one
    modular inverse) in place of n modular inverses."""
    c = (pow(tau, n, p) - 1) * pow(n, -1, p) % p
    ws, d = [], []
    w_r = 1
    for _ in range(n):
        ws.append(w_r)
        d.append((tau - w_r) % p)
        w_r = w_r * omega % p
    pre = [1] * (n + 1)
    for i, v in enumerate(d):
        pre[i + 1] = pre[i] * v % p
    inv = pow(pre[n], -1, p)  # raises where tau is a root of unity, as each inverse did
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = c * ws[i] % p * (inv * pre[i] % p) % p
        inv = inv * d[i] % p
    return out


def _qap_evals_at_tau(r1cs: R1CS, n: int, lag: List[int], p: int):
    """a_tau[i], b_tau[i], c_tau[i] per dense variable (instance rows added)."""
    m = r1cs.num_variables
    a_t = [0] * m
    b_t = [0] * m
    c_t = [0] * m
    for rows, out in ((r1cs.A, a_t), (r1cs.B, b_t), (r1cs.C, c_t)):
        for r, row in enumerate(rows):
            for i, coef in row:
                out[i] = (out[i] + coef * lag[r]) % p
    # instance-binding rows: A[nc + j] has a 1 at instance variable j
    nc = r1cs.num_constraints
    for j in range(r1cs.num_instance):
        a_t[j] = (a_t[j] + lag[nc + j]) % p
    return a_t, b_t, c_t


def _scalar_limbs(grp, scalars: List[int], device) -> torch.Tensor:
    arr = ints_to_limbs([s % grp.r for s in scalars], n_limbs(grp.r)).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def _fb_g1(curve: str, scalars: List[int], device):
    """Fixed-base s_i*G1 -> (packed rows, mask) numpy."""
    from ..kernels.fixed_base import fixed_base_for

    fb = fixed_base_for(curve, "g1")
    ax, ay, inf = fb.to_affine(_scalar_limbs(g1_group(curve), scalars, device))
    return _pack_from_device(curve, ax, ay, inf)


def _fb_g1_points(curve: str, scalars: List[int], device) -> List[Optional[PointG1]]:
    """Fixed-base -> host points (for the few vk elements)."""
    from ..kernels.fixed_base import fixed_base_for

    grp = g1_group(curve)
    fb = fixed_base_for(curve, "g1")
    aff = fb.ops.to_affine_ints(fb(_scalar_limbs(grp, scalars, device)))
    return [None if a is None else PointG1(grp, a[0], a[1]) for a in aff]


def _fb_g2(curve: str, scalars: List[int], device):
    """Fixed-base s_i*G2 -> (x, y (n,2,nl) Montgomery tensors, mask)."""
    from ..kernels.fixed_base import fixed_base_for

    fb = fixed_base_for(curve, "g2")
    ax, ay, inf = fb.to_affine(_scalar_limbs(g2_group(curve), scalars, device))
    return ax, ay, ~inf


def _hw_fused_tier(m: int, n: int) -> int:
    """The padded point count of the prover on hardware for m variables over
    an n-domain (power-of-two tier rounded to the walk granularity M1*R =
    4096). Setup lays out the shared-bucket h query with this row stride."""
    N = max(_msm_tier(m), _msm_tier(n - 1))
    return -(-N // 4096) * 4096


def _h16_p128(curve: str, h_p128: np.ndarray, Nh: int, device, chunk: int = 1 << 15) -> np.ndarray:
    """The shared-bucket h query from the packed h query rows (k points,
    each `width` words: 128, or 144 for BW6-761's 48-limb Fq): (Wc * Nh,
    width) packed rows, row w*Nh + j holding 2^(16w) * h_j for j < k, and
    past k the zero row, which is how _fb_g1 packs the point at infinity of
    a zero scalar (the reference pads with zero scalars).

    The reference computes the rows as _fb_g1 of the shifted scalars. Here
    window w+1 is window w doubled 16 times, in Jacobian coordinates, and
    the windows of `chunk` points at a time are normalized together (one
    batched inversion; the chunks bound the plain ops' temporaries, which
    over BW6-761's Wc = 24 windows of 2^17 points would need tens of GB):
    2^(16w) * h_j is one affine point, so the rows are the same bits."""
    from ..kernels.fixed_base import batch_normalize
    from ..kernels.jec import curve_ops
    from ..kernels.msm_sorted import pack_points, shared_window_count

    q = P.BASE_FIELDS[curve].p
    Wc = shared_window_count(P.SCALAR_FIELDS[curve].p, 16)
    ops = curve_ops(q)
    f = ops.f
    k, width = h_p128.shape
    if k > Nh:
        raise ValueError(f"h query of {k} points does not fit a row stride of {Nh}")
    out = np.zeros((Wc, Nh, width), np.uint32)
    for j0 in range(0, k, chunk):
        j1 = min(k, j0 + chunk)
        xy = torch.as_tensor(h_p128[j0:j1, : 2 * f.nl].astype(np.int64), device=device)
        X, Y = xy[:, : f.nl], xy[:, f.nl :]
        inf = (xy == 0).all(1)  # the zero row: no affine point of the curve
        pt = (X, Y, f.select(inf, f.zero_like(X), f.one_like(X)))
        wins = [pt]
        for _ in range(Wc - 1):
            for _ in range(16):
                pt = ops.double(pt)
            wins.append(pt)
        ax, ay, _ = batch_normalize(ops, tuple(torch.cat([p[i] for p in wins]) for i in range(3)))
        del wins, pt
        rows = pack_points(q, ax, ay).cpu().numpy().astype(np.uint32)
        out[:, j0:j1] = rows.reshape(Wc, j1 - j0, width)
    return out.reshape(Wc * Nh, width)


def setup(r1cs: R1CS, rng=None, device="cuda") -> Tuple[ProvingKey, "VerificationKey"]:
    """Circuit-specific Groth16 setup. rng() draws the five toxic-waste
    scalars (alpha, beta, gamma, delta, tau) in that order."""
    from ..kernels.msm_sorted import pack_points_g2

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p - 1) + 1)

    g1 = g1_group(curve).generator()
    g2 = g2_group(curve).generator()

    nc, ni = r1cs.num_constraints, r1cs.num_instance
    n = _next_pow2(nc + ni)
    dom = domain_for_curve(curve, n)

    alpha, beta, gamma, delta, tau = (rand() for _ in range(5))

    lag = _lagrange_at_tau(p, n, dom.omega, tau)
    a_t, b_t, c_t = _qap_evals_at_tau(r1cs, n, lag, p)

    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    z_tau = (pow(tau, n, p) - 1) % p
    m = r1cs.num_variables

    # h query scalars: tau^j * Z(tau) / delta, j in 0..n-2
    h_s = []
    tp = z_tau * delta_inv % p
    for _ in range(n - 1):
        h_s.append(tp)
        tp = tp * tau % p

    # z-aligned l query: dummies at the instance slots and absent entries
    l_full = [0] * m
    for i in range(ni, m):
        l_full[i] = (beta * a_t[i] + alpha * b_t[i] + c_t[i]) % p * delta_inv % p
    abc_s = [
        (beta * a_t[i] + alpha * b_t[i] + c_t[i]) % p * gamma_inv % p
        for i in range(ni)
    ]

    # every query row is a valid affine point: absent entries get the
    # DISTINCT dummy point (i+1)*G, so the prover can run the raw witness
    # vector and subtract the correction sum_dummy z_i*(i+1) afterwards
    def dummied(scalars):
        return [s if s else (i + 1) for i, s in enumerate(scalars)]

    fr = field_ops(p)

    def weights(scalars):
        w = [0 if s else (i + 1) for i, s in enumerate(scalars)]
        return fr.encode(w).numpy().astype(np.uint32)

    a_p128, _ = _fb_g1(curve, dummied(a_t), device)
    b1_p128, _ = _fb_g1(curve, dummied(b_t), device)
    h_p128, _ = _fb_g1(curve, h_s, device)
    l_p128, _ = _fb_g1(curve, dummied(l_full), device)
    # the shared-bucket form of the h query, for the prover on a CUDA
    # device (the reference builds it on a TPU); gated to n - 1 <= 2^17,
    # since it stores Wc = 16 shifted copies of the query, and to base
    # fields of at most 24 16-bit limbs: over BW6-761's 48 (Wc = 24) its
    # MSM measured slower than the dense one on an H100 (57.06 against
    # 53.11 ms on the recursion circuit, port_tools/bw6_phase.py --h16),
    # for 66 s of setup and a table of 1.8 GB
    h16_p128 = None
    if torch.device(device).type == "cuda" and n - 1 <= (1 << 17) and n_limbs(P.BASE_FIELDS[curve].p) <= 24:
        h16_p128 = _h16_p128(curve, h_p128, _hw_fused_tier(m, n), device)
    b2x, b2y, _ = _fb_g2(curve, dummied(b_t), device)
    q = P.BASE_FIELDS[curve].p
    if 6 * n_limbs(q) <= 128:
        b2_p128 = pack_points_g2(q, b2x, b2y).cpu().numpy().astype(np.uint32)
        b2_xy = None
    else:  # a packed G2 row over 128 words (the BLS12 curves): keep x, y
        b2_p128 = None
        b2_xy = (b2x.cpu().numpy().astype(np.uint32), b2y.cpu().numpy().astype(np.uint32))
    corr_w = np.stack([weights(a_t), weights(b_t), weights(l_full)])

    gamma_abc = _fb_g1_points(curve, abc_s, device)
    gamma_abc = [pt if pt is not None else g1_group(curve).zero() for pt in gamma_abc]

    pk = ProvingKey(
        curve=curve,
        domain_size=n,
        num_instance=ni,
        alpha_g1=g1 * alpha,
        beta_g1=g1 * beta,
        beta_g2=g2 * beta,
        delta_g1=g1 * delta,
        delta_g2=g2 * delta,
        a_p128=a_p128,
        a_mask=np.asarray([s != 0 for s in a_t], dtype=bool),
        b1_p128=b1_p128,
        b1_mask=np.asarray([s != 0 for s in b_t], dtype=bool),
        b2_p128=b2_p128,
        b2_mask=np.asarray([s != 0 for s in b_t], dtype=bool),
        h_p128=h_p128,
        l_p128=l_p128,
        l_mask=np.asarray([s != 0 for s in l_full], dtype=bool),
        corr_w=corr_w,
        b2_xy=b2_xy,
        h16_p128=h16_p128,
    )
    vk = VerificationKey(
        "g16",
        curve,
        {
            "alpha": g1_to_json(g1 * alpha, curve),
            "beta": g2_to_json(g2 * beta, curve),
            "gamma": g2_to_json(g2 * gamma, curve),
            "delta": g2_to_json(g2 * delta, curve),
            "gamma_abc": [g1_to_json(pt, curve) for pt in gamma_abc],
        },
    )
    return pk, vk


# ---------------------------------------------------------------------------
# h stage
# ---------------------------------------------------------------------------


_ROWS: Dict = {}


def _row(p: int, value: int, device) -> torch.Tensor:
    """The (nl,) 16-bit limbs of a host integer in [0, p), cached per
    device: R^2 (to Montgomery form), 1 (from it), Montgomery constants."""
    key = (p, value, torch.device(device))
    t = _ROWS.get(key)
    if t is None:
        t = _ROWS[key] = torch.as_tensor(int_to_limbs(value, n_limbs(p)).astype(np.int64), device=device)
    return t


def _matvec_kind(device) -> str:
    """'walk' (the fused mulacc_walk kernel) on a CUDA device, 'coo' on the
    CPU, as the reference takes its walk on hardware."""
    return "walk" if torch.device(device).type == "cuda" else "coo"


def _matvec_coo(p: int, dev: R1CSDevice, Z_mont: torch.Tensor) -> torch.Tensor:
    """(B, m, nl) Montgomery z -> (B, 3n, nl) A·z | B·z | C·z, canonical:
    rows offset into disjoint blocks [0, n), [n, 2n), [2n, 3n), so one
    gather, one product, one index_add_ and one reduction."""
    n = dev.n
    B, _, nl = Z_mont.shape
    rows = torch.cat([dev.A.rows, dev.B.rows + n, dev.C.rows + 2 * n])
    cols = torch.cat([dev.A.cols, dev.B.cols, dev.C.cols])
    coeff = torch.cat([dev.A.coeff, dev.B.coeff, dev.C.coeff])
    vals = emul(p, Z_mont[:, cols], coeff)
    sums = torch.zeros((B, 3 * n, nl), dtype=torch.int64, device=Z_mont.device)
    sums.index_add_(1, rows, vals)
    return ereduce_wide(p, sums)


# lanes of the walk by batch size (walk_lanes): the counts at which the
# card's _matvec_walk ran fastest on sha256, over 1024 to 32768 lanes
# (PERF.md)
_WALK_LANES = {1: 1 << 15, 16: 1 << 14}


def walk_lanes(B: int, records: int = None) -> int:
    """Lanes of the walk matvec for a batch of B proofs: the measured count
    of _WALK_LANES for the largest batch size in it not above B, halved
    while that leaves lanes of fewer than R records (`records`, when
    given: the walk's record count), down to the reference's 1024."""
    lanes = _WALK_LANES[max(b for b in _WALK_LANES if b <= max(B, 1))]
    while records is not None and lanes > REFERENCE_LANES and records < lanes * MULACC_R:
        lanes //= 2
    return lanes


def _matvec_walk(p: int, dev: R1CSDevice, Z_mont: torch.Tensor, lanes: int = None) -> torch.Tensor:
    """The reference's pipeline_walk matvec, same result as _matvec_coo:
    one mulacc_walk call for the batch (the lazy sums of every flushed
    run, z gathered in the kernel) on a plan of `lanes` lanes (walk_lanes
    by default), the sums reduced, summed per row (the slots of the 3n
    rows; the rest, the padded records' runs and the pad slots, whose seg
    is the reference's extra row 3n, hold 0), and reduced again."""
    B, _, nl = Z_mont.shape
    if lanes is None:
        lanes = walk_lanes(B, sum(mat.rows_np.size for mat in (dev.A, dev.B, dev.C)))
    w = build_mulacc_walk(dev, lanes)
    part = ereduce_wide(p, mulacc_walk(p, Z_mont, w))
    sums = torch.zeros((B, w.n_rows, nl), dtype=torch.int64, device=Z_mont.device)
    sums.index_add_(1, w.seg[: w.n_row_flush], part[:, : w.n_row_flush])
    return ereduce_wide(p, sums)


def _h_stage(curve: str, dev: R1CSDevice, Z: torch.Tensor) -> torch.Tensor:
    """z (B, m, nl) canonical limbs -> h(X) coefficients (B, n, nl)
    canonical: to_mont, one fused 3-matrix matvec (the walk or COO, as
    _matvec_kind picks for the device), QAP coset-NTT division,
    from_mont. All 3B transforms of a stage run as one batched op. The
    elementwise products (to_mont and from_mont among them, as products by
    the R^2 and 1 rows), the lazy-sum reductions, the matvec walk and the
    transforms go through the kernels emul, ereduce_wide, mulacc_walk and
    (in Domain) fft_core, as the reference goes through its Pallas kernels
    on a TPU; sub and the per-row index_add_ stay plain."""
    p = P.SCALAR_FIELDS[curve].p
    f = field_ops(p)
    n = dev.n
    dom = domain_for_curve(curve, n)
    g = P.SCALAR_FIELDS[curve].smallest_nonresidue
    zinv_mont = pow((pow(g, n, p) - 1) % p, -1, p) * f.spec.r % p

    Z = Z.to(torch.int64)
    B, m, nl = Z.shape
    Z_mont = emul(p, Z, _row(p, f.spec.r2, Z.device).expand(m, nl))
    matvec = _matvec_walk if _matvec_kind(Z.device) == "walk" else _matvec_coo
    abc_e = matvec(p, dev, Z_mont).reshape(B * 3, n, nl)
    abc_cs = dom.coset_fft(dom.ifft(abc_e), g).reshape(B, 3, n, nl)
    ab = emul(p, abc_cs[:, 0], abc_cs[:, 1])
    h_cs = emul(p, f.sub(ab, abc_cs[:, 2]), _row(p, zinv_mont, Z.device).expand(n, nl))
    return emul(p, dom.coset_ifft(h_cs, g), _row(p, 1, Z.device).expand(n, nl))


def compute_h(r1cs: R1CS, z: Sequence[int], n: int, device="cuda") -> List[int]:
    """Coefficients of h(X) = (A(X)B(X) - C(X)) / Z(X), host z in, ints out."""
    p = P.SCALAR_FIELDS[r1cs.curve].p
    z_can = torch.as_tensor(ints_to_limbs([v % p for v in z], n_limbs(p)).astype(np.int64), device=device)
    h = _h_stage(r1cs.curve, R1CSDevice.build(r1cs, n, device), z_can[None])[0]
    return limbs_to_ints(h.cpu().numpy())[: n - 1]


# ---------------------------------------------------------------------------
# MSM entry points of the other schemes (GM17; the reference's KZG, Marlin,
# Nova and MPC call the same ones)
# ---------------------------------------------------------------------------

def _pad_pairs(pairs):
    """Pad to the next power of two with (first point, scalar 0) — zero
    scalars fall into the dropped bucket, and pow2 sizes share MSM
    shapes across circuits."""
    n = 1 << max(2, (len(pairs) - 1).bit_length())
    return pairs + [(pairs[0][0], 0)] * (n - len(pairs))


def _mont_elems(q: int, ints: Sequence[int], device) -> torch.Tensor:
    """Host ints in [0, q) -> (len, nl) Montgomery limbs on `device`: the
    canonical limbs uploaded, then one emul by the R^2 row."""
    nl = n_limbs(q)
    t = torch.as_tensor(ints_to_limbs(list(ints), nl).astype(np.int64), device=device)
    return emul(q, t[None], _row(q, field_ops(q).spec.r2, device).expand(t.shape[0], nl))[0]


def _sorted_inputs(P128: torch.Tensor, S: torch.Tensor, mask):
    """(N, 128) packed rows and (m <= N, nls) scalars -> the sorted MSM's
    config for N and both padded to a multiple of its walk granularity
    M1*R, with scalar 0 where mask is False, past m and in the padding."""
    from ..kernels.msm_sorted import default_config

    N, m = P128.shape[0], S.shape[0]
    if m > N:
        raise ValueError(f"{m} scalars for {N} points")
    if mask is not None:
        S = torch.where(mask[:m, None], S, 0)
    cfg = default_config(N)
    full = -(-N // (cfg.M1 * cfg.R)) * (cfg.M1 * cfg.R)
    P128 = torch.nn.functional.pad(P128, (0, 0, 0, full - N))
    return cfg, P128, torch.nn.functional.pad(S, (0, 0, 0, full - m))


def _msm_packed_g1(curve: str, P128: torch.Tensor, S: torch.Tensor, mask=None) -> PointG1:
    """G1 MSM: packed rows (N, 128) int32 [x|y|-y|pad] (Montgomery limbs)
    x canonical-limb scalars (m <= N, nls), both on one device, through the
    sorted MSM (msm_sorted_host: CUDA walks, suffix and epilogue on a CUDA
    device, their plain versions on the CPU). Masked-out and padded slots
    get scalar zero (bucket 0 is skipped)."""
    from ..kernels.msm_sorted import msm_sorted_host

    grp = g1_group(curve)
    cfg, P128, S = _sorted_inputs(P128, S, mask)
    return _jac_to_g1(curve, msm_sorted_host(grp.q, grp.r, P128, S, cfg))


def _msm_dev_g2(curve: str, Px: torch.Tensor, Py: torch.Tensor, S: torch.Tensor, mask=None) -> PointG2:
    """G2 MSM over Fq2 coordinates (N, 2, nl) Montgomery x canonical-limb
    scalars, through the sorted MSM's Fq2 walks (the rows packed by
    pack_points_g2: 144 words for the BLS12 curves, where the reference
    takes its XLA Pippenger, since its TPU gather layout holds 128). A G2
    over the base field (BW6-761: coordinates (N, nl)) runs the Fq walks
    over rows packed by pack_points, as the reference's _msm_g2 runs G1's
    formulas (the adds do not read the curve's b)."""
    from ..kernels.msm_sorted import msm_sorted_host, pack_points, pack_points_g2

    grp = g2_group(curve)
    beta = _g2_beta(curve)
    if beta is None:
        cfg, P128, S = _sorted_inputs(pack_points(grp.q, Px, Py), S, mask)
        return _jac_to_g2(curve, msm_sorted_host(grp.q, grp.r, P128, S, cfg))
    cfg, P128, S = _sorted_inputs(pack_points_g2(grp.q, Px, Py), S, mask)
    beta = beta - grp.q  # small negative representative
    return _jac_to_g2(curve, msm_sorted_host(grp.q, grp.r, P128, S, cfg, beta=beta))


def _msm_g1(curve: str, points: List[Optional[Tuple[int, int]]], scalars: List[int],
            device="cuda") -> PointG1:
    """G1 MSM over host (x, y) points; drops None points and zero scalars,
    pads the pairs to a power of two, uploads them packed and runs
    _msm_packed_g1 (the sorted MSM picks its own window width)."""
    from ..kernels.msm_sorted import pack_points

    grp = g1_group(curve)
    pairs = [(pt, s % grp.r) for pt, s in zip(points, scalars) if pt is not None and s % grp.r != 0]
    if not pairs:
        return grp.zero()
    pairs = _pad_pairs(pairs)
    X = _mont_elems(grp.q, [pt[0] for pt, _ in pairs], device)
    Y = _mont_elems(grp.q, [pt[1] for pt, _ in pairs], device)
    return _msm_packed_g1(curve, pack_points(grp.q, X, Y), _scalar_limbs(grp, [s for _, s in pairs], device))


def _msm_g2(curve: str, points: List[Optional[PointG2]], scalars: List[int],
            device="cuda") -> PointG2:
    """G2 MSM over host points, as _msm_g1, through _msm_dev_g2 (over Fq
    for BW6-761's G2)."""
    grp = g2_group(curve)
    pairs = [(pt, s % grp.r) for pt, s in zip(points, scalars) if pt is not None and s % grp.r != 0]
    if not pairs:
        return grp.zero()
    pairs = _pad_pairs(pairs)
    S = _scalar_limbs(grp, [s for _, s in pairs], device)
    if _g2_beta(curve) is None:
        X = _mont_elems(grp.q, [pt.x for pt, _ in pairs], device)
        Y = _mont_elems(grp.q, [pt.y for pt, _ in pairs], device)
        return _msm_dev_g2(curve, X, Y, S)

    def coord(get):
        ints = [v for pt, _ in pairs for v in (get(pt).c0, get(pt).c1)]
        return _mont_elems(grp.q, ints, device).reshape(len(pairs), 2, -1)

    return _msm_dev_g2(curve, coord(lambda pt: pt.x), coord(lambda pt: pt.y), S)


# ---------------------------------------------------------------------------
# Sparse window split (host, numpy)
# ---------------------------------------------------------------------------


def _pad_rows(arr: np.ndarray, N: int) -> np.ndarray:
    if arr.shape[0] == N:
        return arr
    pad = [(0, N - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _msm_tier(n: int) -> int:
    """Pad MSM sizes to powers of two."""
    return max(4, _next_pow2(n))


def _signed_digits_np(z_limbs: np.ndarray, W: int, c: int):
    """Host signed-digit decomposition: (W, m) |digit| and sign arrays,
    exactly as kernels/msm_sorted._signed_digits (c | 16, so no digit
    spans limbs)."""
    m, nls = z_limbs.shape
    mask = np.uint32((1 << c) - 1)
    half = np.uint32(1 << (c - 1))
    full = np.uint32(1 << c)
    carry = np.zeros(m, np.uint32)
    digits = np.zeros((W, m), np.uint32)
    signs = np.zeros((W, m), np.uint32)
    for w in range(W):
        limb = (w * c) // 16
        sh = np.uint32((w * c) % 16)
        raw = (z_limbs[:, limb] >> sh) & mask if limb < nls else np.zeros(m, np.uint32)
        t = raw + carry
        neg = t >= half
        digits[w] = np.where(neg, full - t, t)
        signs[w] = neg
        carry = neg.astype(np.uint32)
    return digits, signs


def _window_nnz_batch(Z_np: List[np.ndarray], W: int, c: int) -> List[int]:
    """Exact per-window nonzero signed-digit counts, maxed over a batch of
    witnesses in one vectorized pass: a window split that holds for every
    witness."""
    digits, _ = _signed_digits_np(np.concatenate(Z_np, axis=0), W, c)
    counts = np.count_nonzero(digits.reshape(W, len(Z_np), Z_np[0].shape[0]), axis=2)  # (W, B)
    return [int(v) for v in counts.max(axis=1)]


_SPLIT_W0S = (0, 1, 2, 3, 4, 6, 8, 12, 16)
_SPLIT_W1S = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _split_from_nnz(nnz, W: int, cfg, N: int):
    floor = cfg.M1 * cfg.R

    def tier(mx):
        return min(N, max(floor, 1 << max(0, mx - 1).bit_length()))

    last = max((w for w in range(W) if nnz[w]), default=0) + 1
    w1 = min(next((c for c in _SPLIT_W1S if c >= last), W), W)
    best = (W * N + 1, 0, N)
    for w0 in _SPLIT_W0S:
        if w0 > w1:
            break
        Ks = tier(max(nnz[w0:w1], default=1))
        cost = w0 * N + (w1 - w0) * Ks
        if cost < best[0]:
            best = (cost, w0, Ks)
    return best[1], w1, best[2]


# total sparse entries the native host path absorbs per witness (the JAX
# package's cap), against a device walk floor of M1*R slots per window
_HOST_SPARSE_CAP = 4096


def _split_with_host(nnz: List[int], W: int, cfg, N: int, native_ok: bool):
    """Returns (w0, w1, Ks, hw0, hw1): (w0, w1, Ks) is the DEVICE window
    split, [hw0, hw1) the windows the native host backend computes from
    the packed query rows (empty when hw0 == hw1): every trailing window
    whose cumulative nonzero count fits _HOST_SPARSE_CAP, snapped to the
    split grid; the device split is re-optimized over the prefix."""
    last = max((w for w in range(W) if nnz[w]), default=0) + 1
    if native_ok:
        suffix = 0
        wh = last
        while wh > 1 and suffix + nnz[wh - 1] <= _HOST_SPARSE_CAP:
            suffix += nnz[wh - 1]
            wh -= 1
        wh = next((c0 for c0 in _SPLIT_W0S if c0 >= wh), last)
        if wh < last:
            w0, w1, Ks = _split_from_nnz(nnz[:wh], wh, cfg, N)
            return w0, w1, Ks, wh, last
    w0, w1, Ks = _split_from_nnz(nnz, W, cfg, N)
    return w0, w1, Ks, 0, 0


def _host_sparse_windows(nf, nf2, pk, z_np, w0: int, w1: int, c: int):
    """Windows [w0, w1) of the four witness MSMs, computed natively on the
    host from the packed pk rows. Returns ([a, b1, l] per-window G1 jac
    lists, b2 per-window G2 jac list)."""
    digits, signs = _signed_digits_np(z_np, w1, c)
    g1_wins = [[], [], []]
    g2_wins = []
    queries = (pk.a_p128, pk.b1_p128, pk.l_p128)
    b2_rows = pk.b2_rows()
    m = z_np.shape[0]
    for w in range(w0, w1):
        nz = np.nonzero(digits[w][:m])[0].astype(np.int32)
        dg = digits[w][nz]
        sg = signs[w][nz]
        for qi, q in enumerate(queries):
            g1_wins[qi].append(nf.sparse_window_g1(q, nz, dg, sg))
        g2_wins.append(nf2.sparse_window_g2(b2_rows, nz, dg, sg))
    return g1_wins, g2_wins


def _combine_host_g1(nf, dev_jac, host_wins, w0: int, c: int):
    """dev_jac (= sum_{w<w0} 2^{cw} S_w) + 2^{c w0} * Horner(host_wins)."""
    if not host_wins:
        return dev_jac
    acc = (1, 1, 0)
    for S in reversed(host_wins):
        acc = nf.g1_add(nf.g1_shift(acc, c), S)
    return nf.g1_add(dev_jac, nf.g1_shift(acc, c * w0))


def _combine_host_g2(nf2, dev_jac, host_wins, w0: int, c: int):
    """As _combine_host_g1 over nf2's G2 ops (Fq2, or Fq: _G2OverFq)."""
    if not host_wins:
        return dev_jac
    acc = host_wins[-1]
    for S in reversed(host_wins[:-1]):
        acc = nf2.g2_add(nf2.g2_shift(acc, c), S)
    return nf2.g2_add(dev_jac, nf2.g2_shift(acc, c * w0))


class _G2OverFq:
    """A native Fq context under the G2 names of the host tail
    (_finish_native, _host_sparse_windows, _combine_host_g2), for a G2
    over the base field (BW6-761): its G1 ops, on int coordinates."""

    def __init__(self, nf):
        self.nf = nf

    def combine_windows2(self, wX, wY, wZ, W: int, c: int):
        return self.nf.combine_windows(wX, wY, wZ, W, c)

    def g2_add(self, a, b):
        return self.nf.g1_add(a, b)

    def g2_mul(self, jac, k: int):
        return self.nf.g1_mul(jac, k)

    def g2_shift(self, jac, k: int):
        return self.nf.g1_shift(jac, k)

    def g2_to_affine(self, jac):
        return self.nf.g1_to_affine(jac)

    def sparse_window_g2(self, rows, idx, digits, signs):
        return self.nf.sparse_window_g1(rows, idx, digits, signs)


# ---------------------------------------------------------------------------
# Device prove pipeline
# ---------------------------------------------------------------------------


class _Stages:
    """Per-stage wall times of one prove. Each mark synchronizes the
    device first, so the times add up to the prove's wall time; without
    a timings dict the marks are free no-ops."""

    def __init__(self, totals: Optional[dict], device):
        self.totals = totals
        self.device = torch.device(device)
        self.t = time.perf_counter()

    def __call__(self, label: str):
        if self.totals is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.totals[label] = self.totals.get(label, 0.0) + (now - self.t)
        self.t = now


def _corr_fast(f, corr_w, z_pad, C: int, chunk: int):
    """Dummy-correction weights · witness dot products (3 rows), canonical.
    Lazy limb sums over chunks of <= 2^15 products keep the reference's
    u32 headroom. The products and reductions go through emul and
    ereduce_wide, as the reference's TPU branch does."""
    p, nl = f.p, f.nl
    zm = emul(p, z_pad[None], _row(p, f.spec.r2, z_pad.device).expand(z_pad.shape[0], nl))[0]
    prod = emul(p, corr_w, zm)
    s1 = ereduce_wide(p, prod.reshape(3, C, chunk, nl).sum(2))
    s = ereduce_wide(p, s1.sum(1)[None])
    return emul(p, s, _row(p, 1, z_pad.device).expand(3, nl))[0]


def _shared_h_cfg(cfg):
    """MSMConfig of the shared-bucket h walk: c=16 digits into one 2^15-
    bucket space; lw2=1024 keeps the single window's merge and suffix walks
    at 1024 lanes."""
    from ..kernels.msm_sorted import MSMConfig

    return MSMConfig(c=16, M1=cfg.M1, R=cfg.R, lw2=1024)


def _use_h16(pk, p: int, N: int, device) -> bool:
    """The shared-bucket h MSM: on a CUDA device (the reference: on
    hardware), when the pk carries the shifted query at exactly this
    prover's padded tier N; else the dense per-window form."""
    from ..kernels.msm_sorted import shared_window_count

    if torch.device(device).type != "cuda" or pk.h16_p128 is None:
        return False
    return pk.h16_p128.shape[0] == shared_window_count(p, 16) * N


def _prove_device(curve, dev, pkd, Z_pad, N, n, W, cfg, w0, w1, Ks, h16, mark):
    """The device part of B proofs: one batched h stage, then per proof the
    witness and h plans, the three witness G1 MSMs as one query batch, the
    h G1 MSM (shared-bucket over pkd["h16"] if h16, else dense), the G2
    MSM and the dummy corrections. Returns (B, ...) device tensors: window
    sums X, Y, Z in Montgomery limbs for the G1 queries (B, 3, w1, en),
    the h query (B, 1, 1 or W, en) and the G2 query (B, 1, w1, en), and
    the correction scalars (B, 3, nl), canonical."""
    from ..kernels.msm_sorted import (_msm_from_plan, _msm_plan, _msm_plan_shared,
                                      _msm_plan_split, shared_window_count)

    p = P.SCALAR_FIELDS[curve].p
    q = P.BASE_FIELDS[curve].p
    beta = _g2_beta(curve)
    f = field_ops(p)
    chunk = min(N, 1 << 15)
    cfgH = _shared_h_cfg(cfg)
    Wc = shared_window_count(p, 16)

    H = _h_stage(curve, dev, Z_pad)
    H_pad = torch.nn.functional.pad(H[:, : n - 1], (0, 0, 0, N - (n - 1)))
    del H
    mark("h_stage")

    def z_msm(P128, plans, beta_):
        """Witness-scalar MSM over the split plan -> (Q, w1, en) sums."""
        parts = [
            _msm_from_plan(q, wn, cfg, P128, plan, True, beta=beta_, mark=mark)[0]
            for plan, wn in zip(plans, (w0, w1 - w0))
            if plan is not None
        ]
        return tuple(torch.cat([pt[i] for pt in parts], dim=1) for i in range(3))

    outs = []
    for b in range(Z_pad.shape[0]):
        plans = _msm_plan_split(w1, N, cfg, Z_pad[b], w0, Ks)
        plan_h = _msm_plan_shared(Wc, N, cfgH, H_pad[b]) if h16 else _msm_plan(W, N, cfg, H_pad[b])
        mark("plans")
        g1 = z_msm(pkd["g1"], plans, None)
        if h16:
            out_h, _ = _msm_from_plan(q, 1, cfgH, pkd["h16"], plan_h, True, mark=mark)
        else:
            out_h, _ = _msm_from_plan(q, W, cfg, pkd["h"], plan_h, True, mark=mark)
        b2 = z_msm(pkd["b2"], plans, beta)
        corr = _corr_fast(f, pkd["corr"], Z_pad[b], -(-N // chunk), chunk)
        mark("corrections")
        outs.append((g1, out_h, b2, corr))

    def stacked(j):
        return tuple(torch.stack([o[j][i] for o in outs]) for i in range(3))

    return stacked(0), stacked(1), stacked(2), torch.stack([o[3] for o in outs])


def _fetch(tensors):
    """Device tensors -> numpy arrays, in one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def _witness_limbs(r1cs: R1CS, witness: Witness, p: int, nls: int) -> np.ndarray:
    """(m, nls) u32 canonical witness limb array.

    Fast path: witnesses read from disk carry a numpy sidecar
    (Witness._arr_vars/_arr_vals); the full assignment is then two numpy
    gathers instead of a Python int round trip. Falls back to the int path
    for interpreter-built witnesses, foreign layouts, or any value >= p."""
    va = getattr(witness, "_arr_vars", None)
    vals = getattr(witness, "_arr_vals", None)

    def slow():
        z = [v % p for v in r1cs.full_assignment(witness)]
        return np.asarray(ints_to_limbs(z, nls))

    if va is None or vals is None or vals.shape[1] != 2 * nls:
        return slow()
    cached = getattr(r1cs, "_wlimb_map", None)
    if cached is None or not np.array_equal(cached[0], va):
        ir_vars = np.fromiter(r1cs.ir_to_dense.keys(), dtype=np.int64)
        dense = np.fromiter(r1cs.ir_to_dense.values(), dtype=np.int64)
        rows = np.searchsorted(va, ir_vars)
        if np.any(rows >= len(va)) or not np.array_equal(va[rows], ir_vars):
            return slow()  # witness is missing mapped variables
        cached = (va.copy(), dense, rows, int_to_limbs(p, nls))
        r1cs._wlimb_map = cached
    _, dense, rows, p16 = cached
    w16 = np.ascontiguousarray(vals).view("<u2").astype(np.uint32)
    # exact range check vs p (most-significant-limb-first lexicographic)
    eq = np.ones(w16.shape[0], dtype=bool)
    ge = np.zeros(w16.shape[0], dtype=bool)
    for i in range(nls - 1, -1, -1):
        gt = eq & (w16[:, i] > p16[i])
        lt = eq & (w16[:, i] < p16[i])
        ge |= gt
        eq &= ~(gt | lt)
    if np.any(ge | eq):
        return slow()  # non-canonical value present
    z = np.zeros((r1cs.num_variables, nls), np.uint32)
    z[0, 0] = 1
    z[dense] = w16[rows]
    return z


def _public_inputs_json(r1cs: R1CS, witness: Witness, curve: str):
    """Proof JSON public inputs (dense instance slots 1..ni-1)."""
    p = P.SCALAR_FIELDS[curve].p
    inv = getattr(r1cs, "_dense_inv", None)
    if inv is None:
        inv = {d: v for v, d in r1cs.ir_to_dense.items()}
        r1cs._dense_inv = inv
    return [fr_to_json(witness[inv[i]] % p, curve) for i in range(1, r1cs.num_instance)]


def _neg_jac(q, jac):
    x, y, z = jac
    return (x, (q - y) % q, z)


def _neg_jac2(q, jac):
    x, y, z = jac
    return (x, ((q - y[0]) % q, (q - y[1]) % q), z)


def _native_pair(curve):
    """(Fq ctx, G2 ctx) native contexts: the G2 one over Fq2, or the Fq one
    under G2's names (_G2OverFq) where G2 lies over Fq; (None, None) if
    unavailable."""
    from ..native import field_for as _nfield

    q = P.BASE_FIELDS[curve].p
    nf = _nfield(q)
    if nf is None:
        return None, None
    beta = _g2_beta(curve)
    if beta is None:
        return nf, _G2OverFq(nf)
    nf2 = _nfield(q, beta)
    if nf2 is None:
        return None, None
    return nf, nf2


def _g2_jac(pt):
    """A host G2 point as the native tail's Jacobian triple (Z = 1): pairs
    over Fq2, ints over Fq."""
    if hasattr(pt.x, "c0"):
        return ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1), (1, 0))
    return (pt.x, pt.y, 1)


def _g2_from_affine(grp, aff):
    """The native tail's affine G2 result (None: infinity) as a host point
    of grp (PointG2 over Fq2; over Fq, grp's PointG1-type point)."""
    if aff is None:
        return grp.zero()
    if not hasattr(grp, "tower"):
        return PointG1(grp, aff[0], aff[1])
    from ..ec.tower import Fq2

    return PointG2(grp, Fq2(grp.tower, aff[0][0], aff[0][1]), Fq2(grp.tower, aff[1][0], aff[1][1]))


def _r1cs_device(r1cs: R1CS, n: int, device) -> R1CSDevice:
    """The COO matrices on `device`, cached on the r1cs object."""
    cache = r1cs.__dict__.setdefault("_torch_dev", {})
    key = (n, torch.device(device))
    if key not in cache:
        cache[key] = R1CSDevice.build(r1cs, n, device)
    return cache[key]


def _prove_core_sorted_batch(curve, pk, r1cs, Z_list, m, n, rs_list, device, mark):
    """Sorted-MSM prove core for B witnesses of one circuit: the device part
    (_prove_device) for the whole batch, the native host windows, one
    fetch of window sums and corrections, then per proof, on threads, the
    host window combine, correction subtraction and A/B/C randomization
    with that proof's (r, s) from rs_list. The window split holds for
    every witness (per-window nonzero counts maxed over the batch).
    Returns the B final (A, B2, C) proof-point triples."""
    from ..kernels.msm_sorted import _windows, default_config

    p = P.SCALAR_FIELDS[curve].p
    B = len(Z_list)
    N = max(_msm_tier(m), _msm_tier(n - 1))
    cfg = default_config(N)
    need = cfg.M1 * cfg.R
    N = -(-N // need) * need
    W = _windows(p, cfg.c)
    h16 = _use_h16(pk, p, N, device)

    nf, nf2 = _native_pair(curve)
    Z_np = [np.asarray(z) for z in Z_list]
    nnz = _window_nnz_batch(Z_np, W, cfg.c)
    w0, w1, Ks, hw0, hw1 = _split_with_host(nnz, W, cfg, N, nf is not None)
    dev = _r1cs_device(r1cs, n, device)
    pkd = pk.dev(device, N, m)
    Z_pad = torch.as_tensor(
        np.stack([np.pad(z, ((0, N - m), (0, 0))) for z in Z_np]).astype(np.int64), device=device
    )
    mark("host_prep")
    g1w, wh, w2, corr = _prove_device(curve, dev, pkd, Z_pad, N, n, W, cfg, w0, w1, Ks, h16, mark)

    # the host's sparse windows overlap the device's queue
    hosts = [(None, None)] * B
    if hw1 > hw0:
        hosts = [_host_sparse_windows(nf, nf2, pk, z, hw0, hw1, cfg.c) for z in Z_np]
    got = _fetch([*g1w, *wh, *w2, corr])
    g1w, wh, w2, corr = got[0:3], got[3:6], got[6:9], got[9]
    wh_count = 1 if h16 else W

    def finish(b):
        ca, cb, cl = limbs_to_ints(corr[b])
        r, s = rs_list[b]
        g1w_b, wh_b, w2_b = ([a[b] for a in t] for t in (g1w, wh, w2))
        if nf is not None:
            return _finish_native(curve, pk, nf, nf2, g1w_b, wh_b, w2_b, (ca, cb, cl), w1, wh_count,
                                  cfg, r, s, hosts[b][0], hosts[b][1], hw0)
        return _finish_python(curve, pk, g1w_b, wh_b, w2_b, (ca, cb, cl), w1, wh_count, cfg, r, s)

    if nf is not None and B > 1:
        # the native tail runs in C with the GIL released (ctypes)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(B, 8)) as ex:
            outs = list(ex.map(finish, range(B)))
    else:
        outs = [finish(b) for b in range(B)]
    mark("host_tail")
    return outs


def _finish_native(curve, pk, nf, nf2, g1w, wh, w2, corrs, w1, W, cfg, r, s,
                   host_g1=None, host_g2=None, hw0=0):
    """Window sums + corrections -> final (A, B2, C) proof points, all host
    math in the native C backend. g1w/w2 hold (Q, w1, en) window sums per
    coordinate (Q = 3 G1 queries a, b1, l / 1 G2 query), wh (1, W, en)
    (W = 1 for the shared-bucket h MSM);
    host_g1/host_g2 carry natively computed sparse windows [hw0, ...)."""
    p = P.SCALAR_FIELDS[curve].p
    q = P.BASE_FIELDS[curve].p
    ca, cb, cl = corrs
    g1grp = g1_group(curve)
    g2grp = g2_group(curve)
    g1 = g1grp.generator()
    g2 = g2grp.generator()
    gj = (g1.x, g1.y, 1)
    g2j = _g2_jac(g2)
    neg2 = _neg_jac2 if hasattr(g2grp, "tower") else _neg_jac

    def comb1(i):
        dev = nf.combine_windows(g1w[0][i], g1w[1][i], g1w[2][i], w1, cfg.c)
        if host_g1 is not None:
            dev = _combine_host_g1(nf, dev, host_g1[i], hw0, cfg.c)
        return dev

    ja = nf.g1_add(comb1(0), _neg_jac(q, nf.g1_mul(gj, ca)))
    jb1 = nf.g1_add(comb1(1), _neg_jac(q, nf.g1_mul(gj, cb)))
    jl = nf.g1_add(comb1(2), _neg_jac(q, nf.g1_mul(gj, cl)))
    jh = nf.combine_windows(wh[0][0], wh[1][0], wh[2][0], W, cfg.c)
    jb2_dev = nf2.combine_windows2(w2[0][0], w2[1][0], w2[2][0], w1, cfg.c)
    if host_g2 is not None:
        jb2_dev = _combine_host_g2(nf2, jb2_dev, host_g2, hw0, cfg.c)
    jb2 = nf2.g2_add(jb2_dev, neg2(q, nf2.g2_mul(g2j, cb)))

    al, b1p, dl = pk.alpha_g1, pk.beta_g1, pk.delta_g1
    dj = (dl.x, dl.y, 1)
    A = nf.g1_add(nf.g1_add((al.x, al.y, 1), ja), nf.g1_mul(dj, r))
    B1 = nf.g1_add(nf.g1_add((b1p.x, b1p.y, 1), jb1), nf.g1_mul(dj, s))
    b2j, d2j = _g2_jac(pk.beta_g2), _g2_jac(pk.delta_g2)
    B2 = nf2.g2_add(nf2.g2_add(b2j, jb2), nf2.g2_mul(d2j, s))
    rs = r * s % p
    C = nf.g1_add(
        nf.g1_add(jl, jh),
        nf.g1_add(nf.g1_mul(A, s), nf.g1_add(nf.g1_mul(B1, r), _neg_jac(q, nf.g1_mul(dj, rs)))),
    )
    aA = nf.g1_to_affine(A)
    aC = nf.g1_to_affine(C)
    A_pt = g1grp.zero() if aA is None else PointG1(g1grp, aA[0], aA[1])
    C_pt = g1grp.zero() if aC is None else PointG1(g1grp, aC[0], aC[1])
    return A_pt, _g2_from_affine(g2grp, nf2.g2_to_affine(B2)), C_pt


_COMB_CACHE: Dict = {}


def _fb_mul_g1(pt: PointG1, k: int) -> PointG1:
    """Fixed-base scalar mult with a cached comb table."""
    from ..ec.jacobian import comb_mul_g1, comb_table_g1, jac_to_affine

    if pt.infinity:
        return pt
    q = pt.curve.q
    k = int(k) % pt.curve.r
    key = ("g1", q, pt.x, pt.y)
    tbl = _COMB_CACHE.get(key)
    if tbl is None:
        # 4-bit windows over the scalar field's width (95 for BW6-761's
        # 377-bit r; the reference's table stops at 64, 256-bit scalars)
        windows = -(-pt.curve.r.bit_length() // 4)
        tbl = _COMB_CACHE[key] = comb_table_g1(q, (pt.x, pt.y), windows=windows)
    aff = jac_to_affine(q, comb_mul_g1(q, tbl, k))
    if aff is None:
        return PointG1(pt.curve, None, None)
    return PointG1(pt.curve, aff[0], aff[1])


def _fb_mul_g2(pt: PointG2, k: int) -> PointG2:
    from ..ec.jacobian import comb_mul_g2, comb_table_g2, jac2_to_affine
    from ..ec.tower import Fq2

    if pt.infinity or not hasattr(pt.x, "c0"):
        return pt * int(k)
    q = pt.curve.q
    beta = pt.x.ctx.beta
    k = int(k) % pt.curve.r
    key = ("g2", q, pt.x.c0, pt.x.c1, pt.y.c0, pt.y.c1)
    tbl = _COMB_CACHE.get(key)
    if tbl is None:
        tbl = _COMB_CACHE[key] = comb_table_g2(q, beta, ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1)))
    aff = jac2_to_affine(q, beta, comb_mul_g2(q, beta, tbl, k))
    if aff is None:
        return PointG2(pt.curve, None, None)
    return PointG2(
        pt.curve,
        Fq2(pt.x.ctx, aff[0][0], aff[0][1]),
        Fq2(pt.x.ctx, aff[1][0], aff[1][1]),
    )


def _jac_to_g1(curve: str, jac) -> PointG1:
    grp = g1_group(curve)
    jx, jy, jz = jac
    if jz == 0:
        return grp.zero()
    q = grp.q
    zi = pow(jz, -1, q)
    return PointG1(grp, jx * zi * zi % q, jy * zi * zi % q * zi % q)


def _jac_to_g2(curve: str, jac) -> PointG2:
    """Jacobian G2 sums (pairs over Fq2, ints over Fq) -> a host point."""
    from ..ec.tower import Fq2

    grp = g2_group(curve)
    jx, jy, jz = jac
    if not hasattr(grp, "tower"):  # G2 over Fq (BW6-761)
        if jz == 0:
            return grp.zero()
        zi = pow(jz, -1, grp.q)
        return PointG1(grp, jx * zi * zi % grp.q, jy * zi * zi % grp.q * zi % grp.q)
    if jz == (0, 0):
        return grp.zero()
    zi = Fq2(grp.tower, jz[0], jz[1]).inv()
    zi2 = zi * zi
    return PointG2(
        grp,
        Fq2(grp.tower, jx[0], jx[1]) * zi2,
        Fq2(grp.tower, jy[0], jy[1]) * zi2 * zi,
    )


def _finish_python(curve, pk, g1w, wh, w2, corrs, w1, W, cfg, r, s):
    """Pure-Python version of _finish_native (no C compiler needed)."""
    from ..kernels.msm_sorted import combine_windows

    p = P.SCALAR_FIELDS[curve].p
    q = P.BASE_FIELDS[curve].p
    beta = _g2_beta(curve)
    beta = None if beta is None else beta - q
    ca, cb, cl = corrs
    g1 = g1_group(curve).generator()
    g2 = g2_group(curve).generator()

    def g1_res(i):
        wins = (g1w[0][i], g1w[1][i], g1w[2][i])
        return _jac_to_g1(curve, combine_windows(q, p, wins, w1, cfg.c, native=False))

    a_acc = g1_res(0) - _fb_mul_g1(g1, ca)
    b1_acc = g1_res(1) - _fb_mul_g1(g1, cb)
    l_acc = g1_res(2) - _fb_mul_g1(g1, cl)
    h_acc = _jac_to_g1(curve, combine_windows(q, p, (wh[0][0], wh[1][0], wh[2][0]), W, cfg.c, native=False))
    b2_wins = (w2[0][0], w2[1][0], w2[2][0])
    b2_acc = _jac_to_g2(
        curve, combine_windows(q, p, b2_wins, w1, cfg.c, beta=beta, native=False)
    ) - _fb_mul_g2(g2, cb)
    return _randomize_tail(curve, pk, a_acc, b1_acc, b2_acc, l_acc, h_acc, r, s)


def _randomize_tail(curve, pk, a_acc, b1_acc, b2_acc, l_acc, h_acc, r, s):
    """Python-point randomization tail."""
    p = P.SCALAR_FIELDS[curve].p
    delta_g1 = pk.delta_g1
    A = pk.alpha_g1 + a_acc + _fb_mul_g1(delta_g1, r)
    B1 = pk.beta_g1 + b1_acc + _fb_mul_g1(delta_g1, s)
    B2 = pk.beta_g2 + b2_acc + _fb_mul_g2(pk.delta_g2, s)
    rs = r * s % p
    C = l_acc + h_acc + A * s + B1 * r - _fb_mul_g1(delta_g1, rs)
    return A, B2, C


def prove(r1cs: R1CS, pk: ProvingKey, witness: Witness, rng=None, device="cuda",
          timings: Optional[dict] = None) -> Proof:
    """One Groth16 proof. rng() draws the randomizers r, s in that order.
    If `timings` is a dict, per-stage wall seconds are added to it (the
    device is synchronized at each stage boundary)."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p))
    mark = _Stages(timings, device)
    z_limbs = _witness_limbs(r1cs, witness, p, n_limbs(p))
    r, s = rand(), rand()
    (A, B2, C), = _prove_core_sorted_batch(
        curve, pk, r1cs, [z_limbs], z_limbs.shape[0], pk.domain_size, [(r, s)], device, mark
    )
    return _proof_json(r1cs, witness, curve, A, B2, C)


def prove_batch(r1cs: R1CS, pk: ProvingKey, witnesses: Sequence[Witness], rng=None,
                device="cuda", timings: Optional[dict] = None) -> List[Proof]:
    """Proves B witnesses of one circuit in one batched pipeline: one upload
    of the witnesses, one batched h stage (one mulacc_walk call and one
    stacked transform per NTT stage on a CUDA device), the MSMs proof by
    proof, one fetch, and the host tails on threads. Equivalent to
    [prove(r1cs, pk, w) for w in witnesses]: rng() draws r and s for each
    proof in turn (r0, s0, r1, s1, ...), so proof b equals prove() of
    witness b given the same r, s. `timings` as in prove(), summed over
    the batch."""
    curve = r1cs.curve
    if not witnesses:
        return []
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p))
    mark = _Stages(timings, device)
    Z_list = [_witness_limbs(r1cs, w, p, n_limbs(p)) for w in witnesses]
    rs_list = [(rand(), rand()) for _ in witnesses]
    triples = _prove_core_sorted_batch(
        curve, pk, r1cs, Z_list, Z_list[0].shape[0], pk.domain_size, rs_list, device, mark
    )
    return [_proof_json(r1cs, w, curve, *t) for w, t in zip(witnesses, triples)]


def _proof_json(r1cs, witness, curve, A, B2, C) -> Proof:
    return Proof(
        "g16",
        curve,
        {"a": g1_to_json(A, curve), "b": g2_to_json(B2, curve), "c": g1_to_json(C, curve)},
        _public_inputs_json(r1cs, witness, curve),
    )


def verify(vk: VerificationKey, proof: Proof) -> bool:
    curve = vk.curve
    try:
        A = g1_from_json(proof.points["a"], curve)
        B = g2_from_json(proof.points["b"], curve)
        C = g1_from_json(proof.points["c"], curve)
        gamma_abc = [g1_from_json(x, curve) for x in vk.data["gamma_abc"]]
        alpha = g1_from_json(vk.data["alpha"], curve)
        beta = g2_from_json(vk.data["beta"], curve)
        gamma = g2_from_json(vk.data["gamma"], curve)
        delta = g2_from_json(vk.data["delta"], curve)
    except (ValueError, KeyError):
        return False

    inputs = [fr_from_json(x, curve) for x in proof.inputs]
    if len(inputs) + 1 != len(gamma_abc):
        return False

    vk_x = gamma_abc[0]
    for pub, pt in zip(inputs, gamma_abc[1:]):
        vk_x = vk_x + pt * pub

    # e(A,B) = e(alpha,beta) e(vk_x,gamma) e(C,delta)
    return pairing_product_is_one(
        curve,
        [(-A, B), (alpha, beta), (vk_x, gamma), (C, delta)],
    )
