"""bellman/phase2 MPC ceremony artifacts: `mpc.params` + `phase1radix` files.

The counterpart of the JAX package's interop/bellman_mpc.py. The
reference's MPC backend (zokrates_bellman/src/groth16.rs:103-159) is a thin
wrapper over the `phase2` crate (a ZoKrates fork of the zcash phase2
library): `initialize` consumes a phase-1 "powers of tau" radix file and
emits circuit-specific Groth16 parameters with delta = 1, `contribute`
multiplies delta by a secret and publishes a proof-of-knowledge public key,
and `verify` replays the chain. This module implements that artifact
surface natively:

  * the `phase1radix2mN` table file (alpha/beta + Lagrange-basis tau powers
    in both groups + the [tau^i Z(tau)] h terms) — reader, writer, and a
    TEST-ONLY generator (`generate_radix`) standing in for the real Powers
    of Tau ceremony output,
  * the `mpc.params` container: bellman `Parameters` (vk + h/l/a/b_g1/b_g2
    query vectors, uncompressed big-endian points with bellman's
    infinity-flag convention) + a 64-byte cs hash + the contribution list
    (delta_after, s, s_delta, r_delta, transcript),
  * initialize / contribute / verify / export over that container with the
    phase2 trust model: gamma is fixed to one, only delta is randomized,
    and each contribution proves knowledge of its delta factor d via
    same-ratio checks  e(s, r_delta) == e(s_delta, r)  and
    e(delta_prev, r_delta) == e(delta_after, r)  with r = hash_to_g2 over
    the running transcript.

The batch work runs on `device` ("cuda" unless the caller asks for the
CPU), where the JAX package loops on the host:

  * generate_radix: every table by the fixed-base evaluator
    (kernels/fixed_base), the G2 one included;
  * initialize: each query point is a column sum of coefficient * radix
    point terms. The terms are scaled in one batched ladder
    (kernels/ladder.scale_terms: the mixed_add_lm kernel for G1, jec's
    mixed add for G2) and normalized in one batched inversion; the G1
    columns of a, b_g1 and l/ic are summed in one accumulate_lm launch
    (ladder.column_sums_g1), the G2 columns of b_g2 by jec's mixed add
    (ladder.column_sums_ext);
  * contribute: h and l times d^-1 in one batched ladder
    (ladder.scale_affine);
  * verify: initialize again, and each random combination of a query is
    one sorted MSM (groth16._msm_g1: the walk, suffix and epilogue
    kernels);
  * export_keypair: the packed queries, the dummies of absent entries by
    the fixed-base evaluator.

The delta updates, the proof-of-knowledge points, the transcript, the
byte comparisons and the pairings stay host Python.

Byte layout follows the public phase2/bellman serialization structure
(Parameters::write / MPCParameters::write / PublicKey::write), byte for
byte the JAX package's. The one deliberately-divergent primitive is
hash_to_g2 (phase2 seeds a rand-0.4 ChaChaRng and samples the curve's
`random`; this uses a documented try-and-increment over blake2b counters,
as the JAX package does).
"""

from __future__ import annotations

import hashlib
import io
import secrets
import struct
from dataclasses import dataclass, field as dfield
from typing import List, Optional

import numpy as np
import torch

from ..ec.curve import PointG1, PointG2, g1_group, g2_group
from ..ec.pairing import pairing_product_is_one
from ..ec.tower import Fq2
from ..fields import params as P
from ..ir.r1cs import R1CS

# MPC is a bellman-backend feature in the reference: bn128 + bls12_381 only
# (zokrates_cli/src/bin.rs backend gating).
_FQ_BYTES = {"bn128": 32, "bls12_381": 48}


def _fqb(curve: str) -> int:
    try:
        return _FQ_BYTES[curve]
    except KeyError:
        raise ValueError(
            f"phase2 MPC artifacts support bn128/bls12_381, not {curve}"
        ) from None


# ---------------------------------------------------------------------------
# Point codecs — bellman "uncompressed" encoding: x || y big-endian, with
# the infinity flag (0x40) in the top bits of the first byte (the three
# MSBs are free: both moduli are < 2^254 / 2^381).
# ---------------------------------------------------------------------------


def g1_to_bytes(curve: str, pt: Optional[PointG1]) -> bytes:
    nb = _fqb(curve)
    if pt is None or pt.infinity:
        out = bytearray(2 * nb)
        out[0] = 0x40
        return bytes(out)
    return pt.x.to_bytes(nb, "big") + pt.y.to_bytes(nb, "big")


def g1_from_bytes(curve: str, data: bytes, check: bool = True) -> Optional[PointG1]:
    nb = _fqb(curve)
    if len(data) != 2 * nb:
        raise ValueError("bad G1 length")
    if data[0] & 0x40:
        if any(b for b in bytes([data[0] & 0x3F]) + data[1:]):
            raise ValueError("G1 infinity with nonzero body")
        return None
    x = int.from_bytes(data[:nb], "big")
    y = int.from_bytes(data[nb:], "big")
    pt = PointG1(g1_group(curve), x, y)
    if check and not pt.is_on_curve():
        raise ValueError("G1 point not on curve")
    return pt


def g2_to_bytes(curve: str, pt: Optional[PointG2]) -> bytes:
    """Fq2 coordinate order: c1 || c0 (the pairing crate's convention)."""
    nb = _fqb(curve)
    if pt is None or pt.infinity:
        out = bytearray(4 * nb)
        out[0] = 0x40
        return bytes(out)
    return (
        pt.x.c1.to_bytes(nb, "big")
        + pt.x.c0.to_bytes(nb, "big")
        + pt.y.c1.to_bytes(nb, "big")
        + pt.y.c0.to_bytes(nb, "big")
    )


def g2_from_bytes(curve: str, data: bytes, check: bool = True) -> Optional[PointG2]:
    nb = _fqb(curve)
    if len(data) != 4 * nb:
        raise ValueError("bad G2 length")
    if data[0] & 0x40:
        if any(b for b in bytes([data[0] & 0x3F]) + data[1:]):
            raise ValueError("G2 infinity with nonzero body")
        return None
    grp = g2_group(curve)
    c = [int.from_bytes(data[i * nb : (i + 1) * nb], "big") for i in range(4)]
    pt = PointG2(grp, Fq2(grp.tower, c[1], c[0]), Fq2(grp.tower, c[3], c[2]))
    if check and not pt.is_on_curve():
        raise ValueError("G2 point not on curve")
    return pt


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError("unexpected EOF")
    return data


def _read_g1(curve: str, f) -> Optional[PointG1]:
    return g1_from_bytes(curve, _read_exact(f, 2 * _fqb(curve)))


def _read_g2(curve: str, f) -> Optional[PointG2]:
    return g2_from_bytes(curve, _read_exact(f, 4 * _fqb(curve)))


# ---------------------------------------------------------------------------
# phase1radix: the Powers-of-Tau output specialized to one domain size.
# Layout (phase2 MPCParameters::new read order): alpha_g1, beta_g1, beta_g2,
# then n Lagrange coeffs in G1, n in G2, n alpha-coeffs (G1), n beta-coeffs
# (G1), then n-1 h terms [tau^i * Z(tau)] G1.
# ---------------------------------------------------------------------------


@dataclass
class Phase1Radix:
    curve: str
    alpha_g1: PointG1
    beta_g1: PointG1
    beta_g2: PointG2
    coeffs_g1: List[Optional[PointG1]]  # [L_i(tau)] G1
    coeffs_g2: List[Optional[PointG2]]  # [L_i(tau)] G2
    alpha_coeffs_g1: List[Optional[PointG1]]  # [alpha L_i(tau)] G1
    beta_coeffs_g1: List[Optional[PointG1]]  # [beta L_i(tau)] G1
    h: List[Optional[PointG1]]  # [tau^i Z(tau)] G1, i < n-1

    @property
    def n(self) -> int:
        return len(self.coeffs_g1)

    def write(self, f) -> None:
        c = self.curve
        f.write(g1_to_bytes(c, self.alpha_g1))
        f.write(g1_to_bytes(c, self.beta_g1))
        f.write(g2_to_bytes(c, self.beta_g2))
        for pt in self.coeffs_g1:
            f.write(g1_to_bytes(c, pt))
        for pt in self.coeffs_g2:
            f.write(g2_to_bytes(c, pt))
        for pt in self.alpha_coeffs_g1:
            f.write(g1_to_bytes(c, pt))
        for pt in self.beta_coeffs_g1:
            f.write(g1_to_bytes(c, pt))
        for pt in self.h:
            f.write(g1_to_bytes(c, pt))

    @classmethod
    def read(cls, curve: str, f, n: int) -> "Phase1Radix":
        """n is the domain size (the reference infers it from the circuit
        and picks the matching phase1radix2m{k} file)."""
        alpha = _read_g1(curve, f)
        beta1 = _read_g1(curve, f)
        beta2 = _read_g2(curve, f)
        out = cls(curve, alpha, beta1, beta2, [], [], [], [], [])
        out.coeffs_g1 = [_read_g1(curve, f) for _ in range(n)]
        out.coeffs_g2 = [_read_g2(curve, f) for _ in range(n)]
        out.alpha_coeffs_g1 = [_read_g1(curve, f) for _ in range(n)]
        out.beta_coeffs_g1 = [_read_g1(curve, f) for _ in range(n)]
        out.h = [_read_g1(curve, f) for _ in range(n - 1)]
        return out



def _g2_points(curve: str, scalars: List[int], device) -> List[Optional[PointG2]]:
    """s_i * G2 by the fixed-base evaluator on `device`, as host points."""
    from ..kernels.jec import curve_ops_g2
    from ..schemes.groth16 import _fb_g2

    grp = g2_group(curve)
    ax, ay, mask = _fb_g2(curve, scalars, device)
    f = curve_ops_g2(curve).f
    xs, ys = f.decode(ax), f.decode(ay)
    mask = mask.cpu().numpy()
    return [PointG2(grp, Fq2(grp.tower, *x), Fq2(grp.tower, *y)) if ok else None
            for x, y, ok in zip(xs, ys, mask)]


def generate_radix(curve: str, n: int, rng=None, device="cuda") -> Phase1Radix:
    """TEST-ONLY phase-1 substitute: samples fresh (tau, alpha, beta) and
    evaluates the radix tables with fixed-base multiplications on `device`.
    The real file comes from the public Powers of Tau ceremony — this
    generator exists so the phase-2 pipeline is testable end-to-end
    in-process."""
    from ..kernels.ntt import domain_for_curve
    from ..schemes.groth16 import _fb_g1_points, _lagrange_at_tau

    assert n & (n - 1) == 0, "domain size must be a power of two"
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p - 1) + 1)
    tau, alpha, beta = rand(), rand(), rand()
    dom = domain_for_curve(curve, n)
    lag = _lagrange_at_tau(p, n, dom.omega, tau)
    z_tau = (pow(tau, n, p) - 1) % p

    g1 = g1_group(curve).generator()
    g2 = g2_group(curve).generator()

    h_s = []
    tp = z_tau
    for _ in range(n - 1):
        h_s.append(tp)
        tp = tp * tau % p
    # the four G1 tables in one fixed-base evaluation
    g1s = _fb_g1_points(curve, lag + [alpha * v % p for v in lag] + [beta * v % p for v in lag] + h_s, device)
    coeffs_g1, alpha_coeffs_g1, beta_coeffs_g1, h = g1s[:n], g1s[n : 2 * n], g1s[2 * n : 3 * n], g1s[3 * n :]
    coeffs_g2 = _g2_points(curve, lag, device)

    return Phase1Radix(
        curve=curve,
        alpha_g1=g1 * alpha,
        beta_g1=g1 * beta,
        beta_g2=g2 * beta,
        coeffs_g1=coeffs_g1,
        coeffs_g2=coeffs_g2,
        alpha_coeffs_g1=alpha_coeffs_g1,
        beta_coeffs_g1=beta_coeffs_g1,
        h=h,
    )


# ---------------------------------------------------------------------------
# bellman groth16::Parameters — the pk/vk payload inside mpc.params.
# Write order (Parameters::write): vk { alpha_g1, beta_g1, beta_g2,
# gamma_g2, delta_g1, delta_g2, u32-BE ic_len, ic... }, then each query
# vector as u32-BE length + uncompressed points: h, l, a, b_g1, b_g2.
# ---------------------------------------------------------------------------


@dataclass
class BellmanParameters:
    curve: str
    alpha_g1: PointG1
    beta_g1: PointG1
    beta_g2: PointG2
    gamma_g2: PointG2
    delta_g1: PointG1
    delta_g2: PointG2
    ic: List[PointG1]
    h: List[PointG1]
    l: List[PointG1]
    a: List[Optional[PointG1]]
    b_g1: List[Optional[PointG1]]
    b_g2: List[Optional[PointG2]]

    def write(self, f) -> None:
        c = self.curve
        f.write(g1_to_bytes(c, self.alpha_g1))
        f.write(g1_to_bytes(c, self.beta_g1))
        f.write(g2_to_bytes(c, self.beta_g2))
        f.write(g2_to_bytes(c, self.gamma_g2))
        f.write(g1_to_bytes(c, self.delta_g1))
        f.write(g2_to_bytes(c, self.delta_g2))
        f.write(struct.pack(">I", len(self.ic)))
        for pt in self.ic:
            f.write(g1_to_bytes(c, pt))
        for vec, enc in (
            (self.h, g1_to_bytes),
            (self.l, g1_to_bytes),
            (self.a, g1_to_bytes),
            (self.b_g1, g1_to_bytes),
            (self.b_g2, g2_to_bytes),
        ):
            f.write(struct.pack(">I", len(vec)))
            for pt in vec:
                f.write(enc(c, pt))

    @classmethod
    def read(cls, curve: str, f) -> "BellmanParameters":
        alpha_g1 = _read_g1(curve, f)
        beta_g1 = _read_g1(curve, f)
        beta_g2 = _read_g2(curve, f)
        gamma_g2 = _read_g2(curve, f)
        delta_g1 = _read_g1(curve, f)
        delta_g2 = _read_g2(curve, f)

        def vec(reader):
            (ln,) = struct.unpack(">I", _read_exact(f, 4))
            return [reader(curve, f) for _ in range(ln)]

        ic = vec(_read_g1)
        h = vec(_read_g1)
        l = vec(_read_g1)
        a = vec(_read_g1)
        b_g1 = vec(_read_g1)
        b_g2 = vec(_read_g2)
        return cls(
            curve, alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2,
            ic, h, l, a, b_g1, b_g2,
        )


# ---------------------------------------------------------------------------
# PublicKey + MPCParameters containers
# ---------------------------------------------------------------------------


@dataclass
class PublicKey:
    delta_after: PointG1
    s: PointG1
    s_delta: PointG1
    r_delta: PointG2
    transcript: bytes  # 64 bytes

    def write(self, curve: str, f) -> None:
        f.write(g1_to_bytes(curve, self.delta_after))
        f.write(g1_to_bytes(curve, self.s))
        f.write(g1_to_bytes(curve, self.s_delta))
        f.write(g2_to_bytes(curve, self.r_delta))
        assert len(self.transcript) == 64
        f.write(self.transcript)

    @classmethod
    def read(cls, curve: str, f) -> "PublicKey":
        return cls(
            delta_after=_read_g1(curve, f),
            s=_read_g1(curve, f),
            s_delta=_read_g1(curve, f),
            r_delta=_read_g2(curve, f),
            transcript=_read_exact(f, 64),
        )

    def to_bytes(self, curve: str) -> bytes:
        buf = io.BytesIO()
        self.write(curve, buf)
        return buf.getvalue()


@dataclass
class MPCParameters:
    curve: str
    params: BellmanParameters
    cs_hash: bytes  # 64 bytes
    contributions: List[PublicKey] = dfield(default_factory=list)

    def write(self, f) -> None:
        self.params.write(f)
        assert len(self.cs_hash) == 64
        f.write(self.cs_hash)
        f.write(struct.pack(">I", len(self.contributions)))
        for pk in self.contributions:
            pk.write(self.curve, f)

    @classmethod
    def read(cls, curve: str, f) -> "MPCParameters":
        params = BellmanParameters.read(curve, f)
        cs_hash = _read_exact(f, 64)
        (ln,) = struct.unpack(">I", _read_exact(f, 4))
        contributions = [PublicKey.read(curve, f) for _ in range(ln)]
        return cls(curve, params, cs_hash, contributions)


# ---------------------------------------------------------------------------
# Ceremony operations
# ---------------------------------------------------------------------------


def _sqrt_fq(q: int, a: int) -> Optional[int]:
    """Tonelli-Shanks square root in Fq; None if a is a non-residue."""
    a %= q
    if a == 0:
        return 0
    if pow(a, (q - 1) // 2, q) != 1:
        return None
    if q % 4 == 3:
        return pow(a, (q + 1) // 4, q)
    # full Tonelli-Shanks
    s, t = 0, q - 1
    while t % 2 == 0:
        s += 1
        t //= 2
    z = 2
    while pow(z, (q - 1) // 2, q) != q - 1:
        z += 1
    m, c, u, r = s, pow(z, t, q), pow(a, t, q), pow(a, (t + 1) // 2, q)
    while u != 1:
        i, tmp = 0, u
        while tmp != 1:
            tmp = tmp * tmp % q
            i += 1
        b = pow(c, 1 << (m - i - 1), q)
        m, c = i, b * b % q
        u, r = u * c % q, r * b % q
    return r


def _sqrt_fq2(x: Fq2) -> Optional[Fq2]:
    """Square root in Fq2 = Fq[u]/(u^2 - beta) by the norm method."""
    ctx = x.ctx
    q, beta = ctx.q, ctx.beta
    if x.is_zero():
        return Fq2(ctx, 0, 0)
    a0, a1 = x.c0, x.c1
    if a1 == 0:
        r = _sqrt_fq(q, a0)
        if r is not None:
            return Fq2(ctx, r, 0)
        r = _sqrt_fq(q, a0 * pow(beta, -1, q) % q)
        return None if r is None else Fq2(ctx, 0, r)
    norm = (a0 * a0 - beta * a1 * a1) % q
    alpha = _sqrt_fq(q, norm)
    if alpha is None:
        return None
    inv2 = pow(2, -1, q)
    for sgn in (alpha, q - alpha):
        x0sq = (a0 + sgn) * inv2 % q
        x0 = _sqrt_fq(q, x0sq)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0, -1, q) % q
        cand = Fq2(ctx, x0, x1)
        if cand * cand == x:
            return cand
    return None


def _mul_unreduced_g2(pt: PointG2, k: int) -> PointG2:
    """Double-and-add WITHOUT reducing k mod r: needed for cofactor
    clearing, where the input point's order is not r (PointG2.__mul__
    reduces mod the subgroup order, which is only valid in-subgroup)."""
    acc = PointG2(pt.curve, None, None)
    add = pt
    while k:
        if k & 1:
            acc = acc + add
        add = add + add
        k >>= 1
    return acc


# G2 cofactors h2 = |E'(Fq2)| / r (standard published curve constants;
# bn128's equals 2q - r by the BN trace identity)
_G2_COFACTOR = {
    "bn128": 21888242871839275222246405745257275088844257914179612981679871602714643921549,
    "bls12_381": 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5,
}


def _hash_to_g2(curve: str, digest: bytes) -> PointG2:
    """Deterministic digest -> G2 point (try-and-increment over blake2b
    counters, then cofactor-clear). DOCUMENTED DIVERGENCE from phase2,
    which seeds a rand-0.4 ChaChaRng with the digest and calls G2::random;
    the security property (r is an opaque point nobody knows the dlog of)
    is the same."""
    grp = g2_group(curve)
    q = grp.tower.q
    cof = _G2_COFACTOR[curve]
    ctr = 0
    while True:
        h1 = hashlib.blake2b(digest + b"c0" + ctr.to_bytes(4, "big")).digest()
        h2 = hashlib.blake2b(digest + b"c1" + ctr.to_bytes(4, "big")).digest()
        x = Fq2(grp.tower, int.from_bytes(h1, "big") % q, int.from_bytes(h2, "big") % q)
        rhs = x * x * x + grp.b2
        y = _sqrt_fq2(rhs)
        if y is not None:
            pt = _mul_unreduced_g2(PointG2(grp, x, y), cof)
            if not pt.infinity:
                return pt
        ctr += 1


def _params_hash(params: BellmanParameters) -> bytes:
    buf = io.BytesIO()
    params.write(buf)
    return hashlib.blake2b(buf.getvalue(), digest_size=64).digest()


def _g1_table(curve: str, pts: List[Optional[PointG1]], device):
    """Host G1 points -> affine Montgomery (x, y) (n, nl) on `device` and a
    host mask of the real points (None and infinity hold zeros)."""
    from ..schemes.groth16 import _mont_elems

    q = P.BASE_FIELDS[curve].p
    ok = np.asarray([pt is not None and not pt.infinity for pt in pts], dtype=bool)
    xs = [pt.x if o else 0 for pt, o in zip(pts, ok)]
    ys = [pt.y if o else 0 for pt, o in zip(pts, ok)]
    return _mont_elems(q, xs, device), _mont_elems(q, ys, device), ok


def _g2_table(curve: str, pts: List[Optional[PointG2]], device):
    """Host G2 points -> affine Montgomery (x, y) (n, 2, nl) on `device` and
    a host mask of the real points."""
    from ..schemes.groth16 import _mont_elems

    q = P.BASE_FIELDS[curve].p
    ok = np.asarray([pt is not None and not pt.infinity for pt in pts], dtype=bool)

    def coord(get):
        ints = [v for pt, o in zip(pts, ok) for v in ((get(pt).c0, get(pt).c1) if o else (0, 0))]
        return _mont_elems(q, ints, device).reshape(len(pts), 2, -1)

    return coord(lambda pt: pt.x), coord(lambda pt: pt.y), ok


class TermSums:
    """Sparse per-column sums of coefficient * point terms over one group,
    on a device: terms are collected on the host, then `points()` scales
    them in one batched ladder (kernels/ladder.scale_terms), normalizes them
    in one batched inversion and sums each column (G1: one accumulate_lm
    launch, ladder.column_sums_g1; G2: jec's mixed add,
    ladder.column_sums_ext). The result is the JAX package's _PointAccum's:
    None for a column with no term or whose sum is the point at infinity.

    The points live in one table of `n_table` entries (affine Montgomery
    coordinates on the device, mask of the real ones); a term names its
    column, its table entry and its coefficient."""

    def __init__(self, curve: str, group: str, ncols: int, table):
        self.curve = curve
        self.group = group
        self.ncols = ncols
        self.tx, self.ty, self.ok = table
        self.r = P.SCALAR_FIELDS[curve].p
        self.cols: List[int] = []
        self.idx: List[int] = []
        self.coefs: List[int] = []

    def add(self, col: int, idx: int, coef: int) -> None:
        coef %= self.r
        if coef and self.ok[idx]:
            self.cols.append(col)
            self.idx.append(idx)
            self.coefs.append(coef)

    def jacobian(self):
        """The columns' sums as a Jacobian batch (ncols,) on the device."""
        from ..kernels import ladder
        from ..kernels.fixed_base import batch_normalize
        from ..kernels.jec import curve_ops, curve_ops_g2

        q = P.BASE_FIELDS[self.curve].p
        g1 = self.group == "g1"
        ops = curve_ops(q) if g1 else curve_ops_g2(self.curve)
        dev = self.tx.device
        if not self.cols:
            return ops.infinity((self.ncols,), dev)
        idx = torch.as_tensor(np.asarray(self.idx, np.int64), device=dev)
        add = ladder.g1_adder(q) if g1 else ops.mixed_add
        terms = ladder.scale_terms(ops, add, self.tx[idx], self.ty[idx], self.coefs, self.r)
        ax, ay, inf = batch_normalize(ops, terms)
        keep = ~inf.cpu().numpy()  # a term at infinity adds nothing
        cols = np.asarray(self.cols, np.int64)
        if not keep.all():
            kt = torch.as_tensor(keep, device=dev)
            ax, ay, cols = ax[kt], ay[kt], cols[keep]
        if g1:
            return ladder.column_sums_g1(q, ax, ay, cols, self.ncols)[0]
        return ladder.column_sums_ext(ops, ax, ay, cols, self.ncols)

    def points(self) -> List[Optional[object]]:
        from ..kernels.jec import curve_ops, curve_ops_g2

        if self.group == "g1":
            grp = g1_group(self.curve)
            aff = curve_ops(grp.q).to_affine_ints(self.jacobian())
            return [None if a is None else PointG1(grp, a[0], a[1]) for a in aff]
        grp = g2_group(self.curve)
        aff = curve_ops_g2(self.curve).to_affine_ints(self.jacobian())
        return [None if a is None else PointG2(grp, Fq2(grp.tower, *a[0]), Fq2(grp.tower, *a[1]))
                for a in aff]


def accumulations(r1cs: R1CS, radix: Phase1Radix, device):
    """The terms of initialize's four accumulations, on `device`: one G1
    TermSums over 3m columns (a at [0, m), b_g1 at [m, 2m), the l/ic
    combination beta*u + alpha*v + w at [2m, 3m)) over the table [coeffs_g1
    | beta_coeffs_g1 | alpha_coeffs_g1], and one G2 TermSums (b_g2) over
    coeffs_g2."""
    curve = r1cs.curve
    nc, ni, m = r1cs.num_constraints, r1cs.num_instance, r1cs.num_variables
    n = radix.n
    t1 = _g1_table(curve, radix.coeffs_g1 + radix.beta_coeffs_g1 + radix.alpha_coeffs_g1, device)
    g1 = TermSums(curve, "g1", 3 * m, t1)
    g2 = TermSums(curve, "g2", m, _g2_table(curve, radix.coeffs_g2, device))
    A, B, EXT = 0, m, 2 * m           # column bases
    LAG, BETA, ALPHA = 0, n, 2 * n    # table bases
    for r, row in enumerate(r1cs.A):
        for j, coef in row:
            g1.add(A + j, LAG + r, coef)
            g1.add(EXT + j, BETA + r, coef)
    for j in range(ni):  # instance-binding rows
        g1.add(A + j, LAG + nc + j, 1)
        g1.add(EXT + j, BETA + nc + j, 1)
    for r, row in enumerate(r1cs.B):
        for j, coef in row:
            g1.add(B + j, LAG + r, coef)
            g2.add(j, r, coef)
            g1.add(EXT + j, ALPHA + r, coef)
    for r, row in enumerate(r1cs.C):
        for j, coef in row:
            g1.add(EXT + j, LAG + r, coef)
    return g1, g2


def initialize(r1cs: R1CS, radix: Phase1Radix, device="cuda") -> MPCParameters:
    """phase2 MPCParameters::new: build circuit-specific Groth16 parameters
    from the phase-1 radix tables with gamma = delta = 1.

    Query math (in the exponent; L_i = Lagrange basis at tau):
      a[j]    = sum_r u_{r,j} [L_r]          (A-matrix column j)
      b_g1/b_g2 similarly over B
      ic/l[j] = [beta u_j + alpha v_j + w_j] via the alpha/beta coeff tables
      h[i]    = [tau^i Z(tau)] straight from the radix.
    Instance-binding rows (A[nc + j] += 1 at instance j) mirror
    schemes/groth16.setup so proofs bind public inputs identically. The
    column sums run on `device` (accumulations)."""
    curve = r1cs.curve
    if radix.curve != curve:
        raise ValueError("radix curve mismatch")
    nc, ni, m = r1cs.num_constraints, r1cs.num_instance, r1cs.num_variables
    n = 1 << max(1, (nc + ni - 1).bit_length())
    if radix.n != n:
        # Lagrange tables are domain-size specific (the reference ships one
        # phase1radix2m{k} file per k and picks the matching one)
        raise ValueError(f"radix is for domain 2^{radix.n.bit_length() - 1}, circuit needs {n}")

    acc_g1, acc_b2 = accumulations(r1cs, radix, device)
    g1_sums = acc_g1.points()
    a_q, b1_q, ext = g1_sums[:m], g1_sums[m : 2 * m], g1_sums[2 * m :]
    b2_q = acc_b2.points()

    g1 = g1_group(curve).generator()
    g2 = g2_group(curve).generator()
    zero1 = PointG1(g1_group(curve), None, None)

    ic = [pt if pt is not None else zero1 for pt in ext[:ni]]
    l_q = [pt if pt is not None else zero1 for pt in ext[ni:]]
    h_q = [pt for pt in radix.h[: n - 1]]

    params = BellmanParameters(
        curve=curve,
        alpha_g1=radix.alpha_g1,
        beta_g1=radix.beta_g1,
        beta_g2=radix.beta_g2,
        gamma_g2=g2,  # gamma = 1
        delta_g1=g1,  # delta = 1
        delta_g2=g2,
        ic=ic,
        h=h_q,
        l=l_q,
        a=a_q,
        b_g1=b1_q,
        b_g2=b2_q,
    )
    return MPCParameters(
        curve=curve,
        params=params,
        cs_hash=_params_hash(params),
        contributions=[],
    )


def _scale_points(curve: str, pts: List[Optional[PointG1]], k: int, device) -> List[Optional[PointG1]]:
    """k * P for every point in one batched ladder on `device`
    (ladder.scale_affine); None and infinity entries become None."""
    from ..kernels.jec import curve_ops
    from ..kernels.ladder import scale_affine

    grp = g1_group(curve)
    ax, ay, ok = _g1_table(curve, pts, device)
    live = np.flatnonzero(ok)
    out: List[Optional[PointG1]] = [None] * len(pts)
    if live.size:
        t = torch.as_tensor(live, device=ax.device)
        aff = curve_ops(grp.q).to_affine_ints(scale_affine(curve, ax[t], ay[t], k % grp.r))
        for i, a in zip(live, aff):
            out[i] = None if a is None else PointG1(grp, a[0], a[1])
    return out


def contribute(mpc: MPCParameters, entropy: Optional[str] = None, device="cuda") -> bytes:
    """Apply one participant's secret d: delta *= d, h/l /= d (one batched
    ladder on `device`); publish the phase2-style proof of knowledge.
    Returns the 64-byte contribution hash (blake2b of the serialized public
    key)."""
    curve = mpc.curve
    r_ord = P.SCALAR_FIELDS[curve].p
    params = mpc.params
    g1 = g1_group(curve).generator()

    seed = (entropy or "").encode() + secrets.token_bytes(32)
    d = int.from_bytes(hashlib.sha512(seed + b"d").digest(), "big") % (r_ord - 1) + 1
    rho = int.from_bytes(hashlib.sha512(seed + b"s").digest(), "big") % (r_ord - 1) + 1
    d_inv = pow(d, -1, r_ord)

    s = g1 * rho
    s_delta = s * d

    # transcript = H(cs_hash || prior pubkeys || s || s_delta)
    h = hashlib.blake2b(digest_size=64)
    h.update(mpc.cs_hash)
    for pk in mpc.contributions:
        h.update(pk.to_bytes(curve))
    h.update(g1_to_bytes(curve, s))
    h.update(g1_to_bytes(curve, s_delta))
    transcript = h.digest()

    r_pt = _hash_to_g2(curve, transcript)
    r_delta = r_pt * d

    delta_after = params.delta_g1 * d
    pubkey = PublicKey(
        delta_after=delta_after,
        s=s,
        s_delta=s_delta,
        r_delta=r_delta,
        transcript=transcript,
    )

    params.delta_g1 = delta_after
    params.delta_g2 = params.delta_g2 * d
    nh = len(params.h)
    scaled = _scale_points(curve, params.h + params.l, d_inv, device)
    params.h, params.l = scaled[:nh], scaled[nh:]
    mpc.contributions.append(pubkey)
    return hashlib.blake2b(pubkey.to_bytes(curve), digest_size=64).digest()


def beacon(mpc: MPCParameters, beacon_hash: str, iterations: int = 10, device="cuda") -> bytes:
    h = bytes.fromhex(beacon_hash)
    for _ in range(1 << min(iterations, 24)):
        h = hashlib.sha256(h).digest()
    return contribute(mpc, entropy=h.hex(), device=device)


def verify(
    mpc: MPCParameters, r1cs: R1CS, radix: Phase1Radix, rng=None, device="cuda"
) -> List[bytes]:
    """Replay the chain: rebuild the initial parameters from (circuit,
    radix) on `device`, check every contribution's proof of knowledge and
    delta ratio, and check the final h/l queries against the initial ones
    with a random-combination same-ratio test (phase2's merge_pairs check;
    each combination one sorted MSM on `device`). Returns the list of
    contribution hashes; raises ValueError on failure."""
    curve = mpc.curve
    initial = initialize(r1cs, radix, device=device)
    if initial.cs_hash != mpc.cs_hash:
        raise ValueError("cs_hash mismatch: wrong circuit or radix")
    params = mpc.params
    g2 = g2_group(curve).generator()

    # immutable sections must match the initial build exactly
    init_p = initial.params
    for fieldname in ("alpha_g1", "beta_g1"):
        if getattr(params, fieldname) != getattr(init_p, fieldname):
            raise ValueError(f"{fieldname} tampered")
    for fieldname in ("beta_g2", "gamma_g2"):
        if g2_to_bytes(curve, getattr(params, fieldname)) != g2_to_bytes(
            curve, getattr(init_p, fieldname)
        ):
            raise ValueError(f"{fieldname} tampered")
    if [g1_to_bytes(curve, pt) for pt in params.ic] != [
        g1_to_bytes(curve, pt) for pt in init_p.ic
    ]:
        raise ValueError("ic tampered")
    for name in ("a", "b_g1"):
        if [g1_to_bytes(curve, pt) for pt in getattr(params, name)] != [
            g1_to_bytes(curve, pt) for pt in getattr(init_p, name)
        ]:
            raise ValueError(f"{name} query tampered")
    if [g2_to_bytes(curve, pt) for pt in params.b_g2] != [
        g2_to_bytes(curve, pt) for pt in init_p.b_g2
    ]:
        raise ValueError("b_g2 query tampered")

    hashes = []
    delta_prev = init_p.delta_g1  # = G1 generator
    seen: List[PublicKey] = []
    for pk in mpc.contributions:
        # recompute the transcript this contribution must have committed to
        h = hashlib.blake2b(digest_size=64)
        h.update(mpc.cs_hash)
        for prior in seen:
            h.update(prior.to_bytes(curve))
        h.update(g1_to_bytes(curve, pk.s))
        h.update(g1_to_bytes(curve, pk.s_delta))
        if h.digest() != pk.transcript:
            raise ValueError("transcript mismatch")
        r_pt = _hash_to_g2(curve, pk.transcript)
        # proof of knowledge: e(s_delta, r) == e(s, r_delta)
        if not _same_ratio(curve, pk.s, pk.s_delta, r_pt, pk.r_delta):
            raise ValueError("invalid proof of knowledge")
        # delta progression: e(delta_after, r) == e(delta_prev, r_delta)
        if not _same_ratio(curve, delta_prev, pk.delta_after, r_pt, pk.r_delta):
            raise ValueError("invalid delta transition")
        delta_prev = pk.delta_after
        seen.append(pk)
        hashes.append(
            hashlib.blake2b(pk.to_bytes(curve), digest_size=64).digest()
        )
    if delta_prev != params.delta_g1:
        raise ValueError("final delta_g1 does not match the chain")
    # delta_g2 consistency: e(delta_g1, G2) == e(G1, delta_g2)
    g1 = g1_group(curve).generator()
    if not pairing_product_is_one(
        curve, [(params.delta_g1, g2), (-g1, params.delta_g2)]
    ):
        raise ValueError("delta_g2 inconsistent with delta_g1")
    # h/l queries = initial ones scaled by delta^{-1}: random-combination
    # same-ratio check  e(sum rho_i P_i, delta_g2) == e(sum rho_i P0_i, G2)
    rand = rng or (lambda: secrets.randbelow(P.SCALAR_FIELDS[curve].p))
    for cur, init in ((params.h, init_p.h), (params.l, init_p.l)):
        if len(cur) != len(init):
            raise ValueError("query length changed")
        if not cur:
            continue
        rhos = [rand() for _ in cur]
        comb_cur = _lincomb(curve, cur, rhos, device)
        comb_init = _lincomb(curve, init, rhos, device)
        if comb_cur is None or comb_init is None:
            if comb_cur is not comb_init:
                raise ValueError("query tampered (zero combination)")
            continue
        if not pairing_product_is_one(
            curve, [(comb_cur, params.delta_g2), (-comb_init, g2)]
        ):
            raise ValueError("h/l queries inconsistent with delta")
    return hashes


def _lincomb(curve: str, points: List[Optional[PointG1]], rhos: List[int], device) -> Optional[PointG1]:
    """sum rho_i P_i over the real points and nonzero rhos as one sorted MSM
    on `device` (groth16._msm_g1); None where no term is left."""
    from ..schemes.groth16 import _msm_g1

    pairs = [((pt.x, pt.y), rho) for pt, rho in zip(points, rhos)
             if pt is not None and not pt.infinity and rho != 0]
    if not pairs:
        return None
    return _msm_g1(curve, [pt for pt, _ in pairs], [rho for _, rho in pairs], device=device)


def _same_ratio(curve: str, a1: PointG1, b1: PointG1, a2: PointG2, b2: PointG2) -> bool:
    """e(b1, a2) == e(a1, b2) — (a1 : b1) and (a2 : b2) share a ratio."""
    return pairing_product_is_one(curve, [(b1, a2), (-a1, b2)])


def export_keypair(mpc: MPCParameters, r1cs: R1CS, device="cuda"):
    """Final (ProvingKey, VerificationKey) in the port's key types, ready
    for schemes.groth16.prove/verify (reference: export_keypair,
    zokrates_bellman/src/groth16.rs:152-159). The queries are packed as
    groth16.setup packs them, the b2 query's absent entries included (the
    dummies (i+1)*G1 and (i+1)*G2 by the fixed-base evaluator on
    `device`); the key has no shifted h copies (h16_p128 None), so it
    proves by the dense h MSM.

    The bellman query layout differs from ark's only in which element set
    carries gamma (fixed to 1 here), so the exported vk verifies with the
    standard Groth16 equation."""
    from ..fields.jfield import field_ops
    from ..fields.limbs import n_limbs
    from ..kernels.msm_sorted import pack_points_g2
    from ..schemes.groth16 import ProvingKey, _fb_g1, _fb_g2, _pack_query, _pack_query_dummied
    from ..schemes.types import VerificationKey, g1_to_json, g2_to_json

    curve = mpc.curve
    params = mpc.params
    ni = r1cs.num_instance
    m = r1cs.num_variables
    nc = r1cs.num_constraints
    n = 1 << max(1, (nc + ni - 1).bit_length())

    def tup(pt):
        return None if pt is None or pt.infinity else (pt.x, pt.y)

    a_full = [tup(pt) for pt in params.a]
    b1_full = [tup(pt) for pt in params.b_g1]
    l_full = [None] * ni + [tup(pt) for pt in params.l]
    h_pts = [tup(pt) for pt in params.h]

    # the dummies (i+1)*G1 of the three queries' absent entries, i < m, in
    # one fixed-base evaluation
    dummy_rows, _ = _fb_g1(curve, list(range(1, m + 1)), device)
    a_p128, a_mask, corr_a = _pack_query_dummied(curve, a_full, device, dummy_rows)
    b1_p128, b_mask, corr_b = _pack_query_dummied(curve, b1_full, device, dummy_rows)
    l_p128, l_mask, corr_l = _pack_query_dummied(curve, l_full, device, dummy_rows)
    h_p128, _ = _pack_query(curve, [pt if pt else (0, 0) for pt in h_pts], device)

    # the b2 query z-aligned like b_g1: the DISTINCT dummy (i+1)*G2 at an
    # absent entry, which the prover's b correction (corr_w[1], (i+1) at
    # the dummies) subtracts from the b2 sum as it does from b1's; the JAX
    # package writes the G2 generator there, which only its XLA prover
    # (masking those scalars) proves with
    q = P.BASE_FIELDS[curve].p
    fq = field_ops(q)
    b2_mask = np.asarray([pt is not None and not pt.infinity for pt in params.b_g2], dtype=bool)
    pts2 = [pt if ok else g2_group(curve).generator() for pt, ok in zip(params.b_g2, b2_mask)]
    b2x = fq.encode([c for pt in pts2 for c in (pt.x.c0, pt.x.c1)], device=device).reshape(m, 2, -1)
    b2y = fq.encode([c for pt in pts2 for c in (pt.y.c0, pt.y.c1)], device=device).reshape(m, 2, -1)
    dummies = np.flatnonzero(~b2_mask)
    if dummies.size:
        dx, dy, _ = _fb_g2(curve, [int(i) + 1 for i in dummies], device)
        t = torch.as_tensor(dummies, device=b2x.device)
        b2x[t], b2y[t] = dx, dy
    if 6 * n_limbs(q) <= 128:
        b2_p128 = pack_points_g2(q, b2x, b2y).cpu().numpy().astype(np.uint32)
        b2_xy = None
    else:  # a packed G2 row over 128 words (the BLS12 curves): keep x, y
        b2_p128 = None
        b2_xy = (b2x.cpu().numpy().astype(np.uint32), b2y.cpu().numpy().astype(np.uint32))

    corr_w = np.stack([corr_a, corr_b, corr_l])
    pk = ProvingKey(
        curve=curve,
        domain_size=n,
        num_instance=ni,
        alpha_g1=params.alpha_g1,
        beta_g1=params.beta_g1,
        beta_g2=params.beta_g2,
        delta_g1=params.delta_g1,
        delta_g2=params.delta_g2,
        a_p128=a_p128,
        a_mask=a_mask,
        b1_p128=b1_p128,
        b1_mask=b_mask,
        b2_p128=b2_p128,
        b2_mask=b2_mask,
        h_p128=h_p128,
        l_p128=l_p128,
        l_mask=l_mask,
        corr_w=corr_w,
        b2_xy=b2_xy,
        h16_p128=None,
    )
    vk = VerificationKey(
        "g16",
        curve,
        {
            "alpha": g1_to_json(params.alpha_g1, curve),
            "beta": g2_to_json(params.beta_g2, curve),
            "gamma": g2_to_json(params.gamma_g2, curve),
            "delta": g2_to_json(params.delta_g2, curve),
            "gamma_abc": [g1_to_json(pt, curve) for pt in params.ic],
        },
    )
    return pk, vk
