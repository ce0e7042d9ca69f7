"""Marlin: universal-setup zkSNARK (AHP for R1CS + KZG10 commitments).

Reference backend: zokrates_ark/src/marlin.rs (ark-marlin + ark-poly-commit):
universal SRS of 2^size powers-of-tau (marlin.rs:119-132), circuit
specialization/indexing (marlin.rs:134-207), VK/proof JSON shapes in
zokrates_proof_systems/src/scheme/marlin.rs:81-90.

The counterpart of the JAX package's schemes/marlin.py: the same index,
transcript, masks, proof JSON and checks, so under the same SRS rng and
prover rng a proof is byte-equal to the reference's. `device` ("cuda" by
default) carries every KZG commitment (the sorted MSM's CUDA kernels,
through kzg) and every polynomial transform (Domain.fft_ints / ifft_ints:
the NTT pass kernel and emul); verification stays on the host (pairings).

The protocol is re-derived rather than translated from ark-marlin.  The AHP
(Chiesa-Hu-Maller-Mishra-Vesely-Ward 2019) is built on the same three
ingredients, all of which run on the device kernels:

  * matrix arithmetization: for M in {A,B,C} the bivariate extension
    M^(X,Y) = sum_k val'(k) u_H(X,row(k)) u_H(Y,col(k)) with
    u_H(X,a) = (v_H(X)-v_H(a))/(X-a) and val' = val*col/|H|;
    row/col/val' are committed as degree-<|K| polynomials over the index
    domain K (interpolated with the device NTT),
  * rowcheck  : zA(X) zB(X) - zC(X) = h0(X) v_H(X),
  * lincheck  : for random alpha and batching etas, the univariate sumcheck
        sum_{y in H} [ u_H(alpha,y) (sum_M eta_M z_M(y)) - t(y) z^(y) ] = 0
    with t(Y) = sum_M eta_M sum_x u_H(alpha,x) M^(x,Y), proven by the
    decomposition p(X) = X g1(X) + h1(X) v_H(X) (deg g1 < n-1), and the
    claimed t(beta) tied to the committed index polynomials by a rational
    sumcheck over K:  h2(X) v_K(X) = a(X) - b(X) (X g2(X) + t_beta/|K|).

Public inputs bind through z^(X) = w~(X) v_Hx(X) + x^(X): the verifier
evaluates x^ and v_Hx over the instance points {w^0..w^{ni-1}} itself, so the
prover only ever commits the witness part w~.

Degree bounds on g1/g2 (the sumcheck soundness condition) are enforced the
ark-poly-commit way: the prover also commits the shifted polynomial
s_i = X^{D-d_i} g_i and the verifier checks s_i(z) = z^{D-d_i} g_i(z).

Fiat-Shamir uses keccak (sha3-256) like the reference's
HashFiatShamirRng<Keccak256> (marlin.rs:37-107); byte-exact transcript
compatibility with ark-marlin (and hence its Solidity verifier) is not yet
claimed — the proof is self-contained: commit/open/verify all run against
this module's own KZG over our pairing oracle.

Zero-knowledge masking (ark-marlin's zk rng bounded-degree masks) is not yet
applied; the argument is complete and knowledge-sound but proofs leak
polynomial evaluations of the witness.  (round-2 item)
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..ec.curve import PointG1, g1_group, g2_group
from ..fields import params as P
from ..ir.r1cs import R1CS
from ..ir.witness import Witness
from ..kernels.ntt import domain_for_curve
from . import kzg
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


def _g1j(pt: PointG1, curve: str):
    """G1 -> JSON, tolerating infinity (zero-polynomial commitments), which
    the strict Groth16-compatible g1_to_json rejects."""
    if pt.x is None:
        return ["0x0", "0x0"]
    return g1_to_json(pt, curve)


def _g1p(data, curve: str) -> PointG1:
    if int(data[0], 16) == 0 and int(data[1], 16) == 0:
        return g1_group(curve).zero()
    return g1_from_json(data, curve)


# ---------------------------------------------------------------------------
# polynomial helpers (coefficients = Python ints mod r, low degree first;
# large multiplies ride the device NTT)
# ---------------------------------------------------------------------------

_NTT_THRESHOLD = 512


def _trim(p: List[int]) -> List[int]:
    while p and p[-1] == 0:
        p.pop()
    return p


def _padd(a: Sequence[int], b: Sequence[int], r: int) -> List[int]:
    n = max(len(a), len(b))
    return _trim([((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % r for i in range(n)])


def _psub(a: Sequence[int], b: Sequence[int], r: int) -> List[int]:
    n = max(len(a), len(b))
    return _trim([((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % r for i in range(n)])


def _pscale(a: Sequence[int], s: int, r: int) -> List[int]:
    return _trim([c * s % r for c in a])


def _pmul(a: Sequence[int], b: Sequence[int], r: int, curve: str, device="cuda") -> List[int]:
    a = [c % r for c in a]
    b = [c % r for c in b]
    if not a or not b:
        return []
    out_len = len(a) + len(b) - 1
    if out_len <= _NTT_THRESHOLD:
        out = [0] * out_len
        for i, ca in enumerate(a):
            if ca:
                for j, cb in enumerate(b):
                    out[i + j] += ca * cb
        return _trim([c % r for c in out])
    n = _next_pow2(out_len)
    dom = domain_for_curve(curve, n)
    ea = dom.fft_ints(a, device)
    eb = dom.fft_ints(b, device)
    return _trim(dom.ifft_ints([x * y % r for x, y in zip(ea, eb)], device)[:out_len])


def _peval(p: Sequence[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * z + c) % r
    return acc


def _pdiv_vanishing(p: Sequence[int], n: int, r: int) -> Tuple[List[int], List[int]]:
    """p = q * (X^n - 1) + rem, deg rem < n."""
    rem = [c % r for c in p]
    q = [0] * max(0, len(rem) - n)
    for i in range(len(rem) - 1, n - 1, -1):
        c = rem[i]
        if c:
            q[i - n] = (q[i - n] + c) % r
            rem[i - n] = (rem[i - n] + c) % r
            rem[i] = 0
    return _trim(q), _trim(rem[:n])


def _pdiv_linear(p: Sequence[int], root: int, r: int) -> List[int]:
    """Exact division p / (X - root) (remainder must vanish)."""
    out = [0] * (len(p) - 1)
    acc = 0
    for i in range(len(p) - 1, 0, -1):
        acc = (acc * root + p[i]) % r
        out[i - 1] = acc
    assert (acc * root + p[0]) % r == 0, "non-exact linear division"
    return _trim(out)


# ---------------------------------------------------------------------------
# Fiat-Shamir transcript (keccak family, cf. marlin.rs:37-107)
# ---------------------------------------------------------------------------


class _Transcript:
    """Fiat-Shamir transcript over keccak-256 (the reference's
    HashFiatShamirRng<Keccak256>, zokrates_ark/src/marlin.rs:37-107, uses
    the same hash precisely because the EVM has a native KECCAK256 opcode).

    State chaining is one keccak per absorption — replayable in Solidity:
        state = keccak256(state || value_96_bytes_be)
        challenge_i = keccak256(state || be64(ctr)) mod r
    Values absorb as 96-byte big-endian words so every supported curve's
    coordinates (incl. BW6-761's 761-bit Fq) encode uniformly."""

    def __init__(self, label: bytes):
        from ..utils.keccak import keccak256

        self._k = keccak256
        self._state = keccak256(label)
        self._ctr = 0

    def absorb_int(self, v: int):
        self._state = self._k(self._state + int(v).to_bytes(96, "big"))

    def absorb_point(self, pt) -> None:
        if pt is None or (isinstance(pt, PointG1) and pt.x is None):
            self._state = self._k(self._state + b"\x00" * 8)
            return
        if isinstance(pt, PointG1):
            self.absorb_int(pt.x)
            self.absorb_int(pt.y)
        else:  # JSON form [x, y] / [[..],[..]]
            for coord in pt:
                if isinstance(coord, (list, tuple)):
                    for c in coord:
                        self.absorb_int(int(c, 16) if isinstance(c, str) else c)
                else:
                    self.absorb_int(int(coord, 16) if isinstance(coord, str) else coord)

    def squeeze(self, r: int) -> int:
        while True:
            out = self._k(self._state + self._ctr.to_bytes(8, "big"))
            self._ctr += 1
            v = int.from_bytes(out, "big") % r
            if v:
                return v


# ---------------------------------------------------------------------------
# indexing (circuit specialization against the universal SRS)
# ---------------------------------------------------------------------------


@dataclass
class _IndexedMatrix:
    entries: List[Tuple[int, int, int]]   # (row idx, col idx, val) mod r
    row: List[int]                        # poly coeffs over K
    col: List[int]
    valp: List[int]                       # val' = val * w^ri * w^j / n^2


@dataclass
class ProvingKey:
    curve: str
    n: int
    k: int
    num_instance: int
    srs: kzg.SRS
    mats: Dict[str, _IndexedMatrix]
    index_comms: Dict[str, Dict[str, Tuple[int, int]]]


def universal_setup(curve: str, max_degree: int, rng=None, device="cuda") -> kzg.SRS:
    """Powers-of-tau SRS; `max_degree` plays the role of 2^size in
    ark-marlin's universal_setup (marlin.rs:119-132)."""
    return kzg.universal_setup(curve, max_degree, rng=rng, device=device)


def _index_one(rows, n: int, k: int, omega: int, r: int, curve: str, device="cuda") -> _IndexedMatrix:
    # val'(kappa) = val * col / n: the normalization under which both
    #   t(Y) = sum_kappa val' u_H(alpha,row) u_H(Y,col)        (H side)
    #   t(beta) = sum_K val' v_H(alpha)v_H(beta)/((a-row)(b-col))  (K side)
    # hold simultaneously (u_H(y,col)|_{y=col} = n/col cancels the col/n).
    n_inv = pow(n, -1, r)
    entries = []
    for ri, row in enumerate(rows):
        for j, coef in row:
            c = coef % r
            if c:
                entries.append((ri, j, c))
    assert len(entries) <= k
    row_e, col_e, val_e = [], [], []
    for ri, j, c in entries:
        wr = pow(omega, ri, r)
        wc = pow(omega, j, r)
        row_e.append(wr)
        col_e.append(wc)
        val_e.append(c * wc % r * n_inv % r)
    pad = k - len(entries)
    row_e += [1] * pad
    col_e += [1] * pad
    val_e += [0] * pad
    domk = domain_for_curve(curve, k)
    return _IndexedMatrix(
        entries=entries,
        row=_trim(domk.ifft_ints(row_e, device)),
        col=_trim(domk.ifft_ints(col_e, device)),
        valp=_trim(domk.ifft_ints(val_e, device)),
    )


def setup_with_srs(srs: kzg.SRS, r1cs: R1CS, device="cuda") -> Tuple[ProvingKey, VerificationKey]:
    curve = r1cs.curve
    r = P.SCALAR_FIELDS[curve].p
    n = _next_pow2(max(r1cs.num_constraints, r1cs.num_variables, 2))
    nnz = max(
        sum(1 for row in m for _, c in row if c % r) for m in (r1cs.A, r1cs.B, r1cs.C)
    )
    k = _next_pow2(max(nnz, 2))
    # +1 over the unmasked degrees: the zk masks add one v_H multiple to
    # the round-1 polynomials (degree n) and the sumcheck mask has degree n
    need = max(n, 6 * k - 7, 1)
    if srs.max_degree < need:
        raise ValueError(
            f"universal SRS degree {srs.max_degree} < required {need} "
            f"(|H|={n}, |K|={k}); rerun universal-setup with a larger size"
        )
    dom = domain_for_curve(curve, n)
    mats = {
        "a": _index_one(r1cs.A, n, k, dom.omega, r, curve, device),
        "b": _index_one(r1cs.B, n, k, dom.omega, r, curve, device),
        "c": _index_one(r1cs.C, n, k, dom.omega, r, curve, device),
    }
    index_comms = {}
    index_comms_json = {}
    for name, im in mats.items():
        cr = kzg.commit(srs, im.row or [0], device)
        cc = kzg.commit(srs, im.col or [0], device)
        cv = kzg.commit(srs, im.valp or [0], device)
        index_comms[name] = {"row": (cr.x, cr.y), "col": (cc.x, cc.y), "val": (cv.x, cv.y)}
        index_comms_json[name] = {
            "row": _g1j(cr, curve),
            "col": _g1j(cc, curve),
            "val": _g1j(cv, curve),
        }
    pk = ProvingKey(
        curve=curve,
        n=n,
        k=k,
        num_instance=r1cs.num_instance,
        srs=srs,
        mats=mats,
        index_comms=index_comms,
    )
    vk = VerificationKey(
        "marlin",
        curve,
        {
            "n": n,
            "k": k,
            "num_instance": r1cs.num_instance,
            "srs_degree": srs.max_degree,
            "index_comms": index_comms_json,
            "h": g2_to_json(srs.h, curve),
            "tau_h": g2_to_json(srs.tau_h, curve),
            "gamma_g": list(srs.gamma_powers_g1[0])
            if srs.gamma_powers_g1
            else None,
        },
    )
    return pk, vk


# ---------------------------------------------------------------------------
# proving
# ---------------------------------------------------------------------------

_B_NAMES = ["w", "z_a", "z_b", "z_c", "h0", "s", "g1", "s1", "h1"]
_D_NAMES = [
    "g2", "s2", "h2",
    "row_a", "col_a", "val_a",
    "row_b", "col_b", "val_b",
    "row_c", "col_c", "val_c",
]


def _matrix_evals(rows, z: Sequence[int], n: int, r: int) -> List[int]:
    out = [0] * n
    for ri, row in enumerate(rows):
        out[ri] = sum(c * z[i] for i, c in row) % r
    return out


def _start_transcript(curve, n, k, ni, srs_degree, index_comms_raw, inputs_field: Sequence[int], r):
    tr = _Transcript(b"zokrates-tpu marlin v1")
    for v in (n, k, ni, srs_degree):
        tr.absorb_int(v)
    for name in ("a", "b", "c"):
        for part in ("row", "col", "val"):
            x, y = index_comms_raw[name][part]
            tr.absorb_int(x)
            tr.absorb_int(y)
    for v in inputs_field:
        tr.absorb_int(v % r)
    return tr


def _instance_poly(x: Sequence[int], omega: int, r: int, curve: str, device="cuda") -> List[int]:
    """Interpolation of the instance over H_x = {w^0..w^{ni-1}} (tiny, host)."""
    pts = [pow(omega, i, r) for i in range(len(x))]
    acc: List[int] = []
    for i, xi in enumerate(x):
        # Lagrange basis at pts[i]
        num = [1]
        den = 1
        for j, pj in enumerate(pts):
            if j == i:
                continue
            num = _pmul(num, [(-pj) % r, 1], r, curve, device)
            den = den * (pts[i] - pj) % r
        acc = _padd(acc, _pscale(num, xi * pow(den, -1, r) % r, r), r)
    return acc


def prove(r1cs: R1CS, pk: ProvingKey, witness: Witness, rng=None, device="cuda") -> Proof:
    import secrets as _secrets

    curve = pk.curve
    r = P.SCALAR_FIELDS[curve].p
    n, k, ni = pk.n, pk.k, pk.num_instance
    D = pk.srs.max_degree
    dom = domain_for_curve(curve, n)
    omega = dom.omega
    rand = rng or (lambda: _secrets.randbelow(r))

    z = [v % r for v in r1cs.full_assignment(witness)]
    x = z[:ni]

    # zk masks (ark-marlin zk_bound=1): one random v_H multiple per round-1
    # polynomial randomizes its (single) out-of-domain evaluation, and the
    # sumcheck mask polynomial s (random, sum_H s = 0) randomizes g1/h1.
    vh = [(-1) % r] + [0] * (n - 1) + [1]       # v_H = X^n - 1
    rho = {m: rand() for m in ("w", "a", "b", "c")}
    s_mask = [rand() for _ in range(n + 1)]
    s_mask[0] = (-s_mask[n]) % r                # sum over H of X^j is n iff n|j

    # round 1: witness + Mz polynomials --------------------------------------
    z_pad = z + [0] * (n - len(z))
    zhat = _trim(dom.ifft_ints(z_pad, device))
    za_e = _matrix_evals(r1cs.A, z, n, r)
    zb_e = _matrix_evals(r1cs.B, z, n, r)
    zc_e = _matrix_evals(r1cs.C, z, n, r)
    z_a = _padd(_trim(dom.ifft_ints(za_e, device)), _pscale(vh, rho["a"], r), r)
    z_b = _padd(_trim(dom.ifft_ints(zb_e, device)), _pscale(vh, rho["b"], r), r)
    z_c = _padd(_trim(dom.ifft_ints(zc_e, device)), _pscale(vh, rho["c"], r), r)

    h0, rem = _pdiv_vanishing(_psub(_pmul(z_a, z_b, r, curve, device), z_c, r), n, r)
    assert not rem, "rowcheck: zA*zB - zC does not vanish on H (bad witness?)"

    xhat = _instance_poly(x, omega, r, curve, device)
    wbar = _psub(zhat, xhat, r)
    v_hx = [1]
    for i in range(ni):
        wr = pow(omega, i, r)
        wbar = _pdiv_linear(wbar, wr, r)
        v_hx = _pmul(v_hx, [(-wr) % r, 1], r, curve, device)
    wbar = _padd(wbar, _pscale(vh, rho["w"], r), r)
    # the z-hat the verifier reconstructs: w' * v_Hx + x-hat
    zhat = _padd(zhat, _pscale(_pmul(vh, v_hx, r, curve, device), rho["w"], r), r)

    tr = _start_transcript(curve, n, k, ni, D, pk.index_comms, x, r)
    polys1 = {"w": wbar, "z_a": z_a, "z_b": z_b, "z_c": z_c, "h0": h0, "s": s_mask}
    blinders: Dict[str, List[int]] = {}
    comms: Dict[str, PointG1] = {}
    for name in ("w", "z_a", "z_b", "z_c", "h0", "s"):
        blinders[name] = kzg.rand_blinder(curve, rand)
        comms[name] = kzg.commit_hiding(pk.srs, polys1[name] or [0], blinders[name], device)
        tr.absorb_point(comms[name])

    alpha = tr.squeeze(r)
    etas = {"a": tr.squeeze(r), "b": tr.squeeze(r), "c": tr.squeeze(r)}

    # round 2: lincheck sumcheck over H --------------------------------------
    v_h_alpha = (pow(alpha, n, r) - 1) % r
    t_evals = [0] * n
    for name, eta in etas.items():
        im = pk.mats[name]
        for ri, j, c in im.entries:
            wr = pow(omega, ri, r)
            # t(w^j) = sum over entries with col = w^j of eta val u_H(alpha,row)
            # (val' * u_H(col,col) = val*col/n * n/col = val)
            u_a = v_h_alpha * pow((alpha - wr) % r, -1, r) % r
            t_evals[j] = (t_evals[j] + eta * u_a % r * c) % r
    t_poly = _trim(dom.ifft_ints(t_evals, device))

    z_eta = _padd(
        _padd(_pscale(z_a, etas["a"], r), _pscale(z_b, etas["b"], r), r),
        _pscale(z_c, etas["c"], r),
        r,
    )
    u_alpha = [pow(alpha, n - 1 - j, r) for j in range(n)]  # u_H(alpha, X)
    p_sum = _padd(
        s_mask,
        _psub(_pmul(u_alpha, z_eta, r, curve, device), _pmul(t_poly, zhat, r, curve, device), r),
        r,
    )
    h1, rem = _pdiv_vanishing(p_sum, n, r)
    assert not rem or rem[0] == 0, "lincheck sum is nonzero"
    g1p = _trim(list(rem[1:]))
    s1 = [0] * (D - (n - 2)) + g1p if g1p else []
    for name, poly in (("g1", g1p), ("s1", s1), ("h1", h1)):
        blinders[name] = kzg.rand_blinder(curve, rand)
        comms[name] = kzg.commit_hiding(pk.srs, poly or [0], blinders[name], device)
        tr.absorb_point(comms[name])

    beta = tr.squeeze(r)

    # round 3: rational sumcheck over K for t(beta) --------------------------
    t_beta = _peval(t_poly, beta, r)
    v_h_beta = (pow(beta, n, r) - 1) % r
    domk = domain_for_curve(curve, k)

    b_polys = {}
    for name in ("a", "b", "c"):
        im = pk.mats[name]
        am = _psub([alpha], im.row, r)           # alpha - row(X)
        bm = _psub([beta], im.col, r)            # beta - col(X)
        b_polys[name] = _pmul(am, bm, r, curve, device)
    # f(kappa_i): K slot i carries entry i of each matrix (padding = val 0)
    f_evals = [0] * k
    n_inv = pow(n, -1, r)
    for name in ("a", "b", "c"):
        im = pk.mats[name]
        eta = etas[name]
        for i, (ri, j, c) in enumerate(im.entries):
            wr = pow(omega, ri, r)
            wc = pow(omega, j, r)
            valp = c * wc % r * n_inv % r
            u_a = v_h_alpha * pow((alpha - wr) % r, -1, r) % r
            u_b = v_h_beta * pow((beta - wc) % r, -1, r) % r
            f_evals[i] = (f_evals[i] + eta * u_a % r * u_b % r * valp) % r
    assert sum(f_evals) % r == t_beta, "inner sumcheck mismatch"
    f_poly = _trim(domk.ifft_ints(f_evals, device))
    k_inv = pow(k, -1, r)
    assert (f_poly[0] if f_poly else 0) == t_beta * k_inv % r
    g2p = _trim(list(f_poly[1:]))
    s2 = [0] * (D - (k - 2)) + g2p if g2p else []

    b_all = _pmul(_pmul(b_polys["a"], b_polys["b"], r, curve, device), b_polys["c"], r, curve, device)
    vhab = v_h_alpha * v_h_beta % r
    a_poly: List[int] = []
    for name in ("a", "b", "c"):
        others = [o for o in ("a", "b", "c") if o != name]
        term = _pmul(pk.mats[name].valp, _pmul(b_polys[others[0]], b_polys[others[1]], r, curve, device), r,
                     curve, device)
        a_poly = _padd(a_poly, _pscale(term, etas[name] * vhab % r, r), r)
    num = _psub(a_poly, _pmul(b_all, f_poly, r, curve, device), r)
    h2, rem = _pdiv_vanishing(num, k, r)
    assert not rem, "rational sumcheck numerator does not vanish on K"

    tr.absorb_int(t_beta)
    for name, poly in (("g2", g2p), ("s2", s2), ("h2", h2)):
        comms[name] = kzg.commit(pk.srs, poly or [0], device)
        tr.absorb_point(comms[name])

    delta = tr.squeeze(r)

    # openings ---------------------------------------------------------------
    beta_polys = [polys1["w"], z_a, z_b, z_c, h0, s_mask, g1p, s1, h1]
    delta_polys = [g2p, s2, h2] + [
        pk.mats[m].__dict__[part]
        for m in ("a", "b", "c")
        for part in ("row", "col", "valp")
    ]
    evals_beta = [_peval(p, beta, r) for p in beta_polys]
    evals_delta = [_peval(p, delta, r) for p in delta_polys]
    for v in evals_beta + evals_delta:
        tr.absorb_int(v)
    gamma_b = tr.squeeze(r)
    gamma_d = tr.squeeze(r)
    _, proof_b, random_v_b = kzg.open_batch(
        pk.srs,
        [p or [0] for p in beta_polys],
        beta,
        gamma_b,
        blinders=[blinders.get(nm) for nm in _B_NAMES],
        device=device,
    )
    _, proof_d, _ = kzg.open_batch(
        pk.srs, [p or [0] for p in delta_polys], delta, gamma_d, device=device
    )

    points = {
        "commitments": {name: _g1j(comms[name], curve) for name in comms},
        "evals_beta": {nm: fr_to_json(v, curve) for nm, v in zip(_B_NAMES, evals_beta)},
        "evals_delta": {nm: fr_to_json(v, curve) for nm, v in zip(_D_NAMES, evals_delta)},
        "t_beta": fr_to_json(t_beta, curve),
        "batch_proof_beta": _g1j(proof_b, curve),
        "batch_proof_delta": _g1j(proof_d, curve),
        "random_v_beta": fr_to_json(random_v_b, curve),
    }
    inputs = [fr_to_json(z[i], curve) for i in range(1, ni)]
    return Proof("marlin", curve, points, inputs)


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------


def verify(vk: VerificationKey, proof: Proof) -> bool:
    curve = vk.curve
    r = P.SCALAR_FIELDS[curve].p
    data = vk.data
    n, k, ni, D = data["n"], data["k"], data["num_instance"], data["srs_degree"]
    dom = domain_for_curve(curve, n)
    omega = dom.omega
    x = [1] + [fr_from_json(s, curve) for s in proof.inputs]
    if len(x) != ni:
        return False

    comms_json = proof.points["commitments"]
    comms = {name: _g1p(comms_json[name], curve) for name in comms_json}
    index_comms = {
        m: {part: _g1p(data["index_comms"][m][part], curve) for part in ("row", "col", "val")}
        for m in ("a", "b", "c")
    }
    index_raw = {
        m: {part: (pt.x, pt.y) for part, pt in parts.items()} for m, parts in index_comms.items()
    }

    # replay the transcript
    tr = _start_transcript(curve, n, k, ni, D, index_raw, x, r)
    for name in ("w", "z_a", "z_b", "z_c", "h0", "s"):
        tr.absorb_point(comms[name])
    alpha = tr.squeeze(r)
    etas = {"a": tr.squeeze(r), "b": tr.squeeze(r), "c": tr.squeeze(r)}
    for name in ("g1", "s1", "h1"):
        tr.absorb_point(comms[name])
    beta = tr.squeeze(r)
    t_beta = fr_from_json(proof.points["t_beta"], curve)
    tr.absorb_int(t_beta)
    for name in ("g2", "s2", "h2"):
        tr.absorb_point(comms[name])
    delta = tr.squeeze(r)

    eb = {nm: fr_from_json(proof.points["evals_beta"][nm], curve) for nm in _B_NAMES}
    ed = {nm: fr_from_json(proof.points["evals_delta"][nm], curve) for nm in _D_NAMES}
    for v in [eb[nm] for nm in _B_NAMES] + [ed[nm] for nm in _D_NAMES]:
        tr.absorb_int(v)
    gamma_b = tr.squeeze(r)
    gamma_d = tr.squeeze(r)

    # reconstructed z^(beta) from the committed witness part
    pts = [pow(omega, i, r) for i in range(ni)]
    v_hx_beta = 1
    for pt in pts:
        v_hx_beta = v_hx_beta * (beta - pt) % r
    xhat_beta = 0
    for i, xi in enumerate(x):
        num, den = 1, 1
        for j, pj in enumerate(pts):
            if j != i:
                num = num * (beta - pj) % r
                den = den * (pts[i] - pj) % r
        xhat_beta = (xhat_beta + xi * num % r * pow(den, -1, r)) % r
    zhat_beta = (eb["w"] * v_hx_beta + xhat_beta) % r

    v_h_beta = (pow(beta, n, r) - 1) % r
    v_h_alpha = (pow(alpha, n, r) - 1) % r
    ok = True

    # (1) rowcheck at beta
    ok &= (eb["z_a"] * eb["z_b"] - eb["z_c"]) % r == eb["h0"] * v_h_beta % r

    # (2) lincheck sumcheck identity at beta
    if (alpha - beta) % r == 0:
        return False
    u_ab = (v_h_alpha - v_h_beta) % r * pow((alpha - beta) % r, -1, r) % r
    z_eta_beta = (etas["a"] * eb["z_a"] + etas["b"] * eb["z_b"] + etas["c"] * eb["z_c"]) % r
    lhs = (eb["s"] + u_ab * z_eta_beta - t_beta * zhat_beta) % r
    rhs = (beta * eb["g1"] + eb["h1"] * v_h_beta) % r
    ok &= lhs == rhs

    # degree bounds via shifted openings
    ok &= eb["s1"] == pow(beta, D - (n - 2), r) * eb["g1"] % r
    ok &= ed["s2"] == pow(delta, D - (k - 2), r) * ed["g2"] % r

    # (3) rational sumcheck identity at delta
    v_k_delta = (pow(delta, k, r) - 1) % r
    b_vals = {}
    for m in ("a", "b", "c"):
        b_vals[m] = (alpha - ed[f"row_{m}"]) % r * ((beta - ed[f"col_{m}"]) % r) % r
    vhab = v_h_alpha * v_h_beta % r
    a_delta = 0
    for m in ("a", "b", "c"):
        others = [o for o in ("a", "b", "c") if o != m]
        a_delta = (
            a_delta
            + etas[m] * vhab % r * ed[f"val_{m}"] % r * b_vals[others[0]] % r * b_vals[others[1]]
        ) % r
    b_delta = b_vals["a"] * b_vals["b"] % r * b_vals["c"] % r
    f_delta = (delta * ed["g2"] + t_beta * pow(k, -1, r)) % r
    ok &= ed["h2"] * v_k_delta % r == (a_delta - b_delta * f_delta) % r

    if not ok:
        return False

    # KZG batch openings (our own pairing oracle)
    srs = kzg.SRS(
        curve=curve,
        powers_g1=[],
        h=g2_from_json(data["h"], curve),
        tau_h=g2_from_json(data["tau_h"], curve),
        gamma_powers_g1=[tuple(data["gamma_g"])] if data.get("gamma_g") else None,
    )
    beta_comms = [comms[nm] for nm in _B_NAMES]
    delta_comms = [comms["g2"], comms["s2"], comms["h2"]] + [
        index_comms[m][part] for m in ("a", "b", "c") for part in ("row", "col", "val")
    ]
    rv_b = (
        fr_from_json(proof.points["random_v_beta"], curve)
        if "random_v_beta" in proof.points
        else 0
    )
    ok &= kzg.verify_batch(
        srs, beta_comms, beta, [eb[nm] for nm in _B_NAMES],
        _g1p(proof.points["batch_proof_beta"], curve), gamma_b, rv_b,
    )
    ok &= kzg.verify_batch(
        srs, delta_comms, delta, [ed[nm] for nm in _D_NAMES],
        _g1p(proof.points["batch_proof_delta"], curve), gamma_d,
    )
    return bool(ok)
