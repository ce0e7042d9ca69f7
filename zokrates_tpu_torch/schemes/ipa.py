"""Inner-product argument for Pedersen vector commitments (Bulletproofs
IPA, Bootle et al. 2016 / Bunz et al. 2018 — no zero-knowledge blinding;
the Nova compress pipeline blinds the committed vector itself first).

Given public bases g[0..n) and Q, a commitment P = sum w_i g_i, a public
weight vector c and claimed v = <w, c>, the prover sends 2 log n points
plus one scalar; the verifier folds the weight/base structure and checks
one multi-scalar equation. Proof size O(log n); verifier O(n) group work
(one n-MSM after computing the fold coefficients).

Host-side: proofs here are for the Nova step-circuit scale; the n-MSM
in verification reuses the device MSM through _commit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..ec.jacobian import INF1, jac_add, jac_mul, jac_to_affine


@dataclass
class IpaProof:
    Ls: List[Tuple[int, int]]  # (0, 0) = infinity
    Rs: List[Tuple[int, int]]
    w0: int


def _aff(P):
    return P if P is not None else (0, 0)


def _to_jac(xy) -> tuple:
    if xy == (0, 0):
        return INF1
    return (xy[0], xy[1], 1)


def _msm_host(q: int, pts: Sequence[Tuple[int, int]], scalars: Sequence[int]):
    acc = INF1
    for pt, s in zip(pts, scalars):
        if s == 0 or pt == (0, 0):
            continue
        acc = jac_add(q, acc, jac_mul(q, (pt[0], pt[1], 1), s))
    return acc


def _pad_pow2(xs: List[int]) -> List[int]:
    n = len(xs)
    m = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return xs + [0] * (m - n)


def ipa_prove(tr, p: int, q: int, bases, Q, w: Sequence[int], c: Sequence[int]) -> IpaProof:
    """bases: affine (x, y) pairs over base field q; w, c: scalars mod p.
    Transcript must already bind (commitment, c, v)."""
    w = _pad_pow2([v % p for v in w])
    c = _pad_pow2([v % p for v in c])
    g = [tuple(b) for b in bases[: len(w)]]
    assert len(g) == len(w) == len(c)
    Qj = _to_jac(Q)
    Ls: List[Tuple[int, int]] = []
    Rs: List[Tuple[int, int]] = []
    while len(w) > 1:
        half = len(w) // 2
        wL, wR = w[:half], w[half:]
        gL, gR = g[:half], g[half:]
        cL, cR = c[:half], c[half:]
        vL = sum(a * b for a, b in zip(wL, cR)) % p
        vR = sum(a * b for a, b in zip(wR, cL)) % p
        L = jac_add(q, _msm_host(q, gR, wL), jac_mul(q, Qj, vL))
        R = jac_add(q, _msm_host(q, gL, wR), jac_mul(q, Qj, vR))
        Laf = _aff(jac_to_affine(q, L))
        Raf = _aff(jac_to_affine(q, R))
        for pt in (Laf, Raf):
            tr.absorb_int(pt[0])
            tr.absorb_int(pt[1])
        a = tr.squeeze(p)
        ai = pow(a, -1, p)
        w = [(x * a + y * ai) % p for x, y in zip(wL, wR)]
        c = [(x * ai + y * a) % p for x, y in zip(cL, cR)]
        g = [
            _aff(jac_to_affine(q, jac_add(
                q,
                jac_mul(q, _to_jac(x), ai),
                jac_mul(q, _to_jac(y), a),
            )))
            for x, y in zip(gL, gR)
        ]
        Ls.append(Laf)
        Rs.append(Raf)
    return IpaProof(Ls=Ls, Rs=Rs, w0=w[0] % p)


def ipa_verify(
    tr, p: int, q: int, bases, Q, com: Tuple[int, int],
    c: Sequence[int], v: int, proof: IpaProof, msm_host=None,
) -> bool:
    """Check <w, c> = v for the vector committed in `com`. `msm_host` may
    override the base-field MSM (e.g. the device MSM for large n)."""
    c = _pad_pow2([x % p for x in c])
    n = len(c)
    rounds = max(0, n.bit_length() - 1)
    if len(proof.Ls) != rounds or len(proof.Rs) != rounds:
        return False
    g = [tuple(b) for b in bases[:n]]
    if len(g) != n:
        return False
    Qj = _to_jac(Q)
    # P = com + v*Q, folded by alpha^2 L + P + alpha^-2 R each round
    P = jac_add(q, _to_jac(tuple(com)), jac_mul(q, Qj, v % p))
    alphas: List[int] = []
    for Laf, Raf in zip(proof.Ls, proof.Rs):
        for pt in (Laf, Raf):
            tr.absorb_int(pt[0])
            tr.absorb_int(pt[1])
        a = tr.squeeze(p)
        alphas.append(a)
        a2 = a * a % p
        ai2 = pow(a2, -1, p)
        P = jac_add(q, P, jac_mul(q, _to_jac(Laf), a2))
        P = jac_add(q, P, jac_mul(q, _to_jac(Raf), ai2))

    # fold coefficients: s_i = prod over rounds of (a if bit of i along
    # that round's TOP half else a^-1); c* likewise with inverted roles
    s = [1] * n
    step = n
    for a in alphas:
        ai = pow(a, -1, p)
        half = step // 2
        for base_idx in range(0, n, step):
            for j in range(half):
                s[base_idx + j] = s[base_idx + j] * ai % p
                s[base_idx + j + half] = s[base_idx + j + half] * a % p
        step = half
    # c folds with the SAME a/a^-1 pattern as the bases (w carries the
    # inverse pattern), so the folded scalar is sum c_i * s_i
    c_star = 0
    for i in range(n):
        c_star = (c_star + c[i] * s[i]) % p

    msm = msm_host or _msm_host
    rhs = jac_add(
        q,
        msm(q, g, [proof.w0 * si % p for si in s]),
        jac_mul(q, Qj, proof.w0 * c_star % p),
    )
    return jac_to_affine(q, P) == jac_to_affine(q, rhs)
