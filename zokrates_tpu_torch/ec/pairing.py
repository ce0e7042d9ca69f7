"""Optimal ate pairings for BN254 and BLS12-381/377.

Host-side verification oracle. The reference gets pairings from arkworks
(zokrates_ark) / bellman_ce (zokrates_bellman); here they exist so that the
TPU prover's output can be verified in-process (Groth16/GM17/Marlin
verification equations are pairing-product checks).

Strategy: untwist G2 points into E(Fq12) and run the Miller loop with plain
affine formulas in Fq12. This costs a few Fq12 inversions per step, which is
irrelevant at verification scale and keeps the line-function logic
transparent (no sparse-multiplication special cases to get subtly wrong).

  * BN254 (D-type twist, xi = 9+u):  psi(x,y) = (x*w^2, y*w^3)
  * BLS12-381 (M-type twist, xi = 1+u): psi(x,y) = (x/w^2, y/w^3)
  * BLS12-377 (D-type twist, xi = u): as BN254

Loop parameters: BN optimal ate uses |6x+2| plus the two Frobenius line
corrections; BLS12 ate uses |x| with conjugation for negative x.

Final exponentiation: (q^12-1)/r split into the easy part (conjugation +
inversion + q^2-power) and the hard part done as a plain pow by
(q^4 - q^2 + 1)/r. Cyclotomic-subgroup shortcuts are an optimization for
later rounds.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

from ..fields import params as P
from .curve import PointG1, PointG2, g1_group, g2_group, tower_ctx
from .tower import Fq2, Fq6, Fq12, TowerCtx


class _Fq12Point:
    """Affine point on E(Fq12): y^2 = x^3 + b (b in Fq)."""

    __slots__ = ("ctx", "x", "y")

    def __init__(self, ctx, x: Fq12, y: Fq12):
        self.ctx, self.x, self.y = ctx, x, y


def _embed_fq(ctx: TowerCtx, v: int) -> Fq12:
    c0 = Fq6(ctx, Fq2(ctx, v, 0), Fq2.zero(ctx), Fq2.zero(ctx))
    return Fq12(ctx, c0, Fq6.zero(ctx))


def _embed_fq2(ctx: TowerCtx, v: Fq2) -> Fq12:
    c0 = Fq6(ctx, v, Fq2.zero(ctx), Fq2.zero(ctx))
    return Fq12(ctx, c0, Fq6.zero(ctx))


def _w_pow(ctx: TowerCtx, k: int) -> Fq12:
    """w^k as an Fq12 element (w^2 = v, v^3 = xi)."""
    out = Fq12.one(ctx)
    w = Fq12(ctx, Fq6.zero(ctx), Fq6.one(ctx))
    for _ in range(k):
        out = out * w
    return out


@lru_cache(maxsize=None)
def _pairing_cfg(curve: str):
    ctx = tower_ctx(curve)
    if curve == "bn128":
        x = P.BN254_X
        loop = 6 * x + 2
        kind = "bn"
        twist = "D"
    elif curve == "bls12_381":
        loop = P.BLS12_381_X  # negative
        kind = "bls"
        twist = "M"
    elif curve == "bls12_377":
        loop = P.BLS12_377_X
        kind = "bls"
        twist = "D"
    else:
        raise ValueError(f"no pairing for curve {curve}")
    return ctx, loop, kind, twist


def _untwist(curve: str, Q: PointG2) -> _Fq12Point:
    ctx, _, _, twist = _pairing_cfg(curve)
    w2 = _w_pow(ctx, 2)
    w3 = _w_pow(ctx, 3)
    x12 = _embed_fq2(ctx, Q.x)
    y12 = _embed_fq2(ctx, Q.y)
    if twist == "D":
        return _Fq12Point(ctx, x12 * w2, y12 * w3)
    return _Fq12Point(ctx, x12 * w2.inv(), y12 * w3.inv())


def _line(ctx, T: _Fq12Point, Q: _Fq12Point, Px: Fq12, Py: Fq12) -> Tuple[Fq12, _Fq12Point]:
    """Evaluate the line through T,Q (or tangent if T==Q) at P; return
    (line value, T+Q)."""
    if T.x == Q.x and T.y == Q.y:
        lam = (T.x * T.x * _embed_fq(ctx, 3)) * (T.y * _embed_fq(ctx, 2)).inv()
    elif T.x == Q.x:
        # vertical line x - x_T
        return Px - T.x, None
    else:
        lam = (Q.y - T.y) * (Q.x - T.x).inv()
    l = Py - T.y - lam * (Px - T.x)
    x3 = lam * lam - T.x - Q.x
    y3 = lam * (T.x - x3) - T.y
    return l, _Fq12Point(ctx, x3, y3)


def _frob_fq12(ctx: TowerCtx, a: Fq12, power: int = 1) -> Fq12:
    """Frobenius x -> x^(q^power) by plain exponentiation (slow path, only
    used on the two correction points for BN; fine at verification scale)."""
    return a.pow(pow(ctx.q, power))


def miller_loop(curve: str, Pt: PointG1, Q: PointG2) -> Fq12:
    ctx, loop, kind, _ = _pairing_cfg(curve)
    if Pt.infinity or Q.infinity:
        return Fq12.one(ctx)
    Px = _embed_fq(ctx, Pt.x)
    Py = _embed_fq(ctx, Pt.y)
    Qe = _untwist(curve, Q)
    neg = loop < 0
    n = abs(loop)

    f = Fq12.one(ctx)
    T = Qe
    for bit in bin(n)[3:]:
        l, T = _line(ctx, T, T, Px, Py)
        f = f * f * l
        if bit == "1":
            l, T = _line(ctx, T, Qe, Px, Py)
            f = f * l

    if neg:
        # ate with negative parameter: f <- conj(f) (1/f up to final exp),
        # and T <- -T for the BN corrections (not used for BLS)
        f = f.conj()
        T = _Fq12Point(ctx, T.x, -T.y)

    if kind == "bn":
        # Frobenius corrections: Q1 = pi_q(Q), Q2 = -pi_{q^2}(Q)
        Q1 = _Fq12Point(ctx, _frob_fq12(ctx, Qe.x), _frob_fq12(ctx, Qe.y))
        Q2 = _Fq12Point(
            ctx, _frob_fq12(ctx, Qe.x, 2), -(_frob_fq12(ctx, Qe.y, 2))
        )
        l, T = _line(ctx, T, Q1, Px, Py)
        f = f * l
        l, _ = _line(ctx, T, Q2, Px, Py)
        f = f * l
    return f


@lru_cache(maxsize=None)
def _final_exp_exponents(curve: str):
    ctx, _, _, _ = _pairing_cfg(curve)
    q = ctx.q
    r = g1_group(curve).r
    hard = (q**4 - q**2 + 1) // r
    return q, hard


def final_exponentiation(curve: str, f: Fq12) -> Fq12:
    ctx, _, _, _ = _pairing_cfg(curve)
    q, hard = _final_exp_exponents(curve)
    # easy part: f^((q^6-1)(q^2+1))
    f = f.conj() * f.inv()          # f^(q^6 - 1)
    f = _frob_fq12(ctx, f, 2) * f   # ^(q^2 + 1)
    # hard part
    return f.pow(hard)


def pairing(curve: str, Pt: PointG1, Q: PointG2) -> Fq12:
    return final_exponentiation(curve, miller_loop(curve, Pt, Q))


def pairing_product_is_one(curve: str, pairs: Sequence[Tuple[PointG1, PointG2]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the shape of all SNARK verification checks.
    Single shared final exponentiation over the product of Miller loops."""
    if curve == "bw6_761":
        from .pairing_bw6 import pairing_product_is_one_bw6

        return pairing_product_is_one_bw6(pairs)
    ctx, _, _, _ = _pairing_cfg(curve)
    f = Fq12.one(ctx)
    for Pt, Q in pairs:
        f = f * miller_loop(curve, Pt, Q)
    return final_exponentiation(curve, f).is_one()
