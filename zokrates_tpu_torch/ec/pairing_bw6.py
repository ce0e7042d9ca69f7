"""Reduced Tate pairing for BW6-761.

BW6-761 (El Housni–Guillevic) has embedding degree 6 with BOTH groups over
the 761-bit base field Fq: E: y^2 = x^3 - 1 hosts G1 and the sextic twist
E': y^2 = x^3 + 4 hosts G2 (reference: zokrates_field/src/bw6_761.rs wraps
ark-bw6-761, whose Fq6 tower is Fq3(u: u^3 = -4) + Fq6(v: v^2 = u), i.e.
Fq6 = Fq[w]/(w^6 + 4) with u = w^2).

This module is the host-side verification oracle for proofs over bw6_761
(GM17 composition layer, Groth16). It deliberately uses the *reduced Tate
pairing* f_{r,P}(psi(Q))^((q^6-1)/r) instead of the optimal ate: the loop
runs over the group order r with all point arithmetic in Fq (Python ints),
needs no curve-specific loop parameter, and its correctness reduces to
bilinearity — which the test suite checks directly. Any non-degenerate
bilinear pairing satisfies the SNARK product equations, so reference
proofs/VKs verify identically (the equations are exponent identities).

Untwist (M-type, s = 1/w with s^6 = -1/4):
    psi(x', y') = (x'/w^2, y'/w^3) = (-x' w^4 / 4, -y' w^3 / 4)
giving sparse Fq6 evaluation points (one nonzero coefficient each), so each
Miller step costs one full Fq6 square plus one sparse line multiplication.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

from ..fields import params as P

Q = P.BW6_761_Q
R = P.BW6_761_R
# Fq6 = Fq[w] / (w^6 - NR), NR = -4
NR = Q - 4


class Fq6w:
    """Direct sextic extension Fq[w]/(w^6 + 4), coefficients low-to-high."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = [v % Q for v in c]

    @staticmethod
    def one() -> "Fq6w":
        return Fq6w([1, 0, 0, 0, 0, 0])

    @staticmethod
    def sparse(coef: int, deg: int) -> "Fq6w":
        c = [0] * 6
        c[deg] = coef % Q
        return Fq6w(c)

    def is_one(self) -> bool:
        return self.c[0] == 1 and all(v == 0 for v in self.c[1:])

    def __eq__(self, o):
        return self.c == o.c

    def __mul__(self, o: "Fq6w") -> "Fq6w":
        a, b = self.c, o.c
        t = [0] * 11
        for i in range(6):
            ai = a[i]
            if ai:
                for j in range(6):
                    t[i + j] += ai * b[j]
        out = t[:6]
        for k in range(6, 11):
            out[k - 6] = (out[k - 6] + NR * t[k]) % Q
        return Fq6w(out)

    def square(self) -> "Fq6w":
        return self * self

    def mul_sparse(self, pairs: Sequence[Tuple[int, int]]) -> "Fq6w":
        """self * sum(coef * w^deg) for a short list of (coef, deg)."""
        t = [0] * 11
        for coef, deg in pairs:
            if coef:
                for j in range(6):
                    t[deg + j] += coef * self.c[j]
        out = t[:6]
        for k in range(6, 11):
            out[k - 6] = (out[k - 6] + NR * t[k]) % Q
        return Fq6w(out)

    def inv(self) -> "Fq6w":
        """Norm-chain inversion: z^-1 = conj(z) N1 N2 / Norm_{Fq6/Fq}(z),
        where conj = q^3-Frobenius (fixes Fq3 = Fq[w^2], sends w -> -w) and
        N1, N2 are the q^2/q^4 conjugates of the Fq3-norm. Costs ~5 Fq6
        muls + one Fq inversion (vs ~4600 squarings for Fermat)."""
        c = self.frob(3)
        n = self * c          # in Fq3 (even coefficients)
        n1 = n.frob(2)
        n2 = n.frob(4)
        m = (n * n1 * n2).c[0]  # full norm, lands in Fq
        t = c * (n1 * n2)
        minv = pow(m, -1, Q)
        return Fq6w([v * minv for v in t.c])

    def pow(self, e: int) -> "Fq6w":
        r = Fq6w.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def frob(self, power: int = 1) -> "Fq6w":
        """x -> x^(q^power): c_i w^i -> c_i * w^(i*q^power) with
        w^q = w * (w^6)^((q-1)/6) = w * NR^((q-1)/6)."""
        g = _frob_gammas(power)
        return Fq6w([self.c[i] * g[i] % Q for i in range(6)])


@lru_cache(maxsize=None)
def _frob_gammas(power: int) -> Tuple[int, ...]:
    qp = Q**power
    base = pow(NR, (qp - 1) // 6, Q)  # w^(q^power) = base * w (6 | q-1)
    return tuple(pow(base, i, Q) for i in range(6))


# ---------------------------------------------------------------------------
# Miller loop (Tate: loop over r, point arithmetic in Fq)
# ---------------------------------------------------------------------------

_INV4 = pow(4, -1, Q)


def _psi_coords(xq: int, yq: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Untwisted Q as sparse Fq6 coefficients: ((x_coef, 4), (y_coef, 3))."""
    return ((-xq * _INV4 % Q, 4), (-yq * _INV4 % Q, 3))


def miller_loop_bw6(P1, Q2) -> Fq6w:
    """f_{r, P1}(psi(Q2)). P1: host PointG1 on E, Q2: host point on E'
    (both coordinates plain ints mod Q)."""
    if P1.infinity or Q2.infinity:
        return Fq6w.one()
    (xs, xd), (ys, yd) = _psi_coords(Q2.x, Q2.y)

    f = Fq6w.one()
    tx, ty = P1.x, P1.y
    px, py = P1.x, P1.y
    for bit in bin(R)[3:]:
        # tangent line at T: l = (y - ty) - lam (x - tx)
        lam = 3 * tx * tx * pow(2 * ty, -1, Q) % Q
        c0 = (lam * tx - ty) % Q
        f = f.square().mul_sparse([(c0, 0), (ys, yd), (-lam * xs % Q, xd)])
        x3 = (lam * lam - 2 * tx) % Q
        ty = (lam * (tx - x3) - ty) % Q
        tx = x3
        if bit == "1":
            if tx == px:
                # T == P (never at these loop lengths) or T == -P: vertical
                f = f.mul_sparse([(-px % Q, 0), (xs, xd)])
                tx, ty = None, None  # T + P = infinity; r*P = inf ends loop
                break
            lam = (py - ty) * pow(px - tx, -1, Q) % Q
            c0 = (lam * tx - ty) % Q
            f = f.mul_sparse([(c0, 0), (ys, yd), (-lam * xs % Q, xd)])
            x3 = (lam * lam - tx - px) % Q
            ty = (lam * (tx - x3) - ty) % Q
            tx = x3
    return f


@lru_cache(maxsize=None)
def _hard_exp() -> int:
    return (Q * Q - Q + 1) // R


def final_exponentiation_bw6(f: Fq6w) -> Fq6w:
    # easy part: f^((q^3 - 1)(q + 1))
    f = f.frob(3) * f.inv()  # f^(q^3 - 1)  (frob(3) is conjugation)
    f = f.frob(1) * f        # ^(q + 1)
    # hard part: (q^2 - q + 1)/r
    return f.pow(_hard_exp())


def pairing_product_is_one_bw6(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over BW6-761, shared final exponentiation."""
    f = Fq6w.one()
    for P1, Q2 in pairs:
        f = f * miller_loop_bw6(P1, Q2)
    return final_exponentiation_bw6(f).is_one()
