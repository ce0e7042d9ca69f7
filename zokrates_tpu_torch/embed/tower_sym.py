"""Symbolic BLS12-377 extension tower over gadget wires.

Same tower layout as the host oracle (ec/tower.py): Fq2 = Fq[u]/(u^2 + 5),
Fq6 = Fq2[v]/(v^3 - u), Fq12 = Fq6[w]/(w^2 - v) — but elements are
builder.W wires, so every multiplication emits an R1CS constraint (or, in
concrete mode, evaluates on ints). Used by the snark_verify_bls12_377
embed's in-circuit pairing (reference: ark-r1cs-std field gadgets reached
from zokrates_embed/src/ark.rs:48).

Frobenius maps are linear (coefficient-wise multiplication by precomputed
constants) and therefore constraint-free.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

from ..fields import params as P
from .builder import GadgetBuilder, W

Q = P.BLS12_377_Q
BETA = Q - 5          # u^2 = -5
# xi = u  (Fq6 nonresidue), matching ec/curve.py BLS12_377_TOWER


class SFq2:
    __slots__ = ("b", "c0", "c1")

    def __init__(self, b: GadgetBuilder, c0: W, c1: W):
        self.b, self.c0, self.c1 = b, c0, c1

    @staticmethod
    def zero(b):
        return SFq2(b, b.const(0), b.const(0))

    @staticmethod
    def one(b):
        return SFq2(b, b.const(1), b.const(0))

    @staticmethod
    def from_fq(b, x: W):
        return SFq2(b, x, b.const(0))

    def __add__(self, o):
        return SFq2(self.b, self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return SFq2(self.b, self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return SFq2(self.b, -self.c0, -self.c1)

    def scale(self, k: int):
        return SFq2(self.b, self.c0.scale(k), self.c1.scale(k))

    def scale_w(self, x: W):
        """Multiply by a base-field wire (2 constraints)."""
        b = self.b
        return SFq2(b, b.mul(self.c0, x), b.mul(self.c1, x))

    def __mul__(self, o):
        b = self.b
        t0 = b.mul(self.c0, o.c0)
        t1 = b.mul(self.c1, o.c1)
        t2 = b.mul(self.c0 + self.c1, o.c0 + o.c1)
        return SFq2(b, t0 + t1.scale(BETA), t2 - t0 - t1)

    def square(self):
        return self * self

    def conj(self):
        return SFq2(self.b, self.c0, -self.c1)

    def inv(self):
        """Witnessed inverse (2 allocs + verification mul)."""
        b = self.b

        def hv():
            from ..ec.tower import Fq2, TowerCtx

            ctx = TowerCtx(q=Q, beta=BETA, xi=(0, 1))
            z = Fq2(ctx, self.c0.val, self.c1.val).inv()
            return z.c0, z.c1

        i0 = b.alloc(hint=lambda: hv()[0])
        i1 = b.alloc(hint=lambda: hv()[1])
        out = SFq2(b, i0, i1)
        prod = self * out
        b.assert_eq(prod.c0, b.one())
        b.assert_eq(prod.c1, b.const(0))
        return out

    def mul_by_nonresidue(self):
        """* xi where xi = u: (c0 + c1 u) u = beta c1 + c0 u."""
        return SFq2(self.b, self.c1.scale(BETA), self.c0)


class SFq6:
    __slots__ = ("b", "c0", "c1", "c2")

    def __init__(self, b, c0: SFq2, c1: SFq2, c2: SFq2):
        self.b, self.c0, self.c1, self.c2 = b, c0, c1, c2

    @staticmethod
    def zero(b):
        z = SFq2.zero(b)
        return SFq6(b, z, z, z)

    @staticmethod
    def one(b):
        return SFq6(b, SFq2.one(b), SFq2.zero(b), SFq2.zero(b))

    def __add__(self, o):
        return SFq6(self.b, self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return SFq6(self.b, self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return SFq6(self.b, -self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2, b0, b1, b2 = self.c0, self.c1, self.c2, o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return SFq6(self.b, c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        return SFq6(self.b, self.c2.mul_by_nonresidue(), self.c0, self.c1)


class SFq12:
    __slots__ = ("b", "c0", "c1")

    def __init__(self, b, c0: SFq6, c1: SFq6):
        self.b, self.c0, self.c1 = b, c0, c1

    @staticmethod
    def one(b):
        return SFq12(b, SFq6.one(b), SFq6.zero(b))

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return SFq12(self.b, t0 + t1.mul_by_v(), c1)

    def square(self):
        return self * self

    def conj(self):
        return SFq12(self.b, self.c0, -self.c1)

    def inv(self):
        """Witnessed inverse (12 allocs + verification mul)."""
        b = self.b

        def hv():
            z = _to_host(self)
            return _host_coeffs(z.inv())

        coeffs = [b.alloc(hint=(lambda i=i: hv()[i])) for i in range(12)]
        out = _from_wires(b, coeffs)
        prod = self * out
        _assert_is_one(prod)
        return out

    def frob(self, power: int = 1):
        """x -> x^(q^power), coefficient-wise constant multiplications
        (constraint-free): conj^power on each Fq2 coefficient (u -> -u for
        odd powers, since beta^((q^p-1)/2) = (-1)^p) times the slot
        constant from _frob_consts."""
        g = _frob_consts(power)
        sign = -1 if power % 2 else 1
        b = self.b
        cs = _coeff_list(self)
        out = []
        for i in range(6):
            m0, m1 = g[i]
            x0 = cs[2 * i]
            x1 = cs[2 * i + 1].scale(sign)
            # (x0 + x1 u) * (m0 + m1 u)
            out.append(x0.scale(m0) + x1.scale(m1 * BETA % Q))
            out.append(x0.scale(m1) + x1.scale(m0))
        return _from_wires(b, out)


def _coeff_list(z: SFq12) -> List[W]:
    """Flatten to 12 Fq wires: [c0.c0.c0, c0.c0.c1, c0.c1.c0, ...]."""
    out = []
    for six in (z.c0, z.c1):
        for two in (six.c0, six.c1, six.c2):
            out.append(two.c0)
            out.append(two.c1)
    return out


def _from_wires(b, ws: List[W]) -> SFq12:
    def f2(i):
        return SFq2(b, ws[2 * i], ws[2 * i + 1])

    return SFq12(
        b,
        SFq6(b, f2(0), f2(1), f2(2)),
        SFq6(b, f2(3), f2(4), f2(5)),
    )


def _assert_is_one(z: SFq12):
    b = z.b
    cs = _coeff_list(z)
    b.assert_eq(cs[0], b.one())
    for c in cs[1:]:
        b.assert_eq(c, b.const(0))


# -- host bridge (concrete hints + frobenius constants) ----------------------


def _host_ctx():
    from ..ec.curve import tower_ctx

    return tower_ctx("bls12_377")


def _to_host(z: SFq12):
    from ..ec.tower import Fq2, Fq6, Fq12

    ctx = _host_ctx()
    cs = [w.val for w in _coeff_list(z)]

    def f2(i):
        return Fq2(ctx, cs[2 * i], cs[2 * i + 1])

    return Fq12(
        ctx,
        Fq6(ctx, f2(0), f2(1), f2(2)),
        Fq6(ctx, f2(3), f2(4), f2(5)),
    )


def _host_coeffs(z) -> List[int]:
    out = []
    for six in (z.c0, z.c1):
        for two in (six.c0, six.c1, six.c2):
            out.append(two.c0)
            out.append(two.c1)
    return out


def _u_pow(e: int):
    """u^e as an Fq2 constant (m0, m1), using u^2 = BETA (order | 2(q-1))."""
    e %= 2 * (Q - 1)
    m = pow(BETA, e // 2, Q)
    return (m, 0) if e % 2 == 0 else (0, m)


@lru_cache(maxsize=None)
def _frob_consts(power: int):
    """Fq2 constant multiplying coefficient slot (t, s) (basis v^t w^s)
    under x -> x^(q^power). Since frob(v) = v * xi^((q^p-1)/3) and
    frob(w) = w * xi^((q^p-1)/6) with xi = u, the action is slot-diagonal
    with constant u^(t*(q^p-1)/3 + s*(q^p-1)/6)."""
    qp = Q**power
    e3 = (qp - 1) // 3
    e6 = (qp - 1) // 6
    consts = []
    for s in range(2):  # w-degree
        for t in range(3):  # v-degree
            m0, m1 = _u_pow(t * e3 + s * e6)
            consts.append((m0, m1))
    return tuple(consts)
