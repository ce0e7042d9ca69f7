"""Multilinear sumcheck over prime fields (host python-int arithmetic).

Used by the Nova `compress` argument (schemes/nova.py): the relaxed-R1CS
satisfiability check over the blinded folded accumulator is reduced by two
sumchecks (Spartan-style, Setty 2020) to two linear-form openings of the
Pedersen-committed witness/slack vectors, which an inner-product argument
(schemes/ipa.py) proves succinctly.

Conventions: an l-variable multilinear polynomial is a dense list of 2^l
values; round i binds the TOP variable (pairs (j, j + half)); a point
r = [r_0 .. r_{l-1}] lists the round challenges in binding order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple


def eq_table(r: Sequence[int], p: int) -> List[int]:
    """Dense table of eq(r, j) over j in {0,1}^len(r) (same index
    convention as the sumcheck folding: r[0] is the top bit of j)."""
    out = [1]
    for ri in reversed(r):  # r[0] binds the TOP index bit
        lo = [(v * (1 - ri)) % p for v in out]
        hi = [(v * ri) % p for v in out]
        out = lo + hi
    return out


def mle_eval(vec: Sequence[int], r: Sequence[int], p: int) -> int:
    """Evaluate the MLE of a dense 2^l vector at r."""
    cur = list(vec)
    for ri in r:
        half = len(cur) // 2
        cur = [
            (cur[j] + ri * (cur[j + half] - cur[j])) % p for j in range(half)
        ]
    return cur[0] % p


def eq_point(a: Sequence[int], b: Sequence[int], p: int) -> int:
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((1 - x) * (1 - y) + x * y) % p
    return acc % p


def _lagrange_0123(gs: Sequence[int], r: int, p: int) -> int:
    """Evaluate the degree-(len(gs)-1) polynomial with values gs at
    points 0..len(gs)-1, at r."""
    d = len(gs) - 1
    acc = 0
    for i, gi in enumerate(gs):
        num, den = 1, 1
        for j in range(d + 1):
            if j == i:
                continue
            num = num * (r - j) % p
            den = den * (i - j) % p
        acc = (acc + gi * num % p * pow(den, -1, p)) % p
    return acc


def sumcheck_prove(
    tr,
    p: int,
    polys: Sequence[Sequence[int]],
    combine: Callable[..., int],
    deg: int,
) -> Tuple[List[List[int]], List[int], List[int]]:
    """Prove sum_x combine(f_1(x), .., f_k(x)) over the boolean cube.

    Returns (round messages [g(0..deg) per round], challenges, final
    per-poly values at the bound point). The claimed sum itself is the
    caller's responsibility to absorb/check."""
    cur = [list(q) for q in polys]
    l = max(1, len(cur[0])).bit_length() - 1
    msgs: List[List[int]] = []
    rs: List[int] = []
    for _ in range(l):
        half = len(cur[0]) // 2
        gs = []
        for t in range(deg + 1):
            s = 0
            for j in range(half):
                vals = [
                    (q[j] + t * (q[j + half] - q[j])) % p for q in cur
                ]
                s = (s + combine(*vals)) % p
            gs.append(s)
        for g in gs:
            tr.absorb_int(g)
        r = tr.squeeze(p)
        rs.append(r)
        cur = [
            [(q[j] + r * (q[j + half] - q[j])) % p for j in range(half)]
            for q in cur
        ]
        msgs.append(gs)
    return msgs, rs, [q[0] % p for q in cur]


def sumcheck_verify(
    tr, p: int, claim: int, msgs: Sequence[Sequence[int]], deg: int
) -> Optional[Tuple[List[int], int]]:
    """Verify the round messages against the running claim. Returns
    (challenges, final claim) or None; the caller must check the final
    claim against the combined evaluation at the bound point."""
    rs: List[int] = []
    claim %= p
    for gs in msgs:
        if len(gs) != deg + 1:
            return None
        if (gs[0] + gs[1]) % p != claim:
            return None
        for g in gs:
            tr.absorb_int(g)
        r = tr.squeeze(p)
        rs.append(r)
        claim = _lagrange_0123(gs, r, p)
    return rs, claim
