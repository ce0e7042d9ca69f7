"""snark_verify_bls12_377: in-circuit GM17 verification over BW6-761.

The reference extracts this gadget from ark-r1cs-std's GM17VerifierGadget
(zokrates_embed/src/ark.rs:48 generate_verify_constraints, ark.rs:181
generate_verify_witness); BW6-761's scalar field IS BLS12-377's base field,
so the inner proof's coordinates are native wires. Here the whole verifier
circuit is built natively with the gadget builder:

  * inner public inputs are bit-decomposed (canonical) and fed to
    double-and-add scalar multiplications over complete projective
    formulas (Renes-Costello-Batina 2015, a=0), so the query MSM is total,
  * the two GM17 pairing product equations (see schemes/gm17.py verify)
    run as 6 affine Miller loops over the symbolic tower (tower_sym) with
    witnessed (constraint-enforced nonzero) inverses and 2 shared final
    exponentiations using the BLS12 fast chain
    3*(q^4-q^2+1)/r = (x-1)^2 (x+q) (x^2+q^2-1) + 3
    (exponent tripling is harmless: z^3 == 1 iff z == 1 when gcd(3,r)=1),
  * the result is a boolean wire (1 iff both products equal one).

Deviations from the reference gadget, by design: exceptional inputs
(points at infinity encoded in proof/vk wires, equal-x affine additions)
make the witness UNPROVABLE (an inverse constraint turns unsatisfiable)
instead of yielding `false` — honest verifier inputs never hit them.

Interface (matches common/embed.rs:433 snark_verify_bls12_377):
  generate_verify_constraints(n) ->
      (out_index, input_indices, proof_indices, vk_indices, constraints,
       variable_count)
  generate_verify_witness(inputs, proof, vk) -> full assignment vector
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

from ..fields import params as P
from .builder import GadgetBuilder, W
from .tower_sym import SFq2, SFq6, SFq12

Q = P.BLS12_377_Q          # == BW6-761 r: the circuit field
X_BLS = P.BLS12_377_X if hasattr(P, "BLS12_377_X") else 0x8508C00000000001
FQ_BITS = Q.bit_length()   # 377


# ---------------------------------------------------------------------------
# G1 over Fq: complete projective formulas (RCB15, a=0, b=1 -> b3=3)
# ---------------------------------------------------------------------------


def _proj_add(gb: GadgetBuilder, Pp, Qp):
    """Complete homogeneous-projective addition on y^2 = x^3 + 1 (a=0,
    b3=3). Handles doubling and infinity. 12 constraints."""
    X1, Y1, Z1 = Pp
    X2, Y2, Z2 = Qp
    b3 = 3
    t0 = gb.mul(X1, X2)
    t1 = gb.mul(Y1, Y2)
    t2 = gb.mul(Z1, Z2)
    t3 = gb.mul(X1 + Y1, X2 + Y2) - t0 - t1
    t4 = gb.mul(Y1 + Z1, Y2 + Z2) - t1 - t2
    t5 = gb.mul(X1 + Z1, X2 + Z2) - t0 - t2
    t0_3 = t0.scale(3)
    t2_b3 = t2.scale(b3)
    z3 = t1 + t2_b3
    t1m = t1 - t2_b3
    y3 = t5.scale(b3)
    X3 = gb.mul(t4, y3)
    t2b = gb.mul(t3, t1m)
    X3 = t2b - X3
    Y3 = gb.mul(y3, t0_3)
    t1b = gb.mul(t1m, z3)
    Y3 = t1b + Y3
    t0b = gb.mul(t0_3, t3)
    Z3 = gb.mul(z3, t4)
    Z3 = Z3 + t0b
    return (X3, Y3, Z3)


def _proj_select(gb, bit: W, Pp, Qp):
    return tuple(gb.select(bit, a, b) for a, b in zip(Pp, Qp))


def _proj_of_affine(gb, pt):
    return (pt[0], pt[1], gb.one())


def _proj_infinity(gb):
    return (gb.const(0), gb.one(), gb.const(0))


def _proj_to_affine(gb, Pp):
    """(X:Y:Z) -> (X/Z, Y/Z); Z == 0 (infinity) is unprovable."""
    X, Y, Z = Pp
    zinv = gb.inv(Z)
    return (gb.mul(X, zinv), gb.mul(Y, zinv))


def _affine_add_g1(gb, A, B):
    """Affine chord addition; x_B == x_A unprovable (enforced nonzero dx)."""
    dx_inv = gb.inv(B[0] - A[0])
    lam = gb.mul(B[1] - A[1], dx_inv)
    x3 = gb.mul(lam, lam) - A[0] - B[0]
    y3 = gb.mul(lam, A[0] - x3) - A[1]
    return (x3, y3)


def _affine_add_g2(gb, A, B):
    lam = (B[1] - A[1]) * (B[0] - A[0]).inv()
    x3 = lam * lam - A[0] - B[0]
    y3 = lam * (A[0] - x3) - A[1]
    return (x3, y3)


def _neg_g1(pt):
    return (pt[0], -pt[1])


# ---------------------------------------------------------------------------
# Pairing (BLS12-377 ate, D-twist, affine steps, sparse line -> tower Fq12)
# ---------------------------------------------------------------------------


def _line_to_fq12(gb, py: W, c1_fq2: SFq2, c3_fq2: SFq2) -> SFq12:
    """l = py + c1*w + c3*w^3 in the w-power basis -> tower coordinates
    (w-even coefficients form the Fq6 c0 part: a0 + a2 v + a4 v^2)."""
    z2 = SFq2.zero(gb)
    c0 = SFq6(gb, SFq2.from_fq(gb, py), z2, z2)
    c1 = SFq6(gb, c1_fq2, c3_fq2, z2)
    return SFq12(gb, c0, c1)


def _double_step(gb, T, P1):
    tx, ty = T
    px, py = P1
    lam = tx.square().scale(3) * (ty + ty).inv()
    c1 = -lam.scale_w(px)                 # -lam * px  (coeff of w)
    c3 = lam * tx - ty                    # coeff of w^3
    x3 = lam * lam - tx - tx
    y3 = lam * (tx - x3) - ty
    return (x3, y3), _line_to_fq12(gb, py, c1, c3)


def _add_step(gb, T, Q2, P1):
    tx, ty = T
    qx, qy = Q2
    px, py = P1
    lam = (qy - ty) * (qx - tx).inv()
    c1 = -lam.scale_w(px)
    c3 = lam * qx - qy
    x3 = lam * lam - tx - qx
    y3 = lam * (tx - x3) - ty
    return (x3, y3), _line_to_fq12(gb, py, c1, c3)


def _miller(gb, P1, Q2) -> SFq12:
    """f_{x, Q2}(psi at P1) for the BLS ate loop (x positive)."""
    f = None
    T = Q2
    for bit in bin(X_BLS)[3:]:
        if f is not None:
            f = f.square()
        T, l = _double_step(gb, T, P1)
        f = l if f is None else f * l
        if bit == "1":
            T, l = _add_step(gb, T, Q2, P1)
            f = f * l
    return f


def _pow_x(gb, m: SFq12) -> SFq12:
    out = None
    for bit in bin(X_BLS)[2:]:
        if out is not None:
            out = out.square()
        if bit == "1":
            out = m if out is None else out * m
    return out


def _final_exp_is_one(gb, f: SFq12) -> W:
    """Boolean wire: f^((q^12-1)/r) == 1, computed as the tripled BLS
    chain (see module docstring)."""
    # easy part
    t = f.conj() * f.inv()
    m = t.frob(2) * t
    # hard part (exponent 3*(q^4-q^2+1)/r); cyclotomic inverse == conj
    m3 = m.square() * m
    c1 = _pow_x(gb, m) * m.conj()          # m^(x-1)
    c2 = _pow_x(gb, c1) * c1.conj()        # m^((x-1)^2)
    d = _pow_x(gb, c2) * c2.frob(1)        # c2^(x+q)
    e2 = _pow_x(gb, _pow_x(gb, d))         # d^(x^2)
    res = e2 * d.frob(2) * d.conj() * m3
    return _is_one_bool(gb, res)


def _is_one_bool(gb, z: SFq12) -> W:
    from .tower_sym import _coeff_list

    cs = _coeff_list(z)
    ok = gb.is_zero(cs[0] - gb.one())
    for c in cs[1:]:
        ok = gb.band(ok, gb.is_zero(c))
    return ok


# ---------------------------------------------------------------------------
# The GM17 verifier circuit
# ---------------------------------------------------------------------------


def _g2_of(gb, ws: Sequence[W]):
    return (SFq2(gb, ws[0], ws[1]), SFq2(gb, ws[2], ws[3]))


def _build(gb: GadgetBuilder, n: int) -> W:
    inputs = [gb.input_wire(i) for i in range(n)]
    proof = [gb.input_wire(n + i) for i in range(8)]
    vk = [gb.input_wire(n + 8 + i) for i in range(18 + 2 * n)]

    A = (proof[0], proof[1])
    B = _g2_of(gb, proof[2:6])
    C = (proof[6], proof[7])

    H = _g2_of(gb, vk[0:4])
    g_alpha = (vk[4], vk[5])
    h_beta = _g2_of(gb, vk[6:10])
    g_gamma = (vk[10], vk[11])
    h_gamma = _g2_of(gb, vk[12:16])
    query = [(vk[16 + 2 * i], vk[17 + 2 * i]) for i in range(n + 1)]

    # vk_x = query[0] + sum_i input_i * query[i+1] (complete projective)
    acc = _proj_of_affine(gb, query[0])
    for i, inp in enumerate(inputs):
        bits = gb.bits_of(inp, FQ_BITS)
        pt = _proj_of_affine(gb, query[i + 1])
        macc = _proj_infinity(gb)
        for bit in reversed(bits):
            macc = _proj_add(gb, macc, macc)
            added = _proj_add(gb, macc, pt)
            macc = _proj_select(gb, bit, added, macc)
        acc = _proj_add(gb, acc, macc)
    vk_x = _proj_to_affine(gb, acc)

    # (1) e(g_alpha, h_beta) e(vk_x, h_gamma) e(C, H)
    #         e(-(A + g_alpha), B + h_beta) == 1
    a_plus = _affine_add_g1(gb, A, g_alpha)
    b_plus = _affine_add_g2(gb, B, h_beta)
    f1 = (
        _miller(gb, g_alpha, h_beta)
        * _miller(gb, vk_x, h_gamma)
        * _miller(gb, C, H)
        * _miller(gb, _neg_g1(a_plus), b_plus)
    )
    ok1 = _final_exp_is_one(gb, f1)

    # (2) e(A, h_gamma) e(-g_gamma, B) == 1
    f2 = _miller(gb, A, h_gamma) * _miller(gb, _neg_g1(g_gamma), B)
    ok2 = _final_exp_is_one(gb, f2)

    return gb.band(ok1, ok2)


def _n_wires(n: int) -> int:
    return n + 8 + 18 + 2 * n


@lru_cache(maxsize=None)
def generate_verify_constraints(n: int):
    """Constraint table for `n` inner public inputs. Mirrors the reference
    signature (zokrates_embed/src/ark.rs:48): returns (out_index,
    input_indices, proof_indices, vk_indices, constraints, variable_count)
    over gadget-local variables (0 == one)."""
    gb = GadgetBuilder(Q, _n_wires(n))
    out = _build(gb, n)
    (out_index, coef), = out.lin.items()
    assert coef == 1
    input_indices = list(range(1, 1 + n))
    proof_indices = list(range(1 + n, 1 + n + 8))
    vk_indices = list(range(1 + n + 8, 1 + _n_wires(n)))
    return (
        out_index,
        input_indices,
        proof_indices,
        vk_indices,
        gb.constraints,
        gb.n_vars,
    )


def generate_verify_witness(
    inputs: Sequence[int], proof: Sequence[int], vk: Sequence[int], field=None
) -> List[int]:
    """Full gadget assignment (index == gadget variable id), matching
    generate_verify_constraints' allocation order. Reference:
    zokrates_embed/src/ark.rs:181."""
    assert len(proof) == 8
    assert len(vk) == 18 + 2 * len(inputs)
    vals = [int(v) for v in inputs] + [int(v) for v in proof] + [int(v) for v in vk]
    gb = GadgetBuilder(Q, len(vals), input_values=vals)
    _build(gb, len(inputs))
    return gb.vals
