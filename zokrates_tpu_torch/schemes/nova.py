"""Nova IVC: incrementally verifiable computation by R1CS folding.

Reference backend: zokrates_bellperson/src/nova.rs (nova_snark over the pasta
cycle): step-circuit constraint `|public inputs| == |returns|` (nova.rs:44-57),
per-step folding via RecursiveSNARK::prove_step (nova.rs:159-191), Spartan
CompressedSNARK (nova.rs:124-143).

The core of Nova is the *folding scheme* for relaxed R1CS
(Kothapalli-Setty-Tzialla 2021):

  relaxed R1CS:  Az o Bz = u * Cz + E,   z = (u, x, W)
  fold(relaxed U1, strict U2):
      T  = Az1 o Bz2 + Az2 o Bz1 - u1 Cz2 - u2 Cz1
      r  = RO(transcript, com(T))
      (E, u, x, W) <- (E1 + r T, u1 + r, x1 + r x2, W1 + r W2)

Vector commitments are Pedersen over the program curve's G1
(hash-to-curve-derived independent bases), committed through
groth16._msm_g1: the sorted MSM's CUDA kernels on a CUDA device, their plain
versions on the CPU. Every entry point that commits takes `device=`
("cuda" by default). The matrix-vector products and the cross term are
Python-int loops on the host; so are the hash-to-curve of the commitment
keys (setup) and the inner-product arguments' folds (compress).

Divergence from the reference (documented honestly):
  * the folding verifier runs natively instead of inside an augmented step
    circuit, so the proof carries the per-step strict instances
    (x_i, com(W_i), com(T_i)) and verification is O(steps) folds plus one
    O(|W|) final check — constant-size proofs need the in-circuit verifier
    + 2-cycle curve hopping;
  * `compress` implements the reference's CompressedSNARK API as a ZK
    finalization (one extra fold with a uniformly random relaxed pair
    blinds the revealed accumulator witness) followed by a Spartan-style
    sumcheck and inner-product openings (CompressedNovaProof).

The chain is bound through the instances: x_i = (z_i, z_{i+1}) (public step
arguments, then returns), and the verifier walks x_0..x_{N-1} checking
z-continuity before re-folding.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ec.curve import PointG1, g1_group
from ..ec.jacobian import INF1
from ..fields import params as P
from ..interp.interpreter import Interpreter
from ..ir.program import Prog, var_public
from ..ir.r1cs import R1CS
from .marlin import _Transcript


# ---------------------------------------------------------------------------
# Pedersen commitment key (hash-to-curve, independent bases)
# ---------------------------------------------------------------------------


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Tonelli-Shanks; None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # write p-1 = q 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    nr = 2
    while pow(nr, (p - 1) // 2, p) != p - 1:
        nr += 1
    c = pow(nr, q, p)
    x = pow(a, (q + 1) // 2, p)
    t = pow(a, q, p)
    m = s
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        x = x * b % p
        c = b * b % p
        t = t * c % p
        m = i
    return x


def _hash_to_curve(curve: str, label: bytes, n: int) -> List[Tuple[int, int]]:
    """n independent G1 bases by try-and-increment (no known dlog relations,
    unlike multiples of the generator)."""
    grp = g1_group(curve)
    q, a, b = grp.q, grp.a, grp.b
    out = []
    for i in range(n):
        x = int.from_bytes(
            hashlib.sha3_256(b"zokrates-tpu nova ck|" + label + b"|" + i.to_bytes(8, "big")).digest(),
            "big",
        ) % q
        while True:
            rhs = (x * x % q * x + a * x + b) % q
            y = _sqrt_mod(rhs, q)
            if y is not None:
                y = min(y, q - y)
                pt = grp.point(x, y)
                # clear cofactor is a no-op for prime-order pasta/bn/bls G1
                out.append((pt.x, pt.y))
                break
            x = (x + 1) % q
    return out


def _commit(curve: str, bases: Sequence[Tuple[int, int]], scalars: Sequence[int], device="cuda") -> PointG1:
    from . import groth16

    assert len(scalars) <= len(bases)
    return groth16._msm_g1(curve, list(bases[: len(scalars)]), list(scalars), device=device)


def _xy(pt: PointG1) -> Tuple[int, int]:
    return (pt.x, pt.y) if pt.x is not None else (0, 0)


# ---------------------------------------------------------------------------
# data model
# ---------------------------------------------------------------------------


@dataclass
class NovaParams:
    curve: str
    num_instance: int
    num_witness: int
    num_constraints: int
    arg_pos: List[int]     # dense indices (within x = z[1:ni]) of the step args
    out_pos: List[int]     # dense indices (within x) of the step returns
    # commitment keys are padded to powers of two: ck_w to the z-cube
    # half-width (>= max(ni, nw)) and ck_e to the padded row count, so the
    # compress argument's inner-product openings run over full cubes
    ck_w: List[Tuple[int, int]]
    ck_e: List[Tuple[int, int]]
    ck_q: Tuple[int, int] = (0, 0)  # extra IPA base


@dataclass
class RelaxedInstance:
    u: int
    x: List[int]
    com_w: PointG1
    com_e: PointG1


@dataclass
class RelaxedWitness:
    W: List[int]
    E: List[int]


@dataclass
class StepRecord:
    x: List[int]
    com_w: Tuple[int, int]
    com_t: Tuple[int, int]


@dataclass
class NovaProof:
    curve: str
    num_steps: int
    z0: List[int]
    zN: List[int]
    steps: List[StepRecord]
    final_W: List[int]
    final_E: List[int]


@dataclass
class BlindRecord:
    """Random relaxed instance used by the zk finalization fold."""

    u: int
    x: List[int]
    com_w: Tuple[int, int]
    com_e: Tuple[int, int]
    com_t: Tuple[int, int]


@dataclass
class CompressedNovaProof:
    """ZK-finalized, witness-free IVC proof (the `compress` output —
    reference CompressedSNARK, zokrates_bellperson/src/nova.rs:124-143).

    Construction: (1) one extra fold with a uniformly random satisfying
    relaxed pair blinds the accumulator (W_f = W + r*W_r is uniform, so
    nothing the argument later reveals about W_f leaks the real witness);
    (2) a Spartan-style two-phase sumcheck reduces the relaxed-R1CS check
    Az o Bz = u*Cz + E over the blinded accumulator to evaluations of the
    committed vectors' MLEs, proven against the (homomorphically folded)
    Pedersen commitments with Bulletproofs inner-product arguments. The
    proof carries NO witness vectors — O(steps) step instances plus
    O(log n) sumcheck/IPA messages. Divergence from the reference
    (documented): nova_snark's compressed verifier is O(log n) after
    preprocessing; ours evaluates the (public) matrix MLEs itself, an
    O(nnz) field-work verifier with the same proof-size asymptotics."""

    curve: str
    num_steps: int
    z0: List[int]
    zN: List[int]
    steps: List[StepRecord]
    blind: BlindRecord
    sc1: List[List[int]]           # round polys (deg-3 evals) of sumcheck 1
    evals: Tuple[int, int, int, int]  # vA, vB, vC, vE at ry
    sc2: List[List[int]]           # round polys (deg-2 evals) of sumcheck 2
    vZ: int                        # z-cube MLE at rx
    ipa_w: object                  # IpaProof opening <W, eq(rx, half+.)>
    ipa_e: object                  # IpaProof opening <E, eq(ry, .)>


class NovaError(ValueError):
    pass


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


def _state_positions(prog: Prog, r1cs: R1CS) -> Tuple[List[int], List[int]]:
    """Positions of (args, returns) inside x = dense z[1:num_instance]."""
    arg_pos, out_pos = [], []
    for arg in prog.arguments:
        if arg.private:
            raise NovaError("nova step circuits cannot take private arguments")
        arg_pos.append(r1cs.ir_to_dense[arg.id] - 1)
    for i in range(prog.return_count):
        v = var_public(i)
        if v not in r1cs.ir_to_dense:
            raise NovaError("step return not bound to a constraint")
        out_pos.append(r1cs.ir_to_dense[v] - 1)
    if len(arg_pos) != len(out_pos):
        raise NovaError(
            f"nova requires |public inputs| == |returns| "
            f"(got {len(arg_pos)} vs {len(out_pos)}, cf. nova.rs:44-57)"
        )
    return arg_pos, out_pos


def _pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def setup(prog: Prog, r1cs: R1CS) -> NovaParams:
    """The step's positions and the commitment keys. Host work only (the
    bases come from hash-to-curve), so it takes no device."""
    arg_pos, out_pos = _state_positions(prog, r1cs)
    curve = r1cs.curve
    n_half = max(_pow2(r1cs.num_instance), _pow2(r1cs.num_witness), 2)
    nc2 = max(_pow2(r1cs.num_constraints), 2)
    return NovaParams(
        curve=curve,
        num_instance=r1cs.num_instance,
        num_witness=r1cs.num_witness,
        num_constraints=r1cs.num_constraints,
        arg_pos=arg_pos,
        out_pos=out_pos,
        ck_w=_hash_to_curve(curve, b"W", n_half),
        ck_e=_hash_to_curve(curve, b"E", nc2),
        ck_q=_hash_to_curve(curve, b"Q", 1)[0],
    )


# ---------------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------------


def _mat_vec(rows, z: Sequence[int], p: int) -> List[int]:
    return [sum(c * z[i] for i, c in row) % p for row in rows]


def _zvec(inst_u: int, x: Sequence[int], W: Sequence[int]) -> List[int]:
    return [inst_u] + list(x) + list(W)


def _absorb_step(tr: _Transcript, x: Sequence[int], com_w: PointG1, com_t: PointG1):
    for v in x:
        tr.absorb_int(v)
    tr.absorb_point(com_w)
    tr.absorb_point(com_t)


def _fold_instance(
    U1: RelaxedInstance, x2: Sequence[int], com_w2: PointG1, com_t: PointG1, rch: int, p: int
) -> RelaxedInstance:
    return RelaxedInstance(
        u=(U1.u + rch) % p,
        x=[(a + rch * b) % p for a, b in zip(U1.x, x2)],
        com_w=U1.com_w + com_w2 * rch,
        com_e=U1.com_e + com_t * rch,
    )


def _trivial(curve: str, ni: int, nw: int, nc: int) -> Tuple[RelaxedInstance, RelaxedWitness]:
    zero = g1_group(curve).zero()
    return (
        RelaxedInstance(u=0, x=[0] * (ni - 1), com_w=zero, com_e=zero),
        RelaxedWitness(W=[0] * nw, E=[0] * nc),
    )


def _start_transcript(params: NovaParams, z0: Sequence[int], p: int) -> _Transcript:
    tr = _Transcript(b"zokrates-tpu nova v1")
    for v in (params.num_instance, params.num_witness, params.num_constraints):
        tr.absorb_int(v)
    # bind the commitment key (first/last base of each)
    for ck in (params.ck_w, params.ck_e):
        for pt in (ck[0], ck[-1]):
            tr.absorb_int(pt[0])
            tr.absorb_int(pt[1])
    for v in z0:
        tr.absorb_int(v % p)
    return tr


def _replay(curve: str, params: NovaParams, steps: Sequence[StepRecord], z0: Sequence[int], p: int,
            z_chain: bool):
    """Rebuild (transcript, folded instance) by replaying the step records;
    with `z_chain`, each step's args must equal the running state, and the
    state after the last step is returned too (None where a check
    fails: a record of the wrong length, a broken chain)."""
    acc_U, _ = _trivial(curve, params.num_instance, params.num_witness, params.num_constraints)
    tr = _start_transcript(params, z0, p)
    z_i = [v % p for v in z0]
    for rec in steps:
        if z_chain:
            if len(rec.x) != params.num_instance - 1:
                return tr, acc_U, None
            # chain binding: this step's args must equal the running state
            if [rec.x[i] for i in params.arg_pos] != z_i:
                return tr, acc_U, None
        com_w2 = _pt(curve, rec.com_w)
        com_t = _pt(curve, rec.com_t)
        _absorb_step(tr, rec.x, com_w2, com_t)
        acc_U = _fold_instance(acc_U, rec.x, com_w2, com_t, tr.squeeze(p), p)
        if z_chain:
            z_i = [rec.x[i] for i in params.out_pos]
    return tr, acc_U, z_i


def prove(
    prog: Prog,
    r1cs: R1CS,
    params: NovaParams,
    z0: Sequence[int],
    num_steps: int,
    resume: Optional[NovaProof] = None,
    device="cuda",
) -> NovaProof:
    """Fold `num_steps` more steps.  With `resume`, continues an existing
    proof (the reference's `nova prove --continue`, ops/nova/prove.rs:153-156):
    the transcript and folded instance are rebuilt by replay, the folded
    witness carries over. Each step commits W and T on `device`."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    ni = r1cs.num_instance
    if num_steps < 1:
        raise NovaError("need at least one step")

    if resume is not None:
        z0 = [v % p for v in resume.z0]
        tr, acc_U, _ = _replay(curve, params, resume.steps, z0, p, z_chain=False)
        acc_W = RelaxedWitness(W=list(resume.final_W), E=list(resume.final_E))
        z_i = [v % p for v in resume.zN]
        steps = list(resume.steps)
    else:
        z0 = [v % p for v in z0]
        acc_U, acc_W = _trivial(curve, ni, r1cs.num_witness, r1cs.num_constraints)
        tr = _start_transcript(params, z0, p)
        z_i = list(z0)
        steps = []

    for _ in range(num_steps):
        wit = Interpreter().execute(prog, z_i)
        z_next = [v % p for v in wit.return_values()]
        full = [v % p for v in r1cs.full_assignment(wit)]
        x2 = full[1:ni]
        W2 = full[ni:]
        com_w2 = _commit(curve, params.ck_w, W2, device)

        # cross term between the accumulator and this step's strict instance
        T = _cross_term_relaxed(r1cs, _zvec(acc_U.u, acc_U.x, acc_W.W), acc_U.u, _zvec(1, x2, W2), 1, p)
        com_t = _commit(curve, params.ck_e, T, device)

        _absorb_step(tr, x2, com_w2, com_t)
        rch = tr.squeeze(p)

        acc_U = _fold_instance(acc_U, x2, com_w2, com_t, rch, p)
        acc_W = RelaxedWitness(
            W=[(a + rch * b) % p for a, b in zip(acc_W.W, W2)],
            E=[(e + rch * t) % p for e, t in zip(acc_W.E, T)],
        )
        steps.append(StepRecord(x=x2, com_w=_xy(com_w2), com_t=_xy(com_t)))
        z_i = z_next

    return NovaProof(
        curve=curve,
        num_steps=len(steps),
        z0=z0,
        zN=z_i,
        steps=steps,
        final_W=acc_W.W,
        final_E=acc_W.E,
    )


def _pt(curve: str, xy: Tuple[int, int]) -> PointG1:
    grp = g1_group(curve)
    if xy == (0, 0):
        return grp.zero()
    pt = grp.point(xy[0], xy[1])
    if not pt.is_on_curve():
        raise NovaError("proof point not on curve")
    return pt


def _replay_checked(r1cs: R1CS, params: NovaParams, proof):
    """The verifiers' replay of a proof's step records: (transcript,
    folded instance), or None where the record count, a record's length,
    the state chain or a point fails."""
    p = P.SCALAR_FIELDS[r1cs.curve].p
    if proof.num_steps != len(proof.steps) or proof.num_steps < 1:
        return None
    try:
        tr, acc_U, z_N = _replay(r1cs.curve, params, proof.steps, proof.z0, p, z_chain=True)
    except NovaError:
        return None
    if z_N is None or z_N != [v % p for v in proof.zN]:
        return None
    return tr, acc_U


def verify(r1cs: R1CS, params: NovaParams, proof: NovaProof, device="cuda") -> bool:
    """Replay the chain, then open the folded instance with the final
    witness (two commitments on `device`) and check the relaxed R1CS."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    replayed = _replay_checked(r1cs, params, proof)
    if replayed is None:
        return False
    _, acc_U = replayed

    # final check: the folded witness opens the folded instance...
    com_w = _commit(curve, params.ck_w, proof.final_W, device)
    com_e = _commit(curve, params.ck_e, proof.final_E, device)
    if (com_w.x, com_w.y) != (acc_U.com_w.x, acc_U.com_w.y):
        return False
    if (com_e.x, com_e.y) != (acc_U.com_e.x, acc_U.com_e.y):
        return False

    # ...and satisfies the relaxed R1CS
    z = _zvec(acc_U.u, acc_U.x, proof.final_W)
    az, bz, cz = (_mat_vec(m, z, p) for m in (r1cs.A, r1cs.B, r1cs.C))
    return all(
        a * b % p == (acc_U.u * c + e) % p
        for a, b, c, e in zip(az, bz, cz, proof.final_E)
    )


def _replay_fold(r1cs: R1CS, params: NovaParams, proof: NovaProof):
    """Rebuild (transcript, folded instance) by replaying the step records."""
    p = P.SCALAR_FIELDS[r1cs.curve].p
    tr, acc_U, _ = _replay(r1cs.curve, params, proof.steps, proof.z0, p, z_chain=False)
    return tr, acc_U


def _cross_term_relaxed(r1cs: R1CS, z1, u1, z2, u2, p: int) -> List[int]:
    az1, bz1, cz1 = (_mat_vec(m, z1, p) for m in (r1cs.A, r1cs.B, r1cs.C))
    az2, bz2, cz2 = (_mat_vec(m, z2, p) for m in (r1cs.A, r1cs.B, r1cs.C))
    return [
        (a1 * b2 + a2 * b1 - u1 * c2 - u2 * c1) % p
        for a1, b1, c1, a2, b2, c2 in zip(az1, bz1, cz1, az2, bz2, cz2)
    ]


def _absorb_blind(tr: _Transcript, u_r: int, x_r, com_w_r, com_e_r, com_t):
    tr.absorb_int(u_r)
    for v in x_r:
        tr.absorb_int(v)
    tr.absorb_point(com_w_r)
    tr.absorb_point(com_e_r)
    tr.absorb_point(com_t)


def compress(r1cs: R1CS, params: NovaParams, proof: NovaProof, device="cuda") -> CompressedNovaProof:
    """ZK finalization (the reference's CompressedSNARK API surface,
    zokrates_bellperson/src/nova.rs:124-143): fold the accumulator with a
    uniformly random satisfying relaxed pair, then open the blinded fold.
    The blinding pair's three commitments run on `device`; the sumchecks
    and inner-product arguments on the host. See CompressedNovaProof for
    the honest divergence notes."""
    import secrets

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    tr, acc_U = _replay_fold(r1cs, params, proof)
    acc_W = RelaxedWitness(W=list(proof.final_W), E=list(proof.final_E))

    # random satisfying relaxed pair: E_r := Az_r∘Bz_r - u_r·Cz_r
    W_r = [secrets.randbelow(p) for _ in range(r1cs.num_witness)]
    x_r = [secrets.randbelow(p) for _ in range(r1cs.num_instance - 1)]
    u_r = secrets.randbelow(p - 1) + 1
    z_r = _zvec(u_r, x_r, W_r)
    az, bz, cz = (_mat_vec(m, z_r, p) for m in (r1cs.A, r1cs.B, r1cs.C))
    E_r = [(a * b - u_r * c) % p for a, b, c in zip(az, bz, cz)]
    com_w_r = _commit(curve, params.ck_w, W_r, device)
    com_e_r = _commit(curve, params.ck_e, E_r, device)

    z1 = _zvec(acc_U.u, acc_U.x, acc_W.W)
    T = _cross_term_relaxed(r1cs, z1, acc_U.u, z_r, u_r, p)
    com_t = _commit(curve, params.ck_e, T, device)

    _absorb_blind(tr, u_r, x_r, com_w_r, com_e_r, com_t)
    r = tr.squeeze(p)

    W_f = [(a + r * b) % p for a, b in zip(acc_W.W, W_r)]
    E_f = [
        (e + r * t + r * r * er) % p
        for e, t, er in zip(acc_W.E, T, E_r)
    ]
    u_f = (acc_U.u + r * u_r) % p
    x_f = [(a + r * v) % p for a, v in zip(acc_U.x, x_r)]

    sc1, evals, sc2, vZ, ipa_w, ipa_e = _spartan_prove(
        r1cs, params, tr, u_f, x_f, W_f, E_f
    )

    return CompressedNovaProof(
        curve=curve,
        num_steps=proof.num_steps,
        z0=list(proof.z0),
        zN=list(proof.zN),
        steps=list(proof.steps),
        blind=BlindRecord(
            u=u_r, x=x_r, com_w=_xy(com_w_r), com_e=_xy(com_e_r), com_t=_xy(com_t)
        ),
        sc1=sc1,
        evals=evals,
        sc2=sc2,
        vZ=vZ,
        ipa_w=ipa_w,
        ipa_e=ipa_e,
    )


def _zcube_pos(j: int, ni: int, n_half: int) -> int:
    """Dense z index ([u] + x + W) -> position in the 2*n_half cube
    (public block in the low half, witness block in the high half)."""
    return j if j < ni else n_half + (j - ni)


def _spartan_prove(r1cs: R1CS, params: NovaParams, tr, u_f, x_f, W_f, E_f):
    """Two-phase Spartan sumcheck + IPA openings for the blinded folded
    relaxed instance. Shares `tr` (already past the blind-fold squeeze)
    with the verifier replay. Host work only."""
    from .ipa import ipa_prove
    from .sumcheck import eq_table, sumcheck_prove

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    q = P.BASE_FIELDS[curve].p
    ni = r1cs.num_instance
    n_half = len(params.ck_w)
    nc2 = len(params.ck_e)
    lc = nc2.bit_length() - 1

    z_f = _zvec(u_f, x_f, W_f)
    az, bz, cz = (_mat_vec(m, z_f, p) for m in (r1cs.A, r1cs.B, r1cs.C))
    pad = nc2 - len(az)
    az, bz, cz = az + [0] * pad, bz + [0] * pad, cz + [0] * pad
    e_pad = list(E_f) + [0] * (nc2 - len(E_f))

    tau = [tr.squeeze(p) for _ in range(lc)]
    eqt = eq_table(tau, p)

    def comb1(e, a, b, c, ee):
        return e * ((a * b - u_f * c - ee) % p) % p

    sc1, ry, fin1 = sumcheck_prove(tr, p, [eqt, az, bz, cz, e_pad], comb1, 3)
    vA, vB, vC, vE = fin1[1], fin1[2], fin1[3], fin1[4]
    for v in (vA, vB, vC, vE):
        tr.absorb_int(v)
    rho = [tr.squeeze(p) for _ in range(3)]

    eq_ry = eq_table(ry, p)
    mvec = [0] * (2 * n_half)
    for mat, rh in zip((r1cs.A, r1cs.B, r1cs.C), rho):
        for i, row in enumerate(mat):
            w = rh * eq_ry[i] % p
            for j, coef in row:
                pos = _zcube_pos(j, ni, n_half)
                mvec[pos] = (mvec[pos] + w * coef) % p
    zcube = (
        [u_f] + list(x_f) + [0] * (n_half - ni)
        + list(W_f) + [0] * (n_half - len(W_f))
    )

    sc2, rx, fin2 = sumcheck_prove(
        tr, p, [mvec, zcube], lambda m, z: m * z % p, 2
    )
    vZ = fin2[1]
    tr.absorb_int(vZ)

    eq_rx = eq_table(rx, p)
    c_w = eq_rx[n_half:]
    w_pad = list(W_f) + [0] * (n_half - len(W_f))
    ipa_w = ipa_prove(tr, p, q, params.ck_w, params.ck_q, w_pad, c_w)
    ipa_e = ipa_prove(tr, p, q, params.ck_e, params.ck_q, e_pad, eq_ry)
    return sc1, (vA, vB, vC, vE), sc2, vZ, ipa_w, ipa_e


def verify_compressed(
    r1cs: R1CS, params: NovaParams, proof: CompressedNovaProof, device="cuda"
) -> bool:
    """Replay the chain as verify() does, fold in the blinding pair, and
    check the sumchecks and the two inner-product openings (their final
    MSMs through _commit on `device`)."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    replayed = _replay_checked(r1cs, params, proof)
    if replayed is None:
        return False
    tr, acc_U = replayed
    b = proof.blind
    try:
        com_w_r = _pt(curve, b.com_w)
        com_e_r = _pt(curve, b.com_e)
        com_t = _pt(curve, b.com_t)
    except NovaError:
        return False
    _absorb_blind(tr, b.u % p, b.x, com_w_r, com_e_r, com_t)
    r = tr.squeeze(p)

    u_f = (acc_U.u + r * b.u) % p
    x_f = [(a + r * v) % p for a, v in zip(acc_U.x, b.x)]
    com_w_f = acc_U.com_w + com_w_r * r
    com_e_f = acc_U.com_e + com_t * r + com_e_r * (r * r % p)

    return _spartan_verify(
        r1cs, params, tr, u_f, x_f, com_w_f, com_e_f, proof, device
    )


def _spartan_verify(
    r1cs: R1CS, params: NovaParams, tr, u_f, x_f, com_w_f, com_e_f,
    proof: CompressedNovaProof, device="cuda",
) -> bool:
    from .ipa import ipa_verify
    from .sumcheck import eq_point, eq_table, sumcheck_verify

    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    q = P.BASE_FIELDS[curve].p
    ni = r1cs.num_instance
    n_half = len(params.ck_w)
    nc2 = len(params.ck_e)
    lc = nc2.bit_length() - 1
    lz = (2 * n_half).bit_length() - 1
    if len(proof.sc1) != lc or len(proof.sc2) != lz:
        return False

    tau = [tr.squeeze(p) for _ in range(lc)]
    out1 = sumcheck_verify(tr, p, 0, proof.sc1, 3)
    if out1 is None:
        return False
    ry, claim1 = out1
    vA, vB, vC, vE = (v % p for v in proof.evals)
    if claim1 != eq_point(tau, ry, p) * ((vA * vB - u_f * vC - vE) % p) % p:
        return False
    for v in (vA, vB, vC, vE):
        tr.absorb_int(v)
    rho = [tr.squeeze(p) for _ in range(3)]

    out2 = sumcheck_verify(
        tr, p, (rho[0] * vA + rho[1] * vB + rho[2] * vC) % p, proof.sc2, 2
    )
    if out2 is None:
        return False
    rx, claim2 = out2
    vZ = proof.vZ % p
    tr.absorb_int(vZ)

    # the verifier evaluates the (public) combined matrix MLE itself
    eq_ry = eq_table(ry, p)
    eq_rx = eq_table(rx, p)
    m_eval = 0
    for mat, rh in zip((r1cs.A, r1cs.B, r1cs.C), rho):
        for i, row in enumerate(mat):
            w = rh * eq_ry[i] % p
            for j, coef in row:
                m_eval = (m_eval + w * coef % p * eq_rx[_zcube_pos(j, ni, n_half)]) % p
    if claim2 != m_eval * vZ % p:
        return False

    # split vZ into its public part and the committed-witness opening
    z_pub = [u_f] + list(x_f)
    pub = sum(v * eq_rx[j] for j, v in enumerate(z_pub)) % p
    vW = (vZ - pub) % p

    def msm(_q, pts, scalars):
        pt = _commit(curve, pts, scalars, device)
        return INF1 if pt.x is None else (pt.x, pt.y, 1)

    if not ipa_verify(
        tr, p, q, params.ck_w, params.ck_q, _xy(com_w_f),
        eq_rx[n_half:], vW, proof.ipa_w, msm_host=msm,
    ):
        return False
    return ipa_verify(
        tr, p, q, params.ck_e, params.ck_q, _xy(com_e_f),
        eq_ry, vE, proof.ipa_e, msm_host=msm,
    )
