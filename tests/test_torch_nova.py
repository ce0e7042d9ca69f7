"""The port's Nova IVC (zokrates_tpu_torch.schemes.nova) on the CPU against
the JAX package's (zokrates_tpu.schemes.nova).

  * hash-to-curve bases equal the reference's at small n, on Pallas and
    Vesta, and so does setup's NovaParams on the square step (z' = z*z + z);
  * prove on the square step over both curves equals the reference's proof
    field for field (z0, zN, each step's x, com(W), com(T), the final W and
    E); each package's verify accepts the other's proof;
  * resume: k steps and then m more equal one chain of k + m;
  * the reference's three tamperings (the state, one step's x, the final
    W) fail, and setup raises NovaError on a private argument and on a
    step with more returns than arguments;
  * compress under one patched secrets.randbelow sequence on both sides
    equals the reference's compressed proof; each package's
    verify_compressed accepts it, and a tampered final IPA scalar or a
    tampered evaluation fails;
  * one step's commitment through the port's own MSM (the sorted MSM's
    plain versions on the CPU) equals the reference's oracle proof, and
    the walk, suffix and epilogue's plain versions at Pallas and Vesta Fq
    with a quarter of the coordinates within 2^8 of q equal the JAX
    package's Python-int point oracle.

Both packages' groth16._msm_g1 take a Python-int oracle MSM except in
test_prove_through_the_port_msm (the JAX CPU MSM compiles an XLA
Pippenger for minutes; the port's plain sorted MSM costs about 10 s a call
on the CPU). Tolerance: exact equality of integers and affine points.
"""

import dataclasses
import random
import secrets

import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import PointG1 as JP1, g1_group as jg1
from zokrates_tpu.fields import params as JP
from zokrates_tpu.ir import program as jprog
from zokrates_tpu.ir.r1cs import r1cs_from_prog as j_r1cs
from zokrates_tpu.schemes import groth16 as jg16
from zokrates_tpu.schemes import ipa as jipa
from zokrates_tpu.schemes import nova as jnova
from zokrates_tpu_torch.ec.curve import PointG1 as TP1, g1_group as tg1
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.ir import program as tprog
from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog as t_r1cs
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.schemes import groth16 as tg16
from zokrates_tpu_torch.schemes import ipa as tipa
from zokrates_tpu_torch.schemes import nova as tnova

CURVES = ["pallas", "vesta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(g1_group, point_cls):
    def msm(curve, points, scalars, device=None):
        grp = g1_group(curve)
        acc = grp.zero()
        for pt, s in zip(points, scalars):
            if pt is not None and s % grp.r:
                acc = acc + point_cls(grp, pt[0], pt[1]) * (s % grp.r)
        return acc
    return msm


@pytest.fixture
def oracle_msms(monkeypatch):
    monkeypatch.setattr(jg16, "_msm_g1", _oracle(jg1, JP1))
    monkeypatch.setattr(tg16, "_msm_g1", _oracle(tg1, TP1))


def square_step_prog(mod, curve, private=False, returns=1):
    """z' = z*z + z (one public argument, one return: the reference tests'
    square_step_prog), built from the program module `mod` of either
    package; `private` makes the argument private, `returns` = 2 adds a
    second return (out1 = out0)."""
    a, t, out = mod.var_new(0), mod.var_new(1), mod.var_public(0)
    L = mod.LinComb
    stmts = [
        mod.Constraint(mod.QuadComb(L.from_var(a), L.from_var(a)), L.from_var(t)),
        mod.Constraint(mod.QuadComb(L.one(), L.from_var(t) + L.from_var(a)), L.from_var(out)),
    ]
    if returns == 2:
        stmts.append(mod.Constraint(mod.QuadComb(L.one(), L.from_var(out)), L.from_var(mod.var_public(1))))
    return mod.Prog(curve=curve, arguments=[mod.Parameter(a, private=private)], return_count=returns,
                    statements=stmts)


def _pair(curve):
    """(prog, r1cs, params) of the square step in each package."""
    jp, tp = square_step_prog(jprog, curve), square_step_prog(tprog, curve)
    jr, tr = j_r1cs(jp), t_r1cs(tp)
    return (jp, jr, jnova.setup(jp, jr)), (tp, tr, tnova.setup(tp, tr))


@pytest.fixture(scope="module")
def pairs():
    return {curve: _pair(curve) for curve in CURVES}


def _plain(obj):
    """A dataclass tree as nested plain values (lists, tuples, ints), so
    that the two packages' proofs compare field for field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _convert(obj, mod):
    """A proof of one package as the other's dataclasses (`mod`: the target
    nova module; IpaProof from its ipa module)."""
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        cls = getattr(mod, name, None) or getattr(jipa if mod is jnova else tipa, name)
        return cls(**{f.name: _convert(getattr(obj, f.name), mod) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert(v, mod) for v in obj)
    return obj


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("label,n", [(b"W", 4), (b"E", 8), (b"Q", 1)])
def test_hash_to_curve_matches_reference(curve, label, n):
    assert tnova._hash_to_curve(curve, label, n) == jnova._hash_to_curve(curve, label, n)
    q = JP.BASE_FIELDS[curve].p
    for a in (0, 1, 4, 5, q - 1):
        assert tnova._sqrt_mod(a, q) == jnova._sqrt_mod(a, q)


@pytest.mark.parametrize("curve", CURVES)
def test_setup_matches_reference(pairs, curve):
    (_, _, jparams), (_, _, tparams) = pairs[curve]
    assert _plain(tparams) == _plain(jparams)
    assert len(tparams.ck_w) == 4 and len(tparams.ck_e) == 2


@pytest.mark.parametrize("curve", CURVES)
def test_prove_matches_reference_and_cross_verifies(pairs, curve, oracle_msms):
    (jp, jr, jparams), (tp, tr, tparams) = pairs[curve]
    jproof = jnova.prove(jp, jr, jparams, [3], num_steps=4)
    tproof = tnova.prove(tp, tr, tparams, [3], num_steps=4, device="cpu")
    assert _plain(tproof) == _plain(jproof)
    p = JP.SCALAR_FIELDS[curve].p
    z = 3
    for _ in range(4):
        z = (z * z + z) % p
    assert tproof.zN == [z]
    assert tproof.steps[0].com_t == (0, 0)  # the trivial accumulator's cross term is zero
    assert tnova.verify(tr, tparams, tproof, device="cpu")
    assert tnova.verify(tr, tparams, _convert(jproof, tnova), device="cpu")
    assert jnova.verify(jr, jparams, _convert(tproof, jnova))


def test_resume_equals_one_chain(pairs, oracle_msms):
    _, (tp, tr, tparams) = pairs["pallas"]
    direct = tnova.prove(tp, tr, tparams, [5], num_steps=5, device="cpu")
    part = tnova.prove(tp, tr, tparams, [5], num_steps=3, device="cpu")
    resumed = tnova.prove(tp, tr, tparams, [0], num_steps=2, resume=part, device="cpu")
    assert resumed.num_steps == 5
    assert resumed == direct
    assert tnova.verify(tr, tparams, resumed, device="cpu")


@pytest.mark.parametrize("tamper", ["state", "step x", "final W"])
def test_tampered_proofs_fail(pairs, oracle_msms, tamper):
    (_, jr, jparams), (tp, tr, tparams) = pairs["pallas"]
    proof = tnova.prove(tp, tr, tparams, [2], num_steps=3, device="cpu")
    if tamper == "state":
        proof.zN[0] ^= 1
    elif tamper == "step x":
        proof.steps[1].x[0] = (proof.steps[1].x[0] + 1) % 7
    else:
        proof.final_W[0] = proof.final_W[0] + 1
    assert not tnova.verify(tr, tparams, proof, device="cpu")
    assert not jnova.verify(jr, jparams, _convert(proof, jnova))


@pytest.mark.parametrize("kind", ["private", "counts"])
def test_setup_refuses_bad_step_circuits(kind):
    prog = square_step_prog(tprog, "pallas", private=kind == "private", returns=2 if kind == "counts" else 1)
    r1cs = t_r1cs(prog)
    with pytest.raises(tnova.NovaError, match="private" if kind == "private" else "public inputs"):
        tnova.setup(prog, r1cs)
    jp = square_step_prog(jprog, "pallas", private=kind == "private", returns=2 if kind == "counts" else 1)
    with pytest.raises(jnova.NovaError):
        jnova.setup(jp, j_r1cs(jp))


def _seeded_randbelow(seed):
    rng = random.Random(seed)
    return lambda n: rng.randrange(n)


@pytest.mark.parametrize("curve", CURVES)
def test_compress_matches_reference(pairs, curve, oracle_msms, monkeypatch):
    (jp, jr, jparams), (tp, tr, tparams) = pairs[curve]
    proof = tnova.prove(tp, tr, tparams, [3], num_steps=3, device="cpu")
    monkeypatch.setattr(secrets, "randbelow", _seeded_randbelow(7))
    jc = jnova.compress(jr, jparams, _convert(proof, jnova))
    monkeypatch.setattr(secrets, "randbelow", _seeded_randbelow(7))
    tc = tnova.compress(tr, tparams, proof, device="cpu")
    assert _plain(tc) == _plain(jc)
    assert tnova.verify_compressed(tr, tparams, tc, device="cpu")
    assert tnova.verify_compressed(tr, tparams, _convert(jc, tnova), device="cpu")
    assert jnova.verify_compressed(jr, jparams, _convert(tc, jnova))

    p = JP.SCALAR_FIELDS[curve].p
    bad_w0 = dataclasses.replace(tc, ipa_w=tipa.IpaProof(tc.ipa_w.Ls, tc.ipa_w.Rs, (tc.ipa_w.w0 + 1) % p))
    vA, vB, vC, vE = tc.evals
    bad_eval = dataclasses.replace(tc, evals=((vA + 1) % p, vB, vC, vE))
    for bad in (bad_w0, bad_eval, dataclasses.replace(tc, zN=[123456])):
        assert not tnova.verify_compressed(tr, tparams, bad, device="cpu")
        assert not jnova.verify_compressed(jr, jparams, _convert(bad, jnova))


def test_prove_through_the_port_msm(pairs, monkeypatch):
    """One step, one real commitment (W; T is zero at step 1): the port's
    plain sorted MSM against the reference's oracle proof."""
    monkeypatch.setattr(jg16, "_msm_g1", _oracle(jg1, JP1))
    (jp, jr, jparams), (tp, tr, tparams) = pairs["vesta"]
    jproof = jnova.prove(jp, jr, jparams, [11], num_steps=1)
    assert _plain(tnova.prove(tp, tr, tparams, [11], num_steps=1, device="cpu")) == _plain(jproof)


# ---------------------------------------------------------------------------
# the MSM kernels' plain versions at Pasta q, near q
# ---------------------------------------------------------------------------


class NearPool:
    """Real points of the curve's G1 with coordinates near q: a quarter of
    the points with x within 2^8 of q (x = q - k on the curve), the rest
    random multiples of the generator; Jacobian rows of them and their
    negatives with random Z, a quarter of the Z within 2^8 of q; one point
    at infinity as the last Jacobian row."""

    def __init__(self, curve, seed, n=8):
        rng = random.Random(seed)
        grp = jg1(curve)
        q = grp.q
        self.grp, self.q = grp, q
        pts = []
        k = 1
        while len(pts) < n // 4:
            x = q - k
            y = jnova._sqrt_mod(x * x % q * x + grp.a * x + grp.b, q)
            if y is not None:
                pts.append(grp.point(x, y))
            k += 1
        assert k < 1 << 8
        pts += [grp.generator() * rng.randrange(1, grp.r) for _ in range(n - len(pts))]
        self.pts = pts
        f = field_ops(q)

        def rows(vals):
            return f.encode(vals).reshape(len(vals), -1).to(torch.int32)

        self.affine = torch.cat([rows([p.x for p in pts]), rows([p.y for p in pts])], 1)
        self.jpts = pts + [-p for p in pts]
        X, Y, Z = [], [], []
        for i, p in enumerate(self.jpts):
            z = q - rng.randrange(1, 1 << 8) if i % 4 == 0 else rng.randrange(1, q)
            X.append(p.x * z * z % q)
            Y.append(p.y * z ** 3 % q)
            Z.append(z)
        X.append(pts[0].x)
        Y.append(pts[0].y)
        Z.append(0)
        self.jac = torch.cat([rows(X), rows(Y), rows(Z)], 1)
        self.jpts.append(grp.zero())

    def point(self, col):
        """One lane's Jacobian column (3 * 16 Montgomery limbs) -> point."""
        q = self.q
        rinv = pow(1 << 256, -1, q)
        X, Y, Z = (sum(int(v) << (16 * i) for i, v in enumerate(col[j * 16:(j + 1) * 16])) * rinv % q
                   for j in range(3))
        if Z == 0:
            return self.grp.zero()
        zi = pow(Z, -1, q)
        return self.grp.point(X * zi * zi % q, Y * zi ** 3 % q)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
def test_walk_plain_near_q_matches_oracle(curve, mode, safe):
    pool = NearPool(curve, seed=3)
    K, L = 6, 16
    rng = np.random.default_rng(4)
    src = pool.affine if mode == "mixed" else pool.jac
    idx = rng.integers(0, src.shape[0], (K, L))
    rows = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    fl = (rng.random((K, L)) < 0.3).astype(np.int32) | ((rng.random((K, L)) < 0.15).astype(np.int32) << 1)
    out, coll = ms.walk(rows, torch.as_tensor(fl), pool.q, mode, safe, None)
    pts = pool.pts if mode == "mixed" else pool.jpts
    for lane in range(L):
        acc, hit = pool.grp.zero(), False
        for k in range(K):
            if not fl[k, lane] & 2:
                pt = pts[idx[k, lane]]
                hit |= mode == "mixed" and not acc.infinity and acc == pt
                acc = acc + pt
            if not (hit and not safe):
                assert pool.point(out[k, :, lane].numpy()) == acc, (lane, k)
            if fl[k, lane] & 1:
                acc = pool.grp.zero()
        assert int(coll[lane]) == int(hit and not safe)


@pytest.mark.parametrize("curve", CURVES)
def test_suffix_and_fold_plain_near_q_match_oracle(curve):
    """The suffix walk's [acc | tot] and the epilogue's window sums from
    those lanes, against the oracle."""
    pool = NearPool(curve, seed=5)
    Lb, M = 4, 8
    rng = np.random.default_rng(6)
    ia = rng.integers(0, pool.jac.shape[0], (Lb, M))
    ib = rng.integers(0, pool.jac.shape[0], (Lb, M))
    A = pool.jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous()
    B = pool.jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous()
    out = ms.suffix(A, B, pool.q, None)
    accs, tots = [], []
    for lane in range(M):
        acc = tot = pool.grp.zero()
        for t in range(Lb):
            acc = acc + pool.jpts[ia[t, lane]] + pool.jpts[ib[t, lane]]
            tot = tot + acc
        col = out[:, lane].numpy()
        assert pool.point(col[:48]) == acc and pool.point(col[48:]) == tot
        accs.append(acc)
        tots.append(tot)
    G, lw = 2, 4  # two windows of four lanes, each lane Lb buckets
    got = ms.suffix_fold(out, pool.q, G, lw, Lb, None)
    assert len(got) == 3
    for g in range(G):
        want = pool.grp.zero()
        for j in range(lw):
            m = g * lw + j
            want = want + accs[m] * ((lw - 1 - j) * Lb) + tots[m]
        col = torch.stack([t[g] for t in got]).reshape(-1).numpy()
        assert pool.point(col) == want, g
