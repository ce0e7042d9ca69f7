"""The port's GM17 (zokrates_tpu_torch.schemes.gm17) and its MSM entry points
(groth16._msm_g1 / _msm_g2) on the CPU against the JAX package's
(zokrates_tpu.schemes.gm17), on the toy circuit of test_torch_groth16.py
compiled with zokrates_tpu.lang.

  * r1cs_to_sap equals the reference's;
  * setup: with the same rng, the port's proving key equals the JAX key
    field for field, and the verification key JSON is equal;
  * prove: given the JAX proving key through convert.gm17_proving_key and
    the same r, the port's proof JSON equals the JAX proof byte for byte,
    and the JAX verify accepts it. The reference proof runs the JAX h
    pipeline with the gm17 module's _msm_g1 / _msm_g2 replaced, for that
    proof only, by a Python-int oracle MSM (sum of s_i * P_i over
    zokrates_tpu.ec.curve): the JAX CPU prove would otherwise compile its
    XLA Pippenger for minutes;
  * a wrong public input and a tampered proof (a <-> c) are rejected;
  * _msm_g1 / _msm_g2 equal the oracle with None points, zero scalars and
    an empty input (_msm_g2 over an oracle in place of its device MSM,
    whose sorted G2 walk the proof's b MSM checks).

The JAX reference runs once per module (module-scoped fixtures).
Tolerance: exact equality throughout (integers, points, JSON bytes).
"""

import json
import random

import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.lang.compile import compile_source
from zokrates_tpu.schemes import gm17 as jgm
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ec.curve import PointG2, g1_group, g2_group
from zokrates_tpu_torch.ec.tower import Fq2
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.schemes import gm17 as tgm
from zokrates_tpu_torch.schemes import groth16 as tg
from zokrates_tpu_torch.schemes.types import fr_to_json

CURVE = "bn128"
P = JP.SCALAR_FIELDS[CURVE].p
SRC = (
    "def main(private field x0, field y) -> field {\n"
    "    field mut x = x0;\n"
    "    for u32 i in 0..20 { x = x * x + y; }\n"
    "    return x;\n"
    "}"
)
R = 0x1234567890ABCDEF  # the prover's fixed r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_rng(seed):
    """The four toxic-waste draws, fixed by a seed, as an rng() callable."""
    draws = iter([random.Random(seed).randrange(1, P) for _ in range(4)])
    return lambda: next(draws)


def _oracle_g1(curve, points, scalars):
    from zokrates_tpu.ec.curve import PointG1, g1_group as jg1

    grp = jg1(curve)
    acc = grp.zero()
    for pt, s in zip(points, scalars):
        if pt is not None and s % grp.r:
            acc = acc + PointG1(grp, pt[0], pt[1]) * (s % grp.r)
    return acc


def _oracle_g2(curve, points, scalars):
    from zokrates_tpu.ec.curve import g2_group as jg2

    grp = jg2(curve)
    acc = grp.zero()
    for pt, s in zip(points, scalars):
        if pt is not None and s % grp.r:
            acc = acc + pt * (s % grp.r)
    return acc


@pytest.fixture(scope="module")
def circuit():
    prog = compile_source(SRC, curve=CURVE).prog
    r1cs = r1cs_from_prog(prog)
    wit = Interpreter().execute(prog, [3, 7])
    port_r1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness,
                             r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, wit, port_r1cs, TWitness(wit.values)


@pytest.fixture(scope="module")
def jax_keys(circuit):
    return jgm.setup(circuit[0], rng=_seq_rng(1))


@pytest.fixture(scope="module")
def port_keys(circuit):
    """The port's own setup, from the same toxic waste as jax_keys."""
    return tgm.setup(circuit[2], rng=_seq_rng(1), device="cpu")


@pytest.fixture(scope="module")
def port_pk(jax_keys):
    """The JAX proving key carried across by convert.gm17_proving_key."""
    pk, _ = jax_keys

    def g2(pt):
        return None if pt is None else ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1))

    points = {k: (getattr(pk, k).x, getattr(pk, k).y) for k in convert.GM17_G1}
    points.update({k: g2(getattr(pk, k)) for k in convert.GM17_G2})
    queries = {k: getattr(pk, k) for k in convert.GM17_G1_QUERIES}
    queries["b_query"] = [g2(pt) for pt in pk.b_query]
    sap = {k: getattr(pk, k) for k in convert.GM17_SAP}
    return convert.gm17_proving_key(CURVE, pk.domain_size, pk.num_instance, pk.num_r1cs_vars,
                                    points, queries, sap)


@pytest.fixture(scope="module")
def jax_proof(circuit, jax_keys):
    r1cs, wit, _, _ = circuit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, "_msm_g1", _oracle_g1)
        mp.setattr(jgm, "_msm_g2", _oracle_g2)
        return jgm.prove(r1cs, jax_keys[0], wit, rng=lambda: R)


@pytest.fixture(scope="module")
def port_proof(circuit, port_pk):
    _, _, r1cs, wit = circuit
    return tgm.prove(r1cs, port_pk, wit, rng=lambda: R, device="cpu")


def _g2_xy(pt):
    return None if pt is None else ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1))


def test_r1cs_to_sap_matches_reference(circuit):
    r1cs, _, port_r1cs, _ = circuit
    want = jgm.r1cs_to_sap(r1cs, P)
    got = tgm.r1cs_to_sap(port_r1cs, P)
    for name in ("num_vars", "num_instance", "U", "W", "pair_sources"):
        assert getattr(got, name) == getattr(want, name), name


def test_setup_matches_reference(jax_keys, port_keys):
    jpk, jvk = jax_keys
    pk, vk = port_keys
    for name in ("curve", "domain_size", "num_instance", "num_r1cs_vars", "a_query", "c_query",
                 "h_query", "sap_pairs", "sap_U", "sap_W"):
        assert getattr(pk, name) == getattr(jpk, name), name
    assert [_g2_xy(pt) for pt in pk.b_query] == [_g2_xy(pt) for pt in jpk.b_query]
    assert any(pt is None for pt in pk.a_query)  # the SAP's d variables
    for name in convert.GM17_G1:
        assert (getattr(pk, name).x, getattr(pk, name).y) == (getattr(jpk, name).x, getattr(jpk, name).y)
    assert _g2_xy(pk.h_gamma_t) == _g2_xy(jpk.h_gamma_t)
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())


def test_prove_matches_reference(jax_keys, jax_proof, port_proof):
    assert json.dumps(port_proof.to_json()) == json.dumps(jax_proof.to_json())
    assert jgm.verify(jax_keys[1], JProof.from_json(port_proof.to_json()))


@pytest.mark.parametrize("case", ["valid", "wrong_input", "tampered"])
def test_verify_rejects_forgeries(jax_keys, port_proof, case):
    vk = convert.verification_key("gm17", CURVE, jax_keys[1].data)
    proof = type(port_proof).from_json(json.loads(json.dumps(port_proof.to_json())))
    if case == "wrong_input":
        proof.inputs[0] = fr_to_json(8, CURVE)
    elif case == "tampered":
        proof.points["a"], proof.points["c"] = proof.points["c"], proof.points["a"]
    assert tgm.verify(vk, proof) == (case == "valid")


def _ints(limbs, mont: bool, q: int):
    """(..., 16) 16-bit limb tensor -> ints, out of Montgomery form if mont."""
    rinv = pow(1 << 256, -1, q) if mont else 1
    return [sum(int(v) << (16 * i) for i, v in enumerate(row)) * rinv % q
            for row in limbs.reshape(-1, limbs.shape[-1]).tolist()]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_entry_points_match_oracle(group, monkeypatch):
    """Distinct points k_i * G, so the MSM is (sum k_i s_i) * G (and the
    doubling-free walk meets no collision: one pass). G1 runs the whole
    entry point down to the plain sorted MSM. For G2 the device MSM
    (_msm_dev_g2) is replaced by a Python-int oracle over the rows it is
    given: this checks _msm_g2's own work (dropping, padding, Montgomery
    coordinates, scalar limbs), and the sorted G2 MSM is checked through
    the proof's b MSM against the reference (test_prove_matches_reference)."""
    rng = random.Random(5)
    grp = g1_group(CURVE) if group == "g1" else g2_group(CURVE)
    ks = [rng.randrange(1, grp.r) for _ in range(11)]
    sc = [rng.randrange(grp.r) for _ in range(11)]
    sc[4] = 0                      # a zero scalar
    sc[5] = grp.r                  # zero mod r
    sc[6] = grp.r + 5              # reduced mod r
    pts = [grp.generator() * k for k in ks]
    pts[2] = None                  # an absent query point
    want = grp.generator() * (sum(k * s for k, s, pt in zip(ks, sc, pts) if pt is not None) % grp.r)
    if group == "g1":
        got = tg._msm_g1(CURVE, [None if pt is None else (pt.x, pt.y) for pt in pts], sc, device="cpu")
        empty = tg._msm_g1(CURVE, [None, (pts[0].x, pts[0].y)], [5, 0], device="cpu")
    else:
        seen = []

        def dev_oracle(curve, Px, Py, S, mask=None):
            assert mask is None and Px.shape == Py.shape == (8, 2, 16)  # 8 pairs left
            seen.append(S.shape[0])
            x, y = _ints(Px, True, grp.q), _ints(Py, True, grp.q)
            acc = grp.zero()
            for j, s in enumerate(_ints(S, False, 1 << 256)):
                pt = PointG2(grp, Fq2(grp.tower, x[2 * j], x[2 * j + 1]), Fq2(grp.tower, y[2 * j], y[2 * j + 1]))
                acc = acc + pt * s
            return acc

        monkeypatch.setattr(tg, "_msm_dev_g2", dev_oracle)
        got = tg._msm_g2(CURVE, pts, sc, device="cpu")
        empty = tg._msm_g2(CURVE, [], [], device="cpu")
        assert seen == [8]         # the empty input reaches no MSM
    assert (got.x, got.y) == (want.x, want.y)
    assert empty.infinity
