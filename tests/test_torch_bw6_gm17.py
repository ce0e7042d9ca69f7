"""GM17 over BW6-761 on the CPU, against the JAX package: the reference's
cube program (tests/test_groth16.py) over bw6_761, whose G2 lies over its
761-bit base field (y^2 = x^3 + 4 over Fq), so the b query and h_gamma_t
are points with int coordinates, not Fq2 pairs.

  * setup: the b query holds points of BW6-761's G2 over Fq, and the
    prover's device copy of it is (N, 48) coordinates, as _msm_dev_g2
    takes them over Fq;
  * setup with the same rng: the port's keys equal the JAX package's field
    for field (the b query and h_gamma_t by coordinates), and the
    verification key JSON is equal;
  * convert.gm17_proving_key carries the JAX key across, its G2 points
    given as (x, y) ints;
  * prove at fixed r: from the carried key, the port's proof JSON equals
    the JAX package's byte for byte, and it verifies through both
    packages; a wrong public input and a tampered proof (a <-> c) fail.
    The JAX prove's MSMs are a Python-int oracle (its XLA MSMs would
    compile for minutes); the port's run its plain sorted MSM in a small
    configuration (c = 2, 8 walk lanes: at 48 limbs the default c = 8
    configuration's plain suffix takes about 50 s an MSM on one CPU
    thread), so the b MSM runs the Fq walks over rows packed as G1's.

The JAX reference runs once per module (module-scoped fixtures).
Tolerance: exact equality (integers, points, JSON bytes).
"""

import json
import random

import pytest
import torch
from test_groth16 import cube_prog
from test_torch_gm17 import _oracle_g1, _oracle_g2

from zokrates_tpu.fields import params as JP
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import gm17 as jgm
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ec.curve import g2_group
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.schemes import gm17 as tgm
from zokrates_tpu_torch.schemes.types import fr_to_json

CURVE = "bw6_761"
R = JP.SCALAR_FIELDS[CURVE].p
RAND = R - 0x1234567890ABCDEF  # the prover's fixed r, full width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_rng(seed):
    """The four toxic-waste draws, fixed by a seed, as an rng() callable."""
    draws = iter([random.Random(seed).randrange(1, R) for _ in range(4)])
    return lambda: next(draws)


def _xy(pt):
    """A point over Fq (G1, or BW6-761's G2) as (x, y) ints, None at
    infinity or absent."""
    return None if pt is None or pt.infinity else (pt.x, pt.y)


@pytest.fixture(scope="module")
def cube():
    prog = cube_prog(CURVE)
    r1cs = r1cs_from_prog(prog)
    wit = Interpreter().execute(prog, [3])
    port_r1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, wit, port_r1cs, TWitness(wit.values)


@pytest.fixture(scope="module")
def jax_keys(cube):
    return jgm.setup(cube[0], rng=_seq_rng(7))


@pytest.fixture(scope="module")
def port_keys(cube):
    return tgm.setup(cube[2], rng=_seq_rng(7), device="cpu")


@pytest.fixture(scope="module")
def port_pk(jax_keys):
    """The JAX proving key carried across by convert.gm17_proving_key."""
    pk, _ = jax_keys
    points = {k: _xy(getattr(pk, k)) for k in convert.GM17_G1 + convert.GM17_G2}
    queries = {k: getattr(pk, k) for k in convert.GM17_G1_QUERIES}
    queries["b_query"] = [_xy(pt) for pt in pk.b_query]
    sap = {k: getattr(pk, k) for k in convert.GM17_SAP}
    return convert.gm17_proving_key(CURVE, pk.domain_size, pk.num_instance, pk.num_r1cs_vars, points, queries, sap)


@pytest.fixture(scope="module")
def jax_proof(cube, jax_keys):
    r1cs, wit = cube[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgm, "_msm_g1", _oracle_g1)
        mp.setattr(jgm, "_msm_g2", _oracle_g2)
        return jgm.prove(r1cs, jax_keys[0], wit, rng=lambda: RAND)


@pytest.fixture(scope="module")
def port_proof(cube, port_pk):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ms, "default_config", lambda n: ms.MSMConfig(c=2, M1=8, R=2, lw2=2))
        return tgm.prove(cube[2], port_pk, cube[3], rng=lambda: RAND, device="cpu")


def test_setup_takes_g2_over_fq(port_keys):
    pk, _ = port_keys
    grp = g2_group(CURVE)
    live = [pt for pt in pk.b_query if pt is not None]
    assert live and all(pt.curve is grp and isinstance(pt.x, int) and pt.is_on_curve() for pt in live)
    assert isinstance(pk.h_gamma_t.x, int) and pk.h_gamma_t.is_on_curve()
    d = pk.dev("cpu")
    N = d["bx"].shape[0]
    assert d["bx"].shape == d["by"].shape == (N, 48) and d["b_mask"].shape == (N,)
    assert int(d["b_mask"].sum()) == len(live)


def test_setup_matches_reference(jax_keys, port_keys):
    jpk, jvk = jax_keys
    pk, vk = port_keys
    for name in ("curve", "domain_size", "num_instance", "num_r1cs_vars", "a_query", "c_query",
                 "h_query", "sap_pairs", "sap_U", "sap_W"):
        assert getattr(pk, name) == getattr(jpk, name), name
    assert [_xy(pt) for pt in pk.b_query] == [_xy(pt) for pt in jpk.b_query]
    assert any(pt is None for pt in pk.b_query)  # the SAP's d variables
    for name in convert.GM17_G1 + convert.GM17_G2:
        assert _xy(getattr(pk, name)) == _xy(getattr(jpk, name)), name
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())


def test_carried_key_equals_port_setup(port_pk, port_keys):
    pk, _ = port_keys
    assert [_xy(pt) for pt in port_pk.b_query] == [_xy(pt) for pt in pk.b_query]
    assert _xy(port_pk.h_gamma_t) == _xy(pk.h_gamma_t) and port_pk.h_gamma_t.curve is g2_group(CURVE)
    for name in ("a_query", "c_query", "h_query", "sap_pairs", "sap_U", "sap_W"):
        assert getattr(port_pk, name) == getattr(pk, name), name


def test_prove_matches_reference(jax_keys, jax_proof, port_proof):
    assert json.dumps(port_proof.to_json()) == json.dumps(jax_proof.to_json())
    assert jgm.verify(jax_keys[1], JProof.from_json(port_proof.to_json()))


@pytest.mark.parametrize("case", ["valid", "wrong_input", "tampered"])
def test_verify_rejects_forgeries(port_keys, port_proof, case):
    vk = port_keys[1]
    proof = type(port_proof).from_json(json.loads(json.dumps(port_proof.to_json())))
    if case == "wrong_input":
        proof.inputs[0] = fr_to_json(8, CURVE)
    elif case == "tampered":
        proof.points["a"], proof.points["c"] = proof.points["c"], proof.points["a"]
    assert tgm.verify(vk, proof) == (case == "valid")
