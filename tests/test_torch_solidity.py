"""The port's Solidity exporters (zokrates_tpu_torch.schemes.solidity and
solidity_marlin) on the CPU against the JAX package's: the same verifier
contract, as a string, for a Groth16, a GM17 and a Marlin verification key
read from the same JSON, and the same proof_to_token of a proof JSON.

The Groth16 and GM17 keys and the proof hold seeded multiples of the
generators in the layout of those schemes' setup (the exporters only format
the points); the Marlin key is the port's own setup_with_srs of the
mul_pub program of test_groth16.py (one public input, so the contract lists
omega powers) over a degree-32 SRS, its MSMs by a Python-int oracle (the
port's plain sorted MSM costs about 10 s a call on the CPU).
Tolerance: exact string equality.
"""

import json
import random

import pytest
import torch

from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import solidity as jsol
from zokrates_tpu.schemes.types import VerificationKey as JVK
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ec.curve import PointG1, g1_group, g2_group
from zokrates_tpu_torch.schemes import groth16 as tg16
from zokrates_tpu_torch.schemes import marlin as tm
from zokrates_tpu_torch.schemes import solidity as tsol
from zokrates_tpu_torch.schemes.types import VerificationKey, fr_to_json, g1_to_json, g2_to_json

from test_groth16 import mul_pub_prog

CURVE = "bn128"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed):
    rnd = random.Random(seed)
    g1, g2 = g1_group(CURVE), g2_group(CURVE)
    return (lambda: g1_to_json(g1.generator() * rnd.randrange(1, g1.r), CURVE),
            lambda: g2_to_json(g2.generator() * rnd.randrange(1, g2.r), CURVE))


def _g16_vk():
    p1, p2 = _points(1)
    return VerificationKey("g16", CURVE, {"alpha": p1(), "beta": p2(), "gamma": p2(), "delta": p2(),
                                          "gamma_abc": [p1() for _ in range(3)]})


def _gm17_vk():
    p1, p2 = _points(2)
    return VerificationKey("gm17", CURVE, {"h": p2(), "g_alpha": p1(), "h_beta": p2(), "g_gamma": p1(),
                                           "h_gamma": p2(), "query": [p1() for _ in range(3)]})


def _marlin_vk(monkeypatch):
    def oracle(curve, points, scalars, device=None):
        grp = g1_group(curve)
        acc = grp.zero()
        for pt, s in zip(points, scalars):
            if pt is not None and s % grp.r:
                acc = acc + PointG1(grp, pt[0], pt[1]) * (s % grp.r)
        return acc

    monkeypatch.setattr(tg16, "_msm_g1", oracle)
    r1cs = r1cs_from_prog(mul_pub_prog())
    tr1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    rnd = random.Random(3)
    srs = tm.universal_setup(CURVE, 32, rng=lambda: rnd.randrange(1, 1 << 250), device="cpu")
    return tm.setup_with_srs(srs, tr1cs, device="cpu")[1]


@pytest.mark.parametrize("scheme", ["g16", "gm17", "marlin"])
def test_export_matches_reference(scheme, monkeypatch):
    vk = {"g16": _g16_vk, "gm17": _gm17_vk, "marlin": lambda: _marlin_vk(monkeypatch)}[scheme]()
    data = json.loads(json.dumps(vk.to_json()))
    got = tsol.export_solidity_verifier(VerificationKey.from_json(data))
    assert got == jsol.export_solidity_verifier(JVK.from_json(data))
    assert "contract Verifier" in got and "verifyTx" in got


def test_proof_to_token_matches_reference():
    p1, p2 = _points(4)
    proof = {"scheme": "g16", "curve": CURVE, "proof": {"a": p1(), "b": p2(), "c": p1()},
             "inputs": [fr_to_json(v, CURVE) for v in (5, 1 << 200)]}
    assert tsol.proof_to_token(proof) == jsol.proof_to_token(proof)


def test_export_refuses_other_curves():
    vk = VerificationKey("g16", "bls12_381", {})
    with pytest.raises(ValueError, match="only supported for bn128"):
        tsol.export_solidity_verifier(vk)
