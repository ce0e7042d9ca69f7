"""The port's copies of the witness interpreter and the ABI
(zokrates_tpu_torch.interp.interpreter, zokrates_tpu_torch.abi) against the
JAX package's (zokrates_tpu.interp.interpreter, zokrates_tpu.abi):

  * the sha256 circuit's ABI (bench_artifacts/sha256.abi.json) with two
    preimages made as bench.py makes its batch ([16b, ..., 16b + 15]): the
    same flat inputs; the directive solvers that circuit uses (Xor, ShaCh,
    ShaAndXorAndXorAnd, Bits) on seeded inputs: the same outputs;
  * a toy circuit compiled with zokrates_tpu.lang, read back by the port's
    reader, two inputs: the same witness;
  * the solver of the in-circuit BW6 verifier raises (the port has no
    embed/).

Tolerance: exact equality of the witness values.
"""

import json
import os
import random

import pytest

from zokrates_tpu.abi import encode_inputs as j_encode
from zokrates_tpu.fields.field import FIELDS as J_FIELDS
from zokrates_tpu.interp.interpreter import Interpreter as JInterpreter
from zokrates_tpu_torch.abi import encode_inputs as t_encode
from zokrates_tpu_torch.fields.field import FIELDS as T_FIELDS
from zokrates_tpu_torch.interp.interpreter import Interpreter as TInterpreter
from zokrates_tpu_torch.interp.interpreter import execute_solver
from zokrates_tpu_torch.ir.program import Solver
from zokrates_tpu_torch.ir.serialize import deserialize as t_deserialize

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_artifacts")


@pytest.mark.parametrize("b", [0, 15])
def test_sha256_inputs_match_reference(b):
    """bench.py's batch preimages through both ABIs."""
    with open(os.path.join(ART, "sha256.abi.json")) as f:
        abi = json.load(f)
    args = [[[b * 16 + j for j in range(16)]]]
    flat = t_encode(args, abi["inputs"], T_FIELDS["bn128"].P)
    assert flat == j_encode(args, abi["inputs"], J_FIELDS["bn128"].P)
    assert len(flat) == 16


def test_sha256_solvers_match_reference():
    """The directive solvers the sha256 circuit uses, on seeded inputs."""
    from zokrates_tpu.interp.interpreter import execute_solver as j_solve
    from zokrates_tpu.ir.program import Solver as JSolver

    rng = random.Random(6)
    for name, arity, arg in (("Xor", 2, None), ("ShaCh", 3, None), ("ShaAndXorAndXorAnd", 3, None),
                             ("Bits", 1, 32)):
        for _ in range(20):
            ins = [rng.randrange(2) for _ in range(arity)] if arg is None else [rng.randrange(1 << 32)]
            got = execute_solver(Solver(name, arg), ins, T_FIELDS["bn128"])
            assert got == j_solve(JSolver(name, arg), ins, J_FIELDS["bn128"]), (name, ins)


def test_toy_witness_matches_reference():
    from zokrates_tpu.ir.serialize import serialize
    from zokrates_tpu.lang.compile import compile_source

    src = (
        "def main(private field x, field y) -> field {\n"
        "    field mut a = x;\n"
        "    for u32 i in 0..5 { a = a * a + y; }\n"
        "    assert(a != 0);\n"
        "    return a / y;\n"
        "}"
    )
    prog = compile_source(src, curve="bn128").prog
    port_prog = t_deserialize(serialize(prog))
    for inputs in ([3, 7], [12345, 2]):
        assert TInterpreter().execute(port_prog, inputs).values == JInterpreter().execute(prog, inputs).values


def test_bw6_verifier_solver_raises():
    """The SnarkVerifyBls12377 solver (supported since the port has
    embed/) raises on a malformed directive input, as the JAX package's
    does: one inner input takes 8 proof and 20 verification-key wires, and
    10 inputs leave the key one wire. (tests/test_torch_bw6.py holds its
    assignments on the stdlib's test vector.)"""
    from zokrates_tpu.interp.interpreter import execute_solver as j_execute_solver
    from zokrates_tpu.ir.program import Solver as JSolver

    with pytest.raises(AssertionError):
        j_execute_solver(JSolver("SnarkVerifyBls12377", 1), [0] * 10, J_FIELDS["bw6_761"])
    with pytest.raises(AssertionError):
        execute_solver(Solver("SnarkVerifyBls12377", 1), [0] * 10, T_FIELDS["bw6_761"])
