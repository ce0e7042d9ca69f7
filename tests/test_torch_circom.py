"""The port's circom writers (zokrates_tpu_torch.interop.circom) on the CPU
against the JAX package's (zokrates_tpu.interop.circom): the .r1cs and
.wtns files are byte-equal on the reference tests' cube circuit (x = 3) and
on sha256 (bench_artifacts/sha256.out and sha256.witness, 27,459
constraints), each package reading the program and the witness with its
own readers. Host code only; no kernel runs. Tolerance: exact equality of
the bytes.
"""

import io
import os

import pytest

from zokrates_tpu.fields.field import FIELDS as J_FIELDS
from zokrates_tpu.interop import circom as jcircom
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.serialize import deserialize as j_deserialize, serialize as j_serialize
from zokrates_tpu.ir.witness import Witness as JWitness
from zokrates_tpu_torch.fields.field import FIELDS as T_FIELDS
from zokrates_tpu_torch.interop import circom as tcircom
from zokrates_tpu_torch.ir.serialize import deserialize as t_deserialize
from zokrates_tpu_torch.ir.witness import Witness as TWitness

from test_groth16 import cube_prog

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_artifacts")


def _cube():
    prog = cube_prog()
    wit = Interpreter().execute(prog, [3])
    buf = io.BytesIO()
    wit.write(buf, J_FIELDS["bn128"])
    return j_serialize(prog), buf.getvalue()


def _sha256():
    with open(os.path.join(ART, "sha256.out"), "rb") as f:
        prog = f.read()
    with open(os.path.join(ART, "sha256.witness"), "rb") as f:
        return prog, f.read()


@pytest.fixture(scope="module", params=["cube", "sha256"])
def artifacts(request):
    """(program bytes, witness bytes) -> each package's (prog, witness)."""
    prog, wit = {"cube": _cube, "sha256": _sha256}[request.param]()
    jprog = j_deserialize(prog)
    tprog = t_deserialize(prog)
    jwit = JWitness.read(io.BytesIO(wit), J_FIELDS[jprog.curve])
    twit = TWitness.read(io.BytesIO(wit), T_FIELDS[tprog.curve])
    return jprog, jwit, tprog, twit


def _written(fn, *args):
    buf = io.BytesIO()
    fn(buf, *args)
    return buf.getvalue()


def test_r1cs_bytes_equal(artifacts):
    jprog, _, tprog, _ = artifacts
    got = _written(tcircom.write_r1cs, tprog)
    assert got[:4] == b"r1cs" and got == _written(jcircom.write_r1cs, jprog)


def test_wtns_bytes_equal(artifacts):
    jprog, jwit, tprog, twit = artifacts
    got = _written(tcircom.write_wtns, tprog, twit)
    assert got[:4] == b"wtns" and got == _written(jcircom.write_wtns, jprog, jwit)
