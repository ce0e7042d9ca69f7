"""The Pedersen-512 circuit of port_artifacts/ through the port's readers
and interpreter, on the CPU: the size of chip_smoke.py's Marlin phase.

port_artifacts/pedersen512_bn128.out.gz is the standard library's 512-bit
Pedersen hash (hashes/pedersen/512bit) behind `main(private u32[16]
inputs) -> u32[8]`, compiled for bn128 by the JAX package's CLI (see
README.md). The port reads it (gzip, ir/serialize.deserialize,
ir/r1cs.r1cs_from_prog): 3,938 constraints, 3,937 variables and nonzeros
A 4,634, B 9,269, C 3,938, so Marlin's index has |H| = 4,096 and |K| =
16,384 and needs 6|K| - 7 = 98,297 powers of tau, within the CLI's default
universal setup of 2^17. The witness of inputs [0, ..., 15] from the
port's interpreter equals the JAX interpreter's on the JAX package's
reading of the same file, and satisfies every constraint.
Tolerance: exact.
"""

import gzip
import os

import pytest
import torch

from zokrates_tpu.interp.interpreter import Interpreter as JInterpreter
from zokrates_tpu.ir.serialize import deserialize as jdeserialize
from zokrates_tpu_torch.fields import params as P
from zokrates_tpu_torch.interp.interpreter import Interpreter
from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
from zokrates_tpu_torch.ir.serialize import deserialize
from zokrates_tpu_torch.schemes.marlin import _next_pow2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "port_artifacts", "pedersen512_bn128.out.gz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    with gzip.open(ARTIFACT, "rb") as f:
        return f.read()


def test_pedersen512_index_size(data):
    r1cs = r1cs_from_prog(deserialize(data))
    r = P.SCALAR_FIELDS["bn128"].p
    assert r1cs.curve == "bn128"
    assert (r1cs.num_constraints, r1cs.num_variables) == (3938, 3937)
    nnz = [sum(1 for row in m for _, c in row if c % r) for m in (r1cs.A, r1cs.B, r1cs.C)]
    assert nnz == [4634, 9269, 3938]
    n = _next_pow2(max(r1cs.num_constraints, r1cs.num_variables, 2))
    k = _next_pow2(max(max(nnz), 2))
    assert (n, k) == (4096, 16384)
    assert max(n, 6 * k - 7) == 98297 <= 1 << 17


def test_pedersen512_witness_matches_reference(data):
    inputs = list(range(16))
    prog = deserialize(data)
    wit = Interpreter().execute(prog, inputs)
    jwit = JInterpreter().execute(jdeserialize(data), inputs)
    assert wit.values == jwit.values
    r1cs = r1cs_from_prog(prog)
    assert r1cs.check(r1cs.full_assignment(wit), P.SCALAR_FIELDS["bn128"].p)
