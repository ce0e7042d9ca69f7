"""The Nova step of the card's checks, a SHA-256 hash chain
(port_artifacts/sha256_chain_pallas.out.gz: the stdlib's one-block SHA-256
of a 32-byte message, h_{i+1} = sha256(h_i) over u32[8], compiled for
pallas by the JAX package's CLI; the README says how), read by the port on
the CPU.

  * it reads as a pallas program of 26,557 constraints, 17 instance
    variables (one, 8 arguments, 8 returns) and 26,362 witness variables,
    the same R1CS as the JAX package reads; nova._state_positions puts the
    arguments at x[0..7] and the returns at x[8..15];
  * one step's returns from the port's interpreter equal hashlib.sha256 of
    the 32-byte state, and so does the next step's from them;
  * nova._cross_term_relaxed between a relaxed vector of step 1 and the
    strict vector of step 2 equals the JAX package's, and is zero between a
    step and the trivial accumulator.

Tolerance: exact equality of integers.
"""

import gzip
import hashlib
import os

import pytest
import torch

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "port_artifacts",
                   "sha256_chain_pallas.out.gz")
Z0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha256_words(words):
    d = hashlib.sha256(b"".join(w.to_bytes(4, "big") for w in words)).digest()
    return [int.from_bytes(d[4 * i:4 * i + 4], "big") for i in range(8)]


@pytest.fixture(scope="module")
def step():
    from zokrates_tpu_torch.interp.interpreter import Interpreter
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    with gzip.open(ART, "rb") as f:
        data = f.read()
    prog = deserialize(data)
    r1cs = r1cs_from_prog(prog)
    wits = [Interpreter().execute(prog, Z0)]
    wits.append(Interpreter().execute(prog, wits[0].return_values()))
    return data, prog, r1cs, wits


def test_artifact_shape_and_state_positions(step):
    from zokrates_tpu_torch.schemes import nova

    _, prog, r1cs, _ = step
    assert prog.curve == r1cs.curve == "pallas"
    assert (r1cs.num_constraints, r1cs.num_instance, r1cs.num_witness) == (26557, 17, 26362)
    assert [sum(len(row) for row in m) for m in (r1cs.A, r1cs.B, r1cs.C)] == [30460, 35961, 307018]
    assert nova._state_positions(prog, r1cs) == (list(range(8)), list(range(8, 16)))


def test_steps_hash_like_hashlib(step):
    _, _, r1cs, wits = step
    assert wits[0].return_values() == _sha256_words(Z0)
    assert wits[1].return_values() == _sha256_words(_sha256_words(Z0))
    full = r1cs.full_assignment(wits[0])
    assert full[1:9] == Z0 and full[9:17] == _sha256_words(Z0)


def test_cross_term_matches_reference(step):
    from zokrates_tpu.ir.r1cs import r1cs_from_prog as j_r1cs
    from zokrates_tpu.ir.serialize import deserialize as j_deserialize
    from zokrates_tpu.schemes import nova as jnova
    from zokrates_tpu_torch.fields import params as P
    from zokrates_tpu_torch.schemes import nova

    data, _, r1cs, wits = step
    jr = j_r1cs(j_deserialize(data))
    assert (jr.A, jr.B, jr.C) == (r1cs.A, r1cs.B, r1cs.C)
    p = P.SCALAR_FIELDS["pallas"].p
    z1, z2 = (r1cs.full_assignment(w) for w in wits)
    u1 = 0x1234567 * (1 << 200) % p
    relaxed = [u1] + [(v * 3 + 1) % p for v in z1[1:]]
    T = nova._cross_term_relaxed(r1cs, relaxed, u1, z2, 1, p)
    assert T == jnova._cross_term_relaxed(jr, relaxed, u1, z2, 1, p)
    assert len(T) == r1cs.num_constraints and any(T)
    zero = [0] * len(z1)
    assert not any(nova._cross_term_relaxed(r1cs, zero, 0, z2, 1, p))
