"""The BLS12-381 sha256 circuit of port_artifacts/ through the port's
readers and interpreter, on the CPU.

port_artifacts/sha256_bls12_381.out.gz is the bench's sha256 program
compiled for bls12_381 by the JAX package's CLI (see README.md). The port
reads it (gzip, ir/serialize.deserialize, ir/r1cs.r1cs_from_prog): the
curve, 27,459 constraints (the same as bench_artifacts/sha256.out) and
27,281 variables. The witness the port's interpreter computes from
preimage [0, ..., 15], encoded by the ABI of bench_artifacts/sha256.abi.json
over BLS12-381's r, satisfies every constraint, and its eight outputs are
the SHA-256 compression of that one 512-bit block from the standard IV (the
stdlib's sha256 of a u32[1][16] pads nothing), computed here in Python.
Tolerance: exact.
"""

import gzip
import json
import os

import pytest
import torch

from zokrates_tpu_torch.abi import encode_inputs
from zokrates_tpu_torch.fields.field import FIELDS
from zokrates_tpu_torch.interp.interpreter import Interpreter
from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog
from zokrates_tpu_torch.ir.serialize import deserialize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M32 = 0xFFFFFFFF
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
# round constants: the first 32 bits of the fractional parts of the cube
# roots of the first 64 primes
PRIMES = [n for n in range(2, 312) if all(n % d for d in range(2, int(n ** 0.5) + 1))][:64]


def _icbrt(x):
    lo, hi = 0, 1 << (x.bit_length() // 3 + 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if mid ** 3 <= x else (lo, mid - 1)
    return lo


K = [_icbrt(p << 96) & M32 for p in PRIMES]


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_compress(block):
    """SHA-256's compression function of one block of 16 words, from IV."""
    w = list(block)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = IV
    for t in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + K[t] + w[t]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & M32
        a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
    return [(x + y) & M32 for x, y in zip(IV, (a, b, c, d, e, f, g, h))]


def test_sha256_compress_matches_the_standard():
    """The compression above, on the padded empty message, gives the
    published SHA-256 of the empty string."""
    want = bytes.fromhex("e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")
    got = sha256_compress([0x80000000] + [0] * 15)
    assert b"".join(x.to_bytes(4, "big") for x in got) == want


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in the other port test files (the suite runs
    several test processes side by side on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sha256_bls12_381_artifact():
    with gzip.open(os.path.join(ROOT, "port_artifacts", "sha256_bls12_381.out.gz"), "rb") as f:
        prog = deserialize(f.read())
    assert prog.curve == "bls12_381"
    r1cs = r1cs_from_prog(prog)
    assert (r1cs.curve, r1cs.num_constraints, r1cs.num_variables) == ("bls12_381", 27459, 27281)

    with open(os.path.join(ROOT, "bench_artifacts", "sha256.abi.json")) as f:
        abi = json.load(f)
    p = FIELDS["bls12_381"].P
    preimage = list(range(16))
    wit = Interpreter().execute(prog, encode_inputs([[preimage]], abi["inputs"], p))
    assert r1cs.check(r1cs.full_assignment(wit), p)
    assert wit.return_values() == sha256_compress(preimage)
