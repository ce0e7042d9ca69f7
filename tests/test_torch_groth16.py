"""The port's Groth16 (zokrates_tpu_torch.schemes.groth16) on the CPU against
the JAX package's (zokrates_tpu.schemes.groth16), on a toy circuit compiled
with zokrates_tpu.lang.

  * setup: with the same rng, the port's proving-key arrays are bit-equal
    to the JAX setup's, and the verification keys are equal;
  * prove: given the JAX proving key through convert.py and the same fixed
    r, s, the port's proof JSON equals the JAX proof JSON byte for byte,
    and the JAX verify accepts it (native host tail and Python tail);
  * prove_batch draws r, s per proof in turn, and its proofs equal the JAX
    proof and the port's prove() byte for byte;
  * the shared-bucket h query (groth16._h16_p128) holds 2^(16w) * h_j in
    row w*Nh + j (sampled rows against the Python-int oracle), and
    convert.proving_key carries it;
  * the h stage equals groth16.compute_h;
  * the port's readers and witness limbs equal the JAX package's.

The JAX reference runs once per module (module-scoped fixtures): its
setup and its CPU prove (whose G2 Pippenger compile dominates this file's
time) are shared by every test. Tolerance: exact equality throughout
(integers, limb arrays, JSON bytes).
"""

import io
import json
import random

import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.fields.field import FIELDS as J_FIELDS
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.lang.compile import compile_source
from zokrates_tpu.schemes import groth16 as jg
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.fields.field import FIELDS as T_FIELDS
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.schemes import groth16 as tg
from zokrates_tpu_torch.schemes.types import Proof as TProof

CURVE = "bn128"
P = JP.SCALAR_FIELDS[CURVE].p
SRC = (
    "def main(private field x0, field y) -> field {\n"
    "    field mut x = x0;\n"
    "    for u32 i in 0..20 { x = x * x + y; }\n"
    "    return x;\n"
    "}"
)
RS = (0x1234567890ABCDEF, P - 12345)  # the prover's fixed r, s


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_rng(seed):
    """The five toxic-waste draws, fixed by a seed, as an rng() callable."""
    draws = iter([random.Random(seed).randrange(1, P) for _ in range(5)])
    return lambda: next(draws)


def _fixed(values):
    it = iter(values)
    return lambda: next(it)


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
    r1cs = circuit[0]
    return jg.setup(r1cs, rng=_seq_rng(1))


@pytest.fixture(scope="module")
def port_keys(circuit):
    """The port's own setup, from the same toxic waste as jax_keys."""
    return tg.setup(circuit[2], rng=_seq_rng(1), device="cpu")


@pytest.fixture(scope="module")
def port_pk(jax_keys):
    pk, _ = jax_keys
    points = {k: (getattr(pk, k).x, getattr(pk, k).y) for k in convert.PK_G1}
    for k in convert.PK_G2:
        pt = getattr(pk, k)
        points[k] = ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1))
    arrays = {k: np.asarray(getattr(pk, k)) for k in convert.PK_ARRAYS}
    return convert.proving_key(CURVE, pk.domain_size, pk.num_instance, points, arrays)


@pytest.fixture(scope="module")
def jax_proof(circuit, jax_keys):
    r1cs, wit, _, _ = circuit
    return jg.prove(r1cs, jax_keys[0], wit, rng=_fixed(RS))


def test_setup_matches_reference(jax_keys, port_keys):
    jpk, jvk = jax_keys
    pk, vk = port_keys
    for name in convert.PK_ARRAYS:
        want = np.asarray(getattr(jpk, name))
        got = getattr(pk, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in convert.PK_G1 + convert.PK_G2:
        got, want = getattr(pk, name), getattr(jpk, name)
        assert (str(got.x), str(got.y)) == (str(want.x), str(want.y)), name
    assert (pk.domain_size, pk.num_instance) == (jpk.domain_size, jpk.num_instance)
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())


@pytest.mark.parametrize("tail", ["native", "python"])
def test_prove_matches_reference(circuit, jax_keys, port_pk, jax_proof, tail, monkeypatch):
    _, _, port_r1cs, port_wit = circuit
    if tail == "python":
        monkeypatch.setattr(tg, "_native_pair", lambda curve: (None, None))
    proof = tg.prove(port_r1cs, port_pk, port_wit, rng=_fixed(RS), device="cpu")
    assert json.dumps(proof.to_json()) == json.dumps(jax_proof.to_json())
    from zokrates_tpu.schemes.types import Proof as JProof

    assert jg.verify(jax_keys[1], JProof.from_json(proof.to_json()))


@pytest.fixture(scope="module")
def witness2():
    """A second witness of the same circuit (x0 = 5)."""
    prog = compile_source(SRC, curve=CURVE).prog
    return TWitness(Interpreter().execute(prog, [5, 7]).values)


def test_prove_batch_matches_prove(circuit, jax_keys, port_pk, jax_proof, witness2):
    """A batch of two distinct witnesses, r and s drawn in turn (5, 6, then
    RS): proof 1 equals the JAX proof of the same witness and r, s byte for
    byte (and so the port's prove(), test_prove_matches_reference), and
    proof 0 verifies."""
    _, _, port_r1cs, port_wit = circuit
    proofs = tg.prove_batch(port_r1cs, port_pk, [witness2, port_wit], rng=_fixed((5, 6) + RS), device="cpu")
    assert json.dumps(proofs[1].to_json()) == json.dumps(jax_proof.to_json())
    assert proofs[0].inputs != proofs[1].inputs
    from zokrates_tpu.schemes.types import Proof as JProof

    assert jg.verify(jax_keys[1], JProof.from_json(proofs[0].to_json()))


def test_h16_rows_match_oracle(port_keys, jax_keys):
    """Rows w*Nh + j of the shared-bucket h query hold 2^(16w) * h_j (the
    Python-int oracle, zokrates_tpu.ec), the rows past the h query the
    packed point at infinity of a zero scalar; convert carries the array."""
    from zokrates_tpu.ec.curve import PointG1 as JPointG1, g1_group as j_g1_group

    pk = port_keys[0]
    grp = j_g1_group(CURVE)
    q = grp.q
    k, Nh = pk.h_p128.shape[0], 64
    h16 = tg._h16_p128(CURVE, pk.h_p128, Nh, "cpu")
    Wc = 16
    assert h16.shape == (Wc * Nh, 128) and h16.dtype == np.uint32
    rinv = pow(1 << 256, -1, q)

    def coord(row, i):
        return sum(int(v) << (16 * t) for t, v in enumerate(row[16 * i : 16 * (i + 1)])) * rinv % q

    rng = random.Random(4)
    for w, j in [(0, 0), (1, 0), (Wc - 1, k - 1)] + [(rng.randrange(Wc), rng.randrange(k)) for _ in range(5)]:
        h = JPointG1(grp, coord(pk.h_p128[j], 0), coord(pk.h_p128[j], 1))
        want = h * pow(2, 16 * w, grp.r)
        row = h16[w * Nh + j]
        assert (coord(row, 0), coord(row, 1), coord(row, 2)) == (want.x, want.y, (-want).y), (w, j)
    zero_row, _ = tg._fb_g1(CURVE, [0], "cpu")
    for w in (0, Wc - 1):
        np.testing.assert_array_equal(h16[w * Nh + k : (w + 1) * Nh], np.broadcast_to(zero_row, (Nh - k, 128)))

    jpk = jax_keys[0]
    points = {name: (getattr(jpk, name).x, getattr(jpk, name).y) for name in convert.PK_G1}
    for name in convert.PK_G2:
        pt = getattr(jpk, name)
        points[name] = ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1))
    arrays = {name: np.asarray(getattr(jpk, name)) for name in convert.PK_ARRAYS}
    assert convert.proving_key(CURVE, jpk.domain_size, jpk.num_instance, points, arrays).h16_p128 is None
    arrays["h16_p128"] = h16
    carried = convert.proving_key(CURVE, jpk.domain_size, jpk.num_instance, points, arrays)
    np.testing.assert_array_equal(carried.h16_p128, h16)


def test_port_verify(circuit, jax_keys, jax_proof):
    """The port's verify accepts the JAX proof and rejects a forged one."""
    from zokrates_tpu_torch.schemes.types import VerificationKey as TVK

    vk = TVK.from_json(jax_keys[1].to_json())
    good = TProof.from_json(jax_proof.to_json())
    assert tg.verify(vk, good)
    forged = TProof.from_json(jax_proof.to_json())
    forged.points["a"], forged.points["c"] = forged.points["c"], forged.points["a"]
    assert not tg.verify(vk, forged)
    wrong_input = TProof.from_json(jax_proof.to_json())
    wrong_input.inputs = ["0x" + "0" * 63 + "8"]
    assert not tg.verify(vk, wrong_input)


def test_port_setup_prove_verify(circuit, port_keys):
    """The port alone: its own keys, two proofs with distinct r, s, both
    verify with its own verify."""
    _, _, port_r1cs, port_wit = circuit
    pk, vk = port_keys
    p1 = tg.prove(port_r1cs, pk, port_wit, rng=_fixed((5, 6)), device="cpu")
    p2 = tg.prove(port_r1cs, pk, port_wit, rng=_fixed((7, 8)), device="cpu")
    assert p1.points != p2.points and p1.inputs == p2.inputs
    assert tg.verify(vk, p1) and tg.verify(vk, p2)


def test_h_stage_matches_reference(circuit, jax_keys):
    r1cs, wit, port_r1cs, port_wit = circuit
    n = jax_keys[0].domain_size
    z = r1cs.full_assignment(wit)
    assert tg.compute_h(port_r1cs, port_r1cs.full_assignment(port_wit), n, device="cpu") == \
        jg.compute_h(r1cs, z, n)


def test_witness_readers_and_limbs(circuit):
    """The binary witness round-trips through both packages' readers to the
    same values, and the port's limb fast path (numpy sidecar) equals the
    JAX package's."""
    r1cs, wit, port_r1cs, _ = circuit
    buf = io.BytesIO()
    wit.write(buf, J_FIELDS[CURVE])
    from zokrates_tpu.ir.witness import Witness as JWitness

    jw = JWitness.read(io.BytesIO(buf.getvalue()), J_FIELDS[CURVE])
    tw = TWitness.read(io.BytesIO(buf.getvalue()), T_FIELDS[CURVE])
    assert tw.values == jw.values == wit.values
    assert tw._arr_vals is not None
    want = jg._witness_limbs(r1cs, jw, P, 16)
    np.testing.assert_array_equal(tg._witness_limbs(port_r1cs, tw, P, 16), want)
    np.testing.assert_array_equal(tg._witness_limbs(port_r1cs, TWitness(wit.values), P, 16), want)


def test_program_serialization_roundtrip():
    """A compiled program serialized by the JAX package deserializes in the
    port to the same constraint system."""
    from zokrates_tpu.ir.serialize import serialize
    from zokrates_tpu_torch.ir.r1cs import r1cs_from_prog as t_r1cs_from_prog
    from zokrates_tpu_torch.ir.serialize import deserialize

    prog = compile_source(SRC, curve=CURVE).prog
    want = r1cs_from_prog(prog)
    got = t_r1cs_from_prog(deserialize(serialize(prog)))
    assert (got.A, got.B, got.C) == (want.A, want.B, want.C)
    assert (got.num_instance, got.num_witness, got.ir_to_dense) == \
        (want.num_instance, want.num_witness, want.ir_to_dense)


def test_split_helpers_match_reference():
    """The host window split picks the same (w0, w1, Ks, hw0, hw1)."""
    from zokrates_tpu.kernels.msm_sorted import default_config as j_default
    from zokrates_tpu_torch.kernels.msm_sorted import default_config

    rng = np.random.default_rng(3)
    for N, dense_frac in ((1 << 15, 0.02), (1 << 15, 0.3), (1 << 12, 0.5)):
        m = N - 7
        z = np.zeros((m, 16), np.uint32)
        z[:, 0] = rng.integers(0, 2, m)
        wide = rng.random(m) < dense_frac
        z[wide] = rng.integers(0, 1 << 16, (int(wide.sum()), 16)).astype(np.uint32)
        z[:, 15] &= 0x0FFF  # below the field modulus
        cfg, jcfg = default_config(N), j_default(N)
        W = 32
        nnz = tg._window_nnz_batch([z], W, cfg.c)
        assert nnz == jg._window_nnz(z, W, jcfg.c)
        for native in (True, False):
            assert tg._split_with_host(nnz, W, cfg, N, native) == jg._split_with_host(nnz, W, jcfg, N, native)
