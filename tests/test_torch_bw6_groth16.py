"""Groth16 over BW6-761 on the CPU, against the JAX package: the
reference's cube program (tests/test_groth16.py) over bw6_761, whose G2 lies
over its 761-bit base field (y^2 = x^3 + 4 over Fq).

  * setup with the same rng: the port's key arrays equal the JAX package's
    array for array (b2_p128 None; b2_x / b2_y, (m, 48) coordinates over
    Fq, equal), its points and its verification key JSON too; the JAX
    package's fixed-base evaluator is replaced by Python-int scalar
    multiplies of the generators in its own output formats (its XLA
    compiles at 48 limbs would take minutes), the G1 rows packed in the
    reference's layout [x | y | -y] of Montgomery limbs by the JAX
    package's field encoder: its pack_points lays rows out in 128 words and
    refuses the 144 that 48-limb coordinates take;
  * prove at fixed r, s: the port's proof JSON equals the JAX package's
    byte for byte, the JAX prove's MSMs replaced by a Python-int oracle,
    and its fixed-base tail multiply _fb_mul_g1 by a Python-int scalar
    multiply: its comb table covers 256-bit scalars (64 windows of 4
    bits), and BW6-761's r has 377, so its C is wrong there;
    the port's MSMs run its plain sorted MSM in a small configuration (c =
    2, 8 walk lanes: at 48 limbs the default c = 8 configuration's plain
    suffix takes about 50 s an MSM on one CPU thread), so the b2 MSM runs
    the Fq walks over G1-style rows of 144 words and the host tail
    combines G2 over Fq;
  * the proof verifies through the port's BW6-761 pairing and the JAX
    package's; a proof with C swapped for A fails.

Tolerance: exact equality (arrays, points, JSON bytes).
"""

import json
import random

import numpy as np
import pytest
import torch
from test_groth16 import cube_prog
from test_torch_bls12 import _fixed, _oracle_packed_g1, _seq_rng

from zokrates_tpu.ec.curve import g1_group as jg1
from zokrates_tpu.ec.curve import g2_group as jg2
from zokrates_tpu.fields import params as JP
from zokrates_tpu.fields.jfield import field_ops as jfield_ops
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import groth16 as jg
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.schemes import groth16 as tg
from zokrates_tpu_torch.schemes.types import Proof as TProof

CURVE = "bw6_761"
R = JP.SCALAR_FIELDS[CURVE].p
RS = (0x1234567890ABCDEF, R - 12345)  # the prover's fixed r, s


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fixed_base_oracle(mp):
    """The JAX package's fixed-base evaluator as Python-int scalar
    multiplies of the generators, in its output formats: packed rows
    [x | y | -y] (144 words of Montgomery limbs) and mask (_fb_g1), host
    points (_fb_g1_points), and G2's Montgomery coordinates over Fq, (n,
    nl) each, with the mask (_fb_g2)."""
    def points(curve, scalars):
        g = jg1(curve).generator()
        return [None if pt.infinity else pt for pt in (g * s for s in scalars)]

    def fb_g1(curve, scalars):
        q = JP.BASE_FIELDS[curve].p
        f = jfield_ops(q)
        pts = points(curve, scalars)
        xs = [0 if pt is None else pt.x for pt in pts]
        ys = [0 if pt is None else pt.y for pt in pts]
        rows = np.concatenate([np.asarray(f.encode(v)) for v in (xs, ys, [(q - y) % q for y in ys])], 1)
        return rows.astype(np.uint32), np.asarray([pt is not None for pt in pts])

    def fb_g2(curve, scalars):
        pts = [jg2(curve).generator() * s for s in scalars]
        f = jfield_ops(JP.BASE_FIELDS[curve].p)

        def coord(get):
            return np.asarray(f.encode([0 if pt.infinity else get(pt) for pt in pts])).reshape(len(pts), -1)

        return coord(lambda pt: pt.x), coord(lambda pt: pt.y), np.asarray([not pt.infinity for pt in pts])

    mp.setattr(jg, "_fb_g1", fb_g1)
    mp.setattr(jg, "_fb_g1_points", points)
    mp.setattr(jg, "_fb_g2", fb_g2)


def _oracle_dev_g2_over_fq(curve, Px, Py, S, mask=None):
    """Python-int MSM over G2 coordinates in Fq, (N, nl) Montgomery limbs,
    and scalar limbs."""
    grp = jg2(curve)
    nl = -(-grp.q.bit_length() // 16)
    rinv = pow(1 << (16 * nl), -1, grp.q)

    def ints(a):
        return [sum(int(v) << (16 * i) for i, v in enumerate(row)) * rinv % grp.q for row in np.asarray(a)]

    xs, ys, S = ints(Px), ints(Py), np.asarray(S)
    acc = grp.zero()
    for j in range(S.shape[0]):
        if mask is not None and not bool(np.asarray(mask)[j]):
            continue
        s = sum(int(v) << (16 * i) for i, v in enumerate(S[j])) % grp.r
        if s:
            acc = acc + grp.point(xs[j], ys[j]) * s
    return acc


@pytest.fixture(scope="module")
def cube():
    prog = cube_prog(CURVE)
    r1cs = r1cs_from_prog(prog)
    wit = Interpreter().execute(prog, [3])
    port_r1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, wit, port_r1cs, TWitness(wit.values)


@pytest.fixture(scope="module")
def jax_keys(cube):
    with pytest.MonkeyPatch.context() as mp:
        _jax_fixed_base_oracle(mp)
        return jg.setup(cube[0], rng=_seq_rng(R, 5))


@pytest.fixture(scope="module")
def port_keys(cube):
    return tg.setup(cube[2], rng=_seq_rng(R, 5), device="cpu")


@pytest.fixture(scope="module")
def jax_proof(cube, jax_keys):
    r1cs, wit = cube[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "_msm_packed_g1", _oracle_packed_g1)
        mp.setattr(jg, "_msm_dev_g2", _oracle_dev_g2_over_fq)
        mp.setattr(jg, "_fb_mul_g1", lambda pt, k: pt * int(k))
        return jg.prove(r1cs, jax_keys[0], wit, rng=_fixed(RS))


@pytest.fixture(scope="module")
def port_proof(cube, port_keys):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ms, "default_config", lambda n: ms.MSMConfig(c=2, M1=8, R=2, lw2=2))
        return tg.prove(cube[2], port_keys[0], cube[3], rng=_fixed(RS), device="cpu")


def test_setup_matches_reference(jax_keys, port_keys):
    jpk, jvk = jax_keys
    pk, vk = port_keys
    assert pk.b2_p128 is None and jpk.b2_p128 is None
    for name in convert.PK_ARRAYS:
        if name == "b2_p128":
            continue
        want = np.asarray(getattr(jpk, name))
        got = getattr(pk, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("b2_x", "b2_y"):
        assert getattr(pk, name).shape == (pk.a_p128.shape[0], 48)
        np.testing.assert_array_equal(getattr(pk, name), getattr(jpk, name), err_msg=name)
    for name in convert.PK_G1 + convert.PK_G2:
        got, want = getattr(pk, name), getattr(jpk, name)
        assert (got.x, got.y) == (want.x, want.y), name
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())
    assert pk.b2_rows().shape == (pk.b2_x.shape[0], 144)


def test_prove_matches_reference(jax_keys, jax_proof, port_proof):
    assert json.dumps(port_proof.to_json()) == json.dumps(jax_proof.to_json())
    assert jg.verify(jax_keys[1], JProof.from_json(port_proof.to_json()))


@pytest.mark.parametrize("case", ["valid", "c_swapped"])
def test_verify(port_keys, port_proof, case):
    proof = TProof.from_json(json.loads(json.dumps(port_proof.to_json())))
    if case == "c_swapped":
        proof.points["c"] = proof.points["a"]
    assert tg.verify(port_keys[1], proof) == (case == "valid")
