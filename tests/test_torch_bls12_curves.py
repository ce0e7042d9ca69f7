"""The port on BLS12-377 and on BW6-761, and GM17 on BLS12-381, on the CPU
(the kernel wrappers run their plain versions).

  * a bls12_377 Groth16 proof of the reference's cube program
    (tests/test_groth16.py) verifies, by the port's verify and by the JAX
    package's: Fq2 with u^2 = -5, G2 rows of 144 words;
  * a GM17 bls12_381 proof of the same program verifies: its G2 MSM, which
    needs the wide rows, runs the port's sorted MSM; its G1 MSMs run over a
    Python-int oracle (they share the walks with Groth16's, held in
    test_torch_bls12.py);
  * _msm_g1 on BW6-761 (packed rows of 144 words) at N = 16 against the
    oracle; the MSM kernels' CUDA wrappers take its 48-limb width (24
    32-bit limbs) and refuse another (64 16-bit limbs), naming the widths
    they take.

Tolerance: exact equality (points).
"""

import random

import pytest
import torch
from test_groth16 import cube_prog
from test_torch_bls12 import R381, _fixed, _oracle_packed_g1, _seq_rng

from zokrates_tpu.ec.curve import g1_group as jg1
from zokrates_tpu.fields import params as JP
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import groth16 as jg
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu.schemes.types import VerificationKey as JVerificationKey
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.kernels import cuda
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.schemes import gm17 as tgm
from zokrates_tpu_torch.schemes import groth16 as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cube(curve):
    """(port r1cs, port witness of x = 3) of the cube program over curve."""
    prog = cube_prog(curve)
    r1cs = r1cs_from_prog(prog)
    port_r1cs = convert.r1cs(curve, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return port_r1cs, TWitness(Interpreter().execute(prog, [3]).values)


def test_bls12_377_proof_verifies():
    """The port's setup, prove and verify on the cube program over
    bls12_377 (Fq2 with u^2 = -5, G2 rows of 144 words); the JAX package's
    verify accepts the proof too."""
    curve = "bls12_377"
    port_r1cs, wit = _cube(curve)
    pk, vk = tg.setup(port_r1cs, rng=_seq_rng(JP.SCALAR_FIELDS[curve].p, 2), device="cpu")
    assert pk.b2_p128 is None and pk.b2_rows().shape[1] == 144
    proof = tg.prove(port_r1cs, pk, wit, rng=_fixed((11, 13)), device="cpu")
    assert tg.verify(vk, proof)
    assert jg.verify(JVerificationKey.from_json(vk.to_json()), JProof.from_json(proof.to_json()))


def test_gm17_bls12_381_proof_verifies(monkeypatch):
    """GM17 on the cube program over bls12_381: the G2 MSM through the
    port's sorted MSM over wide rows, the G1 MSMs over a Python-int oracle."""
    r1cs, wit = _cube("bls12_381")

    def oracle(curve, P128, S, mask=None):
        from zokrates_tpu_torch.ec.curve import PointG1, g1_group

        pt = _oracle_packed_g1(curve, P128, S, mask)
        return g1_group(curve).zero() if pt.infinity else PointG1(g1_group(curve), pt.x, pt.y)

    monkeypatch.setattr(tgm, "_msm_packed_g1", oracle)
    pk, vk = tgm.setup(r1cs, rng=_seq_rng(R381, 3, 4), device="cpu")
    proof = tgm.prove(r1cs, pk, wit, rng=_fixed((17,)), device="cpu")
    assert tgm.verify(vk, proof)


def test_msm_g1_on_bw6_761():
    """_msm_g1 on BW6-761 (48-limb Fq, packed rows of 144 words) at N = 16
    through the plain sorted MSM, against the oracle; the MSM kernels'
    wrappers take the 48-limb width (24 32-bit limbs: p, R mod p and
    -p^-1 mod 2^32 handed over) and refuse a 1024-bit field (64 16-bit
    limbs), naming the widths they take."""
    curve = "bw6_761"
    grp = jg1(curve)
    rng = random.Random(9)
    ks = [rng.randrange(1, grp.r) for _ in range(10)]
    sc = [rng.randrange(grp.r) for _ in range(10)]
    sc[3] = 0
    pts = [grp.generator() * k for k in ks]
    want = grp.generator() * (sum(k * s for k, s in zip(ks, sc)) % grp.r)
    got = tg._msm_g1(curve, [(pt.x, pt.y) for pt in pts], sc, device="cpu")
    assert (got.x, got.y) == (want.x, want.y)
    q = grp.q
    assert ms.pack_points(q, field_ops(q).encode([1]), field_ops(q).encode([2])).shape == (1, 144)
    n, pl, one, n0, _ = cuda.field_params(q, None)
    assert n == 24 and sum(int(v) << (32 * i) for i, v in enumerate(pl)) == q
    assert sum(int(v) << (32 * i) for i, v in enumerate(one)) == (1 << 768) % q and (n0 * q) % (1 << 32) == (1 << 32) - 1
    with pytest.raises(ValueError, match="16 or 24 or 48 16-bit limbs, got nl=64"):
        cuda.field_params((1 << 1024) - 105, None)
