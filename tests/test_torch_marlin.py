"""The port's Marlin (zokrates_tpu_torch.schemes.marlin) and the Domain's
host transforms on the CPU against the JAX package's.

  * Domain.fft_ints equals the JAX Domain's at n = 2^4 ... 2^10 over
    BN254's and BLS12-381's r (the port's NTT and emul plain versions on
    the CPU, the reference's XLA transform), ifft_ints inverts the JAX
    evaluations, and both refuse a length they cannot take; _pmul's transform path equals the reference's schoolbook
    product;
  * on the cube and mul_pub programs of test_groth16.py, with the same SRS
    rng: the port's SRS (fixed-base powers) equals the reference's, and
    setup_with_srs gives the same index (entries, row, col and val'
    polynomials, commitments) and the same vk JSON;
  * with the same prover rng the port's proof JSON equals the reference's
    byte for byte, and both packages' verify accept it;
  * a flipped evals_beta entry, a flipped t_beta and a wrong public input
    are rejected, and an SRS below the index's degree raises.

Both packages' groth16._msm_g1 (which kzg imports at each call) take a
Python-int oracle MSM: the JAX CPU MSM compiles an XLA Pippenger for
minutes, and the port's plain sorted MSM costs about 10 s a call on the CPU
whatever the size, against about 30 commitments a proof. The port's MSM is
held against the oracle in test_torch_kzg.py and test_torch_gm17.py, and
on the card by chip_smoke.py. The JAX reference runs once per module
(module-scoped fixtures). Tolerance: exact equality (integers, points,
JSON bytes).
"""

import json
import random

import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.kernels.ntt import domain_for_curve as jdomain
from zokrates_tpu.schemes import groth16 as jg16
from zokrates_tpu.schemes import marlin as jm
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.kernels.ntt import domain_for_curve as tdomain
from zokrates_tpu_torch.schemes import groth16 as tg16
from zokrates_tpu_torch.schemes import kzg as tkzg
from zokrates_tpu_torch.schemes import marlin as tm
from zokrates_tpu_torch.schemes.types import Proof as TProof

from test_groth16 import cube_prog, mul_pub_prog

CURVE = "bn128"
PROGS = {"cube": (cube_prog, [3], 1234567), "mul_pub": (mul_pub_prog, [7, 6], 99)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drng(seed):
    """The rng of tests/test_marlin.py: a 64-bit LCG."""
    state = [seed]

    def rand():
        state[0] = (state[0] * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return state[0] + 2

    return rand


def _oracle(g1_group, point_cls):
    def msm(curve, points, scalars, device=None):
        grp = g1_group(curve)
        acc = grp.zero()
        for pt, s in zip(points, scalars):
            if pt is not None and s % grp.r:
                acc = acc + point_cls(grp, pt[0], pt[1]) * (s % grp.r)
        return acc
    return msm


@pytest.fixture(scope="module")
def oracle_msms():
    from zokrates_tpu.ec.curve import PointG1 as JP1, g1_group as jg1
    from zokrates_tpu_torch.ec.curve import PointG1 as TP1, g1_group as tg1

    mp = pytest.MonkeyPatch()
    mp.setattr(jg16, "_msm_g1", _oracle(jg1, JP1))
    mp.setattr(tg16, "_msm_g1", _oracle(tg1, TP1))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def runs(oracle_msms):
    """Per program: both packages' SRS (degree 64), keys and one proof
    from the same rngs."""
    out = {}
    for name, (make, args, seed) in PROGS.items():
        prog = make()
        r1cs = r1cs_from_prog(prog)
        wit = Interpreter().execute(prog, args)
        tr1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
        jsrs = jm.universal_setup(CURVE, 64, rng=_drng(seed))
        tsrs = tm.universal_setup(CURVE, 64, rng=_drng(seed), device="cpu")
        jpk, jvk = jm.setup_with_srs(jsrs, r1cs)
        tpk, tvk = tm.setup_with_srs(tsrs, tr1cs, device="cpu")
        jproof = jm.prove(r1cs, jpk, wit, rng=_drng(seed + 1))
        tproof = tm.prove(tr1cs, tpk, TWitness(wit.values), rng=_drng(seed + 1), device="cpu")
        out[name] = dict(jsrs=jsrs, tsrs=tsrs, jpk=jpk, jvk=jvk, tpk=tpk, tvk=tvk, jproof=jproof, tproof=tproof,
                         tr1cs=tr1cs)
    return out


def _rand_ints(p, n, seed):
    rnd = random.Random(seed)
    return [rnd.randrange(p) for _ in range(n)]


@pytest.mark.parametrize("curve", ["bn128", "bls12_381"])
@pytest.mark.parametrize("k", range(4, 11))
def test_fft_ints_match_reference(curve, k):
    """fft_ints equals the JAX Domain's, and ifft_ints maps the JAX
    evaluations back to the coefficients (the inverse is unique, so this
    is the JAX ifft_ints' output too; its own XLA compile, about 5 s a
    size, is spared)."""
    n = 1 << k
    jd, td = jdomain(curve, n), tdomain(curve, n)
    coeffs = _rand_ints(td.p, n - 3, k)   # fft_ints pads to n
    assert td.omega == jd.omega
    evals = jd.fft_ints(coeffs)
    assert td.fft_ints(coeffs, device="cpu") == evals
    assert td.ifft_ints(evals, device="cpu") == coeffs + [0, 0, 0]


def test_fft_ints_refuse_lengths():
    td = tdomain(CURVE, 16)
    with pytest.raises(ValueError):
        td.fft_ints([1] * 17, device="cpu")
    with pytest.raises(ValueError):
        td.ifft_ints([1] * 15, device="cpu")


def test_pmul_transform_matches_schoolbook(monkeypatch):
    r = JP.SCALAR_FIELDS[CURVE].p
    a, b = _rand_ints(r, 300, 1), _rand_ints(r, 300, 2)
    got = tm._pmul(a, b, r, CURVE, device="cpu")  # 599 > _NTT_THRESHOLD: the transform path
    monkeypatch.setattr(jm, "_NTT_THRESHOLD", 1 << 20)
    assert got == jm._pmul(a, b, r, CURVE)


@pytest.mark.parametrize("name", list(PROGS))
def test_srs_and_index_match_reference(runs, name):
    run = runs[name]
    assert run["tsrs"].powers_g1 == run["jsrs"].powers_g1
    assert run["tsrs"].gamma_powers_g1 == run["jsrs"].gamma_powers_g1
    assert json.dumps(run["tvk"].to_json()) == json.dumps(run["jvk"].to_json())
    tpk, jpk = run["tpk"], run["jpk"]
    assert (tpk.n, tpk.k, tpk.num_instance) == (jpk.n, jpk.k, jpk.num_instance)
    assert tpk.index_comms == jpk.index_comms
    for m in ("a", "b", "c"):
        t, j = tpk.mats[m], jpk.mats[m]
        assert (t.entries, t.row, t.col, t.valp) == (j.entries, j.row, j.col, j.valp)


@pytest.mark.parametrize("name", list(PROGS))
def test_proof_json_matches_reference(runs, name):
    run = runs[name]
    assert json.dumps(run["tproof"].to_json()) == json.dumps(run["jproof"].to_json())
    assert tm.verify(run["tvk"], run["tproof"])
    assert jm.verify(run["jvk"], JProof.from_json(run["tproof"].to_json()))


def _flip(proof, *path):
    bad = TProof.from_json(json.loads(json.dumps(proof.to_json())))
    d = bad.points
    for key in path[:-1]:
        d = d[key]
    d[path[-1]] = "0x" + format(int(d[path[-1]], 16) ^ 1, "064x")
    return bad


def test_forgeries_rejected(runs):
    run = runs["cube"]
    assert not tm.verify(run["tvk"], _flip(run["tproof"], "evals_beta", "z_a"))
    assert not tm.verify(run["tvk"], _flip(run["tproof"], "t_beta"))
    pub = runs["mul_pub"]
    bad = TProof.from_json(json.loads(json.dumps(pub["tproof"].to_json())))
    bad.inputs[0] = "0x" + format(int(bad.inputs[0], 16) + 1, "064x")
    assert not tm.verify(pub["tvk"], bad)


def test_srs_too_small(runs):
    run = runs["cube"]
    srs = run["tsrs"]
    small = tkzg.SRS(CURVE, srs.powers_g1[:9], srs.h, srs.tau_h, srs.gamma_powers_g1)
    with pytest.raises(ValueError, match="universal SRS degree"):
        tm.setup_with_srs(small, run["tr1cs"], device="cpu")
