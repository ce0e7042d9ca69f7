"""The port's keccak (zokrates_tpu_torch.utils.keccak) and KZG10
(zokrates_tpu_torch.schemes.kzg) on the CPU against the JAX package's.

  * keccak256 equals the reference's on seeded byte strings of lengths 0,
    1, 135, 136 (the rate), 137 and 300;
  * universal_setup at degree 16: the port evaluates the powers with the
    fixed-base evaluator, the reference with a Python scalar multiply per
    point; with the same rng the points, the hiding powers and [tau]G2 are
    equal;
  * commit through the port's own MSM (groth16._msm_g1, the sorted MSM's
    plain versions on the CPU) equals the reference's commitment, and an
    empty polynomial's commitment is the point at infinity;
  * commit_hiding, open_single, open_batch (hiding and not) and the
    verify_* checks equal the reference's, and a wrong value fails;
  * a polynomial above the SRS degree raises.

Both packages' _msm_g1 take a Python-int oracle MSM (sum of s_i * P_i)
except in test_commit_through_the_port_msm: the JAX CPU MSM compiles an XLA
Pippenger for minutes, and the port's plain sorted MSM costs about 10 s a
call on the CPU whatever the size (32 windows of 256 buckets). The port's
MSM is held against the oracle in test_torch_gm17.py and on the card by
chip_smoke.py. Tolerance: exact equality (integers, affine points).
"""

import random

import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.schemes import groth16 as jg16
from zokrates_tpu.schemes import kzg as jkzg
from zokrates_tpu.utils.keccak import keccak256 as jkeccak
from zokrates_tpu_torch.schemes import groth16 as tg16
from zokrates_tpu_torch.schemes import kzg as tkzg
from zokrates_tpu_torch.utils.keccak import keccak256 as tkeccak

CURVE = "bn128"
DEGREE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(g1_group, point_cls):
    def msm(curve, points, scalars, device=None):
        grp = g1_group(curve)
        acc = grp.zero()
        for pt, s in zip(points, scalars):
            if pt is not None and s % grp.r:
                acc = acc + point_cls(grp, pt[0], pt[1]) * (s % grp.r)
        return acc
    return msm


@pytest.fixture
def oracle_msms(monkeypatch):
    """Both packages' groth16._msm_g1 (which kzg imports at each call)
    replaced by the Python-int oracle."""
    from zokrates_tpu.ec.curve import PointG1 as JP1, g1_group as jg1
    from zokrates_tpu_torch.ec.curve import PointG1 as TP1, g1_group as tg1

    monkeypatch.setattr(jg16, "_msm_g1", _oracle(jg1, JP1))
    monkeypatch.setattr(tg16, "_msm_g1", _oracle(tg1, TP1))


def _seq_rng(seed):
    r = random.Random(seed)
    return lambda: r.randrange(1, 1 << 250)


def _xy(pt):
    return None if pt.x is None else (int(pt.x), int(pt.y))


def _g2(pt):
    return (pt.x.c0, pt.x.c1, pt.y.c0, pt.y.c1)


@pytest.fixture(scope="module")
def srs_pair():
    return (jkzg.universal_setup(CURVE, DEGREE, rng=_seq_rng(5)),
            tkzg.universal_setup(CURVE, DEGREE, rng=_seq_rng(5), device="cpu"))


def _poly(seed, n):
    rnd = random.Random(seed)
    r = JP.SCALAR_FIELDS[CURVE].p
    return [rnd.randrange(r) for _ in range(n)]


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 300])
def test_keccak256_matches_reference(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    assert tkeccak(data) == jkeccak(data)


def test_universal_setup_matches_reference(srs_pair):
    jsrs, tsrs = srs_pair
    assert tsrs.max_degree == jsrs.max_degree == DEGREE
    assert tsrs.powers_g1 == jsrs.powers_g1
    assert tsrs.gamma_powers_g1 == jsrs.gamma_powers_g1
    assert len(tsrs.gamma_powers_g1) == tkzg.HIDING_DEGREE + 2
    assert _g2(tsrs.h) == _g2(jsrs.h) and _g2(tsrs.tau_h) == _g2(jsrs.tau_h)


def test_commit_through_the_port_msm(srs_pair, monkeypatch):
    from zokrates_tpu.ec.curve import PointG1 as JP1, g1_group as jg1

    monkeypatch.setattr(jg16, "_msm_g1", _oracle(jg1, JP1))
    jsrs, tsrs = srs_pair
    coeffs = _poly(1, DEGREE + 1)
    coeffs[3] = 0
    assert _xy(tkzg.commit(tsrs, coeffs, device="cpu")) == _xy(jkzg.commit(jsrs, coeffs))
    assert tkzg.commit(tsrs, [0], device="cpu").x is None


def test_commit_hiding_matches_reference(srs_pair, oracle_msms):
    jsrs, tsrs = srs_pair
    blinder = _poly(2, tkzg.HIDING_DEGREE + 1)
    for coeffs in (_poly(3, 9), []):
        assert _xy(tkzg.commit_hiding(tsrs, coeffs, blinder, device="cpu")) == \
            _xy(jkzg.commit_hiding(jsrs, coeffs, blinder))


def test_open_single_matches_reference(srs_pair, oracle_msms):
    jsrs, tsrs = srs_pair
    coeffs, z = _poly(4, 12), 0x1234567
    v, w = tkzg.open_single(tsrs, coeffs, z, device="cpu")
    jv, jw = jkzg.open_single(jsrs, coeffs, z)
    assert (v, _xy(w)) == (jv, _xy(jw))
    c = tkzg.commit(tsrs, coeffs, device="cpu")
    assert tkzg.verify_single(tsrs, c, z, v, w)
    assert not tkzg.verify_single(tsrs, c, z, v + 1, w)


@pytest.mark.parametrize("hiding", [False, True])
def test_open_batch_matches_reference(srs_pair, oracle_msms, hiding):
    jsrs, tsrs = srs_pair
    polys = [_poly(10 + i, n) for i, n in enumerate((5, 17, 1, 9))]
    blinders = [_poly(20 + i, tkzg.HIDING_DEGREE + 1) if i % 2 == 0 else None for i in range(4)] \
        if hiding else None
    z, gamma = 0xABCDEF, 0x7777
    got = tkzg.open_batch(tsrs, polys, z, gamma, blinders=blinders, device="cpu")
    want = jkzg.open_batch(jsrs, polys, z, gamma, blinders=blinders)
    assert (got[0], _xy(got[1]), got[2]) == (want[0], _xy(want[1]), want[2])
    assert (got[2] != 0) == hiding
    comms = [tkzg.commit_hiding(tsrs, p, b, device="cpu") if b else tkzg.commit(tsrs, p, device="cpu")
             for p, b in zip(polys, blinders or [None] * 4)]
    assert tkzg.verify_batch(tsrs, comms, z, got[0], got[1], gamma, got[2])
    bad = list(got[0])
    bad[1] += 1
    assert not tkzg.verify_batch(tsrs, comms, z, bad, got[1], gamma, got[2])


def test_degree_bound(srs_pair):
    _, tsrs = srs_pair
    with pytest.raises(ValueError, match="exceeds SRS degree"):
        tkzg.commit(tsrs, [1] * (DEGREE + 2), device="cpu")
