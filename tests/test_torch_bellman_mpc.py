"""The port's bellman/phase2 ceremony artifacts
(zokrates_tpu_torch.interop.bellman_mpc) on the CPU against the JAX
package's (zokrates_tpu.interop.bellman_mpc), on the reference tests' cube
circuit (domain 8).

  * the point codecs are byte-equal on BN254 and BLS12-381 points and the
    point at infinity, and both refuse an infinity flag with a body;
  * generate_radix from the same rng writes the same phase1radix bytes
    (the port's tables by its fixed-base evaluator, G2 included), and the
    port reads them back;
  * initialize writes the same BellmanParameters bytes and cs_hash (the
    port's column sums through its batched ladder and accumulate_lm, in
    their plain versions here);
  * with secrets.token_bytes patched to the same bytes in both packages,
    a contribution and a beacon return the same hashes and the mpc.params
    files are byte-equal;
  * verify returns the same hashes under one seeded rng, and the port's
    rejects the reference tests' tamperings (a swapped delta_g1, a tripled
    h point, a zeroed cs_hash) and a PublicKey with another r_delta;
  * export_keypair's arrays and vk equal the JAX package's, but for the
    b2 query's absent entries: the port writes the dummy (i+1)*G2 there,
    which its prover's b correction assumes (as groth16.setup writes it),
    where the JAX package writes the G2 generator (chip_smoke.py proves
    with such a key on the card; a CPU prove takes 15-20 s).

The JAX package's fixed-base evaluator takes the Python-int oracle of
test_torch_mpc (its XLA compiles take tens of seconds on a CPU), and the
port's verify takes a Python-int oracle for groth16._msm_g1 (each of its
four random combinations is one MSM; the plain sorted MSM takes about 10 s
a call on a CPU and is held to the oracle in tests/test_torch_gm17.py).
Tolerance: exact equality throughout.
"""

import copy
import io
import random
import secrets

import numpy as np
import pytest
import torch

from zokrates_tpu.interop import bellman_mpc as jbm
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ec.curve import PointG1, g1_group, g2_group
from zokrates_tpu_torch.interop import bellman_mpc as tbm
from zokrates_tpu_torch.kernels.msm_sorted import pack_points_g2
from zokrates_tpu_torch.schemes import groth16 as tg

from test_groth16 import cube_prog
from test_torch_mpc import jax_fixed_base_oracle

CURVE = "bn128"
R = g1_group(CURVE).r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(obj):
    buf = io.BytesIO()
    obj.write(buf)
    return buf.getvalue()


def _msm_oracle(curve, points, scalars, device="cuda"):
    grp = g1_group(curve)
    acc = grp.zero()
    for pt, s in zip(points, scalars):
        if pt is not None:
            acc = acc + PointG1(grp, pt[0], pt[1]) * s
    return acc


@pytest.fixture(scope="module")
def circuit():
    prog = cube_prog()
    r1cs = r1cs_from_prog(prog)
    port_r1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness,
                             r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, port_r1cs


@pytest.fixture(scope="module")
def ceremony(circuit):
    """The radix, initialize, a contribution and a beacon in both
    packages (the secrets patched to one byte sequence), with the bytes of
    each stage."""
    r1cs, port_r1cs = circuit
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_fixed_base_oracle(mp)
        for name, mod, rr, kw in (("jax", jbm, r1cs, {}), ("port", tbm, port_r1cs, {"device": "cpu"})):
            draws = iter([random.Random(5).randrange(1, R) for _ in range(3)])
            radix = mod.generate_radix(CURVE, 8, rng=lambda: next(draws), **kw)
            mpc = mod.initialize(rr, radix, **kw)
            init_bytes = _bytes(mpc.params)
            secret = iter([bytes([9] * 32), bytes(range(1, 33))])
            mp.setattr(secrets, "token_bytes", lambda n: next(secret))
            hashes = [mod.contribute(mpc, entropy="alice", **kw), mod.beacon(mpc, "deadbeef", iterations=3, **kw)]
            out[name] = {"radix": radix, "radix_bytes": _bytes(radix), "init_bytes": init_bytes,
                         "init_hash": mpc.cs_hash, "mpc": mpc, "hashes": hashes, "mpc_bytes": _bytes(mpc)}
    return out


@pytest.mark.parametrize("curve", ["bn128", "bls12_381"])
def test_point_codecs_equal(curve):
    from zokrates_tpu.ec.curve import g1_group as j_g1_group, g2_group as j_g2_group

    ks = [random.Random(11).randrange(1, R) for _ in range(3)]
    pairs = [(g1_group(curve).generator() * k, j_g1_group(curve).generator() * k) for k in ks]
    pairs += [(None, None), (g1_group(curve).zero(), j_g1_group(curve).zero())]
    for pt, jpt in pairs:
        got = tbm.g1_to_bytes(curve, pt)
        assert got == jbm.g1_to_bytes(curve, jpt)
        assert tbm.g1_to_bytes(curve, tbm.g1_from_bytes(curve, got)) == got
    pairs = [(g2_group(curve).generator() * k, j_g2_group(curve).generator() * k) for k in ks[:2]] + [(None, None)]
    for pt, jpt in pairs:
        got = tbm.g2_to_bytes(curve, pt)
        assert got == jbm.g2_to_bytes(curve, jpt)
        assert tbm.g2_to_bytes(curve, tbm.g2_from_bytes(curve, got)) == got
    bad = bytearray(tbm.g1_to_bytes(curve, None))
    bad[5] = 1  # infinity flag with a nonzero body
    for mod in (tbm, jbm):
        with pytest.raises(ValueError):
            mod.g1_from_bytes(curve, bytes(bad))


def test_radix_equal(ceremony):
    got, want = ceremony["port"]["radix_bytes"], ceremony["jax"]["radix_bytes"]
    assert got == want
    buf = io.BytesIO(got)
    back = tbm.Phase1Radix.read(CURVE, buf, 8)
    assert buf.read() == b"" and _bytes(back) == got


def test_initialize_equal(ceremony):
    assert ceremony["port"]["init_bytes"] == ceremony["jax"]["init_bytes"]
    assert ceremony["port"]["init_hash"] == ceremony["jax"]["init_hash"]


def test_contributions_equal(ceremony):
    port, jax_ = ceremony["port"], ceremony["jax"]
    assert port["hashes"] == jax_["hashes"] and len(set(port["hashes"])) == 2
    assert port["mpc_bytes"] == jax_["mpc_bytes"]
    buf = io.BytesIO(jax_["mpc_bytes"])
    back = tbm.MPCParameters.read(CURVE, buf)
    assert buf.read() == b"" and _bytes(back) == jax_["mpc_bytes"]


def test_verify_same_hashes(ceremony, circuit, monkeypatch):
    monkeypatch.setattr(tg, "_msm_g1", _msm_oracle)
    rhos = [random.Random(13).randrange(R) for _ in range(64)]
    port, jax_ = ceremony["port"], ceremony["jax"]
    it = iter(rhos)
    got = tbm.verify(port["mpc"], circuit[1], port["radix"], rng=lambda: next(it), device="cpu")
    it = iter(rhos)
    want = jbm.verify(jax_["mpc"], circuit[0], jax_["radix"], rng=lambda: next(it))
    assert got == want == port["hashes"]


@pytest.fixture(scope="module")
def initial(ceremony, circuit):
    """The port's initialize on the ceremony's circuit and radix, once."""
    return tbm.initialize(circuit[1], ceremony["port"]["radix"], device="cpu")


@pytest.mark.parametrize("kind", ["delta", "h", "cs_hash", "r_delta"])
def test_verify_rejects_tampering(ceremony, circuit, initial, kind, monkeypatch):
    """The reference tests' three tamperings (each rejected by the JAX
    package's verify in tests/test_bellman_mpc.py) and a public key whose
    r_delta is another point. verify's own initialize gives `initial` (the
    same circuit and radix; test_verify_same_hashes runs it)."""
    monkeypatch.setattr(tg, "_msm_g1", _msm_oracle)
    monkeypatch.setattr(tbm, "initialize", lambda *a, **kw: copy.deepcopy(initial))
    port = ceremony["port"]
    mpc = copy.deepcopy(port["mpc"])
    if kind == "delta":
        mpc.params.delta_g1 = mpc.params.delta_g1 * 7
    elif kind == "h":
        mpc.params.h[0] = mpc.params.h[0] * 3
    elif kind == "cs_hash":
        mpc.cs_hash = b"\x00" * 64
    else:
        mpc.contributions[0].r_delta = mpc.contributions[0].r_delta * 2
    with pytest.raises(ValueError):
        tbm.verify(mpc, circuit[1], port["radix"], device="cpu")


def test_export_keypair_equal(ceremony, circuit):
    pk, vk = tbm.export_keypair(ceremony["port"]["mpc"], circuit[1], device="cpu")
    jpk, jvk = jbm.export_keypair(ceremony["jax"]["mpc"], circuit[0])
    for name in convert.PK_ARRAYS:
        got, want = getattr(pk, name), np.asarray(getattr(jpk, name))
        assert got.dtype == want.dtype, name
        if name == "b2_p128":
            real = pk.b2_mask
            np.testing.assert_array_equal(got[real], want[real], err_msg=name)
            assert (~real).any()
            # the absent entries hold (i+1) * G2, as groth16.setup writes them
            dx, dy, _ = tg._fb_g2(CURVE, [int(i) + 1 for i in np.flatnonzero(~real)], "cpu")
            rows = pack_points_g2(g1_group(CURVE).q, dx, dy).numpy().astype(np.uint32)
            np.testing.assert_array_equal(got[~real], rows)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert pk.h16_p128 is None
    assert vk.to_json() == jvk.to_json()
