"""The port's Groth16 phase-2 ceremony (zokrates_tpu_torch.schemes.mpc) on
the CPU against the JAX package's (zokrates_tpu.schemes.mpc), on the
reference tests' cube circuit (y == x^3 + x + 5).

  * init from the same setup rng: the proving-key arrays and the initial
    h / l queries equal, array for array;
  * with secrets.token_bytes patched to the same bytes in both packages,
    a contribution and a beacon give the same h and l queries (the port
    scales them in one batched ladder, kernels/ladder.scale_affine, over
    the plain mixed_add_lm here), the same correction weights, deltas,
    transcripts and vk; the setters drop h16_p128 and the device copies,
    and pack on the device of the key's copies (the card where it has
    none);
  * verify agrees on the honest chain, and the port's rejects the
    reference tests' two tamperings (a swapped delta_g1, a tripled h
    point);
  * the exported key proves in the port, and the JAX verify accepts.

The ceremony runs once per package (module-scoped fixtures). The JAX
package's ceremony is host Python. Its setup evaluates the key's points
with its XLA fixed-base evaluator, whose CPU compiles take 35-85 s; here
that evaluator (groth16._fb_g1, _fb_g1_points, _fb_g2) is replaced by a
Python-int oracle giving the same arrays (jax_fixed_base_oracle), so the
JAX setup's QAP evaluation, dummies and packing still run. Tolerance:
exact equality throughout.
"""

import copy
import json
import random
import secrets

import numpy as np
import pytest
import torch

from zokrates_tpu.ec.curve import g1_group as j_g1_group
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import groth16 as jg, mpc as jmpc
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ec.curve import PointG1, g1_group
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.schemes import groth16 as tg, mpc as tmpc

from test_groth16 import cube_prog

CURVE = "bn128"
R = j_g1_group(CURVE).r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_rng(seed):
    draws = iter([random.Random(seed).randrange(1, R) for _ in range(5)])
    return lambda: next(draws)


def jax_fixed_base_oracle(mp):
    """Patch the JAX package's fixed-base evaluator with Python-int scalar
    multiplies of the generators, in the same output formats: packed rows
    and mask (_fb_g1, through its _pack_query), host points
    (_fb_g1_points), Montgomery (n, 2, nl) coordinates and mask (_fb_g2)."""
    from zokrates_tpu.ec.curve import g2_group as j_g2_group
    from zokrates_tpu.fields import params as JP
    from zokrates_tpu.fields.jfield import field_ops as j_field_ops

    def points(curve, scalars):
        g = j_g1_group(curve).generator()
        pts = [g * s for s in scalars]
        return [None if pt.infinity else pt for pt in pts]

    def fb_g1(curve, scalars):
        return jg._pack_query(curve, [None if pt is None else (pt.x, pt.y) for pt in points(curve, scalars)])

    def fb_g2(curve, scalars):
        g = j_g2_group(curve).generator()
        pts = [g * s for s in scalars]
        f = j_field_ops(JP.BASE_FIELDS[curve].p)

        def coord(get):
            ints = [v for pt in pts for v in ((0, 0) if pt.infinity else (get(pt).c0, get(pt).c1))]
            return np.asarray(f.encode(ints)).reshape(len(pts), 2, -1)

        mask = np.asarray([not pt.infinity for pt in pts])
        return coord(lambda pt: pt.x), coord(lambda pt: pt.y), mask

    mp.setattr(jg, "_fb_g1", fb_g1)
    mp.setattr(jg, "_fb_g1_points", points)
    mp.setattr(jg, "_fb_g2", fb_g2)


def _arrays(pk):
    return {k: np.array(getattr(pk, k), copy=True) for k in convert.PK_ARRAYS}


@pytest.fixture(scope="module")
def circuit():
    prog = cube_prog()
    r1cs = r1cs_from_prog(prog)
    wit = Interpreter().execute(prog, [3])
    port_r1cs = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness,
                             r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, wit, port_r1cs, TWitness(wit.values)


@pytest.fixture(scope="module")
def ceremony(circuit):
    """init, a contribution and a beacon in both packages, the secrets
    patched to one byte sequence; the keys after init kept apart."""
    r1cs, _, port_r1cs, _ = circuit
    hashes = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_fixed_base_oracle(mp)
        jp = jmpc.init(r1cs, rng=_seq_rng(3))
        tp = tmpc.init(port_r1cs, rng=_seq_rng(3), device="cpu")
        initial = {"jax": (_arrays(jp.pk), jp.initial_h, jp.initial_l),
                   "port": (_arrays(tp.pk), tp.initial_h, tp.initial_l, tp.pk.h16_p128)}
        for name, mod, params, kw in (("jax", jmpc, jp, {}), ("port", tmpc, tp, {"device": "cpu"})):
            draws = iter([bytes([7] * 32), bytes(range(32))])
            mp.setattr(secrets, "token_bytes", lambda n: next(draws))
            hashes[name] = [mod.contribute(params, "alice", **kw),
                            mod.beacon(params, "deadbeef", iterations=3, **kw)]
    return jp, tp, initial, hashes


def test_init_keys_equal(ceremony):
    _, _, initial, _ = ceremony
    jarr, jh, jl = initial["jax"]
    tarr, th, tl, h16 = initial["port"]
    for name in convert.PK_ARRAYS:
        assert tarr[name].dtype == jarr[name].dtype, name
        np.testing.assert_array_equal(tarr[name], jarr[name], err_msg=name)
    assert th == jh and tl == jl
    assert h16 is None  # setup on the CPU builds no shifted copies


def test_contributions_equal(ceremony):
    jp, tp, _, hashes = ceremony
    assert hashes["port"] == hashes["jax"]
    assert len(set(hashes["port"])) == 2
    for name in convert.PK_ARRAYS:
        np.testing.assert_array_equal(getattr(tp.pk, name), np.asarray(getattr(jp.pk, name)), err_msg=name)
    assert tp.pk.h_query == jp.pk.h_query and tp.pk.l_query == jp.pk.l_query
    assert tp.pk.h_query != tp.initial_h  # the queries were scaled
    for name in ("delta_g1", "delta_g2"):
        got, want = getattr(tp.pk, name), getattr(jp.pk, name)
        assert (str(got.x), str(got.y)) == (str(want.x), str(want.y)), name
    assert [c.transcript for c in tp.contributions] == [c.transcript for c in jp.contributions]
    for c, d in zip(tp.contributions, jp.contributions):
        assert (c.pk_s_g1.x, c.pk_s_g1.y) == (d.pk_s_g1.x, d.pk_s_g1.y)
        assert str(c.pk_s_g2.x) == str(d.pk_s_g2.x) and str(c.pk_s_g2.y) == str(d.pk_s_g2.y)
    assert json.dumps(tp.vk_data) == json.dumps(jp.vk_data)
    assert tp.pk.h16_p128 is None and tp.pk._dev == {}


def _tamper(params, kind, point_cls, grp):
    params = copy.deepcopy(params)
    if kind == "delta":  # a delta swap without updating the queries
        params.pk.delta_g1 = params.pk.delta_g1 * 7
    elif kind == "query":
        hq = params.pk.h_query
        bad = point_cls(grp, *hq[0]) * 3
        hq[0] = (bad.x, bad.y)
        params.pk.set_h_query(hq, device="cpu")
    return params


def test_query_setters_follow_the_key(ceremony, monkeypatch):
    """The h_query / l_query setters (the reference's API, which names no
    device) encode and pack on the device of the key's cached copies, and
    on the card where there are none; the rows they write are the ones
    read."""
    pk = copy.deepcopy(ceremony[1].pk)
    seen = []
    pack = tg._pack_query

    def spy(curve, pts, device="cuda"):
        seen.append(str(device))
        return pack(curve, pts, "cpu")

    monkeypatch.setattr(tg, "_pack_query", spy)
    hq, lq = pk.h_query, pk.l_query
    pk.h_query = hq  # no cached copies
    m = pk.corr_w.shape[1]
    pk.dev("cpu", max(m, pk.h_p128.shape[0]), m)
    pk.h_query = hq
    pk.dev("cpu", max(m, pk.h_p128.shape[0]), m)
    pk.l_query = lq  # its dummies from the fixed-base evaluator on the CPU
    assert seen == ["cuda", "cpu", "cpu"]
    for name in ("h_p128", "l_p128", "l_mask", "corr_w"):
        np.testing.assert_array_equal(getattr(pk, name), getattr(ceremony[1].pk, name), err_msg=name)


def test_verify_agrees(ceremony, circuit):
    jp, tp, _, _ = ceremony
    assert tmpc.verify(tp, circuit[2]) and jmpc.verify(jp, circuit[0])


@pytest.mark.parametrize("kind", ["delta", "query"])
def test_verify_rejects_tampering(ceremony, circuit, kind):
    """The reference tests' tamperings (each rejected by the JAX package's
    verify in tests/test_mpc.py)."""
    assert not tmpc.verify(_tamper(ceremony[1], kind, PointG1, g1_group(CURVE)), circuit[2])


def test_exported_key_proves(ceremony, circuit):
    _, tp, _, _ = ceremony
    jr1cs, _, port_r1cs, port_wit = circuit
    pk, vk = tmpc.export_keys(tp)
    proof = tg.prove(port_r1cs, pk, port_wit, device="cpu")
    assert tg.verify(vk, proof)
    jvk = jmpc.export_keys(ceremony[0])[1]
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())
    assert jg.verify(jvk, JProof.from_json(proof.to_json()))
