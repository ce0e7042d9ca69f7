"""BW6-761 recursion on the CPU: the port's in-circuit BLS12-377 GM17
verifier, its directive solver, its BW6-761 pairing and its sorted MSM over
BW6's 48-limb Fq, against the JAX package.

  * embed.snark_verify: generate_verify_constraints(3) equals the JAX
    package's table (the stdlib's snark/gm17 wrapper with three inner
    inputs); generate_verify_witness equals its assignment on the
    reference's test vector (tests/corpus/stdlib/snark/gm17.json: a GM17
    proof over BLS12-377 with inner inputs [1, 2, 3], output 1) and on a
    variant with an inner input changed (output 0 in both packages); the
    assignments satisfy the constraint table;
  * the interpreter's SnarkVerifyBls12377 solver gives the JAX
    interpreter's assignment, its inputs in the directive's order (inner
    inputs, the 8 proof wires, the verification key), flattened by the
    port's ABI encoder from port_artifacts/snark_gm17_bw6_761.abi.json;
  * ec.pairing_bw6: the Miller loop and the final exponentiation equal the
    JAX module's on seeded points, bilinearity holds, and a pairing product
    check accepts and rejects as the JAX package's;
  * the MSM entry points over BW6's G1 (groth16._msm_g1) and its G2 over
    Fq (groth16._msm_g2: rows packed as G1's, 144 words, the Fq walks)
    through the plain sorted MSM against a Python-int oracle, in a small
    configuration (c = 2, 8 walk lanes; at 48 limbs the default c = 8
    configuration's plain suffix takes about 50 s on one CPU thread: G1
    at that configuration is held in test_torch_bls12_curves.py).

Tolerance: exact equality throughout (field elements, points, wires).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from zokrates_tpu.ec import pairing_bw6 as jpb
from zokrates_tpu.ec.curve import g1_group as jg1
from zokrates_tpu.ec.curve import g2_group as jg2
from zokrates_tpu.embed import snark_verify as jsv
from zokrates_tpu.fields.field import FIELDS as JFIELDS
from zokrates_tpu.interp.interpreter import execute_solver as j_execute_solver
from zokrates_tpu.ir.program import Solver as JSolver
from zokrates_tpu_torch.abi import encode_inputs
from zokrates_tpu_torch.ec import pairing_bw6 as tpb
from zokrates_tpu_torch.ec.curve import g1_group, g2_group
from zokrates_tpu_torch.ec.pairing import pairing_product_is_one
from zokrates_tpu_torch.embed import snark_verify as tsv
from zokrates_tpu_torch.fields.field import FIELDS
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.interp.interpreter import execute_solver
from zokrates_tpu_torch.ir.program import Solver
from zokrates_tpu_torch.kernels import msm_sorted as ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE = "bw6_761"
N_INNER = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_vector():
    """The test vector's arguments as field elements in ABI order: proof.a
    (2), proof.b (4), proof.c (2), the inner inputs (3), then the
    verification key (24)."""
    with open(os.path.join(ROOT, "tests", "corpus", "stdlib", "snark", "gm17.json")) as f:
        case = json.load(f)["tests"][0]
    with open(os.path.join(ROOT, "port_artifacts", "snark_gm17_bw6_761.abi.json")) as f:
        abi = json.load(f)
    return encode_inputs(case["input"]["values"], abi["inputs"], FIELDS[CURVE].P)


def _directive_inputs(flat, bump=0):
    """The SnarkVerifyBls12377 directive's inputs: the inner inputs (the
    first raised by `bump`), the 8 proof wires, the verification key."""
    inner = list(flat[8:8 + N_INNER])
    inner[0] += bump
    return inner + list(flat[:8]) + list(flat[8 + N_INNER:])


@pytest.fixture(scope="module")
def vector():
    flat = _flat_vector()
    assert len(flat) == 8 + N_INNER + 18 + 2 * N_INNER
    return flat


@pytest.fixture(scope="module")
def constraints():
    return jsv.generate_verify_constraints(N_INNER), tsv.generate_verify_constraints(N_INNER)


@pytest.fixture(scope="module")
def assignments(vector):
    """{case: (JAX assignment, port assignment)}: the JAX package's solver
    and the port's interpreter solver on the honest vector and on one with
    the first inner input raised by 1."""
    out = {}
    for case, bump in (("honest", 0), ("changed", 1)):
        ins = _directive_inputs(vector, bump)
        want = j_execute_solver(JSolver("SnarkVerifyBls12377", N_INNER), ins, JFIELDS[CURVE])
        got = execute_solver(Solver("SnarkVerifyBls12377", N_INNER), ins, FIELDS[CURVE])
        out[case] = (want, got)
    return out


def test_verify_constraints_match_reference(constraints):
    want, got = constraints
    assert got[0] == want[0] and got[1:4] == want[1:4] and got[5] == want[5]
    assert len(got[4]) == len(want[4]) > 100_000
    assert got[4] == want[4]


@pytest.mark.parametrize("case,out", [("honest", 1), ("changed", 0)])
def test_solver_matches_reference(assignments, constraints, case, out):
    """The port's interpreter solver equals the JAX package's assignment,
    its output wire is `out` in both, and the assignment satisfies the
    port's constraint table (a changed inner input gives output 0, not an
    unsatisfiable witness)."""
    want, got = assignments[case]
    assert got == want
    table = constraints[1]
    q = FIELDS[CURVE].P
    assert got[table[0]] == out

    def ev(lin):
        return sum(c * got[v] for v, c in lin.items()) % q

    assert all(ev(a) * ev(b) % q == ev(c) for a, b, c in table[4])


def test_generate_verify_witness_matches_reference(vector):
    """generate_verify_witness on the vector split as the stdlib wrapper
    splits it (inputs, proof, vk)."""
    inner, proof, vk = vector[8:8 + N_INNER], vector[:8], vector[8 + N_INNER:]
    assert tsv.generate_verify_witness(inner, proof, vk) == jsv.generate_verify_witness(inner, proof, vk)


@pytest.fixture(scope="module")
def seeded_points():
    """Three (P, Q) pairs of BW6-761's G1 and G2 from seeded multiples of
    the generators, in both packages."""
    rng = random.Random(31)
    ks = [(rng.randrange(1, g1_group(CURVE).r), rng.randrange(1, g1_group(CURVE).r)) for _ in range(3)]
    port = [(g1_group(CURVE).generator() * a, g2_group(CURVE).generator() * b) for a, b in ks]
    jax = [(jg1(CURVE).generator() * a, jg2(CURVE).generator() * b) for a, b in ks]
    return ks, port, jax


def test_miller_loop_and_final_exponentiation_match_reference(seeded_points):
    _, port, jax = seeded_points
    for (tp, tq), (jp, jq) in zip(port, jax):
        assert (tp.x, tp.y, tq.x, tq.y) == (jp.x, jp.y, jq.x, jq.y)
        f_t, f_j = tpb.miller_loop_bw6(tp, tq), jpb.miller_loop_bw6(jp, jq)
        assert list(f_t.c) == list(f_j.c)
        e_t, e_j = tpb.final_exponentiation_bw6(f_t), jpb.final_exponentiation_bw6(f_j)
        assert list(e_t.c) == list(e_j.c)
        assert not e_t.is_one()


def test_pairing_is_bilinear(seeded_points):
    _, port, _ = seeded_points
    P, Q = port[0]
    a, b = 94823, 51771
    e = tpb.final_exponentiation_bw6(tpb.miller_loop_bw6(P, Q))
    assert tpb.final_exponentiation_bw6(tpb.miller_loop_bw6(P * a, Q * b)) == e.pow(a * b % g1_group(CURVE).r)
    assert pairing_product_is_one(CURVE, [(P * a, Q), (-P, Q * a)])
    assert not pairing_product_is_one(CURVE, [(P * a, Q), (-P, Q * (a + 1))])
    assert tpb.miller_loop_bw6(g1_group(CURVE).zero(), Q).is_one()


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_msm_entry_points_match_oracle(group, monkeypatch):
    """groth16._msm_g1 / _msm_g2 over host points k_i * G of BW6-761's G1
    or G2 (G2 over Fq): (sum k_i s_i) * G, with a scalar 0 and a point
    None, in the small configuration."""
    from zokrates_tpu_torch.schemes import groth16 as tg

    monkeypatch.setattr(ms, "default_config", lambda n: ms.MSMConfig(c=2, M1=8, R=2, lw2=2))
    grp = g1_group(CURVE) if group == "G1" else g2_group(CURVE)
    r = grp.r
    rng = random.Random(7 + (group == "G2"))
    n = 10
    ks = [rng.randrange(1, r) for _ in range(n)]
    sc = [rng.randrange(r) for _ in range(n)]
    sc[3] = 0
    pts = [grp.generator() * k for k in ks]
    want = grp.generator() * (sum(k * s for k, s in zip(ks, sc)) % r)
    if group == "G1":
        got = tg._msm_g1(CURVE, [(pt.x, pt.y) for pt in pts] + [None], sc + [5], device="cpu")
    else:
        got = tg._msm_g2(CURVE, pts + [None], sc + [5], device="cpu")
        assert got.curve is grp
    assert (got.x, got.y) == (want.x, want.y)
    q = grp.q
    assert ms.pack_points(q, field_ops(q).encode([1]), field_ops(q).encode([2])).shape == (1, 144)


def test_fixed_base_tail_multiply_covers_r():
    """groth16._fb_mul_g1 (the host tail's comb multiply) at a 377-bit
    scalar: its table spans BW6-761's r, where the reference's 64 windows
    of 4 bits stop at 256 bits."""
    from zokrates_tpu_torch.schemes import groth16 as tg

    g = g1_group(CURVE).generator()
    k = g1_group(CURVE).r - 12345
    assert k >> 256
    got = tg._fb_mul_g1(g, k)
    want = g * k
    assert (got.x, got.y) == (want.x, want.y)


@pytest.mark.parametrize("k", [16, 48, 62, 63, 96, 97])
def test_carry_resolution_at_every_width(k):
    """jfield's packed carry resolution against a sequential ripple over k
    limbs: the 96-limb rows of a 48-limb product (BW6-761's Fq) resolve
    in two int64 pieces. Generate and propagate flags at random, with runs
    of propagates carrying a generate across the pieces' boundary at 62
    limbs."""
    rng = np.random.default_rng(k)
    rows = 4000
    gen = rng.random((rows, k)) < 0.1
    prop = (rng.random((rows, k)) < 0.5) & ~gen
    if k > 62:
        gen[0, 60], prop[0, 61:min(k, 90)], gen[0, 61:min(k, 90)] = True, True, False
    f = field_ops(g1_group(CURVE).q)
    sh = torch.arange(2 * f.nl + 1, dtype=torch.int64)
    cin, cout = f._resolve(torch.as_tensor(gen), torch.as_tensor(prop), sh)
    want = np.zeros((rows, k + 1), np.int64)
    for i in range(k):
        want[:, i + 1] = gen[:, i] | (prop[:, i] & (want[:, i] == 1))
    np.testing.assert_array_equal(cin.numpy(), want[:, :k])
    np.testing.assert_array_equal(cout.numpy(), want[:, k])


def test_shared_bucket_h_query_rows():
    """groth16._h16_p128 on BW6-761's 144-word rows, normalized in chunks
    (2 points a chunk here): row w*Nh + j packs 2^(16w) * h_j, the rows
    past the query zero, over all Wc = 24 windows of the 377-bit r."""
    from zokrates_tpu_torch.schemes import groth16 as tg

    grp = g1_group(CURVE)
    q = grp.q
    f = field_ops(q)
    rng = random.Random(13)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(3)]
    rows = ms.pack_points(q, f.encode([p.x for p in pts]), f.encode([p.y for p in pts])).numpy().astype(np.uint32)
    Nh = 4
    out = tg._h16_p128(CURVE, rows, Nh, "cpu", chunk=2)
    Wc = ms.shared_window_count(grp.r, 16)
    assert Wc == 24 and out.shape == (Wc * Nh, 144)
    shifted = pts
    for w in range(Wc):
        if w:
            shifted = [pt * (1 << 16) for pt in shifted]
        want = ms.pack_points(q, f.encode([p.x for p in shifted]), f.encode([p.y for p in shifted])).numpy()
        np.testing.assert_array_equal(out[w * Nh : w * Nh + 3], want.astype(np.uint32), err_msg=f"window {w}")
        assert not out[w * Nh + 3].any()
