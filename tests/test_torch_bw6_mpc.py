"""The port's Groth16 phase-2 ceremony (zokrates_tpu_torch.schemes.mpc) over
BW6-761 on the CPU, against the JAX package's (zokrates_tpu.schemes.mpc):
the reference tests' cube circuit over bw6_761, its key made by the JAX
package's Groth16 setup and carried across (convert.proving_key: b2_p128
None, the b2 query as (m, 48) coordinates over Fq, the G2 points as (x, y)
ints).

  * one contribution: its scaling of the h and l query rows
    (mpc.scale_rows, one batched ladder at 48 limbs over the plain
    mixed_add_lm here) gives, for 8 sampled rows, the points the JAX
    package's mpc._scale gives for the same rows and the same k;
  * verify accepts the chain, and rejects it with the contribution's
    published [s]G1 changed.

The JAX setup's fixed-base evaluator is replaced by Python-int scalar
multiplies in its output formats (test_torch_bw6_groth16's oracle: its XLA
compiles at 48 limbs would take minutes, and its pack_points lays rows out
in 128 words). One contribution only: its ladder (about 190 GLV steps of
plain doublings and mixed adds at 48 limbs) takes about 20 s on one CPU
thread. Tolerance: exact equality of every coordinate.
"""

import numpy as np
import pytest
import torch
from test_groth16 import cube_prog
from test_torch_bls12 import _seq_rng
from test_torch_bw6_groth16 import _jax_fixed_base_oracle

from zokrates_tpu.fields import params as JP
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.schemes import groth16 as jg, mpc as jmpc
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.schemes import mpc as tmpc

CURVE = "bw6_761"
R = JP.SCALAR_FIELDS[CURVE].p
Q = JP.BASE_FIELDS[CURVE].p
SAMPLES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ceremony():
    """The JAX key carried across, and one contribution to it: (params,
    the scaling's rows, k and new rows)."""
    r1cs = r1cs_from_prog(cube_prog(CURVE))
    with pytest.MonkeyPatch.context() as mp:
        _jax_fixed_base_oracle(mp)
        jpk, jvk = jg.setup(r1cs, rng=_seq_rng(R, 9))
    points = {k: (getattr(jpk, k).x, getattr(jpk, k).y) for k in convert.PK_G1 + convert.PK_G2}
    arrays = {k: getattr(jpk, k) for k in convert.PK_ARRAYS + convert.PK_B2_XY}
    pk = convert.proving_key(CURVE, jpk.domain_size, jpk.num_instance, points, arrays)
    params = tmpc.from_keys(pk, convert.verification_key("g16", CURVE, jvk.data))
    calls = []
    scale_rows = tmpc.scale_rows

    def recorded(curve, rows, k, device):
        out = scale_rows(curve, rows, k, device)
        calls.append((rows, k, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmpc, "scale_rows", recorded)
        tmpc.contribute(params, "alice", device="cpu")
    assert len(calls) == 1
    return params, calls[0]


def test_scale_rows_matches_reference(ceremony):
    _, (rows, k, out) = ceremony
    f = field_ops(Q)
    nl = f.nl
    assert rows.shape[1] == out.shape[1] == 144  # BW6-761's packed rows: [x | y | -y] of 48 limbs
    idx = np.random.default_rng(10).choice(rows.shape[0], min(SAMPLES, rows.shape[0]), replace=False)

    def affine(t):
        t = torch.as_tensor(t[idx][:, : 2 * nl].astype(np.int64))
        return list(zip(f.decode(t[:, :nl]), f.decode(t[:, nl:])))

    for a, b in zip(affine(rows), affine(out)):
        assert b == jmpc._scale(a, k, CURVE)


@pytest.mark.parametrize("case", ["honest", "tampered"])
def test_verify(ceremony, case):
    params = ceremony[0]
    contrib = params.contributions[0]
    saved = contrib.pk_s_g1
    if case == "tampered":
        contrib.pk_s_g1 = saved + saved
    try:
        assert tmpc.verify(params) == (case == "honest")
    finally:
        contrib.pk_s_g1 = saved
