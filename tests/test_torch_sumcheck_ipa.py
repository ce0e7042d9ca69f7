"""The port's sumcheck and inner-product argument
(zokrates_tpu_torch.schemes.sumcheck, .ipa) on the CPU against the JAX
package's (zokrates_tpu.schemes.sumcheck, .ipa).

  * eq_table, mle_eval and eq_point on seeded vectors equal the reference's;
  * sumcheck_prove's round messages, challenges and final values equal the
    reference's under the same transcript label, sumcheck_verify replays
    them to the same challenges and final claim, and a wrong claim fails;
  * ipa_prove at n = 2 to 64 (3 and 17 padded to powers of two) on Pallas
    and Vesta gives the reference's proof (L and R points, final scalar),
    each package's ipa_verify accepts the other's proof, and a wrong value
    or a tampered final scalar or L point fails both.

Both packages' IPAs are host Python (jac_mul) on both sides; the bases
come from the reference's hash-to-curve. Inputs come from seeded numpy
generators. Tolerance: exact equality of integers and affine points.
"""

import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.schemes import ipa as jipa
from zokrates_tpu.schemes import sumcheck as jsc
from zokrates_tpu.schemes.marlin import _Transcript as JTr
from zokrates_tpu.schemes.nova import _hash_to_curve
from zokrates_tpu_torch.schemes import ipa as tipa
from zokrates_tpu_torch.schemes import sumcheck as tsc
from zokrates_tpu_torch.schemes.marlin import _Transcript as TTr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vec(rng, n, p):
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


@pytest.mark.parametrize("curve", ["pallas", "vesta"])
def test_eq_table_mle_eval_eq_point_match_reference(curve):
    p = JP.SCALAR_FIELDS[curve].p
    rng = np.random.default_rng(1)
    for l in (1, 3, 5):
        r, s = _vec(rng, l, p), _vec(rng, l, p)
        vec = _vec(rng, 1 << l, p)
        assert tsc.eq_table(r, p) == jsc.eq_table(r, p)
        assert tsc.mle_eval(vec, r, p) == jsc.mle_eval(vec, r, p)
        assert tsc.eq_point(r, s, p) == jsc.eq_point(r, s, p)
        assert tsc._lagrange_0123(vec[:4], r[0], p) == jsc._lagrange_0123(vec[:4], r[0], p)


@pytest.mark.parametrize("curve", ["pallas", "vesta"])
@pytest.mark.parametrize("deg", [2, 3])
def test_sumcheck_matches_reference(curve, deg):
    """Prover messages, challenges and finals equal; the verifier replays
    them in both packages to the same (challenges, final claim), which
    equals the combined finals; a claim off by one fails."""
    p = JP.SCALAR_FIELDS[curve].p
    rng = np.random.default_rng(2 + deg)
    polys = [_vec(rng, 16, p) for _ in range(deg)]

    def combine(*v):
        acc = 1
        for x in v:
            acc = acc * x % p
        return acc

    claim = sum(combine(*v) for v in zip(*polys)) % p
    jout = jsc.sumcheck_prove(JTr(b"sc"), p, polys, combine, deg)
    tout = tsc.sumcheck_prove(TTr(b"sc"), p, polys, combine, deg)
    assert tout == jout
    msgs, rs, finals = tout
    tver = tsc.sumcheck_verify(TTr(b"sc"), p, claim, msgs, deg)
    assert tver == jsc.sumcheck_verify(JTr(b"sc"), p, claim, msgs, deg)
    assert tver == (rs, combine(*finals))
    assert [tsc.mle_eval(q, rs, p) for q in polys] == finals
    assert tsc.sumcheck_verify(TTr(b"sc"), p, claim + 1, msgs, deg) is None


@pytest.mark.parametrize("curve", ["pallas", "vesta"])
@pytest.mark.parametrize("n", [2, 3, 8, 17, 64])
def test_ipa_matches_reference(curve, n):
    p = JP.SCALAR_FIELDS[curve].p
    q = JP.BASE_FIELDS[curve].p
    bases = _hash_to_curve(curve, b"ipa test", 1 << (n - 1).bit_length())
    (Q,) = _hash_to_curve(curve, b"Q", 1)
    rng = np.random.default_rng(10 + n)
    w, c = _vec(rng, n, p), _vec(rng, n, p)
    v = sum(x * y for x, y in zip(w, c)) % p
    com = tipa._aff(tipa.jac_to_affine(q, tipa._msm_host(q, bases, w)))
    assert com == jipa._aff(jipa.jac_to_affine(q, jipa._msm_host(q, bases, w)))

    tpr = tipa.ipa_prove(TTr(b"ipa"), p, q, bases, Q, w, c)
    jpr = jipa.ipa_prove(JTr(b"ipa"), p, q, bases, Q, w, c)
    assert (tpr.Ls, tpr.Rs, tpr.w0) == (jpr.Ls, jpr.Rs, jpr.w0)
    assert len(tpr.Ls) == (n - 1).bit_length()

    def verdicts(proof, value):
        return (tipa.ipa_verify(TTr(b"ipa"), p, q, bases, Q, com, c, value, proof),
                jipa.ipa_verify(JTr(b"ipa"), p, q, bases, Q, com, c, value, proof))

    assert verdicts(jpr, v) == (True, True)  # the port verifies the reference's proof
    assert verdicts(tpr, v) == (True, True)  # and the reference the port's
    assert verdicts(tpr, (v + 1) % p) == (False, False)
    assert verdicts(tipa.IpaProof(Ls=tpr.Ls, Rs=tpr.Rs, w0=(tpr.w0 + 1) % p), v) == (False, False)
    bad_L = [tpr.Rs[0]] + tpr.Ls[1:]
    assert verdicts(tipa.IpaProof(Ls=bad_L, Rs=tpr.Rs, w0=tpr.w0), v) == (False, False)
