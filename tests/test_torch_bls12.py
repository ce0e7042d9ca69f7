"""The port on the BLS12 curves (BLS12-381, BLS12-377) on the CPU, where the
kernel wrappers run their plain versions, against the JAX package.

  * the sorted MSM's walk (mixed-unsafe, mixed-safe, general), suffix walk
    and suffix epilogue at 24 16-bit limbs, over G1 (Fq) and G2 (Fq2: u^2 =
    -1 on BLS12-381, -5 on BLS12-377), against the JAX package's
    Python-int point oracle (zokrates_tpu.ec), with Jacobian Z values
    within 2^8 of q;
  * the widths: packed rows of max(128, 3*en) words, and the fields each
    CUDA wrapper takes (cuda.field_params), over every curve's fields;
  * emul, ereduce_wide, the NTT and the walk matvec (mulacc_walk) over
    BLS12-381's 255-bit r, against the JAX package's field ops and Domain,
    with values within 2^8 of r (4r exceeds 2^256 there, unlike on BN254);
  * Groth16 on the reference's cube program (tests/test_groth16.py) for
    bls12_381: with the same rng the port's setup keys equal the JAX
    package's array for array (b2_p128 None, b2_x / b2_y equal, as the
    reference keeps a G2 row of 144 words), the proof JSON at fixed r, s
    equals the JAX proof byte for byte (the reference prove's MSMs replaced
    by a Python-int oracle, whose XLA G2 Pippenger would compile for
    minutes at 24 limbs), prove_batch equals prove(), and forgeries fail.

BLS12-377's Groth16, GM17 on BLS12-381 and BW6-761's G1 MSM are held in
test_torch_bls12_curves.py (a file of its own, so that the suite's workers
share the load).

The JAX results run once per module (module-scoped fixtures). Tolerance:
exact equality throughout (limbs, points, JSON bytes).
"""

import json
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_groth16 import cube_prog

from zokrates_tpu.ec.curve import PointG1 as JPointG1
from zokrates_tpu.ec.curve import g1_group as jg1
from zokrates_tpu.ec.curve import g2_group as jg2
from zokrates_tpu.ec.tower import Fq2 as JFq2
from zokrates_tpu.fields import params as JP
from zokrates_tpu.fields.jfield import field_ops as jfield_ops
from zokrates_tpu.interp.interpreter import Interpreter
from zokrates_tpu.ir.r1cs import r1cs_from_prog
from zokrates_tpu.kernels import ntt as jntt
from zokrates_tpu.schemes import groth16 as jg
from zokrates_tpu.schemes.types import Proof as JProof
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.fields.jfield import field_ops
from zokrates_tpu_torch.fields.jfield2 import field_ops2
from zokrates_tpu_torch.ir import r1cs_device as trd
from zokrates_tpu_torch.ir.witness import Witness as TWitness
from zokrates_tpu_torch.kernels import cuda
from zokrates_tpu_torch.kernels import msm_sorted as ms
from zokrates_tpu_torch.kernels import ntt as tntt
from zokrates_tpu_torch.kernels import pallas_field as pf
from zokrates_tpu_torch.schemes import groth16 as tg
from zokrates_tpu_torch.schemes.types import Proof as TProof
from zokrates_tpu_torch.schemes.types import fr_to_json

CURVES = ("bls12_381", "bls12_377")
RS = (0x1234567890ABCDEF, JP.SCALAR_FIELDS["bls12_381"].p - 12345)  # the prover's fixed r, s


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixed(values):
    it = iter(values)
    return lambda: next(it)


def _seq_rng(p, seed, k=5):
    """k toxic-waste draws below p, fixed by a seed, as an rng() callable."""
    return _fixed([random.Random(seed).randrange(1, p) for _ in range(k)])


# ---------------------------------------------------------------------------
# the sorted MSM's plain versions at 24 limbs vs the Python-int oracle
# ---------------------------------------------------------------------------


class Pool:
    """Random points of one BLS12 group as affine rows and as Jacobian rows
    with Z within 2^8 of q, with their negatives (cancellations) and one
    point at infinity as the last Jacobian row."""

    def __init__(self, curve, ext, seed, n=5):
        rng = random.Random(seed)
        grp = jg2(curve) if ext else jg1(curve)
        q = grp.q
        self.grp, self.ext, self.q = grp, ext, q
        self.beta = grp.tower.beta - q if ext else None
        self.f = field_ops2(q, self.beta) if ext else field_ops(q)
        self.pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(n)]
        self.affine = torch.cat([self.rows([p.x for p in self.pts]), self.rows([p.y for p in self.pts])], 1)
        self.jpts = self.pts + [-p for p in self.pts]
        X, Y, Z = [], [], []
        for p in self.jpts:
            z = q - rng.randrange(1, 1 << 8)
            z = JFq2(grp.tower, z, q - rng.randrange(1 << 8)) if ext else z
            X.append(p.x * z * z if ext else p.x * z * z % q)
            Y.append(p.y * z * z * z if ext else p.y * z ** 3 % q)
            Z.append(z)
        X.append(self.pts[0].x)
        Y.append(self.pts[0].y)
        Z.append(JFq2(grp.tower, 0, 0) if ext else 0)
        self.jac = torch.cat([self.rows(X), self.rows(Y), self.rows(Z)], 1)
        self.jpts.append(grp.zero())

    def rows(self, vals):
        """Host coordinates -> (n, en) int32 Montgomery limb rows."""
        vals = [(v.c0, v.c1) for v in vals] if self.ext else vals
        return self.f.encode(vals).reshape(len(vals), -1).to(torch.int32)

    def point(self, col):
        """One lane's Jacobian column (3*en,) of limbs -> host point."""
        en = col.shape[0] // 3
        nl = 24
        rinv = pow(1 << (16 * nl), -1, self.q)

        def elem(limbs):
            ints = [sum(int(v) << (16 * i) for i, v in enumerate(limbs[h:h + nl])) * rinv % self.q
                    for h in range(0, len(limbs), nl)]
            return JFq2(self.grp.tower, *ints) if self.ext else ints[0]

        X, Y, Z = (elem(col[i * en:(i + 1) * en]) for i in range(3))
        if Z == (JFq2(self.grp.tower, 0, 0) if self.ext else 0):
            return self.grp.zero()
        if self.ext:
            zi = Z.inv()
            x, y = X * zi * zi, Y * zi * zi * zi
            return self.grp.point((x.c0, x.c1), (y.c0, y.c1))
        zi = pow(Z, -1, self.q)
        return self.grp.point(X * zi * zi % self.q, Y * zi ** 3 % self.q)


@pytest.fixture(scope="module")
def pools():
    cache = {}

    def get(curve, ext):
        if (curve, ext) not in cache:
            cache[curve, ext] = Pool(curve, ext, seed=11 + 2 * CURVES.index(curve) + ext)
        return cache[curve, ext]
    return get


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("mode,safe", [("mixed", False), ("mixed", True), ("general", True)],
                         ids=["mixed-unsafe", "mixed-safe", "general"])
@pytest.mark.parametrize("curve", CURVES)
def test_walk_matches_oracle(pools, curve, ext, mode, safe):
    """Every snapshot of every lane equals the oracle's running bucket sum;
    the unsafe mixed walk flags exactly the lanes where a running sum met
    its own point."""
    pool = pools(curve, ext)
    K, L = 6, 12
    rng = np.random.default_rng(3 + ext)
    src = pool.affine if mode == "mixed" else pool.jac
    idx = rng.integers(0, src.shape[0], (K, L))
    idx[:2, 0] = 0  # a doubling in lane 0
    q = src[torch.as_tensor(idx)].permute(0, 2, 1).contiguous()
    flags = (rng.random((K, L)) < 0.3).astype(np.int32) | ((rng.random((K, L)) < 0.15).astype(np.int32) << 1)
    flags[:2, 0] = 0
    before = dict(ms.LAUNCHES)
    out, coll = ms.walk(q, torch.as_tensor(flags), pool.q, mode, safe, pool.beta)
    assert dict(ms.LAUNCHES) == before  # the plain version: no launch
    assert out.shape == (K, 3 * (48 if ext else 24), L)
    pts = pool.pts if mode == "mixed" else pool.jpts
    for lane in range(L):
        acc, hit = pool.grp.zero(), False
        for k in range(K):
            if not flags[k, lane] & 2:
                pt = pts[idx[k, lane]]
                hit |= mode == "mixed" and not acc.infinity and acc == pt
                acc = acc + pt
            if not (hit and not safe):
                assert pool.point(out[k, :, lane].numpy()) == acc, (lane, k)
            if flags[k, lane] & 1:
                acc = pool.grp.zero()
        assert int(coll[lane]) == int(hit and not safe), lane
    assert bool(coll[0]) == (mode == "mixed" and not safe)


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("curve", CURVES)
def test_suffix_matches_oracle(pools, curve, ext):
    """[acc | tot] = (sum of both slots over the lane's buckets, sum of the
    running sums)."""
    pool = pools(curve, ext)
    Lb, M = 3, 8
    rng = np.random.default_rng(6 + ext)
    ia = rng.integers(0, pool.jac.shape[0], (Lb, M))
    ib = rng.integers(0, pool.jac.shape[0], (Lb, M))
    A = pool.jac[torch.as_tensor(ia)].permute(0, 2, 1).contiguous()
    B = pool.jac[torch.as_tensor(ib)].permute(0, 2, 1).contiguous()
    out = ms.suffix(A, B, pool.q, pool.beta)
    en = A.shape[1] // 3
    assert out.shape == (6 * en, M)
    for lane in range(M):
        acc = tot = pool.grp.zero()
        for t in range(Lb):
            acc = acc + pool.jpts[ia[t, lane]] + pool.jpts[ib[t, lane]]
            tot = tot + acc
        col = out[:, lane].numpy()
        assert pool.point(col[:3 * en]) == acc
        assert pool.point(col[3 * en:]) == tot


@pytest.mark.parametrize("ext", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("curve", CURVES)
def test_suffix_fold_matches_oracle(pools, curve, ext):
    """Window w's sum of tot_i + (lw-1-i)*L * acc_i over its lw lanes."""
    pool = pools(curve, ext)
    W, lw, L = 2, 4, 3
    rng = np.random.default_rng(8 + ext)
    inf = pool.jac.shape[0] - 1
    ia = rng.integers(0, inf + 1, W * lw)
    it = rng.integers(0, inf + 1, W * lw)
    ia[0] = inf
    out6 = torch.cat([pool.jac[torch.as_tensor(ia)], pool.jac[torch.as_tensor(it)]], 1).T.contiguous()
    got = [t.numpy() for t in ms.suffix_fold(out6, pool.q, W, lw, L, pool.beta)]
    for w in range(W):
        want = pool.grp.zero()
        for i in range(lw):
            m = w * lw + i
            want = want + pool.jpts[it[m]] + pool.jpts[ia[m]] * ((lw - 1 - i) * L)
        assert pool.point(np.concatenate([t[w] for t in got])) == want, w


# (G1 row words, G2 row words or None where G2 lies over Fq) of each curve
ROW_WORDS = {"bn128": (128, 128), "bls12_381": (128, 144), "bls12_377": (128, 144),
             "bw6_761": (144, None), "pallas": (128, None), "vesta": (128, None)}


@pytest.mark.parametrize("curve", sorted(ROW_WORDS))
def test_kernel_widths_and_packed_rows(curve):
    """Packed rows take max(128, 3*en) words: 128 for every G1 but BW6-761's
    (144) and for BN254's G2, 144 for the BLS12 G2. The MSM kernels take
    fields of 8 or 12 32-bit limbs (16 or 24 16-bit limbs), the other
    kernels 8, and cuda.field_params hands over p, R mod p and -p^-1 mod
    2^32 at that width, or names the widths it takes."""
    g1w, g2w = ROW_WORDS[curve]
    q = JP.BASE_FIELDS[curve].p
    f = field_ops(q)
    X = f.encode([1, 2])
    assert ms.pack_points(q, X, X).shape == (2, g1w)
    if g2w is not None:
        assert ms.pack_points_g2(q, X.reshape(1, 2, -1), X.reshape(1, 2, -1)).shape == (1, g2w)
    for p in (q, JP.SCALAR_FIELDS[curve].p):
        nl = field_ops(p).nl
        for widths in (cuda.NL32, cuda.NL32_FIELD):
            if nl // 2 not in widths:
                with pytest.raises(ValueError, match=f"16-bit limbs, got nl={nl}"):
                    cuda.field_params(p, None, widths)
                continue
            n, pl, one, n0, _ = cuda.field_params(p, None, widths)
            assert n == nl // 2 and len(pl) == len(one) == n
            assert sum(int(v) << (32 * i) for i, v in enumerate(pl)) == p
            assert sum(int(v) << (32 * i) for i, v in enumerate(one)) == (1 << (32 * n)) % p
            assert (n0 * p) % (1 << 32) == (1 << 32) - 1
    with pytest.raises(ValueError, match="limbs32"):
        cuda.limbs32(q, 4)


# ---------------------------------------------------------------------------
# the scalar-field kernels' plain versions on BLS12-381's r
# ---------------------------------------------------------------------------

R381 = JP.SCALAR_FIELDS["bls12_381"].p


def _near_r(shape, seed):
    """Canonical residues mod r as (..., 16) int64 limbs: half of them
    within 2^8 of r, the rest uniform below r."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [R381 - int(rng.integers(1, 1 << 8)) if i % 2 else int(rng.integers(0, 1 << 62)) * R381 >> 62
            for i in range(n)]
    limbs = np.array([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals], dtype=np.int64)
    return limbs.reshape(tuple(shape) + (16,))


@pytest.fixture(scope="module")
def jf381():
    return jfield_ops(R381)


def test_emul_near_r_matches_reference(jf381):
    a, b = _near_r((2, 24), 1), _near_r((24,), 2)
    want = np.asarray(jax.jit(jf381.mul_)(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b[None].astype(np.uint32))))
    got = pf.emul(R381, torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_ereduce_wide_near_r_matches_reference(jf381):
    """Lazy sums of 2^15 residues within 2^8 of r, and column sums up to
    2^31 (the reference's u32 headroom)."""
    rng = np.random.default_rng(4)
    t = rng.integers(0, 1 << 31, (2, 20, 16), dtype=np.int64)
    t[0] = _near_r((20,), 5) * (1 << 15)
    want = np.asarray(jax.jit(jf381.reduce_wide_)(jnp.asarray(t.astype(np.uint32))))
    got = pf.ereduce_wide(R381, torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("kind", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_ntt_near_r_matches_reference(kind):
    n = 1 << 6
    jd, td = jntt.domain_for_curve("bls12_381", n), tntt.domain_for_curve("bls12_381", n)
    x = _near_r((2, n), 7)
    g = JP.SCALAR_FIELDS["bls12_381"].smallest_nonresidue
    fn = (lambda d: getattr(d, kind)) if kind in ("fft", "ifft") else (lambda d: lambda a: getattr(d, kind)(a, g))
    want = np.asarray(jax.jit(fn(jd))(jnp.asarray(x.astype(np.uint32))))
    got = fn(td)(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_walk_matvec_near_r_matches_reference(jf381):
    """The walk matvec (mulacc_walk's plain version, its lazy sums and the
    reductions) over 1500 records of residues within 2^8 of r, B = 2."""
    rng = np.random.default_rng(21)
    n, m, L, B = 32, 30, 1500, 2
    rows = np.sort(rng.integers(0, 3 * n, size=L)).astype(np.int64)
    cols = rng.integers(0, m, size=L).astype(np.int64)
    coeff = _near_r((L,), 22)
    Z_mont = _near_r((B, m), 23)
    vals = jf381.mul_(jnp.asarray(coeff.astype(np.uint32))[None],
                      jnp.take(jnp.asarray(Z_mont.astype(np.uint32)), jnp.asarray(cols), axis=1))
    want = jf381.reduce_wide_(jax.vmap(lambda v: jax.ops.segment_sum(
        v, jnp.asarray(rows), num_segments=3 * n, indices_are_sorted=True))(vals))
    blocks = [(rows >= k * n) & (rows < (k + 1) * n) for k in range(3)]
    coo = [trd.COOMatrix(torch.as_tensor(rows[b] - k * n), torch.as_tensor(cols[b]), torch.as_tensor(coeff[b]),
                         n, rows_np=rows[b] - k * n, cols_np=cols[b], coeff_np=coeff[b])
           for k, b in enumerate(blocks)]
    dev = trd.R1CSDevice("bls12_381", n, 1, m - 1, *coo)
    got = tg._matvec_walk(R381, dev, torch.as_tensor(Z_mont))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# Groth16 on bls12_381 against the JAX package
# ---------------------------------------------------------------------------


def _oracle_packed_g1(curve, P128, S, mask=None):
    """Python-int MSM over packed rows (Montgomery limbs) and scalar limbs."""
    grp = jg1(curve)
    nl = n_limbs16(grp.q)
    rinv = pow(1 << (16 * nl), -1, grp.q)
    rows = np.asarray(P128)
    S = np.asarray(S)
    acc = grp.zero()
    for j in range(S.shape[0]):
        if mask is not None and not bool(np.asarray(mask)[j]):
            continue
        s = sum(int(v) << (16 * i) for i, v in enumerate(S[j])) % grp.r
        if s:
            x, y = (sum(int(v) << (16 * i) for i, v in enumerate(rows[j, h * nl:(h + 1) * nl])) * rinv % grp.q
                    for h in (0, 1))
            acc = acc + JPointG1(grp, x, y) * s
    return acc


def _oracle_dev_g2(curve, Px, Py, S, mask=None):
    grp = jg2(curve)
    nl = n_limbs16(grp.q)
    rinv = pow(1 << (16 * nl), -1, grp.q)

    def ints(a):
        return [sum(int(v) << (16 * i) for i, v in enumerate(row)) * rinv % grp.q
                for row in np.asarray(a).reshape(-1, nl)]

    xs, ys, S = ints(Px), ints(Py), np.asarray(S)
    acc = grp.zero()
    for j in range(S.shape[0]):
        if mask is not None and not bool(np.asarray(mask)[j]):
            continue
        s = sum(int(v) << (16 * i) for i, v in enumerate(S[j])) % grp.r
        if s:
            pt = grp.point((xs[2 * j], xs[2 * j + 1]), (ys[2 * j], ys[2 * j + 1]))
            acc = acc + pt * s
    return acc


def n_limbs16(x):
    return -(-x.bit_length() // 16)


@pytest.fixture(scope="module")
def cube381():
    prog = cube_prog("bls12_381")
    r1cs = r1cs_from_prog(prog)
    wit = Interpreter().execute(prog, [3])
    wit2 = Interpreter().execute(prog, [5])
    port_r1cs = convert.r1cs("bls12_381", r1cs.num_instance, r1cs.num_witness,
                             r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    return r1cs, wit, port_r1cs, TWitness(wit.values), TWitness(wit2.values)


@pytest.fixture(scope="module")
def jax_keys381(cube381):
    return jg.setup(cube381[0], rng=_seq_rng(R381, 1))


@pytest.fixture(scope="module")
def port_keys381(cube381):
    return tg.setup(cube381[2], rng=_seq_rng(R381, 1), device="cpu")


@pytest.fixture(scope="module")
def jax_proof381(cube381, jax_keys381):
    r1cs, wit = cube381[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "_msm_packed_g1", _oracle_packed_g1)
        mp.setattr(jg, "_msm_dev_g2", _oracle_dev_g2)
        return jg.prove(r1cs, jax_keys381[0], wit, rng=_fixed(RS))


@pytest.fixture(scope="module")
def port_proof381(cube381, port_keys381):
    return tg.prove(cube381[2], port_keys381[0], cube381[3], rng=_fixed(RS), device="cpu")


def test_setup_matches_reference(jax_keys381, port_keys381):
    jpk, jvk = jax_keys381
    pk, vk = port_keys381
    assert pk.b2_p128 is None and jpk.b2_p128 is None
    for name in convert.PK_ARRAYS:
        if name == "b2_p128":
            continue
        want = np.asarray(getattr(jpk, name))
        got = getattr(pk, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("b2_x", "b2_y"):
        assert getattr(pk, name).dtype == getattr(jpk, name).dtype, name
        np.testing.assert_array_equal(getattr(pk, name), getattr(jpk, name), err_msg=name)
    for name in convert.PK_G1 + convert.PK_G2:
        got, want = getattr(pk, name), getattr(jpk, name)
        assert (str(got.x), str(got.y)) == (str(want.x), str(want.y)), name
    assert json.dumps(vk.to_json()) == json.dumps(jvk.to_json())
    assert pk.b2_rows().shape == (pk.b2_x.shape[0], 144)


def test_keys_carry_across(jax_keys381, port_keys381):
    """convert.proving_key carries the JAX key's b2_x / b2_y (b2_p128 None),
    and pickling keeps them."""
    jpk = jax_keys381[0]
    points = {k: (getattr(jpk, k).x, getattr(jpk, k).y) for k in convert.PK_G1}
    for k in convert.PK_G2:
        pt = getattr(jpk, k)
        points[k] = ((pt.x.c0, pt.x.c1), (pt.y.c0, pt.y.c1))
    arrays = {k: getattr(jpk, k) for k in convert.PK_ARRAYS + convert.PK_B2_XY}
    pk = convert.proving_key("bls12_381", jpk.domain_size, jpk.num_instance, points, arrays)
    back = pickle.loads(pickle.dumps(pk))
    for key in (pk, back):
        assert key.b2_p128 is None
        np.testing.assert_array_equal(key.b2_x, port_keys381[0].b2_x)
        np.testing.assert_array_equal(key.b2_rows(), port_keys381[0].b2_rows())


def test_prove_matches_reference(jax_keys381, jax_proof381, port_proof381):
    assert json.dumps(port_proof381.to_json()) == json.dumps(jax_proof381.to_json())
    assert jg.verify(jax_keys381[1], JProof.from_json(port_proof381.to_json()))


def test_prove_batch_matches_prove(cube381, port_keys381, port_proof381):
    """Two distinct witnesses, r and s drawn in turn (5, 6, then RS): proof 1
    equals prove() of the same witness and r, s byte for byte, proof 0
    verifies."""
    _, _, r1cs, wit, wit2 = cube381
    pk, vk = port_keys381
    proofs = tg.prove_batch(r1cs, pk, [wit2, wit], rng=_fixed((5, 6) + RS), device="cpu")
    assert json.dumps(proofs[1].to_json()) == json.dumps(port_proof381.to_json())
    assert proofs[0].inputs != proofs[1].inputs
    assert tg.verify(vk, proofs[0])


@pytest.mark.parametrize("case", ["valid", "wrong_input", "tampered"])
def test_verify_rejects_forgeries(port_keys381, port_proof381, case):
    proof = TProof.from_json(json.loads(json.dumps(port_proof381.to_json())))
    if case == "wrong_input":
        proof.inputs[0] = fr_to_json(8, "bls12_381")
    elif case == "tampered":
        proof.points["a"], proof.points["c"] = proof.points["c"], proof.points["a"]
    assert tg.verify(port_keys381[1], proof) == (case == "valid")
