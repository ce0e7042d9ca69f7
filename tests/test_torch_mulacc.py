"""The port's fused sparse matvec on the CPU, where the kernel wrapper runs
its plain version, against the JAX package:

  * ir/r1cs_device.build_mulacc_walk: the walk layout's arrays (cols,
    coeff_walk, flags_walk, pos, seg) equal the JAX package's for a seeded
    random constraint system whose rows span lane boundaries; a lane
    count K above MAX_ROW_TERMS raises (the reference asserts no bound);
  * the walk matvec (kernels/pallas_field.mulacc_walk, ereduce_wide, the
    per-row sum, ereduce_wide) equals the JAX COO matvec (gather, mul_,
    segment_sum, reduce_wide_) at L = 3000 records and B = 2, the case of
    tests/test_kernels.py's test_mulacc_walk_matvec;
  * the h stage with the walk matvec equals the JAX _h_stage on a toy
    circuit compiled with zokrates_tpu.lang;
  * mulacc_walk's argument checks, and that CPU calls count no launch.

Inputs come from seeded numpy generators. Tolerance: exact equality of
every limb.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.fields.jfield import field_ops as jfield_ops
from zokrates_tpu.ir import r1cs_device as jrd
from zokrates_tpu.ir.r1cs import R1CS as JR1CS
from zokrates_tpu_torch import convert
from zokrates_tpu_torch.ir import r1cs_device as trd
from zokrates_tpu_torch.kernels import pallas_field as pf
from zokrates_tpu_torch.schemes import groth16 as tg

CURVE = "bn128"
P = JP.SCALAR_FIELDS[CURVE].p
NL = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_r1cs(seed, nc=600, m=50, ni=3):
    """Rows of 1-12 terms (so runs cross lane ends), random coefficients."""
    rng = random.Random(seed)

    def rows():
        return [[(c, rng.randrange(1, P)) for c in rng.sample(range(m), rng.randrange(1, 13))]
                for _ in range(nc)]

    A, B, C = rows(), rows(), rows()
    return JR1CS(curve=CURVE, num_instance=ni, num_witness=m - ni, A=A, B=B, C=C,
                 ir_to_dense={i: i for i in range(m)})


@pytest.fixture(scope="module")
def random_devs():
    jr = _random_r1cs(1)
    n = 1024
    tr = convert.r1cs(CURVE, jr.num_instance, jr.num_witness, jr.A, jr.B, jr.C, jr.ir_to_dense)
    return jrd.R1CSDevice.build(jr, n), trd.R1CSDevice.build(tr, n, device="cpu"), tr


def test_walk_layout_matches_reference(random_devs):
    jdev, tdev, _ = random_devs
    want = jrd.build_mulacc_walk(jdev)
    got = trd.build_mulacc_walk(tdev)
    assert got is trd.build_mulacc_walk(tdev)  # cached on the device
    assert (got.K, got.R, got.S, got.M, got.n_rows) == (want.K, want.R, want.S, want.M, want.n_rows)
    assert got.K > got.R  # several steps per lane, so runs cross lane ends
    K, M = got.K, got.M
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.coeff_walk.numpy(), np.asarray(want.coeff_walk).reshape(K, NL, M))
    np.testing.assert_array_equal(got.flags_walk.numpy(), np.asarray(want.flags_walk).reshape(K, M))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))


def test_walk_records_per_lane_bound(random_devs, monkeypatch):
    """K is bounded as rows are on the COO path: the lazy sums of one run
    must stay within ereduce_wide's headroom."""
    _, tdev, tr = random_devs
    K = trd.build_mulacc_walk(tdev).K
    fresh = trd.R1CSDevice.build(tr, tdev.n, device="cpu")  # no walk cached yet
    monkeypatch.setattr(trd, "MAX_ROW_TERMS", K - 1)
    with pytest.raises(ValueError, match="records per lane"):
        trd.build_mulacc_walk(fresh)


def _elems(shape, rng):
    """Canonical residues mod P as (..., 16) int64 16-bit limbs."""
    x = rng.integers(0, 1 << 16, tuple(shape) + (NL,), dtype=np.int64)
    x[..., -1] = rng.integers(0, P >> 240, tuple(shape))
    return x


def test_walk_matvec_matches_reference():
    """L = 3000 records over 64 rows per matrix block, B = 2."""
    rng = np.random.default_rng(21)
    n, m, L, B = 64, 40, 3000, 2
    rows = np.sort(rng.integers(0, 3 * n, size=L)).astype(np.int64)
    cols = rng.integers(0, m, size=L).astype(np.int64)
    coeff = _elems((L,), rng)
    Z_mont = _elems((B, m), rng)

    jf = jfield_ops(P)
    vals = jf.mul_(jnp.asarray(coeff.astype(np.uint32))[None], jnp.take(jnp.asarray(Z_mont.astype(np.uint32)),
                                                                         jnp.asarray(cols), axis=1))
    want = jf.reduce_wide_(jax.vmap(lambda v: jax.ops.segment_sum(
        v, jnp.asarray(rows), num_segments=3 * n, indices_are_sorted=True))(vals))

    # the three matrix blocks of one record stream, as R1CSDevice holds them
    blocks = [(rows >= k * n) & (rows < (k + 1) * n) for k in range(3)]
    coo = [trd.COOMatrix(torch.as_tensor(rows[b] - k * n), torch.as_tensor(cols[b]), torch.as_tensor(coeff[b]),
                         n, rows_np=rows[b] - k * n, cols_np=cols[b], coeff_np=coeff[b])
           for k, b in enumerate(blocks)]
    dev = trd.R1CSDevice(CURVE, n, 1, m - 1, *coo)
    before = dict(pf.LAUNCHES)
    got = tg._matvec_walk(P, dev, torch.as_tensor(Z_mont))
    assert dict(pf.LAUNCHES) == before  # the plain version ran: no launch
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert torch.equal(got, tg._matvec_coo(P, dev, torch.as_tensor(Z_mont)))


SRC = (
    "def main(private field x0, field y) -> field {\n"
    "    field mut x = x0;\n"
    "    for u32 i in 0..20 { x = x * x + y; }\n"
    "    return x;\n"
    "}"
)


def test_walk_h_stage_matches_reference(monkeypatch):
    from zokrates_tpu.interp.interpreter import Interpreter
    from zokrates_tpu.ir.r1cs import r1cs_from_prog
    from zokrates_tpu.lang.compile import compile_source
    from zokrates_tpu.schemes import groth16 as jg

    prog = compile_source(SRC, curve=CURVE).prog
    r1cs = r1cs_from_prog(prog)
    n = 1 << (r1cs.num_constraints + r1cs.num_instance - 1).bit_length()
    zs = [r1cs.full_assignment(Interpreter().execute(prog, [x, 7])) for x in (3, 4)]
    tr = convert.r1cs(CURVE, r1cs.num_instance, r1cs.num_witness, r1cs.A, r1cs.B, r1cs.C, r1cs.ir_to_dense)
    tdev = trd.R1CSDevice.build(tr, n, device="cpu")
    from zokrates_tpu_torch.fields.limbs import ints_to_limbs

    Z = torch.as_tensor(np.stack([ints_to_limbs(z, NL) for z in zs]).astype(np.int64))
    monkeypatch.setattr(tg, "_matvec_kind", lambda device: "walk")  # the CUDA device's matvec
    got = tg._h_stage(CURVE, tdev, Z)
    jdev = jg._r1cs_device(r1cs, n)
    fn = jg._h_stage(CURVE, n)
    for b, z in enumerate(zs):
        want = fn(*jg._coo_args(jdev), jnp.asarray(ints_to_limbs(z, NL)))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want).astype(np.int64))


def test_mulacc_walk_checks_its_arguments():
    z = torch.zeros((2, 4, NL, 8), dtype=torch.int64)
    coeff = torch.zeros((4, NL, 8), dtype=torch.int64)
    flags = torch.zeros((4, 8), dtype=torch.int32)
    before = dict(pf.LAUNCHES)
    assert pf.mulacc_walk(P, z, coeff, flags).shape == (2, 4, NL, 8)
    assert dict(pf.LAUNCHES) == before
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z[0], coeff, flags)                     # not 4-d
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z, coeff[:3], flags)                    # K differs
    with pytest.raises(TypeError):
        pf.mulacc_walk(P, z, coeff, flags.to(torch.int64))        # flags dtype
    with pytest.raises(TypeError):
        pf.mulacc_walk(P, z.to(torch.int32), coeff, flags)        # z dtype
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, torch.zeros((2, 4, 8, NL), dtype=torch.int64).permute(0, 1, 3, 2),
                       coeff, flags)                              # not contiguous
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z, coeff, flags.to("meta"))             # another device


def test_mulacc_walk_plain_flushes():
    """Snapshots restart after a flagged record, per lane: against a loop."""
    rng = np.random.default_rng(5)
    B, K, M = 2, 7, 5
    z = torch.as_tensor(_elems((B, K, M), rng)).permute(0, 1, 3, 2).contiguous()
    coeff = torch.as_tensor(_elems((K, M), rng)).permute(0, 2, 1).contiguous()
    flags = torch.as_tensor((rng.random((K, M)) < 0.4).astype(np.int32))
    got = pf.mulacc_walk(P, z, coeff, flags)
    f = tg.field_ops(P)
    acc = torch.zeros((B, NL, M), dtype=torch.int64)
    for k in range(K):
        acc = acc + f.mul(z[:, k].transpose(1, 2), coeff[k].T[None]).transpose(1, 2)
        assert torch.equal(got[:, k], acc), k
        acc = torch.where(flags[k].bool()[None, None], 0, acc)
