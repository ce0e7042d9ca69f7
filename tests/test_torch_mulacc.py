"""The port's fused sparse matvec on the CPU, where the kernel wrapper runs
its plain version, against the JAX package:

  * ir/r1cs_device.build_mulacc_walk: at the reference's 1024 lanes the
    walk layout's arrays (cols, coeff_walk, flags_walk, pos, seg) equal
    the JAX package's for a seeded random constraint system whose rows
    span lane boundaries, and the kernel's arrays (cols_walk,
    coeff_packed, lane_base) are those arrays in its layout; a lane count
    K above MAX_ROW_TERMS raises (the reference asserts no bound);
  * the walk matvec (groth16._matvec_walk: kernels/pallas_field.
    mulacc_walk, ereduce_wide, the per-row sum, ereduce_wide) equals the
    JAX COO matvec (gather, mul_, segment_sum, reduce_wide_) and the
    port's _matvec_coo at L = 3000 records and B = 2, the case of
    tests/test_kernels.py's test_mulacc_walk_matvec, on plans of 1024 and
    4096 lanes;
  * the h stage with the walk matvec equals the JAX _h_stage on a toy
    circuit compiled with zokrates_tpu.lang;
  * mulacc_walk_plain equals the reference's per-record snapshot
    (replayed here record by record, the accumulator reset after each
    flagged record) gathered at the flush positions, pad slots 0;
  * the CUDA kernel's slot rule (csrc/mulacc.cu), replayed over the flag
    patterns of random plans at 1024 to 8192 lanes, lanes ending in
    padding included: lane m's i-th flush goes to slot lane_base[m] + i,
    which is the slot whose pos is that record; every flush slot is
    written once, the pad slots are the ones the threads zero; a warp's
    flushes staged in shared memory (flush_warp, stage_word) come back
    to their slots' words, and the staging's 16-byte writes spread over
    the banks;
  * groth16.walk_lanes; mulacc_walk's argument checks, and that CPU calls
    count no launch.

Inputs come from seeded numpy generators. Tolerance: exact equality of
every limb.
"""

import dataclasses
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
    assert got is trd.build_mulacc_walk(tdev, 1024)  # cached on the device, per lane count
    assert (got.K, got.R, got.S, got.M, got.n_rows) == (want.K, want.R, want.S, want.M, want.n_rows)
    assert got.K > got.R  # several steps per lane, so runs cross lane ends
    K, M = got.K, got.M
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.coeff_walk.numpy(), np.asarray(want.coeff_walk).reshape(K, NL, M))
    np.testing.assert_array_equal(got.flags_walk.numpy(), np.asarray(want.flags_walk).reshape(K, M))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    # the kernel's arrays: the same records in its layout
    np.testing.assert_array_equal(got.cols_walk.numpy(), np.asarray(want.cols).reshape(M, K).T)
    cw = np.asarray(want.coeff_walk).reshape(K, NL, M).astype(np.int64)
    np.testing.assert_array_equal(got.coeff_packed.numpy().view(np.uint32), cw[:, 0::2] | (cw[:, 1::2] << 16))
    pos = np.asarray(want.pos)
    assert got.n_flush == np.count_nonzero(np.asarray(want.flags_walk))
    assert (pos[got.n_flush:] == K * M - 1).all()
    np.testing.assert_array_equal(got.lane_base.numpy(), np.searchsorted(pos[: got.n_flush], np.arange(M) * K))


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


def _toy_matvec(rng, n, m, L):
    """A row-sorted record stream over 3n rows as R1CSDevice holds it (its
    three matrix blocks), rows, cols and Montgomery coefficients."""
    rows = np.sort(rng.integers(0, 3 * n, size=L)).astype(np.int64)
    cols = rng.integers(0, m, size=L).astype(np.int64)
    coeff = _elems((L,), rng)
    blocks = [(rows >= k * n) & (rows < (k + 1) * n) for k in range(3)]
    coo = [trd.COOMatrix(torch.as_tensor(rows[b] - k * n), torch.as_tensor(cols[b]), torch.as_tensor(coeff[b]),
                         n, rows_np=rows[b] - k * n, cols_np=cols[b], coeff_np=coeff[b])
           for k, b in enumerate(blocks)]
    return trd.R1CSDevice(CURVE, n, 1, m - 1, *coo), rows, cols, coeff


@pytest.mark.parametrize("lanes", [1024, 4096])
def test_walk_matvec_matches_reference(lanes):
    """L = 3000 records over 64 rows per matrix block, B = 2."""
    rng = np.random.default_rng(21)
    n, m, L, B = 64, 40, 3000, 2
    dev, rows, cols, coeff = _toy_matvec(rng, n, m, L)
    Z_mont = _elems((B, m), rng)

    jf = jfield_ops(P)
    vals = jf.mul_(jnp.asarray(coeff.astype(np.uint32))[None], jnp.take(jnp.asarray(Z_mont.astype(np.uint32)),
                                                                         jnp.asarray(cols), axis=1))
    want = jf.reduce_wide_(jax.vmap(lambda v: jax.ops.segment_sum(
        v, jnp.asarray(rows), num_segments=3 * n, indices_are_sorted=True))(vals))

    before = dict(pf.LAUNCHES)
    got = tg._matvec_walk(P, dev, torch.as_tensor(Z_mont), lanes)
    assert dict(pf.LAUNCHES) == before  # the plain version ran: no launch
    assert trd.build_mulacc_walk(dev, lanes).M == lanes
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
    rng = np.random.default_rng(4)
    dev, *_ = _toy_matvec(rng, 16, 8, 200)
    w = trd.build_mulacc_walk(dev)
    z = torch.as_tensor(_elems((2, 8), rng))
    before = dict(pf.LAUNCHES)
    assert pf.mulacc_walk(P, z, w).shape == (2, w.pos.numel(), NL)
    assert dict(pf.LAUNCHES) == before
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z[0], w)                                  # not 3-d
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z[..., :8], w)                            # not nl limbs
    with pytest.raises(TypeError):
        pf.mulacc_walk(P, z.to(torch.int32), w)                     # z dtype
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z.transpose(0, 1).contiguous().transpose(0, 1), w)  # not contiguous
    with pytest.raises(ValueError):
        pf.mulacc_walk(P, z.to("meta"), w)                          # another device
    with pytest.raises(ValueError, match="variables"):
        pf.mulacc_walk(P, z[:, : w.n_cols - 1].contiguous(), w)     # fewer variables than the walk reads
    for name, bad, err in (("flags_walk", w.flags_walk.to(torch.int64), TypeError),      # flags dtype
                           ("cols_walk", w.cols_walk[:-1], ValueError),                  # K differs
                           ("lane_base", w.lane_base[:-1], ValueError),                  # M differs
                           ("coeff_packed", w.coeff_walk, TypeError)):                   # not packed
        with pytest.raises(err, match=name):
            pf.mulacc_walk(P, z, dataclasses.replace(w, **{name: bad}))
    with pytest.raises(ValueError, match="lanes"):
        trd.build_mulacc_walk(dev, 3000)                            # not a power of two


def _snapshot(Z_mont, w):
    """The reference's per-record snapshot over the walk: per lane, the
    accumulator after each record's product is added, reset to 0 after a
    flagged record. (B, K, M, nl)."""
    B = Z_mont.shape[0]
    K, M = w.K, w.M
    f = tg.field_ops(P)
    cols = w.cols.view(M, K)
    acc = torch.zeros((B, M, NL), dtype=torch.int64)
    snap = torch.empty((B, K, M, NL), dtype=torch.int64)
    for k in range(K):
        acc = acc + f.mul(Z_mont[:, cols[:, k]], w.coeff_walk[k].T)
        snap[:, k] = acc
        acc = torch.where(w.flags_walk[k].bool()[None, :, None], 0, acc)
    return snap


@pytest.mark.parametrize("lanes", [1024, 2048])
def test_mulacc_walk_plain_flushes(lanes):
    """mulacc_walk_plain against the reference's snapshot gathered at the
    flush positions (record j of the stream is lane j // K's step j % K),
    pad slots 0."""
    rng = np.random.default_rng(5)
    dev, *_ = _toy_matvec(rng, 40, 30, 5000)
    w = trd.build_mulacc_walk(dev, lanes)
    Z_mont = torch.as_tensor(_elems((2, 30), rng))
    got = pf.mulacc_walk(P, Z_mont, w)
    snap = _snapshot(Z_mont, w)
    nf = w.n_flush
    assert 0 < nf < w.pos.numel()  # pad slots present
    pos = w.pos[:nf]
    assert torch.equal(got[:, :nf], snap[:, pos % w.K, pos // w.K])
    assert not got[:, nf:].any()
    assert not got[:, w.n_row_flush:].any()  # the padded records' runs and the pad slots: row 3n
    assert (w.seg[w.n_row_flush:] == w.n_rows).all() and (w.seg[: w.n_row_flush] < w.n_rows).all()


@pytest.mark.parametrize("lanes,seed,L", [(1024, 0, 5000), (1024, 1, 1024 * 8), (2048, 2, 20000), (8192, 3, 9000)])
def test_mulacc_slot_rule_replay(lanes, seed, L):
    """csrc/mulacc.cu's slot rule replayed over a random plan's flags:
    thread m counts its flushes and writes its i-th to slot lane_base[m] +
    i; that slot's pos is the record flushed, every slot below n_flush is
    written once, and the slots the threads zero (n_flush + m, + M, ...
    below P) are the rest. Each warp's flushes of a step, staged by rank
    (flush_warp), are stored word by word to their slots. Records the kernel skips (past L, with no
    product) have coefficient 0; rows of 1-3 records per matrix row in a
    lane, lanes ending in padding (L not a multiple of M*K), and L = M*K
    (no padding)."""
    rng = np.random.default_rng(40 + seed)
    dev, *_ = _toy_matvec(rng, max(L // 6, 1), 50, L)
    w = trd.build_mulacc_walk(dev, lanes)
    K, M, nf, P_ = w.K, w.M, w.n_flush, w.pos.numel()
    assert w.n_records == L
    flags = w.flags_walk.numpy().astype(bool)
    base = w.lane_base.numpy().astype(np.int64)
    pos = w.pos.numpy()
    written = np.zeros(P_, np.int64)
    count = np.zeros(M, np.int64)
    lanes_idx = np.arange(M)
    for k in range(K):
        m = lanes_idx[flags[k]]
        slot = base[m] + count[m]
        np.testing.assert_array_equal(pos[slot], m * K + k)
        written[slot] += 1
        count[m] += 1
    assert (written[:nf] == 1).all() and not written[nf:].any()
    # flush_warp: a warp's flushes of one step staged by rank, then stored
    # 32 words a store; every staged word comes back to its slot's word
    for k in range(K):
        for w0 in range(0, M, 32):
            f = flags[k, w0:w0 + 32]
            e = np.cumsum(f) - 1                      # rank among the warp's flushing threads
            staged = {_stage_word(int(r), wd): (int(t), wd) for t, r in zip(np.nonzero(f)[0], e[f]) for wd in range(16)}
            nfl = int(f.sum())
            assert len(staged) == 16 * nfl
            for q in range(nfl * 16):                 # the warp's store loop
                t, wd = staged[_stage_word(q >> 4, q & 15)]
                assert (q >> 4, wd) == (int(e[t]), q & 15)
    zeroed = np.zeros(P_, np.int64)
    for m in range(M):
        zeroed[nf + m: P_: M] += 1
    assert (zeroed[nf:] == 1).all() and not zeroed[:nf].any()
    j = np.arange(M * K)
    assert not w.coeff_packed.numpy().transpose(2, 0, 1).reshape(M * K, NL // 2)[j >= L].any()


def _stage_word(e, w):
    """csrc/mulacc.cu stage_word: the staging-buffer word of word w of
    entry e."""
    return e * 16 + ((((w >> 2) ^ ((e >> 1) & 3)) << 2) | (w & 3))


def test_flush_staging_spreads_banks():
    """Eight consecutive entries' 16-byte chunk j (a quarter warp's
    writes) fall on eight distinct 16-byte bank groups, and each entry's
    chunks are a permutation of its four."""
    for e0 in range(0, 32, 8):
        for j in range(4):
            assert len({(_stage_word(e, 4 * j) // 4) % 8 for e in range(e0, e0 + 8)}) == 8
    for e in range(32):
        assert sorted(_stage_word(e, 4 * j) for j in range(4)) == [16 * e + 4 * j for j in range(4)]


def test_walk_lanes():
    """The measured lane counts by batch size (a batch size between two
    measured ones takes the smaller's), halved while lanes would hold
    fewer than R records on average, down to the reference's 1024."""
    table = tg._WALK_LANES
    assert tg.walk_lanes(1) == table[1] and tg.walk_lanes(16) == table[16]
    assert tg.walk_lanes(3) == table[1] and tg.walk_lanes(48) == table[16]
    assert tg.walk_lanes(1, 405504) == table[1]  # sha256's records
    assert tg.walk_lanes(1, 3000) == 1024
    assert tg.walk_lanes(1, 20000) == min(4096, table[1])
