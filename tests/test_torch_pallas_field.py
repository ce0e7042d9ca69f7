"""The port's elementwise field kernels (zokrates_tpu_torch.kernels.
pallas_field.emul and ereduce_wide) on the CPU, where the wrappers run
their plain versions, against the JAX package's field ops
(zokrates_tpu.fields.jfield: mul_, reduce_wide_) over BN254's scalar field.

  * emul with b shared by the batch, per batch, one row for every element
    (row stride 0), and a taken in place from a larger tensor (a batch
    stride that is not L*nl), as the h stage calls it;
  * emul over BLS12-381's base field (24 limbs, the width its GM17 proving
    key's queries take on the card) and BW6-761's (48 limbs, its GM17
    key's queries), b shared and one row;
  * the CUDA emul kernel's tile walk (csrc/field_elementwise.cu), replayed
    on the CPU: the persistent blocks' tiles cover every (batch, row) once,
    the kernel's word offsets read a strided a and shared, full and
    stride-0 b, ragged last tiles included (tiles of EMUL_TILE[n32]
    elements: 128 at 8 and 12 32-bit limbs, 64 at 24), and the products
    equal the JAX field product; its shared-memory swizzle sends a quarter
    warp's 16-byte reads to eight distinct bank groups at every width;
  * ereduce_wide on lazy column sums up to 2^31 (the reference's u32
    headroom), and its CUDA kernel's tile walk (emul's over one operand)
    replayed on the CPU: every element once, short last tiles;
  * the wrappers' checks of dtype, shape, layout and device, and that CPU
    calls count no launch.

Inputs: canonical field elements and column sums drawn from seeded numpy
generators. Tolerance: exact equality of every limb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.fields.jfield import field_ops as jfield_ops
from zokrates_tpu_torch.kernels import pallas_field as pf

P = JP.SCALAR_FIELDS["bn128"].p
NL = 16
Q381 = JP.BASE_FIELDS["bls12_381"].p
QBW6 = JP.BASE_FIELDS["bw6_761"].p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jf():
    return jfield_ops(P)


def _elems(shape, seed, p=P, nl=NL):
    """Canonical residues mod p as (..., nl) 16-bit limbs: random low limbs
    and a top limb below p's, so every value is below p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, tuple(shape) + (nl,), dtype=np.int64)
    x[..., -1] = rng.integers(0, p >> (16 * nl - 16), tuple(shape))
    return x


def _jmul(jf, a, b):
    return np.asarray(jax.jit(jf.mul_)(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))))


@pytest.mark.parametrize("kind", ["shared", "per_batch", "row", "strided"])
def test_emul_matches_reference(jf, kind):
    B, L = 3, 40
    a = _elems((B, L), seed=1)
    if kind == "shared":
        b = _elems((L,), seed=2)
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        want = _jmul(jf, a, b[None])
    elif kind == "per_batch":
        b = _elems((B, L), seed=3)
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        want = _jmul(jf, a, b)
    elif kind == "row":
        row = _elems((), seed=4)
        ta, tb = torch.as_tensor(a), torch.as_tensor(row).expand(L, NL)
        assert tb.stride() == (0, 1)
        want = _jmul(jf, a, np.broadcast_to(row, (B, L, NL)))
    else:  # a[:, 0] and a[:, 1] of a (B, 3, L, nl) array, as the h stage's A*B
        abc = _elems((B, 3, L), seed=5)
        ta, tb = torch.as_tensor(abc)[:, 0], torch.as_tensor(abc)[:, 1]
        assert not ta.is_contiguous()
        want = _jmul(jf, abc[:, 0], abc[:, 1])
    got = pf.emul(P, ta, tb)
    assert got.shape == (B, L, NL) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("kind", ["shared", "row"])
def test_emul_24_limbs_matches_reference(kind):
    """BLS12-381's Fq (nl = 24): the queries' conversion to Montgomery form
    (one row, R^2) and a shared table."""
    _check_wide_emul(Q381, 24, kind, 12)


@pytest.mark.parametrize("kind", ["shared", "row"])
def test_emul_48_limbs_matches_reference(kind):
    """BW6-761's Fq (nl = 48): GM17's query points to Montgomery form (one
    row, R^2) and a shared table."""
    _check_wide_emul(QBW6, 48, kind, 15)


def _check_wide_emul(p, nl, kind, seed):
    B, L = 2, 30
    a = _elems((B, L), seed=seed, p=p, nl=nl)
    b = _elems((L,), seed=seed + 1, p=p, nl=nl) if kind == "shared" else _elems((), seed=seed + 2, p=p, nl=nl)
    tb = torch.as_tensor(b) if kind == "shared" else torch.as_tensor(b).expand(L, nl)
    want = _jmul(jfield_ops(p), a, np.broadcast_to(b, (B, L, nl)))
    got = pf.emul(p, torch.as_tensor(a), tb)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _chunk_slot(n32, e, c):
    """csrc/field_elementwise.cu chunk_slot: 16-byte slot of limb c of tile
    element e in shared memory."""
    s = (e & 7) if n32 % 8 == 0 else ((e >> 1) & 3)
    return e * n32 + (c ^ s)


def _emul_tile_walk(B, L, grid, n32, a_bs, b_bs, b_rs):
    """Word offsets that emul_kernel reads and writes, replayed: block
    `blk` of `grid` takes tiles blk, blk + grid, ... of EMUL_TILE[n32] elements
    of one batch row (the last of a row short), copies a's (and, unless b's
    row stride is 0, b's) 16-byte chunks tile by tile, and stores the
    products. Returns (out, a, b) offsets in int64 words of each element's
    first word, by element, in the order the stores go out; b's is the row
    read once a tile where b_rs == 0."""
    TE = pf.EMUL_TILE[n32]
    tpr = -(-L // TE)
    outs, aoffs, boffs = [], [], []
    for blk in range(grid):
        for tile in range(blk, B * tpr, grid):
            bi, r0 = divmod(tile, tpr)
            r0 *= TE
            cnt = min(TE, L - r0)
            q = np.arange(cnt * n32)
            e, c = q // n32, q % n32
            slots = _chunk_slot(n32, e, c)
            assert len(set(slots.tolist())) == cnt * n32 and slots.max() < TE * n32
            ga = bi * a_bs + r0 * 2 * n32 + 2 * q  # the copy's source words, chunk by chunk
            gb = bi * b_bs + r0 * 2 * n32 + 2 * q if b_rs else np.full(cnt * n32, bi * b_bs)
            first = c == 0
            aoffs.append(ga[first])
            boffs.append(gb[first])
            outs.append((bi * L + r0) * 2 * n32 + 2 * q[first])
    return np.concatenate(outs), np.concatenate(aoffs), np.concatenate(boffs)


@pytest.mark.parametrize("n32", [8, 12, 24])
def test_emul_swizzle_spreads_banks(n32):
    """A quarter warp (8 threads, consecutive elements) reading chunk c of
    its own element hits 8 distinct 16-byte bank groups, and the copy's 8
    consecutive chunks land on 8 distinct groups too."""
    TE = pf.EMUL_TILE[n32]
    for e0 in range(0, TE, 8):
        for c in range(n32):
            assert len({_chunk_slot(n32, e, c) % 8 for e in range(e0, e0 + 8)}) == 8
    q = np.arange(TE * n32)
    slots = _chunk_slot(n32, q // n32, q % n32)
    assert all(len(set((slots[i:i + 8] % 8).tolist())) == 8 for i in range(0, len(q), 8))


@pytest.mark.parametrize("kind,L,grid", [("strided", 300, 5), ("shared", 256, 1), ("row", 130, 64),
                                         ("full", 1, 3), ("row24", 200, 2), ("row48", 150, 2),
                                         ("shared48", 64, 1), ("strided48", 70, 3)])
def test_emul_tile_walk_replay(jf, kind, L, grid):
    """The kernel's tile walk over a of a (B, 3, L) tensor's [:, 0] (batch
    stride 3*L*nl), b shared (batch stride 0), full, or one row (row
    stride 0, at 16, 24 and 48 limbs); L ragged (300 = 2 * 128 + 44, 130,
    200; at 48 limbs, tiles of 64: 150 = 2 * 64 + 22, 70) or one tile,
    grids smaller and larger than the tile count. Every (batch, row) is
    stored once, and the products of the words the walk reads equal the
    JAX product."""
    B = 3
    p, nl = (Q381, 24) if kind == "row24" else (QBW6, 48) if kind.endswith("48") else (P, NL)
    kind = kind.rstrip("0123456789")
    n32 = nl // 2
    abc = _elems((B, 3, L), seed=20 + L, p=p, nl=nl)
    a_flat = abc.reshape(-1)
    a_view = abc[:, 0]
    a_bs = 3 * L * nl
    if kind == "strided":
        b_flat, b_bs, b_rs, b_full = a_flat[L * nl:], 3 * L * nl, nl, abc[:, 1]
    elif kind == "shared":
        b = _elems((L,), seed=30, p=p, nl=nl)
        b_flat, b_bs, b_rs, b_full = b.reshape(-1), 0, nl, np.broadcast_to(b, (B, L, nl))
    elif kind == "full":
        b = _elems((B, L), seed=31, p=p, nl=nl)
        b_flat, b_bs, b_rs, b_full = b.reshape(-1), L * nl, nl, b
    else:
        b = _elems((), seed=32, p=p, nl=nl)
        b_flat, b_bs, b_rs, b_full = b.reshape(-1), 0, 0, np.broadcast_to(b, (B, L, nl))
    out_off, a_off, b_off = _emul_tile_walk(B, L, grid, n32, a_bs, b_bs, b_rs)
    assert np.array_equal(np.sort(out_off), np.arange(B * L) * nl)  # every element stored once
    words = np.arange(nl)
    av = a_flat[a_off[:, None] + words]
    bv = b_flat[b_off[:, None] + words]
    got = np.empty(B * L * nl, np.int64)
    got[out_off[:, None] + words] = pf.emul_plain(p, torch.as_tensor(av), torch.as_tensor(bv)).numpy()
    field = jf if p == P else jfield_ops(p)
    want = _jmul(field, np.ascontiguousarray(a_view), np.ascontiguousarray(b_full))
    np.testing.assert_array_equal(got.reshape(B, L, nl), want.astype(np.int64))


@pytest.mark.parametrize("top", [1 << 16, 1 << 31], ids=["small", "near_2^31"])
def test_ereduce_wide_matches_reference(jf, top):
    rng = np.random.default_rng(6)
    t = rng.integers(0, top, (2, 50, NL), dtype=np.int64)
    t[0, 0] = top - 1  # the largest sums in every column
    t[0, 1] = 0
    want = np.asarray(jax.jit(jf.reduce_wide_)(jnp.asarray(t.astype(np.uint32))))
    got = pf.ereduce_wide(P, torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("B,L,grid", [(2, 777, 5), (1, 129, 1), (3, 67, 1), (1, 256, 2), (16, 300, 64)])
def test_ereduce_tile_walk_replay(jf, B, L, grid):
    """ereduce_kernel's tile walk (emul's over one operand, the (B, L)
    sums as one row of B*L elements, word pair c of an element in emul's
    chunk slot c at 8 limbs), replayed: every element is stored once, a
    short last tile included ((2, 777): 12 full tiles and one of 18; (1,
    129): one and one of 1), and the reductions of the words the walk
    reads equal the JAX reduce_wide. The swizzle's bank spread is
    test_emul_swizzle_spreads_banks at n32 = 8. (Totals of one tile or
    less take ereduce_lane_kernel, one thread an element.)"""
    rng = np.random.default_rng(50 + L)
    t = rng.integers(0, 1 << 31, (B, L, NL), dtype=np.int64)
    total = B * L
    out_off, t_off, _ = _emul_tile_walk(1, total, grid, NL // 2, 0, 0, 0)
    assert np.array_equal(np.sort(out_off), np.arange(total) * NL)  # every element stored once
    words = np.arange(NL)
    flat = t.reshape(-1)
    got = np.empty(total * NL, np.int64)
    got[out_off[:, None] + words] = pf.ereduce_wide_plain(P, torch.as_tensor(flat[t_off[:, None] + words])).numpy()
    want = np.asarray(jax.jit(jf.reduce_wide_)(jnp.asarray(t.astype(np.uint32))))
    np.testing.assert_array_equal(got.reshape(B, L, NL), want.astype(np.int64))


def test_wrappers_reject_bad_arguments():
    a = torch.as_tensor(_elems((2, 8), seed=7))
    b = torch.as_tensor(_elems((8,), seed=8))
    with pytest.raises(TypeError):
        pf.emul(P, a.to(torch.int32), b)
    with pytest.raises(TypeError):
        pf.ereduce_wide(P, a.to(torch.int32))
    with pytest.raises(ValueError):
        pf.emul(P, a[0], b)  # a must be (B, L, nl)
    with pytest.raises(ValueError):
        pf.emul(P, a, b[:7])  # L differs
    with pytest.raises(ValueError):
        pf.emul(P, a, torch.as_tensor(_elems((3, 8), seed=9)))  # B differs
    with pytest.raises(ValueError):
        pf.emul(P, a[:, :, :8], b[:, :8])  # not nl limbs
    with pytest.raises(ValueError):
        pf.emul(P, a[:, ::2], b[::2])  # rows not packed
    with pytest.raises(ValueError):
        pf.emul(P, a, b.to("meta"))  # mixed devices
    with pytest.raises(ValueError):
        pf.ereduce_wide(P, a.transpose(0, 1).contiguous().transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError):
        pf.ereduce_wide(P, a.to("meta"))


def test_cpu_calls_count_no_launch():
    pf.LAUNCHES.clear()
    a = torch.as_tensor(_elems((1, 4), seed=10))
    pf.emul(P, a, a[0])
    pf.ereduce_wide(P, a)
    assert sum(pf.LAUNCHES.values()) == 0
