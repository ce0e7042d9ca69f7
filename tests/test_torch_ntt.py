"""The port's radix-2 NTT Domain (zokrates_tpu_torch.kernels.ntt) against the
JAX package's (zokrates_tpu.kernels.ntt) at n = 2^10 over bn128's scalar
field: fft, ifft, coset_fft and coset_ifft on a batch of two seeded random
polynomials in Montgomery limbs. Also the whole-transform kernel's side
(zokrates_tpu_torch.kernels.ntt_pallas): its pass tiling and twiddle
table, replayed on the CPU with the plain field ops, against the JAX
transform; the fft_core wrapper's checks; and that Domain's transforms go
through that wrapper.

Tolerance: exact equality of the limb arrays (field elements are integers).
"""

import jax
import numpy as np
import pytest
import torch

from zokrates_tpu.fields import params as JP
from zokrates_tpu.kernels import ntt as jntt
from zokrates_tpu_torch.kernels import ntt as tntt
from zokrates_tpu_torch.kernels import ntt_pallas as tntt_pallas

N = 1 << 10
P = JP.SCALAR_FIELDS["bn128"].p
G = JP.SCALAR_FIELDS["bn128"].smallest_nonresidue


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def domains():
    return jntt.domain_for_curve("bn128", N), tntt.domain_for_curve("bn128", N)


@pytest.fixture(scope="module")
def inputs(domains):
    """(2, N, nl) Montgomery limbs of seeded random field elements."""
    jd, td = domains
    rng = np.random.default_rng(10)
    words = rng.integers(0, 1 << 32, size=(2 * N, 8), dtype=np.uint64)
    xs = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]
    ja = jd.ops.encode(xs).reshape(2, N, -1)
    ta = td.ops.encode(xs).reshape(2, N, -1)
    return ja, ta


def _transform(kind, dom):
    if kind in ("fft", "ifft"):
        return getattr(dom, kind)
    return lambda a: getattr(dom, kind)(a, G)


@pytest.fixture(scope="module")
def reference(domains, inputs):
    """kind -> the JAX Domain's transform of the inputs (compiled once per kind)."""
    jd, _ = domains
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = np.asarray(jax.jit(_transform(kind, jd))(inputs[0])).astype(np.int64)
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_transform_matches_reference(domains, inputs, reference, kind):
    got = _transform(kind, domains[1])(inputs[1])
    np.testing.assert_array_equal(reference(kind), got.numpy())


def test_domain_constants(domains):
    jd, td = domains
    assert (td.omega, td.omega_inv, td.n_inv) == (jd.omega, jd.omega_inv, jd.n_inv)
    np.testing.assert_array_equal(td.bitrev, np.asarray(jd.bitrev))


def test_round_trips(domains, inputs):
    """ifft(fft(x)) == x and coset_ifft(coset_fft(x)) == x."""
    _, td = domains
    _, ta = inputs
    assert torch.equal(td.ifft(td.fft(ta)), ta)
    assert torch.equal(td.coset_ifft(td.coset_fft(ta, G), G), ta)


def test_rejects_bad_sizes():
    with pytest.raises(ValueError):
        tntt.Domain(P, 3 * 256, 5, 28)
    with pytest.raises(ValueError):
        tntt.Domain(P, 1 << 29, 5, 28)


# ---------------------------------------------------------------------------
# the whole-transform kernel's dispatch and its pass tiling
# ---------------------------------------------------------------------------


def _kernel_passes(dom, x, inverse, plan):
    """The index arithmetic of csrc/ntt.cu's pass kernel, replayed with the
    plain field ops: per pass, every block's tiles gathered (the first pass
    reading the input in bit-reversed order, padding slots left out), the
    tile's twiddles from the kernel's (n-1, 8) table, then each stage with
    the thread-to-element map of ntt_pallas.thread_maps (a thread the
    butterfly of its element with the stage's bit clear), and the tiles
    written back. Asserts that each pass's blocks cover every (transform,
    element) once and that each stage's threads cover every element of a
    block once."""
    f = dom.ops
    n, k = dom.n, dom.k
    batch = x.shape[0]
    tw32 = torch.as_tensor(tntt_pallas._tw_tables(dom, inverse).astype(np.int64))
    tw16 = torch.stack([tw32 & 0xFFFF, tw32 >> 16], dim=-1).reshape(n - 1, 16)
    rev = torch.as_tensor(dom.bitrev)
    buf = torch.zeros_like(x)
    for s0, s1, log_slots in plan:
        S = s1 - s0
        T, nE = 1 << S, 1 << (S + log_slots)
        hi_bits = k - s1
        pairs = batch << hi_bits
        nblocks = ((pairs + (1 << log_slots) - 1) >> log_slots) << s0
        blk, E = torch.arange(nblocks), torch.arange(nE)
        lo = blk & ((1 << s0) - 1)
        pair = ((blk >> s0) << log_slots)[:, None] | (E >> S)[None]
        bat, hi = pair >> hi_bits, pair & ((1 << hi_bits) - 1)
        g = (hi << s1) | ((E & (T - 1)) << s0)[None] | lo[:, None]
        valid = bat < batch
        assert torch.equal((bat * n + g)[valid].sort().values, torch.arange(batch * n))
        tile = torch.zeros((nblocks, nE, 16), dtype=torch.int64)
        src = x[bat[valid], rev[g[valid]]] if s0 == 0 else buf[bat[valid], g[valid]]
        tile[valid] = src
        ti = torch.arange(1, T)
        t_of = torch.floor(torch.log2(ti.double())).long()
        J = ((1 << (s0 + t_of)) - 1)[None] + ((((ti - (1 << t_of)) << s0)[None]) | lo[:, None])
        ws = torch.zeros((nblocks, T, 16), dtype=torch.int64)
        ws[:, 1:] = tw16[J]
        tid = torch.arange(nE // 2)
        for t, tpos in tntt_pallas.thread_maps(S, log_slots):
            assert len(tpos) == S + log_slots - 1 and t not in tpos
            e0 = sum(((tid >> b) & 1) << p for b, p in enumerate(tpos))
            e1 = e0 | (1 << t)
            assert torch.equal(torch.cat([e0, e1]).sort().values, E)
            w = ws[:, (1 << t) | (e0 & ((1 << t) - 1))]
            u = f.mul(tile[:, e1], w)
            xe = tile[:, e0]
            tile[:, e0], tile[:, e1] = f.add(xe, u), f.sub(xe, u)
        buf[bat[valid], g[valid]] = tile[valid]
    return buf


@pytest.fixture(scope="module")
def jax_cores(domains, inputs):
    """The JAX transforms without the 1/n scaling, forward and inverse."""
    jd, _ = domains
    fwd = jax.jit(lambda a: jd._fft_core(a, jd._tw))(inputs[0])
    inv = jax.jit(lambda a: jd._fft_core(a, jd._tw_inv))(inputs[0])
    return {False: np.asarray(fwd).astype(np.int64), True: np.asarray(inv).astype(np.int64)}


PLANS = {  # (s0, s1, log2 tiles a block) per pass, from ntt_pallas.pass_plan or written out
    "1pass": tntt_pallas.pass_plan(10, 2),
    # two passes of 5 stages, 8 tiles a block: each transform's 32
    # first-pass tiles split across 4 blocks, 6 padding slots in each
    # second-pass block
    "2passes": [(0, 5, 3), (5, 10, 3)],
    # 3 + 3 + 4 stages, 32, 32 and 2 tiles a block
    "3passes": [(0, 3, 5), (3, 6, 5), (6, 10, 1)],
    # passes of 2, 3, 4 and 1 stages, blocks of 256 to 1024 elements
    "4passes": [(0, 2, 6), (2, 5, 5), (5, 9, 4), (9, 10, 7)],
}


def test_pass_plans():
    """The plan shapes: passes of at most 10 stages split evenly, larger
    last, blocks of 256 to 1024 elements, as many tiles a block as keep two
    blocks an SM on the batches the prove runs."""
    assert tntt_pallas.pass_plan(10, 1) == [(0, 10, 0)]
    assert tntt_pallas.pass_plan(15, 1) == [(0, 7, 1), (7, 15, 0)]
    assert tntt_pallas.pass_plan(15, 48) == [(0, 7, 1), (7, 15, 0)]
    assert tntt_pallas.pass_plan(16, 2) == [(0, 8, 0), (8, 16, 0)]
    assert tntt_pallas.pass_plan(25, 1) == [(0, 8, 0), (8, 16, 0), (16, 25, 0)]
    assert tntt_pallas.pass_plan(2, 3) == [(0, 2, 1)]  # 2 of 3 transforms a block
    for k in range(1, 26):
        for batch in (1, 3, 16, 48):
            plan = tntt_pallas.pass_plan(k, batch)
            assert [s1 for _, s1, _ in plan][-1] == k and len(plan) == -(-k // 10)
            for s0, s1, log_slots in plan:
                E = 1 << (s1 - s0 + log_slots)
                pairs = batch << (k - s1)  # the tiles of one low position
                assert E <= max(256, 1 << (s1 - s0)) and (E >= 256 or 1 << log_slots <= pairs < 2 << log_slots)
                stages = tntt_pallas.thread_maps(s1 - s0, log_slots)
                assert [t for t, _ in stages] == list(range(s1 - s0))
                lanes = stages[0][1][:5]
                assert len({b % 5 for b in lanes}) == 5 or s1 - s0 + log_slots < 10


@pytest.mark.parametrize("inverse,plan", [(False, "1pass"), (True, "1pass"), (False, "2passes"),
                                          (True, "3passes"), (False, "4passes")])
def test_pass_tiling_matches_reference(domains, inputs, jax_cores, inverse, plan):
    """One pass of 10 stages (the prove's blocks at 2^10), and plans of 2,
    3 and 4 passes whose blocks hold several tiles: of both transforms, of
    several high positions, padding past the batch."""
    got = _kernel_passes(domains[1], inputs[1], inverse, PLANS[plan])
    np.testing.assert_array_equal(jax_cores[inverse], got.numpy())


def test_pass_plan_matches_plain_at_2_12():
    """pass_plan's own plan for 3 transforms of 2^12 (two passes of 6
    stages, 4 and 2 tiles a block, a padding slot in the last second-pass
    block) against the plain stage loop."""
    dom = tntt.domain_for_curve("bn128", 1 << 12)
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, (3, 1 << 12, 16), dtype=np.int64)
    x[..., -1] = rng.integers(0, P >> 240, (3, 1 << 12))
    x = torch.as_tensor(x)
    plan = tntt_pallas.pass_plan(12, 3)
    assert plan == [(0, 6, 2), (6, 12, 1)]
    for inverse in (False, True):
        assert torch.equal(_kernel_passes(dom, x, inverse, plan), tntt_pallas.fft_core_plain(dom, x, inverse))


def test_fft_core_wrapper(domains, inputs):
    _, td = domains
    _, ta = inputs
    tntt_pallas.LAUNCHES.clear()
    got = tntt_pallas.fft_core(td, ta, False)
    assert torch.equal(got, tntt_pallas.fft_core_plain(td, ta, False))
    assert sum(tntt_pallas.LAUNCHES.values()) == 0  # the plain version: no launch
    with pytest.raises(TypeError):
        tntt_pallas.fft_core(td, ta.to(torch.int32), False)
    with pytest.raises(ValueError):
        tntt_pallas.fft_core(td, ta[:, : N // 2], False)
    with pytest.raises(ValueError):
        tntt_pallas.fft_core(td, ta.transpose(0, 1), False)
    with pytest.raises(ValueError):
        tntt_pallas.fft_core(td, ta.to("meta"), False)


@pytest.mark.parametrize("kind", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_domain_transforms_go_through_fft_core(domains, inputs, reference, kind, monkeypatch):
    """Every Domain transform runs its butterflies through the fft_core
    wrapper (the kernel on the card), once, whatever the domain's size."""
    calls = []

    def recording(dom, x, inverse):
        calls.append((dom.n, inverse))
        return tntt_pallas.fft_core(dom, x, inverse)

    monkeypatch.setattr(tntt, "fft_core", recording)
    got = _transform(kind, domains[1])(inputs[1])
    assert calls == [(N, kind in ("ifft", "coset_ifft"))]
    np.testing.assert_array_equal(reference(kind), got.numpy())
