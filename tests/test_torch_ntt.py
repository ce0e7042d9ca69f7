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
    plain field ops: per pass, every tile's elements gathered (the first
    pass reading the input in bit-reversed order), the pass's butterflies
    with the twiddles of the kernel's (8, n-1) table, and the tile written
    back. Asserts that each pass's tiles cover every element once."""
    f = dom.ops
    n = dom.n
    tw32 = torch.as_tensor(tntt_pallas._tw_tables(dom, inverse).T.astype(np.int64))
    tw16 = torch.stack([tw32 & 0xFFFF, tw32 >> 16], dim=-1).reshape(n - 1, 16)
    buf = x[:, torch.as_tensor(dom.bitrev)].clone()
    for s0, s1, logT in plan:
        logC = logT - (s1 - s0)
        C = 1 << logC
        chunk_bits = s0 - logC
        blk = torch.arange(n >> logT)
        lo0 = (blk & ((1 << chunk_bits) - 1)) << logC
        base = ((blk >> chunk_bits) << s1) | lo0
        e = torch.arange(1 << logT)
        g = base[:, None] | ((e >> logC) << s0)[None] | (e & (C - 1))[None]
        assert torch.equal(g.flatten().sort().values, torch.arange(n))
        tile = buf[:, g]
        for t in range(s1 - s0):
            b = torch.arange(1 << (logT - 1))
            hp, c = b >> logC, b & (C - 1)
            hj = hp & ((1 << t) - 1)
            ie = ((((hp >> t) << (t + 1)) | hj) << logC) | c
            io = ie + (1 << (t + logC))
            j = ((hj << s0) | c)[None] | lo0[:, None]
            u = f.mul(tile[:, :, io], tw16[(1 << (s0 + t)) - 1 + j])
            xe = tile[:, :, ie]
            tile[:, :, ie], tile[:, :, io] = f.add(xe, u), f.sub(xe, u)
        buf[:, g] = tile
    return buf


@pytest.fixture(scope="module")
def jax_cores(domains, inputs):
    """The JAX transforms without the 1/n scaling, forward and inverse."""
    jd, _ = domains
    fwd = jax.jit(lambda a: jd._fft_core(a, jd._tw))(inputs[0])
    inv = jax.jit(lambda a: jd._fft_core(a, jd._tw_inv))(inputs[0])
    return {False: np.asarray(fwd).astype(np.int64), True: np.asarray(inv).astype(np.int64)}


PLANS = {  # (s0, s1, log2 tile) per pass, as ntt_pallas.pass_plan gives them
    "1pass": tntt_pallas.pass_plan(10),
    "3passes": [(0, 4, 4), (4, 8, 4), (8, 10, 4)],
    "4passes": [(0, 3, 3), (3, 6, 3), (6, 9, 3), (9, 10, 3)],
}


@pytest.mark.parametrize("inverse,plan", [(False, "1pass"), (True, "1pass"), (False, "3passes"),
                                          (True, "4passes")])
def test_pass_tiling_matches_reference(domains, inputs, jax_cores, inverse, plan):
    """One pass of 10 stages (the prove's first pass), and 3 or 4 passes of
    at most 4 or 3 stages, whose later tiles take several low positions
    each (as the prove's second pass over 2^15 does)."""
    got = _kernel_passes(domains[1], inputs[1], inverse, PLANS[plan])
    np.testing.assert_array_equal(jax_cores[inverse], got.numpy())


def test_fft_core_wrapper(domains, inputs):
    _, td = domains
    _, ta = inputs
    tntt_pallas.LAUNCHES.clear()
    got = tntt_pallas.fft_core(td, ta, False)
    assert torch.equal(got, tntt_pallas.fft_core_plain(td, ta, False))
    assert sum(tntt_pallas.LAUNCHES.values()) == 0  # the plain version: no launch
    assert tntt_pallas.pass_plan(10) == [(0, 10, 10)]
    assert tntt_pallas.pass_plan(15) == [(0, 10, 10), (10, 15, 10)]
    assert tntt_pallas.pass_plan(25) == [(0, 10, 10), (10, 20, 10), (20, 25, 10)]
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
