"""The port's elementwise field kernels (zokrates_tpu_torch.kernels.
pallas_field.emul and ereduce_wide) on the CPU, where the wrappers run
their plain versions, against the JAX package's field ops
(zokrates_tpu.fields.jfield: mul_, reduce_wide_) over BN254's scalar field.

  * emul with b shared by the batch, per batch, one row for every element
    (row stride 0), and a taken in place from a larger tensor (a batch
    stride that is not L*nl), as the h stage calls it;
  * ereduce_wide on lazy column sums up to 2^31 (the reference's u32
    headroom);
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


def _elems(shape, seed):
    """Canonical residues as (..., 16) 16-bit limbs: random low limbs and a
    top limb below p's, so every value is below p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, tuple(shape) + (NL,), dtype=np.int64)
    x[..., -1] = rng.integers(0, P >> 240, tuple(shape))
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


@pytest.mark.parametrize("top", [1 << 16, 1 << 31], ids=["small", "near_2^31"])
def test_ereduce_wide_matches_reference(jf, top):
    rng = np.random.default_rng(6)
    t = rng.integers(0, top, (2, 50, NL), dtype=np.int64)
    t[0, 0] = top - 1  # the largest sums in every column
    t[0, 1] = 0
    want = np.asarray(jax.jit(jf.reduce_wide_)(jnp.asarray(t.astype(np.uint32))))
    got = pf.ereduce_wide(P, torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


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
