"""The MPC ceremony's batched ladders (zokrates_tpu_torch.kernels.ladder) on
the CPU, where mixed_add_lm and accumulate_lm run their plain versions,
against Python-int point arithmetic (zokrates_tpu_torch.ec.curve):

  * glv_split recombines to k mod r with halves of at most 128 bits, on
    every curve with a G1 (random k and k = 1, 2, r - 1, (r - 1) / 2);
  * scale_terms, a scalar a point: coefficients 1, small, r - small (the
    negated point) and mixed bit lengths, in the input order;
  * column_sums_g1: a column longer than a piece (ladder.PIECE), a column
    whose points cancel, an empty column and short ones.

Inputs from seeded generators. Tolerance: exact equality of the affine
coordinates. scale_affine, a scalar for all points, is held to the JAX
package's contributions in tests/test_torch_mpc.py and
tests/test_torch_bellman_mpc.py.
"""

import random

import numpy as np
import pytest
import torch

from zokrates_tpu_torch.ec.curve import g1_group
from zokrates_tpu_torch.kernels import ladder
from zokrates_tpu_torch.kernels.jec import curve_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several test processes side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("curve", ["bn128", "bls12_381", "bls12_377", "pallas", "vesta"])
def test_glv_split(curve):
    r = g1_group(curve).r
    lam = ladder.glv(curve)[1]
    rng = random.Random(31)
    for k in [rng.randrange(1, r) for _ in range(200)] + [1, 2, r - 1, (r - 1) // 2]:
        k1, k2 = ladder.glv_split(curve, k)
        assert (k1 + k2 * lam - k) % r == 0
        assert max(abs(k1), abs(k2)).bit_length() <= 128


def _encode(ops, pts):
    return ops.f.encode([p.x for p in pts]), ops.f.encode([p.y for p in pts])


def test_scale_terms_matches_host():
    grp = g1_group("bn128")
    ops = curve_ops(grp.q)
    rng = random.Random(32)
    pts = [grp.generator() * rng.randrange(1, grp.r) for _ in range(40)]
    ks = [rng.choice([1, 2, 5, grp.r - 1, grp.r - 7, rng.randrange(1, 1 << 12), grp.r - rng.randrange(1, 1 << 12)])
          for _ in pts]
    got = ops.to_affine_ints(ladder.scale_terms(ops, ladder.g1_adder(grp.q), *_encode(ops, pts), ks, grp.r))
    assert got == [((p * k).x, (p * k).y) for p, k in zip(pts, ks)]


def test_column_sums_in_pieces_match_host():
    grp = g1_group("bn128")
    ops = curve_ops(grp.q)
    rng = random.Random(33)
    base = [grp.generator() * rng.randrange(1, grp.r) for _ in range(8)]
    long = 2 * ladder.PIECE + 5
    pts = [base[i % 8] * (i + 1) for i in range(long + 30)]
    cols = [0] * long + [rng.randrange(2, 6) for _ in range(30)]
    pts += [pts[0], -pts[0]]
    cols += [6, 6]  # P + (-P)
    sums, (lanes, steps) = ladder.column_sums_g1(grp.q, *_encode(ops, pts), np.asarray(cols), 8)
    got = ops.to_affine_ints(sums)
    for c in range(8):
        acc = grp.zero()
        for p, cc in zip(pts, cols):
            if cc == c:
                acc = acc + p
        assert got[c] == (None if acc.infinity else (acc.x, acc.y)), c
    assert got[1] is None and got[6] is None and got[7] is None
    assert steps <= ladder.PIECE < long
