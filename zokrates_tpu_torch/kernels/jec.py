"""Batched elliptic-curve point arithmetic on torch tensors.

The counterpart of the JAX package's kernels/jec.py: every op is
data-parallel over a batch axis of points, in Jacobian coordinates over
the Montgomery-limb field ops of fields/jfield.py (G1) or fields/jfield2.py
(G2). All supported curves have a = 0. Infinity is encoded as Z == 0;
formulas select around the edge cases so the ops are complete over the
batch (no data-dependent branches).

Layout: a point batch is a tuple (X, Y, Z) of (..., nl) int64 tensors
((..., 2, nl) over Fq2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pallas_field import _double_inline, _general_add, _mixed_add_inline

PointBatch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class CurveOps:
    """Batched ops for an a=0 short-Weierstrass group over a field object
    (base field for G1, quadratic extension for G2 — same formulas)."""

    def __init__(self, f):
        self.f = f

    # -- construction ------------------------------------------------------
    def infinity(self, shape=(), device="cpu") -> PointBatch:
        one = self.f.ones_mont(shape, device)
        return (one, one.clone(), self.f.zeros(shape, device))

    def to_affine_ints(self, P: PointBatch):
        """Batch -> host list of (x, y) or None for infinity."""
        X, Y, Z = P
        f = self.f
        zinv = f.inv(Z)
        zinv2 = f.mul(zinv, zinv)
        zinv3 = f.mul(zinv2, zinv)
        ax = f.decode(f.mul(X, zinv2))
        ay = f.decode(f.mul(Y, zinv3))
        inf = f.is_zero(Z).reshape(-1).cpu().numpy()
        return [None if inf[i] else (ax[i], ay[i]) for i in range(len(ax))]

    # -- group law ---------------------------------------------------------
    def double(self, P: PointBatch) -> PointBatch:
        """dbl-2009-l (a=0). Maps infinity to infinity (Z3 = 2YZ = 0)."""
        return _double_inline(self.f, P)

    def add(self, P: PointBatch, Q: PointBatch) -> PointBatch:
        """Complete Jacobian add."""
        return _general_add(self.f, P, Q)

    def mixed_add(self, P: PointBatch, Qx, Qy, q_inf=None) -> PointBatch:
        """P + (Qx, Qy) with Q affine (Z2 = 1); q_inf marks affine slots
        that are infinity."""
        X3, Y3, Z3, _ = _mixed_add_inline(self.f, P, Qx, Qy, with_double=True)
        if q_inf is not None:
            sel = self.f.select
            X3 = sel(q_inf, P[0], X3)
            Y3 = sel(q_inf, P[1], Y3)
            Z3 = sel(q_inf, P[2], Z3)
        return (X3, Y3, Z3)

    def neg(self, P: PointBatch) -> PointBatch:
        X, Y, Z = P
        return (X, self.f.neg(Y), Z)

    def select(self, cond, P: PointBatch, Q: PointBatch) -> PointBatch:
        s = self.f.select
        return (s(cond, P[0], Q[0]), s(cond, P[1], Q[1]), s(cond, P[2], Q[2]))


_CURVE_OPS = {}


def curve_ops(q: int) -> CurveOps:
    """G1 ops for base field q."""
    from ..fields.jfield import field_ops

    key = ("g1", q)
    if key not in _CURVE_OPS:
        _CURVE_OPS[key] = CurveOps(field_ops(q))
    return _CURVE_OPS[key]


def curve_ops_g2(curve: str) -> CurveOps:
    """G2 ops (Jacobian over Fq2) for a pairing curve, or over Fq for
    bw6_761, whose G2 lies over its base field."""
    from ..ec.curve import g2_group
    from ..fields.jfield import field_ops
    from ..fields.jfield2 import field_ops2

    key = ("g2", curve)
    if key not in _CURVE_OPS:
        grp = g2_group(curve)
        f = field_ops2(grp.q, grp.tower.beta) if hasattr(grp, "tower") else field_ops(grp.q)
        _CURVE_OPS[key] = CurveOps(f)
    return _CURVE_OPS[key]
