"""Multi-party trusted-setup ceremony for Groth16 (phase 2).

The counterpart of the JAX package's schemes/mpc.py, itself the functional
equivalent of the reference's bellman MPC backend
(zokrates_bellman/src/groth16.rs:103-159, phase2::MPCParameters): start from
a circuit-specific parameter set, let any number of participants contribute
randomness to delta, and verify the whole chain so the setup is trustworthy
if at least one contributor was honest.

Math (delta-only phase 2): a contribution with secret s updates

    delta_g1 *= s        delta_g2 *= s
    h_query  *= 1/s      l_query  *= 1/s

and publishes pk_s = ([s]G1, [s]G2) plus the running transcript hash.
Verification checks, per contribution i:
    e(pk_s_g1^i, G2)  == e(G1, pk_s_g2^i)                  (same s in G1/G2)
and for the final parameters the deltas' consistency with each other and
with the initial ones, and h_0 against the initial h_0.

On the device: `init` runs groth16.setup there (`from_keys` starts a
ceremony on a key pair already made), and `contribute` scales the
h and l queries by s^-1 in one batched ladder over their packed rows
(kernels/ladder.scale_affine: the mixed_add_lm kernel on a CUDA device),
where the reference multiplies point by point on the host. The deltas,
pk_s, the transcript and verify's few pairings stay host Python.

The CLI surface (mpc init / contribute / beacon / verify / export) matches
zokrates_cli/ops/mpc/*.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field as dfield
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ec.curve import PointG1, g1_group, g2_group
from ..ec.pairing import pairing_product_is_one
from ..fields import params as P
from ..ir.r1cs import R1CS
from . import groth16
from .types import VerificationKey, g2_to_json


@dataclass
class Contribution:
    pk_s_g1: PointG1
    pk_s_g2: object
    transcript: bytes


@dataclass
class MPCParams:
    curve: str
    pk: groth16.ProvingKey
    vk_data: dict
    initial_delta_g1: PointG1
    initial_delta_g2: object
    initial_h: List[Tuple[int, int]]
    initial_l: List[Optional[Tuple[int, int]]]
    contributions: List[Contribution] = dfield(default_factory=list)

    def contribution_hash(self) -> bytes:
        h = hashlib.sha256()
        for c in self.contributions:
            h.update(c.transcript)
        return h.digest()


def init(r1cs: R1CS, rng=None, device="cuda") -> MPCParams:
    """Create the initial (delta = 1 contribution base) parameter set:
    groth16.setup on `device`.

    The reference consumes a phase-1 ("powers of tau") radix file here; this
    setup generates the circuit-specific base directly (the phase-1
    universality concern is orthogonal to the delta ceremony)."""
    return from_keys(*groth16.setup(r1cs, rng=rng, device=device))


def from_keys(pk: groth16.ProvingKey, vk: VerificationKey) -> MPCParams:
    """The initial parameter set on a Groth16 key pair (init's second half):
    the ceremony takes `pk` over and changes it in place."""
    return MPCParams(
        curve=pk.curve,
        pk=pk,
        vk_data=vk.data,
        initial_delta_g1=pk.delta_g1,
        initial_delta_g2=pk.delta_g2,
        initial_h=list(pk.h_query),
        initial_l=list(pk.l_query),
    )


def scale_rows(curve: str, p128: np.ndarray, k: int, device) -> np.ndarray:
    """k * P for every packed G1 row (affine points, none at infinity) in
    one batched ladder on `device`: the new packed rows."""
    from ..kernels.fixed_base import batch_normalize
    from ..kernels.jec import curve_ops
    from ..kernels.ladder import scale_affine
    from ..kernels.msm_sorted import pack_points

    q = P.BASE_FIELDS[curve].p
    ops = curve_ops(q)
    nl = ops.f.nl
    xy = torch.as_tensor(np.ascontiguousarray(p128[:, : 2 * nl]).astype(np.int64), device=device)
    ax, ay, _ = batch_normalize(ops, scale_affine(curve, xy[:, :nl].contiguous(), xy[:, nl:].contiguous(), k))
    return pack_points(q, ax, ay).cpu().numpy().astype(np.uint32)


def _scale_queries(pk: groth16.ProvingKey, k: int, device) -> None:
    """h and l (its real rows; the dummies stay) times k, one ladder."""
    nh = pk.h_p128.shape[0]
    real = np.flatnonzero(pk.l_mask)
    rows = scale_rows(pk.curve, np.concatenate([pk.h_p128, pk.l_p128[real]]), k, device)
    l_p128 = pk.l_p128.copy()
    l_p128[real] = rows[nh:]
    pk.set_h_rows(rows[:nh])
    pk.set_l_rows(l_p128)


def contribute(params: MPCParams, entropy: Optional[str] = None, device="cuda") -> bytes:
    """Apply one participant's randomness; returns the contribution hash."""
    curve = params.curve
    r = P.SCALAR_FIELDS[curve].p
    g1 = g1_group(curve).generator()
    g2 = g2_group(curve).generator()

    seed = (entropy or "").encode() + secrets.token_bytes(32)
    s = int.from_bytes(hashlib.sha512(seed).digest(), "big") % (r - 1) + 1
    s_inv = pow(s, -1, r)

    pk = params.pk
    pk.delta_g1 = pk.delta_g1 * s
    pk.delta_g2 = pk.delta_g2 * s
    _scale_queries(pk, s_inv, device)
    params.vk_data["delta"] = g2_to_json(pk.delta_g2, curve)

    transcript = hashlib.sha256(
        params.contribution_hash()
        + str(pk.delta_g1.x).encode()
        + str(pk.delta_g1.y).encode()
    ).digest()
    params.contributions.append(
        Contribution(pk_s_g1=g1 * s, pk_s_g2=g2 * s, transcript=transcript)
    )
    return transcript


def beacon(params: MPCParams, beacon_hash: str, iterations: int = 10, device="cuda") -> bytes:
    """Final deterministic beacon contribution (e.g. a block hash), applying
    iterated hashing as in the reference's mpc beacon ceremony step."""
    h = bytes.fromhex(beacon_hash)
    for _ in range(1 << min(iterations, 24)):
        h = hashlib.sha256(h).digest()
    return contribute(params, entropy=h.hex(), device=device)


def verify(params: MPCParams, r1cs: R1CS = None) -> bool:
    """Verify the contribution chain: every delta update must be a clean
    scalar multiplication proven by the published (sG1, sG2) pair."""
    curve = params.curve
    grp = g1_group(curve)
    g1 = grp.generator()
    g2 = g2_group(curve).generator()

    for c in params.contributions:
        # same s in both groups: e(sG1, G2) == e(G1, sG2)
        if not pairing_product_is_one(curve, [(c.pk_s_g1, g2), (-g1, c.pk_s_g2)]):
            return False
    # final delta consistency: e(delta_g1, G2) == e(G1, delta_g2)
    pk = params.pk
    if not pairing_product_is_one(curve, [(pk.delta_g1, g2), (-g1, pk.delta_g2)]):
        return False
    # cross-consistency of the G1/G2 deltas against the initial ones:
    # e(delta_final_g1, initial_delta_g2) == e(initial_delta_g1, delta_final_g2)
    if not pairing_product_is_one(
        curve,
        [(pk.delta_g1, params.initial_delta_g2), (-params.initial_delta_g1, pk.delta_g2)],
    ):
        return False
    # h/l queries must be the initial ones scaled by 1/prod(s): spot-check
    # via pairing on the first elements of each query
    if params.initial_h:
        h0 = params.initial_h[0]
        hn = pk._unpack_g1(pk.h_p128[:1])[0]
        if not pairing_product_is_one(
            curve,
            [(PointG1(grp, hn[0], hn[1]), pk.delta_g2),
             (-PointG1(grp, h0[0], h0[1]), params.initial_delta_g2)],
        ):
            return False
    return True


def export_keys(params: MPCParams):
    """Final (pk, vk) after the ceremony."""
    vk = VerificationKey("g16", params.curve, dict(params.vk_data))
    return params.pk, vk
