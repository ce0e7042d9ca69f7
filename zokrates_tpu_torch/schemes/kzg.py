"""KZG10 polynomial commitments (the core of Marlin's universal setup).

SRS: powers-of-tau in G1 (+ [1]2, [tau]2). commit(p) = [p(tau)]1 via MSM;
open(p, z): witness w(X) = (p(X) - p(z)) / (X - z), proof = [w(tau)]1;
verify: e(C - [v]1, H) == e(W, [tau]2 - [z]2)  <=>
        e(C - v*G + z*W, H) == e(W, [tau]2).

Batch opening at one point uses a random linear combination of polynomials
(standard Kate batching, as ark-poly-commit does for Marlin).

The counterpart of the JAX package's schemes/kzg.py: the same SRS,
commitments, openings and checks. The commitments run groth16._msm_g1 (the
sorted MSM's CUDA kernels on a CUDA device) and the universal setup the
fixed-base evaluator (kernels/fixed_base), on `device`.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ec.curve import PointG1, PointG2, g1_group, g2_group
from ..ec.pairing import pairing_product_is_one
from ..fields import params as P


@dataclass
class SRS:
    curve: str
    powers_g1: List[Tuple[int, int]]    # [tau^i]G1 as affine ints
    h: object                           # G2
    tau_h: object                       # [tau]G2
    # hiding support (ark-poly-commit KZG10 `gamma_g` powers): [gamma*tau^i]G1
    gamma_powers_g1: List[Tuple[int, int]] = None

    @property
    def max_degree(self):
        return len(self.powers_g1) - 1


# blinding degree for hiding commitments: each polynomial is opened at most
# once per point set, so degree 1 randomness suffices (ark zk_bound = 1)
HIDING_DEGREE = 2


def _fixed_base_g1(curve: str, scalars: List[int], device) -> List[Tuple[int, int]]:
    """s_i * G1 as affine int tuples ((None, None) at infinity) by the
    fixed-base evaluator on `device`, converted to affine there."""
    import numpy as np
    import torch

    from ..fields.limbs import ints_to_limbs, n_limbs
    from ..kernels.fixed_base import fixed_base_for

    fb = fixed_base_for(curve, "g1")
    r = P.SCALAR_FIELDS[curve].p
    S = torch.as_tensor(ints_to_limbs(scalars, n_limbs(r)).astype(np.int64), device=device)
    ax, ay, inf = fb.to_affine(S)
    xs, ys = fb.ops.f.decode(ax), fb.ops.f.decode(ay)
    return [(None, None) if i else (x, y) for x, y, i in zip(xs, ys, inf.cpu().tolist())]


def universal_setup(curve: str, max_degree: int, rng=None, device="cuda") -> SRS:
    """[tau^i]G1 for i <= max_degree and the hiding powers [gamma tau^i]G1
    for i <= HIDING_DEGREE + 1, all in one fixed-base evaluation on
    `device`; the same draws and points as the reference's loop."""
    r = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(r - 1) + 1)
    tau = rand()
    gamma = rand()
    g2 = g2_group(curve).generator()
    scalars = []
    acc = 1
    for _ in range(max_degree + 1):
        scalars.append(acc)
        acc = acc * tau % r
    gscalars = [gamma * a % r for a in scalars[: HIDING_DEGREE + 2]]
    pts = _fixed_base_g1(curve, scalars + gscalars, device)
    return SRS(
        curve=curve, powers_g1=pts[: len(scalars)], h=g2, tau_h=g2 * tau,
        gamma_powers_g1=pts[len(scalars):],
    )


def commit(srs: SRS, coeffs: Sequence[int], device="cuda") -> PointG1:
    """[p(tau)]G1 via the device MSM."""
    from .groth16 import _msm_g1

    if len(coeffs) > len(srs.powers_g1):
        raise ValueError(
            f"degree {len(coeffs) - 1} exceeds SRS degree {srs.max_degree}"
        )
    return _msm_g1(srs.curve, srs.powers_g1[: len(coeffs)], list(coeffs), device=device)


def _poly_eval(coeffs: Sequence[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc


def _synthetic_div(coeffs: Sequence[int], z: int, r: int) -> List[int]:
    """(p(X) - p(z)) / (X - z) coefficients."""
    out = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % r
        out[i - 1] = acc
    return out


def open_single(srs: SRS, coeffs: Sequence[int], z: int, device="cuda") -> Tuple[int, PointG1]:
    """Evaluate + witness proof for p at z: returns (p(z), [w(tau)]1)."""
    r = P.SCALAR_FIELDS[srs.curve].p
    v = _poly_eval(coeffs, z, r)
    w = _synthetic_div(list(coeffs), z, r)
    return v, commit(srs, w, device) if w else g1_group(srs.curve).zero()


def verify_single(srs: SRS, commitment: PointG1, z: int, v: int, proof: PointG1) -> bool:
    curve = srs.curve
    g1 = g1_group(curve).generator()
    # e(C - vG + zW, H) * e(-W, tau H) == 1
    lhs = commitment + (-(g1 * v)) + proof * z
    return pairing_product_is_one(curve, [(lhs, srs.h), (-proof, srs.tau_h)])


def commit_gamma(srs: SRS, coeffs: Sequence[int], device="cuda") -> PointG1:
    """[gamma * p(tau)]G1 over the hiding powers (small degree)."""
    from .groth16 import _msm_g1

    assert srs.gamma_powers_g1 and len(coeffs) <= len(srs.gamma_powers_g1)
    return _msm_g1(srs.curve, srs.gamma_powers_g1[: len(coeffs)], list(coeffs), device=device)


def rand_blinder(curve: str, rng=None) -> List[int]:
    r = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(r))
    return [rand() for _ in range(HIDING_DEGREE + 1)]


def commit_hiding(srs: SRS, coeffs: Sequence[int], blinder: Sequence[int], device="cuda") -> PointG1:
    """Hiding commitment C = [p(tau)]G1 + [gamma * rho(tau)]G1
    (ark KZG10 `commit` with hiding_bound)."""
    return commit(srs, coeffs or [0], device) + commit_gamma(srs, blinder, device)


def open_batch(
    srs: SRS,
    polys: Sequence[Sequence[int]],
    z: int,
    gamma: int,
    blinders: Optional[Sequence[Optional[Sequence[int]]]] = None,
    device="cuda",
) -> Tuple[List[int], PointG1, int]:
    """Open several polynomials at one point: random combination by gamma.

    blinders[i] is the hiding randomness of commitment i (None for
    non-hiding commitments). Returns (values, proof, random_v) where
    random_v is the combined blinding evaluation the verifier subtracts
    against [gamma]G1 (ark KZG10 Proof::random_v)."""
    r = P.SCALAR_FIELDS[srs.curve].p
    values = [_poly_eval(pc, z, r) for pc in polys]
    max_len = max(len(pc) for pc in polys)
    combined = [0] * max_len
    comb_rho = [0] * (HIDING_DEGREE + 1)
    g = 1
    any_rho = False
    for i, pc in enumerate(polys):
        for j, c in enumerate(pc):
            combined[j] = (combined[j] + g * c) % r
        if blinders is not None and blinders[i]:
            any_rho = True
            for j, c in enumerate(blinders[i]):
                comb_rho[j] = (comb_rho[j] + g * c) % r
        g = g * gamma % r
    w = _synthetic_div(combined, z, r)
    proof = commit(srs, w, device) if w else g1_group(srs.curve).zero()
    random_v = 0
    if any_rho:
        random_v = _poly_eval(comb_rho, z, r)
        w_rho = _synthetic_div(comb_rho, z, r)
        if w_rho:
            proof = proof + commit_gamma(srs, w_rho, device)
    return values, proof, random_v


def verify_batch(
    srs: SRS,
    commitments: Sequence[PointG1],
    z: int,
    values: Sequence[int],
    proof: PointG1,
    gamma: int,
    random_v: int = 0,
) -> bool:
    r = P.SCALAR_FIELDS[srs.curve].p
    curve = srs.curve
    g1 = g1_group(curve).generator()
    comb_c = g1_group(curve).zero()
    comb_v = 0
    g = 1
    for c, v in zip(commitments, values):
        comb_c = comb_c + c * g
        comb_v = (comb_v + g * v) % r
        g = g * gamma % r
    lhs = comb_c + (-(g1 * comb_v)) + proof * z
    if random_v % r:
        if not srs.gamma_powers_g1:
            return False
        gx, gy = srs.gamma_powers_g1[0]
        gamma_g = g1_group(curve).point(gx, gy)
        lhs = lhs + (-(gamma_g * (random_v % r)))
    return pairing_product_is_one(curve, [(lhs, srs.h), (-proof, srs.tau_h)])
