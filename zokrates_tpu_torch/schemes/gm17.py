"""GM17 (Groth-Maller 2017) setup / prove / verify on PyTorch, with the
prover's kernels in CUDA.

The counterpart of the JAX package's schemes/gm17.py: the same SAP (square
arithmetic program) reduction, keys, proof and verification equations

  (1) e(g_alpha, h_beta) * e(vk_x, h_gamma) * e(C, H)
        == e(A + g_alpha, B + h_beta)
  (2) e(A, h_gamma) == e(g_gamma, B)

with VK/proof JSON byte-compatible with the reference's ({h, g_alpha,
h_beta, g_gamma, h_gamma, query}, {a, b, c}). Where the work runs:

  * setup evaluates the SAP at x on the host and produces every query point
    with the batched fixed-base MSM (kernels/fixed_base.py), where the
    reference multiplies each point on the host; the points are the same,
  * proving extends the witness with the SAP's square witnesses and
    evaluates U and W on the host (integer sums, as the reference), then
    on the device: h(X) = (U^2 - W)/t with the Domain's transforms over
    the NTT kernel and the products through the emul kernel
    (kernels/pallas_field.py), and the four MSMs (a, b in G2, c, h)
    through groth16's sorted-MSM entry points (_msm_packed_g1,
    _msm_dev_g2) over query rows the pk packs on the device at first use;
    the randomization with r runs on the host (cached comb tables),
  * verification uses the host pairing-product oracle (ec/pairing.py).

Entry points take a `device` argument: "cuda" unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run instead.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ec.curve import PointG1, g1_group, g2_group
from ..ec.pairing import pairing_product_is_one
from ..fields import params as P
from ..fields.jfield import field_ops
from ..fields.limbs import ints_to_limbs, n_limbs
from ..ir.r1cs import R1CS
from ..ir.witness import Witness
from ..kernels.ntt import domain_for_curve
from ..kernels.pallas_field import emul
from .groth16 import (
    _fb_mul_g1,
    _fb_mul_g2,
    _g2_beta,
    _g2_from_affine,
    _lagrange_at_tau,
    _mont_elems,
    _msm_dev_g2,
    _msm_packed_g1,
    _msm_tier,
    _next_pow2,
    _row,
    _scalar_limbs,
    _Stages,
)
from .types import (
    Proof,
    VerificationKey,
    fr_from_json,
    fr_to_json,
    g1_from_json,
    g1_to_json,
    g2_from_json,
    g2_to_json,
)

Row = List[Tuple[int, int]]  # (dense variable index, coefficient)


@dataclass
class SAP:
    """Square arithmetic program rows over the dense variable space
    [r1cs vars] + [one d per row-pair]."""

    num_vars: int
    num_instance: int
    U: List[Row]
    W: List[Row]
    pair_sources: List[Tuple[Row, Row]]
    # (a_minus_b row per pair) to compute the d witnesses at prove time


def r1cs_to_sap(r1cs: R1CS, p: int) -> SAP:
    """Each constraint (a.z)(b.z) = (c.z), and the binding (z_j)(z_0) = z_j
    of each instance variable j, becomes the squaring pair
    ((a+b).z)^2 = 4(c.z) + d, ((a-b).z)^2 = d with d a fresh witness."""
    ni = r1cs.num_instance
    rows_U, rows_W, pairs = [], [], []
    d_base = r1cs.num_variables

    def neg(row):
        return [(i, (-c) % p) for i, c in row]

    def addrows(x, y):
        acc: Dict[int, int] = {}
        for i, c in x + y:
            acc[i] = (acc.get(i, 0) + c) % p
        return [(i, c) for i, c in acc.items() if c]

    def scale(row, k):
        return [(i, c * k % p) for i, c in row]

    binding = [([(j, 1)], [(0, 1)], [(j, 1)]) for j in range(ni)]
    for k, (a, b, c) in enumerate(binding + list(zip(r1cs.A, r1cs.B, r1cs.C))):
        d = d_base + k
        rows_U.append(addrows(a, b))
        rows_W.append(addrows(scale(c, 4), [(d, 1)]))
        rows_U.append(addrows(a, neg(b)))
        rows_W.append([(d, 1)])
        pairs.append((addrows(a, neg(b)), c))

    return SAP(num_vars=d_base + len(pairs), num_instance=ni, U=rows_U, W=rows_W, pair_sources=pairs)


@dataclass
class ProvingKey:
    """GM17 proving key, field for field the reference's: query points as
    affine (x, y) ints (G2: host points), None where the query's scalar is 0.
    The prover packs the queries into device rows at first use (dev()),
    cached per device and never pickled."""

    curve: str
    domain_size: int
    num_instance: int
    num_r1cs_vars: int
    a_query: List[Optional[Tuple[int, int]]]
    b_query: List[Optional[object]]  # G2 points: PointG2, or over Fq (BW6-761) the group's PointG1
    c_query: List[Optional[Tuple[int, int]]]  # witness-indexed
    h_query: List[Tuple[int, int]]  # G^{gamma^2 t x^j}, j = 0..n-1
    g_gamma_t: PointG1
    h_gamma_t: object  # a G2 point, as b_query's
    g_gamma2_t2: PointG1
    g_ab_t: PointG1
    sap_pairs: List[Tuple[Row, Row]]
    sap_U: List[Row]
    sap_W: List[Row]
    _dev: Dict = field(default_factory=dict, repr=False, compare=False)

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_dev"] = {}
        return d

    def dev(self, device) -> Dict[str, torch.Tensor]:
        """The queries on `device`, each padded to a power of two: G1 as
        packed rows (pack_points), G2 as Fq2 coordinates (N, 2, nl), or
        (N, nl) where G2 lies over Fq (BW6-761), all Montgomery; a point at
        infinity (None) is a zero row whose mask is False."""
        key = torch.device(device)
        if key not in self._dev:
            q = P.BASE_FIELDS[self.curve].p
            d = {}
            for name in ("a", "c", "h"):
                pts = [None if pt is None or pt[0] is None else pt for pt in getattr(self, name + "_query")]
                d[name], d[name + "_mask"] = _g1_rows(q, pts, device)
            pts = [None if pt is None or pt.infinity else pt for pt in self.b_query]
            d["bx"], d["by"], d["b_mask"] = _g2_coords(q, pts, _g2_beta(self.curve) is None, device)
            self._dev[key] = d
        return self._dev[key]


def _query_mask(pts, N: int, device) -> torch.Tensor:
    return torch.as_tensor([pt is not None for pt in pts] + [False] * (N - len(pts)), device=device)


def _g1_rows(q: int, pts, device):
    """(x, y) points or None -> packed rows (N, 128) and mask (N,), N the
    power-of-two tier of len(pts)."""
    from ..kernels.msm_sorted import pack_points

    N = _msm_tier(len(pts))
    xy = [pt if pt is not None else (0, 0) for pt in pts] + [(0, 0)] * (N - len(pts))
    X = _mont_elems(q, [v[0] for v in xy], device)
    Y = _mont_elems(q, [v[1] for v in xy], device)
    return pack_points(q, X, Y), _query_mask(pts, N, device)


def _g2_coords(q: int, pts, over_fq: bool, device):
    """G2 points or None -> x, y Montgomery and mask (N,): (N, 2, nl)
    over Fq2, (N, nl) where G2 lies over Fq (BW6-761, as _msm_dev_g2 takes
    them there)."""
    N = _msm_tier(len(pts))
    if over_fq:
        cs = [(0, 0) if pt is None else (pt.x, pt.y) for pt in pts] + [(0, 0)] * (N - len(pts))
        shape = (N, 2, -1)
    else:
        cs = [(0, 0, 0, 0) if pt is None else (pt.x.c0, pt.x.c1, pt.y.c0, pt.y.c1) for pt in pts]
        cs += [(0, 0, 0, 0)] * (N - len(pts))
        shape = (N, 2, 2, -1)
    xy = _mont_elems(q, [c for v in cs for c in v], device).reshape(shape)
    return xy[:, 0].contiguous(), xy[:, 1].contiguous(), _query_mask(pts, N, device)


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _fb_affine(curve: str, group: str, scalars: List[int], device):
    """Fixed-base s_i * G -> host affine coordinates, None at infinity: (x,
    y) ints for G1, ((x0, x1), (y0, y1)) for G2 over Fq2, (x, y) ints for
    G2 over Fq."""
    from ..kernels.fixed_base import fixed_base_for

    grp = g1_group(curve) if group == "g1" else g2_group(curve)
    fb = fixed_base_for(curve, group)
    ax, ay, inf = fb.to_affine(_scalar_limbs(grp, scalars, device))
    xs, ys = fb.ops.f.decode(ax), fb.ops.f.decode(ay)
    inf = inf.cpu().numpy()
    return [None if inf[i] else (xs[i], ys[i]) for i in range(len(scalars))]


def setup(r1cs: R1CS, rng=None, device="cuda") -> Tuple[ProvingKey, VerificationKey]:
    """Circuit-specific GM17 setup. rng() draws alpha, beta, gamma and the
    evaluation point x, in that order. Query points come from the
    fixed-base MSM on `device`; they equal the reference's g1 * s."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p - 1) + 1)
    g1grp, g2grp = g1_group(curve), g2_group(curve)
    g1, g2 = g1grp.generator(), g2grp.generator()

    sap = r1cs_to_sap(r1cs, p)
    n = _next_pow2(len(sap.U))
    dom = domain_for_curve(curve, n)

    alpha, beta, gamma, x = (rand() for _ in range(4))
    ab = (alpha + beta) % p
    lag = _lagrange_at_tau(p, n, dom.omega, x)
    t_x = (pow(x, n, p) - 1) % p

    u_t = [0] * sap.num_vars
    w_t = [0] * sap.num_vars
    for rows, out in ((sap.U, u_t), (sap.W, w_t)):
        for r, row in enumerate(rows):
            for i, coef in row:
                out[i] = (out[i] + coef * lag[r]) % p

    ni, nv = sap.num_instance, sap.num_vars
    gg = gamma * gamma % p
    a_s = [gamma * u_t[i] % p for i in range(nv)]
    c_s = [(gg * w_t[i] + gamma * ab % p * u_t[i]) % p for i in range(ni, nv)]
    h_s, acc = [], gg * t_x % p
    for _ in range(n):
        h_s.append(acc)
        acc = acc * x % p
    q_s = [(gamma * w_t[i] + ab * u_t[i]) % p for i in range(ni)]

    g1_pts = _fb_affine(curve, "g1", a_s + c_s + h_s + q_s, device)
    a_query = g1_pts[:nv]
    c_query = g1_pts[nv : 2 * nv - ni]
    h_query = [pt if pt is not None else (None, None) for pt in g1_pts[2 * nv - ni : 2 * nv - ni + n]]
    query = [g1grp.zero() if pt is None else PointG1(g1grp, *pt) for pt in g1_pts[2 * nv - ni + n :]]
    b_query = [None if pt is None else _g2_from_affine(g2grp, pt) for pt in _fb_affine(curve, "g2", a_s, device)]

    pk = ProvingKey(
        curve=curve,
        domain_size=n,
        num_instance=ni,
        num_r1cs_vars=r1cs.num_variables,
        a_query=a_query,
        b_query=b_query,
        c_query=c_query,
        h_query=h_query,
        g_gamma_t=g1 * (gamma * t_x % p),
        h_gamma_t=g2 * (gamma * t_x % p),
        g_gamma2_t2=g1 * (gg * t_x % p * t_x % p),
        g_ab_t=g1 * (gamma * ab % p * t_x % p),
        sap_pairs=sap.pair_sources,
        sap_U=sap.U,
        sap_W=sap.W,
    )
    vk = VerificationKey(
        "gm17",
        curve,
        {
            "h": g2_to_json(g2, curve),
            "g_alpha": g1_to_json(g1 * alpha, curve),
            "h_beta": g2_to_json(g2 * beta, curve),
            "g_gamma": g1_to_json(g1 * gamma, curve),
            "h_gamma": g2_to_json(g2 * gamma, curve),
            "query": [g1_to_json(pt, curve) for pt in query],
        },
    )
    return pk, vk


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------


def _h_stage(curve: str, n: int, u_e: List[int], w_e: List[int], two_r: int, device) -> torch.Tensor:
    """U, W evaluations (host ints, n each) -> the h MSM's scalars on
    `device`, (n, nl) canonical limbs: h_j + two_r * u_j, where u_j are
    U's coefficients (one ifft), h(X) = (U^2 - W)/t on the coset (coset
    NTTs) with its top coefficient dropped, as the reference. Both
    inverse transforms of the first stage and both forward ones of the
    second run as one batched call; every product is an emul."""
    p = P.SCALAR_FIELDS[curve].p
    f = field_ops(p)
    nl = f.nl
    dom = domain_for_curve(curve, n)
    g = P.SCALAR_FIELDS[curve].smallest_nonresidue
    zinv_mont = pow((pow(g, n, p) - 1) % p, -1, p) * f.spec.r % p

    uw = _mont_elems(p, u_e + w_e, device).reshape(2, n, nl)
    coef = dom.ifft(uw)
    cs = dom.coset_fft(coef, g)
    h_cs = emul(p, f.sub(emul(p, cs[:1], cs[0]), cs[1:]), _row(p, zinv_mont, device).expand(n, nl))
    h = emul(p, dom.coset_ifft(h_cs, g), _row(p, 1, device).expand(n, nl))[0]
    h[n - 1] = 0
    return f.add(h, emul(p, coef[:1], _row(p, two_r, device).expand(n, nl))[0])


def prove(r1cs: R1CS, pk: ProvingKey, witness: Witness, rng=None, device="cuda",
          timings: Optional[dict] = None) -> Proof:
    """One GM17 proof. rng() draws the randomizer r. If `timings` is a dict,
    per-stage wall seconds are added to it (the device is synchronized at
    each stage boundary): sap_witness, uw_eval, upload, h_stage, msm_a,
    msm_b, msm_c, msm_h, tail."""
    curve = r1cs.curve
    p = P.SCALAR_FIELDS[curve].p
    rand = rng or (lambda: secrets.randbelow(p))
    n = pk.domain_size
    ni = pk.num_instance
    mark = _Stages(timings, device)

    z = [v % p for v in r1cs.full_assignment(witness)]
    for am_b, _c in pk.sap_pairs:
        v = sum(c * z[i] for i, c in am_b) % p
        z.append(v * v % p)
    mark("sap_witness")
    u_e = [0] * n
    w_e = [0] * n
    for rows, out in ((pk.sap_U, u_e), (pk.sap_W, w_e)):
        for r, row in enumerate(rows):
            out[r] = sum(c * z[i] for i, c in row) % p
    mark("uw_eval")

    r = rand() % p
    pkd = pk.dev(device)
    Z = torch.as_tensor(ints_to_limbs(z, n_limbs(p)).astype(np.int64), device=device)
    mark("upload")
    h_exp = _h_stage(curve, n, u_e, w_e, 2 * r % p, device)
    mark("h_stage")

    A = _msm_packed_g1(curve, pkd["a"], Z, pkd["a_mask"])
    mark("msm_a")
    B = _msm_dev_g2(curve, pkd["bx"], pkd["by"], Z, pkd["b_mask"])
    mark("msm_b")
    c_acc = _msm_packed_g1(curve, pkd["c"], Z[ni:], pkd["c_mask"])
    mark("msm_c")
    h_acc = _msm_packed_g1(curve, pkd["h"], h_exp, pkd["h_mask"])
    mark("msm_h")

    A = A + _fb_mul_g1(pk.g_gamma_t, r)
    B = B + _fb_mul_g2(pk.h_gamma_t, r)
    C = c_acc + h_acc + _fb_mul_g1(pk.g_gamma2_t2, r * r % p) + _fb_mul_g1(pk.g_ab_t, r)
    inputs = [fr_to_json(z[i], curve) for i in range(1, ni)]
    proof = Proof("gm17", curve, {"a": g1_to_json(A, curve), "b": g2_to_json(B, curve),
                                  "c": g1_to_json(C, curve)}, inputs)
    mark("tail")
    return proof


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------


def verify(vk: VerificationKey, proof: Proof) -> bool:
    curve = vk.curve
    try:
        A = g1_from_json(proof.points["a"], curve)
        B = g2_from_json(proof.points["b"], curve)
        C = g1_from_json(proof.points["c"], curve)
        H = g2_from_json(vk.data["h"], curve)
        g_alpha = g1_from_json(vk.data["g_alpha"], curve)
        h_beta = g2_from_json(vk.data["h_beta"], curve)
        g_gamma = g1_from_json(vk.data["g_gamma"], curve)
        h_gamma = g2_from_json(vk.data["h_gamma"], curve)
        query = [g1_from_json(q, curve) for q in vk.data["query"]]
    except (ValueError, KeyError):
        return False

    inputs = [fr_from_json(s, curve) for s in proof.inputs]
    if len(inputs) + 1 != len(query):
        return False
    vk_x = query[0]
    for v, q in zip(inputs, query[1:]):
        vk_x = vk_x + q * v

    # (1) e(g_alpha, h_beta) e(vk_x, h_gamma) e(C, H) == e(A + g_alpha, B + h_beta)
    if not pairing_product_is_one(
        curve,
        [(g_alpha, h_beta), (vk_x, h_gamma), (C, H), (-(A + g_alpha), B + h_beta)],
    ):
        return False
    # (2) e(A, h_gamma) == e(g_gamma, B)
    return pairing_product_is_one(curve, [(A, h_gamma), (-g_gamma, B)])
