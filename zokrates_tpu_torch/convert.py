"""Carry keys and circuits across from the JAX package.

The JAX package's ProvingKey, VerificationKey and R1CS hold numpy arrays,
integer point coordinates and plain lists. These functions build the
port's objects from exactly those plain values, so a key made by either
package proves in the other. Nothing here imports the JAX package: the
caller extracts the arrays and ints and hands them over.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .ec.curve import PointG1, PointG2, g1_group, g2_group
from .ec.tower import Fq2
from .ir.r1cs import R1CS
from .schemes.gm17 import ProvingKey as GM17ProvingKey
from .schemes.groth16 import ProvingKey
from .schemes.types import VerificationKey

PK_ARRAYS = (
    "a_p128", "a_mask", "b1_p128", "b1_mask", "b2_p128", "b2_mask",
    "h_p128", "l_p128", "l_mask", "corr_w",
)
# carried when present: the shared-bucket h query (None on a key the JAX
# package made off a TPU)
PK_OPTIONAL = ("h16_p128",)
# the b2 query's coordinates, carried where b2_p128 is None (a packed G2 row
# over 128 words: the BLS12 curves)
PK_B2_XY = ("b2_x", "b2_y")
PK_G1 = ("alpha_g1", "beta_g1", "delta_g1")
PK_G2 = ("beta_g2", "delta_g2")


def g1_point(curve: str, xy) -> PointG1:
    """(x, y) ints, or None for infinity -> PointG1."""
    grp = g1_group(curve)
    return grp.zero() if xy is None else PointG1(grp, int(xy[0]), int(xy[1]))


def g2_point(curve: str, xy):
    """((x.c0, x.c1), (y.c0, y.c1)) ints, or None for infinity -> PointG2;
    where G2 lies over Fq (BW6-761), (x, y) ints -> the group's PointG1."""
    grp = g2_group(curve)
    if xy is None:
        return grp.zero()
    if not hasattr(grp, "tower"):
        return PointG1(grp, int(xy[0]), int(xy[1]))
    (x0, x1), (y0, y1) = xy
    return PointG2(grp, Fq2(grp.tower, int(x0), int(x1)), Fq2(grp.tower, int(y0), int(y1)))


def proving_key(curve: str, domain_size: int, num_instance: int,
                points: Dict[str, object], arrays: Dict[str, np.ndarray]) -> ProvingKey:
    """points: PK_G1 names -> (x, y) ints, PK_G2 names -> ((x0, x1),
    (y0, y1)) ints ((x, y) ints where G2 lies over Fq: g2_point). arrays:
    PK_ARRAYS names -> numpy arrays in the JAX package's layout (uint32
    packed rows, bool masks, uint32 weights); PK_OPTIONAL names may be
    absent or None; b2_p128 may be None, and then
    PK_B2_XY names give the b2 query's coordinates ((m, 2, nl) uint32)."""
    wide = arrays.get("b2_p128", ()) is None
    need = [k for k in PK_ARRAYS if not (wide and k == "b2_p128")] + list(PK_B2_XY if wide else ())
    missing = [k for k in need if k not in arrays] + [k for k in PK_G1 + PK_G2 if k not in points]
    if missing:
        raise KeyError(f"proving key fields missing: {missing}")
    kw = {k: np.array(arrays[k], copy=True) for k in PK_ARRAYS if not (wide and k == "b2_p128")}
    if wide:
        kw["b2_p128"] = None
        kw["b2_xy"] = tuple(np.array(arrays[k], copy=True) for k in PK_B2_XY)
    kw.update({k: np.array(arrays[k], copy=True) for k in PK_OPTIONAL if arrays.get(k) is not None})
    kw.update({k: g1_point(curve, points[k]) for k in PK_G1})
    kw.update({k: g2_point(curve, points[k]) for k in PK_G2})
    return ProvingKey(curve=curve, domain_size=int(domain_size), num_instance=int(num_instance), **kw)


GM17_G1 = ("g_gamma_t", "g_gamma2_t2", "g_ab_t")
GM17_G2 = ("h_gamma_t",)
GM17_G1_QUERIES = ("a_query", "c_query", "h_query")
GM17_SAP = ("sap_pairs", "sap_U", "sap_W")


def gm17_proving_key(curve: str, domain_size: int, num_instance: int, num_r1cs_vars: int,
                     points: Dict[str, object], queries: Dict[str, list],
                     sap: Dict[str, list]) -> GM17ProvingKey:
    """The GM17 proving key. points: GM17_G1 names -> (x, y) ints, GM17_G2
    names -> ((x0, x1), (y0, y1)) ints ((x, y) ints where G2 lies over Fq,
    BW6-761; g2_point). queries: GM17_G1_QUERIES names -> lists of (x, y)
    ints or None, "b_query" -> a list of G2 coordinates as GM17_G2's, or
    None. sap: GM17_SAP names -> the SAP rows as lists of
    (index, coefficient) pairs ("sap_pairs": a list of such row pairs)."""
    missing = [k for k in GM17_G1 + GM17_G2 if k not in points] + [
        k for k in GM17_G1_QUERIES + ("b_query",) if k not in queries
    ] + [k for k in GM17_SAP if k not in sap]
    if missing:
        raise KeyError(f"proving key fields missing: {missing}")

    def g1q(xy):
        return None if xy is None else (None, None) if xy[0] is None else (int(xy[0]), int(xy[1]))

    def row(r):
        return [(int(i), int(c)) for i, c in r]

    kw = {k: [g1q(xy) for xy in queries[k]] for k in GM17_G1_QUERIES}
    kw["b_query"] = [None if xy is None else g2_point(curve, xy) for xy in queries["b_query"]]
    kw.update({k: g1_point(curve, points[k]) for k in GM17_G1})
    kw.update({k: g2_point(curve, points[k]) for k in GM17_G2})
    kw["sap_pairs"] = [(row(a), row(b)) for a, b in sap["sap_pairs"]]
    kw["sap_U"] = [row(r) for r in sap["sap_U"]]
    kw["sap_W"] = [row(r) for r in sap["sap_W"]]
    return GM17ProvingKey(curve=curve, domain_size=int(domain_size), num_instance=int(num_instance),
                          num_r1cs_vars=int(num_r1cs_vars), **kw)


def verification_key(scheme: str, curve: str, data: dict) -> VerificationKey:
    """The verification key from its JSON fields (hex strings)."""
    return VerificationKey(scheme, curve, dict(data))


def r1cs(curve: str, num_instance: int, num_witness: int,
         A: Sequence[Sequence[Tuple[int, int]]], B, C,
         ir_to_dense: Dict[int, int]) -> R1CS:
    """Constraint rows as lists of (dense variable, coefficient) pairs."""

    def rows(M) -> List[List[Tuple[int, int]]]:
        return [[(int(i), int(c)) for i, c in row] for row in M]

    return R1CS(
        curve=curve,
        num_instance=int(num_instance),
        num_witness=int(num_witness),
        A=rows(A),
        B=rows(B),
        C=rows(C),
        ir_to_dense={int(k): int(v) for k, v in ir_to_dense.items()},
    )
