"""Solidity verifier for our Marlin proofs (bn128).

The reference ships a 691-line Marlin template
(zokrates_proof_systems/src/scheme/marlin.rs:90+) for ark-marlin's proof
shape; ours verifies THIS module's proof format (schemes/marlin.py):
keccak-256 transcript replay (the Python _Transcript chains
state = keccak256(state || value_96B_be), which maps 1:1 onto the EVM's
KECCAK256), the three AHP identities with mulmod arithmetic, and the two
KZG batch openings via the bn128 pairing precompile — including the
hiding-commitment correction term random_v * [gamma]G1.

Proof ABI (all uint256):
  comms[24]  : 12 G1 commitments (x, y) in _C_NAMES order
  evals[22]  : 9 beta evals, 12 delta evals, t_beta (_B_NAMES/_D_NAMES order)
  randomV    : combined blinding evaluation for the beta batch
  proofBeta / proofDelta : batch opening proofs (G1)
"""

from __future__ import annotations

from typing import List

from ..fields import params as P
from ..utils.keccak import keccak256
from .types import VerificationKey

_C_NAMES = ["w", "z_a", "z_b", "z_c", "h0", "s", "g1", "s1", "h1", "g2", "s2", "h2"]


def _u(v) -> int:
    return int(v, 16) if isinstance(v, str) else int(v)


def _g1_words(pt) -> List[int]:
    return [_u(pt[0]), _u(pt[1])]


def _g2_words(pt) -> List[int]:
    # EVM precompile word order: (imag, real) per coordinate
    return [_u(pt[0][1]), _u(pt[0][0]), _u(pt[1][1]), _u(pt[1][0])]


HEADER = """// SPDX-License-Identifier: MIT
// Auto-generated Marlin verifier (zokrates-tpu). Scheme/format:
// zokrates_tpu/schemes/marlin.py; transcript = chained keccak-256.
pragma solidity ^0.8.0;

contract Verifier {
    uint constant R =
        21888242871839275222246405745257275088548364400416034343698204186575808495617;
    uint constant Q =
        21888242871839275222246405745257275088696311157297823662689037894645226208583;
"""

BODY = """
    function _absorb(bytes32 st, uint v) internal pure returns (bytes32) {
        return keccak256(abi.encodePacked(st, uint(0), uint(0), v));
    }

    function _absorbPt(bytes32 st, uint x, uint y) internal pure returns (bytes32) {
        if (x == 0 && y == 0) {
            return keccak256(abi.encodePacked(st, bytes8(0)));
        }
        return _absorb(_absorb(st, x), y);
    }

    function _squeeze(bytes32 st, uint ctr)
        internal pure returns (uint v, uint nextCtr)
    {
        while (true) {
            v = uint(keccak256(abi.encodePacked(st, bytes8(uint64(ctr))))) % R;
            ctr++;
            if (v != 0) return (v, ctr);
        }
    }

    function _modexp(uint b, uint e) internal view returns (uint result) {
        bool ok;
        uint[6] memory input = [uint(32), 32, 32, b, e, R];
        uint[1] memory output;
        assembly {
            ok := staticcall(sub(gas(), 2000), 5, input, 0xc0, output, 0x20)
        }
        require(ok, "modexp");
        return output[0];
    }

    function _inv(uint a) internal view returns (uint) {
        return _modexp(a, R - 2);
    }

    function _ecAdd(uint[2] memory p, uint[2] memory q)
        internal view returns (uint[2] memory out)
    {
        uint[4] memory input = [p[0], p[1], q[0], q[1]];
        bool ok;
        assembly {
            ok := staticcall(sub(gas(), 2000), 6, input, 0x80, out, 0x40)
        }
        require(ok, "ec-add");
    }

    function _ecMul(uint[2] memory p, uint s)
        internal view returns (uint[2] memory out)
    {
        uint[3] memory input = [p[0], p[1], s];
        bool ok;
        assembly {
            ok := staticcall(sub(gas(), 2000), 7, input, 0x60, out, 0x40)
        }
        require(ok, "ec-mul");
    }

    function _neg(uint[2] memory p) internal pure returns (uint[2] memory) {
        if (p[0] == 0 && p[1] == 0) return p;
        return [p[0], Q - (p[1] % Q)];
    }

    /// e(a1, a2) * e(b1, b2) == 1
    function _pairing2(
        uint[2] memory a1, uint[4] memory a2,
        uint[2] memory b1, uint[4] memory b2
    ) internal view returns (bool) {
        uint[12] memory input = [
            a1[0], a1[1], a2[0], a2[1], a2[2], a2[3],
            b1[0], b1[1], b2[0], b2[1], b2[2], b2[3]
        ];
        uint[1] memory out;
        bool ok;
        assembly {
            ok := staticcall(sub(gas(), 2000), 8, input, 0x180, out, 0x20)
        }
        require(ok, "pairing");
        return out[0] != 0;
    }

    struct Challenges {
        uint alpha;
        uint etaA;
        uint etaB;
        uint etaC;
        uint beta;
        uint delta;
        uint gammaB;
        uint gammaD;
    }

    function _transcript(
        uint[24] memory comms, uint[22] memory evals, uint[] memory input
    ) internal pure returns (Challenges memory ch) {
        bytes32 st = INIT_STATE;
        uint ctr = 0;
        for (uint i = 0; i < input.length; i++) {
            st = _absorb(st, input[i]);
        }
        // round 1: w, z_a, z_b, z_c, h0, s
        for (uint i = 0; i < 6; i++) {
            st = _absorbPt(st, comms[2 * i], comms[2 * i + 1]);
        }
        (ch.alpha, ctr) = _squeeze(st, ctr);
        (ch.etaA, ctr) = _squeeze(st, ctr);
        (ch.etaB, ctr) = _squeeze(st, ctr);
        (ch.etaC, ctr) = _squeeze(st, ctr);
        // round 2: g1, s1, h1 (the Python transcript's counter is
        // monotonic across the whole protocol — never reset)
        for (uint i = 6; i < 9; i++) {
            st = _absorbPt(st, comms[2 * i], comms[2 * i + 1]);
        }
        (ch.beta, ctr) = _squeeze(st, ctr);
        // round 3: t_beta then g2, s2, h2
        st = _absorb(st, evals[21]);
        for (uint i = 9; i < 12; i++) {
            st = _absorbPt(st, comms[2 * i], comms[2 * i + 1]);
        }
        (ch.delta, ctr) = _squeeze(st, ctr);
        // openings: all evaluations
        for (uint i = 0; i < 21; i++) {
            st = _absorb(st, evals[i]);
        }
        (ch.gammaB, ctr) = _squeeze(st, ctr);
        (ch.gammaD, ctr) = _squeeze(st, ctr);
    }

    function _instance(uint beta, uint[] memory input)
        internal view returns (uint xhat, uint vhx)
    {
        uint ni = input.length + 1;
        vhx = 1;
        for (uint i = 0; i < ni; i++) {
            vhx = mulmod(vhx, addmod(beta, R - OMEGA_POWS(i), R), R);
        }
        for (uint i = 0; i < ni; i++) {
            uint xi = i == 0 ? 1 : input[i - 1];
            uint num = 1;
            uint den = 1;
            for (uint j = 0; j < ni; j++) {
                if (j == i) continue;
                num = mulmod(num, addmod(beta, R - OMEGA_POWS(j), R), R);
                den = mulmod(
                    den, addmod(OMEGA_POWS(i), R - OMEGA_POWS(j), R), R
                );
            }
            xhat = addmod(xhat, mulmod(xi, mulmod(num, _inv(den), R), R), R);
        }
    }

    function _kzgBatch(
        uint[2][] memory cs, uint z, uint[] memory vals,
        uint[2] memory proofPt, uint gamma, uint randomV
    ) internal view returns (bool) {
        uint[2] memory comb = [uint(0), 0];
        uint combV = 0;
        uint g = 1;
        for (uint i = 0; i < cs.length; i++) {
            comb = _ecAdd(comb, _ecMul(cs[i], g));
            combV = addmod(combV, mulmod(g, vals[i], R), R);
            g = mulmod(g, gamma, R);
        }
        uint[2] memory lhs = _ecAdd(comb, _neg(_ecMul(G1, combV)));
        lhs = _ecAdd(lhs, _ecMul(proofPt, z));
        if (randomV != 0) {
            lhs = _ecAdd(lhs, _neg(_ecMul(GAMMA_G, randomV)));
        }
        return _pairing2(lhs, H2, _neg(proofPt), TAU_H2);
    }

    function verifyTx(
        uint[24] memory comms,
        uint[22] memory evals,
        uint randomV,
        uint[2] memory proofBeta,
        uint[2] memory proofDelta,
        uint[N_INPUTS] memory publicInput
    ) public view returns (bool) {
        uint[] memory input = new uint[](N_INPUTS);
        for (uint i = 0; i < N_INPUTS; i++) {
            require(publicInput[i] < R);
            input[i] = publicInput[i];
        }
        Challenges memory ch = _transcript(comms, evals, input);
        uint tBeta = evals[21];

        uint vhBeta = addmod(_modexp(ch.beta, N), R - 1, R);
        uint vhAlpha = addmod(_modexp(ch.alpha, N), R - 1, R);

        // (1) rowcheck: z_a*z_b - z_c == h0 * v_H(beta)
        if (
            addmod(
                mulmod(evals[1], evals[2], R), R - evals[3], R
            ) != mulmod(evals[4], vhBeta, R)
        ) return false;

        // (2) lincheck: s + u_H(a,b)*z_eta - t*zhat == beta*g1 + h1*v_H(beta)
        {
            if (ch.alpha == ch.beta) return false;
            uint uab = mulmod(
                addmod(vhAlpha, R - vhBeta, R),
                _inv(addmod(ch.alpha, R - ch.beta, R)),
                R
            );
            uint zeta = addmod(
                addmod(
                    mulmod(ch.etaA, evals[1], R), mulmod(ch.etaB, evals[2], R), R
                ),
                mulmod(ch.etaC, evals[3], R),
                R
            );
            (uint xhat, uint vhx) = _instance(ch.beta, input);
            uint zhat = addmod(mulmod(evals[0], vhx, R), xhat, R);
            uint lhs = addmod(
                addmod(evals[5], mulmod(uab, zeta, R), R),
                R - mulmod(tBeta, zhat, R),
                R
            );
            uint rhs = addmod(
                mulmod(ch.beta, evals[6], R), mulmod(evals[8], vhBeta, R), R
            );
            if (lhs != rhs) return false;
            // degree bounds
            if (evals[7] != mulmod(_modexp(ch.beta, D_SHIFT_N), evals[6], R))
                return false;
            if (evals[10] != mulmod(_modexp(ch.delta, D_SHIFT_K), evals[9], R))
                return false;
        }

        // (3) rational sumcheck over K at delta
        {
            uint vkDelta = addmod(_modexp(ch.delta, K), R - 1, R);
            uint ba = mulmod(
                addmod(ch.alpha, R - evals[12], R),
                addmod(ch.beta, R - evals[13], R), R
            );
            uint bb = mulmod(
                addmod(ch.alpha, R - evals[15], R),
                addmod(ch.beta, R - evals[16], R), R
            );
            uint bc = mulmod(
                addmod(ch.alpha, R - evals[18], R),
                addmod(ch.beta, R - evals[19], R), R
            );
            uint vhab = mulmod(vhAlpha, vhBeta, R);
            uint aD = mulmod(
                mulmod(ch.etaA, vhab, R), mulmod(evals[14], mulmod(bb, bc, R), R), R
            );
            aD = addmod(
                aD,
                mulmod(
                    mulmod(ch.etaB, vhab, R),
                    mulmod(evals[17], mulmod(ba, bc, R), R), R
                ),
                R
            );
            aD = addmod(
                aD,
                mulmod(
                    mulmod(ch.etaC, vhab, R),
                    mulmod(evals[20], mulmod(ba, bb, R), R), R
                ),
                R
            );
            uint bD = mulmod(ba, mulmod(bb, bc, R), R);
            uint fD = addmod(
                mulmod(ch.delta, evals[9], R), mulmod(tBeta, K_INV, R), R
            );
            if (
                mulmod(evals[11], vkDelta, R)
                    != addmod(aD, R - mulmod(bD, fD, R), R)
            ) return false;
        }

        // (4) KZG batch openings
        {
            uint[2][] memory bc = new uint[2][](9);
            uint[] memory bv = new uint[](9);
            for (uint i = 0; i < 9; i++) {
                bc[i] = [comms[2 * i], comms[2 * i + 1]];
                bv[i] = evals[i];
            }
            if (!_kzgBatch(bc, ch.beta, bv, proofBeta, ch.gammaB, randomV))
                return false;

            uint[2][] memory dc = new uint[2][](12);
            uint[] memory dv = new uint[](12);
            for (uint i = 0; i < 3; i++) {
                dc[i] = [comms[2 * (9 + i)], comms[2 * (9 + i) + 1]];
            }
            for (uint i = 0; i < 9; i++) {
                dc[3 + i] = INDEX_COMM(i);
            }
            for (uint i = 0; i < 12; i++) {
                dv[i] = evals[9 + i];
            }
            if (!_kzgBatch(dc, ch.delta, dv, proofDelta, ch.gammaD, 0))
                return false;
        }
        return true;
    }
}
"""


def export_marlin_verifier(vk: VerificationKey) -> str:
    if vk.curve != "bn128":
        raise ValueError("solidity export is only supported for bn128")
    d = vk.data
    r = P.SCALAR_FIELDS["bn128"].p
    n, k, ni, D = d["n"], d["k"], d["num_instance"], d["srs_degree"]

    # transcript initial state after the static absorptions (label, sizes,
    # index commitments) — everything input-independent is precomputed here
    st = keccak256(b"zokrates-tpu marlin v1")

    def absorb_int(s, v):
        return keccak256(s + int(v).to_bytes(96, "big"))

    for v in (n, k, ni, D):
        st = absorb_int(st, v)
    index_words = []
    for name in ("a", "b", "c"):
        for part in ("row", "col", "val"):
            x, y = _g1_words(d["index_comms"][name][part])
            st = absorb_int(st, x)
            st = absorb_int(st, y)
            index_words.append((x, y))
    # the transcript next absorbs x = [1] + inputs; absorb the leading 1 now
    st = absorb_int(st, 1)

    from ..kernels.ntt import domain_for_curve

    omega = domain_for_curve("bn128", n).omega
    omega_pows = [pow(omega, i, r) for i in range(ni)]

    consts = [
        f"    bytes32 constant INIT_STATE = bytes32(0x{st.hex()});",
        f"    uint constant N = {n};",
        f"    uint constant K = {k};",
        f"    uint constant N_INPUTS = {ni - 1};",
        f"    uint constant D_SHIFT_N = {D - (n - 2)};",
        f"    uint constant D_SHIFT_K = {D - (k - 2)};",
        f"    uint constant K_INV = {pow(k, -1, r)};",
    ]
    g1x, g1y = 1, 2
    consts.append(f"    uint[2] G1 = [uint({g1x}), {g1y}];")
    gx, gy = _g1_words(d["gamma_g"]) if d.get("gamma_g") else (0, 0)
    consts.append(f"    uint[2] GAMMA_G = [uint({gx}), {gy}];")
    h2 = _g2_words(d["h"])
    th2 = _g2_words(d["tau_h"])
    consts.append(
        f"    uint[4] H2 = [uint({h2[0]}), {h2[1]}, {h2[2]}, {h2[3]}];"
    )
    consts.append(
        f"    uint[4] TAU_H2 = [uint({th2[0]}), {th2[1]}, {th2[2]}, {th2[3]}];"
    )

    omega_fn = ["    function OMEGA_POWS(uint i) internal pure returns (uint) {"]
    for i, w in enumerate(omega_pows):
        omega_fn.append(f"        if (i == {i}) return {w};")
    omega_fn.append("        revert();")
    omega_fn.append("    }")

    idx_fn = [
        "    function INDEX_COMM(uint i) internal pure returns (uint[2] memory) {"
    ]
    for i, (x, y) in enumerate(index_words):
        idx_fn.append(f"        if (i == {i}) return [uint({x}), {y}];")
    idx_fn.append("        revert();")
    idx_fn.append("    }")

    return (
        HEADER
        + "\n".join(consts)
        + "\n"
        + "\n".join(omega_fn)
        + "\n"
        + "\n".join(idx_fn)
        + BODY
    )
