"""Solidity verifier export (bn128 only, like the reference solidity.rs:5-11).

Generates a self-contained Groth16 verifier contract with the reference's
external interface — `verifyTx(Proof memory proof, uint[N] memory input)
returns (bool)` — using the EVM precompiles for bn128 add / scalar-mul /
pairing (EIP-196/197). The template is our own implementation; only the
ABI surface matches zokrates_proof_systems/src/scheme/groth16.rs so
existing integrations keep working.
"""

from __future__ import annotations

from typing import List

from .types import VerificationKey


def _g1(v) -> str:
    return f"Pairing.G1Point(uint256({v[0]}), uint256({v[1]}))"


def _g2(v) -> str:
    # EVM pairing precompile expects Fq2 coefficients in (imaginary, real)
    # word order within each pair
    return (
        "Pairing.G2Point("
        f"[uint256({v[0][1]}), uint256({v[0][0]})], "
        f"[uint256({v[1][1]}), uint256({v[1][0]})])"
    )


PAIRING_LIB = """// This file is MIT Licensed.
pragma solidity ^0.8.0;

library Pairing {
    struct G1Point { uint X; uint Y; }
    struct G2Point { uint[2] X; uint[2] Y; }

    function P1() internal pure returns (G1Point memory) { return G1Point(1, 2); }

    function negate(G1Point memory p) internal pure returns (G1Point memory) {
        uint q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
        if (p.X == 0 && p.Y == 0) return G1Point(0, 0);
        return G1Point(p.X, q - (p.Y % q));
    }

    function addition(G1Point memory p1, G1Point memory p2) internal view returns (G1Point memory r) {
        uint[4] memory input = [p1.X, p1.Y, p2.X, p2.Y];
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 6, input, 0x80, r, 0x60)
        }
        require(success, "pairing-add-failed");
    }

    function scalar_mul(G1Point memory p, uint s) internal view returns (G1Point memory r) {
        uint[3] memory input = [p.X, p.Y, s];
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 7, input, 0x60, r, 0x60)
        }
        require(success, "pairing-mul-failed");
    }

    function pairing(G1Point[] memory p1, G2Point[] memory p2) internal view returns (bool) {
        require(p1.length == p2.length, "pairing-lengths-failed");
        uint elements = p1.length;
        uint inputSize = elements * 6;
        uint[] memory input = new uint[](inputSize);
        for (uint i = 0; i < elements; i++) {
            input[i * 6 + 0] = p1[i].X;
            input[i * 6 + 1] = p1[i].Y;
            input[i * 6 + 2] = p2[i].X[0];
            input[i * 6 + 3] = p2[i].X[1];
            input[i * 6 + 4] = p2[i].Y[0];
            input[i * 6 + 5] = p2[i].Y[1];
        }
        uint[1] memory out;
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 8, add(input, 0x20), mul(inputSize, 0x20), out, 0x20)
        }
        require(success, "pairing-opcode-failed");
        return out[0] != 0;
    }

    function pairingProd4(
        G1Point memory a1, G2Point memory a2,
        G1Point memory b1, G2Point memory b2,
        G1Point memory c1, G2Point memory c2,
        G1Point memory d1, G2Point memory d2
    ) internal view returns (bool) {
        G1Point[] memory p1 = new G1Point[](4);
        G2Point[] memory p2 = new G2Point[](4);
        p1[0] = a1; p1[1] = b1; p1[2] = c1; p1[3] = d1;
        p2[0] = a2; p2[1] = b2; p2[2] = c2; p2[3] = d2;
        return pairing(p1, p2);
    }
}
"""

CONTRACT_TEMPLATE = """
contract Verifier {{
    using Pairing for *;

    struct VerifyingKey {{
        Pairing.G1Point alpha;
        Pairing.G2Point beta;
        Pairing.G2Point gamma;
        Pairing.G2Point delta;
        Pairing.G1Point[] gamma_abc;
    }}

    struct Proof {{
        Pairing.G1Point a;
        Pairing.G2Point b;
        Pairing.G1Point c;
    }}

    function verifyingKey() internal pure returns (VerifyingKey memory vk) {{
        vk.alpha = {alpha};
        vk.beta = {beta};
        vk.gamma = {gamma};
        vk.delta = {delta};
        vk.gamma_abc = new Pairing.G1Point[]({abc_len});
{abc_body}
    }}

    function verify(uint[] memory input, Proof memory proof) internal view returns (uint) {{
        uint snark_scalar_field = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
        VerifyingKey memory vk = verifyingKey();
        require(input.length + 1 == vk.gamma_abc.length);
        Pairing.G1Point memory vk_x = Pairing.G1Point(0, 0);
        for (uint i = 0; i < input.length; i++) {{
            require(input[i] < snark_scalar_field);
            vk_x = Pairing.addition(vk_x, Pairing.scalar_mul(vk.gamma_abc[i + 1], input[i]));
        }}
        vk_x = Pairing.addition(vk_x, vk.gamma_abc[0]);
        if (!Pairing.pairingProd4(
            proof.a, proof.b,
            Pairing.negate(vk_x), vk.gamma,
            Pairing.negate(proof.c), vk.delta,
            Pairing.negate(vk.alpha), vk.beta
        )) return 1;
        return 0;
    }}

    function verifyTx(Proof memory proof, uint[{n_inputs}] memory input) public view returns (bool r) {{
        uint[] memory inputValues = new uint[](input.length);
        for (uint i = 0; i < input.length; i++) {{
            inputValues[i] = input[i];
        }}
        if (verify(inputValues, proof) == 0) {{
            return true;
        }} else {{
            return false;
        }}
    }}
}}
"""


# --------------------------------------------------------------------------
# GM17 (reference zokrates_proof_systems/src/scheme/gm17.rs:37+: same
# external interface; our own implementation of the template + a G2
# addition library, since the EVM has no G2 precompile)
# --------------------------------------------------------------------------

G2_ADD_LIB = """
library BN256G2 {
    uint internal constant FIELD_MODULUS =
        0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47;

    // Fq2 arithmetic: (a + bi), i^2 = -1
    function _fq2mul(uint xx, uint xy, uint yx, uint yy)
        internal pure returns (uint, uint)
    {
        return (
            addmod(mulmod(xx, yx, FIELD_MODULUS),
                   FIELD_MODULUS - mulmod(xy, yy, FIELD_MODULUS), FIELD_MODULUS),
            addmod(mulmod(xx, yy, FIELD_MODULUS),
                   mulmod(xy, yx, FIELD_MODULUS), FIELD_MODULUS)
        );
    }

    function _fq2sub(uint xx, uint xy, uint yx, uint yy)
        internal pure returns (uint, uint)
    {
        return (
            addmod(xx, FIELD_MODULUS - yx, FIELD_MODULUS),
            addmod(xy, FIELD_MODULUS - yy, FIELD_MODULUS)
        );
    }

    function _modInv(uint a) internal view returns (uint result) {
        // a^(p-2) via the modexp precompile
        bool success;
        uint[6] memory input = [
            32, 32, 32, a, FIELD_MODULUS - 2, FIELD_MODULUS
        ];
        uint[1] memory output;
        assembly {
            success := staticcall(sub(gas(), 2000), 5, input, 0xc0, output, 0x20)
        }
        require(success, "modexp-failed");
        return output[0];
    }

    function _fq2inv(uint x, uint y) internal view returns (uint, uint) {
        uint inv = _modInv(
            addmod(mulmod(y, y, FIELD_MODULUS), mulmod(x, x, FIELD_MODULUS),
                   FIELD_MODULUS)
        );
        return (
            mulmod(x, inv, FIELD_MODULUS),
            FIELD_MODULUS - mulmod(y, inv, FIELD_MODULUS)
        );
    }

    /// Affine twist-point addition (handles double and infinity; inputs in
    /// the EVM word order [imag, real] used by the pairing precompile).
    function ecTwistAdd(
        uint[2] memory ax, uint[2] memory ay,
        uint[2] memory bx, uint[2] memory by
    ) internal view returns (uint[2] memory cx, uint[2] memory cy) {
        if (ax[0] == 0 && ax[1] == 0 && ay[0] == 0 && ay[1] == 0) {
            return (bx, by);
        }
        if (bx[0] == 0 && bx[1] == 0 && by[0] == 0 && by[1] == 0) {
            return (ax, ay);
        }
        // work in (real, imag)
        uint x1r = ax[1]; uint x1i = ax[0];
        uint y1r = ay[1]; uint y1i = ay[0];
        uint x2r = bx[1]; uint x2i = bx[0];
        uint y2r = by[1]; uint y2i = by[0];
        uint lr; uint li;
        if (x1r == x2r && x1i == x2i) {
            if (y1r == y2r && y1i == y2i) {
                // doubling: l = 3 x1^2 / (2 y1)
                (uint n_r, uint n_i) = _fq2mul(x1r, x1i, x1r, x1i);
                n_r = mulmod(n_r, 3, FIELD_MODULUS);
                n_i = mulmod(n_i, 3, FIELD_MODULUS);
                (uint d_r, uint d_i) = _fq2inv(
                    addmod(y1r, y1r, FIELD_MODULUS), addmod(y1i, y1i, FIELD_MODULUS)
                );
                (lr, li) = _fq2mul(n_r, n_i, d_r, d_i);
            } else {
                return (cx, cy); // P + (-P) = infinity (zeroed memory)
            }
        } else {
            (uint n_r, uint n_i) = _fq2sub(y2r, y2i, y1r, y1i);
            (uint dd_r, uint dd_i) = _fq2sub(x2r, x2i, x1r, x1i);
            (dd_r, dd_i) = _fq2inv(dd_r, dd_i);
            (lr, li) = _fq2mul(n_r, n_i, dd_r, dd_i);
        }
        (uint x3r, uint x3i) = _fq2mul(lr, li, lr, li);
        (x3r, x3i) = _fq2sub(x3r, x3i, x1r, x1i);
        (x3r, x3i) = _fq2sub(x3r, x3i, x2r, x2i);
        (uint t_r, uint t_i) = _fq2sub(x1r, x1i, x3r, x3i);
        (t_r, t_i) = _fq2mul(lr, li, t_r, t_i);
        (uint y3r, uint y3i) = _fq2sub(t_r, t_i, y1r, y1i);
        cx[0] = x3i; cx[1] = x3r;
        cy[0] = y3i; cy[1] = y3r;
    }
}
"""

GM17_TEMPLATE = """
contract Verifier {{
    using Pairing for *;

    struct VerifyingKey {{
        Pairing.G2Point h;
        Pairing.G1Point g_alpha;
        Pairing.G2Point h_beta;
        Pairing.G1Point g_gamma;
        Pairing.G2Point h_gamma;
        Pairing.G1Point[] query;
    }}

    struct Proof {{
        Pairing.G1Point a;
        Pairing.G2Point b;
        Pairing.G1Point c;
    }}

    function verifyingKey() internal pure returns (VerifyingKey memory vk) {{
        vk.h = {h};
        vk.g_alpha = {g_alpha};
        vk.h_beta = {h_beta};
        vk.g_gamma = {g_gamma};
        vk.h_gamma = {h_gamma};
        vk.query = new Pairing.G1Point[]({query_len});
{query_body}
    }}

    function addG2(Pairing.G2Point memory p, Pairing.G2Point memory q)
        internal view returns (Pairing.G2Point memory r)
    {{
        (uint[2] memory x, uint[2] memory y) =
            BN256G2.ecTwistAdd(p.X, p.Y, q.X, q.Y);
        r.X = x;
        r.Y = y;
    }}

    function verify(uint[] memory input, Proof memory proof) internal view returns (uint) {{
        uint snark_scalar_field = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
        VerifyingKey memory vk = verifyingKey();
        require(input.length + 1 == vk.query.length);
        // psi = query[0] + sum_i input_i * query[i+1]
        Pairing.G1Point memory vk_x = Pairing.G1Point(0, 0);
        for (uint i = 0; i < input.length; i++) {{
            require(input[i] < snark_scalar_field);
            vk_x = Pairing.addition(vk_x, Pairing.scalar_mul(vk.query[i + 1], input[i]));
        }}
        vk_x = Pairing.addition(vk_x, vk.query[0]);
        // e(A + g_alpha, B + h_beta) = e(g_alpha, h_beta) e(psi, h_gamma) e(C, h)
        if (!Pairing.pairingProd4(
            vk.g_alpha, vk.h_beta,
            vk_x, vk.h_gamma,
            proof.c, vk.h,
            Pairing.negate(Pairing.addition(proof.a, vk.g_alpha)),
            addG2(proof.b, vk.h_beta)
        )) return 1;
        // e(A, h_gamma) = e(g_gamma, B)
        if (!Pairing.pairingProd2(
            proof.a, vk.h_gamma,
            Pairing.negate(vk.g_gamma), proof.b
        )) return 2;
        return 0;
    }}

    function verifyTx(Proof memory proof, uint[{n_inputs}] memory input) public view returns (bool r) {{
        uint[] memory inputValues = new uint[](input.length);
        for (uint i = 0; i < input.length; i++) {{
            inputValues[i] = input[i];
        }}
        return verify(inputValues, proof) == 0;
    }}
}}
"""


def export_solidity_verifier(vk: VerificationKey) -> str:
    if vk.curve != "bn128":
        raise ValueError("solidity export is only supported for bn128")
    d = vk.data
    if vk.scheme == "g16":
        abc = d["gamma_abc"]
        abc_body = "\n".join(
            f"        vk.gamma_abc[{i}] = {_g1(pt)};" for i, pt in enumerate(abc)
        )
        contract = CONTRACT_TEMPLATE.format(
            alpha=_g1(d["alpha"]),
            beta=_g2(d["beta"]),
            gamma=_g2(d["gamma"]),
            delta=_g2(d["delta"]),
            abc_len=len(abc),
            abc_body=abc_body,
            n_inputs=len(abc) - 1,
        )
        return PAIRING_LIB + contract
    if vk.scheme == "gm17":
        query = d["query"]
        query_body = "\n".join(
            f"        vk.query[{i}] = {_g1(pt)};" for i, pt in enumerate(query)
        )
        contract = GM17_TEMPLATE.format(
            h=_g2(d["h"]),
            g_alpha=_g1(d["g_alpha"]),
            h_beta=_g2(d["h_beta"]),
            g_gamma=_g1(d["g_gamma"]),
            h_gamma=_g2(d["h_gamma"]),
            query_len=len(query),
            query_body=query_body,
            n_inputs=len(query) - 1,
        )
        return PAIRING_LIB + G2_ADD_LIB + contract
    if vk.scheme == "marlin":
        from .solidity_marlin import export_marlin_verifier

        return export_marlin_verifier(vk)
    raise ValueError(f"solidity export not implemented for scheme {vk.scheme}")


def proof_to_token(proof_json: dict) -> str:
    """ABI-token encoding of a proof for remix / manual contract calls
    (reference to_token.rs:36-40)."""
    pts = proof_json["proof"]
    a = f'["{pts["a"][0]}","{pts["a"][1]}"]'
    b = (
        f'[["{pts["b"][0][0]}","{pts["b"][0][1]}"],'
        f'["{pts["b"][1][0]}","{pts["b"][1][1]}"]]'
    )
    c = f'["{pts["c"][0]}","{pts["c"][1]}"]'
    inputs = ",".join(f'"{v}"' for v in proof_json.get("inputs", []))
    return f"[{a},{b},{c}],[{inputs}]"
