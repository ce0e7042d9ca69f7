"""JSON ABI: encode typed values to field elements and decode back.

Mirrors zokrates_abi/src/lib.rs: the ABI spec is a list of typed parameters
(field / bool / uN / arrays / structs / tuples); `encode` flattens a JSON
value into field elements in declaration order, `decode` rebuilds the JSON
tree from a flat list. Strict parsing rejects shape/type mismatches like the
reference's `parse_strict`.

Type encoding (as produced by the checker, matching abi.json in the
reference):
    {"type": "field"} | {"type": "bool"} | {"type": "u8"|"u16"|"u32"|"u64"}
    {"type": "array", "components": {"size": n, "type": T}}
    {"type": "tuple", "components": {"elements": [T...]}}
    {"type": "struct", "components": {"name": s, "members":
        [{"name": n, "type": T}...]}}
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


class AbiError(Exception):
    pass


def type_size(ty) -> int:
    """Number of field elements a type flattens to."""
    t = ty["type"] if isinstance(ty, dict) else ty
    if t in ("field", "bool", "u8", "u16", "u32", "u64"):
        return 1
    if t == "array":
        comp = ty["components"]
        return int(comp["size"]) * type_size(comp["type"])
    if t == "tuple":
        return sum(type_size(e) for e in ty["components"]["elements"])
    if t == "struct":
        return sum(type_size(m["type"]) for m in ty["components"]["members"])
    raise AbiError(f"unknown type {ty}")


def encode_value(value: Any, ty, p: int) -> List[int]:
    """JSON value -> flat field elements (strict)."""
    t = ty["type"] if isinstance(ty, dict) else ty
    if t == "field":
        if isinstance(value, bool) or not isinstance(value, (str, int)):
            raise AbiError(f"expected field (decimal string), got {value!r}")
        v = int(value, 0) if isinstance(value, str) else int(value)
        if not (0 <= v < p):
            raise AbiError(f"field value {v} out of range")
        return [v]
    if t == "bool":
        if not isinstance(value, bool):
            raise AbiError(f"expected bool, got {value!r}")
        return [1 if value else 0]
    if t in ("u8", "u16", "u32", "u64"):
        width = int(t[1:])
        if isinstance(value, str):
            v = int(value, 0)
        elif isinstance(value, int) and not isinstance(value, bool):
            v = value
        else:
            raise AbiError(f"expected {t} (hex string), got {value!r}")
        if not (0 <= v < (1 << width)):
            raise AbiError(f"{t} value {v} out of range")
        return [v]
    if t == "array":
        comp = ty["components"]
        size, elem = int(comp["size"]), comp["type"]
        if not isinstance(value, list) or len(value) != size:
            raise AbiError(f"expected array of size {size}, got {value!r}")
        out = []
        for item in value:
            out += encode_value(item, elem, p)
        return out
    if t == "tuple":
        elems = ty["components"]["elements"]
        if not isinstance(value, list) or len(value) != len(elems):
            raise AbiError(f"expected tuple of {len(elems)} elements")
        out = []
        for item, ety in zip(value, elems):
            out += encode_value(item, ety, p)
        return out
    if t == "struct":
        members = ty["components"]["members"]
        if not isinstance(value, dict):
            raise AbiError(f"expected struct object, got {value!r}")
        if set(value.keys()) != {m["name"] for m in members}:
            raise AbiError(
                f"struct fields mismatch: got {sorted(value)} expected "
                f"{sorted(m['name'] for m in members)}"
            )
        out = []
        for m in members:
            out += encode_value(value[m["name"]], m["type"], p)
        return out
    raise AbiError(f"unknown type {ty}")


def decode_value(values: List[int], ty) -> Any:
    v, rest = _decode(values, ty)
    if rest:
        raise AbiError(f"{len(rest)} leftover values")
    return v


def _decode(values: List[int], ty) -> Tuple[Any, List[int]]:
    t = ty["type"] if isinstance(ty, dict) else ty
    if t == "field":
        return str(values[0]), values[1:]
    if t == "bool":
        return bool(values[0]), values[1:]
    if t in ("u8", "u16", "u32", "u64"):
        width = int(t[1:])
        return "0x{:0{}x}".format(values[0], width // 4), values[1:]
    if t == "array":
        comp = ty["components"]
        out = []
        for _ in range(int(comp["size"])):
            item, values = _decode(values, comp["type"])
            out.append(item)
        return out, values
    if t == "tuple":
        out = []
        for ety in ty["components"]["elements"]:
            item, values = _decode(values, ety)
            out.append(item)
        return out, values
    if t == "struct":
        out = {}
        for m in ty["components"]["members"]:
            item, values = _decode(values, m["type"])
            out[m["name"]] = item
        return out, values
    raise AbiError(f"unknown type {ty}")


def encode_inputs(values: List[Any], abi_inputs: List[dict], p: int) -> List[int]:
    """Encode the argument list against the ABI's inputs section."""
    if len(values) != len(abi_inputs):
        raise AbiError(f"expected {len(abi_inputs)} inputs, got {len(values)}")
    out = []
    for v, inp in zip(values, abi_inputs):
        out += encode_value(v, inp["type"] if "type" in inp else inp, p)
    return out


def decode_outputs(values: List[int], abi_output: dict) -> Any:
    return decode_value(values, abi_output)
