"""snarkjs/circom interop: .r1cs and .wtns writers.

The counterpart of the JAX package's interop/circom.py (host code only).
Byte formats follow the reference zokrates_circom crate (r1cs.rs:8-33,130
and witness.rs:27), which implement the public iden3 binary formats:
  .r1cs: magic "r1cs", version 1, sections (header / constraints / w2l map)
  .wtns: magic "wtns", version 2, sections (header, witness values LE)
"""

from __future__ import annotations

import io
import struct

from ..ir.program import Prog
from ..ir.r1cs import r1cs_from_prog
from ..ir.witness import Witness


def _write_section(out, sid: int, payload: bytes):
    out.write(struct.pack("<iq", sid, len(payload)))
    out.write(payload)


def write_r1cs(out, prog: Prog) -> None:
    field = prog.field
    fbytes = field.NBYTES
    r1cs = r1cs_from_prog(prog)

    n_pub_out = prog.return_count
    n_pub_in = sum(1 for a in prog.arguments if not a.private)
    n_prv_in = sum(1 for a in prog.arguments if a.private)
    n_wires = r1cs.num_variables
    n_constraints = r1cs.num_constraints

    header = io.BytesIO()
    header.write(struct.pack("<i", fbytes))
    header.write(field.P.to_bytes(fbytes, "little"))
    header.write(
        struct.pack(
            "<iiiiqi",
            n_wires,
            n_pub_out,
            n_pub_in,
            n_prv_in,
            n_wires,
            n_constraints,
        )
    )

    def write_lc(buf, row):
        buf.write(struct.pack("<i", len(row)))
        for idx, coef in row:
            buf.write(struct.pack("<i", idx))
            buf.write((coef % field.P).to_bytes(fbytes, "little"))

    constraints = io.BytesIO()
    for a, b, c in zip(r1cs.A, r1cs.B, r1cs.C):
        write_lc(constraints, a)
        write_lc(constraints, b)
        write_lc(constraints, c)

    wire_map = io.BytesIO()
    for i in range(n_wires):
        wire_map.write(struct.pack("<q", i))

    out.write(b"r1cs")
    out.write(struct.pack("<ii", 1, 3))  # version, n sections
    _write_section(out, 1, header.getvalue())
    _write_section(out, 2, constraints.getvalue())
    _write_section(out, 3, wire_map.getvalue())


def write_wtns(out, prog: Prog, witness: Witness) -> None:
    field = prog.field
    fbytes = field.NBYTES
    r1cs = r1cs_from_prog(prog)
    z = r1cs.full_assignment(witness)

    header = io.BytesIO()
    header.write(struct.pack("<i", fbytes))
    header.write(field.P.to_bytes(fbytes, "little"))
    header.write(struct.pack("<i", len(z)))

    values = io.BytesIO()
    for v in z:
        values.write((v % field.P).to_bytes(fbytes, "little"))

    out.write(b"wtns")
    out.write(struct.pack("<ii", 2, 2))
    _write_section(out, 1, header.getvalue())
    _write_section(out, 2, values.getvalue())
