"""Witness generation: streaming R1CS interpreter.

Semantics mirror zokrates_interpreter/src/lib.rs:40-138 exactly:
  * witness starts with ~one = 1 and the program arguments bound to inputs,
  * a Constraint either assigns (lin is a fresh single variable with
    coefficient 1) or checks equality and fails with the attached error,
  * a Directive evaluates its input quads and runs a solver
    (lib.rs:167-352 for the solver dispatch table).

The `try_out_of_range` mode reproduces the reference's adversarial bit
decomposition (lib.rs:140-165) used to stress-test `<` flattening soundness.

A vectorized/levelized generator for large witness batches lives in
interp/vectorized.py; this scalar version is the semantic reference and the
fallback for exotic solvers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..ir.program import Constraint, Directive, LinComb, LogStatement, Prog, QuadComb, Solver
from ..ir.witness import Witness


class ExecutionError(Exception):
    pass


class UnsatisfiedConstraint(ExecutionError):
    def __init__(self, error: Optional[str]):
        self.error = error
        super().__init__(f"Execution failed: {error or 'constraint not satisfied'}")


class WrongInputCount(ExecutionError):
    def __init__(self, expected, received):
        super().__init__(f"expected {expected} input values, received {received}")


class SolverError(ExecutionError):
    pass


def evaluate_lin(witness: Dict[int, int], lin: LinComb, p: int) -> int:
    acc = 0
    for v, c in lin.terms:
        if v not in witness:
            raise ExecutionError(f"variable {v} not yet computed")
        acc += c * witness[v]
    return acc % p


def evaluate_quad(witness: Dict[int, int], quad: QuadComb, p: int) -> int:
    return evaluate_lin(witness, quad.left, p) * evaluate_lin(witness, quad.right, p) % p


class Interpreter:
    def __init__(self, try_out_of_range: bool = False):
        self.try_out_of_range = try_out_of_range

    def execute(
        self,
        prog: Prog,
        inputs: Sequence[int],
        log_stream=None,
    ) -> Witness:
        field = prog.field
        p = field.P
        if len(prog.arguments) != len(inputs):
            raise WrongInputCount(len(prog.arguments), len(inputs))

        witness: Dict[int, int] = {0: 1}
        for arg, value in zip(prog.arguments, inputs):
            witness[arg.id] = int(value) % p

        for stmt in prog.statements:
            if isinstance(stmt, Constraint):
                if stmt.lin.is_assignee(witness):
                    witness[stmt.lin.terms[0][0]] = evaluate_quad(witness, stmt.quad, p)
                else:
                    lhs = evaluate_quad(witness, stmt.quad, p)
                    rhs = evaluate_lin(witness, stmt.lin, p)
                    if lhs != rhs:
                        raise UnsatisfiedConstraint(stmt.error)
            elif isinstance(stmt, Directive):
                ins = [evaluate_quad(witness, i, p) for i in stmt.inputs]
                if (
                    self.try_out_of_range
                    and stmt.solver.name == "Bits"
                    and stmt.solver.arg >= field.BITS
                ):
                    res = _out_of_range_bits(field, stmt.solver.arg, ins[-1])
                else:
                    res = execute_solver(stmt.solver, ins, field, prog.solvers)
                for var, val in zip(stmt.outputs, res):
                    witness[var] = val % p
            elif isinstance(stmt, LogStatement):
                if log_stream is not None:
                    parts = stmt.format_string.split("{}")
                    out = [parts[0]]
                    for (ty, lins), part in zip(stmt.expressions, parts[1:]):
                        vals = [evaluate_lin(witness, l, p) for l in lins]
                        out.append(_format_log_value(ty, vals))
                        out.append(part)
                    log_stream.write("".join(out) + "\n")
            else:
                raise ExecutionError(f"unknown statement {stmt!r}")

        return Witness(witness)


def _format_log_value(ty, vals: List[int]) -> str:
    """ABI-decode log values to their JSON form (best-effort until the ABI
    module wires in richer types)."""
    from ..abi import decode_value  # late import to avoid cycle

    try:
        import json

        return json.dumps(decode_value(vals, ty))
    except Exception:
        return str(vals if len(vals) > 1 else vals[0])


def _out_of_range_bits(field, bit_width: int, value: int) -> List[int]:
    """Reference lib.rs:140-165: produce the 'other' valid decomposition
    value + p when it still fits in get_required_bits bits."""
    candidate = value + field.P
    v = candidate if candidate < (1 << field.BITS) else value
    padding = bit_width - field.BITS
    bits = [0] * padding
    state = v
    for i in reversed(range(field.BITS)):
        if (1 << i) <= state:
            state -= 1 << i
            bits.append(1)
        else:
            bits.append(0)
    return bits


def execute_solver(solver: Solver, inputs: List[int], field, solvers: Sequence[Solver] = ()) -> List[int]:
    """Solver dispatch (reference zokrates_interpreter/src/lib.rs:167-352)."""
    p = field.P
    if solver.name == "Ref":
        solver = solvers[solver.arg]

    name = solver.name
    if name == "ConditionEq":
        x = inputs[0]
        if x == 0:
            return [0, 1]
        return [1, pow(x, -1, p)]
    if name == "Bits":
        width = solver.arg
        v = inputs[0]
        bits = [(v >> i) & 1 for i in reversed(range(width))]
        if v >> width:
            # keep only `width` least significant bits (reference keeps at
            # most bit_width starting from least significant)
            bits = [(v >> i) & 1 for i in reversed(range(width))]
        return bits
    if name == "Div":
        if inputs[1] % p == 0:
            return [1]
        return [inputs[0] * pow(inputs[1], -1, p) % p]
    if name == "Xor":
        x, y = inputs
        return [(x + y - 2 * x * y) % p]
    if name == "Or":
        x, y = inputs
        return [(x + y - x * y) % p]
    if name == "ShaAndXorAndXorAnd":
        a, b, c = inputs
        return [(b * c - (2 * b * c - b - c) * a) % p]
    if name == "ShaCh":
        a, b, c = inputs
        return [(a * (b - c) + c) % p]
    if name == "EuclideanDiv":
        n, d = inputs
        q = n // d if d != 0 else 0
        r = n - d * q
        return [q % p, r % p]
    if name == "Zir":
        func = solver.arg  # a callable or a ZirFunction with .evaluate
        if not callable(func):
            # ir/serialize keeps Zir solvers undecoded: evaluating one needs lang/
            raise SolverError("Zir directive solver: not supported by zokrates_tpu_torch")
        return func(inputs, field)
    if name == "Sha256Round":
        # Our compiler inlines the sha256round embed as flattener gadgets
        # (lang/embeds.py), so it never emits this solver. Reference .out
        # files use it with bellman's gadget-internal wire layout
        # (zokrates_embed/src/bellman.rs:16-319), which has no spec beyond
        # that implementation — interop for such files is not supported.
        raise SolverError(
            "Sha256Round directive solver: this program was compiled by the "
            "reference with the bellman sha256 gadget; recompile the source "
            "with zokrates-tpu (which inlines sha256round)"
        )
    if name == "SnarkVerifyBls12377":
        from ..embed.snark_verify import generate_verify_witness

        n = solver.arg
        return generate_verify_witness(inputs[:n], inputs[n : n + 8], inputs[n + 8 :])
    raise SolverError(f"unknown solver {name}")
