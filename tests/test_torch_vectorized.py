"""The port's levelized witness generator (zokrates_tpu_torch.interp.
vectorized) against the JAX package's (zokrates_tpu.interp.vectorized) and
both scalar interpreters, on the CPU, where emul and ereduce_wide run their
plain versions:

  * build_plan on bench_artifacts/sha256.out, read by each package's own
    reader: segments, levels, groups (solver, k, arity, outputs, COO
    arrays), host groups and the check batch, array for array;
  * the programs of tests/test_vectorized.py (field arithmetic with Div,
    Bits and comparison, ConditionEq, u32 EuclideanDiv and bit logic, the
    sha256 round), compiled by zokrates_tpu.lang, serialized and read back
    by the port's reader: the port's witness equals the JAX package's
    Interpreter on the reference's own program, with the same inputs as
    tests/test_vectorized.py (which holds the JAX VectorizedInterpreter
    equal to that Interpreter); the JAX VectorizedInterpreter itself runs
    on the Div program only (its XLA compiles take 5-10 s a program);
  * errors and logs: a failed assert, a wrong input count, the logs;
  * a directive with no device version (a Zir lambda) runs in a host
    segment;
  * the fallback rules: a PlanError gives the scalar witness, a host
    solver's exception the scalar walk's, and an exception of a kernel
    wrapper (emul made to raise) propagates out of execute.

Tolerance: exact equality of witness values, errors and logs.
"""

import io
import os

import numpy as np
import pytest
import torch

from zokrates_tpu.interp.interpreter import Interpreter as JInterpreter
from zokrates_tpu.interp.interpreter import UnsatisfiedConstraint as JUnsatisfied
from zokrates_tpu.interp.vectorized import VectorizedInterpreter as JVectorized
from zokrates_tpu.interp.vectorized import build_plan as j_build_plan
from zokrates_tpu.ir.serialize import deserialize as j_deserialize
from zokrates_tpu.ir.serialize import serialize as j_serialize
from zokrates_tpu.lang.compile import compile_source
from zokrates_tpu_torch.interp import vectorized as V
from zokrates_tpu_torch.interp.interpreter import Interpreter, UnsatisfiedConstraint, WrongInputCount
from zokrates_tpu_torch.ir.program import Directive, LinComb, QuadComb, Solver
from zokrates_tpu_torch.ir.serialize import deserialize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHA256 = os.path.join(ROOT, "bench_artifacts", "sha256.out")

PROGRAMS = {
    "field_arith_div": ("def main(private field a, field b) -> field {\n"
                        "    field c = a * a + b;\n"
                        "    field d = c / (a + 1);\n"
                        "    return d * d;\n"
                        "}\n", [[7, 5], [0, 3]]),
    "bits_comparison": ("def main(field a, field b) -> bool {\n"
                        "    return a < b;\n"
                        "}\n", [[3, 9], [9, 3]]),
    "condition_eq": ("def main(field a) -> bool {\n"
                     "    return a == 42;\n"
                     "}\n", [[42], [41]]),
    "u32_euclidean_div": ("def main(u32 a, u32 b) -> u32[3] {\n"
                          "    u32 q = a / b;\n"
                          "    u32 r = a % b;\n"
                          "    u32 x = a ^ (b | (a & b));\n"
                          "    return [q, r, x];\n"
                          "}\n", [[1000003, 97], [0xFFFFFFFF, 1]]),
    "sha256round": ('import "hashes/sha256/512bitPadded" as sha256;\n'
                    "def main(u32[8] a, u32[8] b) -> u32[8] {\n"
                    "    return sha256(a, b);\n"
                    "}\n", [list(range(1, 17))]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(src, debug=False):
    """(the JAX package's program, the port's reading of its bytes)."""
    jprog = compile_source(src, curve="bn128", debug=debug).prog
    return jprog, deserialize(j_serialize(jprog))


@pytest.fixture(scope="module")
def sha256_progs():
    with open(SHA256, "rb") as f:
        data = f.read()
    return j_deserialize(data), deserialize(data)


def _same_quads(a, b):
    assert a.k == b.k
    for name in ("l_rows", "l_cols", "r_rows", "r_cols"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).dtype == getattr(b, name).dtype
    for name in ("l_coef", "r_coef"):
        assert list(getattr(a, name)) == list(getattr(b, name)), name


def test_plan_equals_reference_on_sha256(sha256_progs):
    jprog, prog = sha256_progs
    want, got = j_build_plan(jprog), V.build_plan(prog)
    assert (got.curve, got.num_dense, got.var_of_dense) == (want.curve, want.num_dense, want.var_of_dense)
    assert got.dense_of_var == want.dense_of_var
    assert np.array_equal(got.arg_idx, want.arg_idx) and got.arg_idx.dtype == want.arg_idx.dtype
    assert [len(s) for s in got.segments] == [len(s) for s in want.segments]
    assert (len(got.segments), sum(map(len, got.segments))) == (8, 191)
    n_groups = 0
    for gs, ws in zip(got.segments, want.segments):
        for gl, wl in zip(gs, ws):
            assert len(gl.groups) == len(wl.groups)
            for g, w in zip(gl.groups, wl.groups):
                assert (None if g.solver is None else (g.solver.name, g.solver.arg)) == \
                    (None if w.solver is None else (w.solver.name, w.solver.arg))
                assert (g.arity, g.n_out) == (w.arity, w.n_out)
                assert np.array_equal(g.out_idx, w.out_idx) and g.out_idx.dtype == w.out_idx.dtype
                _same_quads(g.quads, w.quads)
                n_groups += 1
    assert n_groups == 432
    assert [h is None for h in got.host_groups] == [h is None for h in want.host_groups]
    assert all(h is None for h in got.host_groups)
    gc, wc = got.checks, want.checks
    _same_quads(gc.quads, wc.quads)
    for name in ("lin_rows", "lin_cols"):
        assert np.array_equal(getattr(gc, name), getattr(wc, name))
    assert list(gc.lin_coef) == list(wc.lin_coef)
    assert gc.errors == wc.errors and gc.quads.k == 25499
    assert len(got.logs) == len(want.logs)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_witness_equals_reference(name):
    src, cases = PROGRAMS[name]
    jprog, prog = _compile(src)
    vi = V.VectorizedInterpreter(device="cpu")
    for inputs in cases:
        want = JInterpreter().execute(jprog, inputs).values
        if name == "field_arith_div":  # each JAX segment's XLA compile takes 5-10 s here
            assert JVectorized().execute(jprog, inputs).values == want
        assert vi.execute(prog, inputs).values == want
        assert Interpreter().execute(prog, inputs).values == want


def test_failed_assertion_and_input_count():
    jprog, prog = _compile("def main(field a) {\n    assert(a == 1);\n    return;\n}\n")
    vi = V.VectorizedInterpreter(device="cpu")
    with pytest.raises(JUnsatisfied) as want:
        JInterpreter().execute(jprog, [2])
    with pytest.raises(UnsatisfiedConstraint) as got:
        vi.execute(prog, [2])
    assert str(got.value) == str(want.value)
    assert vi.execute(prog, [1]).values == JInterpreter().execute(jprog, [1]).values
    with pytest.raises(WrongInputCount):
        vi.execute(prog, [1, 2])


def test_logs_identical():
    jprog, prog = _compile("def main(field a) -> field {\n"
                           '    log("a is {}", a);\n'
                           "    return a + 1;\n"
                           "}\n", debug=True)
    want, got = io.StringIO(), io.StringIO()
    JInterpreter().execute(jprog, [5], log_stream=want)
    V.VectorizedInterpreter(device="cpu").execute(prog, [5], log_stream=got)
    assert got.getvalue() == want.getvalue()
    assert want.getvalue().startswith("a is ")


def test_plan_error_falls_back_to_scalar(monkeypatch):
    jprog, prog = _compile(PROGRAMS["field_arith_div"][0])

    def refuse(prog):
        raise V.PlanError("refused")

    monkeypatch.setattr(V, "build_plan", refuse)
    assert V.VectorizedInterpreter(device="cpu").execute(prog, [7, 5]).values == \
        JInterpreter().execute(jprog, [7, 5]).values


def _with_host_solver(prog):
    """prog with one statement more: a directive of a solver with no device
    version (a Zir lambda), out = a + 1, at the end."""
    a = prog.arguments[0].id
    out = max(v for s in prog.statements for v in getattr(s, "outputs", [])) + 1000
    zir = Solver("Zir", lambda ins, field: [(ins[0] + 1) % field.P])
    prog.statements.append(Directive([QuadComb(LinComb.from_var(a), LinComb.one())], [out], zir))
    return prog, out


def test_host_solver_runs_on_host_and_its_errors_fall_back(monkeypatch):
    _, prog = _compile(PROGRAMS["field_arith_div"][0])
    prog, out = _with_host_solver(prog)
    plan = V.build_plan(prog)
    assert sum(h is not None for h in plan.host_groups) == 1
    got = V.VectorizedInterpreter(device="cpu").execute(prog, [7, 5])
    assert got.values == Interpreter().execute(prog, [7, 5]).values and got[out] == 8

    calls = []

    def fallback(self, prog_, inputs, log_stream=None):
        calls.append(inputs)
        return "scalar"

    # a host solver raising something else than an ExecutionError: the scalar walk
    prog.statements[-1].solver = Solver("Zir", lambda ins, field: 1 // 0)
    monkeypatch.setattr(V.Interpreter, "execute", fallback)
    assert V.VectorizedInterpreter(device="cpu").execute(prog, [7, 5]) == "scalar"
    assert calls == [[7, 5]]


def test_kernel_errors_propagate(monkeypatch):
    """No catch turns an error of a kernel wrapper into a scalar witness."""
    _, prog = _compile(PROGRAMS["field_arith_div"][0])

    def broken(p, a, b):
        raise RuntimeError("emul launch failed: CUDA error 700")

    monkeypatch.setattr(V.pallas_field, "emul", broken)
    monkeypatch.setattr(V.Interpreter, "execute", lambda *a, **k: pytest.fail("fell back to the scalar walk"))
    with pytest.raises(RuntimeError, match="emul launch failed"):
        V.VectorizedInterpreter(device="cpu").execute(prog, [7, 5])
