"""Vectorized (levelized) witness generation on the card.

The counterpart of the JAX package's interp/vectorized.py. The scalar
interpreter (interp/interpreter.py) walks the statements one at a time;
this generator:

  * PLAN (host, once per program, build_plan): levelizes the statements.
    A statement's level is 1 + the highest level of the variables it
    reads; ~one and the arguments sit at level 0. Within a level the
    assigning constraints form one batched quad evaluation and the
    directives are grouped by solver kind; constraints that assign nothing
    are deferred to one check batch at the end, the A*z o B*z == C*z
    residual. Levels are cut into segments of at most MAX_SEG_LEVELS, and
    around the solvers with no device version (host groups). The plan is
    host numpy and equals the reference's array for array.
  * EXECUTE: the witness is a dense (V, nl) int64 tensor of Montgomery
    limbs on the device. Each group gathers its terms' rows of W
    (index_select), multiplies them by the coefficients (emul, the CUDA
    kernel of kernels/pallas_field), sums each row's products as lazy
    int64 column sums (index_add_), reduces the sums (ereduce_wide, CUDA)
    and multiplies the two sides (emul); a solver group then runs its
    solver on the batch (_solver_kernel: every Montgomery product through
    emul, additions, selections and bit work as torch ops) and the
    outputs scatter into W (index_copy_). On a CUDA device every segment
    is captured, on its first run, into one CUDA graph (the counterpart
    of the reference's jax.jit per segment); later calls copy the inputs
    into the static W and replay. A host group downloads W once, runs the
    scalar solvers (interp.interpreter.execute_solver) and scatters their
    outputs back.

Semantics guard: outputs are bit-identical to interp.interpreter. The
generator falls back to the scalar interpreter where the reference does so
for the program's sake: on a PlanError (a program that cannot run out of
order), and when a host solver raises something other than an
ExecutionError (the scalar walk then gives the canonical error in program
order). An ExecutionError is raised as it is (WrongInputCount, a failed
check's UnsatisfiedConstraint). Nothing else is caught: an error of torch,
of the kernels' build or launch (kernels/cuda) or of a kernel wrapper
propagates, and never turns into a scalar witness. The adversarial
try_out_of_range mode is scalar-only, as in the reference.

Launch counts: a capture records launches without making them, so the
counts the wrappers take during a capture (pallas_field.LAUNCHES and
WIDTH_LAUNCHES) are taken back, and each replay adds its graph's. REPLAYS
counts the replays by kind ("segment", "check").
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields.jfield import field_ops
from ..fields.limbs import LIMB_BITS, LIMB_MASK, ints_to_limbs, limbs_to_ints
from ..ir.program import (
    Constraint,
    Directive,
    LinComb,
    LogStatement,
    Prog,
    QuadComb,
    Solver,
)
from ..ir.witness import Witness
from ..kernels import pallas_field
from .interpreter import (
    ExecutionError,
    Interpreter,
    UnsatisfiedConstraint,
    WrongInputCount,
    execute_solver,
)

# Solvers with device versions; everything else splits a host segment.
_DEVICE_SOLVERS = {
    "Bits",
    "ConditionEq",
    "Div",
    "Xor",
    "Or",
    "ShaAndXorAndXorAnd",
    "ShaCh",
    "EuclideanDiv",
}

# terms a row: lazy column sums of 16-bit limb products stay below 2^31,
# far inside ereduce_wide's 2^47 (the reference's cap for its uint32 sums)
_MAX_TERMS = 1 << 15

# levels a segment (the reference's cap on one jitted function)
MAX_SEG_LEVELS = 24

# replays of the generator's CUDA graphs, by kind ("segment", "check")
REPLAYS: Counter = Counter()


class PlanError(Exception):
    """Program shape not vectorizable (use the scalar interpreter)."""


# ---------------------------------------------------------------------------
# Plan data structures (all numpy; moved to the device per plan)
# ---------------------------------------------------------------------------


@dataclass
class _QuadBatch:
    """k quad-combs evaluated as (L·w) ∘ (R·w) over dense witness indices."""

    k: int
    l_rows: np.ndarray
    l_cols: np.ndarray
    l_coef: np.ndarray  # (nnz,) canonical ints, encoded per plan
    r_rows: np.ndarray
    r_cols: np.ndarray
    r_coef: np.ndarray


@dataclass
class _Group:
    solver: Optional[Solver]  # None = assigning constraints
    arity: int
    n_out: int
    quads: _QuadBatch
    out_idx: np.ndarray  # (k * n_out,) dense indices


@dataclass
class _Level:
    groups: List[_Group]


@dataclass
class _CheckBatch:
    """All non-assigning constraints, checked at once at the end."""

    quads: _QuadBatch
    lin_rows: np.ndarray
    lin_cols: np.ndarray
    lin_coef: np.ndarray
    errors: List[Optional[str]]


@dataclass
class _Plan:
    curve: str
    num_dense: int
    var_of_dense: List[int]
    dense_of_var: Dict[int, int]
    arg_idx: np.ndarray  # dense indices of prog.arguments, in order
    segments: List[List[_Level]]  # device segments
    host_groups: List[Optional[List[Tuple[Directive, List[int]]]]]
    # host_groups[i] runs after segments[i] (None after the last)
    checks: Optional[_CheckBatch]
    logs: List[LogStatement]
    _exec: dict = dfield(default_factory=dict)  # device state, by device


def _quad_batch(quads: List[QuadComb], dense: Dict[int, int]) -> _QuadBatch:
    lr, lc, lv = [], [], []
    rr, rc, rv = [], [], []
    for i, q in enumerate(quads):
        if len(q.left.terms) > _MAX_TERMS or len(q.right.terms) > _MAX_TERMS:
            raise PlanError("quad row too wide for lazy accumulation")
        for v, c in q.left.terms:
            lr.append(i)
            lc.append(dense[v])
            lv.append(c)
        for v, c in q.right.terms:
            rr.append(i)
            rc.append(dense[v])
            rv.append(c)
    if not lr:
        lr, lc, lv = [0], [0], [0]
    if not rr:
        rr, rc, rv = [0], [0], [0]
    return _QuadBatch(
        k=len(quads),
        l_rows=np.asarray(lr, np.int32),
        l_cols=np.asarray(lc, np.int32),
        l_coef=np.asarray(lv, object),
        r_rows=np.asarray(rr, np.int32),
        r_cols=np.asarray(rc, np.int32),
        r_coef=np.asarray(rv, object),
    )


def build_plan(prog: Prog) -> _Plan:
    """Levelize `prog` (host-side, one pass). Raises PlanError when the
    program cannot be executed out of order (use-before-def, double
    definition, unsupported shapes)."""
    dense: Dict[int, int] = {0: 0}
    var_of_dense: List[int] = [0]
    level_of: Dict[int, int] = {0: 0}

    def ensure(v: int) -> int:
        if v not in dense:
            dense[v] = len(var_of_dense)
            var_of_dense.append(v)
        return dense[v]

    arg_idx = []
    for a in prog.arguments:
        ensure(a.id)
        level_of[a.id] = 0
        arg_idx.append(dense[a.id])

    # pass 1: statement levels
    defined = set(level_of)
    # per level: {"assign": [(quad, out_var)], (solver key): [(directive, solver)]}
    levels: List[Dict] = []
    check_list: List[Constraint] = []
    logs: List[LogStatement] = []

    def stmt_level(vars_used) -> int:
        lv = 0
        for v in vars_used:
            if v not in level_of:
                raise PlanError(f"variable {v} used before definition")
            lv = max(lv, level_of[v])
        return lv

    def at_level(lv: int) -> Dict:
        while len(levels) <= lv:
            levels.append({})
        return levels[lv]

    for stmt in prog.statements:
        if isinstance(stmt, Constraint):
            t = stmt.lin.terms
            if len(t) == 1 and t[0][1] == 1 and t[0][0] not in defined:
                out = t[0][0]
                lv = stmt_level(stmt.quad.left.variables() + stmt.quad.right.variables())
                at_level(lv).setdefault("assign", []).append((stmt.quad, out))
                level_of[out] = lv + 1
                defined.add(out)
                ensure(out)
            else:
                stmt_level(
                    stmt.quad.left.variables() + stmt.quad.right.variables() + stmt.lin.variables()
                )  # validates defined-ness
                check_list.append(stmt)
        elif isinstance(stmt, Directive):
            used = []
            for q in stmt.inputs:
                used += q.left.variables() + q.right.variables()
            lv = stmt_level(used)
            solver = stmt.solver
            if solver.name == "Ref":
                solver = prog.solvers[solver.arg]
            key = (solver.name, solver.arg if solver.name == "Bits" else id(solver))
            if solver.name in {"Xor", "Or", "ShaAndXorAndXorAnd", "ShaCh", "ConditionEq", "Div", "EuclideanDiv"}:
                key = (solver.name,)
            at_level(lv).setdefault(key, []).append((stmt, solver))
            for out in stmt.outputs:
                if out in defined:
                    raise PlanError(f"variable {out} defined twice")
                level_of[out] = lv + 1
                defined.add(out)
                ensure(out)
        elif isinstance(stmt, LogStatement):
            logs.append(stmt)
        else:
            raise PlanError(f"unknown statement {stmt!r}")

    # pass 2: device groups and host groups per level, cut into segments of
    # at most MAX_SEG_LEVELS levels and around every host group
    segments: List[List[_Level]] = [[]]
    host_groups: List[Optional[List[Tuple[Directive, List[int]]]]] = []

    for lvl in levels:
        device_groups: List[_Group] = []
        host: List[Tuple[Directive, List[int]]] = []
        for key, items in lvl.items():
            if key == "assign":
                quads = [q for q, _ in items]
                outs = np.asarray([dense[v] for _, v in items], np.int32)
                device_groups.append(_Group(None, 1, 1, _quad_batch(quads, dense), outs))
                continue
            solver = items[0][1]
            if solver.name in _DEVICE_SOLVERS:
                n_in, n_out = solver.signature(prog.solvers)
                quads = []
                outs = []
                for d, _ in items:
                    if len(d.inputs) != n_in or len(d.outputs) != n_out:
                        raise PlanError("directive arity mismatch")
                    quads += d.inputs
                    outs += [dense[v] for v in d.outputs]
                device_groups.append(
                    _Group(solver, n_in, n_out, _quad_batch(quads, dense), np.asarray(outs, np.int32))
                )
            else:
                for d, s in items:
                    host.append((d, [dense[v] for v in d.outputs]))
        if device_groups:
            if len(segments[-1]) >= MAX_SEG_LEVELS:
                host_groups.append(None)
                segments.append([])
            segments[-1].append(_Level(device_groups))
        if host:
            host_groups.append(host)
            segments.append([])

    while len(host_groups) < len(segments):
        host_groups.append(None)

    check_batch = None
    if check_list:
        cq = _quad_batch([c.quad for c in check_list], dense)
        lr, lc, lv = [], [], []
        for i, c in enumerate(check_list):
            for v, co in c.lin.terms:
                lr.append(i)
                lc.append(dense[v])
                lv.append(co)
        if not lr:
            lr, lc, lv = [0], [0], [0]
        check_batch = _CheckBatch(
            quads=cq,
            lin_rows=np.asarray(lr, np.int32),
            lin_cols=np.asarray(lc, np.int32),
            lin_coef=np.asarray(lv, object),
            errors=[c.error for c in check_list],
        )

    return _Plan(
        curve=prog.curve,
        num_dense=len(var_of_dense),
        var_of_dense=var_of_dense,
        dense_of_var=dense,
        arg_idx=np.asarray(arg_idx, np.int32),
        segments=segments,
        host_groups=host_groups,
        checks=check_batch,
        logs=logs,
    )


# ---------------------------------------------------------------------------
# Device execution
# ---------------------------------------------------------------------------


class _Field:
    """One field's constants on one device, and its Montgomery products
    through the emul kernel."""

    def __init__(self, p: int, device):
        self.f = field_ops(p)
        self.p, self.nl, self.device = p, self.f.nl, device
        limbs = lambda x: torch.as_tensor(ints_to_limbs([x], self.nl)[0].astype(np.int64), device=device)
        self.one = limbs(1)                       # canonical 1: from Montgomery form
        self.r2 = limbs(self.f.spec.r2)           # R^2: to Montgomery form
        self.one_m = limbs(self.f.spec.r)         # 1 in Montgomery form
        self.zero = torch.zeros(self.nl, dtype=torch.int64, device=device)
        # the Fermat exponent p - 2, its bits after the leading one
        self.inv_bits = [b == "1" for b in bin(p - 2)[3:]]

    def mul(self, a, b):
        """Montgomery product of (k, nl) rows a and b, b (k, nl) or one
        (nl,) row for all."""
        if b.dim() == 1:
            b = b.expand(a.shape)
        return pallas_field.emul(self.p, a[None], b)[0]

    def to_mont(self, a):
        return self.mul(a, self.r2)

    def from_mont(self, a):
        return self.mul(a, self.one)

    def inv(self, x):
        """x^(p-2) by square and multiply (0 -> 0)."""
        acc = x
        for bit in self.inv_bits:
            acc = self.mul(acc, acc)
            if bit:
                acc = self.mul(acc, x)
        return acc

    def encode(self, arrays):
        """Coefficient arrays (canonical ints) -> one (n, nl) tensor of
        Montgomery limbs on the device, each distinct value encoded once
        (one emul by R^2 for the whole plan, then a gather), and its
        slices, one an array."""
        p, index, invs = self.p, {}, []
        for arr in arrays:
            inv = np.empty(len(arr), np.int64)
            for i, c in enumerate(arr):
                c = int(c) % p
                j = index.get(c)
                if j is None:
                    j = index[c] = len(index)
                inv[i] = j
            invs.append(inv)
        table = torch.as_tensor(ints_to_limbs(list(index), self.nl).astype(np.int64), device=self.device)
        coefs = self.to_mont(table).index_select(0, torch.as_tensor(np.concatenate(invs), device=self.device))
        ends = np.cumsum([len(a) for a in arrays])
        return [coefs[e - len(a):e] for a, e in zip(arrays, ends)]


class _Terms:
    """The terms of n blocks of k rows (a quad batch's left and right
    sides; the check batch's lin side too) merged into one product and one
    reduction: block j's rows at j*k."""

    def __init__(self, k: int, parts, device):
        t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
        self.k, self.n = k, len(parts)
        self.rows = t(np.concatenate([rows.astype(np.int64) + j * k for j, (rows, _) in enumerate(parts)]))
        self.cols = t(np.concatenate([cols for _, cols in parts]))
        self.coef = None  # (terms, nl) Montgomery, set by _DevPlan

    @staticmethod
    def quads(qb: _QuadBatch, device) -> "_Terms":
        return _Terms(qb.k, [(qb.l_rows, qb.l_cols), (qb.r_rows, qb.r_cols)], device)

    def sums(self, F: _Field, W):
        """(n*k, nl) canonical Montgomery sums of coef * W[cols] by row."""
        prods = F.mul(W.index_select(0, self.cols), self.coef)
        sums = torch.zeros((self.n * self.k, F.nl), dtype=torch.int64, device=W.device)
        sums.index_add_(0, self.rows, prods)
        return pallas_field.ereduce_wide(F.p, sums[None])[0]


def _eval_quads(F: _Field, sums, k: int):
    """(k, nl) Montgomery values of k quads from their sides' row sums."""
    return F.mul(sums[:k], sums[k:2 * k])


def _shl1_with_bit(limbs, bit):
    """(k, nl) little-endian 16-bit limbs << 1 | bit (bit: (k,) in {0, 1})."""
    carry = torch.cat([bit[:, None], limbs[:, :-1] >> (LIMB_BITS - 1)], dim=1)
    return ((limbs << 1) & LIMB_MASK) | carry


class _BitsAt:
    """The limb index, shift and validity of bit positions nbits-1 .. 0 (MSB
    first) of nl-limb values, on the device."""

    def __init__(self, nbits: int, nl: int, device):
        pos = np.arange(nbits - 1, -1, -1)
        t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
        self.li = t(np.minimum(pos // LIMB_BITS, nl - 1))
        self.sh = t(pos % LIMB_BITS)
        self.valid = t(pos // LIMB_BITS < nl)

    def __call__(self, v_can):
        """(k, nl) canonical limbs -> (k, nbits) bits, index 0 = MSB."""
        return ((v_can.index_select(1, self.li) >> self.sh) & 1) * self.valid


def _solver_kernel(F: _Field, solver: Solver, ins, bits: Optional[_BitsAt]):
    """ins: (k, arity, nl) Montgomery -> (k, n_out, nl) Montgomery."""
    f, name = F.f, solver.name
    col = lambda i: ins[:, i].contiguous()
    if name == "Bits":
        b = bits(F.from_mont(col(0)))  # (k, w)
        return torch.where((b == 1)[..., None], F.one_m, F.zero)
    if name == "ConditionEq":
        x = col(0)
        z = f.is_zero(x)
        out0 = f.select(z, F.zero, F.one_m)
        out1 = f.select(z, F.one_m, F.inv(x))
        return torch.stack([out0, out1], dim=1)
    if name == "Div":
        a, b = col(0), col(1)
        res = f.select(f.is_zero(b), F.one_m, F.mul(a, F.inv(b)))
        return res[:, None]
    if name == "Xor":
        x, y = col(0), col(1)
        xy = F.mul(x, y)
        return f.sub(f.add(x, y), f.add(xy, xy))[:, None]
    if name == "Or":
        x, y = col(0), col(1)
        return f.sub(f.add(x, y), F.mul(x, y))[:, None]
    if name == "ShaAndXorAndXorAnd":
        a, b, c = col(0), col(1), col(2)
        t = F.mul(b, c)
        return f.sub(t, F.mul(f.sub(f.add(t, t), f.add(b, c)), a))[:, None]
    if name == "ShaCh":
        a, b, c = col(0), col(1), col(2)
        return f.add(F.mul(a, f.sub(b, c)), c)[:, None]
    if name == "EuclideanDiv":
        n_can = F.from_mont(col(0))
        d_can = F.from_mont(col(1))
        nb = bits(n_can)  # (k, nl * 16), MSB first
        q = torch.zeros_like(n_can)
        rem = torch.zeros_like(n_can)
        for i in range(nb.shape[1]):
            rem = _shl1_with_bit(rem, nb[:, i])
            diff, borrow = f.borrow_sub(rem, d_can)
            ge = borrow == 0
            rem = torch.where(ge[:, None], diff, rem)
            q = _shl1_with_bit(q, ge.to(torch.int64))
        dz = f.is_zero(d_can)
        q = torch.where(dz[:, None], torch.zeros_like(q), q)
        rem = torch.where(dz[:, None], n_can, rem)
        return torch.stack([F.to_mont(q), F.to_mont(rem)], dim=1)
    raise PlanError(f"no device version of solver {name}")


class _HostSolverFailed(Exception):
    """A host solver raised something other than an ExecutionError."""


@dataclass
class _DevGroup:
    group: _Group
    terms: _Terms
    out_idx: torch.Tensor
    bits: Optional[_BitsAt]


class _DevPlan:
    """A plan's device state: its index and coefficient tensors, the
    static witness W, and the CUDA graphs of its segments and check
    (captured on first use)."""

    def __init__(self, plan: _Plan, p: int, device):
        F = self.F = _Field(p, device)
        nl = F.nl
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        self.device = device
        self.W = torch.zeros((plan.num_dense, nl), dtype=torch.int64, device=device)
        self.inp = torch.zeros((len(plan.arg_idx), nl), dtype=torch.int64, device=device)
        self.arg_idx = idx(plan.arg_idx)
        terms, coefs = [], []
        self.segments = []
        for seg in plan.segments:
            levels = []
            for lvl in seg:
                groups = []
                for g in lvl.groups:
                    bits = None
                    if g.solver is not None and g.solver.name in ("Bits", "EuclideanDiv"):
                        bits = _BitsAt(g.solver.arg if g.solver.name == "Bits" else nl * LIMB_BITS, nl, device)
                    groups.append(_DevGroup(g, _Terms.quads(g.quads, device), idx(g.out_idx), bits))
                    terms.append(groups[-1].terms)
                    coefs.append(np.concatenate([g.quads.l_coef, g.quads.r_coef]))
                levels.append(groups)
            self.segments.append(levels)
        self.check = None
        if plan.checks is not None:
            cb = plan.checks
            q = cb.quads
            self.check = _Terms(q.k, [(q.l_rows, q.l_cols), (q.r_rows, q.r_cols), (cb.lin_rows, cb.lin_cols)],
                                device)
            terms.append(self.check)
            coefs.append(np.concatenate([q.l_coef, q.r_coef, cb.lin_coef]))
            self.ok = torch.zeros(q.k, dtype=torch.bool, device=device)
        for t, c in zip(terms, F.encode(coefs)):
            t.coef = c
        self.graphs: Dict[Tuple[str, int], tuple] = {}
        self.pool = torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None

    def run_segment(self, i: int):
        F, W = self.F, self.W
        if i == 0:
            W.zero_()
            W[0] = F.one_m
            if len(self.arg_idx):
                W.index_copy_(0, self.arg_idx, F.to_mont(self.inp))
        for groups in self.segments[i]:
            for dg in groups:
                g, k = dg.group, dg.terms.k
                vals = _eval_quads(F, dg.terms.sums(F, W), k)
                if g.solver is not None:
                    vals = _solver_kernel(F, g.solver, vals.reshape(k // g.arity, g.arity, F.nl),
                                          dg.bits).reshape(-1, F.nl)
                W.index_copy_(0, dg.out_idx, vals)

    def run_check(self, i: int = 0):
        k = self.check.k
        sums = self.check.sums(self.F, self.W)
        self.ok.copy_((_eval_quads(self.F, sums, k) == sums[2 * k:]).all(-1))

    def step(self, kind: str, i: int, fn):
        """Run fn(i): eagerly on the CPU; on a CUDA device eagerly the first
        time (this call's result), then captured into a CUDA graph that
        later calls replay."""
        if self.pool is None:
            fn(i)
            return
        key = (kind, i)
        got = self.graphs.get(key)
        if got is None:
            fn(i)
            before, wbefore = Counter(pallas_field.LAUNCHES), Counter(pallas_field.WIDTH_LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                fn(i)
            counts = Counter(pallas_field.LAUNCHES)
            counts.subtract(before)
            wcounts = Counter(pallas_field.WIDTH_LAUNCHES)
            wcounts.subtract(wbefore)
            # the capture launched nothing: take its counts back
            pallas_field.LAUNCHES.subtract(counts)
            pallas_field.WIDTH_LAUNCHES.subtract(wcounts)
            self.graphs[key] = (graph, +counts, +wcounts)
            return
        graph, counts, wcounts = got
        graph.replay()
        REPLAYS[kind] += 1
        pallas_field.LAUNCHES.update(counts)
        pallas_field.WIDTH_LAUNCHES.update(wcounts)

    def download(self) -> List[int]:
        """W's canonical values, by dense index."""
        return limbs_to_ints(self.F.from_mont(self.W).cpu().numpy())


class VectorizedInterpreter:
    """Drop-in levelized interpreter on `device` ("cuda" unless the caller
    asks for the CPU, where every kernel wrapper runs its plain version).
    Falls back to the scalar interpreter only on a PlanError or a host
    solver's non-ExecutionError exception (see the module docstring)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._plans: Dict[int, Tuple[Prog, _Plan]] = {}

    def plan(self, prog: Prog) -> _Plan:
        """prog's plan (build_plan), built on first use and kept."""
        got = self._plans.get(id(prog))
        if got is None or got[0] is not prog:
            got = self._plans[id(prog)] = (prog, build_plan(prog))
        return got[1]

    def adopt(self, prog: Prog, plan: _Plan) -> None:
        """Take `plan`, made by build_plan elsewhere (say, in the process
        that read the program), as prog's. prog must have the planned
        program's curve, arguments and solvers; the scalar fallback runs
        prog's own statements."""
        self._plans[id(prog)] = (prog, plan)

    def execute(self, prog: Prog, inputs: Sequence[int], log_stream=None) -> Witness:
        if len(prog.arguments) != len(inputs):
            raise WrongInputCount(len(prog.arguments), len(inputs))
        try:
            plan = self.plan(prog)
        except PlanError:
            return Interpreter().execute(prog, inputs, log_stream)
        try:
            return self._execute_plan(prog, plan, inputs, log_stream)
        except _HostSolverFailed:
            # the scalar walk gives the canonical error in program order
            return Interpreter().execute(prog, inputs, log_stream)

    def _dev(self, plan: _Plan, prog: Prog) -> _DevPlan:
        got = plan._exec.get(self.device)
        if got is None:
            got = plan._exec[self.device] = _DevPlan(plan, prog.field.P, self.device)
        return got

    def _execute_plan(self, prog: Prog, plan: _Plan, inputs, log_stream) -> Witness:
        p = prog.field.P
        dp = self._dev(plan, prog)
        if len(inputs):
            limbs = ints_to_limbs([int(v) % p for v in inputs], dp.F.nl).astype(np.int64)
            dp.inp.copy_(torch.as_tensor(limbs))

        for i, host in enumerate(plan.host_groups):
            dp.step("segment", i, dp.run_segment)
            if host:
                self._run_host(prog, plan, dp, host)

        if dp.check is not None:
            dp.step("check", 0, dp.run_check)
            ok = dp.ok.cpu().numpy()
            if not ok.all():
                raise UnsatisfiedConstraint(plan.checks.errors[int(np.argmin(ok))])

        vals = dp.download()
        witness = {plan.var_of_dense[i]: vals[i] for i in range(len(vals))}

        if log_stream is not None and plan.logs:
            from .interpreter import _format_log_value, evaluate_lin

            for stmt in plan.logs:
                parts = stmt.format_string.split("{}")
                out = [parts[0]]
                for (ty, lins), part in zip(stmt.expressions, parts[1:]):
                    lvals = [evaluate_lin(witness, l, p) for l in lins]
                    out.append(_format_log_value(ty, lvals))
                    out.append(part)
                log_stream.write("".join(out) + "\n")

        return Witness(witness)

    @staticmethod
    def _run_host(prog: Prog, plan: _Plan, dp: _DevPlan, host):
        """One host group: W downloaded once, the scalar solvers, their
        outputs scattered back in Montgomery form."""
        p = prog.field.P
        vals = dp.download()
        wit = {plan.var_of_dense[i]: vals[i] for i in range(len(vals))}
        upd_idx, upd_vals = [], []
        for d, out_idx in host:
            ins = [_host_quad(wit, q, p) for q in d.inputs]
            try:
                res = execute_solver(d.solver, ins, prog.field, prog.solvers)
            except ExecutionError:
                raise
            except Exception as e:
                raise _HostSolverFailed(d.solver.name) from e
            upd_idx += out_idx
            upd_vals += [v % p for v in res]
        if upd_idx:
            limbs = torch.as_tensor(ints_to_limbs(upd_vals, dp.F.nl).astype(np.int64), device=dp.device)
            idx = torch.as_tensor(np.asarray(upd_idx, np.int64), device=dp.device)
            dp.W.index_copy_(0, idx, dp.F.to_mont(limbs))


def _host_quad(wit: Dict[int, int], q: QuadComb, p: int) -> int:
    def lin(l: LinComb) -> int:
        return sum(c * wit[v] for v, c in l.terms) % p

    return lin(q.left) * lin(q.right) % p
