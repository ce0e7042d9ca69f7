"""R1CS gadget builder: straight-line circuit DSL with dual execution modes.

The reference extracts embed gadgets from foreign constraint frameworks
(zokrates_embed/src/ark.rs runs ark-r1cs-std twice: once to dump the
constraint matrices, once per witness to dump the assignment). Here the
gadget is a plain Python function over `W` wire values executed the same
two ways:

  * symbolic mode (values=None): every multiplication/hint allocates a
    gadget variable and records an R1CS constraint (a, b, c) meaning
    <a,x>*<b,x> == <c,x> over gadget-local variable indices
    (0 = the gadget-local one);
  * concrete mode (values given for the input variables): no constraints
    are recorded; allocations evaluate their hint on concrete ints and
    append to the assignment vector.

The only contract is that the gadget function is straight-line: it must
perform the same allocations in the same order in both modes (no Python
branching on wire *values*; branching on structure/shape is fine).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

Lin = Dict[int, int]


class W:
    """A wire expression: linear combination of gadget variables (symbolic
    mode) and/or a concrete value (concrete mode)."""

    __slots__ = ("b", "lin", "val")

    def __init__(self, b: "GadgetBuilder", lin: Optional[Lin], val: Optional[int]):
        self.b = b
        self.lin = lin
        self.val = val

    # -- linear ops (free) --------------------------------------------------
    def __add__(self, o: "W") -> "W":
        b = self.b
        if isinstance(o, int):
            o = b.const(o)
        lin = None
        if b.sym:
            lin = dict(self.lin)
            for v, c in o.lin.items():
                lin[v] = (lin.get(v, 0) + c) % b.p
        val = None if self.val is None else (self.val + o.val) % b.p
        return W(b, lin, val)

    __radd__ = __add__

    def __sub__(self, o: "W") -> "W":
        if isinstance(o, int):
            o = self.b.const(o)
        return self + o.scale(-1)

    def __rsub__(self, o) -> "W":
        if isinstance(o, int):
            o = self.b.const(o)
        return o - self

    def __neg__(self) -> "W":
        return self.scale(-1)

    def scale(self, k: int) -> "W":
        b = self.b
        k = k % b.p
        lin = None if not b.sym else {v: (c * k) % b.p for v, c in self.lin.items()}
        val = None if self.val is None else (self.val * k) % b.p
        return W(b, lin, val)

    def __mul__(self, o) -> "W":
        if isinstance(o, int):
            return self.scale(o)
        return self.b.mul(self, o)

    def __rmul__(self, o) -> "W":
        return self.__mul__(o)


class GadgetBuilder:
    def __init__(self, p: int, n_inputs: int, input_values: Optional[List[int]] = None):
        self.p = p
        self.sym = input_values is None
        self.constraints: List[Tuple[Lin, Lin, Lin]] = []
        # assignment vector; index == gadget variable id; var 0 == one
        self.vals: Optional[List[int]] = None
        if input_values is not None:
            assert len(input_values) == n_inputs
            self.vals = [1] + [v % p for v in input_values]
        self.n_vars = 1 + n_inputs

    # -- wires ----------------------------------------------------------------
    def const(self, c: int) -> W:
        c = c % self.p
        return W(self, {0: c} if self.sym else None, None if self.sym else c)

    def one(self) -> W:
        return self.const(1)

    def input_wire(self, i: int) -> W:
        v = 1 + i
        return W(self, {v: 1} if self.sym else None, self.vals[v] if self.vals else None)

    def alloc(self, hint: Optional[Callable[[], int]] = None) -> W:
        """Fresh gadget variable. In concrete mode `hint()` supplies its
        value (must be provided); in symbolic mode the hint is ignored."""
        v = self.n_vars
        self.n_vars += 1
        if self.sym:
            return W(self, {v: 1}, None)
        val = hint() % self.p
        self.vals.append(val)
        return W(self, None, val)

    # -- constraints ------------------------------------------------------------
    def enforce(self, a: W, b: W, c: W):
        """<a,x>*<b,x> == <c,x>."""
        if self.sym:
            self.constraints.append((a.lin, b.lin, c.lin))

    def assert_eq(self, x: W, y: W):
        self.enforce(x - y, self.one(), self.const(0))

    def mul(self, x: W, y: W) -> W:
        out = self.alloc(hint=lambda: x.val * y.val)
        self.enforce(x, y, out)
        return out

    def inv(self, x: W) -> W:
        """Witnessed inverse; the constraint x*xinv == 1 makes x == 0
        unsatisfiable (documented deviation: exceptional pairing inputs are
        unprovable rather than 'false')."""
        out = self.alloc(hint=lambda: pow(x.val, -1, self.p))
        self.enforce(x, out, self.one())
        return out

    def div(self, x: W, y: W) -> W:
        out = self.alloc(
            hint=lambda: x.val * pow(y.val, -1, self.p)
        )
        self.enforce(y, out, x)
        return out

    def enforce_bool(self, x: W):
        self.enforce(x, x, x)

    def is_zero(self, x: W) -> W:
        """1 if x == 0 else 0 (2 constraints)."""
        bbit = self.alloc(hint=lambda: 1 if x.val == 0 else 0)
        w = self.alloc(hint=lambda: 0 if x.val == 0 else pow(x.val, -1, self.p))
        self.enforce(x, w, self.one() - bbit)
        self.enforce(x, bbit, self.const(0))
        return bbit

    def band(self, x: W, y: W) -> W:
        return self.mul(x, y)

    def select(self, bit: W, a: W, b: W) -> W:
        """bit ? a : b (1 constraint)."""
        d = self.mul(bit, a - b)
        return b + d

    def bits_of(self, x: W, nbits: int) -> List[W]:
        """Little-endian bit decomposition, canonical (< p) enforced via the
        big-endian constant comparison against p-1."""
        p = self.p
        bits = [
            self.alloc(hint=(lambda i=i: (x.val >> i) & 1)) for i in range(nbits)
        ]
        for bit in bits:
            self.enforce_bool(bit)
        acc = self.const(0)
        for i, bit in enumerate(bits):
            acc = acc + bit.scale(pow(2, i, p))
        self.assert_eq(acc, x)
        # canonical: value <= p - 1 as big-endian bits
        cbits = [(p - 1) >> i & 1 for i in range(nbits)][::-1]
        gt = self.const(0)
        eq = self.one()
        for bit, cb in zip(reversed(bits), cbits):
            if cb == 0:
                # gt |= eq & bit ; eq &= !bit
                t = self.mul(eq, bit)
                gt = gt + t - self.mul(gt, t)
            else:
                # eq &= bit (bit 1 keeps equality, 0 makes it less-than)
                eq = self.mul(eq, bit)
        self.assert_eq(gt, self.const(0))
        return bits
