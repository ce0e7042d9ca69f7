"""Batched prime-field arithmetic on torch tensors, in Montgomery form.

The counterpart of the JAX package's fields/jfield.py. A field element is
a vector of nl base-2^16 limbs, least significant first, on the trailing
axis — the same values as the reference's uint32 limb arrays, held here in
int64 so that every limb product and every lazy column sum is exact.

Where the reference walks carry chains one limb at a time (a lax.scan),
this module resolves them with a fixed number of whole-vector passes:

  * a pass moves each column's bits above 16 into the next column; after
    enough passes every limb is at most 2^16,
  * the remaining ripple (a 2^16 limb passing its carry through a run of
    0xFFFF limbs) is the carry of one binary addition over bit masks
    packed into an int64 — so a normalization costs a few tensor ops
    whatever nl is. Borrows resolve the same way.

Montgomery multiplication takes the full schoolbook product of the two
limb vectors (one outer product, summed along anti-diagonals), derives
m = (T mod R) * (-p^-1) mod R from the unnormalized low columns, and
normalizes T + m*p once; its top half is the product (< 2p), reduced by
one conditional subtraction. Every op returns canonical residues in
[0, p), so results are bit-equal to the reference's for equal inputs.

Ops are methods of a FieldOps object (one per modulus, see field_ops);
tensors may live on any device, constants follow the input's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, ints_to_limbs, limbs_to_ints, n_limbs

_MASK = LIMB_MASK


@dataclass(frozen=True)
class FieldSpec:
    """Static (host-side) constants for one prime field's limb arithmetic."""

    p: int
    nl: int                      # number of 16-bit limbs
    n0inv: int                   # -p^-1 mod 2^16
    r: int                       # Montgomery radix B^nl mod p
    r2: int                      # R^2 mod p
    p_limbs: np.ndarray          # (nl,)
    r_limbs: np.ndarray          # (nl,)  == one in Montgomery form
    r2_limbs: np.ndarray         # (nl,)
    nprime_limbs: np.ndarray     # (nl,)  -p^-1 mod R

    @staticmethod
    def make(p: int) -> "FieldSpec":
        nl = n_limbs(p)
        B = 1 << LIMB_BITS
        Rfull = 1 << (LIMB_BITS * nl)
        R = Rfull % p
        return FieldSpec(
            p=p,
            nl=nl,
            n0inv=(-pow(p, -1, B)) % B,
            r=R,
            r2=R * R % p,
            p_limbs=int_to_limbs(p, nl),
            r_limbs=int_to_limbs(R, nl),
            r2_limbs=int_to_limbs(R * R % p, nl),
            nprime_limbs=int_to_limbs((-pow(p, -1, Rfull)) % Rfull, nl),
        )


_SPECS: Dict[int, FieldSpec] = {}


def field_spec(p: int) -> FieldSpec:
    if p not in _SPECS:
        _SPECS[p] = FieldSpec.make(p)
    return _SPECS[p]


def _passes(bits: int) -> int:
    """Carry passes that bring columns < 2^bits down to <= 2^16."""
    v, n = (1 << bits) - 1, 0
    while v > (1 << LIMB_BITS):
        v = _MASK + (v >> LIMB_BITS)
        n += 1
    return n


# limbs one packed carry resolution takes (FieldOps._resolve): 62 bits of
# x and G leave their sum, and a carry in, below 2^63
_RESOLVE_LIMBS = 62

_CHUNK_PRODUCTS = 1 << 25  # caps _diag_sums' (rows, k, 2k) int64 temporary at 512 MiB


def _diag_sums(a: torch.Tensor, b: torch.Tensor, lead) -> torch.Tensor:
    k = a.shape[-1]
    prod = a[..., :, None] * b[..., None, :]            # (..., k, k)
    wide = torch.nn.functional.pad(prod, (0, k))        # (..., k, 2k)
    # element (i, j) sits at flat 2k*i + j = (2k-1)*i + (i+j): re-rowing the
    # flat buffer at width 2k-1 puts it in column i+j of row i
    diag = wide.reshape(lead + (2 * k * k,))[..., : k * (2 * k - 1)]
    return diag.reshape(lead + (k, 2 * k - 1)).sum(-2)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns: (..., k) x (..., k) limbs ->
    (..., 2k-1) column sums (exact in int64 for k <= 2^14). Large batches
    go through _diag_sums in chunks of rows, to bound its temporary."""
    k = a.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    rows = 1
    for d in lead:
        rows *= d
    step = max(1, _CHUNK_PRODUCTS // (k * k))
    if rows <= step:
        return _diag_sums(a, b, lead)
    a = a.expand(lead + (k,)).reshape(rows, k)
    b = b.expand(lead + (k,)).reshape(rows, k)
    cols = torch.empty((rows, 2 * k - 1), dtype=torch.int64, device=a.device)
    for i in range(0, rows, step):
        cols[i : i + step] = _diag_sums(a[i : i + step], b[i : i + step], (min(step, rows - i),))
    return cols.reshape(lead + (2 * k - 1,))


def _toeplitz(limbs, width: int, device) -> torch.Tensor:
    """(k, width) float64 matrix M of a constant's k limbs, M[i, c] =
    limbs[c - i] (0 where c - i is out of range): x @ M gives the first
    `width` product columns of x and the constant."""
    k = len(limbs)
    m = np.zeros((k, width), np.float64)
    for i in range(k):
        n = min(k, width - i)
        if n > 0:
            m[i, i : i + n] = np.asarray(limbs[:n], np.float64)
    return torch.as_tensor(m, device=device)


def _const_cols(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Product columns of 16-bit limbs x (..., k) and a constant's column
    matrix m (_toeplitz), int64: float64 is exact here, each column a sum
    of k <= 48 products below 2^32."""
    return torch.matmul(x.to(torch.float64), m).to(torch.int64)


class FieldOps:
    """Field arithmetic for one modulus over (..., nl) int64 limb tensors."""

    element_ndim = 1

    def __init__(self, p: int):
        self.spec = field_spec(p)
        self.p = p
        self.nl = self.spec.nl
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    # -- constants ---------------------------------------------------------
    def _c(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        c = self._dev.get(device)
        if c is None:
            s = self.spec

            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

            c = {
                "p": t(s.p_limbs),
                "r": t(s.r_limbs),
                "r2": t(s.r2_limbs),
                "np": t(s.nprime_limbs),
                "one": t(int_to_limbs(1, self.nl)),
                "sh": torch.arange(2 * self.nl + 1, dtype=torch.int64, device=device),
                # product columns by the constants as matrix products:
                # (..., nl) x (nl, 2nl-1) for p, (nl, nl) for np's low half
                "p_cols": _toeplitz(s.p_limbs, 2 * self.nl - 1, device),
                "np_cols": _toeplitz(s.nprime_limbs, self.nl, device),
            }
            self._dev[device] = c
        return c

    # -- carry machinery ---------------------------------------------------
    def _resolve(self, gen: torch.Tensor, prop: torch.Tensor, sh: torch.Tensor):
        """Ripple carries: limb i generates a carry (gen) or passes an
        incoming one on (prop). Returns (carry into each limb, carry out)
        via binary additions over packed masks: for x = P|G, the carry
        into bit i of x + G + c_in is G_{i-1} | (P_{i-1} & carry_{i-1}),
        bit 0 taking c_in. One int64 addition takes _RESOLVE_LIMBS limbs
        (x + G + 1 < 2^63); wider rows (the 2*nl = 96 product limbs of
        BW6-761's 48-limb Fq) go in pieces, each piece's carry out the
        next one's c_in."""
        k = gen.shape[-1]
        carry, parts = None, []
        for j in range(0, k, _RESOLVE_LIMBS):
            g, pr = gen[..., j:j + _RESOLVE_LIMBS], prop[..., j:j + _RESOLVE_LIMBS]
            s = sh[: g.shape[-1]]
            G = (g.to(torch.int64) << s).sum(-1)
            x = (pr.to(torch.int64) << s).sum(-1) | G
            c = ((x + G) if carry is None else (x + G + carry)) ^ x ^ G
            parts.append((c[..., None] >> s) & 1)
            carry = c >> g.shape[-1]
        return (parts[0] if len(parts) == 1 else torch.cat(parts, -1)), carry

    def _norm(self, t: torch.Tensor, bits: int):
        """Nonnegative columns < 2^bits -> (16-bit limbs, carry out)."""
        sh = self._c(t.device)["sh"]
        top = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
        for _ in range(_passes(bits)):
            c = t >> LIMB_BITS
            t = t & _MASK
            t[..., 1:] += c[..., :-1]
            top = top + c[..., -1]
        cin, cout = self._resolve(t >> LIMB_BITS != 0, t == _MASK, sh)
        return (t + cin) & _MASK, top + cout

    def _norm_signed(self, d: torch.Tensor):
        """Limbwise differences in (-2^16, 2^16) -> (16-bit limbs of the
        value mod B^nl, borrow out in {0, 1})."""
        sh = self._c(d.device)["sh"]
        c = d >> LIMB_BITS                                  # -1 or 0
        d = d & _MASK
        d[..., 1:] += c[..., :-1]                           # now in [-1, 2^16)
        bin_, bout = self._resolve(d < 0, d == 0, sh)
        return (d - bin_) & _MASK, bout - c[..., -1]

    def _cond_sub_p(self, t: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """Reduce t + hi*B^nl (< 2p) into [0, p)."""
        d, borrow = self._norm_signed(t - self._c(t.device)["p"])
        use_d = (hi > 0) | (borrow == 0)
        return torch.where(use_d[..., None], d, t)

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        s, carry = self._norm(a + b, LIMB_BITS + 1)
        return self._cond_sub_p(s, carry)

    def sub(self, a, b):
        d, borrow = self._norm_signed(a - b)
        dp, _ = self._norm(d + self._c(d.device)["p"], LIMB_BITS + 1)
        return torch.where((borrow != 0)[..., None], dp, d)

    def borrow_sub(self, a, b):
        """(a - b) mod B^nl of 16-bit limbs, and the borrow out in {0, 1}
        (the reference's _borrow_sub)."""
        return self._norm_signed(a - b)

    def neg(self, a):
        d, _ = self._norm_signed(self._c(a.device)["p"] - a)
        return torch.where(self.is_zero(a)[..., None], a, d)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (see module docstring). The
        two products by constants (the low half of T times -p^-1, m times
        p) take 16-bit limbs on both sides, so they run as float64 matrix
        products against the constants' column matrices (_toeplitz): every
        column is below 48 * 2^32 < 2^53, exact; T's low half is brought to
        16-bit limbs first (only its value mod B^nl counts)."""
        nl = self.nl
        c = self._c(a.device)
        bits = 2 * LIMB_BITS + nl.bit_length() + 2
        T = _mul_cols(a, b)                                 # (..., 2nl-1)
        t_lo, _ = self._norm(T[..., :nl].contiguous(), bits)
        m, _ = self._norm(_const_cols(t_lo, c["np_cols"]), 62)
        U = torch.nn.functional.pad(T + _const_cols(m, c["p_cols"]), (0, 1))
        U, top = self._norm(U, bits)
        return self._cond_sub_p(U[..., nl:].contiguous(), top)

    def square(self, a):
        return self.mul(a, a)

    def pow_const(self, a, e: int):
        """a^e for a host-known integer e >= 0 (square-and-multiply)."""
        if e == 0:
            return self.one_like(a)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2). inv(0) = 0 by convention."""
        return self.pow_const(a, self.p - 2)

    def reduce_wide(self, t):
        """Lazy column sums (..., nl), each < 2^47, of 16-bit-limb residues
        -> the sum mod p (canonical Montgomery-agnostic residue). The value
        lo + carry*B^nl folds back with one Montgomery multiplication per
        part (mul by R gives x mod p; mul by R^2 gives carry*R mod p)."""
        c = self._c(t.device)
        res, carry = self._norm(t, 48)
        lo = self.mul(res, c["r"])
        emb = torch.zeros_like(res)
        emb[..., 0] = carry & _MASK
        emb[..., 1] = (carry >> LIMB_BITS) & _MASK
        emb[..., 2] = carry >> (2 * LIMB_BITS)
        hi = self.mul(emb, c["r2"])
        return self.add(lo, hi)

    def to_mont(self, a):
        return self.mul(a, self._c(a.device)["r2"])

    def from_mont(self, a):
        return self.mul(a, self._c(a.device)["one"])

    # -- selection / predicates --------------------------------------------
    def select(self, cond, a, b):
        """cond ? a : b, cond shaped like the leading dims."""
        return torch.where(cond[..., None], a, b)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def zeros(self, shape=(), device="cpu"):
        return torch.zeros(tuple(shape) + (self.nl,), dtype=torch.int64, device=device)

    def ones_mont(self, shape=(), device="cpu"):
        return self._c(device)["r"].expand(tuple(shape) + (self.nl,)).clone()

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self._c(a.device)["r"].expand(a.shape).clone()

    # -- host converters -----------------------------------------------------
    def encode(self, xs, device="cpu", mont: bool = True):
        """list[int] -> (N, nl) limb tensor, optionally Montgomery."""
        arr = ints_to_limbs([x % self.p for x in xs], self.nl).astype(np.int64)
        out = torch.as_tensor(arr, device=device)
        return self.to_mont(out) if mont else out

    def encode_scalar(self, x: int, device="cpu", mont: bool = True):
        return self.encode([x], device=device, mont=mont)[0]

    def decode(self, arr, mont: bool = True):
        """limb tensor -> list[int] (canonical)."""
        a = self.from_mont(arr) if mont else arr
        return limbs_to_ints(a.reshape(-1, self.nl).cpu().numpy())


_OPS_CACHE: Dict[int, FieldOps] = {}


def field_ops(p: int) -> FieldOps:
    if p not in _OPS_CACHE:
        _OPS_CACHE[p] = FieldOps(p)
    return _OPS_CACHE[p]
