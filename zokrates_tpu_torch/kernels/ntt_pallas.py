"""Whole-transform NTT: the counterpart of the JAX package's
kernels/ntt_pallas.py (fft_core_pallas), as the CUDA pass kernel of
csrc/ntt.cu.

fft_core(dom, x, inverse) is Domain._fft_core without the ifft's 1/n
scaling: x (..., n, nl) Montgomery limbs -> the radix-2 DIT transform in
natural order. On the card a transform of 2^k elements runs as
ceil(k/10) launches (two at the prove's 2^15 and GM17's 2^16), the
stages split evenly among them (pass_plan); a launch's blocks each hold
tiles of 2^S elements (of several transforms where a tile is small) and
their twiddles in shared memory, a thread a butterfly a stage
(thread_maps; see the source's note). The first pass gathers the input in
bit-reversed order. Any power-of-two size takes the kernel: unlike the
reference's Pallas NTT, which holds the whole transform in VMEM up to
2^15, nothing here bounds n. Its plain version, fft_core_plain, is the
stage loop: one batched butterfly per stage over the whole tensor. The
wrapper runs it only for tensors on the CPU.

Twiddles come from the host, built from ints as the reference's
_tw_tables builds its own: stage s's powers w^0 .. w^(2^s - 1) of
w = omega^(n / 2^(s+1)), Montgomery form, stacked at offset 2^s - 1 of one
(n-1, nl/2) table of 32-bit limbs, 2nl B a twiddle. The kernel runs at 8
32-bit limbs (the 254/255-bit scalar fields) and at 12 (BW6-761's 377-bit
one).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

# launches of the CUDA kernel, counted by its wrapper (one per pass), and
# by width: ("ntt", 32-bit limbs) -> launches
LAUNCHES: Counter = Counter()
WIDTH_LAUNCHES: Counter = Counter()

MAX_STAGES_PER_PASS = 10  # a tile of 1024 elements, 32 KB of shared memory, and its twiddles
BLOCK_ELEMS = 256         # elements a block holds where a tile is smaller (csrc/ntt.cu: up to 1024)
TID_INTS = 9              # ints a stage's thread-bit record: csrc/ntt.cu kMaxTidBits


def fft_core_plain(dom, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain version of fft_core: bit reversal, then one batched butterfly
    per stage. Same arguments and result as fft_core()."""
    f = dom.ops
    n = dom.n
    lead = x.shape[:-2]
    tw = dom._twiddles(inverse, x.device)
    rev = dom._on("rev", x.device, lambda: torch.as_tensor(dom.bitrev, device=x.device))
    x = x.index_select(-2, rev)
    for s in range(dom.k):
        m = 1 << (s + 1)
        half = m // 2
        xv = x.reshape(lead + (n // m, m, -1))
        even = xv[..., :half, :]
        odd = xv[..., half:, :]
        t = f.mul(odd, tw[s])
        x = torch.cat([f.add(even, t), f.sub(even, t)], dim=-2).reshape(lead + (n, -1))
    return x


def _tw_tables(dom, inverse: bool) -> np.ndarray:
    """(n-1, nl/2) uint32 twiddle table, one row of 32-bit limbs a twiddle,
    host-built from the Domain's per-stage Montgomery powers (themselves
    computed from ints)."""
    src = dom._tw_inv if inverse else dom._tw
    limbs16 = np.concatenate(src).astype(np.uint32)  # (n-1, nl): stage s at 2^s - 1
    return np.ascontiguousarray(limbs16[:, 0::2] | (limbs16[:, 1::2] << np.uint32(16)))


def pass_plan(k: int, batch: int):
    """[(s0, s1, log_slots)] of the passes of `batch` transforms of 2^k
    elements: stages [s0, s1) over tiles of 2^(s1 - s0) elements,
    2^log_slots tiles a block. ceil(k / 10) passes, the stages split
    as evenly as they go, the larger passes last (2^15: 7 + 8). A pass's
    tiles are the batch times 2^(k - s1) high positions (its "pairs") for
    each of 2^s0 low positions; a block takes tiles of one low position, as
    many as make BLOCK_ELEMS elements and the pairs hold (a power of two):
    blocks of 128 to 256 elements measured fastest at every batch of the
    prove, 1024 slowest (PERF.md), so the launch has as many blocks as the
    batch has tiles of that size (128 at B = 1 and 2^15, 6144 at B = 48)."""
    npass = -(-k // MAX_STAGES_PER_PASS)
    base, extra = divmod(k, npass)
    plan, s0 = [], 0
    for S in [base] * (npass - extra) + [base + 1] * extra:
        pairs = batch << (k - s0 - S)
        log_slots = max(0, min((BLOCK_ELEMS >> S).bit_length(), pairs.bit_length()) - 1)
        plan.append((s0, s0 + S, log_slots))
        s0 += S
    return plan


@lru_cache(maxsize=None)
def thread_maps(S: int, log_slots: int):
    """[(t, tpos)] of the stages of a pass of S stages over blocks of
    2^log_slots tiles (E = 2^(S + log_slots) elements, 2 a thread): at stage
    t a thread takes the butterfly of its element with bit t clear; tpos,
    the bit of the block's element index that each bit of the thread index
    sets, the 5 lane bits first, chosen below 10 and distinct mod 5 where
    the free bits allow (csrc/ntt.cu: then a warp's shared-memory accesses
    hit 32 banks)."""
    nbits = S + log_slots
    stages = []
    for t in range(S):
        free = [b for b in range(nbits) if b != t]
        lanes, seen = [], set()
        for b in free:
            if len(lanes) < min(5, nbits - 1) and b < 10 and b % 5 not in seen:
                lanes.append(b)
                seen.add(b % 5)
        stages.append((t, tuple(lanes + [b for b in free if b not in lanes])))
    return stages


@lru_cache(maxsize=None)
def _thread_map_ints(S: int, log_slots: int):
    """thread_maps as the C entry point takes them: TID_INTS ints a stage."""
    flat = []
    for _, tpos in thread_maps(S, log_slots):
        flat += [*tpos] + [0] * (TID_INTS - len(tpos))
    return (ctypes.c_int * len(flat))(*flat)


def fft_core(dom, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Radix-2 DIT transform of x (..., n, nl) int64 Montgomery limbs, n =
    dom.n, without the 1/n scaling (CUDA kernel ntt_pass_kernel, the
    reference's fft_core_pallas). Returns a new tensor in natural order.
    CPU tensors take fft_core_plain; CUDA tensors launch the kernel."""
    nl = dom.ops.nl
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f"x: expected an int64 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (dom.n, nl):
        raise ValueError(f"x: expected (..., {dom.n}, {nl}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if x.device.type == "cpu":
        return fft_core_plain(dom, x, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"fft_core: unsupported device {x.device}")
    if dom.k < 1:
        raise ValueError("fft_core: the kernel takes domains of 2 or more elements")
    from . import cuda

    lib = cuda.load()
    n32, pl, one, n0, _ = cuda.field_params(dom.p, None, cuda.NL32_FIELD)
    batch = x.numel() // (dom.n * nl)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    if batch >= 1 << 31:
        raise ValueError(f"fft_core: fewer than 2^31 transforms a call, got {batch}")
    tw = dom._on(("tw32", inverse), x.device,
                 lambda: torch.as_tensor(_tw_tables(dom, inverse).view(np.int32), device=x.device))
    plan = pass_plan(dom.k, batch)
    scratch = torch.empty((batch, dom.n, n32), dtype=torch.int32, device=x.device) if len(plan) > 1 else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        for s0, s1, log_slots in plan:
            rc = lib.zkt_ntt_pass(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), tw.data_ptr(),
                                  batch, dom.k, s0, s1, log_slots, _thread_map_ints(s1 - s0, log_slots),
                                  n32, pl, one, n0, stream)
            cuda.check(rc, "ntt")
            LAUNCHES["ntt"] += 1
            WIDTH_LAUNCHES[("ntt", n32)] += 1
    return out
