"""Whole-transform NTT: the counterpart of the JAX package's
kernels/ntt_pallas.py (fft_core_pallas), as the CUDA pass kernel of
csrc/ntt.cu.

fft_core(dom, x, inverse) is Domain._fft_core without the ifft's 1/n
scaling: x (..., n, nl) Montgomery limbs -> the radix-2 DIT transform in
natural order. On the card a transform of 2^k elements runs as
ceil(k/10) launches (two at the prove's 2^15), each folding up to 10
butterfly stages over tiles of 1024 elements in shared memory; the first
gathers the input in bit-reversed order (see the source's note). Any
power-of-two size takes the kernel: unlike the reference's Pallas NTT,
which holds the whole transform in VMEM up to 2^15, nothing here bounds
n. Its plain version, fft_core_plain, is the stage loop: one batched
butterfly per stage over the whole tensor. The wrapper runs it only for
tensors on the CPU.

Twiddles come from the host, built from ints as the reference's
_tw_tables builds its own: stage s's powers w^0 .. w^(2^s - 1) of
w = omega^(n / 2^(s+1)), Montgomery form, stacked at offset 2^s - 1 of one
(8, n-1) table of 32-bit limbs, limb-major.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

# launches of the CUDA kernel, counted by its wrapper (one per pass)
LAUNCHES: Counter = Counter()

MAX_STAGES_PER_PASS = 10  # log2 of the tile, 1024 elements = 32 KB of shared memory


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
    """(8, n-1) uint32 limb-major twiddle table, host-built from the
    Domain's per-stage Montgomery powers (themselves computed from ints)."""
    src = dom._tw_inv if inverse else dom._tw
    limbs16 = np.concatenate(src).astype(np.uint32)  # (n-1, 16): stage s at 2^s - 1
    limbs32 = limbs16[:, 0::2] | (limbs16[:, 1::2] << np.uint32(16))
    return np.ascontiguousarray(limbs32.T)


def pass_plan(k: int):
    """[(s0, s1, logT)] of the passes of a 2^k transform: stages [s0, s1)
    over tiles of 2^logT elements."""
    logT = min(k, MAX_STAGES_PER_PASS)
    return [(s0, min(s0 + logT, k), logT) for s0 in range(0, k, logT)]


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
    _, pl, one, n0, _ = cuda.field_params(dom.p, None, cuda.NL32_FIELD)
    batch = x.numel() // (dom.n * nl)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    if batch > 65535:
        raise ValueError(f"fft_core: at most 65535 transforms a call, got {batch}")
    tw = dom._on(("tw32", inverse), x.device,
                 lambda: torch.as_tensor(_tw_tables(dom, inverse).view(np.int32), device=x.device))
    plan = pass_plan(dom.k)
    scratch = torch.empty((batch, 8, dom.n), dtype=torch.int32, device=x.device) if len(plan) > 1 else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        for s0, s1, logT in plan:
            rc = lib.zkt_ntt_pass(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), tw.data_ptr(),
                                  batch, dom.k, s0, s1, logT, pl, one, n0, stream)
            cuda.check(rc, "ntt")
            LAUNCHES["ntt"] += 1
    return out
