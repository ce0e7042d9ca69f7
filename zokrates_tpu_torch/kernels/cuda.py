"""Build and bind the CUDA kernels in csrc/ (nvcc into shared libraries with
a plain C interface, loaded with ctypes).

Each source builds into a library of its own, all nvcc processes started
together, so the build takes as long as the slowest source (msm_sorted.cu,
with its Fq2 instantiations, or msm_sorted_wide.cu, the same kernels at 24
limbs) rather than their sum; nvcc also spreads each
source's optimization over the CPUs (-split-compile). The libraries build at
first use — never at import — into zokrates_tpu_torch/_build/ (see
buildtools.py) for sm_90a. Only a machine with the CUDA toolkit builds
them; nvcc is looked up as $CUDA_HOME/bin/nvcc, then on PATH, then at
/usr/local/cuda/bin/nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

from ..buildtools import PKG_DIR, build_shared
from ..fields.jfield import field_spec

CSRC = os.path.join(PKG_DIR, "csrc")
# library name -> source; each includes field.cuh
SOURCES = {
    "zkt_msm": os.path.join(CSRC, "msm_sorted.cu"),
    "zkt_msm_wide": os.path.join(CSRC, "msm_sorted_wide.cu"),
    "zkt_field": os.path.join(CSRC, "field_elementwise.cu"),
    "zkt_ntt": os.path.join(CSRC, "ntt.cu"),
    "zkt_mulacc": os.path.join(CSRC, "mulacc.cu"),
    "zkt_point": os.path.join(CSRC, "point_elementwise.cu"),
    "zkt_probe": os.path.join(CSRC, "probe.cu"),
}
HEADERS = [os.path.join(CSRC, "field.cuh"), os.path.join(CSRC, "msm_kernels.cuh")]
ARCH = "arch=compute_90a,code=sm_90a"
# 32-bit limbs per element the MSM kernels are instantiated for: 8 (BN254's
# and the Pasta base fields) and 12 (the BLS12 base fields) in
# msm_sorted.cu, 24 (BW6-761's base field, over Fq only: BW6's G2 lies
# over Fq too) in msm_sorted_wide.cu, entry points zkt_msm_wide_*; emul and
# mixed_add_lm take the same widths (24: GM17's query points over
# BW6-761's Fq, a contribution's ladder over its G1)
NL32 = (8, 12, 24)
# the widths of the other kernels: ereduce_wide, the NTT, the matvec walk
# and accumulate_lm (8 and 12; the probe at 8): the 254/255-bit scalar
# fields and the 377-bit ones (BW6-761's r, the BLS12 base fields)
NL32_FIELD = (8, 12)

_LIB: Optional[SimpleNamespace] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> Dict[str, Tuple[str, str]]:
    """Compile the kernel libraries not built yet, one nvcc per source, in
    parallel. Returns {library: (path, compiler output incl. the ptxas
    register/spill report; empty if cached)}."""
    # -split-compile=0: nvcc runs its optimizations on as many threads as
    # there are CPUs (msm_sorted.cu: 81 s against 136 s without, on the
    # card's 8-core machine)
    cmd = [
        nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-split-compile=0", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
    ]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futs = {name: pool.submit(build_shared, name, cmd, [src], HEADERS)
                for name, src in SOURCES.items()}
        return {name: f.result() for name, f in futs.items()}


def load() -> SimpleNamespace:
    """Build (first call) and load the kernel libraries; returns their C
    functions as attributes of one object."""
    global _LIB
    if _LIB is not None:
        return _LIB
    libs = {name: ctypes.CDLL(so) for name, (so, _) in build().items()}
    P, I, U, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    L = ctypes.POINTER(ctypes.c_uint32)
    sigs = {
        "zkt_msm": {
            "zkt_msm_walk": [P, P, P, P, I, I, I, I, I, I, I, L, L, U, I, P],
            "zkt_msm_suffix": [P, P, P, I, I, I, I, I, L, L, U, I, P],
            "zkt_msm_suffix_fold": [P, P, P, I, I, I, I, I, L, L, U, I, P],
        },
        "zkt_msm_wide": {
            "zkt_msm_wide_walk": [P, P, P, P, I, I, I, I, I, I, I, L, L, U, I, P],
            "zkt_msm_wide_suffix": [P, P, P, I, I, I, I, I, L, L, U, I, P],
            "zkt_msm_wide_suffix_fold": [P, P, P, I, I, I, I, I, L, L, U, I, P],
        },
        "zkt_field": {
            "zkt_emul": [P, P, P, LL, LL, LL, LL, LL, I, L, L, U, P],
            "zkt_emul_tile": [I],
            "zkt_ereduce_wide": [P, P, LL, I, L, L, L, U, P],
        },
        "zkt_ntt": {
            "zkt_ntt_pass": [P, P, P, P, I, I, I, I, I, P, I, L, L, U, P],
        },
        "zkt_mulacc": {
            "zkt_mulacc_walk": [P, P, LL, P, P, P, P, P, I, I, I, LL, I, I, I, L, L, U, P],
        },
        "zkt_point": {
            "zkt_mixed_add_lm": [P, P, P, P, P, P, P, P, I, I, I, L, L, U, P],
            "zkt_accumulate_lm": [P, P, P, P, P, P, I, I, I, I, I, L, L, U, P],
        },
        "zkt_probe": {
            "zkt_probe_imad": [P, I, I, U, P],
            "zkt_probe_mont": [P, I, I, L, L, U, P],
        },
    }
    fns = SimpleNamespace()
    for name, table in sigs.items():
        for fn, argtypes in table.items():
            f = getattr(libs[name], fn)
            f.argtypes = argtypes
            f.restype = I
            setattr(fns, fn, f)
    err = libs["zkt_msm"].zkt_error_string
    err.argtypes = [I]
    err.restype = ctypes.c_char_p
    fns.zkt_error_string = err
    from .msm_sorted import SUFFIX_BLOCK

    block = libs["zkt_msm"].zkt_msm_suffix_block
    block.argtypes = []
    block.restype = I
    if block() != SUFFIX_BLOCK:
        raise RuntimeError(f"csrc/msm_sorted.cu runs {block()} threads a suffix block, "
                           f"msm_sorted.SUFFIX_BLOCK says {SUFFIX_BLOCK}")
    from .pallas_field import EMUL_TILE

    tiles = {n: fns.zkt_emul_tile(n) for n in NL32}
    if tiles != EMUL_TILE:
        raise RuntimeError(f"csrc/field_elementwise.cu runs tiles of {tiles} elements by width, "
                           f"pallas_field.EMUL_TILE says {EMUL_TILE}")
    _LIB = fns
    return fns


_PARAMS = {}


def field_params(p: int, beta, widths=NL32) -> Tuple[int, object, object, int, int]:
    """(n, p limbs, Montgomery one, n0, |beta|) as the kernels take them: n
    = nl/2 little-endian 32-bit limbs for a field of nl 16-bit limbs; R =
    2^(16 nl), the R of the reference's limb layout. Raises for a field
    whose width is not among `widths` (32-bit limb counts: the widths the
    calling kernel is instantiated for)."""
    n = field_spec(p).nl // 2
    if n not in widths:
        raise ValueError(
            f"the CUDA kernel takes fields of {' or '.join(str(2 * w) for w in widths)} "
            f"16-bit limbs, got nl={2 * n}"
        )
    key = (p, beta)
    if key not in _PARAMS:
        n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        _PARAMS[key] = (n, limbs32(p, n), limbs32(field_spec(p).r, n), n0, 0 if beta is None else -beta)
    return _PARAMS[key]


def limbs32(x: int, n: int):
    """0 <= x < 2^(32n) as n little-endian 32-bit limbs (a ctypes array), n
    one of NL32."""
    if n not in NL32 or not 0 <= x < 1 << (32 * n):
        raise ValueError(f"limbs32: {x.bit_length()}-bit value in {n} limbs (widths {NL32})")
    return (ctypes.c_uint32 * n)(*[(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)])


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _LIB.zkt_error_string(rc).decode() if _LIB is not None else ""
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
