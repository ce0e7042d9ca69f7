"""Radix-2 number-theoretic transform over prime scalar fields.

The counterpart of the JAX package's kernels/ntt.py: iterative
Cooley-Tukey, decimation in time after a bit-reversal permutation, with
twiddles precomputed per stage on the host (Montgomery form). The
transform itself is kernels/ntt_pallas.fft_core (the whole-transform CUDA
kernel, or on the CPU its plain version, one batched butterfly per stage).
Coset transforms (for the Groth16 h(X) = (A·B - C)/Z on a coset of the
vanishing domain) and the ifft's 1/n multiply by host tables of coset
powers and by the n^-1 row through the elementwise product
(kernels/pallas_field.emul). fft_ints / ifft_ints take and return host
ints (Marlin's polynomial products and interpolations): canonical limbs
uploaded, to Montgomery form and back by emul with the R^2 and 1 rows.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

from ..fields import params as P
from ..fields.jfield import field_ops
from ..fields.limbs import LIMB_BITS, int_to_limbs, ints_to_limbs, limbs_to_ints
from .ntt_pallas import fft_core
from .pallas_field import emul


class Domain:
    """Radix-2 evaluation domain of size n = 2^k over field p."""

    def __init__(self, p: int, n: int, two_adic_root: int, two_adicity: int):
        if n & (n - 1):
            raise ValueError("domain size must be a power of two")
        k = n.bit_length() - 1
        if k > two_adicity:
            raise ValueError(f"field has no 2^{k} roots of unity")
        self.p = p
        self.n = n
        self.k = k
        self.ops = field_ops(p)
        self.omega = pow(two_adic_root, 1 << (two_adicity - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(n, -1, p)
        self._rr = pow(2, LIMB_BITS * self.ops.nl, p)  # Montgomery factor

        self._tw = self._make_twiddles(self.omega)
        self._tw_inv = self._make_twiddles(self.omega_inv)

        idx = np.arange(n, dtype=np.int64)
        rev = np.zeros(n, dtype=np.int64)
        for b in range(k):
            rev = (rev << 1) | ((idx >> b) & 1)
        self.bitrev = rev
        self.n_inv_mont = np.asarray(
            ints_to_limbs([self.n_inv * self._rr % p], self.ops.nl), dtype=np.int64
        )[0]
        self._dev: Dict[tuple, object] = {}

    def _make_twiddles(self, omega: int) -> List[np.ndarray]:
        """Stage s uses w_m = omega^(n/m), m = 2^(s+1): [w_m^0 .. w_m^(m/2-1)]."""
        tws = []
        for s in range(self.k):
            m = 1 << (s + 1)
            w_m = pow(omega, self.n // m, self.p)
            powers, acc = [], 1
            for _ in range(m // 2):
                powers.append(acc * self._rr % self.p)
                acc = acc * w_m % self.p
            tws.append(np.asarray(ints_to_limbs(powers, self.ops.nl), dtype=np.int64))
        return tws

    def _on(self, key, device, make):
        """Per-device cache of host-built tables."""
        k = (key, torch.device(device))
        t = self._dev.get(k)
        if t is None:
            t = make()
            self._dev[k] = t
        return t

    def _twiddles(self, inverse: bool, device):
        src = self._tw_inv if inverse else self._tw
        return self._on(
            ("tw", inverse), device,
            lambda: [torch.as_tensor(t, device=device) for t in src],
        )

    # -- transforms --------------------------------------------------------
    def _fft_core(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """x: (..., n, nl) Montgomery limbs -> transformed, natural order.

        Every size takes the pass kernel (ntt_pallas.fft_core). The
        reference keeps its whole-transform Pallas NTT to 2^15, the VMEM it
        holds, and takes a four-step path above; the pass kernel has no
        such bound (one more launch per 10 stages)."""
        return fft_core(self, x.contiguous(), inverse)

    def _mul_table(self, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Elementwise multiply of (..., n, nl) by a shared (n, nl) table, or
        by one (nl,) row for every element (read with a row stride of 0)."""
        xb = x.contiguous().reshape(-1, self.n, self.ops.nl)
        out = emul(self.p, xb, rows.expand(self.n, self.ops.nl))
        return out.reshape(x.shape)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Coefficients -> evaluations on the domain (both Montgomery)."""
        return self._fft_core(coeffs, inverse=False)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        """Evaluations -> coefficients."""
        x = self._fft_core(evals, inverse=True)
        ninv = self._on("ninv", x.device, lambda: torch.as_tensor(self.n_inv_mont, device=x.device))
        return self._mul_table(x, ninv)

    # -- coset transforms --------------------------------------------------
    @lru_cache(maxsize=None)
    def _coset_powers(self, g: int) -> np.ndarray:
        """Montgomery limb table of [g^0 .. g^(n-1)], host-computed."""
        powers, acc = [], 1
        for _ in range(self.n):
            powers.append(acc * self._rr % self.p)
            acc = acc * g % self.p
        return np.asarray(ints_to_limbs(powers, self.ops.nl), dtype=np.int64)

    def _coset_table(self, g: int, device):
        return self._on(("coset", g), device, lambda: torch.as_tensor(self._coset_powers(g), device=device))

    def coset_fft(self, coeffs: torch.Tensor, g: int) -> torch.Tensor:
        """Evaluate on the coset g * <omega>."""
        return self.fft(self._mul_table(coeffs, self._coset_table(g, coeffs.device)))

    def coset_ifft(self, evals: torch.Tensor, g: int) -> torch.Tensor:
        coeffs = self.ifft(evals)
        ginv = pow(g, -1, self.p)
        return self._mul_table(coeffs, self._coset_table(ginv, coeffs.device))

    # -- host helpers ------------------------------------------------------
    def _row(self, value: int, device) -> torch.Tensor:
        """The (nl,) canonical limbs of R^2 or 1, per device."""
        return self._on(("row", value), device,
                        lambda: torch.as_tensor(int_to_limbs(value, self.ops.nl).astype(np.int64), device=device))

    def _ints(self, xs, inverse: bool, device) -> List[int]:
        device = torch.device(device)
        a = ints_to_limbs([x % self.p for x in xs], self.ops.nl).astype(np.int64)
        a = self._mul_table(torch.as_tensor(a, device=device)[None], self._row(self.ops.spec.r2, device))
        y = self.ifft(a) if inverse else self.fft(a)
        return limbs_to_ints(self._mul_table(y, self._row(1, device))[0].cpu().numpy())

    def fft_ints(self, xs, device="cuda") -> List[int]:
        """Coefficients (ints, at most n, zero-padded to n) -> the n
        evaluations on the domain, canonical ints."""
        if len(xs) > self.n:
            raise ValueError(f"{len(xs)} coefficients for a domain of {self.n}")
        return self._ints(list(xs) + [0] * (self.n - len(xs)), False, device)

    def ifft_ints(self, xs, device="cuda") -> List[int]:
        """The n evaluations on the domain (ints) -> the n coefficients,
        canonical ints."""
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} evaluations for a domain of {self.n}")
        return self._ints(list(xs), True, device)


@lru_cache(maxsize=None)
def domain_for_curve(curve: str, n: int) -> Domain:
    fp = P.SCALAR_FIELDS[curve]
    return Domain(fp.p, n, fp.two_adic_root, fp.two_adicity)
