"""Scaled Chebyshev spectral filter — the polynomial accelerator behind
``rbl_filtered`` (solver/filtered.py) and the polish (solver/polish.py).
Port of ``rbl_tpu/ops/chebyshev.py``.

Randomized block Lanczos convergence is set by the relative gaps between
the wanted exterior eigenvalues and the rest of the spectrum; on
slowly-decaying spectra (the reference's ``slow_decay`` fixture, and the
2D-Laplacian headline problem whose top cluster spans <2% of ‖A‖) the basis
must grow deep before the top k separate.  A degree-d Chebyshev polynomial
p(A) that is ≤ τ = 1/T_d(x̂) on the damped interval [a, b] and grows to 1
at the normalization point γ re-spreads the wanted cluster [cutoff, λmax]
across [τ, 1] — gaps improve by orders of magnitude and the Krylov dimension
(and with it the reorthogonalization traffic, which scales as basis-length
× n per step) collapses.  Each filtered apply is d extra SpMM + AXPY
passes: streaming work with no host round-trips, no polls, and no basis
growth.

The recurrence is the σ-scaled three-term form (Zhou & Saad,
Chebyshev–Davidson; same scaling as EVSL's cheb filters): the iterates
carry τ_j·T_j rather than raw T_j, so nothing overflows at any degree —
T_d(x̂) itself can exceed f32 range for d in the hundreds.

Filter geometry (which="LA" orientation):

    damp [a, b], normalize at γ > b:  p(x) = T_d((x−c)/e) / T_d((γ−c)/e),
    c = (a+b)/2, e = (b−a)/2, so |p| ≤ τ on [a, b], p(γ) = 1, and p is
    monotone increasing on [b, ∞) — top-k of A map to top-k algebraic of
    p(A) whenever all wanted eigenvalues lie above b.

Safety requirement: a ≤ λ_min(A).  Below the damped interval |T_d| grows
with alternating sign, so an eigenvalue under a would be *amplified* — the
callers bound a by −‖A‖₂ (power-method bound) unless the user certifies a
tighter λ_min.

These were XLA expressions in the JAX package, not Pallas kernels, so they
are torch expressions here; ``base.apply`` on a block-sparse operator
launches the CUDA SpMM.  The interval edges are 0-d tensors on the
operator's device, so ``apply`` never waits for the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..parallel.mesh import col_sumsq
from .spmm.operator import LinearOperator


def _scalar(x, base: LinearOperator) -> torch.Tensor:
    """x as a 0-d tensor of the operator's dtype on its device."""
    return torch.as_tensor(x, dtype=base.dtype, device=base.device)


@dataclasses.dataclass
class ChebyshevFilterOperator(LinearOperator):
    """p(A) for the scaled Chebyshev filter damping [a, b], normalized to
    1 at γ.  ``a``/``b``/``gamma`` are 0-d tensors on the base operator's
    device."""

    base: LinearOperator
    a: torch.Tensor      # 0-d: damped-interval lower edge (≤ λ_min!)
    b: torch.Tensor      # 0-d: damped-interval upper edge (the cutoff)
    gamma: torch.Tensor  # 0-d: normalization point (λ_max estimate)
    degree: int = 24

    @classmethod
    def make(cls, base: LinearOperator, a: float, b: float, gamma: float,
             degree: int = 24):
        if not (a < b < gamma):
            raise ValueError(
                f"need a < b < gamma, got a={a}, b={b}, gamma={gamma}"
            )
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        return cls(base=base, a=_scalar(a, base), b=_scalar(b, base),
                   gamma=_scalar(gamma, base), degree=int(degree))

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        c = (self.a + self.b) / 2
        e = (self.b - self.a) / 2
        sigma1 = e / (self.gamma - c)  # |σ₁| < 1 since γ is outside [a, b]

        # y₁ = σ₁/e · (A − cI) x  — the degree-1 scaled filter
        Y = (self.base.apply(X) - c * X) * (sigma1 / e)
        Xp, sig = X, sigma1
        for _ in range(2, self.degree + 1):
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            Yn = (
                2.0 * (sig_new / e) * (self.base.apply(Y) - c * Y)
                - (sig * sig_new) * Xp
            )
            Xp, Y, sig = Y, Yn, sig_new
        return Y

    def scalar(self, x):
        """p(x) for scalar/array x — the exact polynomial the operator
        applies (test oracle, and the value-mapping for diagnostics)."""
        a = float(self.a); b = float(self.b); g = float(self.gamma)
        c = (a + b) / 2.0
        e = (b - a) / 2.0
        xs = (np.asarray(x, dtype=np.float64) - c) / e
        gs = (g - c) / e
        sigma1 = 1.0 / gs
        y_prev = np.ones_like(xs)
        y = xs * sigma1
        sig = sigma1
        for _ in range(2, self.degree + 1):
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            y_prev, y, sig = (
                y, 2.0 * sig_new * xs * y - sig * sig_new * y_prev, sig_new
            )
        return y


def _leja_order(x):
    """Greedy Leja ordering of the points x: each next point maximizes the
    product of distances to those already chosen.  Keeps the partial
    products of the factored filter well-scaled (the classic ordering for
    product-form polynomial evaluation)."""
    n = len(x)
    sel = np.zeros(n, bool)
    acc = np.zeros(n)
    j = int(np.argmax(np.abs(x)))
    order = [j]
    sel[j] = True
    for _ in range(n - 1):
        acc = acc + np.log(np.abs(x - x[j]) + 1e-300)
        masked = np.where(sel, -np.inf, acc)
        j = int(np.argmax(masked))
        order.append(j)
        sel[j] = True
    return np.asarray(order)


@functools.lru_cache(maxsize=64)
def _unit_roots(d: int):
    """Leja-ordered roots of T_d on the REFERENCE interval [−1, 1] (a
    constant of the degree; the affine map to [a, b] happens in device
    arithmetic)."""
    r = np.cos((2 * np.arange(1, d + 1) - 1) * np.pi / (2 * d))
    r = r[_leja_order(r)]
    r.setflags(write=False)
    return r


@dataclasses.dataclass
class ChebyshevProductFilter(LinearOperator):
    """The degree-d Chebyshev filter T_d((A−c)/e) evaluated as the product
    of its d linear factors (A − r_i·I), r_i the Chebyshev roots of the
    damped interval [a, b], visited in Leja order with per-step column
    normalization.

    Same filtered SUBSPACE as ChebyshevFilterOperator (columns differ by
    positive per-column scales, which every consumer normalizes away), but
    built exclusively from the `(A·Y − r·Y)` pattern.  The per-step
    normalization removes the scaled form's range hazard (p-values
    e^{−d·y} underflow a narrow exponent range), so no underflow degree
    cap is needed."""

    base: LinearOperator
    a: torch.Tensor      # 0-d: damped-interval lower edge (≤ λ_min!)
    b: torch.Tensor      # 0-d: damped-interval upper edge (the cutoff)
    degree: int = 24
    mesh: Any = None     # RowMesh: X is the rank's rows, norms reduced

    @classmethod
    def make(cls, base: LinearOperator, a: float, b: float,
             degree: int = 24):
        if not (a < b):
            raise ValueError(f"need a < b, got a={a}, b={b}")
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        return cls(base=base, a=_scalar(a, base), b=_scalar(b, base),
                   degree=int(degree))

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _unit_roots(self):
        return _unit_roots(self.degree)

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        c = (self.a + self.b) / 2
        e = (self.b - self.a) / 2
        # torch.tensor copies: the cached array stays read-only
        roots = c + e * torch.tensor(self._unit_roots(), dtype=X.dtype,
                                     device=X.device)
        Y = X
        for i in range(self.degree):
            Y = self.base.apply(Y) - roots[i] * Y
            nrm = torch.sqrt(col_sumsq(Y, self.mesh))
            Y = Y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        return Y

    def scalar_direction(self, x):
        """sign(p(x))·|p(x)| up to a global positive scale, via
        log-magnitude accumulation (test oracle — the operator's output
        is only defined up to positive per-column scaling)."""
        a = float(self.a); b = float(self.b)
        c = (a + b) / 2.0
        e = (b - a) / 2.0
        xs = np.asarray(x, dtype=np.float64)
        roots = c + e * self._unit_roots()
        logm = np.zeros_like(xs, dtype=np.float64)
        sign = np.ones_like(xs)
        for r in roots:
            t = xs - r
            logm = logm + np.log(np.abs(t) + 1e-300)
            sign = sign * np.sign(t)
        logm = logm - np.max(logm)
        return sign * np.exp(logm)
