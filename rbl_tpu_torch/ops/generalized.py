"""Chebyshev matrix-function series and the symmetric pencil transform
(port of ``rbl_tpu/ops/generalized.py``) — the machinery behind generalized
eigenproblems ``A·x = λ·M·x`` (solver/generalized.py).

scipy's ``eigsh`` accepts an SPD mass matrix M and ARPACK handles it by
factorizing M.  The route here keeps everything as block SpMMs:

    S = P(M) · A · P(M),     P(M) ≈ M^{−1/2} as a Chebyshev series in M,

so S is **exactly symmetric by construction** (P(M) is a symmetric
polynomial of a symmetric operator), the standard randomized block Lanczos
solver applies unchanged, and every apply of S costs one SpMM with A plus
2·degree SpMMs with M — no factorization, no host callbacks.

Approximation error does NOT silently corrupt results: P(M)² = M̃⁻¹ for a
symmetric M̃ with ‖M̃ − M‖ = O(approx_tol·‖M‖), i.e. the solver solves a
*nearby pencil exactly*; the caller (solver/generalized.py) re-derives
eigenvalues as Rayleigh quotients with the TRUE (A, M) and validates true
pencil residuals ‖A·x − λ·M·x‖, demoting ``converged`` on contradiction.

``ChebyshevSeriesOperator`` is generic — any smooth f(M)·X (inverse square
root here; f(t)=t^{1/2} is one ``fun=`` away) evaluated by the Clenshaw
recurrence.  Its coefficients and domain edges are tensors on the base
operator's device, so an apply never reads back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .spmm.operator import LinearOperator


def chebyshev_fit(fun: Callable[[np.ndarray], np.ndarray], lo: float,
                  hi: float, degree: int, nodes: Optional[int] = None
                  ) -> np.ndarray:
    """First-kind Chebyshev interpolation coefficients of ``fun`` on
    [lo, hi] (host-side, one-time): c_j via the discrete cosine transform
    on Chebyshev–Gauss nodes, f(t) ≈ Σ_j c_j·T_j((2t − hi − lo)/(hi − lo)).
    """
    if not lo < hi:
        raise ValueError(f"need lo < hi, got [{lo}, {hi}]")
    if degree < 0:
        raise ValueError(f"degree must be >= 0, got {degree}")
    N = nodes or max(2 * (degree + 1), 64)
    theta = np.pi * (np.arange(N) + 0.5) / N
    x = np.cos(theta)
    t = (hi + lo) / 2.0 + (hi - lo) / 2.0 * x
    f = np.asarray(fun(t), dtype=np.float64)
    j = np.arange(degree + 1)
    c = (2.0 / N) * np.cos(np.outer(j, theta)) @ f
    c[0] /= 2.0
    return c


def fit_to_tolerance(fun: Callable[[np.ndarray], np.ndarray], lo: float,
                     hi: float, rel_tol: float, max_degree: int = 1000,
                     ) -> Tuple[np.ndarray, float]:
    """Smallest-degree Chebyshev fit of ``fun`` on [lo, hi] whose max
    relative error on a fine grid is ≤ rel_tol.  Returns (coeffs, achieved
    relative error).  Raises if ``max_degree`` cannot reach the tolerance
    (for f = t^{−1/2} the needed degree grows like √(hi/lo)·log(1/rel_tol)
    — a huge condition number of M is the usual culprit; pass tighter
    ``m_bounds``, a lumped/diagonal M, or an explicit ``degree``)."""
    c_full = chebyshev_fit(fun, lo, hi, max_degree,
                           nodes=max(2 * (max_degree + 1), 2048))
    # exact truncation error on a dense probe grid (robust where the
    # tail-coefficient bound is noisy near the f64 floor)
    tg = np.linspace(lo, hi, 4001)
    fg = np.asarray(fun(tg), dtype=np.float64)
    scale = np.max(np.abs(fg))
    xg = (2.0 * tg - hi - lo) / (hi - lo)
    Tg = np.cos(np.outer(np.arange(max_degree + 1), np.arccos(
        np.clip(xg, -1.0, 1.0))))
    # cumulative partial sums over degrees: err(d) = max |f − Σ_{j≤d}c_jT_j|
    approx = np.cumsum(c_full[:, None] * Tg, axis=0)
    err = np.max(np.abs(approx - fg[None, :]), axis=1) / scale
    ok = np.nonzero(err <= rel_tol)[0]
    if ok.size == 0:
        raise ValueError(
            f"Chebyshev fit on [{lo:.3g}, {hi:.3g}] cannot reach rel_tol="
            f"{rel_tol:.1e} within degree {max_degree} (best "
            f"{err.min():.1e}) — for M^(-1/2) this usually means κ(M) is "
            "too large; pass tighter m_bounds, a diagonal/lumped M, or an "
            "explicit degree"
        )
    d = int(ok[0])
    return c_full[: d + 1], float(err[d])


@dataclasses.dataclass
class ChebyshevSeriesOperator(LinearOperator):
    """f(M)·X for a symmetric M via a first-kind Chebyshev series on
    [lo, hi] ⊇ spec(M), evaluated with the Clenshaw recurrence — one SpMM
    with M per term, no basis storage.

    Symmetric by construction (a polynomial in a symmetric operator).
    ``coeffs`` (degree+1,) and the 0-d ``lo``/``hi`` are tensors on the
    base operator's device.
    """

    base: LinearOperator
    coeffs: torch.Tensor  # (degree+1,)
    lo: torch.Tensor      # 0-d: domain lower edge (≤ λ_min(M))
    hi: torch.Tensor      # 0-d: domain upper edge (≥ λ_max(M))
    degree: int = 0

    @classmethod
    def fit(cls, base: LinearOperator, fun, lo: float, hi: float,
            degree: Optional[int] = None, rel_tol: float = 1e-10,
            max_degree: int = 1000, return_err: bool = False):
        """Fit f on [lo, hi]: at an explicit ``degree``, or to ``rel_tol``
        max relative error with the smallest sufficient degree.  With
        ``return_err=True`` also returns the MEASURED max relative fit
        error on the probe grid (not the requested tolerance)."""
        if degree is not None:
            c = chebyshev_fit(fun, float(lo), float(hi), int(degree))
            tg = np.linspace(float(lo), float(hi), 4001)
            fg = np.asarray(fun(tg), dtype=np.float64)
            xg = (2.0 * tg - hi - lo) / (hi - lo)
            Tg = np.cos(np.outer(np.arange(len(c)), np.arccos(
                np.clip(xg, -1.0, 1.0))))
            err = float(np.max(np.abs(c @ Tg - fg)) / np.max(np.abs(fg)))
        else:
            c, err = fit_to_tolerance(fun, float(lo), float(hi),
                                      rel_tol=rel_tol,
                                      max_degree=max_degree)
        op = cls.from_coeffs(base, c, lo, hi)
        return (op, err) if return_err else op

    @classmethod
    def from_coeffs(cls, base: LinearOperator, coeffs, lo: float, hi: float):
        """The series with the given coefficients on [lo, hi] (e.g. a JAX
        ``ChebyshevSeriesOperator``'s, as numpy)."""
        dt, dev = base.dtype, base.device
        c = np.array(coeffs, dtype=np.float64).reshape(-1)
        return cls(
            base=base,
            coeffs=torch.as_tensor(c, dtype=dt, device=dev),
            lo=torch.as_tensor(float(lo), dtype=dt, device=dev),
            hi=torch.as_tensor(float(hi), dtype=dt, device=dev),
            degree=len(c) - 1,
        )

    @classmethod
    def inv_sqrt(cls, base: LinearOperator, lo: float, hi: float, **kw):
        """P ≈ M^{−1/2} on [lo, hi] (lo must be a certified positive lower
        bound of λ_min(M) — below the domain the series is uncontrolled)."""
        if not 0 < lo < hi:
            raise ValueError(
                f"inv_sqrt needs 0 < lo < hi, got [{lo}, {hi}] — M must be "
                "positive definite"
            )
        return cls.fit(base, lambda t: 1.0 / np.sqrt(t), lo, hi, **kw)

    @classmethod
    def sqrt(cls, base: LinearOperator, lo: float, hi: float, **kw):
        """P ≈ M^{+1/2} on [lo, hi] (the other half of the symmetric
        shift-invert transform W = M^{1/2}·(A − σM)^{−1}·M^{1/2}).  Far
        easier to fit than the inverse root — √t has no singularity below
        the domain."""
        if not 0 < lo < hi:
            raise ValueError(
                f"sqrt needs 0 < lo < hi, got [{lo}, {hi}] — M must be "
                "positive definite"
            )
        return cls.fit(base, np.sqrt, lo, hi, **kw)

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
        c = (self.hi + self.lo) / 2
        e = (self.hi - self.lo) / 2

        def L(V):  # the [-1, 1]-normalized operator argument
            return (self.base.apply(V) - c * V) / e

        d = self.degree
        if d == 0:
            return self.coeffs[0] * X
        # Clenshaw: b_k = c_k·X + 2·L(b_{k+1}) − b_{k+2}, k = d .. 1;
        # f(M)X = c_0·X + L(b_1) − b_2
        b1 = torch.zeros_like(X)
        b2 = torch.zeros_like(X)
        for i in range(d):
            b1, b2 = self.coeffs[d - i] * X + 2.0 * L(b1) - b2, b1
        return self.coeffs[0] * X + L(b1) - b2

    def scalar(self, x):
        """The exact series value at scalar/array x (test oracle)."""
        lo = float(self.lo)
        hi = float(self.hi)
        xs = (2.0 * np.asarray(x, dtype=np.float64) - hi - lo) / (hi - lo)
        c = self.coeffs.detach().cpu().numpy().astype(np.float64)
        b1 = np.zeros_like(xs)
        b2 = np.zeros_like(xs)
        for k in range(len(c) - 1, 0, -1):
            b1, b2 = c[k] + 2.0 * xs * b1 - b2, b1
        return c[0] + xs * b1 - b2


@dataclasses.dataclass
class PencilOperator(LinearOperator):
    """S = P·A·P for symmetric A and a symmetric P ≈ M^{−1/2}: the
    standard-form transform of the pencil (A, M).  spec(S) approximates the
    pencil eigenvalues; pencil eigenvectors are x = P·y for eigenvectors y
    of S.  Exactly symmetric for ANY symmetric P, so the unmodified solver
    core applies (no M-inner-product fork of the sweep)."""

    A: LinearOperator
    P: LinearOperator

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        return self.P.apply(self.A.apply(self.P.apply(X)))


@dataclasses.dataclass
class GeneralizedShiftInvertOperator(LinearOperator):
    """W = M^{1/2}·(A − σM)^{−1}·M^{1/2}: the symmetric standard form of the
    generalized shift-invert transform (ARPACK mode 3, OP = (A − σM)^{−1}M
    with the M-inner product — this operator is its similarity transform by
    M^{1/2}, so it has the SAME eigenvalues ν = 1/(λ − σ) while being
    symmetric in the plain Euclidean inner product, and the unmodified
    solver core applies).

    Pencil eigenvectors recover as x = M^{−1/2}·y for eigenvectors y of W
    (solver/generalized.py applies the matching ``inv_sqrt`` series and
    re-validates against the true pencil).

    Composition — no factorization anywhere:
    - ``msqrt``: a :class:`ChebyshevSeriesOperator` ≈ M^{1/2} (or an exact
      diagonal operator for lumped mass);
    - the inner inverse: blocked MINRES (ops/minres.py) on the symmetric
      indefinite A − σM, one SpMM with A *and* one with M per inner
      iteration.

    ``sigma`` is a 0-d tensor on A's device.  ``inner_tol`` must sit well
    below the outer tolerance — inner error perturbs W invisibly to the
    outer bounds.  ``precond="jacobi"`` (default) preconditions the inner
    MINRES with T = diag(|diag(A) − σ·diag(M)|)⁻¹ when both operators
    report their diagonals (see ops/minres.py ``jacobi_psolve``);
    ``psolve`` (e.g. an ``AssembledMultigrid.psolve`` built from the
    assembled A) overrides it.  ``inner_precision``: "full"/"auto" run
    MINRES at A's dtype; "mixed" runs it in f32 with f64 defect correction
    (under "mixed" a user ``psolve`` must accept f32 blocks).  ``counts``
    accumulates inner solves and MINRES iterations, as on
    ``ShiftInvertOperator``.
    """

    A: LinearOperator
    M: LinearOperator
    msqrt: LinearOperator   # ≈ M^{1/2}
    sigma: torch.Tensor     # 0-d
    inner_tol: float = 1e-11
    inner_maxiter: Optional[int] = None
    precond: str = "jacobi"
    psolve: Optional[Callable] = None
    inner_precision: str = "auto"
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        from .minres import _count, block_minres, block_minres_refined, jacobi_psolve
        from .spmm.operator import cast_operator

        B = self.msqrt.apply(X.to(self.dtype))

        def op(V):
            return self.A.apply(V) - self.sigma * self.M.apply(V)

        psolve = self.psolve
        if psolve is None and self.precond == "jacobi":
            dA, dM = self.A.diagonal(), self.M.diagonal()
            if dA is not None and dM is not None:
                psolve = jacobi_psolve(
                    dA.to(self.dtype) - self.sigma * dM.to(self.dtype)
                )
        if self.inner_precision == "mixed":
            A32 = cast_operator(self.A, torch.float32)
            M32 = cast_operator(self.M, torch.float32)
            sig32 = self.sigma.to(torch.float32)

            def op32(V):
                return A32.apply(V) - sig32 * M32.apply(V)

            Y, (itn, _) = block_minres_refined(
                op, B, shift=0.0, tol=self.inner_tol,
                apply32=op32, psolve32=psolve,
                inner_maxiter=self.inner_maxiter,
            )
        else:
            Y, (itn, _) = block_minres(
                op, B, shift=0.0, tol=self.inner_tol,
                maxiter=self.inner_maxiter, psolve=psolve,
            )
        _count(self.counts, itn)
        return self.msqrt.apply(Y).to(X.dtype)
