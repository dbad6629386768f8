"""Blocked MINRES and the shift-invert spectral transform (port of
``rbl_tpu/ops/minres.py``).

The reference is exterior-only: its ARPACK comparison surface is
``eigs(..., which=:LM)`` (benchmark.jl:42) and the solver itself converges to
largest-magnitude Ritz pairs.  Interior eigenvalues (scipy's
``eigsh(A, k, sigma=...)`` and ``which="SM"``) need the shift-invert
transform OP = (A − σI)⁻¹, whose eigenvalues θ = 1/(λ − σ) make the
eigenvalues of A nearest σ the *exterior* ones of OP.

Design:

- The inner solve is **blocked MINRES** (A − σI is symmetric but indefinite
  for interior σ, so CG does not apply): all b right-hand sides advance in
  lockstep, so each inner iteration costs exactly one block SpMM — the same
  (n, b) shape as the outer Lanczos recurrence — plus a handful of
  per-column (b,) scalar recurrences.  No per-column Python loop.
- The loop runs on the host; every per-column quantity stays on the
  device.  The stop test ``any(φ̄ > tol·β₁)`` is the loop's only
  device→host read, and it is taken every ``DEFAULT_CHECK_EVERY``
  iterations, not every one: between two reads the host
  queues iterations ahead of the card.  Iterations past convergence only
  shrink φ̄ further (a column that broke down exactly stays put through the
  guards), so the answer is the same as the JAX package's or better, and
  the iteration count is rounded up to the cadence.
- Division guards (`beta`, `oldb`, `gamma`) make exact breakdowns (RHS in a
  low-dimensional Krylov space — e.g. B already an eigenvector) converge to
  the exact solution instead of producing NaNs, with no per-column masking.

The recurrence follows Paige & Saunders' MINRES (the same formulation as
scipy.sparse.linalg.minres), vectorized so every scalar becomes a (b,) lane
vector.

The JAX package's ``inner_precision="auto"`` ran the inner solve in f32
with f64 defect correction on the TPU, which has no f64 units; the H100
has them, so "auto" means "full" here and ``block_minres_refined`` is
reached only through the explicit ``inner_precision="mixed"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .spmm.operator import LinearOperator, cast_operator

# Iterations between two reads of the MINRES stop test (see the module
# docstring and PERF.md: the cost of a read on the card).  1 stops at the
# first converged iterate, as the JAX package's ``lax.while_loop`` does.
DEFAULT_CHECK_EVERY = 4


def _coldot(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Per-column dot products, f32-accumulated for sub-f32 inputs."""
    if X.dtype.itemsize >= 4:
        return torch.sum(X * Y, dim=0)
    return torch.sum(X.float() * Y.float(), dim=0).to(X.dtype)


def _safe(d: torch.Tensor) -> torch.Tensor:
    """Guard a nonnegative divisor: exact zero -> 1 (the masked quantity is
    itself zero in that case, so the quotient's value is irrelevant)."""
    return torch.where(d > 0, d, torch.ones_like(d))


def block_minres(
    apply_a: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    *,
    shift: torch.Tensor | float = 0.0,
    tol: float = 1e-11,
    maxiter: Optional[int] = None,
    psolve: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Solve (A − shift·I) X = B columnwise with MINRES in lockstep.

    Parameters
    ----------
    apply_a: block matvec X ↦ A·X on (n, b) tensors (A symmetric).
    B: (n, b) right-hand-side block.
    shift: scalar σ (a Python float or a 0-d tensor on B's device — a
        tensor is never read back to the host).
    tol: per-column relative residual target ‖(A−σI)x − rhs‖ / ‖rhs‖
        (in the preconditioned norm when ``psolve`` is given).
    maxiter: inner iteration cap (default 3n; MINRES terminates in ≤ n
        exact-arithmetic steps, the slack covers finite-precision stalls).
    psolve: optional SPD preconditioner application X ↦ T·X (e.g. Jacobi
        T = diag(|A − σI|)⁻¹): the Paige–Saunders preconditioned recurrence
        — Lanczos runs on T^{1/2}·(A−σI)·T^{1/2} implicitly, one ``psolve``
        per iteration, no T^{1/2} ever formed.  T must be symmetric
        positive definite.

    Returns
    -------
    (X, (iterations, relres)) — the solution block, the number of inner
    iterations executed (an int), and the (b,) per-column relative
    residual estimates (the MINRES φ̄ recurrence, not a recomputed true
    residual; preconditioned-norm when ``psolve`` is given).
    """
    n, b = B.shape
    dt = B.dtype
    dev = B.device
    if maxiter is None:
        maxiter = 3 * n
    maxiter = int(min(maxiter, 2**31 - 1))
    eps = float(torch.finfo(dt).eps)
    sigma = torch.as_tensor(shift, dtype=dt, device=dev)

    def op(V):
        return apply_a(V) - sigma * V

    if psolve is None:
        def psolve(X):  # noqa: E306 — identity preconditioner
            return X
        y = B
        beta1 = torch.sqrt(_coldot(B, B))
    else:
        y = psolve(B)
        # β² = rᵀTr ≥ 0 for SPD T; clamp rounding noise
        beta1 = torch.sqrt(torch.clamp(_coldot(B, y), min=0.0))
    beta1s = _safe(beta1)  # zero columns converge at itn=0 with x=0
    thresh = tol * beta1s

    x = torch.zeros_like(B)
    r1 = r2 = B
    w = w2 = torch.zeros_like(B)
    zeros_b = torch.zeros((b,), dtype=dt, device=dev)
    beta = safe_beta = beta1s
    dbar = epsln = sn = zeros_b
    phibar = beta1
    cs = -torch.ones((b,), dtype=dt, device=dev)

    itn = 0
    while itn < maxiter:
        if itn % DEFAULT_CHECK_EVERY == 0 and not bool(torch.any(phibar > thresh)):
            break
        itn += 1
        v = y / safe_beta[None, :]
        y = op(v)
        # the r1 correction only exists from the second iteration on
        if itn >= 2:
            y = y - (beta / safe_oldb)[None, :] * r1
        alfa = _coldot(v, y)
        y = y - (alfa / safe_beta)[None, :] * r2
        r1, r2 = r2, y
        y = psolve(r2)
        safe_oldb = safe_beta
        beta = torch.sqrt(torch.clamp(_coldot(r2, y), min=0.0))
        safe_beta = _safe(beta)

        # previous plane rotation applied to the new tridiagonal column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1, w2 = w2, w
        w = (v - oldeps[None, :] * w1 - delta[None, :] * w2) / gamma[None, :]
        x = x + phi[None, :] * w
    return x, (itn, phibar / beta1s)


def _count(counts: dict, itn: int):
    counts["applies"] = counts.get("applies", 0) + 1
    counts["iterations"] = counts.get("iterations", 0) + int(itn)


@dataclasses.dataclass
class ShiftInvertOperator(LinearOperator):
    """OP = (A − σI)⁻¹ via blocked MINRES — the spectral transform behind
    ``eigsh(A, k, sigma=σ)`` and ``which="SM"`` (σ = 0).

    θ(OP) = 1/(λ(A) − σ): eigenvalues of A nearest σ become the
    largest-magnitude eigenvalues of OP, which is exactly what the outer
    randomized block Lanczos converges to.  OP is symmetric, so the outer
    solver applies unchanged; each outer recurrence step costs one full
    inner MINRES solve (the price of interior eigenvalues — identical to
    ARPACK's shift-invert mode, but with the factorization replaced by an
    iteration that never materializes or factors A).

    ``sigma`` is a 0-d tensor on the base operator's device, so one
    operator serves every shift without a read back to the host.
    ``inner_tol`` should be well below the outer convergence tolerance —
    inner-solve error acts as a non-symmetric perturbation of OP that the
    outer residual bounds cannot see.

    ``precond="auto"`` (the default) resolves, in order: "fdm" — the EXACT
    fast-diagonalization shifted solve for Kronecker-sum operators
    (ops/fdm.py; a handful of dense products replace the whole inner
    iteration, any σ); "mg" — the geometric multigrid V-cycle for supported
    structured operators (ops/multigrid.py) when the shift is small against
    a diagonal-based ‖A‖ estimate (the cycle approximates A⁻¹, which only
    helps near the bottom of the spectrum); else Jacobi, once, at
    construction.  ``precond="jacobi"``
    preconditions with the quantile-clamped Jacobi T of ``jacobi_psolve``
    (d = diag(A) − σ) whenever the operator can report its diagonal
    (matrix-free operators return None and run unpreconditioned).

    ``counts`` accumulates the inner solves ("applies") and their MINRES
    iterations ("iterations"); reset it by assigning a new dict.
    """

    base: LinearOperator
    sigma: torch.Tensor  # 0-d
    inner_tol: float = 1e-11
    inner_maxiter: Optional[int] = None
    precond: str = "auto"
    # explicit SPD preconditioner application (wins over precond
    # resolution except the exact FDM path) — e.g. an
    # ops/amg.AssembledMultigrid.psolve for assembled FEM matrices
    psolve: Optional[Callable] = None
    # "full": MINRES at the operator dtype.  "mixed": f32 MINRES + f64
    # defect correction (block_minres_refined).  "auto" = "full" on every
    # device of this package (the TPU's reason for "mixed" does not apply).
    # NB under "mixed" a user ``psolve`` must accept f32 blocks.
    inner_precision: str = "auto"
    counts: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.inner_precision not in ("auto", "full", "mixed"):
            raise ValueError(
                f"unknown inner_precision {self.inner_precision!r}")
        # Resolve "auto" once, at construction: the MG V-cycle
        # approximates A⁻¹, which only preconditions (A − σI) well while
        # |σ| is small against ‖A‖ — for interior shifts the 1 − σ/λ
        # spectrum is badly spread at the small-λ end and MG can be worse
        # than Jacobi.
        if self.precond == "auto":
            self.precond = self._resolve_auto(self.base, float(self.sigma))

    @classmethod
    def shift(cls, base: LinearOperator, sigma: float, **kw):
        op = cls(base=base,
                 sigma=torch.as_tensor(float(sigma), dtype=base.dtype,
                                       device=base.device), **kw)
        if op.precond == "fdm":
            # σ exactly at an eigenvalue makes A − σI singular; fail
            # loudly at construction instead of NaN-poisoning the sweep
            # (scipy's factorized shift-invert fails the same way, with
            # a singular-matrix error from the LU)
            from .fdm import fdm_min_shift_gap

            gap = fdm_min_shift_gap(base, float(sigma))
            if gap is not None and gap < 1e-12 * max(1.0, abs(float(sigma))):
                raise ValueError(
                    f"sigma={float(sigma)!r} coincides with an eigenvalue "
                    "of the operator (A - sigma*I is singular) — perturb "
                    "sigma"
                )
        return op

    @staticmethod
    def _resolve_auto(base: LinearOperator, sigma: float) -> str:
        """'fdm' when the operator admits an exact fast-diagonalization
        shifted solve (ops/fdm.py — Kronecker sums, any σ); else 'mg'
        when a V-cycle exists AND σ sits in the bottom of the spectrum
        (|σ| ≤ c·‖A‖ with ‖A‖ estimated from the diagonal — 2·max|d| is
        exact for the model Laplacians and a Gershgorin-flavored proxy
        generally); else 'jacobi'."""
        from .fdm import fdm_solver_for
        from .multigrid import mg_psolve_for

        if fdm_solver_for(base) is not None:
            return "fdm"
        if mg_psolve_for(base) is None:
            return "jacobi"
        d = base.diagonal()
        if d is not None:
            norm_est = 2.0 * float(torch.max(torch.abs(d)))
            if abs(sigma) > 0.125 * norm_est:
                return "jacobi"
        return "mg"

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _minres_solve(self, B: torch.Tensor, psolve) -> torch.Tensor:
        """The inner solve, at full or mixed precision (see
        ``inner_precision``)."""
        if self.inner_precision == "mixed":
            op32 = cast_operator(self.base, torch.float32)
            Y, (itn, _) = block_minres_refined(
                self.base.apply, B, shift=self.sigma,
                tol=self.inner_tol, apply32=op32.apply, psolve32=psolve,
                inner_maxiter=self.inner_maxiter,
            )
        else:
            Y, (itn, _) = block_minres(
                self.base.apply, B, shift=self.sigma, tol=self.inner_tol,
                maxiter=self.inner_maxiter, psolve=psolve,
            )
        _count(self.counts, itn)
        return Y

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        precond = self.precond
        if self.psolve is not None and precond != "fdm":
            # an explicit SPD preconditioner (e.g. assembled-matrix AMG,
            # ops/amg.py) wins over the built-in resolution — except the
            # exact FDM solve, which no preconditioner can beat
            return self._minres_solve(
                X.to(self.dtype), self.psolve
            ).to(X.dtype)
        if precond == "fdm":
            return self._fdm_apply(X)
        psolve = None
        if precond == "mg":
            # geometric V-cycle for supported structured operators
            # (ops/multigrid.py).  Approximates A⁻¹, so it is the right
            # preconditioner for sigma at/near 0 ("SM", lowest modes).
            from .multigrid import mg_psolve_for

            psolve = mg_psolve_for(self.base)
            if psolve is None:
                raise ValueError(
                    "precond='mg' requires a supported structured "
                    "operator (Laplacian2D with even dims, hierarchy "
                    "bottoming out near 8x8) — use 'jacobi', 'auto', "
                    "or 'none'"
                )
        if psolve is None and precond == "jacobi":
            d = self.base.diagonal()
            if d is not None:
                psolve = jacobi_psolve(d.to(self.dtype) - self.sigma)
        return self._minres_solve(X.to(self.dtype), psolve).to(X.dtype)

    def _fdm_apply(self, X: torch.Tensor) -> torch.Tensor:
        # exact fast-diagonalization shifted solve (ops/fdm.py): no inner
        # iteration at all — the analogue of ARPACK's factorized
        # shift-invert, valid at any σ
        from .fdm import fdm_solver_for

        direct = fdm_solver_for(self.base)
        if direct is None:
            raise ValueError(
                "precond='fdm' requires a Kronecker-sum operator "
                "(Laplacian2D/3D) — use 'mg', 'jacobi', 'auto', or "
                "'none'"
            )
        _count(self.counts, 0)
        return direct(X.to(self.dtype), self.sigma).to(X.dtype)


def block_minres_refined(
    apply64: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    *,
    shift: torch.Tensor | float = 0.0,
    tol: float = 1e-11,
    apply32: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    psolve32: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    inner_tol: float = 1e-5,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 8,
):
    """Solve (A − σI) X = B to f64 accuracy with ALL MINRES iterations in
    f32: repeated defect correction x ← x + S₃₂(b − (A−σI)x), where S₃₂ is
    an f32 blocked-MINRES solve to ``inner_tol`` and the residual is true
    f64 (one ``apply64`` per refinement step).

    The JAX package's f64 strategy for the TPU (no f64 units there); on
    the card it is an option (``inner_precision="mixed"``), not the
    default.  Each refinement contracts the error by ~max(inner_tol,
    κ·eps₃₂), so the loop reaches ``tol`` (relative, f64 floor) when
    κ(A−σI) ≲ 1e5 — beyond that the f32 inner solve itself stalls and the
    loop exits at ``max_refine`` with whatever it reached.

    apply32/psolve32 default to casting wrappers around ``apply64``.
    Returns (X, (refinements, relres)); the per-column residuals are read
    once per refinement step.
    """
    if apply32 is None:
        def apply32(V):  # noqa: E306
            return apply64(V.to(B.dtype)).to(torch.float32)
    sig64 = torch.as_tensor(shift, dtype=B.dtype, device=B.device)
    sig32 = sig64.to(torch.float32)

    def rnorm(r):
        return torch.sqrt(torch.sum(r * r, dim=0))

    bnorm = rnorm(B)
    bnorm_s = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))

    def resid(x):
        return B - (apply64(x) - sig64 * x)

    def solve32(r):
        dx, _ = block_minres(
            apply32, r.to(torch.float32), shift=sig32, tol=inner_tol,
            maxiter=inner_maxiter, psolve=psolve32,
        )
        return dx.to(B.dtype)

    x = solve32(B)
    r = resid(x)
    it = 1
    while it < max_refine and bool(torch.any(rnorm(r) > tol * bnorm_s)):
        x = x + solve32(r)
        r = resid(x)
        it += 1
    return x, (it, rnorm(r) / bnorm_s)


def default_inner_tol(dtype, tol: float) -> float:
    """Inner MINRES relative target for shift-invert transforms: well
    below the outer tolerance (inner error perturbs OP invisibly to the
    outer residual bounds), but floored at what the dtype's φ̄ recurrence
    can honestly reach — 1e-13 for f64, 30·eps for sub-f64 compute
    dtypes.  Below the floor the φ̄ estimate keeps 'converging' while the
    TRUE residual stalls."""
    fi = torch.finfo(dtype)
    floor = 1e-13 if fi.bits >= 64 else 30.0 * float(fi.eps)
    return float(max(floor, min(1e-11, 1e-4 * tol)))


def jacobi_psolve(d: torch.Tensor, clamp_quantile: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """SPD Jacobi preconditioner T = diag(max(|d|, floor))⁻¹ for a
    (possibly indefinite) system whose matrix diagonal is ``d`` — the
    absolute value keeps T positive definite, which preconditioned MINRES
    requires.

    The floor is the ``clamp_quantile`` quantile of |d| (not a tiny
    epsilon): a shift-invert diagonal d = diag(A) − σ·diag(M) CROSSES ZERO
    at interior shifts, and amplifying the near-crossing rows by 1/|d|
    scales their off-diagonal coupling up unboundedly.  Clamping at q10
    keeps those rows un-amplified while preserving the global
    equilibration.  Everything stays on d's device."""
    dabs = torch.abs(d)
    floor = torch.clamp(torch.quantile(dabs, clamp_quantile),
                        min=torch.finfo(d.dtype).tiny)
    inv = 1.0 / torch.maximum(dabs, floor)

    def psolve(X):
        return X * inv[:, None].to(X.dtype)

    return psolve
