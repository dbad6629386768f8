"""Fast-diagonalization (FDM) exact shifted solves for Kronecker-sum
operators (port of ``rbl_tpu/ops/fdm.py``) — the analogue of ARPACK's
factorized shift-invert.

The model stencil operators are Kronecker sums (Laplacian2D = L⊗I + I⊗L,
Laplacian3D likewise).  Such operators diagonalize separably: with
L = QΛQᵀ,

    (A − σI)⁻¹ = (Q⊗Q) diag(λᵢ + λⱼ − σ)⁻¹ (Q⊗Q)ᵀ,

so a SHIFTED SOLVE is exact in 2d dense (n^{1/d}·n^{1/d}) × (n^{1/d}·b)
products — no iteration.  For the 512² grid that is four 512×512 @
512×(512·b) products per apply, replacing an inner MINRES run of hundreds
of SpMM iterations, and it is valid at ANY shift (interior σ included).

The 1-D Dirichlet factors have the analytic eigensystem
λ_k = 2 − 2cos(kπ/(n+1)), Q[i,k] = √(2/(n+1))·sin((i+1)(k+1)π/(n+1)),
so construction is closed-form (no LAPACK call).

The transforms are plain dense products (the JAX package computed them
outside any Pallas kernel), so they are ``torch.matmul`` here.  The JAX
package ran f64 solves as f32 transforms plus three steps of iterative
refinement, because the TPU has no f64 units; the card has them, so an
f64 solve runs its transforms in f64, with no refinement.  The
denominators λᵢ + λⱼ are summed in f64 on the host and rounded once to the
solve's dtype, so an f32 solve keeps the small eigenvalues' relative
accuracy.

``ShiftInvertOperator(precond="auto")`` resolves to this first
(ops/minres._resolve_auto); the V-cycle (ops/multigrid.py) remains the tier
for structured operators that are not Kronecker sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["fdm_solver_for", "fdm_min_shift_gap"]


@functools.lru_cache(maxsize=16)
def _dirichlet_eig_1d(n: int):
    """Analytic eigensystem of tridiag(-1, 2, -1) (n points, Dirichlet at
    virtual points 0 and n+1).  Returns (lam (n,), Q (n, n)) float64; Q
    orthonormal, A = Q diag(lam) Qᵀ."""
    k = np.arange(1, n + 1)
    lam = 2.0 - 2.0 * np.cos(np.pi * k / (n + 1))
    i = np.arange(1, n + 1)
    Q = np.sqrt(2.0 / (n + 1)) * np.sin(np.pi * np.outer(i, k) / (n + 1))
    return lam, Q


class _FdmSolve:
    """solve(X, sigma) = (A − σI)⁻¹X for A = Σ_a I⊗…⊗L_a⊗…⊗I on a grid of
    ``dims``.  The factors and the summed eigenvalues are moved to a
    device once per (dtype, device) and kept."""

    def __init__(self, dims):
        self.dims = tuple(int(d) for d in dims)
        eig = [_dirichlet_eig_1d(d) for d in self.dims]
        self._Q = [Q for _, Q in eig]
        lam = eig[0][0]
        for lam_a, _ in eig[1:]:
            lam = np.add.outer(lam, lam_a)
        self._lam = lam  # (dims) f64: λ of A on the grid
        self._cache = {}

    def _tensors(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._cache:
            self._cache[key] = (
                [torch.as_tensor(Q, dtype=dtype, device=device)
                 for Q in self._Q],
                torch.as_tensor(self._lam, dtype=dtype, device=device),
            )
        return self._cache[key]

    def __call__(self, X: torch.Tensor, sigma) -> torch.Tensor:
        Qs, lam = self._tensors(X.dtype, X.device)
        b = X.shape[1]
        den = lam - torch.as_tensor(sigma, dtype=X.dtype, device=X.device)
        T = X.reshape(*self.dims, b)
        nd = len(self.dims)
        # forward transform (Qᵀ along each axis), pointwise solve, back:
        # each axis product moves that axis to the front, multiplies, and
        # moves it back
        for a, Q in enumerate(Qs):
            T = torch.movedim(torch.tensordot(Q.T, T, dims=([1], [a])), 0, a)
        T = T / den[..., None]
        for a in reversed(range(nd)):
            T = torch.movedim(torch.tensordot(Qs[a], T, dims=([1], [a])), 0, a)
        return T.reshape(X.shape)


def fdm_min_shift_gap(op, sigma: float):
    """min |λ(A) − σ| for a supported Kronecker-sum operator (None if
    unsupported).  The FDM solve divides by these gaps — a σ that hits an
    eigenvalue exactly (it happens on the model Laplacians: e.g. σ = 3 on
    a 64² grid via cos(π/5) − cos(2π/5) = ½) must be rejected with a clear
    error instead of NaN-poisoning the sweep."""
    dims = _kron_dims(op)
    if dims is None:
        return None
    return float(np.abs(_solver(dims)._lam - sigma).min())


def _kron_dims(op):
    from .spmm.operator import Laplacian2D, Laplacian3D

    if isinstance(op, Laplacian2D):
        return (op.nx, op.ny)
    if isinstance(op, Laplacian3D):
        return (op.nx, op.ny, op.nz)
    return None


@functools.lru_cache(maxsize=8)
def _solver(dims) -> _FdmSolve:
    return _FdmSolve(dims)


def fdm_solver_for(op):
    """Return an exact shifted-solve ``solve(X, sigma) -> (A−σI)⁻¹X`` for a
    supported Kronecker-sum operator, or None.  ``sigma`` may be a 0-d
    tensor on X's device (it only enters the pointwise denominators, so
    one solver serves every shift)."""
    dims = _kron_dims(op)
    return None if dims is None else _solver(dims)
