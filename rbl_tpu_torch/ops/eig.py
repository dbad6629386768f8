"""Projected (Rayleigh–Ritz) eigensolve, Ritz selection, and convergence.

Reference path: LAPACK dsbev/ssbev on the *host*, even in the GPU solver
(common.jl:28-48; called at RBL.jl:107, RBL_gpu.jl:187) — T is small, so
shipping it to the CPU is the right call there and here.  The host
functions are the JAX package's numpy/scipy code; the in-repo C++ solver
("native") and the on-device eigh ("device") are not ported yet.

Ritz selection keeps the k largest by |λ| (reference sort_eig_abs,
common.jl:50-54); convergence is the all-or-nothing residual bound
‖B_i · V[last b rows, i]‖ ≤ tol over all k pairs (check_convergence,
common.jl:56-65).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def eig_banded_host(band: np.ndarray, backend: str = "scipy"):
    """All eigenpairs of the banded symmetric T via LAPACK dsbevd (scipy).
    Returns (w ascending, V) as numpy f64."""
    if backend != "scipy":
        raise NotImplementedError(
            f"eig backend {backend!r} is not ported yet (ROADMAP.md "
            "section A); use eig_backend='banded_host'"
        )
    w, V = scipy.linalg.eig_banded(band.astype(np.float64), lower=True)
    return w, V


def _topk_abs_split(w_all: np.ndarray, k: int) -> tuple[int, int]:
    """Two-pointer top-k-by-|λ| selection over an ascending spectrum:
    returns (a, t) with the selected set = prefix [0, a) ∪ suffix [t, m).
    (argsort could split ties non-contiguously, which LAPACK's index-range
    query cannot express.)"""
    m = len(w_all)
    a, t = 0, m
    for _ in range(k):
        if abs(w_all[a]) >= abs(w_all[t - 1]):
            a += 1
        else:
            t -= 1
    return a, t


def eig_banded_values_topk(band: np.ndarray, k: int) -> np.ndarray:
    """The k largest-|λ| eigenvalues (no vectors) of banded symmetric T,
    ascending by |λ|, via dsbevd's values-only path — used to pre-screen
    convergence polls before paying for eigenvectors."""
    w_all = scipy.linalg.eigvals_banded(band.astype(np.float64), lower=True)
    a, t = _topk_abs_split(w_all, min(k, len(w_all)))
    w = np.concatenate([w_all[:a], w_all[t:]])
    return w[np.argsort(np.abs(w))]


def eig_banded_topk(band: np.ndarray, k: int):
    """The k largest-|λ| eigenpairs of banded symmetric T, ascending by |λ|
    — the exact output of ``sort_eig_abs(*eig_banded_host(band), k)`` via
    values-only bisection plus index-range inverse iteration."""
    band = band.astype(np.float64)
    m = band.shape[1]
    if k >= m:
        w, V = eig_banded_host(band)
        return sort_eig_abs(w, V, k)
    w_all = scipy.linalg.eigvals_banded(band, lower=True)
    a, t = _topk_abs_split(w_all, k)
    parts = []
    if a > 0:
        parts.append(
            scipy.linalg.eig_banded(
                band, lower=True, select="i", select_range=(0, a - 1)
            )
        )
    if k - a > 0:
        parts.append(
            scipy.linalg.eig_banded(
                band, lower=True, select="i", select_range=(m - (k - a), m - 1)
            )
        )
    w = np.concatenate([p[0] for p in parts])
    V = np.concatenate([p[1] for p in parts], axis=1)
    order = np.argsort(np.abs(w))
    return w[order], V[:, order]


def eig_banded_topk_dense(band: np.ndarray, k: int):
    """The k largest-|λ| eigenpairs of banded symmetric T, ascending by |λ|
    — the host path for the solver's polls: a values-only dsbevd sweep
    locates the top-k split, then MRRR subset queries (scipy
    ``eigh(subset_by_index=…)`` on the densified T) form only those k
    eigenvectors.  Falls back to the full factorization when k is a large
    fraction of m."""
    band = band.astype(np.float64)
    m = band.shape[1]
    if k * 3 >= m:
        w, V = eig_banded_host(band)
        return sort_eig_abs(w, V, k)
    from .band import band_to_dense

    w_all = scipy.linalg.eigvals_banded(band, lower=True)
    a, t = _topk_abs_split(w_all, k)
    dense = band_to_dense(band)
    parts = []
    if a > 0:
        parts.append(scipy.linalg.eigh(dense, subset_by_index=(0, a - 1)))
    if t < m:
        parts.append(scipy.linalg.eigh(dense, subset_by_index=(t, m - 1)))
    w = np.concatenate([p[0] for p in parts])
    V = np.concatenate([p[1] for p in parts], axis=1)
    order = np.argsort(np.abs(w))
    return w[order], V[:, order]


def sort_eig_abs(w, V, k: int):
    """Keep the k largest-|λ| eigenpairs, ordered ascending by |λ|
    (reference sort_eig_abs, common.jl:50-54 — callers reverse at return)."""
    perm_k = np.argsort(np.abs(w))[-k:]
    return w[perm_k], V[:, perm_k]


def ritz_residual_bounds(Bi, V, b: int):
    """Per-Ritz-pair residual bounds ‖B_i · V[last b rows, j]‖₂ (the
    classical Lanczos bound, common.jl:56-65 and restarted.jl:93)."""
    Y = Bi @ V[-b:, :]
    return np.linalg.norm(Y, axis=0)


def check_convergence(Bi, V, b: int, k: int, tol: float) -> bool:
    """All-or-nothing: every one of the k selected Ritz pairs must meet the
    residual bound (reference check_convergence, common.jl:56-65)."""
    bounds = ritz_residual_bounds(np.asarray(Bi), np.asarray(V[:, :k]), b)
    return bool(np.all(bounds <= tol))


def spectral_norm_bound(op, generator: torch.Generator, iters: int = 24,
                        margin: float = 1.1) -> float:
    """An upper estimate of ‖A‖₂ = |λ|max of a symmetric operator: power
    iteration (a monotone UNDER-estimate converging geometrically in
    |λ₂/λ₁|) times a safety margin.  Sizes the spectral shift for
    ``which="LA"/"SA"`` solves — an overshoot only compresses relative
    gaps by O(margin), while an undershoot could leave the wrong spectrum
    end dominant."""
    v = torch.randn((op.n, 1), generator=generator, dtype=op.dtype,
                    device=op.device)
    v = v / torch.linalg.norm(v)
    nrm = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = op.apply(v)
        nrm = torch.linalg.norm(w)
        v = w / nrm
    return margin * float(nrm)
