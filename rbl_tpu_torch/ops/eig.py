"""Projected (Rayleigh–Ritz) eigensolve, Ritz selection, and convergence.

Reference path: LAPACK dsbev/ssbev on the *host*, even in the GPU solver
(common.jl:28-48; called at RBL.jl:107, RBL_gpu.jl:187) — T is small, so
shipping it to the CPU is the right call there and here.  The host
functions are the JAX package's numpy/scipy code.  Three backends
factorize T (``RBLConfig.eig_backend``): "banded_host", scipy's LAPACK;
"native", the in-repo C++ tred2/tql2 solver (``rbl_tpu_torch.native``);
"device", ``torch.linalg.eigh`` of the densified T in f64 on the solve's
device.

Ritz selection keeps the k largest by |λ| (reference sort_eig_abs,
common.jl:50-54); convergence is the all-or-nothing residual bound
‖B_i · V[last b rows, i]‖ ≤ tol over all k pairs (check_convergence,
common.jl:56-65).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def eig_banded_host(band: np.ndarray, backend: str = "scipy", device=None):
    """All eigenpairs of the banded symmetric T.  Returns (w ascending, V)
    as numpy f64.

    backend="scipy": LAPACK dsbevd via scipy (default).
    backend="native": the in-repo C++ tred2/tql2 solver
    (``csrc/host/band_eig.cpp``); raises if its library cannot be built.
    backend="device": ``torch.linalg.eigh`` of the densified T in f64 on
    ``device`` (None: the CUDA card), on a side stream of its own on a
    CUDA device, so that its two copies neither wait for nor hold up the
    work queued on the caller's stream; pays two transfers a call."""
    if backend == "native":
        from ..native import band_eigh

        return band_eigh(band)
    if backend == "device":
        from ..config import resolve_device
        from .band import band_to_dense

        dev = resolve_device(device)
        dense = band_to_dense(band.astype(np.float64))
        if dev.type != "cuda":
            w, V = eigh_device(torch.as_tensor(dense, device=dev))
            return w.numpy(), V.numpy()
        with torch.cuda.stream(torch.cuda.Stream(device=dev)):
            w, V = eigh_device(torch.as_tensor(dense, device=dev))
            return w.cpu().numpy(), V.cpu().numpy()
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


def eigh_device(T_dense: torch.Tensor):
    """Dense symmetric eigensolve of T on its own device (ascending)."""
    return torch.linalg.eigh(T_dense)


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
                        margin: float = 1.1, mesh=None) -> float:
    """An upper estimate of ‖A‖₂ = |λ|max of a symmetric operator: power
    iteration (a monotone UNDER-estimate converging geometrically in
    |λ₂/λ₁|) times a safety margin.  Sizes the spectral shift for
    ``which="LA"/"SA"`` solves — an overshoot only compresses relative
    gaps by O(margin), while an undershoot could leave the wrong spectrum
    end dominant.  Under ``mesh`` the vectors are the rank's rows (the
    whole start vector is drawn on every rank) and the norms are reduced
    over the ranks."""
    from ..parallel.mesh import col_sumsq, randn_rows

    v = randn_rows(op.n, 1, generator, op.dtype, op.device, mesh)
    if mesh is None:
        v = v / torch.linalg.norm(v)
    else:
        v = v / torch.sqrt(col_sumsq(v, mesh))
    nrm = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = op.apply(v)
        nrm = (torch.linalg.norm(w) if mesh is None
               else torch.sqrt(col_sumsq(w, mesh))[0])
        v = w / nrm
    return margin * float(nrm)
