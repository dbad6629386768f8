"""Truncated SVD via randomized block Lanczos (port of
``rbl_tpu/solver/svd.py``).

The reference computes truncated SVDs through the normal equations: RBL on
the Gram matrix BᵀB gives σ² and the right singular vectors V, and the left
factor follows as U = B·V/σ (images.jl:21-25, where the Gram matrix is
formed densely and the recovery is inlined in the demo script).  ``rbl_svd``
packages that pattern as a solver API:

- **matrix-free Gram operator** (ops/spmm/operator.py GramOperator): BᵀB is
  never materialized — O(m·n) device memory instead of O(n²)+O(m·n), and
  each apply is two chained GEMMs;
- **small-side selection**: for m < n the solve runs on B·Bᵀ (m×m Krylov
  vectors) and recovers V = Bᵀ·U/σ instead — the reference demo hardcodes
  the BᵀB side;
- **σ≈0 guarding**: Ritz values of a Gram operator are σ² ≥ 0 up to
  rounding; values at/below the floor are clamped and their cross-factor
  columns zeroed rather than divided into garbage.

Caveat inherited from the normal equations (and from the reference): the
Gram matrix SQUARES the spectrum, so σ smaller than ~√eps·σ₁ fall below the
compute dtype's resolvable range — run f64 for wide spectra, exactly as
images.jl does (it keeps Float64 throughout).

``which="SM"`` returns the smallest singular triplets through the σ = 0
shift-invert transform of the Gram operator (ops/minres.py): blocked
MINRES inside, never factoring B.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import RBLConfig, resolve_device
from ..ops.spmm.operator import GramOperator, SparseGramOperator, _pet, dot
from .rbl import rbl


@dataclasses.dataclass
class SVDResult:
    U: torch.Tensor         # (m, k) left singular vectors
    s: np.ndarray           # (k,) singular values, descending; entries at
    #                         the normal-equations noise floor clamped to 0
    V: torch.Tensor         # (n, k) right singular vectors
    iterations: int
    kryl_dim: int
    converged: bool


def _guarded_divide(X, sigma, floor):
    """X / σ column by column, with σ ≤ floor columns zeroed instead of
    divided."""
    live = sigma > floor
    safe = torch.where(live, sigma, torch.ones_like(sigma))
    return torch.where(live[None, :], X / safe[None, :], torch.zeros_like(X))


def _cross_recover(B, W, sigma, floor, transpose: bool = False, mesh=None):
    """The other singular factor: X = (B·W)/σ (or BᵀW), with σ ≤ floor
    columns zeroed instead of divided.  Under ``mesh`` W is the rank's
    rows of the Gram side: it is gathered whole, and the rank keeps its
    own rows of X."""
    M = B.T if transpose else B
    if mesh is not None:
        W = mesh.gather_rows(W, M.shape[1])
    X = _guarded_divide(dot(M, W.to(M.dtype), _pet(W.dtype)), sigma, floor)
    if mesh is not None:
        X = X[slice(*mesh.row_range(M.shape[0]))]
    return X


def _cross_recover_sparse(Bop, W, sigma, floor):
    """Sparse-factor cross recovery: X = Bop(W)/σ with the same σ ≤ floor
    guarding (Bop is the pre-sorted rectangular COO factor)."""
    return _guarded_divide(Bop.apply(W.to(Bop.dtype)), sigma, floor)


def rbl_svd(
    B: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    timer=None,
    v0: Optional[Any] = None,
    which: str = "LM",
) -> SVDResult:
    """Top-k truncated SVD of an (m, n) factor B: B ≈ U·diag(s)·Vᵀ.

    Runs randomized block Lanczos on the matrix-free Gram operator of B's
    smaller side and recovers the cross factor with one product (the
    reference's images.jl:21-25 pattern, lifted out of the demo script).
    A scipy-sparse factor stays sparse: the Gram operator chains two
    rectangular COO SpMMs instead of densifying B.  Host data is built on
    ``cfg.device`` (None: the CUDA card, which must exist); a tensor keeps
    its own device.

    ``v0`` (scipy ``svds`` convention) seeds the first column of the
    sampling block on the Gram side: length ``min(m, n)``.

    ``which="SM"`` returns the k SMALLEST singular triplets (scipy's
    ``svds(which="SM")``) via σ = 0 shift-invert on the Gram operator —
    blocked MINRES inside (Jacobi-preconditioned through the Gram
    operator's diagonal), never factoring B.  Singular values are
    recovered as the cross-product column norms σ = ‖B·w‖ (exact for exact
    singular vectors, first-order accurate in the Ritz error — more robust
    than √λ followed by a division at the small end of the spectrum).  The
    normal-equations resolvability floor √(eps·dim)·σ₁ still applies:
    smaller σ are reported as 0 (run f64 to push the floor down).  A
    rank-deficient B makes the Gram singular at σ = 0 and the inner solve
    stalls, as ARPACK's shift-invert does on a singular pencil.

    Under ``cfg.mesh`` a sparse B whose dimensions divide the mesh size
    runs through a pair of ``ShardedRectCooSpMM`` factors (forward and
    transpose); any other B is applied replicated.  U and V come back as
    the rank's rows of each.
    """
    which = which.upper()
    if which not in ("LM", "SM"):
        raise ValueError(f"which={which!r} not in ('LM', 'SM')")
    cfg = cfg or RBLConfig()
    cdt = cfg.compute_dtype
    mesh = cfg.mesh
    if mesh is not None and cfg.device is None:
        cfg = cfg.replace(device=str(mesh.device))
    if hasattr(B, "tocsr"):
        m, n = B.shape
        if not (0 < k <= min(m, n)):
            raise ValueError(f"k={k} out of range for shape {B.shape}")
        left = m < n  # solve the smaller Gram side
        op = None
        if mesh is None:
            op = SparseGramOperator.from_scipy(B, dtype=cdt, left=left,
                                               device=cfg.device)
        elif m % mesh.size == 0 and n % mesh.size == 0:
            # row-partitioned rectangular COO factors, each all-gathering
            # its input block; indivisible dims take the dense path below
            import scipy.sparse as sp

            from ..parallel.dist_spmm import ShardedRectCooSpMM

            Bc = sp.csr_matrix(B)
            op = SparseGramOperator(
                Bf=ShardedRectCooSpMM.from_scipy(Bc, mesh, dtype=cdt),
                Bt=ShardedRectCooSpMM.from_scipy(Bc.T.tocsr(), mesh,
                                                 dtype=cdt),
                left=left,
            )
        if op is not None:
            res = _solve_gram(op, k, b, cfg, timer, v0, which)
            if which == "SM":
                return _assemble_svd_sm(res, cfg, m, n, left, op=op)
            return _assemble_svd(res, k, cfg, m, n, left, op=op)
        B = B.toarray()
    if isinstance(B, torch.Tensor):
        Bd = B.to(cdt) if cfg.device is None else B.to(
            device=resolve_device(cfg.device), dtype=cdt)
    else:
        Bd = torch.as_tensor(np.asarray(B)).to(
            device=resolve_device(cfg.device), dtype=cdt)
    if Bd.ndim != 2:
        raise ValueError(f"B must be 2-D, got shape {tuple(Bd.shape)}")
    m, n = Bd.shape
    if not (0 < k <= min(m, n)):
        raise ValueError(f"k={k} out of range for shape {tuple(Bd.shape)}")
    left = m < n  # solve the smaller Gram side
    op = GramOperator(B=Bd, left=left)
    res = _solve_gram(op, k, b, cfg, timer, v0, which)
    if which == "SM":
        return _assemble_svd_sm(res, cfg, m, n, left, Bd=Bd)
    return _assemble_svd(res, k, cfg, m, n, left, Bd=Bd)


def _solve_gram(op, k, b, cfg, timer, v0, which):
    """Run the block Lanczos on the Gram-side operator: LM directly, SM
    through the σ = 0 blocked-MINRES shift-invert transform (the Gram is
    SPD, so the inner MINRES is a definite solve)."""
    if which == "SM":
        from ..ops.minres import ShiftInvertOperator, default_inner_tol

        op = ShiftInvertOperator.shift(
            op, 0.0, inner_tol=default_inner_tol(op.dtype, cfg.tol)
        )
    return rbl(op, k, b, cfg=cfg, compute_eigenvectors=True, timer=timer,
               v0=v0)


def _assemble_svd_sm(res, cfg, m, n, left, op=None, Bd=None):
    """SM-end assembly: σ from cross-product column norms ‖B·w‖ (never a
    division by a tiny Ritz-derived σ), with the same normal-equations
    floor as the LM path — σ₁ for the floor comes from a power-method
    bound on the Gram operator since the solve only saw the small end."""
    from ..ops.eig import spectral_norm_bound

    from ..parallel.mesh import col_sumsq

    mesh = cfg.mesh
    W = res.eigenvectors  # (gram-side, k) orthonormal
    xmesh = None  # the mesh X's rows are sharded over (sparse factors)
    if Bd is not None:
        M = Bd.T if left else Bd
        if mesh is not None:  # the whole X from the gathered W
            W_all = mesh.gather_rows(W, M.shape[1])
            X = dot(M, W_all.to(M.dtype), _pet(W.dtype))
        else:
            X = dot(M, W.to(M.dtype), _pet(W.dtype))
        gop = GramOperator(B=Bd, left=left)
    else:
        cross = op.Bt if left else op.Bf
        X = cross.apply(W.to(cross.dtype))
        gop, xmesh = op, mesh
    s = torch.sqrt(col_sumsq(X.to(torch.float64), xmesh)).cpu().numpy()
    gen = torch.Generator(device=gop.device)
    gen.manual_seed(cfg.seed + 2)
    sigma1 = float(np.sqrt(max(spectral_norm_bound(gop, gen, mesh=xmesh),
                               0.0)))
    eps = float(torch.finfo(cfg.compute_dtype).eps)
    floor = float(np.sqrt(eps * max(m, n))
                  * max(sigma1, np.finfo(np.float64).tiny))
    st = torch.as_tensor(s, dtype=X.dtype, device=X.device)
    X = _guarded_divide(X, st, floor)
    if Bd is not None and mesh is not None:
        X = X[slice(*mesh.row_range(X.shape[0]))]  # the rank's rows
    s = np.where(s > floor, s, 0.0)
    order = np.argsort(-s, kind="stable")  # SVDResult contract: descending
    idx = torch.as_tensor(order, device=W.device)
    s, X, W = s[order], X[:, idx], W[:, idx]
    U, V = (W, X) if left else (X, W)
    return SVDResult(U=U, s=s, V=V, iterations=res.iterations,
                     kryl_dim=res.kryl_dim, converged=res.converged)


def _assemble_svd(res, k, cfg, m, n, left, op=None, Bd=None):
    """σ = √λ with noise-floor guarding, descending re-sort, and the
    cross-factor recovery (dense ``Bd`` or sparse ``op`` path)."""
    sig2 = np.maximum(res.eigenvalues, 0.0)  # Ritz values of BᵀB are σ²≥0
    sigma = np.sqrt(sig2)
    # Below floor, W's directions are (numerical) null-space of B: their
    # cross-factor columns are rounding noise scaled by 1/σ — zero them.
    # The floor is the normal-equations resolvability limit: the Gram's
    # rounding is O(dim·eps·σ₁²) in λ, i.e. √(dim·eps)·σ₁ in σ — anything
    # at that level is indistinguishable from null space in this scheme.
    eps = float(torch.finfo(cfg.compute_dtype).eps)
    floor = float(np.sqrt(eps * max(m, n)) * max(
        sigma[0] if len(sigma) else 0.0, np.finfo(np.float64).tiny
    ))
    # Honor the documented contract: σ at/below the floor clamp to 0, and
    # s comes back descending.  Without the re-sort a tiny negative Ritz
    # value (→ σ = 0) can precede a tinier positive one under the solver's
    # |λ| ordering, breaking callers that truncate at the first
    # below-threshold entry.
    sigma = np.where(sigma > floor, sigma, 0.0)
    order = np.argsort(-sigma, kind="stable")
    sigma = sigma[order]
    W = res.eigenvectors
    W = W[:, torch.as_tensor(order, device=W.device)]
    # left (m<n): W = U, recover V = Bᵀ·U/σ; else W = V, recover U = B·V/σ
    if Bd is not None:
        st = torch.as_tensor(sigma, dtype=Bd.dtype, device=Bd.device)
        X = _cross_recover(Bd, W, st, floor, transpose=left, mesh=cfg.mesh)
    else:
        cross = op.Bt if left else op.Bf
        st = torch.as_tensor(sigma, dtype=op.dtype, device=op.device)
        X = _cross_recover_sparse(cross, W, st, floor)
    U, V = (W, X) if left else (X, W)
    return SVDResult(
        U=U,
        s=sigma,
        V=V,
        iterations=res.iterations,
        kryl_dim=res.kryl_dim,
        converged=res.converged,
    )
