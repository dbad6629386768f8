"""Tall-skinny QR / block orthonormalization.

The reference leans on LAPACK geqrf (RBL.jl:86,103) and CUSOLVER qr
(RBL_gpu.jl:155,180) for the n×b residual block.  Two choices:

- "householder": ``torch.linalg.qr`` — bitwise-robust, used for the strict
  f64 accuracy gates.
- "cholqr2": CholeskyQR2 — G = XᵀX (one GEMM), Cholesky of the b×b Gram,
  triangular solve, repeated twice.  O(eps) orthogonality for
  κ(X) ≲ eps^-1/2 at matmul speed.

A small symmetric shift (shifted CholeskyQR) guards against breakdown when
the residual block is numerically rank-deficient — a case the reference never
handles (SURVEY §5: no breakdown handling).

Under a row mesh (``mesh``) X is the rank's rows of n.  CholeskyQR
reduces its b×b Gram and its column norms over the ranks (one all-reduce
each), so R is replicated and Q keeps the rank's rows.  Householder does
what GSPMD does with ``jnp.linalg.qr`` of a row-sharded operand: it
gathers the (n, b) block, factors it on every rank and keeps the own rows
of Q.
"""

from __future__ import annotations

import torch

from ..config import matmul_precision
from ..parallel.mesh import col_sumsq
from .contract import _CHUNK, gram
from .spmm.operator import _pet, dot


def _chol_qr_once(X, acc_dtype, mesh=None):
    n, b = X.shape
    # The Gram pins the factorization's entire accuracy: full FP32 on the
    # card whatever the ambient matmul precision (never TF32).
    with matmul_precision("highest"):
        G = gram(X, X, acc_dtype=acc_dtype, mesh=mesh)
    eps = torch.finfo(acc_dtype).eps
    tiny = torch.finfo(acc_dtype).tiny
    # torch's Cholesky raises on failure where JAX's returns NaN; the _ex
    # form reports it in ``info`` instead, with no host sync.
    L, info = torch.linalg.cholesky_ex(G)
    # Fall back to a shifted Cholesky only on breakdown (nearly
    # rank-deficient X): the shift keeps G positive definite under rounding
    # at the cost of O(shift/σ_min²) orthogonality, which the next pass or
    # the enclosing CGS sweep repairs.  The error-size factor reflects
    # gram's chunked PAIRWISE accumulation (error ~ eps·chunk, not eps·n).
    # The absolute tiny-floor covers X ≈ 0 (a fully deflated residual
    # block), where a trace-proportional shift vanishes.
    err_rows = min(n, _CHUNK) * b + b * (b + 1)
    tr = torch.trace(G)
    shift = 11.0 * err_rows * eps * tr / b + tiny * 1e4
    eye = torch.eye(b, dtype=G.dtype, device=G.device)
    L_shifted, _ = torch.linalg.cholesky_ex(G + shift * eye)
    bad = (info != 0) | torch.isnan(L).any()
    R = torch.where(bad, L_shifted, L).T  # upper triangular
    # Clamp vanishing diagonal entries before the solve: a ~0 pivot turns a
    # degenerate column into an unbounded one, whose norm then SQUARES in
    # downstream Grams.  With the clamp a degenerate column comes out ≈ 0;
    # the solver's host-side collapse detection then handles the
    # breakdown.  The floor sits between healthy pivots and rounding
    # garbage: √eps on the average column scale.
    floor = torch.sqrt(eps * tr / b) + tiny
    d = torch.abs(torch.diagonal(R))
    R_solve = R + torch.diag(torch.where(d < floor, floor, torch.zeros_like(d)))
    # solved in the accumulation dtype: torch has no bf16 triangular solve
    Q = torch.linalg.solve_triangular(
        R_solve, X.to(acc_dtype), upper=True, left=False
    ).to(X.dtype)
    return Q, R


def cholqr(X, passes: int = 2, mesh=None):
    """CholeskyQR with `passes` refinement sweeps. Returns (Q, R) with
    X = Q @ R, R upper-triangular (product of per-pass factors).

    The first pass runs on column-equilibrated X: with mixed column scales
    the Gram's small diagonal entries drown in the rounding of the large
    ones (eps·max² ≫ min²) and the factor comes out garbage.  Scaling
    columns to unit norm bounds the Gram's dynamic range by inter-column
    angles only; the scales are absorbed into R (X = X̂·D, X̂ = Q·R̂ ⇒
    R = R̂·D)."""
    acc = _pet(X.dtype)
    Xa = X.to(acc)
    d = torch.sqrt(col_sumsq(Xa, mesh))
    d_safe = torch.where(d > 0, d, torch.ones_like(d))
    Q, R = _chol_qr_once(X / d_safe.to(X.dtype)[None, :], acc, mesh)
    R = R * d_safe[None, :]
    for _ in range(passes - 1):
        Q, R2 = _chol_qr_once(Q, acc, mesh)
        R = dot(R2, R, acc)
    return Q, R.to(X.dtype)


def householder_qr(X, mesh=None, n=None):
    """``torch.linalg.qr``; under ``mesh`` X is the rank's rows of the
    global row count ``n``."""
    if mesh is None:
        return torch.linalg.qr(X, mode="reduced")
    if n is None:
        raise ValueError("householder_qr under a mesh needs n, the global "
                         "row count")
    Q, R = torch.linalg.qr(mesh.gather_rows(X, n), mode="reduced")
    lo, hi = mesh.row_range(n)
    # the own rows in the column-major layout the unsharded QR returns:
    # on the card a row-major copy sends the products after it down other
    # GEMM kernels, whose sums round differently.  The copy (none on one
    # rank, where the rows are all of Q) lets the whole Q go
    return Q[lo:hi].mT.contiguous().mT, R


def block_qr(X, method: str = "householder", mesh=None, n=None):
    """Orthonormalize the columns of the tall-skinny block X (the rank's
    rows of ``n`` under ``mesh``; Householder reads n).

    Returns (Q, R): the reference consumes Q as the next Lanczos block and
    R as the super-/sub-diagonal block B_i of T (RBL.jl:86-88)."""
    if method == "householder":
        return householder_qr(X, mesh, n)
    if method == "cholqr2":
        return cholqr(X, passes=2, mesh=mesh)
    if method == "cholqr3":
        return cholqr(X, passes=3, mesh=mesh)
    raise ValueError(f"unknown qr method: {method}")
