"""Reorthogonalization.

The reference's reorthogonalization layer is a family of per-block BLAS
loops (``part_reorth!``, RBL.jl:34-46; ``hybrid_part_reorth!``,
RBL_gpu.jl:59-81).  Here each projection is two large contractions against
the stored basis prefix:

- partial reorth: both newest blocks stacked into one (n, 2b) panel,
  projected against the stored basis.
- local reorth: CGS2 (two passes of project-then-orthonormalize) of the
  newest block against its predecessor — the *intended* semantics of
  ``loc_reorth!`` (RBL.jl:4-13).
- deflation: projection against the locked Ritz vectors
  (restarted.jl:1-21, RBL.jl:50-59), same formulation.

Every function takes ``mesh`` (a ``parallel.mesh.RowMesh`` or None): under
a mesh the (n, ·) blocks are the rank's rows and each contraction over
rows is reduced over the ranks.
"""

from __future__ import annotations

import torch

from .contract import gram, update
from .qr import block_qr


def project_out(basis, W, mesh=None):
    """W <- W - basis @ (basisᵀ @ W).  basis: (n, M), the stored prefix
    (or a zero-padded buffer); W: (n, p).  The coefficients are rounded to
    the basis dtype, as in the JAX package, and the update accumulates in
    f32 at least.  On the card: one launch of each skinny kernel."""
    return update(basis, gram(basis, W, mesh=mesh), W)


def partial_reorth(basis, Qi, Qprev, qr_method: str = "householder",
                   passes: int = 1, mesh=None, n=None):
    """Project the two newest blocks against the stored basis in one fused
    contraction (reference: part_reorth!, RBL.jl:31-48).

    basis must contain only blocks strictly older than Qprev.  Returns the
    updated (Qi, Qprev); Qprev is re-orthonormalized (a projection against a
    basis that has lost orthogonality can grow a block's norm, and storing
    un-normalized blocks compounds that growth).  ``passes=2`` is CGS2
    against the basis.  Under ``mesh`` the blocks are the rank's rows of
    ``n``."""
    b = Qi.shape[1]
    W = torch.cat([Qi, Qprev], dim=1)
    for _ in range(passes):
        W = project_out(basis, W, mesh)
    Qprev_new, _ = block_qr(W[:, b:], method=qr_method, mesh=mesh, n=n)
    return W[:, :b], Qprev_new


def local_reorth(Qi, Qprev, passes: int = 2, qr_method: str = "householder",
                 mesh=None, n=None):
    """CGS2: orthogonalize Qi against Qprev and re-orthonormalize, `passes`
    times (reference loc_reorth!'s intended algorithm, RBL.jl:4-13)."""
    for _ in range(passes):
        Qi = project_out(Qprev, Qi, mesh)
        Qi, _ = block_qr(Qi, method=qr_method, mesh=mesh, n=n)
    return Qi


def deflate(lock_basis, W, mesh=None):
    """Project W against the locked (converged) Ritz vectors
    (reference restart_reorth!/restart_reorth_gpu!)."""
    return project_out(lock_basis, W, mesh)
