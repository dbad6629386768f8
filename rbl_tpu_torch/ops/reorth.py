"""Reorthogonalization.

The reference's reorthogonalization layer is a family of per-block BLAS
loops (``part_reorth!``, RBL.jl:34-46; ``hybrid_part_reorth!``,
RBL_gpu.jl:59-81; ``loc_reorth!``, RBL.jl:4-13).  Here each projection is
two large contractions against a stored block or prefix; the sweep
(``solver/lanczos.py``) applies them to the newborn residual of each step:

- projection against the stored basis, a host panel or a parent block
  (the sweep's full and local scrubs);
- deflation: projection against the locked Ritz vectors
  (restarted.jl:1-21, RBL.jl:50-59), same formulation.

Every function takes ``mesh`` (a ``parallel.mesh.RowMesh`` or None): under
a mesh the (n, ·) blocks are the rank's rows and each contraction over
rows is reduced over the ranks.
"""

from __future__ import annotations

from .contract import gram, update


def project_out(basis, W, mesh=None):
    """W <- W - basis @ (basisᵀ @ W).  basis: (n, M), the stored prefix
    (or a zero-padded buffer); W: (n, p).  The coefficients are rounded to
    the basis dtype, as in the JAX package, and the update accumulates in
    f32 at least.  On the card: one launch of each skinny kernel."""
    return update(basis, gram(basis, W, mesh=mesh), W)


def deflate(lock_basis, W, mesh=None):
    """Project W against the locked (converged) Ritz vectors
    (reference restart_reorth!/restart_reorth_gpu!)."""
    return project_out(lock_basis, W, mesh)
