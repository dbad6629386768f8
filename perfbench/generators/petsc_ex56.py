"""PETSc's ex56: 3-D linear elasticity on the unit cube, assembled.

``src/ksp/ksp/tutorials/ex56.c``, the standard test of PETSc's algebraic
multigrid (GAMG): trilinear hexahedra (Q1) with three displacements a
node, ``-ne`` elements to a side (h = 1/ne), Young's modulus E = 1,
Poisson's ratio ν = 0.25, a Dirichlet condition on the face y = 0, and
``-alpha 1`` (the embedded soft ball's material scaled by 1: homogeneous).

The matrix as the configuration states it: nodes numbered x fastest, then
y, then z, the three dofs of a node interleaved (ex56's block size 3);
the element integrated by 2×2×2 Gauss quadrature; the clamped dofs
eliminated (rows and columns removed), so that the stiffness is symmetric
positive definite with n = 3·(ne+1)²·ne.  Assembled in float64 with
every 3×3 block of two neighbouring nodes stored, as ex56's blocked
assembly (``MatSetValuesBlocked`` of whole elements) stores it: at
ν = 0.25 (λ = μ) a third of the element's couplings vanish, and they are
stored as exact zeros.  ``nonzeros`` counts the values a product needs,
without those zeros.

It is the configuration's plain reference and imports nothing of the
program.  ``mirrors`` gives the signed permutations of the free dofs
under the mesh's symmetries (the planes x = ½ and z = ½ and the swap of
x and z), which commute with the matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from perfbench.harness.problem import Problem

GAUSS = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))   # 2-point rule, weights 1
# the element's corners in reference coordinates, x fastest
CORNERS = np.array([(x, y, z) for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
                   dtype=np.float64)


def hooke(E: float, nu: float) -> np.ndarray:
    """The isotropic 6×6 material matrix in Voigt order
    (xx, yy, zz, yz, zx, xy), engineering shear strains."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[range(3), range(3)] = lam + 2.0 * mu
    D[range(3, 6), range(3, 6)] = mu
    return D


def element(h: float, E: float, nu: float) -> np.ndarray:
    """The 24×24 stiffness of a cube of side h: dofs (node, direction),
    direction fastest, nodes in ``CORNERS`` order."""
    D = hooke(E, nu)
    K = np.zeros((24, 24))
    for xi in [(a, b, c) for a in GAUSS for b in GAUSS for c in GAUSS]:
        # ∂N_a/∂ξ_d = c_ad/8 · Π_{e≠d} (1 + c_ae ξ_e); ∂ξ/∂x = 2/h
        grad = np.empty((8, 3))
        for d in range(3):
            others = [e for e in range(3) if e != d]
            grad[:, d] = (CORNERS[:, d] / 8.0
                          * np.prod(1.0 + CORNERS[:, others] * np.asarray(xi)[others],
                                    axis=1))
        grad *= 2.0 / h
        B = np.zeros((6, 24))
        for a in range(8):
            gx, gy, gz = grad[a]
            c = 3 * a
            B[0, c] = gx
            B[1, c + 1] = gy
            B[2, c + 2] = gz
            B[3, c + 1], B[3, c + 2] = gz, gy
            B[4, c], B[4, c + 2] = gz, gx
            B[5, c], B[5, c + 1] = gy, gx
        K += B.T @ D @ B * (h / 2.0) ** 3          # the Jacobian's determinant
    K = (K + K.T) / 2.0
    # couplings whose integrals vanish (λ = μ at ν = 0.25) come out as
    # rounding noise: make them the exact zeros they are
    K[np.abs(K) < 1e-12 * np.abs(K).max()] = 0.0
    return K


def node_ids(ne: int) -> np.ndarray:
    """(ne+1)³ node numbers indexed [k, j, i] (z, y, x): x fastest."""
    m = ne + 1
    return np.arange(m ** 3, dtype=np.int64).reshape(m, m, m)


def free_dofs(ne: int) -> np.ndarray:
    """The dofs that the clamp on y = 0 leaves, in the global order."""
    keep = np.ones((ne + 1, ne + 1, ne + 1, 3), dtype=bool)
    keep[:, 0, :, :] = False
    return np.flatnonzero(keep.ravel())


def assemble(ne: int, E: float = 1.0, nu: float = 0.25) -> sp.csr_matrix:
    """The stiffness with the clamped dofs eliminated, float64 CSR."""
    Ke = element(1.0 / ne, E, nu)
    ids = node_ids(ne)
    # each element's 8 corner nodes in CORNERS order (x fastest)
    corner = np.stack([ids[dz:dz + ne, dy:dy + ne, dx:dx + ne].ravel()
                       for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], axis=1)
    dof = (3 * corner[:, :, None] + np.arange(3)).reshape(-1, 24)
    ndof = 3 * ids.size
    # the global numbers of the free dofs (-1 for a clamped one)
    renum = np.full(ndof, -1, dtype=np.int64)
    free = free_dofs(ne)
    renum[free] = np.arange(free.size)
    local = renum[dof]
    rows = np.repeat(local, 24, axis=1).ravel()
    cols = np.tile(local, (1, 24)).ravel()
    vals = np.broadcast_to(Ke.ravel(), (local.shape[0], 576)).ravel()
    live = (rows >= 0) & (cols >= 0)
    n = free.size
    A = sp.csr_matrix((vals[live], (rows[live].astype(np.int32),
                                    cols[live].astype(np.int32))), shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def mirrors(ne: int) -> dict:
    """Signed permutations S of the free dofs with S·A·Sᵀ = A: the mirror
    in x = ½ (x → 1 − x, u_x → −u_x), in z = ½, and the swap of x and z
    (u_x ↔ u_z).  Each is an (n, n) CSR matrix taking a vector to its
    image."""
    m = ne + 1
    k, j, i = np.meshgrid(np.arange(m), np.arange(m), np.arange(m), indexing="ij")
    free = free_dofs(ne)
    renum = np.full(3 * m ** 3, -1, dtype=np.int64)
    renum[free] = np.arange(free.size)

    def signed(ii, kk, perm, sign):
        node = (kk * m + j) * m + ii                      # the image's node
        src = 3 * node_ids(ne)[..., None] + np.arange(3)  # (m, m, m, 3)
        dst = 3 * node[..., None] + np.asarray(perm)
        s = np.broadcast_to(np.asarray(sign, dtype=np.float64), src.shape)
        r, c = renum[dst.ravel()], renum[src.ravel()]
        ok = c >= 0
        return sp.csr_matrix((s.ravel()[ok], (r[ok], c[ok])),
                             shape=(free.size, free.size))

    return {"x": signed(ne - i, k, (0, 1, 2), (-1, 1, 1)),
            "z": signed(i, ne - k, (0, 1, 2), (1, 1, -1)),
            "xz": signed(k, i, (2, 1, 0), (1, 1, 1))}


def build(config: dict) -> Problem:
    ne = int(config["ne"])
    if float(config.get("alpha", 1.0)) != 1.0:
        raise ValueError("only -alpha 1 (a homogeneous cube) is generated")
    A = assemble(ne, float(config.get("E", 1.0)), float(config.get("nu", 0.25)))
    norm = float(abs(A).sum(axis=1).max())
    return Problem(n=A.shape[0], nonzeros=int(np.count_nonzero(A.data)), norm=norm,
                   A=A)
