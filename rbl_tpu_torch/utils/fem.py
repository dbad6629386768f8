"""3D linear-elasticity FEM stiffness assembly (the SuiteSparse ldoor/hood
matrix family, built from an actual discretization).

The reference benchmarks SuiteSparse structural matrices — ldoor, hood,
audikw (reference `Julia/benchmark.jl:21-28`): 3-D solid-mechanics
stiffness matrices with 3 dof per node and dense 3x3 node-coupling blocks.
This environment has no network egress (`benchmarks/fetch_suitesparse.sh`
documents the download path for machines that do), so the benchmark-class
matrix is *assembled* here instead of downloaded: an isotropic
linear-elasticity stiffness matrix on a uniform 8-node hexahedral mesh,
2x2x2 Gauss quadrature — a real FEM operator with the same block
structure (3x3 dof blocks, 27-node coupling stencil, ~81 nnz/row
interior), a genuine elasticity spectrum, and SPD after clamping one
face's rigid-body modes.

This is NOT a random-pattern synthetic: the entries are the exact element
stiffness integrals, so conditioning, clustering, and convergence behavior
are those of a production structural model at the same mesh resolution.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["hex8_stiffness", "fem_elasticity_3d"]


def hex8_stiffness(h: float = 1.0, E: float = 1.0, nu: float = 0.3) -> np.ndarray:
    """24x24 element stiffness of an 8-node hexahedron with side h.

    Trilinear shape functions, full 2x2x2 Gauss quadrature, isotropic
    Hooke tensor (Young's modulus E, Poisson ratio nu), Voigt ordering
    (xx, yy, zz, xy, yz, zx).  Node order: x fastest, then y, then z.
    """
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[3:, 3:] = np.eye(3) * mu

    # natural coordinates of the 8 corners, x fastest
    corners = np.array(
        [[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
        dtype=np.float64,
    )
    g = 1.0 / np.sqrt(3.0)
    Ke = np.zeros((24, 24))
    for gz in (-g, g):
        for gy in (-g, g):
            for gx in (-g, g):
                xi = np.array([gx, gy, gz])
                a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
                dN = np.empty((8, 3))
                dN[:, 0] = a * (1 + b * xi[1]) * (1 + c * xi[2]) / 8
                dN[:, 1] = (1 + a * xi[0]) * b * (1 + c * xi[2]) / 8
                dN[:, 2] = (1 + a * xi[0]) * (1 + b * xi[1]) * c / 8
                dNx = dN * (2.0 / h)  # uniform cube: J = (h/2) I
                B = np.zeros((6, 24))
                B[0, 0::3] = dNx[:, 0]
                B[1, 1::3] = dNx[:, 1]
                B[2, 2::3] = dNx[:, 2]
                B[3, 0::3] = dNx[:, 1]
                B[3, 1::3] = dNx[:, 0]
                B[4, 1::3] = dNx[:, 2]
                B[4, 2::3] = dNx[:, 1]
                B[5, 0::3] = dNx[:, 2]
                B[5, 2::3] = dNx[:, 0]
                Ke += B.T @ D @ B * (h / 2) ** 3
    return Ke


def fem_elasticity_3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    h: float = 1.0,
    E: float = 1.0,
    nu: float = 0.3,
    clamp: bool = True,
    dtype=np.float64,
) -> sp.csr_matrix:
    """Assemble the global stiffness of an nx x ny x nz hex mesh.

    Returns CSR with 3 dof per node (n = 3 * prod(n_i + 1) before
    clamping).  With ``clamp`` the z=0 face is fixed (Dirichlet), which
    removes the 6 rigid-body modes and makes the matrix SPD — matching
    the constrained SuiteSparse structural matrices.  Without it the
    matrix is PSD with a 6-dimensional null space (free-free body).

    Sizes for calibration against the reference's benchmark set
    (`Julia/benchmark.jl:21-28`): nx=ny=nz=42 -> n=238k / 18.9 Mnnz
    (hood-class, hood is 220k/9.8M); 64^3 -> n=0.82M / 66 Mnnz
    (ldoor-class, ldoor is 952k/42.5M).
    """
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    Ke = hex8_stiffness(h, E, nu).astype(dtype)
    nnx, nny = nx + 1, ny + 1
    n_nodes = nnx * nny * (nz + 1)

    ii, jj, kk = np.meshgrid(
        np.arange(nx, dtype=np.int64),
        np.arange(ny, dtype=np.int64),
        np.arange(nz, dtype=np.int64),
        indexing="ij",
    )
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()

    def nid(i, j, k):
        return (k * nny + j) * nnx + i

    offs = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    conn = np.stack([nid(ii + a, jj + b, kk + c) for a, b, c in offs], axis=1)
    dof = (conn[:, :, None] * 3 + np.arange(3)).reshape(-1, 24).astype(np.int32)

    ne = dof.shape[0]
    rows = np.repeat(dof, 24, axis=1).ravel()
    cols = np.tile(dof, (1, 24)).ravel()
    data = np.tile(Ke.ravel(), ne)
    n = n_nodes * 3
    A = sp.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()

    if clamp:
        face = (np.arange(nny)[:, None] * nnx + np.arange(nnx)).ravel()  # k=0
        keep = np.ones(n, dtype=bool)
        keep[(face[:, None] * 3 + np.arange(3)).ravel()] = False
        A = A[keep][:, keep].tocsr()
    A.sum_duplicates()
    return A
