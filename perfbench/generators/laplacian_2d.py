"""The 2-D 5-point Dirichlet Laplacian on an nx × ny grid.

The matrix of scipy's ``LaplacianNd((nx, ny), boundary_conditions=
"dirichlet")``, negated: 4 on the diagonal, −1 to each grid neighbour,
row i·ny + j for grid point (i, j).  Matrix-free by default: the program's
operator named by the configuration's ``"operator"`` takes (nx, ny).  With
``"assembled": true`` the program is handed the same matrix as a scipy
CSR instead.  Its spectrum is known in closed form:
4 − 2cos(iπ/(nx+1)) − 2cos(jπ/(ny+1)), i ≤ nx, j ≤ ny.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from perfbench.harness.problem import Problem

NORM = 8.0   # the largest absolute row sum: an interior row


def _second_difference(m: int) -> sp.dia_matrix:
    ones = np.ones(m)
    return sp.diags([-ones[1:], 2.0 * ones, -ones[1:]], [-1, 0, 1])


def build(config: dict) -> Problem:
    nx, ny = int(config["nx"]), int(config["ny"])
    if config.get("assembled"):
        A = (sp.kron(_second_difference(nx), sp.identity(ny))
             + sp.kron(sp.identity(nx), _second_difference(ny))).tocsr()
        return Problem(n=nx * ny, nonzeros=int(A.nnz), norm=NORM, A=A,
                       grid=(nx, ny))
    nonzeros = nx * ny + 2 * ((nx - 1) * ny + nx * (ny - 1))
    return Problem(n=nx * ny, nonzeros=nonzeros, norm=NORM, grid=(nx, ny),
                   operator=config["operator"])


def apply64(problem: Problem, X: torch.Tensor) -> torch.Tensor:
    """A·X in float64, the stencil written out."""
    nx, ny = problem.grid
    b = X.shape[1]
    G = X.reshape(nx, ny, b)
    Y = 4.0 * G
    Y[1:] -= G[:-1]
    Y[:-1] -= G[1:]
    Y[:, 1:] -= G[:, :-1]
    Y[:, :-1] -= G[:, 1:]
    return Y.reshape(nx * ny, b)


def spectrum(problem: Problem) -> np.ndarray:
    nx, ny = problem.grid
    a = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    c = 2.0 - 2.0 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
    return (a[:, None] + c[None, :]).ravel()
