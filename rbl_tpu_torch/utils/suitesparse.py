"""SuiteSparse matrix loading (port of ``rbl_tpu/utils/suitesparse.py``).

The reference's benchmark harness loads ldoor via MAT and hood/audi via
MatrixMarket (benchmark.jl:21-28).  Equivalent here: MatrixMarket, plain
or compressed, via scipy.io.mmread, MATLAB .mat via scipy.io.loadmat
(SuiteSparse .mat files store the matrix under Problem.A), all returned as
symmetric CSR on the host; ``as_operator`` or any entry point moves it to
the device.  The port's C++ reader (``rbl_tpu_torch.native.
read_matrix_market``) is not on this path: scipy's reader, C++ and
multithreaded since scipy 1.12, reads fem_elasticity_3d(42)'s 18.0 M
nonzeros 2-2.6× faster (``tools/bench_mtx.py``).
"""

from __future__ import annotations

import scipy.io
import scipy.sparse as sp


def load_matrix(path: str) -> sp.csr_matrix:
    """Load a sparse symmetric matrix from .mtx/.mtx.gz or .mat."""
    if path.endswith((".mtx", ".mtx.gz")):
        A = scipy.io.mmread(path)
    elif path.endswith(".mat"):
        m = scipy.io.loadmat(path)
        if "Problem" in m:  # SuiteSparse collection layout
            A = m["Problem"]["A"][0, 0]
        else:
            A = next(v for v in m.values() if sp.issparse(v))
    else:
        raise ValueError(f"unsupported matrix format: {path}")
    A = sp.csr_matrix(A)
    if (abs(A - A.T)).max() > 0:
        A = (A + A.T) * 0.5
    return A


def laplacian_2d(nx: int, ny: int) -> sp.csr_matrix:
    """Explicit sparse 5-point Laplacian (for cross-checks against the
    matrix-free operator ``Laplacian2D``)."""
    Ix = sp.eye(nx)
    Iy = sp.eye(ny)
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Dy = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    return sp.csr_matrix(sp.kron(Dx, Iy) + sp.kron(Ix, Dy))
