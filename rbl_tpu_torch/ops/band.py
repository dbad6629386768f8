"""Block-tridiagonal T assembly.

The reference packs T into LAPACK lower-band storage, growing a
(b+1) × (j·b) array by ``hcat`` every iteration (common.jl:9-26,
RBL.jl:105).  T is tiny (≤ max_kryl_dim ≈ 1400 columns), lives on the host
next to the banded eigensolver, and is replicated under any sharding — so
here it is a preallocated numpy band buffer with O(b²) writes per iteration
and no reallocation.

Band layout (LAPACK 'L', same as scipy.linalg.eig_banded(lower=True)):
``band[r, c] = T[c + r, c]`` for r = 0..b.
"""

from __future__ import annotations

import numpy as np


class BlockTridiagonalT:
    """Accumulates the projected block-tridiagonal matrix T in banded form."""

    def __init__(self, block_size: int, max_cols: int, dtype=np.float64):
        self.b = block_size
        self.band = np.zeros((block_size + 1, max_cols), dtype=dtype)
        self.ncols = 0  # columns with a diagonal block written

    def append_diag(self, Ai) -> None:
        """Write diagonal block A_i (lower triangle) into a new band panel
        (reference insertA!, common.jl:9-17)."""
        b = self.b
        Ai = np.asarray(Ai)
        c0 = self.ncols
        for j in range(b):
            self.band[0 : b - j, c0 + j] = Ai[j:b, j]
        self.ncols = c0 + b

    def set_subdiag(self, Bi, block_index: int) -> None:
        """Write sub-diagonal block B_i (upper triangle of the QR factor R)
        into the band columns of panel ``block_index`` (0-based)
        (reference insertB!, common.jl:20-26)."""
        b = self.b
        Bi = np.asarray(Bi)
        c0 = block_index * b
        for j in range(b):
            self.band[b - j : b + 1, c0 + j] = Bi[0 : j + 1, j]

    def view(self, ncols: int | None = None) -> np.ndarray:
        """Banded view of the first ``ncols`` columns of T."""
        if ncols is None:
            ncols = self.ncols
        return self.band[:, :ncols]

    def dense(self, ncols: int | None = None) -> np.ndarray:
        """Expand to a dense symmetric matrix (for the on-device eigh path
        and for tests)."""
        band = self.view(ncols)
        m = band.shape[1]
        T = np.zeros((m, m), dtype=band.dtype)
        for r in range(self.b + 1):
            for c in range(m):
                if c + r < m:
                    T[c + r, c] = band[r, c]
                    T[c, c + r] = band[r, c]
        return T


def band_to_dense(band: np.ndarray) -> np.ndarray:
    """Expand LAPACK lower-band storage to a dense symmetric matrix."""
    bw1, m = band.shape
    T = np.zeros((m, m), dtype=band.dtype)
    for r in range(bw1):
        d = np.asarray(band[r, : m - r if r else m])
        idx = np.arange(m - r)
        T[idx + r, idx] = d[: m - r]
        T[idx, idx + r] = d[: m - r]
    return T
