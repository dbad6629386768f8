"""ELLPACK sparse operator — the portable SpMM for matrices with no block
or band structure.

Port of ``rbl_tpu/ops/spmm/ell.py``: every row padded to the same slot
count L, giving two dense (L, n) arrays (column indices, values).  The JAX
package applied it as a ``lax.scan`` of L gathered AXPYs, left to XLA; here
it is a torch expression over chunks of slots, so that the (L, n, b)
gather never exists at once (81 slots × 232,974 rows × b = 8 × 4 B =
604 MB on fem42).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import resolve_device
from .operator import LinearOperator, _pet, host_dtype, to_device

# Bytes of gathered X rows one slot chunk may hold.
_GATHER_BYTES = 64 * 2**20


def ell_arrays(A, dtype=None):
    """The host (L, n) int32 column ids and values of a scipy matrix's
    ELLPACK layout (padding slots point at their own row, value 0), the
    values in ``dtype``'s host dtype (None: the matrix's own)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    row_nnz = np.diff(A.indptr)
    L = max(int(row_nnz.max()), 1) if n else 1
    cols = np.tile(np.arange(n, dtype=np.int32), (L, 1))  # self-pad
    vals = np.zeros((L, n), dtype=host_dtype(dtype, A.dtype))
    # scatter nonzeros into slot l = position within row, vectorized
    rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    slot = np.arange(A.nnz, dtype=np.int64) - A.indptr[rows]
    cols[slot, rows] = A.indices.astype(np.int32)
    vals[slot, rows] = A.data
    return cols, vals


def ell_apply(cols, vals, X, nrows):
    """Σ over the L slots of vals·X[cols] into ``nrows`` output rows,
    accumulated in ``_pet(X.dtype)``, a chunk of slots at a time.  cols
    and vals are (L, nrows); X may hold more rows than the output (a
    rank's rows followed by its ghost rows)."""
    # accumulate in _pet(X.dtype): a bf16 sum over L~100 slots loses
    # ~L·2⁻⁸ relative per row — the same upcast as the COO/DIA paths
    acc_dt = _pet(X.dtype)
    b = X.shape[1]
    out = torch.zeros((nrows, b), dtype=acc_dt, device=X.device)
    L = cols.shape[0]
    step = max(1, _GATHER_BYTES // max(nrows * b * X.element_size(), 1))
    for l0 in range(0, L, step):
        c = cols[l0 : l0 + step]
        G = X.index_select(0, c.reshape(-1)).reshape(*c.shape, b)
        out += (vals[l0 : l0 + step, :, None] * G).to(acc_dt).sum(0)
    return out.to(X.dtype)


@dataclasses.dataclass
class SparseEllOperator(LinearOperator):
    """Symmetric sparse operator in ELLPACK (padded-row) layout.

    cols: (L, n) int32 — column index of the l-th nonzero of each row;
          padding slots point at the row itself.
    vals: (L, n)       — matching values; padding slots are 0.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    _n: int = 0

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self):
        # counts stored (padded) slots with nonzero value
        return int(torch.count_nonzero(self.vals))

    def apply(self, X):
        return ell_apply(self.cols, self.vals, X, X.shape[0])

    def diagonal(self):
        # padding slots self-point with value 0, so they contribute nothing
        r = torch.arange(self._n, dtype=self.cols.dtype, device=self.device)
        return torch.where(self.cols == r[None, :], self.vals, 0.0).sum(0)

    @classmethod
    def from_scipy(cls, A, dtype=None, device=None):
        """Build from a scipy.sparse matrix (CSR'd internally) on
        ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        cols, vals = ell_arrays(A, dtype)
        return cls(cols=torch.from_numpy(cols).to(dev),
                   vals=to_device(vals, dtype, dev), _n=A.shape[0])

    @classmethod
    def from_dense(cls, M, dtype=None, device=None):
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(M)), dtype=dtype,
                              device=device)
