"""COO scatter-add and HYB (capped-ELL / COO overflow) sparse operators.

Port of ``rbl_tpu/ops/spmm/coo.py``.  ELL pads every row to the longest
one; under row-length skew (power-law graphs, a few dense rows) that
multiplies memory and work by the skew factor.  Two layouts fix it:

- ``CooOperator``: nonzeros as flat (rows, cols, vals) triplets sorted by
  row; SpMM gathers X rows and scatter-adds them into the output
  (``index_add_``, the JAX package's sorted ``segment_sum``), in chunks
  that bound the (nnz, b) gather.
- ``HybOperator``: ELL capped at a row-length quantile + COO for the
  overflow entries of the few long rows.

Both were XLA on the TPU, so their port is a torch expression.
``as_operator(..., format="auto")`` routes skewed matrices to HYB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import resolve_device
from .operator import LinearOperator, _pet, host_dtype, to_device

# Pad the triplet arrays to a multiple of this (the JAX package's choice,
# kept so that the two packages hold the same arrays).
_NNZ_ALIGN = 1024


def _coo_apply(rows, cols, vals, X, nrows_out, chunk):
    """Shared COO SpMM body: gather X rows, scatter-add into ``nrows_out``
    output rows, accumulated in ``_pet(X.dtype)``, ``chunk`` triplets at a
    time."""
    acc = _pet(X.dtype)
    out = torch.zeros((nrows_out, X.shape[1]), dtype=acc, device=X.device)
    for s in range(0, rows.shape[0], chunk):
        c = cols[s : s + chunk]
        contrib = (vals[s : s + chunk, None] * X.index_select(0, c)).to(acc)
        out.index_add_(0, rows[s : s + chunk], contrib)
    return out.to(X.dtype)


def _pad_sorted_triplets(rows, cols, vals, last_row):
    """Row-sort triplets and pad to ``_NNZ_ALIGN``.  Pad slots target
    ``last_row`` with val 0 (zero contribution), which keeps the row array
    ascending."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    pad = (-len(rows)) % _NNZ_ALIGN
    if pad or len(rows) == 0:
        pad = pad or _NNZ_ALIGN
        rows = np.concatenate([rows, np.full(pad, last_row, rows.dtype)])
        cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
        vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    return rows.astype(np.int32), cols.astype(np.int32), vals


@dataclasses.dataclass
class CooOperator(LinearOperator):
    """Symmetric sparse operator as row-sorted COO triplets.

    rows/cols: (nnz_pad,) int32, sorted by row; padding slots target the
    LAST row (col 0, val 0 — zero contribution).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    _n: int = 0
    # Max gathered rows per chunk: bounds the (chunk, b) scratch for very
    # large nnz; one chunk when nnz fits.
    _chunk: int = 1 << 22

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
        return int(torch.count_nonzero(self.vals))

    def apply(self, X):
        return _coo_apply(self.rows, self.cols, self.vals, X, self._n,
                          self._chunk)

    def diagonal(self):
        # padding slots carry value 0 (last row, col 0) — no contribution
        out = torch.zeros((self._n,), dtype=self.dtype, device=self.device)
        return out.index_add_(
            0, self.rows, torch.where(self.rows == self.cols, self.vals, 0.0)
        )

    @classmethod
    def from_scipy(cls, A, dtype=None, device=None):
        """Build from scipy sparse on ``device`` (default: the CUDA card)."""
        import scipy.sparse as sp

        A = sp.coo_matrix(A)
        vals = A.data.astype(host_dtype(dtype, A.dtype))
        return cls._from_triplets(A.row, A.col, vals, A.shape[0], dtype,
                                  device)

    @classmethod
    def _from_triplets(cls, rows, cols, vals, n, dtype=None, device=None):
        dev = resolve_device(device)
        rows, cols, vals = _pad_sorted_triplets(rows, cols, vals, n - 1)
        return cls(
            rows=torch.from_numpy(rows).to(dev),
            cols=torch.from_numpy(cols).to(dev),
            vals=to_device(vals, dtype, dev),
            _n=n,
        )

    @classmethod
    def from_dense(cls, M, dtype=None, device=None):
        import scipy.sparse as sp

        return cls.from_scipy(sp.coo_matrix(np.asarray(M)), dtype=dtype,
                              device=device)


@dataclasses.dataclass
class RectCooOperator:
    """RECTANGULAR (m, n) sparse factor as row-sorted COO triplets — the
    sparse analogue of the dense factor B that ``rbl_svd`` (solver/svd.py)
    takes: not a symmetric LinearOperator, but the building block of the
    matrix-free Gram operator BᵀB / B·Bᵀ (operator.py SparseGramOperator).
    apply(X): (n, b) → (m, b) via the same gather + scatter-add as
    CooOperator; ``transpose()`` returns the (n, m) factor with triplets
    re-sorted by the new row index."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    _m: int = 0
    _ncols: int = 0
    _chunk: int = 1 << 22

    @property
    def shape(self):
        return (self._m, self._ncols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.vals))

    def apply(self, X):
        return _coo_apply(self.rows, self.cols, self.vals, X, self._m,
                          self._chunk)

    @classmethod
    def from_scipy(cls, A, dtype=None, device=None):
        """Build from scipy sparse on ``device`` (default: the CUDA card)."""
        import scipy.sparse as sp

        A = sp.coo_matrix(A)
        vals = A.data.astype(host_dtype(dtype, A.dtype))
        return cls._from_triplets(A.row, A.col, vals, A.shape[0], A.shape[1],
                                  dtype, device)

    @classmethod
    def _from_triplets(cls, rows, cols, vals, m, ncols, dtype=None,
                       device=None):
        dev = resolve_device(device)
        rows, cols, vals = _pad_sorted_triplets(rows, cols, vals, m - 1)
        return cls(
            rows=torch.from_numpy(rows).to(dev),
            cols=torch.from_numpy(cols).to(dev),
            vals=to_device(vals, dtype, dev),
            _m=m,
            _ncols=ncols,
        )

    def transpose(self) -> "RectCooOperator":
        """The (n, m) transposed factor on the same device — triplets
        swapped and re-sorted host-side (a one-time cost at operator
        construction)."""
        rows = self.cols.cpu().numpy()
        cols = self.rows.cpu().numpy()
        vals = self.vals
        if vals.dtype.itemsize < 4:
            vals = vals.float()
        vals = vals.cpu().numpy()
        live = vals != 0  # drop this layout's padding; _from_triplets re-pads
        return RectCooOperator._from_triplets(
            rows[live], cols[live], vals[live], self._ncols, self._m,
            self.dtype, self.device,
        )

    @property
    def T(self) -> "RectCooOperator":
        return self.transpose()


@dataclasses.dataclass
class HybOperator(LinearOperator):
    """ELL capped at a row-length quantile + COO overflow (HYB layout)."""

    ell: LinearOperator  # SparseEllOperator over the capped rows
    coo: CooOperator     # overflow entries of the long rows

    @property
    def shape(self):
        return self.ell.shape

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def device(self):
        return self.ell.device

    @property
    def nnz(self):
        return self.ell.nnz + self.coo.nnz

    def apply(self, X):
        return self.ell.apply(X) + self.coo.apply(X)

    def diagonal(self):
        return self.ell.diagonal() + self.coo.diagonal()

    @classmethod
    def from_scipy(cls, A, dtype=None, quantile: float = 0.95, device=None):
        """Cap ELL at the ``quantile`` row-length; spill the rest to COO.

        The cap keeps the ELL slot count at the TYPICAL row length; the
        few rows longer than that contribute only their tail entries to
        the O(nnz_tail) COO pass."""
        import scipy.sparse as sp

        from .ell import SparseEllOperator

        A = sp.csr_matrix(A)
        n = A.shape[0]
        row_nnz = np.diff(A.indptr)
        L = max(int(np.quantile(row_nnz, quantile)), 1)
        rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
        # slot l = position within row, vectorized
        slot = np.arange(A.nnz, dtype=np.int64) - A.indptr[rows]
        keep = slot < L
        ell_part = sp.csr_matrix(
            (A.data[keep], (rows[keep], A.indices[keep])), shape=A.shape
        )
        spill = ~keep
        ell = SparseEllOperator.from_scipy(ell_part, dtype=dtype, device=device)
        coo = CooOperator._from_triplets(
            rows[spill].astype(np.int32),
            A.indices[spill].astype(np.int32),
            A.data[spill].astype(host_dtype(dtype, A.dtype)),
            n, dtype, device,
        )
        return cls(ell=ell, coo=coo)
