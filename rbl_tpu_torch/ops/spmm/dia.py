"""DIA (diagonal-storage) sparse operator for banded and multi-banded
matrices.

Port of ``rbl_tpu/ops/spmm/dia.py``.  SpMM in diagonal form needs no
indices: one multiply-add of a statically shifted slice of X per populated
diagonal.  The JAX package left it to XLA, so its port is a torch
expression, one fused multiply-add kernel per diagonal on the card.

``Y[r] = Σ_d data[d, r] · X[r + off_d]`` with the row-aligned ``data``
below (scipy's DIA storage is column-aligned and is re-aligned once on the
host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import resolve_device
from .operator import LinearOperator, _pet, host_dtype, to_device


@dataclasses.dataclass
class DiaOperator(LinearOperator):
    """Symmetric sparse operator in DIA layout.

    data: (k, n) *row-aligned* — data[d, r] = A[r, r + offsets[d]] (zero
    where r + off is out of range), so ``apply`` is a multiply-add over
    static slices of a zero-padded X.
    """

    data: torch.Tensor
    offsets: tuple = ()
    _n: int = 0

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.data))

    @property
    def _halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def apply(self, X):
        n = self._n
        m = self._halo
        Xp = torch.nn.functional.pad(X, (0, 0, m, m))
        # accumulate in _pet(X.dtype): sub-f32 inputs sum k_diags products
        # per row — the same upcast as the COO/ELL paths
        Y = torch.zeros(X.shape, dtype=_pet(X.dtype), device=X.device)
        for d, off in enumerate(self.offsets):
            # row r reads column r + off  →  Xp[m + off + r]
            Y.addcmul_(self.data[d][:, None], Xp[m + off : m + off + n])
        return Y.to(X.dtype)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros((self._n,), dtype=self.dtype, device=self.device)

    @classmethod
    def from_scipy(cls, A, dtype=None, max_diags: int = 256, device=None):
        """Build from scipy sparse on ``device`` (default: the CUDA card);
        raises if A has more than ``max_diags`` populated diagonals (then
        use BSR/ELL instead)."""
        import scipy.sparse as sp

        dev = resolve_device(device)
        D = sp.dia_matrix(A)
        if len(D.offsets) > max_diags:
            raise ValueError(
                f"{len(D.offsets)} diagonals > max_diags={max_diags}; "
                "DIA is the wrong format for this matrix"
            )
        n = A.shape[0]
        # re-align scipy's column-aligned storage (data[d, c] = A[c-off, c])
        # to row-aligned (data[d, r] = A[r, r+off])
        data = np.zeros((len(D.offsets), n), dtype=host_dtype(dtype, D.data.dtype))
        for d, off in enumerate(D.offsets):
            off = int(off)
            src = D.data[d]
            if off >= 0:
                # rows r = c - off, c in [off, min(len, n))
                hi = min(src.shape[0], n)
                if hi > off:
                    data[d, : hi - off] = src[off:hi]
            else:
                hi = min(src.shape[0], n + off)
                if hi > 0:
                    data[d, -off : -off + hi] = src[:hi]
        return cls(
            data=to_device(data, dtype, dev),
            offsets=tuple(int(o) for o in D.offsets),
            _n=n,
        )


def count_diagonals(A) -> int:
    """Number of populated diagonals of a scipy sparse matrix (cheap probe
    for format selection)."""
    coo = A.tocoo()
    return len(np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64)))
