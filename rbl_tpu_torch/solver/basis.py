"""Krylov-basis store.

The reference archives every Lanczos block in a VRAM-budgeted resident
device buffer (gpu_buffer_size, RBL_gpu.jl:95-104) plus pinned host copies
for overflow (RBL_gpu.jl:168-169).

Here the device tier is one zero-padded (n, capacity) buffer, preallocated
at the solve's clamped Krylov cap (eager PyTorch has no recompiles to bound,
so there is no geometric growth).  Blocks are written in place and the
reorthogonalization contracts over the stored prefix ``buf[:, :ncols]``.
Columns past ``ncols`` stay zero: a rewind zeros what it discards.  The
pinned-host overflow tier is not ported yet.
"""

from __future__ import annotations

import torch


class BasisStore:
    """Preallocated, zero-padded (n, max_cols) basis buffer."""

    def __init__(self, n, block_size, max_cols, dtype, device,
                 device_cap_cols=None):
        if device_cap_cols is not None:
            raise NotImplementedError(
                "basis_device_cap_cols (the pinned-host basis tier) is not "
                "ported yet (ROADMAP.md section A)"
            )
        self.n = n
        self.b = block_size
        self.max_cols = max_cols
        self.ncols = 0
        self.buf = torch.zeros((n, max_cols), dtype=dtype,
                               device=torch.device(device))

    @property
    def capacity(self):
        return self.buf.shape[1]

    def append(self, block) -> None:
        self.buf[:, self.ncols : self.ncols + self.b].copy_(block)
        self.ncols += self.b

    def view(self):
        """The stored prefix (n, ncols) — a view, not a copy."""
        return self.buf[:, : self.ncols]

    def read_block(self, col: int, width: int):
        """A copy of columns [col, col + width): a later rewind zeros the
        buffer in place, so callers that keep a block get their own."""
        if col + width > self.ncols:
            raise IndexError(f"columns {col}..{col + width} beyond stored {self.ncols}")
        return self.buf[:, col : col + width].clone()

    def rewind(self, ncols_new: int) -> None:
        """Discard (and zero) every column ≥ ncols_new (speculation /
        breakdown / stale convergence-poll rewind)."""
        if self.ncols <= ncols_new:
            return
        self.buf[:, ncols_new : self.ncols].zero_()
        self.ncols = ncols_new
