"""Packed block-sparse (CSR-of-tiles) SpMM operator.

Port of ``rbl_tpu/ops/spmm/pallas_bsr.py``: the host-side conversion and
tile-plan search are the same numpy code; the SpMM itself is the
hand-written CUDA kernel ``csrc/bsr_spmm.cu`` on a CUDA tensor, and the
plain PyTorch version ``bsr_spmm_packed_reference`` on a CPU tensor.

Layout: A is cut into (bm, bk) tiles and only nonzero tiles are stored.
Block-row i owns the tiles [rptr[i]·U, (rptr[i] + hcount[i])·U) of
``vals`` (T, bm, bk), padded with zero tiles (column 0) to a multiple of
the unroll U; ``tile_cols`` (T,) holds each tile's column-block id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .operator import LinearOperator

# The JAX package kept X resident in the TPU's on-chip VMEM up to this
# size and streamed it tile by tile above it.  The rule is kept for
# parity, so that both entry points stay on the solver's path and under
# test; on the card both launch the same kernel.
_RESIDENT_X_BYTES = 8 * 2**20

# Modelled cost of one step of the tile plan, in the bytes of tile traffic
# it is worth; ranks (tile height, unroll) plans in ``pick_tile_plan``.  A
# placeholder carried over from the JAX package's tuner so both packages
# rank plans alike: it awaits an H100 measurement.
_STEP_COST_BYTES = 280_000

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _tile_census(A, bm: int, bk: int):
    """Host-side (block-row id, col id) pairs of nonzero tiles + per-row
    counts — the cheap statistic both the packed converter and the tile-
    height auto-tuner need."""
    import scipy.sparse as sp

    C = A if isinstance(A, sp.coo_matrix) else sp.coo_matrix(A)
    n = C.shape[0]
    nb = -(-n // bm)
    ncb = -(-n // bk)
    key = (C.row // bm).astype(np.int64) * ncb + (C.col // bk)
    ukey = np.unique(key)
    ubr = (ukey // ncb).astype(np.int64)
    ubc = (ukey % ncb).astype(np.int32)
    counts = np.bincount(ubr, minlength=nb)
    return key, ukey, ubr, ubc, counts, nb, ncb


def pick_tile_plan(A, bk: int = 128,
                   heights=(128, 64, 32, 16),
                   unrolls=(4, 8, 16, 32)) -> tuple[int, int]:
    """Jointly choose (tile height, unroll) minimizing modeled apply time:
    stored tile bytes plus ``_STEP_COST_BYTES`` per step of an nb × (most
    chunks in a row) schedule.  Finer tiles store fewer zeros; a larger
    unroll divides the step count but pads every row's tile list to a
    multiple of U."""
    best, best_cost = None, float("inf")
    for bm in heights:
        _, ukey, _, _, counts, nb, _ = _tile_census(A, bm, bk)
        for U in unrolls:
            # U ≥ 32 only with bm = 16, as in the JAX package's tuner
            if U >= 32 and bm > 16:
                continue
            chunks = np.maximum(-(-counts // U), 1)
            tiles_padded = int(chunks.sum()) * U
            bytes_tiles = tiles_padded * bm * bk * 4
            steps = nb * int(chunks.max())
            cost = bytes_tiles + steps * _STEP_COST_BYTES
            if cost < best_cost:
                best, best_cost = (bm, U), cost
    return best


def pick_tile_height(A, bk: int = 128, unroll: int = 4,
                     candidates=(128, 64, 32, 16)) -> int:
    """Tile height of the jointly-tuned plan (see pick_tile_plan)."""
    return pick_tile_plan(A, bk=bk, heights=candidates)[0]


def _packed_bsr_from_scipy(A, bm: int, bk: int, unroll: int, dtype):
    """Host-side conversion scipy sparse → packed (CSR-of-tiles) arrays.

    Each block-row's tile list is zero-padded to a multiple of ``unroll``
    (padding tiles point at column-block 0 with zero values — the
    identity-contribution trick)."""
    import scipy.sparse as sp

    C = sp.coo_matrix(A)
    C.sum_duplicates()
    key, ukey, ubr, ubc, counts, nb, ncb = _tile_census(C, bm, bk)
    chunks = np.maximum(-(-counts // unroll), 1)  # ≥1 so hcount ≥ 1
    rptr = np.zeros(nb, dtype=np.int32)
    rptr[1:] = np.cumsum(chunks)[:-1]
    T = int(chunks.sum()) * unroll

    # slot of each unique tile within its row, then its packed position
    row_start = np.searchsorted(ubr, np.arange(nb))
    slot = np.arange(len(ukey)) - row_start[ubr]
    pos = rptr[ubr] * unroll + slot  # packed tile index

    tile_cols = np.zeros(T, dtype=np.int32)
    tile_cols[pos] = ubc
    vals = np.zeros((T, bm, bk), dtype=np.dtype(dtype))
    inv = np.searchsorted(ukey, key)  # nnz → unique-tile rank
    vals[pos[inv], C.row % bm, C.col % bk] = C.data.astype(np.dtype(dtype))
    hcount = chunks.astype(np.int32)
    return tile_cols, hcount, rptr, vals, nb, ncb, int(chunks.max())


def bsr_spmm_packed_reference(tile_cols, hcount, rptr, vals, X, *, bm: int,
                              bk: int, unroll: int, out_dtype=None):
    """Plain PyTorch Y = A @ X for packed A: gather each tile's X rows,
    one batched product per tile, and a scatter-add into the block-rows.
    X must already be padded to (ncb*bk, b) rows.  Returns (nb*bm, b)."""
    nb = rptr.shape[0]
    b = X.shape[1]
    dev = vals.device
    hc = hcount.long()
    row = torch.repeat_interleave(torch.arange(nb, device=dev), hc)
    first = torch.cumsum(hc, 0) - hc  # each row's offset in the chunk list
    chunk = rptr.long()[row] + torch.arange(row.shape[0], device=dev) - first[row]
    tiles = (chunk[:, None] * unroll
             + torch.arange(unroll, device=dev)).reshape(-1)
    Xg = X.reshape(-1, bk, b)[tile_cols.long()[tiles]]  # (tiles, bk, b)
    P = torch.einsum("tmk,tkb->tmb", vals[tiles], Xg)
    Y = torch.zeros((nb, bm, b), dtype=vals.dtype, device=dev)
    Y.index_add_(0, row.repeat_interleave(unroll), P)
    Y = Y.reshape(nb * bm, b)
    return Y if out_dtype is None else Y.to(out_dtype)


def _check_operands(tile_cols, hcount, rptr, vals, X, bm, bk, unroll):
    dev = vals.device
    for name, t in (("tile_cols", tile_cols), ("hcount", hcount),
                    ("rptr", rptr), ("vals", vals), ("X", X)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("tile_cols", tile_cols), ("hcount", hcount),
                    ("rptr", rptr)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if vals.dtype not in _NP_DTYPE:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if X.dtype != vals.dtype:
        raise TypeError(f"X is {X.dtype}, vals {vals.dtype}")
    T = vals.shape[0]
    if vals.ndim != 3 or tuple(vals.shape[1:]) != (bm, bk) or T % unroll:
        raise ValueError(
            f"vals {tuple(vals.shape)} is not (T, bm={bm}, bk={bk}) "
            f"with T a multiple of unroll={unroll}"
        )
    if tile_cols.shape[0] != T or hcount.shape != rptr.shape:
        raise ValueError("tile_cols must be (T,), hcount and rptr (nb,)")
    if X.ndim != 2 or X.shape[0] % bk:
        raise ValueError(f"X {tuple(X.shape)} is not padded to ncb*bk rows")


def _spmm(tile_cols, hcount, rptr, vals, X, bm, bk, unroll, out_dtype):
    """The CPU reference for a CPU tensor, the CUDA kernel otherwise.
    Returns (Y, launched)."""
    _check_operands(tile_cols, hcount, rptr, vals, X, bm, bk, unroll)
    if vals.device.type == "cpu":
        Y = bsr_spmm_packed_reference(
            tile_cols, hcount, rptr, vals, X, bm=bm, bk=bk, unroll=unroll,
            out_dtype=out_dtype,
        )
        return Y, False
    if vals.device.type != "cuda":
        raise ValueError(f"no bsr_spmm_packed kernel for {vals.device}")
    if bm > 128 or bk % 32:
        raise ValueError(f"the CUDA kernel takes bm ≤ 128 and bk % 32 == 0, "
                         f"got bm={bm}, bk={bk}")
    if vals.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads vals in 16-byte vectors: "
                         "its storage must be 16-byte aligned")
    from ._kernels import launch_bsr_spmm_packed

    Y = launch_bsr_spmm_packed(tile_cols, hcount, rptr, vals, X, bm=bm,
                               bk=bk, unroll=unroll)
    return (Y if out_dtype is None else Y.to(out_dtype)), True


def bsr_spmm_packed_resident(tile_cols, hcount, rptr, vals, X, *, bm: int,
                             bk: int, H: int, unroll: int = 1,
                             out_dtype=None):
    """Y = A @ X for packed A — the entry point the JAX package used when
    X fit the TPU's VMEM.  X must already be padded to (ncb*bk, b) rows.
    ``H`` (the longest row's chunk count) sized the TPU grid; the CUDA
    kernel loops over each row's own chunks and does not need it."""
    Y, launched = _spmm(tile_cols, hcount, rptr, vals, X, bm, bk, unroll,
                        out_dtype)
    if launched:
        bsr_spmm_packed_resident.launches += 1
    return Y


def bsr_spmm_packed(tile_cols, hcount, rptr, vals, X, *, bm: int, bk: int,
                    H: int, unroll: int = 1, out_dtype=None):
    """Y = A @ X for packed A — the entry point the JAX package used when
    X was larger than the TPU's VMEM.  Same kernel and arguments as
    ``bsr_spmm_packed_resident``."""
    Y, launched = _spmm(tile_cols, hcount, rptr, vals, X, bm, bk, unroll,
                        out_dtype)
    if launched:
        bsr_spmm_packed.launches += 1
    return Y


# CUDA kernel launches per entry point: a run can show it went through them
bsr_spmm_packed_resident.launches = 0
bsr_spmm_packed.launches = 0


@dataclasses.dataclass
class BlockSparseOperator(LinearOperator):
    """Symmetric sparse operator in packed (CSR-of-tiles) block layout,
    applied with the CUDA packed-BSR kernel on the card and with its
    plain PyTorch version on the CPU.  Values are f32 or f64."""

    tile_cols: torch.Tensor  # (T,) int32 column-block id per packed tile
    hcount: torch.Tensor     # (nb,) int32 chunk count per block-row
    rptr: torch.Tensor       # (nb,) int32 first chunk of each block-row
    vals: torch.Tensor       # (T, bm, bk) packed tiles
    diag: torch.Tensor | None = None  # (n,)
    _n: int = 0
    H: int = 1
    bm: int = 128
    bk: int = 128
    unroll: int = 1

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
    def nnz_blocks(self):
        return int(self.tile_cols.shape[0])

    def apply(self, X):
        # X is indexed by column blocks: pad its rows to ncb*bk
        ncb = -(-self._n // self.bk)
        pad = ncb * self.bk - self._n
        Xp = X.to(self.dtype)
        if pad:
            Xp = torch.nn.functional.pad(Xp, (0, 0, 0, pad))
        Xp = Xp.contiguous()
        xbytes = ncb * self.bk * X.shape[1] * self.dtype.itemsize
        fn = (bsr_spmm_packed_resident
              if xbytes <= _RESIDENT_X_BYTES else bsr_spmm_packed)
        Y = fn(
            self.tile_cols, self.hcount, self.rptr, self.vals, Xp,
            bm=self.bm, bk=self.bk, H=self.H, unroll=self.unroll,
            out_dtype=X.dtype,
        )
        nrows = self.rptr.shape[0] * self.bm
        return Y[: self._n] if nrows != self._n else Y

    def diagonal(self):
        return self.diag

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, bm: int | None = None,
                   bk: int = 128, unroll: int | None = None, device="cpu"):
        """Build from a scipy sparse symmetric matrix on ``device``.

        ``bm=None`` (and ``unroll=None``) auto-tunes the tile plan from the
        matrix's tile-fill profile (``pick_tile_plan``)."""
        import scipy.sparse as sp

        if dtype not in _NP_DTYPE:
            raise TypeError(
                f"BlockSparseOperator holds float32 or float64 values, got {dtype}"
            )
        if bm is None and unroll is None:
            bm, unroll = pick_tile_plan(A, bk=bk)
        elif bm is None:
            bm = pick_tile_height(A, bk=bk, unroll=unroll)
        elif unroll is None:
            unroll = 4
        npdt = _NP_DTYPE[dtype]
        tile_cols, hcount, rptr, vals, nb, ncb, H = _packed_bsr_from_scipy(
            A, bm, bk, unroll, npdt
        )
        dev = torch.device(device)
        return cls(
            tile_cols=torch.from_numpy(tile_cols).to(dev),
            hcount=torch.from_numpy(hcount).to(dev),
            rptr=torch.from_numpy(rptr).to(dev),
            vals=torch.from_numpy(vals).to(dev),
            diag=torch.from_numpy(
                sp.csr_matrix(A).diagonal().astype(npdt)
            ).to(dev),
            _n=A.shape[0],
            H=H,
            bm=bm,
            bk=bk,
            unroll=unroll,
        )
