"""Block-sparse SpMM operators: packed (CSR-of-tiles), blocked-ELL and
transposed-panel layouts.

Port of ``rbl_tpu/ops/spmm/pallas_bsr.py``: the host-side conversions and
the tile-plan search are the same numpy code; each SpMM is a hand-written
CUDA kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor:

- packed (B1/B2): ``bsr_spmm_packed_resident``, ``bsr_spmm_packed`` —
  ``csrc/bsr_spmm.cu``;
- blocked-ELL (B3): ``bsr_spmm`` — the same kernel with a fixed L tiles
  per block-row;
- panel (B4): ``bsr_spmm_panel`` — ``csrc/bsr_spmm_panel.cu``, persistent
  CTAs that stream each panel slice and its tile's X rows into a ring of
  shared memory by bulk asynchronous copies.

Packed layout: A is cut into (bm, bk) tiles and only nonzero tiles are
stored.  Block-row i owns the tiles [rptr[i]·U, (rptr[i] + hcount[i])·U)
of ``vals`` (T, bm, bk), padded with zero tiles (column 0) to a multiple
of the unroll U; ``tile_cols`` (T,) holds each tile's column-block id.
The panel layout stores each chunk of U tiles transposed, as one
(U·bk, bm) panel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import resolve_device
from .operator import LinearOperator

# The JAX package kept X resident in the TPU's on-chip VMEM up to this
# size and streamed it tile by tile above it; its panel layout took only
# a resident X.  The rules are kept for parity, so that the entry points
# a user reaches stay the same.  On the card the packed entry points
# launch the same kernel, and the panel kernel copies each tile's X rows
# into shared memory beside its panel rows, whatever X's size.
_RESIDENT_X_BYTES = 8 * 2**20

# Time model of the packed CUDA kernel: an apply streams the stored tile
# bytes at _BSR_BYTES_PER_S and pays _STEP_COST_BYTES more for each tile
# it visits (the tile's X rows and the per-tile loop).  It ranks (tile
# height, unroll) plans in ``pick_tile_plan`` and prices a plan for the
# format router.  Least-squares fit by tools/fit_router.py to the f32,
# b = 8 apply times of 12 plans of fem_elasticity_3d(42) and of the
# assembled 512² Laplacian on an NVIDIA H100 80GB HBM3, 700.00 W (within
# 6% on every fem42 plan, 19% on the Laplacian's).  The kernel streams its
# tiles through a ring of asynchronous copies, so a tile costs little
# beyond its bytes.
_STEP_COST_BYTES = 669
_BSR_BYTES_PER_S = 2.5647e12

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


def _plan_tiles(counts, U: int) -> int:
    """Tiles a packed plan of unroll U stores (rows padded to a multiple
    of U, at least one chunk each)."""
    return int(np.maximum(-(-counts // U), 1).sum()) * U


def pick_tile_plan(A, bk: int = 128,
                   heights=(128, 64, 32, 16),
                   unrolls=(4, 8, 16, 32)) -> tuple[int, int]:
    """Jointly choose (tile height, unroll) minimizing the modelled apply
    time: stored tile bytes plus ``_STEP_COST_BYTES`` per stored tile.
    Finer tiles store fewer zeros but more tiles; a larger unroll pads
    every row's tile list to a multiple of U.  The candidates are the JAX
    package's."""
    best, best_cost = None, float("inf")
    for bm in heights:
        _, _, _, _, counts, _, _ = _tile_census(A, bm, bk)
        for U in unrolls:
            # U ≥ 32 only with bm = 16, as in the JAX package's tuner
            if U >= 32 and bm > 16:
                continue
            cost = _plan_tiles(counts, U) * (bm * bk * 4 + _STEP_COST_BYTES)
            if cost < best_cost:
                best, best_cost = (bm, U), cost
    return best


def pick_tile_height(A, bk: int = 128, unroll: int = 4,
                     candidates=(128, 64, 32, 16)) -> int:
    """Tile height of the jointly-tuned plan (see pick_tile_plan)."""
    return pick_tile_plan(A, bk=bk, heights=candidates)[0]


def modeled_bsr_apply_seconds(A, bk: int = 128,
                              hbm_bw: float = _BSR_BYTES_PER_S,
                              plan: tuple | None = None) -> float:
    """Modelled f32 apply time of the (given or best) packed plan on the
    card — the format router compares it with the DIA model."""
    bm, U = plan if plan is not None else pick_tile_plan(A, bk=bk)
    _, _, _, _, counts, _, _ = _tile_census(A, bm, bk)
    return _plan_tiles(counts, U) * (bm * bk * 4 + _STEP_COST_BYTES) / hbm_bw


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


def _blocked_ell_from_scipy(A, bm: int, bk: int, dtype):
    """Host-side conversion scipy sparse → blocked-ELL arrays: every
    block-row padded to the same L tiles (zero tiles at column-block 0).
    Returns (block_cols (nb, L), block_vals (nb, L, bm, bk), nb, ncb, L)."""
    import scipy.sparse as sp

    A = sp.coo_matrix(A)
    A.sum_duplicates()  # fancy-index scatter below keeps only last writes
    n = A.shape[0]
    nb = -(-n // bm)          # block rows
    ncb = -(-n // bk)         # block cols
    br = A.row // bm
    bc = A.col // bk
    key = br.astype(np.int64) * ncb + bc
    ukey, inv = np.unique(key, return_inverse=True)
    ubr = (ukey // ncb).astype(np.int64)
    ubc = (ukey % ncb).astype(np.int32)
    # slot = rank of each unique block within its block-row
    row_start = np.searchsorted(ubr, np.arange(nb))
    slot = np.arange(len(ukey)) - row_start[ubr]
    L = int(slot.max()) + 1 if len(ukey) else 1
    block_cols = np.zeros((nb, L), dtype=np.int32)
    block_cols[ubr, slot] = ubc
    block_vals = np.zeros((nb, L, bm, bk), dtype=np.dtype(dtype))
    block_vals[br, slot[inv], A.row % bm, A.col % bk] = A.data.astype(
        np.dtype(dtype)
    )
    return block_cols, block_vals, nb, ncb, L


def _panels_from_tiles(vals: np.ndarray, unroll: int) -> np.ndarray:
    """Repack packed tiles (T, bm, bk) into transposed panels
    (T/U, U·bk, bm): element (u·bk + kk, m) of chunk c is tile c·U+u's
    (m, kk)."""
    T, bm, bk = vals.shape
    return np.ascontiguousarray(
        vals.reshape(T // unroll, unroll, bm, bk)
        .transpose(0, 1, 3, 2)
        .reshape(T // unroll, unroll * bk, bm)
    )


def _packed_chunks(hcount, rptr):
    """(row, chunk) of every chunk the packed layout's rows own."""
    nb = rptr.shape[0]
    dev = rptr.device
    hc = hcount.long()
    row = torch.repeat_interleave(torch.arange(nb, device=dev), hc)
    first = torch.cumsum(hc, 0) - hc  # each row's offset in the chunk list
    chunk = rptr.long()[row] + torch.arange(row.shape[0], device=dev) - first[row]
    return row, chunk


def bsr_spmm_packed_reference(tile_cols, hcount, rptr, vals, X, *, bm: int,
                              bk: int, unroll: int, out_dtype=None):
    """Plain PyTorch Y = A @ X for packed A: gather each tile's X rows,
    one batched product per tile, and a scatter-add into the block-rows.
    X must already be padded to (ncb*bk, b) rows.  Returns (nb*bm, b)."""
    nb = rptr.shape[0]
    b = X.shape[1]
    dev = vals.device
    row, chunk = _packed_chunks(hcount, rptr)
    tiles = (chunk[:, None] * unroll
             + torch.arange(unroll, device=dev)).reshape(-1)
    Xg = X.reshape(-1, bk, b)[tile_cols.long()[tiles]]  # (tiles, bk, b)
    P = torch.einsum("tmk,tkb->tmb", vals[tiles], Xg)
    Y = torch.zeros((nb, bm, b), dtype=vals.dtype, device=dev)
    Y.index_add_(0, row.repeat_interleave(unroll), P)
    Y = Y.reshape(nb * bm, b)
    return Y if out_dtype is None else Y.to(out_dtype)


def bsr_spmm_reference(block_cols, block_vals, X, *, bm: int, bk: int,
                       L: int, unroll: int = 1, out_dtype=None):
    """Plain PyTorch Y = A @ X for blocked-ELL A: every block-row sums the
    products of its L tiles with their X rows.  Returns (nb*bm, b)."""
    nb = block_cols.shape[0] // L
    b = X.shape[1]
    Xg = X.reshape(-1, bk, b)[block_cols.long()]  # (nb·L, bk, b)
    P = torch.einsum("tmk,tkb->tmb", block_vals, Xg)
    Y = P.reshape(nb, L, bm, b).sum(1).reshape(nb * bm, b)
    return Y if out_dtype is None else Y.to(out_dtype)


def bsr_spmm_panel_reference(tile_cols, hcount, rptr, vals_t, X, *, bm: int,
                             bk: int, unroll: int, gather: str = "swap",
                             out_dtype=None):
    """Plain PyTorch Y = A @ X for the panel layout, as the TPU kernel
    computes it: per chunk, the (b, U·bk) stack of its tiles' X rows (built
    by a stack and axis swap, or by a concatenation — the two assemblies of
    ``gather``) times its (U·bk, bm) panel, accumulated as (b, bm) and
    written transposed.  Returns (nb*bm, b)."""
    nb = rptr.shape[0]
    b = X.shape[1]
    U = unroll
    row, chunk = _packed_chunks(hcount, rptr)
    Xt = X.reshape(-1, bk, b).transpose(1, 2)  # (ncb, b, bk)
    ids = tile_cols.long().reshape(-1, U)[chunk]  # (chunks, U)
    if gather == "concat":
        xflat = torch.cat([Xt[ids[:, u]] for u in range(U)], dim=2)
    else:
        xflat = Xt[ids].transpose(1, 2).reshape(-1, b, U * bk)
    acc = torch.einsum("cbk,ckm->cbm", xflat, vals_t[chunk])  # (chunks, b, bm)
    Y = torch.zeros((nb, b, bm), dtype=vals_t.dtype, device=vals_t.device)
    Y.index_add_(0, row, acc)
    Y = Y.transpose(1, 2).reshape(nb * bm, b)
    return Y if out_dtype is None else Y.to(out_dtype)


def _check_operands(ints, vals, vals_shape, X, bk):
    """Validate the operands of a block-sparse SpMM: the int32 index
    arrays ``ints`` (name → tensor), ``vals`` of shape ``vals_shape`` and
    X padded to ncb·bk rows, all contiguous on one device."""
    dev = vals.device
    for name, t in (*ints.items(), ("vals", vals), ("X", X)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if vals.dtype not in _NP_DTYPE:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if X.dtype != vals.dtype:
        raise TypeError(f"X is {X.dtype}, vals {vals.dtype}")
    if tuple(vals.shape) != tuple(vals_shape):
        raise ValueError(f"vals is {tuple(vals.shape)}, expected "
                         f"{tuple(vals_shape)}")
    if X.ndim != 2 or X.shape[0] % bk:
        raise ValueError(f"X {tuple(X.shape)} is not padded to ncb*bk rows")


def _check_packed(tile_cols, hcount, rptr, vals, X, bm, bk, unroll):
    T = vals.shape[0]
    if T % unroll:
        raise ValueError(f"{T} tiles are not a multiple of unroll={unroll}")
    if tile_cols.shape[0] != T or hcount.shape != rptr.shape:
        raise ValueError("tile_cols must be (T,), hcount and rptr (nb,)")
    _check_operands(dict(tile_cols=tile_cols, hcount=hcount, rptr=rptr),
                    vals, (T, bm, bk), X, bk)


def _check_cuda(vals, bm, bk, name):
    """The CUDA kernels' own limits; raises for a tensor off CPU and CUDA."""
    if vals.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {vals.device}")
    if bm > 128 or bk % 32:
        raise ValueError(f"the CUDA kernel takes bm ≤ 128 and bk % 32 == 0, "
                         f"got bm={bm}, bk={bk}")
    if vals.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads vals in 16-byte vectors: "
                         "its storage must be 16-byte aligned")


def _spmm(tile_cols, hcount, rptr, vals, X, bm, bk, unroll, out_dtype):
    """The CPU reference for a CPU tensor, the CUDA kernel otherwise.
    Returns (Y, launched)."""
    _check_packed(tile_cols, hcount, rptr, vals, X, bm, bk, unroll)
    if vals.device.type == "cpu":
        Y = bsr_spmm_packed_reference(
            tile_cols, hcount, rptr, vals, X, bm=bm, bk=bk, unroll=unroll,
            out_dtype=out_dtype,
        )
        return Y, False
    _check_cuda(vals, bm, bk, "bsr_spmm_packed")
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


def bsr_spmm(block_cols, block_vals, X, *, bm: int, bk: int, L: int,
             unroll: int = 1, out_dtype=None):
    """Y = A @ X for blocked-ELL A (``_blocked_ell_from_scipy``, flattened
    over (block-row, slot)): block_cols (nb·L,) int32, block_vals
    (nb·L, bm, bk), X padded to (ncb·bk, b) rows.  ``unroll`` grouped the
    TPU's tile fetches; L must be a multiple of it.  Returns (nb·bm, b)."""
    if L < 1 or L % unroll:
        raise ValueError(f"L={L} not a multiple of unroll={unroll}")
    nbL = block_cols.shape[0]
    if nbL % L:
        raise ValueError(f"block_cols holds {nbL} slots, not nb·L with L={L}")
    _check_operands(dict(block_cols=block_cols), block_vals, (nbL, bm, bk),
                    X, bk)
    if block_vals.device.type == "cpu":
        return bsr_spmm_reference(block_cols, block_vals, X, bm=bm, bk=bk,
                                  L=L, unroll=unroll, out_dtype=out_dtype)
    _check_cuda(block_vals, bm, bk, "bsr_spmm")
    from ._kernels import launch_bsr_spmm_ell

    Y = launch_bsr_spmm_ell(block_cols, block_vals, X, bm=bm, bk=bk, L=L)
    bsr_spmm.launches += 1
    return Y if out_dtype is None else Y.to(out_dtype)


def bsr_spmm_panel(tile_cols, hcount, rptr, vals_t, X, *, bm: int, bk: int,
                   H: int, unroll: int = 1, out_dtype=None,
                   gather: str = "swap"):
    """Y = A @ X for the panel layout: the packed tile list with each chunk
    of U tiles stored as one transposed (U·bk, bm) panel (``vals_t``
    (T/U, U·bk, bm)).  ``gather`` ("swap" or "concat") chose how the TPU
    assembled the stacked X operand; both give the same product, and the
    CUDA kernel takes either.  X must already be padded to (ncb*bk, b)
    rows.  Returns (nb·bm, b)."""
    if gather not in ("swap", "concat"):
        raise ValueError(f"gather must be 'swap' or 'concat', got {gather!r}")
    nch = vals_t.shape[0]
    if tile_cols.shape[0] != nch * unroll or hcount.shape != rptr.shape:
        raise ValueError("tile_cols must be (T/U·U,), hcount and rptr (nb,)")
    _check_operands(dict(tile_cols=tile_cols, hcount=hcount, rptr=rptr),
                    vals_t, (nch, unroll * bk, bm), X, bk)
    if vals_t.device.type == "cpu":
        return bsr_spmm_panel_reference(
            tile_cols, hcount, rptr, vals_t, X, bm=bm, bk=bk, unroll=unroll,
            gather=gather, out_dtype=out_dtype,
        )
    _check_cuda(vals_t, bm, bk, "bsr_spmm_panel")
    if X.data_ptr() % 16:
        raise ValueError("the panel kernel copies X in 16-byte units: its "
                         "storage must be 16-byte aligned")
    from ._kernels import launch_bsr_spmm_panel

    Y = launch_bsr_spmm_panel(tile_cols, hcount, rptr, vals_t, X, bm=bm,
                              bk=bk, unroll=unroll)
    bsr_spmm_panel.launches += 1
    return Y if out_dtype is None else Y.to(out_dtype)


# CUDA kernel launches per entry point: a run can show it went through them
bsr_spmm_packed_resident.launches = 0
bsr_spmm_packed.launches = 0
bsr_spmm.launches = 0
bsr_spmm_panel.launches = 0


@dataclasses.dataclass
class BlockSparseOperator(LinearOperator):
    """Symmetric sparse operator in packed (CSR-of-tiles) block layout,
    applied with the CUDA block-sparse kernels on the card and with their
    plain PyTorch versions on the CPU.  Values are f32 or f64.  With
    ``panel=True`` the tiles are stored as transposed panels and applied
    by the panel kernel."""

    tile_cols: torch.Tensor  # (T,) int32 column-block id per packed tile
    hcount: torch.Tensor     # (nb,) int32 chunk count per block-row
    rptr: torch.Tensor       # (nb,) int32 first chunk of each block-row
    vals: torch.Tensor       # (T, bm, bk) packed tiles — or, when
    #                          panel=True, (T/U, U·bk, bm) transposed panels
    diag: torch.Tensor | None = None  # (n,)
    _n: int = 0
    H: int = 1
    bm: int = 128
    bk: int = 128
    unroll: int = 1
    panel: bool = False
    panel_gather: str = "swap"

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
        args = (self.tile_cols, self.hcount, self.rptr, self.vals, Xp)
        kw = dict(bm=self.bm, bk=self.bk, H=self.H, unroll=self.unroll,
                  out_dtype=X.dtype)
        if self.panel:
            if xbytes > _RESIDENT_X_BYTES:
                raise ValueError(
                    "the panel layout takes an X of at most "
                    f"{_RESIDENT_X_BYTES} bytes, the JAX package's limit, "
                    f"kept for parity (this X: {xbytes} bytes) — rebuild "
                    "with panel=False for this block width"
                )
            Y = bsr_spmm_panel(*args, gather=self.panel_gather, **kw)
        elif xbytes <= _RESIDENT_X_BYTES:
            Y = bsr_spmm_packed_resident(*args, **kw)
        else:
            Y = bsr_spmm_packed(*args, **kw)
        nrows = self.rptr.shape[0] * self.bm
        return Y[: self._n] if nrows != self._n else Y

    def diagonal(self):
        return self.diag

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, bm: int | None = None,
                   bk: int = 128, unroll: int | None = None,
                   panel: bool = False, panel_gather: str = "swap",
                   device=None):
        """Build from a scipy sparse symmetric matrix on ``device`` (default:
        the CUDA card).

        ``bm=None`` (and ``unroll=None``) auto-tunes the tile plan from the
        matrix's tile-fill profile (``pick_tile_plan``).  ``panel=True``
        repacks the tiles into transposed panels for ``bsr_spmm_panel``."""
        import scipy.sparse as sp

        if dtype not in _NP_DTYPE:
            raise TypeError(
                f"BlockSparseOperator holds float32 or float64 values, got {dtype}"
            )
        dev = resolve_device(device)
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
        if panel:
            vals = _panels_from_tiles(vals, unroll)
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
            panel=panel,
            panel_gather=panel_gather,
        )

    def density_report(self) -> str:
        nnz = int(torch.count_nonzero(self.vals))
        stored = self.vals.numel()
        return (
            f"BlockSparseOperator: n={self._n}, {self.nnz_blocks} packed "
            f"tiles of {self.bm}x{self.bk} (H={self.H}, unroll="
            f"{self.unroll}), fill={nnz/max(stored,1):.3f}"
        )
