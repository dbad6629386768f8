"""Row-partitioned SpMM with boundary-only ghost exchange (port of
``rbl_tpu/parallel/dist_spmm.py``).

A's rows are split over a ``RowMesh``: rank r owns a contiguous band of
rows, and the (n, b) block X arrives as the rank's rows.  Applying a
stencil or banded operator needs only the boundary rows of the
neighbouring ranks; these are known on the host from the sparsity
pattern, so each operator holds a static send list and moves one padded
slab per mesh shift that carries coupling (``RowMesh.exchange``, the
circular ``ppermute`` of the JAX package).  Zero-cap shifts cost nothing.

- ``ShardedLaplacian2D``: the 5-point stencil, a halo of one grid row each
  way (zero at the mesh edges: the Dirichlet boundary).
- ``ShardedEllSpMM`` / ``ShardedCooSpMM``: general sparse at ROW
  granularity (``_row_ghost_plan``), falling back to an all-gather of X
  when the ghost volume reaches half of it.
- ``ShardedBlockSparseOperator``: the packed (CSR-of-tiles) layout banded
  over the ranks, the ghost plan at BLOCK granularity
  (``_block_ghost_plan``), and the CUDA packed kernel (B1/B2 of
  ``ops/spmm/bsr.py``) on each rank's rectangular band: its X holds the
  own column blocks followed by the ghosts.
- ``ShardedRectCooSpMM``: a rectangular factor, output rows banded, X
  all-gathered — the pair behind ``rbl_svd`` on a mesh.

The host plans (``caps``, ``send_idx``, the local-extended column ids) are
the JAX package's numpy code, so both packages hold the same arrays; the
divisibility rules are the JAX package's too.  ``ReplicatedOperator``
applies an operator that is not sharded under a mesh, as GSPMD applies a
replicated one: all-gather X, apply, keep the own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops.spmm.bsr import (
    _NP_DTYPE,
    _RESIDENT_X_BYTES,
    _packed_bsr_from_scipy,
    _tile_census,
    bsr_spmm_packed,
    bsr_spmm_packed_resident,
    pick_tile_plan,
)
from ..ops.spmm.coo import _coo_apply
from ..ops.spmm.ell import ell_apply, ell_arrays
from ..ops.spmm.operator import LinearOperator, host_dtype, to_device
from .mesh import RowMesh

# Triplets a COO apply gathers at a time (the single-device COO default).
_COO_CHUNK = 1 << 22


def _check_exchange(exchange: str) -> None:
    if exchange not in ("auto", "ghost", "allgather"):
        raise ValueError(f"exchange={exchange!r}")


@dataclasses.dataclass
class ShardedLaplacian2D(LinearOperator):
    """5-point 2D Laplacian with grid rows slabbed across the mesh: rank r
    holds grid rows [r·nx/size, (r+1)·nx/size) of every (n, b) block, and
    apply() adds a one-grid-row halo from each neighbour."""

    nx: int
    ny: int
    mesh: RowMesh
    dtype: torch.dtype = torch.float32

    @property
    def shape(self):
        n = self.nx * self.ny
        return (n, n)

    @property
    def device(self):
        return self.mesh.device

    def _nx_local(self) -> int:
        if self.nx % self.mesh.size:
            raise ValueError(
                f"nx={self.nx} not divisible by mesh axis size {self.mesh.size}"
            )
        return self.nx // self.mesh.size

    def apply(self, X):
        mesh = self.mesh
        nxl, ny, b = self._nx_local(), self.ny, X.shape[1]
        # the folded (nx_local, ny·b) full-lane layout of Laplacian2D
        G = X.reshape(nxl, ny * b)
        if mesh.size > 1:
            halo_lo = mesh.exchange(G[-1], 1)    # rank r−1's last row
            halo_hi = mesh.exchange(G[0], -1)    # rank r+1's first row
        if mesh.size == 1 or mesh.rank == 0:
            halo_lo = torch.zeros_like(G[0])
        if mesh.size == 1 or mesh.rank == mesh.size - 1:
            halo_hi = torch.zeros_like(G[0])
        out = 4.0 * G
        out[0] -= halo_lo
        out[1:] -= G[:-1]
        out[:-1] -= G[1:]
        out[-1] -= halo_hi
        out[:, b:] -= G[:, :-b]
        out[:, :-b] -= G[:, b:]
        return out.reshape(nxl * ny, b)

    def diagonal(self):
        return torch.full((self._nx_local() * self.ny,), 4.0,
                          dtype=self.dtype, device=self.device)


def _ghost_exchange(x_local, send_idx, caps, mesh: RowMesh):
    """x_local extended with its ghost rows in receive order (the layout
    the ghost plans' remaps target): one circular exchange per
    coupling-carrying shift s, of the (cap, ...) slab the rank s hops
    ahead needs."""
    ghosts = []
    off = 0
    for s, cap in enumerate(caps, start=1):
        if cap:
            slab = x_local.index_select(0, send_idx[off : off + cap])
            ghosts.append(mesh.exchange(slab, s))
        off += cap
    if not ghosts:
        return x_local
    return torch.cat([x_local, *ghosts], dim=0)


def _block_ghost_plan(needs, ndev: int, ncb_local: int):
    """The ghost plan at BLOCK granularity (the JAX package's numpy code).

    needs: per-device sorted arrays of GLOBAL column-block ids referenced
    by that device's tiles.  Returns (caps, seg_off, send_idx, remaps):
    per-shift uniform slab capacities, each device's send list (its own
    local block ids, one segment per shift), and per-device dicts mapping
    remote global ids to local-extended ids (own blocks first, then ghost
    slots in receive order)."""
    recv = [[None] * ndev for _ in range(max(ndev - 1, 0))]
    for d in range(ndev):
        lo = d * ncb_local
        need = needs[d]
        remote = need[(need < lo) | (need >= lo + ncb_local)]
        owner = remote // ncb_local
        for s in range(1, ndev):
            recv[s - 1][d] = remote[owner == (d - s) % ndev]
    caps = tuple(
        int(max(len(recv[s][d]) for d in range(ndev)))
        for s in range(max(ndev - 1, 0))
    )
    seg_off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    total_cap = int(sum(caps))
    send_idx = np.zeros((ndev, max(total_cap, 1)), np.int32)
    remaps = []
    for d in range(ndev):
        lo = d * ncb_local
        remap = {}
        for s in range(1, ndev):
            if caps[s - 1] == 0:
                continue
            base = ncb_local + seg_off[s - 1]
            for j, c in enumerate(recv[s - 1][d]):
                remap[int(c)] = base + j
            dst = (d + s) % ndev
            lst = recv[s - 1][dst]  # owned by d by construction
            send_idx[d, seg_off[s - 1] : seg_off[s - 1] + len(lst)] = (
                lst - lo
            )
        remaps.append(remap)
    return caps, seg_off, send_idx, remaps


def _row_ghost_plan(cols_by_dev, ml, ndev):
    """The ghost plan at ROW granularity: ``_block_ghost_plan`` with a
    row for a block.

    ``cols_by_dev[d]`` is the (possibly duplicated) GLOBAL column-id
    array referenced by device d's row band; every id is in range and pad
    slots already point at a LOCAL row.  Returns ``(remap, send_idx,
    caps)``: ``remap[d]`` maps an array of global ids to local-extended
    ids (own rows 0..ml-1, then ghost rows in receive order)."""
    needs = [np.unique(np.asarray(c)) for c in cols_by_dev]
    caps, _seg_off, send_idx, lookup = _block_ghost_plan(needs, ndev, ml)

    def make_remap(d):
        lo = d * ml
        tbl = lookup[d]

        def remap(cols):
            cols = np.asarray(cols)
            uniq, inv = np.unique(cols, return_inverse=True)
            own = (uniq >= lo) & (uniq < lo + ml)
            ext = np.empty_like(uniq, dtype=np.int32)
            ext[own] = (uniq[own] - lo).astype(np.int32)
            ext[~own] = [tbl[int(c)] for c in uniq[~own]]
            return ext[inv].reshape(cols.shape)

        return remap

    return [make_remap(d) for d in range(ndev)], send_idx, caps


def _rank_tensor(a, mesh: RowMesh, dtype=None):
    return to_device(np.asarray(a), dtype, mesh.device)


@dataclasses.dataclass
class ShardedEllSpMM(LinearOperator):
    """General row-partitioned sparse SpMM: each rank owns its row band of
    A in ELL layout (cols/vals (L, n/size)).

    Input rows move BOUNDARY-ONLY by default: one padded (cap, b) slab per
    coupling-carrying mesh shift (``_row_ghost_plan``), with ``cols`` in
    local-extended ids.  When the sparsity has no locality (Σcaps ≥ half
    of what an all-gather moves) construction falls back to the all-gather
    apply, with global column ids (``caps is None``)."""

    cols: torch.Tensor      # (L, ml) int32, local-extended or global ids
    vals: torch.Tensor      # (L, ml)
    send_idx: torch.Tensor  # (max(Σcaps, 1),) int32 local row ids
    _n: int
    mesh: RowMesh
    caps: Optional[tuple] = None  # None → all-gather

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @classmethod
    def from_scipy(cls, A, mesh: RowMesh, dtype=None, exchange: str = "auto"):
        _check_exchange(exchange)
        ndev, n = mesh.size, A.shape[0]
        if n % ndev:
            raise ValueError(f"n={n} not divisible by mesh axis size {ndev}")
        cols, vals = ell_arrays(A, dtype)  # pad slots self-point: local
        ml = n // ndev
        caps = None
        send_idx = np.zeros((ndev, 1), np.int32)
        if exchange != "allgather" and ndev > 1:
            bands = [cols[:, d * ml : (d + 1) * ml] for d in range(ndev)]
            # (the all-gather fallback keeps the plan's unused send list,
            # as the JAX package does)
            remap, send_idx, caps_ = _row_ghost_plan(bands, ml, ndev)
            # an all-gather moves (ndev−1)·ml rows per rank; take the
            # boundary path only when it moves materially less
            if exchange == "ghost" or sum(caps_) < 0.5 * (ndev - 1) * ml:
                caps = caps_
                cols = np.concatenate(
                    [remap[d](bands[d]) for d in range(ndev)], axis=1
                )
        r = mesh.rank
        return cls(
            cols=_rank_tensor(cols[:, r * ml : (r + 1) * ml], mesh),
            vals=_rank_tensor(vals[:, r * ml : (r + 1) * ml], mesh, dtype),
            send_idx=_rank_tensor(send_idx[r], mesh),
            _n=n, mesh=mesh, caps=caps,
        )

    def apply(self, X):
        if self.caps is None:
            x_ext = self.mesh.gather_rows(X, self._n)
        else:
            x_ext = _ghost_exchange(X, self.send_idx, self.caps, self.mesh)
        return ell_apply(self.cols, self.vals, x_ext, self.cols.shape[1])

    def diagonal(self):
        # padding slots self-point with value 0; the diagonal of local row
        # r is local-extended id r under the ghost plan, global lo + r
        # under the all-gather fallback
        ml = self.cols.shape[1]
        r = torch.arange(ml, dtype=self.cols.dtype, device=self.device)
        if self.caps is None:
            r = r + self.mesh.rank * ml
        return torch.where(self.cols == r[None, :], self.vals, 0.0).sum(0)

    def comm_rows_per_apply(self) -> int:
        """Ghost rows each rank moves per apply (an all-gather moves
        n − n/size) — the boundary comm-volume metric."""
        if self.caps is None:
            return self._n - self._n // self.mesh.size
        return int(sum(self.caps))


@dataclasses.dataclass
class ShardedBlockSparseOperator(LinearOperator):
    """Row-banded PACKED (CSR-of-tiles) operator applied with the CUDA
    packed kernel (B1/B2) on each rank's band, with BOUNDARY-ONLY
    ghost-block exchange.

    Everything data-dependent is resolved on the host at construction, as
    in the JAX package: rank r owns block rows [r·nb_local, (r+1)·nb_local)
    — its slice of the packed tile list, zero-padded to the longest band's
    tile count Tmax — and the matching band of X's column blocks.  Its
    tile column ids are REMAPPED to local-extended ids: own column blocks
    first (0..ncb_local−1), then ghost slots in receive order.  For each
    mesh shift that carries coupling anywhere, each rank holds a static
    send list padded to the max count over ranks (``caps[s−1]``).

    apply() appends the received ghost blocks to the rank's own X rows and
    launches the unchanged packed kernel on the rectangular band: B1
    (``bsr_spmm_packed_resident``) when the extended X fits the JAX
    package's 8 MiB resident size, B2 (``bsr_spmm_packed``) above it."""

    tile_cols: torch.Tensor   # (Tmax,) int32 LOCAL-EXTENDED column blocks
    hcount: torch.Tensor      # (nb_local,) int32 chunk count per block-row
    rptr: torch.Tensor        # (nb_local,) int32 LOCAL chunk offsets
    vals: torch.Tensor        # (Tmax, bm, bk) the band's packed tiles
    send_idx: torch.Tensor    # (max(Σcaps, 1),) int32 local column blocks
    diag: torch.Tensor | None  # (n/size,) the band's diagonal
    _n: int
    mesh: RowMesh
    H: int = 1
    bm: int = 128
    bk: int = 128
    unroll: int = 1
    caps: tuple = ()

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @staticmethod
    def _index_plan(A, ndev: int, dtype, bm, bk: int, unroll) -> dict:
        """Every band's index plan from A's sparsity pattern, no tile
        values packed: the tile plan, H, the longest band's tile count
        Tmax and the ghost plan (``caps``,
        ``send_idx``, ``remaps``) of the column blocks each band's nonzero
        tiles touch."""
        import scipy.sparse as sp

        if dtype not in _NP_DTYPE:
            raise TypeError(f"ShardedBlockSparseOperator holds float32 or "
                            f"float64 values, got {dtype}")
        n = A.shape[0]
        if bm is None and unroll is None:
            bm, unroll = pick_tile_plan(A, bk=bk)
        elif unroll is None:
            unroll = 4
        elif bm is None:
            raise ValueError("pass bm with unroll (or neither)")
        if n % (ndev * bk) or n % (ndev * bm):
            raise ValueError(
                f"n={n} must be divisible by mesh_size*bk={ndev * bk} and "
                f"mesh_size*bm={ndev * bm} so row bands align with the "
                "column-block grid"
            )
        npdt = _NP_DTYPE[dtype]
        Ac = sp.csr_matrix(A)
        if not Ac.has_canonical_format:  # (a canonical CSR needs no sort)
            Ac = Ac.copy()
            Ac.sum_duplicates()
        C = Ac.tocoo()
        key, ukey, _, _, counts, nb, ncb = _tile_census(C, bm, bk)
        chunks = np.maximum(-(-counts // unroll), 1)
        nb_local, ncb_local = nb // ndev, ncb // ndev
        band_chunks = chunks.reshape(ndev, nb_local).sum(axis=1)
        # a tile is occupied when one of its values is nonzero in dtype
        nz = C.data.astype(npdt) != 0
        occ = ukey if nz.all() else np.unique(key[nz])
        band_of = occ // ncb // nb_local
        needs = [np.unique(occ[band_of == d] % ncb) for d in range(ndev)]
        caps, _seg_off, send_idx, remaps = _block_ghost_plan(
            needs, ndev, ncb_local)
        return dict(
            _n=n, bm=bm, bk=bk, unroll=unroll, npdt=npdt, H=int(chunks.max()),
            Tmax=int(band_chunks.max()) * unroll, caps=caps,
            send_idx=send_idx, remaps=remaps,
        )

    @staticmethod
    def _band_arrays(A, plan: dict, ndev: int, d: int) -> dict:
        """Band d's packed arrays: its rows of A packed on their own, tile
        columns remapped to local-extended ids (padding tiles point at the
        band's own block 0), zero-padded to ``Tmax`` tiles."""
        import scipy.sparse as sp

        n, bm, bk, U = plan["_n"], plan["bm"], plan["bk"], plan["unroll"]
        ml, ncb_local = n // ndev, n // (ndev * bk)
        band = sp.csr_matrix(A)[d * ml : (d + 1) * ml]
        flat, hcount, rptr, vals_d = _packed_bsr_from_scipy(
            band, bm, bk, U, plan["npdt"])[:4]
        lo = d * ncb_local
        occ = vals_d.reshape(vals_d.shape[0], -1).any(axis=1)
        cols = np.zeros(flat.shape[0], dtype=np.int32)  # padding → own 0
        own = occ & (flat >= lo) & (flat < lo + ncb_local)
        rem = occ & ~own
        cols[own] = flat[own] - lo
        cols[rem] = [plan["remaps"][d][int(c)] for c in flat[rem]]
        Tmax = plan["Tmax"]
        tile_cols = np.zeros(Tmax, np.int32)
        tile_cols[: cols.shape[0]] = cols
        vals = vals_d
        if vals_d.shape[0] < Tmax:
            vals = np.zeros((Tmax, bm, bk), vals_d.dtype)
            vals[: vals_d.shape[0]] = vals_d
        return dict(tile_cols=tile_cols, hcount=hcount, rptr=rptr, vals=vals,
                    send_idx=plan["send_idx"][d],
                    diag=band.diagonal(d * ml).astype(plan["npdt"]))

    @classmethod
    def from_plan(cls, plan: dict, mesh: RowMesh):
        """Rank ``mesh.rank``'s operator from the banded arrays of every
        rank, stacked over ranks as the JAX operator's fields are."""
        ndev, r = mesh.size, mesh.rank
        nbl = plan["rptr"].shape[0] // ndev
        Tmax = plan["tile_cols"].shape[0] // ndev
        n = int(plan["_n"])
        ml = n // ndev
        diag = plan.get("diag")
        return cls._from_band(dict(
            tile_cols=plan["tile_cols"][r * Tmax : (r + 1) * Tmax],
            hcount=plan["hcount"][r * nbl : (r + 1) * nbl],
            rptr=plan["rptr"][r * nbl : (r + 1) * nbl],
            vals=plan["vals"][r * Tmax : (r + 1) * Tmax],
            send_idx=np.asarray(plan["send_idx"])[r],
            diag=None if diag is None else np.asarray(diag)[r * ml : (r + 1) * ml],
        ), plan, mesh)

    @classmethod
    def _from_band(cls, band: dict, plan: dict, mesh: RowMesh):
        diag = band["diag"]
        return cls(
            tile_cols=_rank_tensor(band["tile_cols"], mesh),
            hcount=_rank_tensor(band["hcount"], mesh),
            rptr=_rank_tensor(band["rptr"], mesh),
            vals=_rank_tensor(band["vals"], mesh),
            send_idx=_rank_tensor(band["send_idx"], mesh),
            diag=None if diag is None else _rank_tensor(diag, mesh),
            _n=int(plan["_n"]), mesh=mesh, H=int(plan["H"]),
            bm=int(plan["bm"]), bk=int(plan["bk"]),
            unroll=int(plan["unroll"]),
            caps=tuple(int(c) for c in plan["caps"]),
        )

    @classmethod
    def from_scipy(cls, A, mesh: RowMesh, dtype=torch.float32,
                   bm: int | None = None, bk: int = 128,
                   unroll: int | None = None):
        """Build rank ``mesh.rank``'s band of A.  ``bm=None`` (and
        ``unroll=None``) tunes the tile plan (``pick_tile_plan``); n must
        be divisible by mesh.size·bk and mesh.size·bm.  Every rank plans
        every band's ghosts from A's pattern but packs only its own band's
        tiles."""
        plan = cls._index_plan(A, mesh.size, dtype, bm, bk, unroll)
        return cls._from_band(
            cls._band_arrays(A, plan, mesh.size, mesh.rank), plan, mesh)

    @property
    def ncb_local(self) -> int:
        return self._n // (self.mesh.size * self.bk)

    def extended_x(self, X):
        """The rank's X rows followed by its ghost blocks, (ncb_ext·bk, b)
        in the operator's dtype: the X the band's kernel reads."""
        b = X.shape[1]
        xb = X.reshape(self.ncb_local, self.bk, b)
        x_ext = _ghost_exchange(xb, self.send_idx, self.caps, self.mesh)
        return x_ext.reshape(-1, b).to(self.dtype).contiguous()

    def kernel(self, b: int):
        """The packed entry point the band takes at block width b: B1 when
        the extended X fits ``_RESIDENT_X_BYTES``, B2 above it."""
        xbytes = ((self.ncb_local + sum(self.caps)) * self.bk * b
                  * self.dtype.itemsize)
        return (bsr_spmm_packed_resident if xbytes <= _RESIDENT_X_BYTES
                else bsr_spmm_packed)

    def apply(self, X):
        fn = self.kernel(X.shape[1])
        return fn(self.tile_cols, self.hcount, self.rptr, self.vals,
                  self.extended_x(X), bm=self.bm, bk=self.bk, H=self.H,
                  unroll=self.unroll, out_dtype=X.dtype)

    def diagonal(self):
        return self.diag

    def comm_blocks_per_apply(self) -> int:
        """Ghost (bk, b)-slabs each rank receives per apply — the boundary
        comm-volume metric (an all-gather would move ncb − ncb_local)."""
        return int(sum(self.caps))


def _banded_coo_shards_np(A, ndev, dtype):
    """Split a scipy matrix into ``ndev`` row bands of row-sorted COO
    triplets, padded to the max per-band nnz (the JAX package's numpy
    code).  Pad slots target the band's last local row with val 0 and the
    band's own FIRST GLOBAL column (clamped into range for a rectangular
    operand).  Returns (ndev, cap) arrays: rows LOCAL, cols GLOBAL, vals."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    ml = A.shape[0] // ndev
    dtype = np.dtype(dtype or A.dtype)
    shards = []
    for d in range(ndev):
        band = A[d * ml : (d + 1) * ml].tocoo()
        order = np.argsort(band.row, kind="stable")
        shards.append((band.row[order], band.col[order], band.data[order]))
    cap = max(max(len(s[0]) for s in shards), 1)
    rows = np.full((ndev, cap), ml - 1, np.int32)
    pad_col = np.minimum(
        np.arange(ndev, dtype=np.int32) * ml, A.shape[1] - 1
    )
    cols = np.repeat(pad_col[:, None], cap, axis=1)
    vals = np.zeros((ndev, cap), dtype)
    for d, (r, c, v) in enumerate(shards):
        rows[d, : len(r)] = r
        cols[d, : len(c)] = c
        vals[d, : len(v)] = v.astype(dtype)
    return rows, cols, vals


@dataclasses.dataclass
class ShardedCooSpMM(LinearOperator):
    """Row-partitioned COO SpMM: each rank owns its row band's nonzero
    triplets (row ids LOCAL to the band, padded to the max per-band count)
    and scatter-adds them into its rows — the skew-robust general
    distributed path.  Input rows move BOUNDARY-ONLY by default
    (``_row_ghost_plan`` slabs); dense coupling falls back to the
    all-gather (``caps is None``)."""

    rows: torch.Tensor      # (cap,) int32 LOCAL row ids, ascending
    cols: torch.Tensor      # (cap,) int32 local-extended or global ids
    vals: torch.Tensor      # (cap,)
    send_idx: torch.Tensor  # (max(Σcaps, 1),) int32 local row ids
    _n: int
    mesh: RowMesh
    caps: Optional[tuple] = None

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @classmethod
    def from_scipy(cls, A, mesh: RowMesh, dtype=None, exchange: str = "auto"):
        _check_exchange(exchange)
        n, ndev = A.shape[0], mesh.size
        if n % ndev:
            raise ValueError(f"n={n} not divisible by mesh axis size {ndev}")
        rows, cols, vals = _banded_coo_shards_np(A, ndev, host_dtype(dtype, A.dtype))
        ml = n // ndev
        caps = None
        send_idx = np.zeros((ndev, 1), np.int32)
        if exchange != "allgather" and ndev > 1:
            remap, send_idx, caps_ = _row_ghost_plan(list(cols), ml, ndev)
            if exchange == "ghost" or sum(caps_) < 0.5 * (ndev - 1) * ml:
                caps = caps_
                cols = np.stack([remap[d](cols[d]) for d in range(ndev)])
        r = mesh.rank
        return cls(rows=_rank_tensor(rows[r], mesh),
                   cols=_rank_tensor(cols[r], mesh),
                   vals=_rank_tensor(vals[r], mesh, dtype),
                   send_idx=_rank_tensor(send_idx[r], mesh),
                   _n=n, mesh=mesh, caps=caps)

    def apply(self, X):
        if self.caps is None:
            x_ext = self.mesh.gather_rows(X, self._n)
        else:
            x_ext = _ghost_exchange(X, self.send_idx, self.caps, self.mesh)
        return _coo_apply(self.rows, self.cols, self.vals, x_ext,
                          self._n // self.mesh.size, _COO_CHUNK)

    def diagonal(self):
        # rows are LOCAL band ids: the diagonal entry of local row r is
        # local-extended id r under the ghost plan, global lo + r under the
        # all-gather fallback; pad slots carry val 0
        ml = self._n // self.mesh.size
        base = 0 if self.caps is not None else self.mesh.rank * ml
        eq = self.cols.long() == self.rows.long() + base
        out = torch.zeros((ml,), dtype=self.dtype, device=self.device)
        return out.index_add_(0, self.rows.long(),
                              torch.where(eq, self.vals, 0.0))

    def comm_rows_per_apply(self) -> int:
        """Ghost rows each rank moves per apply (an all-gather moves
        n − n/size)."""
        if self.caps is None:
            return self._n - self._n // self.mesh.size
        return int(sum(self.caps))


@dataclasses.dataclass
class ShardedRectCooSpMM:
    """RECTANGULAR (m, n) row-partitioned COO factor, used in pairs
    (forward + transpose) by the sparse Gram operator behind ``rbl_svd``
    on a mesh.  Output rows (m) are banded over the ranks; the input block
    arrives as the rank's rows of n and is all-gathered before the local
    gather and scatter-add.  Both m and n must be divisible by the mesh
    size (``rbl_svd`` falls back to the dense path otherwise)."""

    rows: torch.Tensor  # (cap,) int32 LOCAL output-row ids
    cols: torch.Tensor  # (cap,) int32 global input-column ids
    vals: torch.Tensor  # (cap,)
    _m: int
    _ncols: int
    mesh: RowMesh

    @property
    def shape(self):
        return (self._m, self._ncols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @classmethod
    def from_scipy(cls, B, mesh: RowMesh, dtype=None):
        m, n = B.shape
        ndev = mesh.size
        if m % ndev or n % ndev:
            raise ValueError(
                f"shape {B.shape} not divisible by mesh axis size {ndev}"
            )
        rows, cols, vals = _banded_coo_shards_np(B, ndev, host_dtype(dtype, B.dtype))
        r = mesh.rank
        return cls(rows=_rank_tensor(rows[r], mesh),
                   cols=_rank_tensor(cols[r], mesh),
                   vals=_rank_tensor(vals[r], mesh, dtype),
                   _m=m, _ncols=n, mesh=mesh)

    def apply(self, X):
        x_full = self.mesh.gather_rows(X, self._ncols)
        return _coo_apply(self.rows, self.cols, self.vals, x_full,
                          self._m // self.mesh.size, _COO_CHUNK)


@dataclasses.dataclass
class ReplicatedOperator(LinearOperator):
    """An operator that is not sharded, applied under a row mesh as GSPMD
    applies a replicated one: all-gather the rank's rows of X into the
    whole block, apply the base operator on every rank, keep the own rows
    of the result.  Every rank holds the whole of ``base``."""

    base: Any
    mesh: RowMesh

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def apply(self, X):
        n = self.base.n
        Y = self.base.apply(self.mesh.gather_rows(X, n))
        lo, hi = self.mesh.row_range(n)
        return Y[lo:hi]

    def diagonal(self):
        d = self.base.diagonal()
        if d is None:
            return None
        lo, hi = self.mesh.row_range(self.base.n)
        return d[lo:hi]


def _inner(node):
    """The operator a combinator wraps: ``base`` (affine, filters,
    shift-invert, series), ``A`` (the pencil transforms), or None."""
    inner = getattr(node, "base", None)
    return inner if inner is not None else getattr(node, "A", None)


def op_mesh(op) -> Optional[RowMesh]:
    """The RowMesh an operator is applied over (a sharded operator's own,
    a ``ReplicatedOperator``'s, a Gram operator's sharded factors', or
    that of the operator a combinator wraps), or None."""
    node = op
    while node is not None:
        own = getattr(node, "mesh", None)
        if own is None:
            own = getattr(getattr(node, "Bf", None), "mesh", None)
        if isinstance(own, RowMesh):
            return own
        node = _inner(node)
    return None


def on_mesh(op, mesh: Optional[RowMesh]):
    """``op`` ready for a solve on ``mesh``: a sharded operator (or a
    combinator over one) as it is, anything else wrapped in
    ``ReplicatedOperator``."""
    if mesh is None:
        return op
    own = op_mesh(op)
    if own is None:
        return ReplicatedOperator(base=op, mesh=mesh)
    if own.size != mesh.size:
        raise ValueError(
            f"the operator is sharded over {own.size} ranks, cfg.mesh has "
            f"{mesh.size}"
        )
    return op


def sharded_from_arrays(kind: str, arrays: dict, static: dict, mesh: RowMesh):
    """Rank ``mesh.rank``'s part of a sharded operator from the JAX
    operator's GLOBAL banded arrays and its statics (see
    ``utils.convert.operator_from_arrays``)."""
    r, ndev = mesh.rank, mesh.size
    if kind == "ShardedBlockSparseOperator":
        plan = dict(arrays)
        plan.update({k: static[k] for k in ("_n", "H", "bm", "bk", "unroll")})
        plan["caps"] = tuple(static.get("caps", ()))
        return ShardedBlockSparseOperator.from_plan(plan, mesh)
    if kind == "ShardedLaplacian2D":
        from ..utils.convert import torch_dtype

        return ShardedLaplacian2D(
            nx=int(static["nx"]), ny=int(static["ny"]), mesh=mesh,
            dtype=torch_dtype(static.get("_dtype", np.float32)),
        )
    caps = static.get("caps")
    caps = None if caps is None else tuple(int(c) for c in caps)

    def row_r(name):
        a = np.asarray(arrays[name]).reshape(ndev, -1)
        return _rank_tensor(a[r], mesh)

    send = (np.asarray(arrays["send_idx"]).reshape(ndev, -1)[r]
            if "send_idx" in arrays else np.zeros(1, np.int32))
    if kind == "ShardedEllSpMM":
        n = int(static["_n"])
        ml = n // ndev
        return ShardedEllSpMM(
            cols=_rank_tensor(np.asarray(arrays["cols"])[:, r * ml : (r + 1) * ml], mesh),
            vals=_rank_tensor(np.asarray(arrays["vals"])[:, r * ml : (r + 1) * ml], mesh),
            send_idx=_rank_tensor(send, mesh), _n=n, mesh=mesh, caps=caps,
        )
    if kind == "ShardedCooSpMM":
        return ShardedCooSpMM(
            rows=row_r("rows"), cols=row_r("cols"), vals=row_r("vals"),
            send_idx=_rank_tensor(send, mesh), _n=int(static["_n"]),
            mesh=mesh, caps=caps,
        )
    if kind == "ShardedRectCooSpMM":
        return ShardedRectCooSpMM(
            rows=row_r("rows"), cols=row_r("cols"), vals=row_r("vals"),
            _m=int(static["_m"]), _ncols=int(static["_ncols"]), mesh=mesh,
        )
    raise ValueError(f"unknown sharded operator kind {kind!r}")
