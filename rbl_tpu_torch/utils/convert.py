"""Build the port's objects from the JAX package's state, given as numpy.

The two packages share no code (the port never imports JAX), so state
crosses as plain arrays: ``np.asarray(getattr(jax_op, field))`` for each
array field of a JAX operator, plus its static fields as Python values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import RBLConfig, resolve_device
from ..ops.spmm.bsr import BlockSparseOperator
from ..ops.spmm.coo import CooOperator, HybOperator, RectCooOperator
from ..ops.spmm.dia import DiaOperator
from ..ops.spmm.ell import SparseEllOperator
from ..ops.spmm.operator import (
    DenseOperator,
    DiagonalOperator,
    GramOperator,
    Laplacian2D,
    SparseGramOperator,
)

# RBLConfig fields of the JAX package that exist only for the TPU: dropped.
_TPU_ONLY_FIELDS = frozenset({
    "chunk_growth_cap_f64", "fault_retries", "min_basis_cols",
})
# Fields that the JAX package validates but nothing of it reads (both
# packages deflate the restarted sweep every step): dropped.
_UNREAD_FIELDS = frozenset({"restart_reorth_cadence"})


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type (JAX's
    ``jnp.float32`` and ``jnp.bfloat16`` included), or a dtype name."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype for {dt!r}")
    return out


def config_from_fields(fields: dict) -> RBLConfig:
    """An RBLConfig from the fields of the JAX package's RBLConfig (e.g.
    ``dataclasses.asdict(cfg)``), the checkpoint, fault-injection and
    restart knobs included.  Drops the TPU-only fields and the ones nothing
    reads.  A JAX ``Mesh`` cannot cross (the port's mesh is a
    torch.distributed process group): ``mesh`` must be None or a
    ``parallel.mesh.RowMesh`` the caller built, and anything else raises.
    A RowMesh has one axis, so ``rows_axis`` is dropped at its default
    "rows" and raises otherwise."""
    from ..parallel.mesh import RowMesh

    kw = {}
    for name, value in fields.items():
        if name in _TPU_ONLY_FIELDS or name in _UNREAD_FIELDS:
            continue
        if name == "rows_axis":
            if value != "rows":
                raise ValueError(
                    f"RBLConfig.rows_axis={value!r}: the PyTorch package's "
                    "RowMesh has a single axis; only the default 'rows' "
                    "crosses"
                )
            continue
        if name == "mesh" and value is not None and not isinstance(value, RowMesh):
            raise TypeError(
                f"RBLConfig.mesh={value!r}: a JAX mesh cannot cross to the "
                "PyTorch package — build a RowMesh (parallel.mesh."
                "make_row_mesh) over an initialized process group and pass "
                "it instead"
            )
        if name in ("basis_dtype", "compute_dtype"):
            value = torch_dtype(value)
        kw[name] = value
    return RBLConfig(**kw)


def operator_from_arrays(kind: str, arrays: dict[str, np.ndarray],
                         static: dict[str, Any], device=None, mesh=None):
    """The port's operator ``kind`` from the JAX operator's array fields
    (``arrays``) and static fields (``static``), on ``device`` (default:
    the CUDA card).

    kind: "BlockSparseOperator" (arrays tile_cols, hcount, rptr, vals, diag;
    static _n, H, bm, bk, unroll, and panel, panel_gather for the panel
    layout), "DiaOperator" (data; offsets, _n), "SparseEllOperator" (cols,
    vals; _n), "CooOperator" (rows, cols, vals; _n, _chunk),
    "HybOperator" (the ELL part's arrays as ell_cols, ell_vals and the COO
    part's as coo_rows, coo_cols, coo_vals; _n, _chunk),
    "DiagonalOperator" (diag), "DenseOperator" (mat), "Laplacian2D"
    (static nx, ny, _dtype), "GramOperator" (B; left), "RectCooOperator"
    (rows, cols, vals; _m, _ncols, _chunk) or "SparseGramOperator" (the
    forward factor's arrays as bf_rows, bf_cols, bf_vals and the
    transpose's as bt_rows, bt_cols, bt_vals; _m, _ncols, left, _chunk).

    The sharded kinds take the JAX operator's GLOBAL banded arrays and a
    ``mesh`` (a ``parallel.mesh.RowMesh``; ``device`` is then the mesh's),
    and keep rank ``mesh.rank``'s part: "ShardedBlockSparseOperator"
    (tile_cols, hcount, rptr, vals, send_idx, diag; _n, H, bm, bk, unroll,
    caps), "ShardedEllSpMM" (cols, vals, send_idx; _n, caps),
    "ShardedCooSpMM" (rows, cols, vals, send_idx; _n, caps),
    "ShardedRectCooSpMM" (rows, cols, vals; _m, _ncols) and
    "ShardedLaplacian2D" (nx, ny, _dtype).

    A ``RestartState`` and a sweep state cross as the .npz files of
    ``utils.checkpoint``, which both packages read and write."""
    if kind.startswith("Sharded"):
        from ..parallel.dist_spmm import sharded_from_arrays

        if mesh is None:
            raise ValueError(f"{kind} needs the mesh of its ranks (mesh=)")
        return sharded_from_arrays(kind, arrays, static, mesh)
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), device=dev)

    if kind == "BlockSparseOperator":
        return BlockSparseOperator(
            tile_cols=t("tile_cols"), hcount=t("hcount"), rptr=t("rptr"),
            vals=t("vals"), diag=t("diag") if arrays.get("diag") is not None else None,
            _n=int(static["_n"]), H=int(static["H"]), bm=int(static["bm"]),
            bk=int(static["bk"]), unroll=int(static["unroll"]),
            panel=bool(static.get("panel", False)),
            panel_gather=str(static.get("panel_gather", "swap")),
        )
    if kind == "DiaOperator":
        return DiaOperator(data=t("data"),
                           offsets=tuple(int(o) for o in static["offsets"]),
                           _n=int(static["_n"]))
    if kind == "SparseEllOperator":
        return SparseEllOperator(cols=t("cols"), vals=t("vals"),
                                 _n=int(static["_n"]))
    if kind == "CooOperator":
        return CooOperator(rows=t("rows"), cols=t("cols"), vals=t("vals"),
                           _n=int(static["_n"]),
                           _chunk=int(static.get("_chunk", 1 << 22)))
    if kind == "HybOperator":
        n = int(static["_n"])
        return HybOperator(
            ell=SparseEllOperator(cols=t("ell_cols"), vals=t("ell_vals"), _n=n),
            coo=CooOperator(rows=t("coo_rows"), cols=t("coo_cols"),
                            vals=t("coo_vals"), _n=n,
                            _chunk=int(static.get("_chunk", 1 << 22))),
        )
    if kind == "DiagonalOperator":
        return DiagonalOperator(t("diag"))
    if kind == "DenseOperator":
        return DenseOperator(t("mat"))
    if kind == "Laplacian2D":
        return Laplacian2D(
            nx=int(static["nx"]), ny=int(static["ny"]),
            dtype=torch_dtype(static.get("_dtype", np.float64)), device=dev,
        )
    if kind == "GramOperator":
        return GramOperator(B=t("B"), left=bool(static.get("left", False)))
    chunk = int(static.get("_chunk", 1 << 22))
    if kind == "RectCooOperator":
        return RectCooOperator(rows=t("rows"), cols=t("cols"), vals=t("vals"),
                               _m=int(static["_m"]),
                               _ncols=int(static["_ncols"]), _chunk=chunk)
    if kind == "SparseGramOperator":
        m, ncols = int(static["_m"]), int(static["_ncols"])
        return SparseGramOperator(
            Bf=RectCooOperator(rows=t("bf_rows"), cols=t("bf_cols"),
                               vals=t("bf_vals"), _m=m, _ncols=ncols,
                               _chunk=chunk),
            Bt=RectCooOperator(rows=t("bt_rows"), cols=t("bt_cols"),
                               vals=t("bt_vals"), _m=ncols, _ncols=m,
                               _chunk=chunk),
            left=bool(static.get("left", False)),
        )
    raise ValueError(f"unknown operator kind {kind!r}")


def amg_from_arrays(levels: list, transfers: list, coarse_inv: np.ndarray,
                    nu: int, dtype=torch.float64, device=None):
    """The port's ``AssembledMultigrid`` holding the JAX hierarchy's arrays.

    levels: one dict a level: "kind", "arrays", "static" (its operator, as
    ``operator_from_arrays`` takes it), "Winv" (n_nodes, dof, dof).
    transfers: one dict a level: {"type": "agg", "Qpad", "perm", "posinv",
    "dinv", "w", "nc"} (the smoothing term applies that level's operator),
    {"type": "grid", "fine_dims", "coarse_dims", "P1s", "dof"} or
    {"type": "coo", "P"} (P as a scipy matrix).  coarse_inv: the dense
    coarsest inverse; nu: the smoothing sweeps."""
    from ..ops.amg import (
        AssembledMultigrid,
        _AggTransfer,
        _AMGLevel,
        _CooTransfer,
        _GridTransfer,
    )

    dev = resolve_device(device)
    lv = []
    for spec in levels:
        op = operator_from_arrays(spec["kind"], spec["arrays"],
                                  spec.get("static", {}), dev)
        Winv = np.asarray(spec["Winv"])
        lv.append(_AMGLevel(None, Winv.shape[1], 0.0, dtype, dev, op=op,
                            Winv=Winv))
    tr = []
    for level, spec in zip(lv, transfers):
        kind = spec["type"]
        if kind == "agg":
            tr.append(_AggTransfer(
                (spec["Qpad"], spec["perm"], spec["posinv"]), level.op,
                spec["dinv"], spec["w"], spec["nc"], dtype, dev))
        elif kind == "grid":
            tr.append(_GridTransfer(spec["fine_dims"], spec["coarse_dims"],
                                    spec["P1s"], spec["dof"]))
        elif kind == "coo":
            tr.append(_CooTransfer(spec["P"], dtype, dev))
        else:
            raise ValueError(f"unknown transfer type {kind!r}")
    return AssembledMultigrid(lv, tr, np.asarray(coarse_inv), int(nu), dtype,
                              dev)


def series_from_arrays(base, coeffs: np.ndarray, lo: float, hi: float):
    """The port's ``ChebyshevSeriesOperator`` on ``base`` (a port operator)
    with the JAX series' coefficients and domain [lo, hi]."""
    from ..ops.generalized import ChebyshevSeriesOperator

    return ChebyshevSeriesOperator.from_coeffs(base, coeffs, lo, hi)
