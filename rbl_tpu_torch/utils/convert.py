"""Build the port's objects from the JAX package's state, given as numpy.

The two packages share no code (the port never imports JAX), so state
crosses as plain arrays: ``np.asarray(getattr(jax_op, field))`` for each
array field of a JAX operator, plus its static fields as Python values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import RBLConfig
from ..ops.spmm.bsr import BlockSparseOperator
from ..ops.spmm.operator import DenseOperator, DiagonalOperator, Laplacian2D

# RBLConfig fields of the JAX package that exist only for the TPU: dropped.
_TPU_ONLY_FIELDS = frozenset({
    "chunk_growth_cap_f64", "fault_retries", "min_basis_cols",
})
# Fields of features not ported yet, with the JAX package's defaults: a
# config that leaves them at the default converts, any other raises.
_NOT_PORTED_DEFAULTS = {
    "mesh": None,
    "rows_axis": "rows",
    "sweep_checkpoint_path": None,
    "sweep_checkpoint_every": 1,
    "fault_inject_abort_after_chunks": None,
    "restart_kryl_dim": 100,
    "restart_growth": 10,
    "restart_reorth_cadence": 3,
    "restart_growth_policy": "stall",
}


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
    ``dataclasses.asdict(cfg)``).  Drops the TPU-only fields; raises
    NotImplementedError for a feature the port does not have yet."""
    kw = {}
    for name, value in fields.items():
        if name in _TPU_ONLY_FIELDS:
            continue
        if name in _NOT_PORTED_DEFAULTS:
            if value != _NOT_PORTED_DEFAULTS[name]:
                raise NotImplementedError(
                    f"RBLConfig.{name}={value!r}: not ported yet (ROADMAP.md "
                    "section A)"
                )
            continue
        if name in ("basis_dtype", "compute_dtype"):
            value = torch_dtype(value)
        kw[name] = value
    return RBLConfig(**kw)


def operator_from_arrays(kind: str, arrays: dict[str, np.ndarray],
                         static: dict[str, Any], device="cpu"):
    """The port's operator ``kind`` from the JAX operator's array fields
    (``arrays``) and static fields (``static``), on ``device``.

    kind: "BlockSparseOperator" (arrays tile_cols, hcount, rptr, vals, diag;
    static _n, H, bm, bk, unroll), "DiagonalOperator" (diag),
    "DenseOperator" (mat) or "Laplacian2D" (static nx, ny, _dtype)."""
    dev = torch.device(device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name]), device=dev)

    if kind == "BlockSparseOperator":
        return BlockSparseOperator(
            tile_cols=t("tile_cols"), hcount=t("hcount"), rptr=t("rptr"),
            vals=t("vals"), diag=t("diag") if arrays.get("diag") is not None else None,
            _n=int(static["_n"]), H=int(static["H"]), bm=int(static["bm"]),
            bk=int(static["bk"]), unroll=int(static["unroll"]),
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
    raise ValueError(f"unknown operator kind {kind!r}")
