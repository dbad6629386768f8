"""Shared helpers of the parity tests between the JAX package (rbl_tpu, the
reference) and its PyTorch port (rbl_tpu_torch).

Inputs are made from a seed with numpy and handed to both packages; state
crosses between them as numpy arrays.  Importing this module caps torch's
intra-op threads, because tier-1 runs the test files in parallel workers.
"""

from __future__ import annotations

import ast
import importlib
import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

torch.set_num_threads(2)

# The port's entry points run on the CUDA card unless asked for the CPU:
# every CPU test asks.
CPU = "cpu"

BSR_ARRAYS = ("tile_cols", "hcount", "rptr", "vals", "diag")
BSR_STATIC = ("_n", "H", "bm", "bk", "unroll", "panel", "panel_gather")


def bsr_from_jax(jax_op, device=CPU):
    """The port's BlockSparseOperator holding the JAX operator's arrays."""
    from rbl_tpu_torch.utils.convert import operator_from_arrays

    arrays = {f: np.asarray(getattr(jax_op, f)) for f in BSR_ARRAYS}
    static = {f: getattr(jax_op, f) for f in BSR_STATIC}
    return operator_from_arrays("BlockSparseOperator", arrays, static, device)


def jax_hierarchy_arrays(amg):
    """A JAX AssembledMultigrid's levels and transfers, as numpy, in the
    layout of ``utils.convert.amg_from_arrays``."""
    levels, transfers = [], []
    for lv in amg.levels:
        op = lv.op
        kind = type(op).__name__
        if kind == "DiaOperator":
            arrays, static = {"data": np.asarray(op.data)}, {"offsets": op.offsets,
                                                             "_n": op._n}
        else:
            arrays, static = ({"cols": np.asarray(op.cols), "vals": np.asarray(op.vals)},
                              {"_n": op._n})
        levels.append(dict(kind=kind, arrays=arrays, static=static,
                           Winv=np.asarray(lv.Winv)))
    for t in amg.transfers:
        if type(t).__name__ == "_AggTransfer":
            transfers.append(dict(type="agg", Qpad=np.asarray(t.Qpad),
                                  perm=np.asarray(t.perm), posinv=np.asarray(t.posinv),
                                  dinv=np.asarray(t.dinv), w=t.w, nc=t.nc))
        else:
            transfers.append(dict(type="grid", fine_dims=t.fine_dims,
                                  coarse_dims=t.coarse_dims, P1s=t.P1s, dof=t.dof))
    return levels, transfers


def random_sym(n, density, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng)
    return ((A + A.T) * 0.5).tocsr()


def messy_sym(n=2000, seed=0):
    """Skewed tile counts, one very heavy row, plenty of empty block-rows
    (the fixture of tests/test_sparse_formats.py)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 300, 4000), np.full(1500, 1777)])
    cols = np.concatenate([rng.integers(0, n, 4000), rng.integers(0, n, 1500)])
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def duplicate_coo(n=300, seed=0):
    """FEM-assembly-style COO input with repeated (row, col) entries, which
    the converters must sum."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 3000)
    cols = rng.integers(0, n, 3000)
    rows = np.concatenate([rows, rows[:500]])
    cols = np.concatenate([cols, cols[:500]])
    vals = rng.standard_normal(rows.size)
    # symmetric by construction, duplicates kept (no summing on the way)
    return sp.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    )


def rel_err(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_bench(name: str):
    """The JAX package's ``benchmarks/<name>.py``, imported as
    ``benchmarks.<name>`` (the name its sibling scripts import it by)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(f"benchmarks.{name}")


def json_key_sets(path: str) -> set:
    """The key sets of the JSON objects a script prints, read from its
    source: each dict literal with a "metric" key, with the keys a function
    later assigns into the name it is bound to (``row["k"] = ...``)."""
    tree = ast.parse(open(path).read())
    found = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Dict):
                continue
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" not in keys:
                continue
            for a in ast.walk(fn):
                if (isinstance(a, ast.Assign) and a.value is node
                        and isinstance(a.targets[0], ast.Name)):
                    name = a.targets[0].id
                    for t in ast.walk(fn):
                        if (isinstance(t, ast.Subscript)
                                and isinstance(t.ctx, ast.Store)
                                and getattr(t.value, "id", None) == name
                                and isinstance(t.slice, ast.Constant)):
                            keys.add(t.slice.value)
            found.add(frozenset(keys))
    return found


def csr_equal(A, B) -> bool:
    """Two scipy sparse matrices with the same CSR arrays, bit for bit."""
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    return (A.shape == B.shape and A.dtype == B.dtype
            and np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices)
            and np.array_equal(A.data, B.data))
