"""Shared helpers of the parity tests between the JAX package (rbl_tpu, the
reference) and its PyTorch port (rbl_tpu_torch).

Inputs are made from a seed with numpy and handed to both packages; state
crosses between them as numpy arrays.  Importing this module caps torch's
intra-op threads, because tier-1 runs the test files in parallel workers.
"""

from __future__ import annotations

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
