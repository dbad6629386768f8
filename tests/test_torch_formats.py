"""Parity of the port's sparse layouts and format router
(rbl_tpu_torch/ops/spmm/{dia,ell,coo,operator}.py) with the JAX package's
(rbl_tpu/ops/spmm/{dia,ell,coo,operator}.py).

The same seeded numpy inputs go through both packages on the CPU.  Both
packages build their arrays with the same numpy code, so the converters
must agree exactly; the applies agree to 1e-12 relative in f64 (sums in
another order); the bf16 checks hold both to the f64 ground truth at the
JAX package's own tolerance (tests/test_sparse_formats.py:204).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu
import rbl_tpu_torch as rtt
from _torch_parity import CPU, duplicate_coo, messy_sym, random_sym, rel_err
from rbl_tpu.ops.spmm import coo as jcoo, dia as jdia, ell as jell
from rbl_tpu.ops.spmm.operator import _pick_sparse_format as jpick
from rbl_tpu.utils.fem import fem_elasticity_3d
from rbl_tpu_torch.ops.spmm import coo as tcoo, dia as tdia, ell as tell
from rbl_tpu_torch.ops.spmm.operator import _pick_sparse_format as tpick
from rbl_tpu_torch.utils.convert import operator_from_arrays

TOL = 1e-12


def banded(n, offs, seed=0):
    """tests/test_sparse_formats.py's banded fixture."""
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.standard_normal(n) for _ in offs], offs, shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def skewed_sym(n, seed=0):
    """tests/test_sparse_formats.py's row-length-skewed fixture: a sparse
    background and a few half-dense rows."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.01, random_state=rng).tolil()
    for r in rng.choice(n, 3, replace=False):
        cols = rng.choice(n, n // 2, replace=False)
        A[r, cols] = rng.standard_normal(len(cols))
    return ((A + A.T) * 0.5).tocsr()


def duplicate_band(n=300, seed=0):
    """duplicate_coo's repeated (row, col) entries, inside a band of 11
    diagonals (DIA takes at most 256)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 3000)
    cols = np.clip(rows + rng.integers(-5, 6, 3000), 0, n - 1)
    rows = np.concatenate([rows, rows[:500]])
    cols = np.concatenate([cols, cols[:500]])
    vals = rng.standard_normal(rows.size)
    return sp.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    )


MATRICES = {
    "band1": lambda: banded(200, [0]),
    "band3": lambda: banded(200, [0, 1, -1]),
    "band5": lambda: banded(200, [0, 3, -3, 40, -40]),
    "random250": lambda: random_sym(250, 0.03, seed=6),
    "random300": lambda: random_sym(300, 0.05, seed=6),
    "skewed400": lambda: skewed_sym(400, seed=7),
    "messy": lambda: messy_sym(),
    "dupcoo": lambda: duplicate_coo(),
    "dupband": lambda: duplicate_band(),
}
# DIA takes at most 256 populated diagonals
DIA_MATRICES = ["band1", "band3", "band5", "dupband"]

PAIRS = {
    "dia": (jdia.DiaOperator, tdia.DiaOperator),
    "ell": (jell.SparseEllOperator, tell.SparseEllOperator),
    "coo": (jcoo.CooOperator, tcoo.CooOperator),
    "hyb": (jcoo.HybOperator, tcoo.HybOperator),
}


def _X(n, b, seed):
    return np.random.default_rng(seed).standard_normal((n, b))


def _cases():
    for fmt in PAIRS:
        names = DIA_MATRICES if fmt == "dia" else sorted(set(MATRICES) - {"dupband"})
        for name in names:
            yield fmt, name


@pytest.mark.parametrize("fmt,name", list(_cases()))
def test_apply_and_diagonal_match_jax(fmt, name):
    A = MATRICES[name]()
    J, T = PAIRS[fmt]
    jop = J.from_scipy(A, dtype=np.float64)
    top = T.from_scipy(A, dtype=torch.float64, device=CPU)
    assert top.shape == tuple(jop.shape) and top.dtype == torch.float64
    X = _X(A.shape[0], 5, 1)
    want = np.asarray(jop.apply(jnp.asarray(X)))
    got = top.apply(torch.from_numpy(X)).numpy()
    assert rel_err(got, want) < TOL
    assert rel_err(got, A @ X) < TOL
    assert rel_err(top.diagonal().numpy(), np.asarray(jop.diagonal())) < TOL
    assert top.nnz == jop.nnz


def _jax_arrays(fmt, jop):
    if fmt == "dia":
        return {"data": jop.data}, {"offsets": jop.offsets, "_n": jop._n}
    if fmt == "ell":
        return {"cols": jop.cols, "vals": jop.vals}, {"_n": jop._n}
    if fmt == "coo":
        return ({"rows": jop.rows, "cols": jop.cols, "vals": jop.vals},
                {"_n": jop._n, "_chunk": jop._chunk})
    return ({"ell_cols": jop.ell.cols, "ell_vals": jop.ell.vals,
             "coo_rows": jop.coo.rows, "coo_cols": jop.coo.cols,
             "coo_vals": jop.coo.vals}, {"_n": jop.ell._n})


@pytest.mark.parametrize("fmt,name", [("dia", "band5"), ("dia", "dupband"),
                                      ("ell", "messy"), ("ell", "dupcoo"),
                                      ("coo", "random300"), ("coo", "dupcoo"),
                                      ("hyb", "skewed400"), ("hyb", "messy")])
def test_converter_arrays_equal_jax(fmt, name):
    """from_scipy builds the JAX operator's arrays exactly, and the JAX
    operator's own arrays (operator_from_arrays) apply the same in the
    port."""
    A = MATRICES[name]()
    J, T = PAIRS[fmt]
    jop = J.from_scipy(A, dtype=np.float64)
    top = T.from_scipy(A, dtype=torch.float64, device=CPU)
    arrays, static = _jax_arrays(fmt, jop)
    mine, _ = _jax_arrays(fmt, top)
    for key in arrays:
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(arrays[key]))
        assert np.asarray(mine[key]).dtype == np.asarray(arrays[key]).dtype, key
    conv = operator_from_arrays(type(top).__name__,
                                {k: np.asarray(v) for k, v in arrays.items()},
                                static, CPU)
    X = _X(A.shape[0], 3, 2)
    want = np.asarray(jop.apply(jnp.asarray(X)))
    assert rel_err(conv.apply(torch.from_numpy(X)).numpy(), want) < TOL


def test_dia_guard_and_count_diagonals():
    A = random_sym(300, 0.5, seed=2)
    with pytest.raises(ValueError):
        tdia.DiaOperator.from_scipy(A, max_diags=16, device=CPU)
    for name in ("band3", "random300", "messy"):
        M = MATRICES[name]()
        assert tdia.count_diagonals(M) == jdia.count_diagonals(M)


def test_coo_chunked_matches_unchunked():
    import dataclasses

    A = random_sym(300, 0.05, seed=6)
    op = tcoo.CooOperator.from_scipy(A, dtype=torch.float64, device=CPU)
    small = dataclasses.replace(op, _chunk=1024)
    assert op.rows.shape[0] > 1024
    X = torch.from_numpy(_X(300, 4, 2))
    assert rel_err(small.apply(X).numpy(), op.apply(X).numpy()) < TOL


def test_ell_slot_chunks_match_one_chunk(monkeypatch):
    A = messy_sym()
    op = tell.SparseEllOperator.from_scipy(A, dtype=torch.float64, device=CPU)
    X = torch.from_numpy(_X(A.shape[0], 3, 3))
    whole = op.apply(X).numpy()
    monkeypatch.setattr(tell, "_GATHER_BYTES", 1)  # one slot per chunk
    assert rel_err(op.apply(X).numpy(), whole) < TOL


def test_hyb_spills_like_jax():
    A = MATRICES["skewed400"]()
    jop = jcoo.HybOperator.from_scipy(A)
    top = tcoo.HybOperator.from_scipy(A, device=CPU)
    assert top.coo.nnz == jop.coo.nnz > 0
    assert top.ell.cols.shape[0] == jop.ell.cols.shape[0] < np.diff(A.indptr).max()
    assert top.nnz == A.nnz
    none = tcoo.HybOperator.from_scipy(random_sym(200, 0.05, seed=9),
                                       quantile=1.0, device=CPU)
    assert none.coo.nnz == 0


def test_bf16_input_accumulates_in_f32():
    """tests/test_sparse_formats.py:204 — bf16 X against f32 operators:
    the port, like the JAX package, sums in f32 (a bf16 sum over ~50
    products per row misses the tolerance by an order of magnitude)."""
    n, b = 256, 4
    A = banded(n, list(range(-24, 25)), seed=12)
    X = np.random.default_rng(12).standard_normal((n, b))
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    ref = A @ Xb.double().numpy()
    scale = np.abs(ref).max()
    for fmt in ("dia", "ell", "coo", "hyb"):
        J, T = PAIRS[fmt]
        top = T.from_scipy(A, dtype=torch.float32, device=CPU)
        out = top.apply(Xb)
        assert out.dtype == torch.bfloat16
        assert np.abs(out.double().numpy() - ref).max() < 3e-3 * scale, fmt
        jout = np.asarray(J.from_scipy(A, dtype=np.float32)
                          @ jnp.asarray(X, dtype=jnp.bfloat16), dtype=np.float64)
        assert np.abs(out.double().numpy() - jout).max() < 3e-3 * scale, fmt


ROUTE_MATRICES = {
    "diagonal": lambda: sp.diags(np.linspace(1.0, 2.0, 300)).tocsr(),
    "banded": lambda: banded(400, [0, 1, -1, 7, -7]),
    "fem6": lambda: fem_elasticity_3d(6),
    "random200": lambda: random_sym(200, 0.05, seed=0),
    "random400": lambda: random_sym(400, 0.05, seed=8),
    "skewed": lambda: skewed_sym(400, seed=10),
    "f32": lambda: random_sym(600, 0.05, seed=13).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(ROUTE_MATRICES))
def test_router_takes_the_jax_route_on_the_cpu(name):
    A = ROUTE_MATRICES[name]()
    for dtype in (None, np.float32):
        tdt = None if dtype is None else torch.float32
        assert tpick(A, tdt, torch.device(CPU)) == jpick(A, dtype)
    jtype = type(rbl_tpu.as_operator(A)).__name__
    assert type(rtt.as_operator(A, device=CPU)).__name__ == jtype


def test_router_prices_dia_against_bsr_on_cuda(monkeypatch):
    """On a CUDA device the router compares the two time models; the
    comparison runs here without a card (no operator is built)."""
    from rbl_tpu_torch.ops.spmm import operator as toperator

    A = fem_elasticity_3d(4)
    cuda = torch.device("cuda")
    monkeypatch.setattr(toperator, "_DIA_BYTES_PER_S", 1e30)  # free DIA
    assert tpick(A, torch.float32, cuda) == ("dia", None)
    monkeypatch.setattr(toperator, "_DIA_BYTES_PER_S", 1.0)   # costly DIA
    fmt, plan = tpick(A, torch.float64, cuda)
    assert fmt == "bsr" and plan == rtt.ops.spmm.bsr.pick_tile_plan(A)
    # bf16 has no CUDA kernel: the CPU route
    assert tpick(A, torch.bfloat16, cuda) == tpick(A, torch.bfloat16,
                                                   torch.device(CPU))


def test_torch_sparse_input_routes_through_scipy():
    A = MATRICES["band3"]()
    C = A.tocoo()
    ts = torch.sparse_coo_tensor(np.vstack([C.row, C.col]), C.data, A.shape)
    X = _X(A.shape[0], 2, 4)
    for T in (ts, ts.to_sparse_csr()):
        op = rtt.as_operator(T)
        assert isinstance(op, rtt.DiaOperator) and op.device.type == "cpu"
        assert rel_err(op.apply(torch.from_numpy(X)).numpy(), A @ X) < TOL
    with pytest.raises(TypeError):
        rtt.as_operator(torch.sparse_coo_tensor(
            np.zeros((2, 1), np.int64), np.ones((1, 3)), (4, 4, 3)))


@pytest.mark.parametrize("fmt", ["dia", "ell", "hyb", "coo", "bsr", "auto"])
def test_fem_solve_through_each_format(fmt):
    """fem6 (f64) through every layout, to the 1e-13 gate."""
    A = fem_elasticity_3d(6)
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU, format=fmt)
    res = rtt.rbl(op, 6, 4)
    w = np.linalg.eigvalsh(A.toarray())[::-1][:6]
    assert res.converged
    assert np.abs((res.eigenvalues - w) / w).max() < 1e-13


def test_from_dense_matches_from_scipy():
    A = MATRICES["random250"]()
    X = torch.from_numpy(_X(250, 2, 5))
    for T in (tell.SparseEllOperator, tcoo.CooOperator):
        dense = T.from_dense(A.toarray(), dtype=torch.float64, device=CPU)
        assert rel_err(dense.apply(X).numpy(), A @ X.numpy()) < TOL
