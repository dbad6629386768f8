"""The Gram-side operators and ``rbl_svd`` of the port on the CPU: operator
applies against the JAX package's on the same seeded block (1e-13
relative, f64), solves against ``numpy.linalg.svd`` (singular values 1e-10
relative; vectors only through ‖B·V − U·diag(s)‖).  ``which="SM"``: the
smallest triplets through σ = 0 shift-invert, against numpy and the JAX
package (tests/test_svd.py's SM cases).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.ops.spmm.coo import RectCooOperator as JaxRectCoo

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu_torch.ops.spmm.coo import RectCooOperator
from rbl_tpu_torch.utils.convert import operator_from_arrays


def _factor(m=90, n=50, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n))


def _sparse_factor(m=400, n=150, seed=0):
    return sp.random(m, n, density=0.04, random_state=np.random.default_rng(seed),
                     format="csr")


@pytest.mark.parametrize("left", [False, True])
def test_gram_operator_matches_jax(left):
    B = _factor()
    side = B.shape[0] if left else B.shape[1]
    X = np.random.default_rng(1).standard_normal((side, 4))
    jop = rbl_tpu.GramOperator(B=jnp.asarray(B), left=left)
    top = rtt.GramOperator(B=torch.from_numpy(B), left=left)
    assert top.shape == (side, side) == tuple(jop.shape)
    assert rel_err(top.apply(torch.from_numpy(X)).numpy(), jop.apply(jnp.asarray(X))) < 1e-13
    assert rel_err(top.diagonal().numpy(), jop.diagonal()) < 1e-13
    G = B @ B.T if left else B.T @ B
    assert rel_err(top.apply(torch.from_numpy(X)).numpy(), G @ X) < 1e-13


@pytest.mark.parametrize("left", [False, True])
def test_sparse_gram_operator_matches_jax(left):
    S = _sparse_factor()
    side = S.shape[0] if left else S.shape[1]
    X = np.random.default_rng(2).standard_normal((side, 3))
    jop = rbl_tpu.SparseGramOperator.from_scipy(S, dtype=jnp.float64, left=left)
    top = rtt.SparseGramOperator.from_scipy(S, dtype=torch.float64, left=left, device=CPU)
    assert top.shape == (side, side) and top.dtype == torch.float64
    Yt = top.apply(torch.from_numpy(X)).numpy()
    assert rel_err(Yt, jop.apply(jnp.asarray(X))) < 1e-13
    assert rel_err(top.diagonal().numpy(), jop.diagonal()) < 1e-13
    G = (S @ S.T if left else S.T @ S).toarray()
    assert rel_err(Yt, G @ X) < 1e-13


def test_rect_coo_operator_matches_jax_and_transposes():
    S = _sparse_factor(seed=3)
    m, n = S.shape
    X = np.random.default_rng(3).standard_normal((n, 5))
    Z = np.random.default_rng(4).standard_normal((m, 5))
    jop = JaxRectCoo.from_scipy(S, dtype=jnp.float64)
    top = RectCooOperator.from_scipy(S, dtype=torch.float64, device=CPU)
    # the same padded, row-sorted triplets in both packages
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(top, f).numpy(), np.asarray(getattr(jop, f)))
    assert top.shape == (m, n) and top.nnz == S.nnz
    assert rel_err(top.apply(torch.from_numpy(X)).numpy(), jop.apply(jnp.asarray(X))) < 1e-13
    assert rel_err(top.apply(torch.from_numpy(X)).numpy(), S @ X) < 1e-13
    tt = top.T
    assert tt.shape == (n, m) and tt.device.type == "cpu"
    assert rel_err(tt.apply(torch.from_numpy(Z)).numpy(), S.T @ Z) < 1e-13
    assert rel_err(tt.apply(torch.from_numpy(Z)).numpy(),
                   jop.transpose().apply(jnp.asarray(Z))) < 1e-13
    # chunked scatter-add: the same answer with a chunk smaller than nnz
    small = RectCooOperator(rows=top.rows, cols=top.cols, vals=top.vals,
                            _m=m, _ncols=n, _chunk=500)
    assert rel_err(small.apply(torch.from_numpy(X)).numpy(), S @ X) < 1e-13


@pytest.mark.parametrize("kind", ["GramOperator", "RectCooOperator", "SparseGramOperator"])
def test_operator_from_arrays_builds_the_gram_side_operators(kind):
    """The JAX operators' array fields, as numpy, through utils.convert."""
    S = _sparse_factor(seed=5)
    B = _factor(seed=5)
    if kind == "GramOperator":
        jop = rbl_tpu.GramOperator(B=jnp.asarray(B), left=True)
        top = operator_from_arrays(kind, {"B": np.asarray(jop.B)}, {"left": jop.left}, CPU)
        X = np.random.default_rng(6).standard_normal((B.shape[0], 3))
    elif kind == "RectCooOperator":
        jop = JaxRectCoo.from_scipy(S, dtype=jnp.float64)
        arrays = {f: np.asarray(getattr(jop, f)) for f in ("rows", "cols", "vals")}
        top = operator_from_arrays(kind, arrays, {"_m": jop._m, "_ncols": jop._ncols,
                                                   "_chunk": jop._chunk}, CPU)
        X = np.random.default_rng(6).standard_normal((S.shape[1], 3))
    else:
        jop = rbl_tpu.SparseGramOperator.from_scipy(S, dtype=jnp.float64)
        arrays = {f"{p}_{f}": np.asarray(getattr(getattr(jop, P), f))
                  for p, P in (("bf", "Bf"), ("bt", "Bt")) for f in ("rows", "cols", "vals")}
        top = operator_from_arrays(kind, arrays, {"_m": jop.Bf._m, "_ncols": jop.Bf._ncols,
                                                   "left": jop.left}, CPU)
        X = np.random.default_rng(6).standard_normal((S.shape[1], 3))
    assert rel_err(top.apply(torch.from_numpy(X)).numpy(), jop.apply(jnp.asarray(X))) < 1e-13


def _decaying(m, n, seed=0, rate=0.8):
    rng = np.random.default_rng(seed)
    r = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, r)))
    V, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return (U * rate ** np.arange(r)) @ V.T


@pytest.mark.parametrize("shape", [(300, 60), (60, 300)], ids=["tall", "wide"])
def test_svd_dense_against_numpy_and_jax(shape):
    """Tall solves BᵀB and recovers U; wide solves B·Bᵀ and recovers V.
    Singular values 1e-10 relative against numpy and the JAX package."""
    B = _decaying(*shape)
    k = 6
    s = np.linalg.svd(B, compute_uv=False)[:k]
    res = rtt.rbl_svd(B, k, 4, cfg=rtt.RBLConfig(device=CPU))
    jres = rbl_tpu.rbl_svd(B, k, 4)
    assert res.converged and isinstance(res, rtt.SVDResult)
    np.testing.assert_allclose(res.s, s, rtol=1e-10)
    np.testing.assert_allclose(res.s, jres.s, rtol=1e-10)
    U, V = res.U.numpy(), res.V.numpy()
    assert U.shape == (shape[0], k) and V.shape == (shape[1], k)
    assert np.abs(B @ V - U * res.s).max() < 1e-10
    assert np.abs(U.T @ U - np.eye(k)).max() < 1e-8
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-8


def test_svd_sparse_keeps_the_factor_sparse():
    S = _sparse_factor(600, 200, seed=7)
    k = 5
    s = np.linalg.svd(S.toarray(), compute_uv=False)[:k]
    res = rtt.rbl_svd(S, k, 4, cfg=rtt.RBLConfig(device=CPU, tol=1e-9))
    assert res.converged
    np.testing.assert_allclose(res.s, s, rtol=1e-10)
    assert np.abs(S @ res.V.numpy() - res.U.numpy() * res.s).max() < 1e-9
    # a torch tensor keeps its own device and takes the dense route
    rt2 = rtt.rbl_svd(torch.from_numpy(S.toarray()), k, 4, cfg=rtt.RBLConfig(tol=1e-9))
    np.testing.assert_allclose(rt2.s, s, rtol=1e-10)


def test_svd_clamps_the_null_space_and_checks_arguments():
    """A rank-3 factor asked for 5 triplets: σ₄, σ₅ sit under the
    normal-equations floor, come back as exact zeros with zeroed cross
    columns, and s is descending."""
    rng = np.random.default_rng(8)
    B = rng.standard_normal((80, 3)) @ rng.standard_normal((3, 40))
    res = rtt.rbl_svd(B, 5, 2, cfg=rtt.RBLConfig(device=CPU))
    s = np.linalg.svd(B, compute_uv=False)
    np.testing.assert_allclose(res.s[:3], s[:3], rtol=1e-9)
    assert np.all(res.s[3:] == 0.0) and np.all(np.diff(res.s) <= 0)
    assert not res.U.numpy()[:, 3:].any()
    with pytest.raises(ValueError, match="which"):
        rtt.rbl_svd(B, 2, which="LA")
    with pytest.raises(ValueError, match="out of range"):
        rtt.rbl_svd(B, 41, cfg=rtt.RBLConfig(device=CPU))
    with pytest.raises(ValueError, match="2-D"):
        rtt.rbl_svd(np.ones(5), 1, cfg=rtt.RBLConfig(device=CPU))


def _spread(m, n, seed=4):
    """A dense factor with singular values spread over [1, 10]."""
    rng = np.random.default_rng(seed)
    r = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, r)))
    V, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s = np.linspace(10.0, 1.0, r)
    return (U * s) @ V.T, s


@pytest.mark.parametrize("shape", [(90, 60), (60, 90)], ids=["tall", "wide"])
def test_svd_smallest_which_sm(shape):
    B, s_true = _spread(*shape)
    k = 5
    res = rtt.rbl_svd(B, k, 4, cfg=rtt.RBLConfig(device=CPU), which="SM")
    jres = rbl_tpu.rbl_svd(B, k, b=4, which="SM")
    s_small = np.sort(s_true)[:k]
    np.testing.assert_allclose(np.sort(res.s), s_small, rtol=1e-8)
    np.testing.assert_allclose(np.sort(res.s), np.sort(jres.s), rtol=1e-8)
    assert np.all(np.diff(res.s) <= 0)  # descending, as the LM path
    U, s, V = res.U.numpy(), res.s, res.V.numpy()
    assert U.shape == (shape[0], k) and V.shape == (shape[1], k)
    assert np.abs(U.T @ U - np.eye(k)).max() < 1e-8
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-8
    r1 = np.linalg.norm(B @ V - U * s[None, :], axis=0)
    r2 = np.linalg.norm(B.T @ U - V * s[None, :], axis=0)
    assert max(r1.max(), r2.max()) < 1e-6 * s_true[0]


def test_svd_sm_sparse_factor():
    """The SM path on a sparse factor keeps B sparse (SparseGramOperator +
    Jacobi-preconditioned inner MINRES through its diagonal)."""
    rng = np.random.default_rng(13)
    B = (sp.random(80, 80, density=0.1, random_state=rng) + 3.0 * sp.eye(80)).tocsr()
    res = rtt.rbl_svd(B, 4, 4, cfg=rtt.RBLConfig(device=CPU), which="sm")
    s_true = np.sort(np.linalg.svd(B.toarray(), compute_uv=False))[:4]
    np.testing.assert_allclose(np.sort(res.s), s_true, rtol=1e-7)
    U, V = res.U.numpy(), res.V.numpy()
    assert np.abs(B @ V - U * res.s).max() < 1e-6 * s_true[-1]


def test_function_operator_solves_matrix_free():
    d = torch.arange(1.0, 201.0, dtype=torch.float64)
    op = rtt.FunctionOperator(fun=lambda X: d[:, None] * X, _n=200,
                              dtype=torch.float64, device=CPU)
    assert op.shape == (200, 200) and op.device.type == "cpu"
    res = rtt.rbl(op, 4, 4)
    np.testing.assert_allclose(res.eigenvalues, [200.0, 199.0, 198.0, 197.0], rtol=1e-10)
