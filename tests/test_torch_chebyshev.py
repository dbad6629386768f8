"""The Chebyshev filters of the port (ops/chebyshev.py) against the JAX
package's on the same seeded block, and against their scalar oracles on a
diagonal operator, on the CPU.  f64: 1e-12 relative between the packages
(columns normalised for the product form, which is defined up to a
positive scale a column), 1e-10 against the oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.ops import chebyshev as jcheb

import rbl_tpu_torch as rtt
from _torch_parity import CPU, random_sym, rel_err
from rbl_tpu_torch.ops import chebyshev as tcheb

DEGREES = (1, 2, 24)


def _matrix_and_block(n=300, b=4, seed=5):
    A = random_sym(n, 0.05, seed=seed).toarray()
    A = A / np.abs(np.linalg.eigvalsh(A)).max()  # spectrum in [-1, 1]
    X = np.random.default_rng(seed).standard_normal((n, b))
    return A, X


def _unit_columns(Y):
    Y = np.asarray(Y, dtype=np.float64)
    return Y / np.linalg.norm(Y, axis=0)


@pytest.mark.parametrize("degree", DEGREES)
def test_scaled_filter_matches_jax(degree):
    A, X = _matrix_and_block()
    a, b, g = -1.05, 0.6, 1.05
    jop = jcheb.ChebyshevFilterOperator.make(
        rbl_tpu.DenseOperator(jnp.asarray(A)), a, b, g, degree=degree)
    top = tcheb.ChebyshevFilterOperator.make(
        rtt.DenseOperator(torch.from_numpy(A)), a, b, g, degree=degree)
    assert top.shape == (300, 300) and top.dtype == torch.float64
    assert top.device.type == "cpu" and top.a.ndim == 0
    Yt = top.apply(torch.from_numpy(X)).numpy()
    assert rel_err(Yt, jop.apply(jnp.asarray(X))) < 1e-12
    # the operator IS the polynomial of its scalar oracle: p(A) = U p(Λ) Uᵀ
    w, U = np.linalg.eigh(A)
    assert rel_err(Yt, (U * top.scalar(w)) @ (U.T @ X)) < 1e-10
    np.testing.assert_allclose(top.scalar(w), jop.scalar(w), rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("degree", DEGREES)
def test_product_filter_matches_jax(degree):
    A, X = _matrix_and_block(seed=6)
    a, b = -1.05, 0.6
    jop = jcheb.ChebyshevProductFilter.make(
        rbl_tpu.DenseOperator(jnp.asarray(A)), a, b, degree=degree)
    top = tcheb.ChebyshevProductFilter.make(
        rtt.DenseOperator(torch.from_numpy(A)), a, b, degree=degree)
    Yt = top.apply(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(np.linalg.norm(Yt, axis=0), 1.0, rtol=1e-12)
    assert rel_err(_unit_columns(Yt), _unit_columns(jop.apply(jnp.asarray(X)))) < 1e-12
    np.testing.assert_array_equal(top._unit_roots(), jop._unit_roots())


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("form", ["scaled", "product"])
def test_filters_match_their_scalar_oracles_on_a_diagonal(form, degree):
    """On diag(d) the filter acts entry by entry: column j of the output is
    p(d)·x_j (scaled form), or proportional to it (product form)."""
    d = np.linspace(-0.9, 1.0, 200)
    x = np.random.default_rng(1).standard_normal((200, 3))
    base = rtt.DiagonalOperator(torch.from_numpy(d))
    if form == "scaled":
        op = tcheb.ChebyshevFilterOperator.make(base, -1.0, 0.5, 1.0, degree=degree)
        Y = op.apply(torch.from_numpy(x)).numpy()
        assert rel_err(Y, op.scalar(d)[:, None] * x) < 1e-10
        assert abs(float(op.scalar(1.0)) - 1.0) < 1e-12       # p(γ) = 1
        assert np.abs(op.scalar(np.linspace(-1, 0.5, 50))).max() <= op.scalar(0.5) + 1e-12
    else:
        op = tcheb.ChebyshevProductFilter.make(base, -1.0, 0.5, degree=degree)
        Y = op.apply(torch.from_numpy(x)).numpy()
        assert rel_err(_unit_columns(Y), _unit_columns(op.scalar_direction(d)[:, None] * x)) < 1e-10


def test_leja_order_and_argument_checks():
    r = np.cos((2 * np.arange(1, 25) - 1) * np.pi / 48)
    np.testing.assert_array_equal(tcheb._leja_order(r), jcheb._leja_order(r))
    assert sorted(tcheb._leja_order(r)) == list(range(24))
    base = rtt.DiagonalOperator(torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="a < b < gamma"):
        tcheb.ChebyshevFilterOperator.make(base, 0.0, 1.0, 0.5)
    with pytest.raises(ValueError, match="degree"):
        tcheb.ChebyshevFilterOperator.make(base, 0.0, 0.5, 1.0, degree=0)
    with pytest.raises(ValueError, match="a < b"):
        tcheb.ChebyshevProductFilter.make(base, 1.0, 0.5)
    with pytest.raises(ValueError, match="degree"):
        tcheb.ChebyshevProductFilter.make(base, 0.0, 0.5, degree=0)


def test_filter_over_the_block_sparse_operator_and_in_f32():
    """The filter wraps any operator: on the packed block-sparse one (its
    plain version on the CPU) it matches the dense filter to 1e-12; cast to
    f32 (the polish's low-precision chain) it matches f64 to 1e-4."""
    from rbl_tpu_torch.ops.spmm.operator import cast_operator

    S = random_sym(260, 0.04, seed=2)
    S = S / np.abs(np.linalg.eigvalsh(S.toarray())).max()
    X = np.random.default_rng(2).standard_normal((260, 4))
    bsr = rtt.as_operator(S.tocsr(), dtype=torch.float64, device=CPU, format="bsr")
    dense = rtt.DenseOperator(torch.from_numpy(S.toarray()))
    Yb = tcheb.ChebyshevFilterOperator.make(bsr, -1.05, 0.5, 1.05, degree=12).apply(
        torch.from_numpy(X)).numpy()
    Yd = tcheb.ChebyshevFilterOperator.make(dense, -1.05, 0.5, 1.05, degree=12).apply(
        torch.from_numpy(X)).numpy()
    assert rel_err(Yb, Yd) < 1e-12
    f32 = cast_operator(tcheb.ChebyshevProductFilter.make(dense, -1.05, 0.5, degree=12),
                        torch.float32)
    assert f32.dtype == torch.float32 and f32.a.dtype == torch.float32
    Y32 = f32.apply(torch.from_numpy(X).float()).numpy()
    Y64 = tcheb.ChebyshevProductFilter.make(dense, -1.05, 0.5, degree=12).apply(
        torch.from_numpy(X)).numpy()
    assert rel_err(_unit_columns(Y32), _unit_columns(Y64)) < 1e-4
