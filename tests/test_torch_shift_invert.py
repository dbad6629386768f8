"""Blocked MINRES and the shift-invert operator of the port on the CPU
(the twin of tests/test_shift_invert.py).

Step-level checks give both packages the same B and preconditioner: with
the stop test read every iteration (``DEFAULT_CHECK_EVERY`` patched to 1)
the port's MINRES
runs the JAX package's iterations and its solution agrees at 1e-12
relative; at the default cadence it is held to the dense solve.  Solves
compare eigenvalues, never vectors.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import jax.numpy as jnp

import rbl_tpu as rt
from rbl_tpu.ops.minres import ShiftInvertOperator as JaxSI
from rbl_tpu.ops.minres import block_minres as jax_block_minres
from rbl_tpu.ops.minres import jacobi_psolve as jax_jacobi_psolve

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu_torch.ops import minres as minres_mod
from rbl_tpu_torch.ops.minres import (
    ShiftInvertOperator,
    block_minres,
    block_minres_refined,
    default_inner_tol,
    jacobi_psolve,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scaled(n=400):
    """Wildly scaled diagonal + weak coupling: Jacobi equilibration
    collapses the iteration count."""
    d = np.logspace(0, 6, n)
    return (sp.diags(d) + sp.diags([np.ones(n - 1)] * 2, [-1, 1])).tocsr()


def _case(name):
    """(A as scipy, shift, preconditioner diagonal or None, columns)."""
    if name == "indefinite_diagonal":
        return sp.diags(np.arange(1.0, 201.0)).tocsr(), 37.3, None, 4
    if name == "jacobi_scaled":
        return _scaled(), 513.7, "jacobi", 3
    if name == "laplacian_interior":
        A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(300, 300)).tocsr()
        return A, 1.7, None, 2
    raise ValueError(name)


@pytest.mark.parametrize("name", ["indefinite_diagonal", "jacobi_scaled",
                                  "laplacian_interior"])
def test_block_minres_matches_jax(name, monkeypatch):
    A, sig, pc, b = _case(name)
    B = np.random.default_rng(0).standard_normal((A.shape[0], b))
    jop = rt.as_operator(A)
    top = rtt.as_operator(A, dtype=torch.float64, device=CPU)
    jps = tps = None
    if pc == "jacobi":
        jps = jax_jacobi_psolve(jop.diagonal() - sig)
        tps = jacobi_psolve(top.diagonal() - sig)
    Xj, (itj, _) = jax_block_minres(jop.apply, jnp.asarray(B), shift=sig,
                                    tol=1e-12, psolve=jps)
    with monkeypatch.context() as m:
        m.setattr(minres_mod, "DEFAULT_CHECK_EVERY", 1)
        X, (it, rel) = block_minres(top.apply, _t(B), shift=sig, tol=1e-12,
                                    psolve=tps)
    assert it == int(itj)
    assert rel_err(X.numpy(), Xj) < 1e-12
    # the default cadence runs at most DEFAULT_CHECK_EVERY − 1 iterations
    # more and lands on the solution as well
    Xd, (itd, reld) = block_minres(top.apply, _t(B), shift=sig, tol=1e-12,
                                   psolve=tps)
    Xtrue = np.linalg.solve(A.toarray() - sig * np.eye(A.shape[0]), B)
    assert itd >= it and float(reld.max()) < 1e-12
    assert np.abs(Xd.numpy() - Xtrue).max() < 1e-9 * np.abs(Xtrue).max()


def test_breakdown_columns_stay_finite():
    """Column 0: zero RHS (x = 0); column 1: an eigenvector (exact
    solution after one step) — neither may produce NaNs."""
    d = torch.arange(1.0, 201.0, dtype=torch.float64)
    B = torch.zeros((200, 2), dtype=torch.float64)
    B[5, 1] = 1.0
    X, (itn, relres) = block_minres(lambda V: d[:, None] * V, B, shift=37.3,
                                    tol=1e-12)
    assert bool(torch.isfinite(X).all())
    assert float(X[:, 0].abs().max()) == 0.0
    assert float(X[5, 1]) == pytest.approx(1.0 / (6.0 - 37.3), rel=1e-12)
    # an all-zero block converges before the first iteration
    _, (itz, _) = block_minres(lambda V: d[:, None] * V, B[:, :1], shift=1.5)
    assert itz == 0


def test_maxiter_caps_and_cadence_checks(monkeypatch):
    d = torch.arange(1.0, 201.0, dtype=torch.float64)
    B = torch.ones((200, 2), dtype=torch.float64)
    _, (itn, _) = block_minres(lambda V: d[:, None] * V, B, shift=37.3,
                               tol=1e-14, maxiter=5)
    assert itn == 5
    # the stop test is read only every DEFAULT_CHECK_EVERY iterations: the
    # count rounds up to the cadence, never past it
    counts = {}
    for c in (1, 4, 16):
        monkeypatch.setattr(minres_mod, "DEFAULT_CHECK_EVERY", c)
        _, (counts[c], _) = block_minres(lambda V: d[:, None] * V, B,
                                         shift=37.3, tol=1e-10)
    for c in (4, 16):
        assert counts[c] % c == 0 and counts[1] <= counts[c] < counts[1] + c


def test_jacobi_psolve_matches_jax():
    """The quantile-clamped T (torch.quantile against jnp.quantile, both
    linear interpolation)."""
    d = np.random.default_rng(1).standard_normal(333) * np.logspace(0, 3, 333)
    X = np.random.default_rng(2).standard_normal((333, 3))
    got = jacobi_psolve(_t(d))(_t(X)).numpy()
    want = np.asarray(jax_jacobi_psolve(jnp.asarray(d))(jnp.asarray(X)))
    assert rel_err(got, want) < 1e-15


def test_jacobi_cuts_iterations():
    A = _scaled()
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU)
    B = _t(np.random.default_rng(3).standard_normal((400, 3)))
    sig = 513.7
    _, (it0, _) = block_minres(op.apply, B, shift=sig, tol=1e-12)
    X1, (it1, _) = block_minres(op.apply, B, shift=sig, tol=1e-12,
                                psolve=jacobi_psolve(op.diagonal() - sig))
    res1 = op.apply(X1) - sig * X1 - B
    assert float(res1.abs().max()) < 1e-9
    assert it1 < 200 and it1 * 5 < it0


def test_zero_crossing_pencil_not_harmed():
    """d = diag(A) − σ·diag(M) crosses zero: the quantile clamp keeps the
    preconditioned solve at least as good as the unpreconditioned one AND
    accurate."""
    dA = np.linspace(1.0, 500.0, 500)
    A = sp.diags(dA).tocsr()
    M = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(500, 500)).tocsr()
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    sig = 0.5 * (w[300] + w[301])
    opA = rtt.as_operator(A, dtype=torch.float64, device=CPU)
    opM = rtt.as_operator(M, dtype=torch.float64, device=CPU)

    def f(V):
        return opA.apply(V) - sig * opM.apply(V)

    B = _t(np.random.default_rng(9).standard_normal((500, 2)))
    ps = jacobi_psolve(opA.diagonal() - sig * opM.diagonal())
    X1, (it1, _) = block_minres(f, B, tol=1e-11, psolve=ps)
    _, (it0, _) = block_minres(f, B, tol=1e-11)
    Xtrue = np.linalg.solve((A - sig * M).toarray(), B.numpy())
    assert np.max(np.abs(X1.numpy() - Xtrue)) < 1e-9
    assert it1 <= it0 + 50


@pytest.mark.parametrize("fmt", ["coo", "dia", "ell", "hyb", "bsr", "dense",
                                 "affine", "stencils"])
def test_diagonal_protocol(fmt):
    """Every operator the Jacobi tier meets reports its diagonal, equal to
    the JAX package's (matrix-free operators opt out)."""
    rng = np.random.default_rng(4)
    n = 150
    Ad = np.zeros((n, n))
    for off in range(-8, 9):
        v = rng.standard_normal(n - abs(off))
        v[np.abs(v) < 0.8] = 0.0
        Ad += np.diag(v, off)
    Ad = Ad + Ad.T
    np.fill_diagonal(Ad, rng.standard_normal(n) + 5.0)
    want = Ad.diagonal()
    if fmt == "dense":
        got = rtt.DenseOperator(_t(Ad)).diagonal().numpy()
    elif fmt == "affine":
        dop = rtt.DiagonalOperator(_t(want))
        got = rtt.AffineOperator.shift(dop, 2.0, -1.5).diagonal().numpy()
        want = 2.0 * want - 1.5
    elif fmt == "stencils":
        assert float(rtt.Laplacian2D(4, 4, device=CPU).diagonal()[0]) == 4.0
        assert float(rtt.Laplacian3D(3, 3, 3, device=CPU).diagonal()[0]) == 6.0
        assert rtt.FunctionOperator(fun=lambda X: X, _n=8, device=CPU).diagonal() is None
        return
    else:
        dt = torch.float32 if fmt == "bsr" else torch.float64
        got = rtt.as_operator(sp.csr_matrix(Ad), dtype=dt, device=CPU,
                              format=fmt).diagonal().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6 if fmt == "bsr" else 1e-14,
                               atol=0)


def _weak_coupling():
    d = np.logspace(0, 4, 250)
    return (sp.diags(d) + 0.5 * sp.diags([np.ones(249)] * 2, [-1, 1])).tocsr()


@pytest.mark.parametrize("precond", ["jacobi", "none"])
def test_shift_invert_apply_matches_jax(precond):
    A = _weak_coupling()
    B = np.random.default_rng(5).standard_normal((250, 2))
    sig = 97.3
    si = ShiftInvertOperator.shift(rtt.as_operator(A, dtype=torch.float64, device=CPU),
                                   sig, inner_tol=1e-12, precond=precond)
    jsi = JaxSI.shift(rt.as_operator(A), sig, inner_tol=1e-12, precond=precond)
    got = si.apply(_t(B)).numpy()
    want = np.asarray(jsi.apply(jnp.asarray(B)))
    Xtrue = np.linalg.solve(A.toarray() - sig * np.eye(250), B)
    assert rel_err(got, Xtrue) < 1e-9 and rel_err(got, want) < 1e-9
    assert si.counts["applies"] == 1 and si.counts["iterations"] > 0
    assert si.sigma.ndim == 0 and si.sigma.dtype == torch.float64


def test_direct_construction_resolves_auto_once():
    """A directly constructed operator resolves "auto" from its 0-d sigma;
    a psolve given explicitly wins over everything but the exact FDM."""
    d = rtt.DiagonalOperator(torch.linspace(1.0, 100.0, 500, dtype=torch.float64))
    si = ShiftInvertOperator(base=d, sigma=torch.tensor(0.0, dtype=torch.float64))
    assert si.precond == "jacobi"
    calls = []

    def ps(X):
        calls.append(X.shape)
        return X

    si = ShiftInvertOperator(base=d, sigma=torch.tensor(10.5, dtype=torch.float64),
                             psolve=ps, inner_tol=1e-12)
    Y = si.apply(torch.ones((500, 2), dtype=torch.float64))
    np.testing.assert_allclose(Y.numpy()[:, 0], 1.0 / (np.linspace(1, 100, 500) - 10.5),
                               rtol=1e-9)
    assert calls and calls[0] == (500, 2)
    lap = rtt.Laplacian2D(16, 16, dtype=torch.float64, device=CPU)
    si = ShiftInvertOperator(base=lap, sigma=torch.tensor(0.0, dtype=torch.float64),
                             psolve=ps)
    assert si.precond == "fdm" and si.apply(torch.ones((256, 1), dtype=torch.float64)).shape == (256, 1)
    with pytest.raises(ValueError, match="inner_precision"):
        ShiftInvertOperator.shift(d, 0.0, inner_precision="bogus")


def test_sm_solve_tridiagonal_laplacian():
    """which="SM" as rbl on the σ = 0 transform: 1/θ against scipy."""
    lp = sp.diags([-1, 2.0, -1], [-1, 0, 1], shape=(400, 400)).tocsr()
    op = rtt.as_operator(lp, dtype=torch.float64, device=CPU)
    si = ShiftInvertOperator.shift(op, 0.0, inner_tol=default_inner_tol(torch.float64, 1e-8))
    res = rtt.rbl(si, 4, 4, cfg=rtt.RBLConfig(tol=1e-8))
    w = np.sort(1.0 / res.eigenvalues)
    ws = np.sort(sla.eigsh(lp, k=4, which="SM", return_eigenvectors=False))
    np.testing.assert_allclose(w, ws, rtol=1e-8)
    V = res.eigenvectors.numpy()
    r = lp @ V - V * (1.0 / res.eigenvalues)
    assert np.max(np.abs(r)) < 1e-6


@pytest.mark.parametrize("side", ["nearest", "above", "below"])
def test_interior_sigma_on_a_diagonal(side):
    """LM of OP = nearest σ; the sign of θ splits the sides."""
    A = sp.diags(np.arange(1.0, 201.0)).tocsr()
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU)
    sig = 50.4
    si = ShiftInvertOperator.shift(op, sig, inner_tol=1e-12)
    which = {"nearest": "LM", "above": "LA", "below": "SA"}[side]
    res = rtt.rbl(si, 3, 3, cfg=rtt.RBLConfig(tol=1e-9), which=which)
    lam = np.sort(sig + 1.0 / res.eigenvalues)
    want = {"nearest": [49.0, 50.0, 51.0], "above": [51.0, 52.0, 53.0],
            "below": [48.0, 49.0, 50.0]}[side]
    np.testing.assert_allclose(lam, want, rtol=1e-9)


def test_default_inner_tol_matches_jax():
    from rbl_tpu.ops.minres import default_inner_tol as jax_dit

    for tol in (1e-3, 1e-7, 1e-9, 1e-12):
        assert default_inner_tol(torch.float64, tol) == jax_dit(jnp.float64, tol)
        assert default_inner_tol(torch.float32, tol) == jax_dit(jnp.float32, tol)


class TestMixedPrecisionInner:
    """f32 MINRES + f64 defect correction (block_minres_refined), reached
    through ``inner_precision="mixed"``, must reach full-f64 inner
    accuracy; "auto" means "full" in the port."""

    def test_refined_matches_full_diag(self):
        d = torch.linspace(1.0, 500.0, 800, dtype=torch.float64)
        op = rtt.DiagonalOperator(d)
        B = _t(np.random.default_rng(0).standard_normal((800, 3)))
        sigma = 123.4
        X, (it, rel) = block_minres_refined(op.apply, B, shift=sigma, tol=1e-12)
        R = (op.apply(X) - sigma * X - B).numpy()
        assert np.linalg.norm(R) < 1e-10 * np.linalg.norm(B.numpy())
        assert 1 <= it <= 8 and float(rel.max()) < 1e-12
        Ym = ShiftInvertOperator.shift(op, sigma, inner_precision="mixed").apply(B)
        Yf = ShiftInvertOperator.shift(op, sigma, inner_precision="full").apply(B)
        Ya = ShiftInvertOperator.shift(op, sigma).apply(B)
        np.testing.assert_allclose(Ym.numpy(), Yf.numpy(), rtol=1e-8, atol=1e-10)
        assert torch.equal(Ya, Yf)

    def test_refined_generalized_fem(self):
        from rbl_tpu_torch.ops.generalized import GeneralizedShiftInvertOperator
        from rbl_tpu_torch.utils.fem import fem_elasticity_3d

        A = fem_elasticity_3d(4)
        n = A.shape[0]
        m = np.abs(np.asarray(A.sum(axis=1)).ravel()) + 0.1
        opA = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="ell")
        B = _t(np.random.default_rng(1).standard_normal((n, 2)))
        outs = {}
        for label in ("mixed", "full"):
            W = GeneralizedShiftInvertOperator(
                A=opA, M=rtt.DiagonalOperator(_t(m)),
                msqrt=rtt.DiagonalOperator(_t(np.sqrt(m))),
                sigma=torch.tensor(0.0, dtype=torch.float64),
                inner_tol=1e-11, inner_precision=label,
            )
            outs[label] = W.apply(B).numpy()
        np.testing.assert_allclose(outs["mixed"], outs["full"], rtol=1e-7, atol=1e-9)
