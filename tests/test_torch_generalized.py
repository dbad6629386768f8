"""Generalized eigenproblems A·x = λ·M·x of the port on the CPU
(ops/generalized.py, solver/generalized.py) — the twin of
tests/test_generalized.py.

Series fits are the same numpy in both packages; a series apply and the
pencil operators are held against the JAX package's on the same seeded
block at 1e-12 relative (the series carried across by
``utils.convert.series_from_arrays``).  Solves compare eigenvalues with the
dense oracle and check M-orthonormality and true pencil residuals.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu as rt
from rbl_tpu.ops import generalized as jgen

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu_torch.ops.generalized import (
    ChebyshevSeriesOperator,
    GeneralizedShiftInvertOperator,
    PencilOperator,
    chebyshev_fit,
    fit_to_tolerance,
)
from rbl_tpu_torch.solver.generalized import rbl_generalized
from rbl_tpu_torch.utils.convert import series_from_arrays

F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(**kw):
    return rtt.RBLConfig(device=CPU, **kw)


def _fem1d(n):
    """1D FEM stiffness/mass pencil on (0,1): eigenvalues ≈ (kπ)²."""
    h = 1.0 / (n + 1)
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr() / h
    M = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).tocsr() * (h / 6)
    return A, M


def _wellcond(n=300):
    dA = np.linspace(1.0, 500.0, n)
    A = sp.diags(dA).tocsr()
    M = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(n, n)).tocsr()
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    return A, M, w


class TestChebyshevSeries:
    def test_fit_reproduces_polynomial_exactly(self):
        c = chebyshev_fit(lambda t: 2 * t**3 - t + 0.5, 1.0, 4.0, 3)
        np.testing.assert_array_equal(
            c, jgen.chebyshev_fit(lambda t: 2 * t**3 - t + 0.5, 1.0, 4.0, 3))
        op = ChebyshevSeriesOperator.from_coeffs(
            rtt.DiagonalOperator(torch.linspace(1.0, 4.0, 50, dtype=F64)), c, 1.0, 4.0)
        assert op.degree == 3
        t = np.linspace(1.0, 4.0, 200)
        np.testing.assert_allclose(op.scalar(t), 2 * t**3 - t + 0.5, rtol=1e-12, atol=1e-12)

    def test_inv_sqrt_fit_accuracy_and_apply(self):
        d = np.linspace(0.5, 8.0, 300)
        op = ChebyshevSeriesOperator.inv_sqrt(rtt.DiagonalOperator(_t(d)), 0.4, 8.5,
                                              rel_tol=1e-11)
        t = np.linspace(0.4, 8.5, 3000)
        assert np.max(np.abs(op.scalar(t) * np.sqrt(t) - 1.0)) < 1e-11
        Y = op.apply(torch.ones((300, 1), dtype=F64)).numpy()[:, 0]
        np.testing.assert_allclose(Y, op.scalar(d), rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("fun", ["inv_sqrt", "sqrt"])
    def test_series_apply_matches_jax(self, fun):
        """The JAX series' coefficients and domain carried across: one
        apply on a tridiagonal M at 1e-12."""
        M = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(200, 200)).tocsr()
        jop = getattr(jgen.ChebyshevSeriesOperator, fun)(rt.as_operator(M), 1.3, 2.7,
                                                         rel_tol=1e-12)
        top = series_from_arrays(rtt.as_operator(M, dtype=F64, device=CPU),
                                 np.asarray(jop.coeffs), float(jop.lo), float(jop.hi))
        mine = getattr(ChebyshevSeriesOperator, fun)(
            rtt.as_operator(M, dtype=F64, device=CPU), 1.3, 2.7, rel_tol=1e-12)
        assert top.degree == mine.degree == jop.degree
        np.testing.assert_array_equal(mine.coeffs.numpy(), np.asarray(jop.coeffs))
        X = np.random.default_rng(0).standard_normal((200, 3))
        want = np.asarray(jop.apply(jnp.asarray(X)))
        assert rel_err(top.apply(_t(X)).numpy(), want) < 1e-12
        assert rel_err(mine.apply(_t(X)).numpy(), want) < 1e-12

    def test_fit_to_tolerance_matches_jax_and_grows_with_kappa(self):
        f = lambda t: 1 / np.sqrt(t)  # noqa: E731
        c_easy, e_easy = fit_to_tolerance(f, 1.0, 4.0, rel_tol=1e-10)
        c_hard, _ = fit_to_tolerance(f, 0.01, 4.0, rel_tol=1e-10)
        assert len(c_hard) > 2 * len(c_easy)
        jc, je = jgen.fit_to_tolerance(f, 1.0, 4.0, rel_tol=1e-10)
        np.testing.assert_array_equal(c_easy, jc)
        assert e_easy == je

    def test_fit_errors_raise(self):
        with pytest.raises(ValueError, match="cannot reach"):
            fit_to_tolerance(lambda t: 1 / np.sqrt(t), 1e-9, 1.0, rel_tol=1e-12,
                             max_degree=30)
        op = rtt.DiagonalOperator(torch.linspace(1.0, 4.0, 10, dtype=F64))
        with pytest.raises(ValueError, match="positive definite"):
            ChebyshevSeriesOperator.inv_sqrt(op, -0.5, 4.0)
        with pytest.raises(ValueError, match="positive definite"):
            ChebyshevSeriesOperator.sqrt(op, 0.0, 4.0)
        with pytest.raises(ValueError, match="lo < hi"):
            chebyshev_fit(np.sqrt, 2.0, 1.0, 3)

    def test_pencil_operator_is_symmetric_and_matches_jax(self):
        rng = np.random.default_rng(0)
        Ad = rng.standard_normal((40, 40))
        Ad = Ad + Ad.T
        Md = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(40, 40)).toarray()
        P = ChebyshevSeriesOperator.inv_sqrt(rtt.DenseOperator(_t(Md)), 1.0, 3.0,
                                              rel_tol=1e-12)
        S = PencilOperator(A=rtt.DenseOperator(_t(Ad)), P=P)
        Sd = S.apply(torch.eye(40, dtype=F64)).numpy()
        np.testing.assert_allclose(Sd, Sd.T, atol=1e-12)
        jP = jgen.ChebyshevSeriesOperator.inv_sqrt(rt.DenseOperator(jnp.asarray(Md)),
                                                   1.0, 3.0, rel_tol=1e-12)
        jS = jgen.PencilOperator(A=rt.DenseOperator(jnp.asarray(Ad)), P=jP)
        assert rel_err(Sd, np.asarray(jS.apply(jnp.eye(40)))) < 1e-12


class TestRblGeneralized:
    @pytest.mark.parametrize("which", ["SA", "LA", "LM"])
    def test_wellconditioned_whiches(self, which):
        A, M, w = _wellcond()
        res = rbl_generalized(A, M, 5, cfg=_cfg(block_size=5, tol=1e-9), which=which)
        exact = w[:5] if which == "SA" else w[::-1][:5]
        assert res.converged
        assert np.max(np.abs(res.eigenvalues - exact) / np.abs(exact)) < 1e-12
        V = res.eigenvectors.numpy()
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(5))) < 1e-10
        R = A @ V - (M @ V) * res.eigenvalues[None, :]
        assert np.max(np.linalg.norm(R, axis=0)) < 1e-7

    def test_fem_pencil_largest_modes(self):
        A, M = _fem1d(300)
        w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
        res, info = rbl_generalized(A, M, 6, cfg=_cfg(block_size=6, tol=1e-4),
                                    which="LA", return_info=True)
        assert res.converged
        assert np.max(np.abs(res.eigenvalues - w[::-1][:6]) / w[::-1][:6]) < 1e-11
        assert info.degree > 0
        lo, hi = info.m_bounds
        assert 0 < lo < hi

    def test_diagonal_mass_fast_path_exact(self):
        a = np.linspace(3.0, 900.0, 600)
        m = np.linspace(0.5, 2.0, 600)
        res, info = rbl_generalized(sp.diags(a).tocsr(), rtt.DiagonalOperator(_t(m)), 4,
                                    cfg=_cfg(block_size=4, tol=1e-10), which="LA",
                                    return_info=True)
        assert info.degree == 0 and info.approx_err == 0.0
        np.testing.assert_allclose(res.eigenvalues, np.sort(a / m)[::-1][:4], rtol=1e-12)

    def test_explicit_degree_and_bounds(self):
        A, M, w = _wellcond()
        res, info = rbl_generalized(A, M, 3, cfg=_cfg(block_size=3, tol=1e-8),
                                    which="LA", m_bounds=(0.5, 3.2), degree=20,
                                    return_info=True)
        assert info.degree == 20 and info.m_bounds == (0.5, 3.2)
        np.testing.assert_allclose(res.eigenvalues, w[::-1][:3], rtol=1e-10)

    def test_low_degree_demotes_converged(self):
        A, M, _ = _wellcond()
        res = rbl_generalized(A, M, 3, cfg=_cfg(block_size=3, tol=1e-10), which="LA",
                              m_bounds=(0.5, 3.2), degree=2)
        assert not res.converged and np.max(res.residual_bounds) > 1e-8

    @pytest.mark.parametrize("case", ["diagonal", "series"])
    def test_indefinite_m_raises(self, case):
        A = sp.diags(np.linspace(1.0, 10.0, 200)).tocsr()
        if case == "diagonal":
            with pytest.raises(ValueError, match="non-positive diagonal"):
                rbl_generalized(A, rtt.DiagonalOperator(torch.linspace(-1.0, 2.0, 200,
                                                                       dtype=F64)),
                                2, cfg=_cfg())
        else:
            Mind = sp.diags([0.3, 0.1, 0.3], [-1, 0, 1], shape=(200, 200)).tocsr()
            with pytest.raises(ValueError, match="positive definite"):
                rbl_generalized(A, Mind, 2, cfg=_cfg())

    def test_argument_checks(self):
        A = sp.eye(100).tocsr()
        with pytest.raises(ValueError, match="shapes differ"):
            rbl_generalized(A, sp.eye(80).tocsr(), 2, cfg=_cfg())
        with pytest.raises(ValueError, match="out of range"):
            rbl_generalized(A, sp.eye(100).tocsr(), 0, cfg=_cfg())
        with pytest.raises(ValueError, match="which"):
            rbl_generalized(A, sp.eye(100).tocsr(), 2, which="BE", cfg=_cfg())
        with pytest.raises(ValueError, match="requires sigma"):
            rbl_generalized(A, A, 2, mode="buckling", cfg=_cfg())
        with pytest.raises(ValueError, match="nonzero sigma"):
            rbl_generalized(A, A, 2, mode="cayley", sigma=0.0, cfg=_cfg())
        with pytest.raises(ValueError, match="mode="):
            rbl_generalized(A, A, 2, mode="bogus", cfg=_cfg())

    def test_needs_a_card_unless_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        A = sp.diags(np.arange(1.0, 41.0)).tocsr()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            rbl_generalized(A, sp.eye(40).tocsr(), 2)


class TestGeneralizedShiftInvert:
    """sigma: interior pencil eigenvalues via the factorization-free mode-3
    transform W = M^{1/2}·(A − σM)^{−1}·M^{1/2}."""

    def test_operator_is_symmetric_and_matches_jax(self):
        rng = np.random.default_rng(1)
        Ad = rng.standard_normal((30, 30))
        Ad = Ad + Ad.T
        Md = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(30, 30)).toarray()
        jPs = jgen.ChebyshevSeriesOperator.sqrt(rt.DenseOperator(jnp.asarray(Md)),
                                                1.0, 3.0, rel_tol=1e-12)
        Ps = series_from_arrays(rtt.DenseOperator(_t(Md)), np.asarray(jPs.coeffs),
                                1.0, 3.0)
        W = GeneralizedShiftInvertOperator(
            A=rtt.DenseOperator(_t(Ad)), M=rtt.DenseOperator(_t(Md)), msqrt=Ps,
            sigma=torch.tensor(0.37, dtype=F64), inner_tol=1e-12)
        Wd = W.apply(torch.eye(30, dtype=F64)).numpy()
        np.testing.assert_allclose(Wd, Wd.T, atol=1e-9)
        w_pencil = scipy.linalg.eigh(Ad, Md, eigvals_only=True)
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(Wd)),
                                   np.sort(1.0 / (w_pencil - 0.37)), rtol=1e-7, atol=1e-9)
        jW = jgen.GeneralizedShiftInvertOperator(
            A=rt.DenseOperator(jnp.asarray(Ad)), M=rt.DenseOperator(jnp.asarray(Md)),
            msqrt=jPs, sigma=jnp.asarray(0.37), inner_tol=1e-12)
        assert rel_err(Wd, np.asarray(jW.apply(jnp.eye(30)))) < 1e-9
        assert W.counts["applies"] == 1

    def test_sigma_nearest_interior(self):
        A, M, w = _wellcond(100)
        sig = w[40] + 0.3 * (w[41] - w[40])
        res = rbl_generalized(A, M, 4, cfg=_cfg(block_size=4, tol=1e-9), which="LM",
                              sigma=sig)
        assert res.converged
        exact = w[np.argsort(np.abs(w - sig), kind="stable")[:4]]
        np.testing.assert_allclose(res.eigenvalues, exact, rtol=1e-10)
        V = res.eigenvectors.numpy()
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(4))) < 1e-8
        R = A @ V - (M @ V) * res.eigenvalues[None, :]
        assert np.max(np.linalg.norm(R, axis=0)) < 1e-6

    @pytest.mark.parametrize("which", ["LA", "SA"])
    def test_sigma_sides(self, which):
        A, M, w = _wellcond(100)
        sig = 0.5 * (w[60] + w[61])
        want = w[w > sig][:3] if which == "LA" else w[w < sig][-3:][::-1]
        res = rbl_generalized(A, M, 3, cfg=_cfg(block_size=3, tol=1e-8), which=which,
                              sigma=sig)
        np.testing.assert_allclose(res.eigenvalues, want, rtol=1e-10)

    def test_sigma_diagonal_mass_fast_path(self):
        a = np.linspace(3.0, 900.0, 500)
        m = np.linspace(0.5, 2.0, 500)
        lam = a / m
        sig = float(np.median(lam)) + 0.123
        res, info = rbl_generalized(sp.diags(a).tocsr(), rtt.DiagonalOperator(_t(m)), 4,
                                    cfg=_cfg(block_size=4, tol=1e-9), which="LM",
                                    sigma=sig, return_info=True)
        assert info.degree == 0
        assert info.inner_solves > 0 and info.inner_iterations >= info.inner_solves
        exact = lam[np.argsort(np.abs(lam - sig), kind="stable")[:4]]
        np.testing.assert_allclose(res.eigenvalues, exact, rtol=1e-10)

    def test_buckling_mode(self):
        """A SPD, M symmetric INDEFINITE; B = A inner product,
        ν = λ/(λ−σ)."""
        n = 120
        dA = np.linspace(4.0, 600.0, n)
        A = sp.diags([-1.0 * np.ones(n - 1), dA, -1.0 * np.ones(n - 1)], [-1, 0, 1]).tocsr()
        s = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        M = (sp.diags(s) + 0.2 * sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])).tocsr()
        w = np.sort(np.real(scipy.linalg.eig(A.toarray(), M.toarray(), right=False)))
        sig = 37.3
        expect = w[np.argsort(-np.abs(w / (w - sig)), kind="stable")[:3]]
        res = rbl_generalized(A, M, 3, cfg=_cfg(block_size=3, tol=1e-8), which="LM",
                              sigma=sig, mode="buckling")
        np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)
        assert res.converged
        V = res.eigenvectors.numpy()
        assert np.max(np.abs(V.T @ (A @ V) - np.eye(3))) < 1e-8

    def test_cayley_mode(self):
        A, M, w = _wellcond(100)
        sig = w[50] + 0.37 * (w[51] - w[50])
        expect = w[np.argsort(-np.abs((w + sig) / (w - sig)), kind="stable")[:3]]
        res = rbl_generalized(A, M, 3, cfg=_cfg(block_size=3, tol=1e-8), which="LM",
                              sigma=sig, mode="cayley")
        np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)
        assert res.converged
        V = res.eigenvectors.numpy()
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(3))) < 1e-8

    def test_restart_budget_route(self):
        """max_restarts runs the transformed sweep through rbl_restarted."""
        a = np.linspace(3.0, 900.0, 300)
        m = np.linspace(0.5, 2.0, 300)
        lam = a / m
        res = rbl_generalized(sp.diags(a).tocsr(), rtt.DiagonalOperator(_t(m)), 3,
                              cfg=_cfg(block_size=3, tol=1e-9, restart_kryl_dim=30),
                              which="LA", max_restarts=40)
        np.testing.assert_allclose(res.eigenvalues, np.sort(lam)[::-1][:3], rtol=1e-10)
