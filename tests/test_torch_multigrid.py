"""The geometric V-cycle (ops/multigrid.py) and the exact FDM shifted
solve (ops/fdm.py) of the port on the CPU — the twin of
tests/test_multigrid.py.

One V-cycle and one FDM solve are held against the JAX package's on the
same seeded block at 1e-12 relative (f64), the FDM solve also against a
dense solve; the contraction factors and inner-iteration counts are the
JAX file's gates; SM solves compare eigenvalues with the analytic
spectrum.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu as rt
from rbl_tpu.ops.fdm import fdm_solver_for as jax_fdm_solver_for
from rbl_tpu.ops.multigrid import mg_psolve_for as jax_mg_psolve_for

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu_torch.ops.fdm import fdm_min_shift_gap, fdm_solver_for
from rbl_tpu_torch.ops import minres as minres_mod
from rbl_tpu_torch.ops.minres import ShiftInvertOperator, block_minres, default_inner_tol
from rbl_tpu_torch.ops.multigrid import (
    MultigridCycle2D,
    SeparableMultigrid,
    mg_psolve_for,
)

F64 = torch.float64


def _lap(*dims):
    if len(dims) == 2:
        return (rtt.Laplacian2D(*dims, dtype=F64, device=CPU),
                rt.Laplacian2D(nx=dims[0], ny=dims[1], _dtype=jnp.float64))
    return (rtt.Laplacian3D(*dims, dtype=F64, device=CPU),
            rt.Laplacian3D(nx=dims[0], ny=dims[1], nz=dims[2], _dtype=jnp.float64))


def _dense_lap(dims):
    """The assembled Dirichlet Laplacian on a grid (last axis fastest)."""
    A = None
    for a, m in enumerate(dims):
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
        f = [sp.identity(d) for d in dims]
        f[a] = T
        K = f[0]
        for g in f[1:]:
            K = sp.kron(K, g)
        A = K if A is None else A + K
    return A.toarray()


def _analytic(n, k):
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[:k]


@pytest.mark.parametrize("dims", [(32, 32), (64, 64), (64, 32), (16, 16, 16)])
def test_vcycle_matches_jax(dims):
    op, jop = _lap(*dims)
    X = np.random.default_rng(0).standard_normal((op.n, 3))
    got = mg_psolve_for(op)(torch.from_numpy(X)).numpy()
    want = np.asarray(jax_mg_psolve_for(jop)(jnp.asarray(X)))
    assert rel_err(got, want) < 1e-12


def test_vcycle_is_spd_and_contracts():
    op, _ = _lap(64, 64)
    ps = mg_psolve_for(op)
    assert ps is not None
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((64 * 64, 2)))
    x = torch.zeros_like(b)
    r0 = float(torch.linalg.norm(b))
    for _ in range(6):
        x = x + ps(b - op.apply(x))
    assert float(torch.linalg.norm(b - op.apply(x))) / r0 < 5e-3
    u = torch.from_numpy(rng.standard_normal((64 * 64, 1)))
    v = torch.from_numpy(rng.standard_normal((64 * 64, 1)))
    s1 = float(u[:, 0] @ ps(v)[:, 0])
    s2 = float(v[:, 0] @ ps(u)[:, 0])
    assert abs(s1 - s2) <= 1e-12 * abs(s1)
    assert float(u[:, 0] @ ps(u)[:, 0]) > 0


def test_mesh_independent_contraction():
    """Exact separable Galerkin: the per-cycle contraction does not
    degrade with depth."""
    rng = np.random.default_rng(1)
    for nx in (64, 128, 256):
        op, _ = _lap(nx, nx)
        ps = mg_psolve_for(op)
        b = torch.from_numpy(rng.standard_normal((nx * nx, 1)))
        x = torch.zeros_like(b)
        prev = float(torch.linalg.norm(b))
        for _ in range(6):
            x = x + ps(b - op.apply(x))
            rn = float(torch.linalg.norm(b - op.apply(x)))
            rho, prev = rn / prev, rn
        assert rho < 0.45, f"nx={nx}: asymptotic rho {rho:.3f}"


@pytest.mark.parametrize("dims,factor,ceiling", [((128, 128), 10, 30),
                                                 ((16, 16, 16), 3, 40)])
def test_mg_cuts_minres_iterations(dims, factor, ceiling, monkeypatch):
    monkeypatch.setattr(minres_mod, "DEFAULT_CHECK_EVERY", 1)
    op, _ = _lap(*dims)
    B = torch.from_numpy(np.random.default_rng(1).standard_normal((op.n, 4)))
    _, (it_none, _) = block_minres(op.apply, B, tol=1e-10)
    _, (it_mg, _) = block_minres(op.apply, B, tol=1e-10,
                                 psolve=mg_psolve_for(op))
    assert it_mg * factor <= it_none
    assert it_mg < ceiling


@pytest.mark.parametrize("dims", [(48, 32), (12, 10, 8)])
@pytest.mark.parametrize("sigma", [0.0, 3.7, 11.9])
def test_fdm_matches_jax_and_dense(dims, sigma):
    """(A − σI)⁻¹ by fast diagonalization, for σ below, inside and above
    the spectrum: against a dense solve and the JAX package's solve (f32
    transforms + refinement there, native f64 here)."""
    op, jop = _lap(*dims)
    B = np.random.default_rng(3).standard_normal((op.n, 3))
    got = fdm_solver_for(op)(torch.from_numpy(B), torch.tensor(sigma, dtype=F64)).numpy()
    want = np.asarray(jax_fdm_solver_for(jop)(jnp.asarray(B), jnp.asarray(sigma)))
    dense = np.linalg.solve(_dense_lap(dims) - sigma * np.eye(op.n), B)
    assert rel_err(got, dense) < 1e-12
    assert rel_err(got, want) < 1e-12


def test_fdm_f32_keeps_the_small_end():
    """The f32 solve sums the denominators in f64 before rounding: the
    smallest eigenvalue's mode comes back to f32 accuracy."""
    op = rtt.Laplacian2D(64, 64, dtype=torch.float32, device=CPU)
    lam0 = _analytic(64, 1)[0]
    i = np.arange(1, 65)
    q = np.sin(np.pi * i / 65)
    v = np.outer(q, q).ravel()[:, None]
    v /= np.linalg.norm(v)
    Y = fdm_solver_for(op)(torch.from_numpy(v).float(), 0.0).double().numpy()
    assert rel_err(Y, v / lam0) < 1e-5


def test_sm_solve_through_fdm_matches_analytic():
    op, _ = _lap(64, 64)
    si = ShiftInvertOperator.shift(op, 0.0)
    assert si.precond == "fdm"
    res = rtt.rbl(si, 4, 4, cfg=rtt.RBLConfig(tol=1e-8))
    w = 1.0 / res.eigenvalues
    exact = _analytic(64, 4)
    assert np.abs((np.sort(w) - exact) / exact).max() < 1e-8
    V = res.eigenvectors
    R = (op.apply(V) - V * torch.from_numpy(w)[None, :]).numpy()
    assert np.linalg.norm(R, axis=0).max() < 1e-6
    assert si.counts["iterations"] == 0 and si.counts["applies"] > 0


def test_sm_solve_through_mg_matches_analytic():
    op, _ = _lap(32, 32)
    si = ShiftInvertOperator.shift(op, 0.0, precond="mg",
                                   inner_tol=default_inner_tol(F64, 1e-8))
    res = rtt.rbl(si, 4, 4)
    w = 1.0 / res.eigenvalues
    exact = _analytic(32, 4)
    assert np.abs((np.sort(w) - exact) / exact).max() < 1e-7
    assert si.counts["iterations"] > 0


def test_interior_shift_through_fdm():
    """σ between two analytic eigenvalues, the 4 nearest by |λ − σ|."""
    op, _ = _lap(32, 32)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, 33) / 33)
    lam = np.sort(np.add.outer(ev1, ev1).ravel())
    u = np.unique(np.round(lam, 12))
    sig = u[300] + 0.37 * (u[301] - u[300])
    si = ShiftInvertOperator.shift(op, sig)
    res = rtt.rbl(si, 4, 4, cfg=rtt.RBLConfig(tol=1e-9 * float(np.max(np.abs(1.0 / (lam - sig))))))
    V = res.eigenvectors
    rq = ((V * op.apply(V)).sum(0) / (V * V).sum(0)).numpy()
    want = lam[np.argsort(np.abs(lam - sig), kind="stable")[:4]]
    np.testing.assert_allclose(np.sort(rq), np.sort(want), rtol=1e-9)
    np.testing.assert_allclose(np.sort(sig + 1.0 / res.eigenvalues), np.sort(want), rtol=1e-9)


def test_mg_unsupported_falls_back_and_strict_raises():
    d = rtt.DiagonalOperator(torch.linspace(1.0, 100.0, 500, dtype=F64))
    si = ShiftInvertOperator.shift(d, 0.0, precond="auto")
    assert si.precond == "jacobi"
    assert bool(torch.isfinite(si.apply(torch.ones((500, 2), dtype=F64))).all())
    with pytest.raises(ValueError, match="precond='mg'"):
        ShiftInvertOperator.shift(d, 0.0, precond="mg").apply(torch.ones((500, 2), dtype=F64))
    with pytest.raises(ValueError, match="precond='fdm'"):
        ShiftInvertOperator.shift(d, 0.0, precond="fdm").apply(torch.ones((500, 2), dtype=F64))


def test_galerkin_factors_stay_spd():
    S = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]])
    cyc = MultigridCycle2D(128, 128, S)
    assert isinstance(cyc, SeparableMultigrid) and cyc.n_levels == 4
    for lv in cyc.levels:
        assert np.all(cyc.omega / lv.winv > 0)
    nc = int(np.prod(cyc.coarse_dims))
    A = np.zeros((nc, nc))
    for fac in cyc.coarse_terms:
        K = fac[0]
        for T in fac[1:]:
            K = np.kron(K, T)
        A = A + K
    assert np.linalg.eigvalsh((A + A.T) / 2).min() > 0
    np.testing.assert_allclose(A, A.T, atol=1e-13)
    # the stencil split refuses what is not a Kronecker sum
    with pytest.raises(ValueError, match="corner"):
        MultigridCycle2D(16, 16, np.ones((3, 3)))


def test_hierarchy_bound_rejects_early_odd_grids():
    op = rtt.Laplacian2D(1026, 1026, dtype=F64, device=CPU)
    assert mg_psolve_for(op) is None
    S = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]])
    with pytest.raises(ValueError, match="bottoms out"):
        MultigridCycle2D(1026, 1026, S)
    assert mg_psolve_for(rtt.Laplacian2D(130, 130, dtype=F64, device=CPU)) is None


def test_auto_resolves_fdm_for_kronecker_sums():
    op, _ = _lap(64, 64)
    assert ShiftInvertOperator.shift(op, 0.0).precond == "fdm"
    assert ShiftInvertOperator.shift(op, 4.05).precond == "fdm"
    op3, _ = _lap(16, 16, 16)
    assert ShiftInvertOperator.shift(op3, 1.0).precond == "fdm"
    d = rtt.DiagonalOperator(torch.linspace(1.0, 100.0, 500, dtype=F64))
    assert ShiftInvertOperator.shift(d, 0.0).precond == "jacobi"
    assert fdm_solver_for(d) is None and fdm_min_shift_gap(d, 0.0) is None


def test_fdm_sigma_at_eigenvalue_raises():
    """σ = 3 IS an eigenvalue of the 64² grid (cos(π/5) − cos(2π/5) = ½)."""
    op, _ = _lap(64, 64)
    with pytest.raises(ValueError, match="coincides with an eigenvalue"):
        ShiftInvertOperator.shift(op, 3.0)
    si = ShiftInvertOperator.shift(op, 3.0 + 1e-6)
    assert bool(torch.isfinite(si.apply(torch.ones((64 * 64, 2), dtype=F64))).all())
