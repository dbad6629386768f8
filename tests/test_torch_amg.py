"""Assembled-matrix multigrid (ops/amg.py) of the port on the CPU — the
twin of tests/test_amg.py.

The host set-up is numpy/scipy in both packages and must give the same
arrays.  One V-cycle is held against the JAX package's at 1e-12 relative
(f64), once on the JAX hierarchy carried across by
``utils.convert.amg_from_arrays`` and once on the port's own build from the
same scipy matrix.  The iteration gates are the JAX file's; the vibration
solve is held to scipy's factorized shift-invert.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import jax.numpy as jnp

from rbl_tpu.ops import amg as jamg
from rbl_tpu.utils.fem import fem_elasticity_3d

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu_torch.ops import amg as tamg
from rbl_tpu_torch.ops.amg import (
    AssembledMultigrid,
    block_jacobi_psolve,
    detect_dof_blocks,
    rigid_body_modes,
)
from rbl_tpu_torch.ops import minres as minres_mod
from rbl_tpu_torch.ops.minres import block_minres, jacobi_psolve
from rbl_tpu_torch.utils.convert import amg_from_arrays

F64 = torch.float64


def _fem_coords(nx):
    nnx = nx + 1
    g = np.arange(nnx, dtype=np.float64)
    k, j, i = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)
    return coords[nnx * nnx:]  # clamped z=0 face removed


def _jax_hierarchy_arrays(amg):
    """A JAX AssembledMultigrid's arrays, as numpy, in the converter's
    layout."""
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
        if isinstance(t, jamg._AggTransfer):
            transfers.append(dict(type="agg", Qpad=np.asarray(t.Qpad),
                                  perm=np.asarray(t.perm), posinv=np.asarray(t.posinv),
                                  dinv=np.asarray(t.dinv), w=t.w, nc=t.nc))
        else:
            transfers.append(dict(type="grid", fine_dims=t.fine_dims,
                                  coarse_dims=t.coarse_dims, P1s=t.P1s, dof=t.dof))
    return levels, transfers


def _builds(build, N, **kw):
    A = fem_elasticity_3d(N)
    if build == "grid":
        return (A, jamg.AssembledMultigrid.from_grid(A, (N, N + 1, N + 1), dof=3, **kw),
                lambda **k: AssembledMultigrid.from_grid(A, (N, N + 1, N + 1), dof=3,
                                                         device=CPU, **k))
    return (A, jamg.AssembledMultigrid.smoothed_aggregation(A, dof=3, **kw),
            lambda **k: AssembledMultigrid.smoothed_aggregation(A, dof=3, device=CPU, **k))


def test_detect_dof_blocks():
    A = fem_elasticity_3d(4)
    assert detect_dof_blocks(A) == jamg.detect_dof_blocks(A) == 3
    L = sp.diags([-np.ones(99), 2 * np.ones(100), -np.ones(99)], [-1, 0, 1]).tocsr()
    assert detect_dof_blocks(L) == jamg.detect_dof_blocks(L) == 1


@pytest.mark.parametrize("piece", ["strength", "aggregate", "tentative", "lambda",
                                   "block_inv", "rigid", "grid_prolong"])
def test_host_setup_matches_jax(piece):
    """Each host building block gives the JAX package's arrays."""
    A = fem_elasticity_3d(5)
    if piece == "strength":
        a, b = tamg._node_strength_graph(A, 3), jamg._node_strength_graph(A, 3)
        assert (a != b).nnz == 0
    elif piece == "aggregate":
        S = jamg._node_strength_graph(A, 3)
        np.testing.assert_array_equal(tamg._aggregate(S, 0.05), jamg._aggregate(S, 0.05))
    elif piece == "tentative":
        agg = jamg._aggregate(jamg._node_strength_graph(A, 3), 0.05)
        B = rigid_body_modes(_fem_coords(5))
        got, want = tamg._tentative_prolongator(agg, B, 3), jamg._tentative_prolongator(agg, B, 3)
        assert abs(got[0] - want[0]).max() == 0
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            np.testing.assert_array_equal(g, w)
    elif piece == "lambda":
        assert tamg._lambda_max_dinv_a(A) == jamg._lambda_max_dinv_a(A)
    elif piece == "block_inv":
        np.testing.assert_array_equal(tamg._block_diag_inv(A, 3, 0.6),
                                      jamg._block_diag_inv(A, 3, 0.6))
    elif piece == "rigid":
        c = _fem_coords(3)
        np.testing.assert_array_equal(rigid_body_modes(c), jamg.rigid_body_modes(c))
        np.testing.assert_array_equal(rigid_body_modes(c[:, :2], dof=2),
                                      jamg.rigid_body_modes(c[:, :2], dof=2))
        with pytest.raises(ValueError, match="dof"):
            rigid_body_modes(c, dof=4)
    else:
        for m in (4, 5, 9):
            np.testing.assert_array_equal(tamg._grid_prolong_1d(m), jamg._grid_prolong_1d(m))


@pytest.mark.parametrize("build", ["grid", "sa"])
@pytest.mark.parametrize("route", ["converted", "rebuilt"])
def test_vcycle_matches_jax(build, route):
    """fem3d-8 with a 300-row coarsest: two levels, DIA level operators on
    the CPU in both packages."""
    A, jax_amg, port_build = _builds(build, 8, coarsest_n=300)
    if route == "converted":
        levels, transfers = _jax_hierarchy_arrays(jax_amg)
        amg = amg_from_arrays(levels, transfers, jax_amg.coarse_inv, jax_amg.nu, device=CPU)
    else:
        amg = port_build(coarsest_n=300)
        assert [lv.n for lv in amg.levels] == [lv.n for lv in jax_amg.levels]
        assert amg.coarse_inv.shape == jax_amg.coarse_inv.shape
    assert len(amg.levels) == len(jax_amg.levels) >= 1
    X = np.random.default_rng(0).standard_normal((A.shape[0], 3))
    got = amg.psolve(torch.from_numpy(X)).numpy()
    want = np.asarray(jax_amg.psolve(jnp.asarray(X)))
    assert rel_err(got, want) < 1e-12


def test_f32_hierarchy_on_an_f64_block_matches_jax():
    """Built at f32, handed f64: both packages run the cycle in f64 with
    f32-rounded constants and return f64."""
    A, jax_amg, port_build = _builds("grid", 6, coarsest_n=300, dtype=jnp.float32)
    amg = port_build(coarsest_n=300, dtype=torch.float32)
    X = np.random.default_rng(1).standard_normal((A.shape[0], 2))
    got = amg.psolve(torch.from_numpy(X))
    want = np.asarray(jax_amg.psolve(jnp.asarray(X)))
    assert got.dtype == F64 and want.dtype == np.float64
    assert rel_err(got.numpy(), want) < 1e-12
    got32 = amg.psolve(torch.from_numpy(X).float())
    assert got32.dtype == torch.float32 and rel_err(got32.numpy(), want) < 1e-5


@pytest.mark.parametrize("build", ["grid", "sa"])
def test_amg_cycle_is_spd(build):
    _, _, port_build = _builds(build, 6)
    amg = port_build(coarsest_n=300)
    n = amg.levels[0].n
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((n, 1)))
    v = torch.from_numpy(rng.standard_normal((n, 1)))
    s1 = float(u[:, 0] @ amg.psolve(v)[:, 0])
    s2 = float(v[:, 0] @ amg.psolve(u)[:, 0])
    assert abs(s1 - s2) <= 1e-12 * abs(s1)
    assert float(u[:, 0] @ amg.psolve(u)[:, 0]) > 0


def test_amg_cuts_minres_iterations(monkeypatch):
    """fem3d-8 elasticity at σ = 0: scalar Jacobi ~131, block Jacobi ~121,
    SA-AMG with rigid modes ~20, grid AMG ~25 (the JAX file's gates)."""
    monkeypatch.setattr(minres_mod, "DEFAULT_CHECK_EVERY", 1)
    A = fem_elasticity_3d(8)
    op = rtt.as_operator(A, dtype=F64, device=CPU, format="ell")
    B = torch.from_numpy(np.random.default_rng(0).standard_normal((A.shape[0], 4)))

    def iters(ps):
        _, (it, _) = block_minres(op.apply, B, tol=1e-10, psolve=ps, maxiter=4000)
        return it

    it_jac = iters(jacobi_psolve(op.diagonal()))
    it_bj = iters(block_jacobi_psolve(A, device=CPU))
    sa = AssembledMultigrid.smoothed_aggregation(
        A, dof=3, near_nullspace=rigid_body_modes(_fem_coords(8)), device=CPU)
    it_sa = iters(sa.psolve)
    gg = AssembledMultigrid.from_grid(A, (8, 9, 9), dof=3, device=CPU)
    it_gg = iters(gg.psolve)
    assert it_bj <= it_jac
    assert it_sa * 4 <= it_jac, (it_sa, it_jac)
    assert it_gg * 3 <= it_jac, (it_gg, it_jac)
    assert it_sa < 40 and it_gg < 50


def test_block_jacobi_psolve_matches_jax():
    A = fem_elasticity_3d(4)
    X = np.random.default_rng(2).standard_normal((A.shape[0], 3))
    got = block_jacobi_psolve(A, device=CPU)(torch.from_numpy(X)).numpy()
    want = np.asarray(jamg.block_jacobi_psolve(A)(jnp.asarray(X)))
    assert rel_err(got, want) < 1e-14


def test_grid_transfers_match_scipy_kron():
    """The per-axis products equal the assembled kron(P0,P1,P2)⊗I3 used
    for RAP (same operators, two code paths)."""
    dims, dof = (4, 5, 3), 3
    P1s = [tamg._grid_prolong_1d(m) for m in dims]
    cdims = tuple(P.shape[1] for P in P1s)
    tr = tamg._GridTransfer(dims, cdims, P1s, dof)
    Pn = sp.kron(sp.kron(sp.csr_matrix(P1s[0]), sp.csr_matrix(P1s[1])),
                 sp.csr_matrix(P1s[2]))
    P = sp.kron(Pn, sp.identity(dof, format="csr")).tocsr()
    rng = np.random.default_rng(1)
    C = rng.standard_normal((P.shape[1], 2))
    F = rng.standard_normal((P.shape[0], 2))
    np.testing.assert_allclose(tr.prolong(torch.from_numpy(C)).numpy(), P @ C, atol=1e-13)
    np.testing.assert_allclose(tr.restrict(torch.from_numpy(F)).numpy(), P.T @ F, atol=1e-13)


@pytest.mark.parametrize("kind", ["agg", "coo"])
def test_transfers_match_scipy_smoothed_p(kind):
    """The permuted-aggregate transfers (and the generic COO pair) equal
    the scipy smoothed prolongator used for RAP."""
    A = fem_elasticity_3d(5)
    agg = tamg._aggregate(tamg._node_strength_graph(A, 3), 0.05)
    B = np.zeros((A.shape[0], 3))
    for c in range(3):
        B[c::3, c] = 1.0
    Pt, Bc, meta = tamg._tentative_prolongator(agg, B, 3)
    w = 4.0 / (3.0 * tamg._lambda_max_dinv_a(A))
    d = A.diagonal().copy()
    P = (Pt - w * (sp.diags(1.0 / d) @ (A @ Pt))).tocsr()
    if kind == "agg":
        lv = tamg._AMGLevel(A, 3, 0.6, F64, torch.device(CPU))
        tr = tamg._AggTransfer(meta, lv.op, 1.0 / d, w, Pt.shape[1], F64, CPU)
    else:
        tr = tamg._CooTransfer(P, F64, CPU)
    rng = np.random.default_rng(2)
    C = rng.standard_normal((P.shape[1], 3))
    F = rng.standard_normal((P.shape[0], 3))
    np.testing.assert_allclose(tr.prolong(torch.from_numpy(C)).numpy(), P @ C, atol=1e-11)
    np.testing.assert_allclose(tr.restrict(torch.from_numpy(F)).numpy(), P.T @ F, atol=1e-11)


@pytest.mark.parametrize("build", ["grid", "sa"])
def test_vibration_solve_with_amg_matches_scipy(build):
    """rbl_generalized(K, M = lumped diag, σ = 0) with the AMG inner
    preconditioner against scipy's factorized eigsh on the host."""
    N = 4
    A = fem_elasticity_3d(N)
    m = np.asarray(A.sum(axis=1)).ravel()
    m = np.abs(m) + 1e-3 * np.abs(m).mean()
    kw = dict(dof=3, device=CPU, coarsest_n=100)
    amg = (AssembledMultigrid.from_grid(A, (N, N + 1, N + 1), **kw) if build == "grid"
           else AssembledMultigrid.smoothed_aggregation(A, **kw))
    opA = rtt.as_operator(A, dtype=F64, device=CPU, format="ell")
    # the level operator is the router's choice (DIA for this band on the CPU)
    route = type(rtt.as_operator(A, dtype=F64, device=CPU)).__name__
    assert len(amg.levels) == 1 and f"route={route}" in amg.report()
    res = rtt.rbl_generalized(opA, rtt.DiagonalOperator(torch.from_numpy(m)), 4,
                              cfg=rtt.RBLConfig(tol=1e-8), which="LM", sigma=0.0,
                              inner_psolve=amg.psolve)
    w_ref = sla.eigsh(A, k=4, M=sp.diags(m), sigma=0.0, which="LM",
                      return_eigenvectors=False)
    assert res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues), np.sort(w_ref), rtol=1e-8)
    V = res.eigenvectors.numpy()
    R = A @ V - (m[:, None] * V) * res.eigenvalues[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6
    assert np.abs(V.T @ (m[:, None] * V) - np.eye(4)).max() < 1e-8


def test_set_up_rejects_a_bad_grid_and_needs_a_card():
    A = fem_elasticity_3d(4)
    with pytest.raises(ValueError, match="node_dims"):
        AssembledMultigrid.from_grid(A, (4, 5, 4), dof=3, device=CPU)
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            AssembledMultigrid.from_grid(A, (4, 5, 5), dof=3)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            block_jacobi_psolve(A)
