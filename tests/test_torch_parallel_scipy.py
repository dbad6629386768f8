"""The last two row-mesh paths of the port on 2 gloo CPU ranks, against the
JAX package on the CPU and scipy: the assembled multigrid V-cycle on the
mesh (``AssembledMultigrid(mesh=)``) and the scipy front door
(``eigsh``/``svds`` with ``cfg.mesh``).

- The mesh V-cycle (grid and aggregation hierarchies, f64 and f32) on
  ``fem_elasticity_3d(7)``: the JAX hierarchy carried across by
  ``amg_from_arrays(..., mesh=)`` and the port's own mesh build, each
  within 1e-12 (f64) or 1e-5 (f32) relative of
  ``rbl_tpu.ops.amg.AssembledMultigrid.psolve`` on the same block, the
  port's build within the same of the port's unsharded cycle, and one
  all-reduce a cycle; the grid hierarchy of ``fem_elasticity_3d(15)`` at
  its defaults (level 0 packed by the hierarchy itself) within 1e-12; a
  hierarchy with no level (the dense inverse on the gathered block)
  within 1e-10 of a direct solve.
- ``rbl_generalized(K_sh, M_sh, 4, sigma=0)`` (K and M sharded) with the
  mesh cycle as the inner psolve within 1e-9 of the JAX package's
  unsharded pencil solve and of scipy's factorized ``eigsh(K, 4, M,
  sigma=0)``.
- One apply of ``ShiftInvertOperator`` over the sharded K with the mesh
  cycle and with an unsharded hierarchy's cycle (applied replicated), and
  of ``GeneralizedShiftInvertOperator`` with the mesh cycle, each within
  1e-9 of scipy's direct solve and 1e-10 of the same operator's apply in
  one process (inner MINRES to 1e-13).
- One apply of ``ShiftInvertOperator`` over the 64² Laplacian operator
  made replicated by the mesh: the exact FDM solve (no MINRES iteration)
  within 1e-9 of scipy's and 1e-10 of the one-process FDM apply.
- ``eigsh`` (LM, SA, BE, σ = 0 with the aggregation AMG that the auto
  route builds for the 64² Laplacian matrix, an interior σ on the
  Laplacian operator, a pencil) and ``svds`` (LM, SM)
  within tests/test_torch_compat.py's gates of the unsharded ``rbl_tpu``
  call and of scipy; ``maxiter`` raises ``ArpackNoConvergence`` with the
  whole partial vectors on both ranks.
- Every result is whole and bitwise equal on both ranks; a band that
  splits a node, or a whole block handed to a mesh cycle, raises
  ``ValueError``.

The ranks run as one spawned job (tests/_torch_parallel_job.py) under a
timeout that kills the group.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import jax.numpy as jnp

import rbl_tpu as jt
from rbl_tpu.ops import amg as jamg

import _torch_parallel_job as J
from _torch_parity import CPU, jax_hierarchy_arrays
from rbl_tpu_torch.ops.amg import AssembledMultigrid

TOL = {"f64": 1e-12, "f32": 1e-5}  # ‖Y − Y_ref‖ / ‖Y_ref‖ of one V-cycle
PENCIL_RTOL = 1e-9
SOLVE_RTOL, ONE_PROCESS_RTOL = 1e-9, 1e-10  # the shift-invert applies
EIGSH_CASES = ["eigsh_lm", "eigsh_sa", "eigsh_be", "eigsh_sigma0_auto",
               "eigsh_lap_fdm", "eigsh_pencil_la"]
APPLIES = ["si_mesh_amg", "si_replicated", "gsi_mesh_amg"]


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _jax_build(h, K):
    build, prec = h.split("_")
    dt = jnp.float64 if prec == "f64" else jnp.float32
    if build == "grid":
        return jamg.AssembledMultigrid.from_grid(
            K, J.fem_dims(), dof=3, coarsest_n=J.GRID_COARSEST, dtype=dt)
    return jamg.AssembledMultigrid.smoothed_aggregation(
        K, dof=3, coarsest_n=J.SA_COARSEST, dtype=dt)


@pytest.fixture(scope="module")
def pencil():
    return J.fem_pencil()


@pytest.fixture(scope="module")
def jax_amgs(pencil):
    return {h: _jax_build(h, pencil[0]) for h in J.HIERARCHIES}


@pytest.fixture(scope="module")
def ranks(jax_amgs, tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_scipy")
    inputs = {}
    for h, amg in jax_amgs.items():
        levels, transfers = jax_hierarchy_arrays(amg)
        inputs.update(J.pack_hierarchy(h, levels, transfers, amg.coarse_inv,
                                       amg.nu))
    np.savez(d / "scipy_inputs.npz", **inputs)
    return J.run_job("scipy", J.SCIPY_RANKS, str(d), timeout=120)


@pytest.fixture(scope="module")
def jax_pencil(pencil, jax_amgs):
    K, mass = pencil
    return jt.rbl_generalized(
        K, sp.diags(mass).tocsr(), 4, 4, cfg=jt.RBLConfig(tol=J.PENCIL_TOL),
        which="LM", sigma=0.0, inner_psolve=jax_amgs["grid_f64"].psolve)


@pytest.fixture(scope="module")
def scipy_pencil(pencil):
    K, mass = pencil
    return np.sort(sla.eigsh(K, 4, M=sp.diags(mass), sigma=0.0,
                             return_eigenvectors=False))


@pytest.mark.parametrize("route", ["converted", "built"])
@pytest.mark.parametrize("h", J.HIERARCHIES)
def test_mesh_vcycle_matches_jax(h, route, ranks, jax_amgs):
    amg = jax_amgs[h]
    X = J.vcycle_block(J.fem_pencil()[0].shape[0])
    dt = jnp.float64 if h.endswith("f64") else jnp.float32
    ref = np.asarray(amg.psolve(jnp.asarray(X, dtype=dt))).astype(np.float64)
    got = ranks[0][f"vcycle_{h}_{route}__Y"]
    assert got.dtype == (np.float64 if h.endswith("f64") else np.float32)
    assert ranks[1][f"vcycle_{h}_{route}__Y"].tobytes() == got.tobytes()
    assert _rel(got.astype(np.float64), ref) < TOL[h[-3:]]


def test_mesh_vcycle_fem15_defaults(ranks):
    K, _ = J.fem_pencil(J.FEM_BIG)
    amg = jamg.AssembledMultigrid.from_grid(K, J.fem_dims(J.FEM_BIG), dof=3)
    assert len(amg.levels) == 2
    ref = np.asarray(amg.psolve(jnp.asarray(J.vcycle_block(K.shape[0]))))
    for rk in ranks:
        assert str(rk["vcycle_fem15__route"]) == "ShardedBlockSparseOperator"
        assert _rel(rk["vcycle_fem15__Y"], ref) < TOL["f64"]


def test_mesh_hierarchy_without_levels_solves_whole(ranks, pencil):
    """n ≤ coarsest_n: no level on the band, and the coarsest dense inverse
    (here K's own) takes the gathered block."""
    K = pencil[0]
    X = J.vcycle_block(K.shape[0])
    exact = np.linalg.solve(K.toarray(), X)
    for rk in ranks:
        assert int(rk["vcycle_nolevels__levels"]) == 0
        assert _rel(rk["vcycle_nolevels__Y"], exact) < 1e-10


@pytest.mark.parametrize("h", J.HIERARCHIES)
def test_mesh_vcycle_matches_unsharded_port(h, ranks, pencil):
    K = pencil[0]
    build, prec = h.split("_")
    dt = torch.float64 if prec == "f64" else torch.float32
    if build == "grid":
        amg = AssembledMultigrid.from_grid(K, J.fem_dims(), dof=3,
                                           coarsest_n=J.GRID_COARSEST,
                                           dtype=dt, device=CPU)
    else:
        amg = AssembledMultigrid.smoothed_aggregation(
            K, dof=3, coarsest_n=J.SA_COARSEST, dtype=dt, device=CPU)
    X = torch.from_numpy(J.vcycle_block(K.shape[0])).to(dt)
    ref = amg.psolve(X).double().numpy()
    got = ranks[0][f"vcycle_{h}_built__Y"].astype(np.float64)
    assert _rel(got, ref) < TOL[prec]


def test_mesh_vcycle_reduces_once_a_cycle(ranks):
    """Level 0's restriction is the cycle's only collective; levels ≥ 1
    and the coarsest inverse are replicated on every rank."""
    for rk in ranks:
        for h in J.HIERARCHIES:
            for route in ("converted", "built"):
                assert int(rk[f"vcycle_{h}_{route}__reduces"]) == 1
                assert int(rk[f"vcycle_{h}_{route}__levels"]) == 2


def test_pencil_with_mesh_amg(ranks, jax_pencil, scipy_pencil, pencil):
    K, mass = pencil
    w = np.sort(ranks[0]["pencil_amg__w"])
    np.testing.assert_allclose(w, np.sort(jax_pencil.eigenvalues),
                               rtol=PENCIL_RTOL)
    np.testing.assert_allclose(w, scipy_pencil, rtol=PENCIL_RTOL)
    assert bool(ranks[0]["pencil_amg__converged"])
    X = ranks[0]["pencil_amg__V"]
    lam = ranks[0]["pencil_amg__w"]
    assert X.shape == (K.shape[0], 4)
    np.testing.assert_allclose(X.T @ (mass[:, None] * X), np.eye(4),
                               atol=1e-8)
    assert np.linalg.norm(K @ X - (mass[:, None] * X) * lam, axis=0).max() \
        < 1e-6 * sla.norm(K, 1)
    # a V-cycle a MINRES iteration, each with its one all-reduce, beside
    # the iteration's two column reductions
    inner, its, reduces = ranks[0]["pencil_amg__counts"]
    assert inner > 0 and reduces > 3 * its


def _one_process_apply(case, K, mass, X):
    """The same operator and psolve kind in one process, on the whole."""
    import rbl_tpu_torch as tt
    from rbl_tpu_torch.ops.generalized import GeneralizedShiftInvertOperator
    from rbl_tpu_torch.ops.minres import ShiftInvertOperator

    amg = AssembledMultigrid.from_grid(K, J.fem_dims(), dof=3,
                                       coarsest_n=J.GRID_COARSEST, device=CPU)
    Kop = tt.as_operator(K, dtype=torch.float64, device=CPU)
    if case.startswith("si_"):
        op = ShiftInvertOperator.shift(Kop, 0.0, inner_tol=J.SI_INNER_TOL,
                                       psolve=amg.psolve)
    else:
        op = GeneralizedShiftInvertOperator(
            A=Kop, M=tt.DiagonalOperator(torch.from_numpy(mass)),
            msqrt=tt.DiagonalOperator(torch.from_numpy(np.sqrt(mass))),
            sigma=torch.zeros((), dtype=torch.float64),
            inner_tol=J.SI_INNER_TOL, psolve=amg.psolve)
    return op.apply(torch.from_numpy(X)).numpy()


@pytest.mark.parametrize("case", APPLIES)
def test_shift_invert_apply_with_explicit_psolve(case, ranks, pencil):
    """The mesh cycle is taken as it is (one all-reduce a cycle, no
    gather); an unsharded hierarchy's cycle is applied as GSPMD applies a
    replicated function (a gather a cycle): both give the one-process
    answer, and scipy's direct solve."""
    K, mass = pencil
    X = J.vcycle_block(K.shape[0], seed=6)
    if case.startswith("si_"):
        exact = sla.spsolve(K.tocsc(), X)
    else:  # W = M^½·K⁻¹·M^½
        r = np.sqrt(mass)[:, None]
        exact = r * sla.spsolve(K.tocsc(), r * X)
    got = ranks[0][f"{case}__Y"]
    assert _rel(got, exact) < SOLVE_RTOL
    assert _rel(got, _one_process_apply(case, K, mass, X)) < ONE_PROCESS_RTOL
    its, reduces, gathers = ranks[0][f"{case}__counts"]
    assert its > 0 and reduces > 2 * its
    assert (gathers >= its) if case == "si_replicated" else gathers == 0


def test_replicated_laplacian_keeps_fdm(ranks):
    """A Laplacian under the mesh is a ``ReplicatedOperator``; the shift-
    invert still takes the exact FDM solve (no MINRES iteration, no
    all-reduce) on the gathered block, as in one process."""
    import rbl_tpu_torch as tt
    from rbl_tpu_torch.ops.minres import ShiftInvertOperator

    n = J.LAP_NX * J.LAP_NX
    X = J.vcycle_block(n, seed=7)
    exact = sla.spsolve((J.laplacian_2d() - J.LAP_SIGMA * sp.identity(n))
                        .tocsc(), X)
    one = ShiftInvertOperator.shift(
        tt.Laplacian2D(J.LAP_NX, J.LAP_NX, device=CPU), J.LAP_SIGMA)
    ref = one.apply(torch.from_numpy(X)).numpy()
    for rk in ranks:
        assert str(rk["si_fdm_replicated__precond"]) == "fdm"
        its, reduces, gathers = rk["si_fdm_replicated__counts"]
        assert its == 0 and reduces == 0 and gathers == 1
        got = rk["si_fdm_replicated__Y"]
        assert _rel(got, exact) < SOLVE_RTOL
        assert _rel(got, ref) < ONE_PROCESS_RTOL


def _eigsh_reference(case):
    """(the unsharded rbl_tpu.eigsh, scipy's eigsh, A, M, rtol) of a case."""
    if case == "eigsh_lm":
        A = J.eig_sym(300, 0)
        return (jt.eigsh(A, k=6, tol=1e-9)[0],
                sla.eigsh(A, k=6, which="LM", tol=1e-10)[0], A, None, 1e-7)
    if case == "eigsh_sa":
        A = J.eig_sym(300, 1)
        return (jt.eigsh(A, k=5, which="SA", tol=1e-9,
                         return_eigenvectors=False),
                sla.eigsh(A, k=5, which="SA", tol=1e-10,
                          return_eigenvectors=False), A, None, 1e-6)
    if case == "eigsh_be":
        A = J.eig_sym(300, 4)
        return (jt.eigsh(A, k=5, which="BE", tol=1e-9)[0],
                sla.eigsh(A, k=5, which="BE", tol=1e-10,
                          return_eigenvectors=False), A, None, 1e-6)
    if case == "eigsh_sigma0_auto":
        A = J.laplacian_2d()
        return (jt.eigsh(A, 4, sigma=0.0)[0],
                sla.eigsh(A, 4, sigma=0.0, return_eigenvectors=False), A,
                None, 1e-8)
    if case == "eigsh_lap_fdm":
        A = J.laplacian_2d()
        return (jt.eigsh(jt.Laplacian2D(J.LAP_NX, J.LAP_NX), 4,
                         sigma=J.LAP_SIGMA)[0],
                sla.eigsh(A, 4, sigma=J.LAP_SIGMA, return_eigenvectors=False),
                A, None, 1e-8)
    A, M = J.eig_sym(300, 2), J.pencil_mass()
    return (jt.eigsh(A, 4, M=M, which="LA", tol=1e-9)[0],
            sla.eigsh(A, 4, M=M, which="LA", tol=1e-10,
                      return_eigenvectors=False), A, M, 1e-6)


@pytest.mark.parametrize("case", EIGSH_CASES)
def test_eigsh_on_the_mesh(case, ranks):
    jw, sw, A, M, rtol = _eigsh_reference(case)
    w = ranks[0][f"{case}__w"]
    if case == "eigsh_sa":  # no vectors: scipy's order, ascending |λ|
        assert np.all(np.diff(np.abs(w)) >= 0)
    else:
        assert np.all(np.diff(w) >= 0)
    np.testing.assert_allclose(np.sort(w), np.sort(np.asarray(jw)), rtol=rtol)
    np.testing.assert_allclose(np.sort(w), np.sort(sw), rtol=rtol)
    if f"{case}__V" in ranks[0]:
        V = ranks[0][f"{case}__V"]
        assert V.shape == (A.shape[0], w.shape[0])
        R = A @ V - (V if M is None else M @ V) * w
        assert np.linalg.norm(R, axis=0).max() < 1e-6 * sla.norm(A, 1)


@pytest.mark.parametrize("case", ["maxiter", "maxiter_sm"])
def test_maxiter_raises_with_the_whole_partial_result(case, ranks):
    A = J.three_isolated() if case == "maxiter" else J.three_isolated_sm()
    with pytest.raises(sla.ArpackNoConvergence) as ej:
        if case == "maxiter":
            jt.eigsh(A, k=8, maxiter=1, ncv=10, b=1)
        else:
            jt.eigsh(A, k=8, which="SM", maxiter=1, ncv=10, b=1, tol=1e-12)
    for rk in ranks:
        assert str(rk[f"{case}__raised"]) == "ArpackNoConvergence"
        w, V = rk[f"{case}__w"], rk[f"{case}__V"]
        assert w.shape[0] <= 8 and V.shape == (A.shape[0], w.shape[0])
        np.testing.assert_allclose(np.sort(w), np.sort(ej.value.eigenvalues),
                                   rtol=1e-9)


@pytest.mark.parametrize("case", ["svds_lm", "svds_sm"])
def test_svds_on_the_mesh(case, ranks):
    B = J.svd_lm() if case == "svds_lm" else J.svd_sm()
    k, which, rtol = (5, "LM", 1e-7) if case == "svds_lm" else (4, "SM", 1e-8)
    s_jax = jt.svds(B, k=k, which=which)[1]
    Bd = B.toarray() if sp.issparse(B) else B
    s_exact = np.linalg.svd(Bd, compute_uv=False)
    s_exact = np.sort(s_exact)[::-1][:k] if which == "LM" \
        else np.sort(s_exact)[:k]
    U, s, Vh = (ranks[0][f"{case}__{f}"] for f in ("U", "s", "Vh"))
    assert np.all(np.diff(s) >= 0)
    np.testing.assert_allclose(s, np.sort(s_jax), rtol=rtol)
    np.testing.assert_allclose(s, np.sort(s_exact), rtol=rtol)
    assert U.shape == (B.shape[0], k) and Vh.shape == (k, B.shape[1])
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-8)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=1e-8)
    np.testing.assert_allclose(Bd @ Vh.T, U * s[None, :], atol=1e-7 * s.max())


@pytest.mark.parametrize("case", ["pencil_amg", *APPLIES, *EIGSH_CASES,
                                  "maxiter", "maxiter_sm", "svds_lm",
                                  "svds_sm"])
def test_results_whole_and_bitwise_equal_across_ranks(case, ranks):
    keys = [k for k in ranks[0] if k.startswith(f"{case}__")
            and k.split("__")[1] in ("w", "V", "Y", "s", "U", "Vh")]
    assert keys
    for k in keys:
        assert ranks[1][k].shape == ranks[0][k].shape
        assert ranks[1][k].tobytes() == ranks[0][k].tobytes(), k


def test_mesh_cycle_refuses_a_whole_block(ranks):
    """A hierarchy built on the mesh cycles the rank's rows; a whole block
    (an unsharded solve's) raises instead of mixing rows."""
    for rk in ranks:
        assert str(rk["whole_block__raised"]) == "ValueError"


def test_band_that_splits_a_node_raises(ranks):
    for rk in ranks:
        assert str(rk["split_node__raised"]) == "ValueError"
