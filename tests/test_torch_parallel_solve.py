"""Row-sharded solves of the port on 2 gloo CPU ranks against the JAX
package on ``make_row_mesh(2)``, with the JAX package's own gates:
``ShardedLaplacian2D`` 32×32 (k=4, b=4) within 1e-9 of the analytic
spectrum (once more with a fault injected into both ranks' first dispatch
and retried), tests/fake_cluster_worker.py's 256-row COO matrix and
tests/test_distributed.py's sharded-BSR case within 1e-9 of ``eigvalsh``,
the fuzz spectra "indefinite" and "gap_clusters" through a replicated
``DiagonalOperator`` at 1e-10, ``rbl_polished`` at tol 1e-7, ``rbl_restarted``,
``rbl_filtered`` and ``rbl_svd`` (sparse and dense, k = 4).

Every solve's eigenvalues must be BITWISE equal across the ranks (the
replicated host state, as tests/test_multiprocess.py asks).  One solve runs
with rank 1's eig polls late (each runs only when waited for) and rank 0's
done at once: the two ranks' ``done()`` disagree at every non-blocking
harvest, and the ranks must still agree on every branch.  The ranks run as one spawned job
(tests/_torch_parallel_job.py) with a timeout.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import rbl_tpu as rt
from rbl_tpu.parallel import dist_spmm as JD
from rbl_tpu.parallel.mesh import make_row_mesh

import _torch_parallel_job as J

SOLVES = ["lap", "coo", "coo_sa", "coo_deflated", "lap_host_tier", "bsr",
          "indefinite", "gap_clusters", "polished", "restarted", "filtered", "pencil_la",
          "pencil_sigma", "pencil_lumped", "si_lap", "ck_sweep", "ck_restart",
          "ck_polish", "race", "retry"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_solve")
    return J.run_job("solve", J.SOLVE_RANKS, str(d), timeout=300)


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return make_row_mesh(J.SOLVE_RANKS)


def _top(w, k):
    return w[np.argsort(-np.abs(w), kind="stable")][:k]


@pytest.mark.parametrize("case", SOLVES)
def test_eigenvalues_bitwise_equal_across_ranks(case, ranks):
    w0, w1 = ranks[0][f"{case}__w"], ranks[1][f"{case}__w"]
    assert w0.tobytes() == w1.tobytes()
    assert bool(ranks[0][f"{case}__converged"]) == bool(ranks[1][f"{case}__converged"])


@pytest.mark.parametrize("case", ["svd_sparse", "svd_dense", "svd_sm_sparse",
                                  "svd_sm_dense"])
def test_singular_values_bitwise_equal_across_ranks(case, ranks):
    assert ranks[0][f"{case}__s"].tobytes() == ranks[1][f"{case}__s"].tobytes()


def test_sharded_laplacian_solve(ranks, jmesh):
    w = ranks[0]["lap__w"]
    np.testing.assert_allclose(w, J.lap_exact(32, 32, 4), rtol=1e-9)
    jres = rt.rbl(JD.ShardedLaplacian2D(nx=32, ny=32, mesh=jmesh,
                                        _dtype=jnp.float64),
                  4, 4, cfg=rt.RBLConfig(block_size=4, mesh=jmesh,
                                         max_kryl_dim=256))
    np.testing.assert_allclose(w, jres.eigenvalues, rtol=1e-9)
    # the gathered eigenvectors (each rank returned its own rows): their
    # residuals within a factor 2 of the JAX package's at this capped solve
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(32, 32))
    A = sp.kronsum(T, T)

    def resid(V, w):
        return np.linalg.norm(A @ V - V * w[None, :], axis=0).max()

    Vj = np.asarray(jres.eigenvectors)
    assert resid(ranks[0]["lap__V"], w) <= 2 * resid(Vj, jres.eigenvalues) + 1e-12


def test_sharded_coo_solve(ranks, jmesh):
    A = J.coo256()
    w = ranks[0]["coo__w"]
    np.testing.assert_allclose(w, _top(np.linalg.eigvalsh(A.toarray()), 3),
                               rtol=1e-9)
    jres = rt.rbl(JD.ShardedCooSpMM.from_scipy(A, jmesh), 3, 4,
                  cfg=rt.RBLConfig(block_size=4, mesh=jmesh, max_kryl_dim=256))
    np.testing.assert_allclose(w, jres.eigenvalues, rtol=1e-9)


def test_sa_deflation_and_host_tier_on_the_mesh(ranks):
    """which="SA", a global deflate= span with a global v0, and the
    pinned-host basis tier (basis_device_cap_cols=64) under the mesh."""
    w = np.linalg.eigvalsh(J.coo256().toarray())
    np.testing.assert_allclose(ranks[0]["coo_sa__w"], np.sort(w)[:3], rtol=1e-9)
    order = np.argsort(-np.abs(w))
    np.testing.assert_allclose(ranks[0]["coo_deflated__w"], w[order][2:5],
                               rtol=1e-9)
    np.testing.assert_allclose(ranks[0]["lap_host_tier__w"],
                               J.lap_exact(32, 32, 4), rtol=1e-9)


def test_sharded_bsr_solve(ranks, jmesh):
    A = J.bsr512()
    w = ranks[0]["bsr__w"]
    np.testing.assert_allclose(w, _top(np.linalg.eigvalsh(A.toarray()), 5),
                               rtol=1e-9)
    jop = JD.ShardedBlockSparseOperator.from_scipy(A, jmesh, dtype=jnp.float64,
                                                   bm=16, bk=16)
    jres = rt.rbl(jop, 5, 4, cfg=rt.RBLConfig(block_size=4, mesh=jmesh,
                                              max_kryl_dim=256))
    np.testing.assert_allclose(w, jres.eigenvalues, rtol=1e-9)


def test_replicated_diagonal_fuzz_indefinite(ranks, jmesh):
    """A plain operator under the mesh is applied replicated (all-gather,
    apply, keep the own rows), as GSPMD applies it."""
    d = J.indefinite()
    true_k = _top(d, 5)
    w = ranks[0]["indefinite__w"]
    assert np.all(np.abs(w - true_k) / np.abs(true_k) < 1e-10)
    jres = rt.rbl(rt.DiagonalOperator(d), 5, 5,
                  cfg=rt.RBLConfig(block_size=5, mesh=jmesh))
    assert np.all(np.abs(w - jres.eigenvalues) / np.abs(true_k) < 1e-10)


def test_replicated_diagonal_fuzz_gap_clusters(ranks, jmesh):
    """tests/test_fuzz_spectra.py's mesh case: two tight clusters a huge
    gap apart (danger and selective modes) under the row mesh."""
    d = J.gap_clusters()
    true_k = _top(d, 5)
    w = ranks[0]["gap_clusters__w"]
    assert np.all(np.abs(w - true_k) / np.abs(true_k) < 1e-10)
    jres = rt.rbl(rt.DiagonalOperator(d), 5, 5,
                  cfg=rt.RBLConfig(block_size=5, mesh=jmesh))
    assert np.all(np.abs(w - jres.eigenvalues) / np.abs(true_k) < 1e-10)


def test_polished_restarted_filtered_on_the_mesh(ranks):
    exact = J.lap_exact(24, 24, 4)
    for case, rtol in (("polished", 1e-8), ("restarted", 1e-9),
                       ("filtered", 1e-9)):
        assert bool(ranks[0][f"{case}__converged"]), case
        np.testing.assert_allclose(np.sort(ranks[0][f"{case}__w"])[::-1],
                                   exact, rtol=rtol, err_msg=case)


def test_polished_matches_jax_on_its_mesh(ranks, jmesh):
    jres = rt.rbl_polished(
        JD.ShardedLaplacian2D(nx=24, ny=24, mesh=jmesh, _dtype=jnp.float64),
        4, cfg=rt.RBLConfig(block_size=2, tol=1e-7, mesh=jmesh), b=2)
    np.testing.assert_allclose(np.sort(ranks[0]["polished__w"]),
                               np.sort(jres.eigenvalues), rtol=1e-8)


@pytest.mark.parametrize("case", ["svd_sparse", "svd_dense"])
def test_sharded_svd(case, ranks, jmesh):
    B = J.svd_sparse() if case == "svd_sparse" else J.svd_dense()
    Bd = B.toarray() if sp.issparse(B) else B
    s = ranks[0][f"{case}__s"]
    np.testing.assert_allclose(s, np.linalg.svd(Bd, compute_uv=False)[:4],
                               rtol=1e-8)
    U, V = ranks[0][f"{case}__U"], ranks[0][f"{case}__V"]
    np.testing.assert_allclose(Bd @ V, U * s[None, :], atol=1e-8 * s[0])
    jres = rt.rbl_svd(B, 4, b=4, cfg=rt.RBLConfig(mesh=jmesh, block_size=4))
    np.testing.assert_allclose(s, jres.s, rtol=1e-8)


def test_sharded_pencil(ranks):
    """tests/test_distributed.py's sharded pencil (A and M ShardedCooSpMM):
    the LA end through the Chebyshev M^(-1/2) series, and a shift-invert
    probe (blocked MINRES on the rank's rows, Jacobi from the sharded
    diagonals, the quantile over the whole diagonal), against scipy."""
    _A, _M, w = J.pencil()
    np.testing.assert_allclose(ranks[0]["pencil_la__w"], w[::-1][:4],
                               rtol=1e-10)
    assert bool(ranks[0]["pencil_la__converged"])
    sig = J.pencil_sigma(w)
    exact = w[np.argsort(np.abs(w - sig), kind="stable")[:2]]
    np.testing.assert_allclose(ranks[0]["pencil_sigma__w"], exact, rtol=1e-9)


def test_pencil_with_a_lumped_mass_applied_replicated(ranks):
    """A diagonal M under the mesh takes the exact fast path (the rank's
    rows of M^(-1/2)), against scipy's generalized eigh."""
    import scipy.linalg

    w = scipy.linalg.eigh(J.coo256().toarray(),
                          np.diag(np.linspace(1.0, 2.0, 256)),
                          eigvals_only=True)
    np.testing.assert_allclose(ranks[0]["pencil_lumped__w"], w[::-1][:3],
                               rtol=1e-9)


def test_shift_invert_and_smallest_triplets_on_the_mesh(ranks):
    """ShiftInvertOperator over the sharded 8² stencil at σ = 0 (θ = 1/λ),
    and rbl_svd(which="SM") on sharded sparse factors and on a dense
    factor applied replicated, against numpy."""
    ex = 2 - 2 * np.cos(np.pi * np.arange(1, 9) / 9)
    lam = np.sort(np.add.outer(ex, ex).ravel())
    np.testing.assert_allclose(np.sort(ranks[0]["si_lap__w"]),
                               np.sort(1.0 / lam[:2]), rtol=1e-9)
    for case, B in (("svd_sm_sparse", J.svd_sparse_sm().toarray()),
                    ("svd_sm_dense", J.svd_dense())):
        s = ranks[0][f"{case}__s"]
        np.testing.assert_allclose(np.sort(s),
                                   np.sort(np.linalg.svd(B, compute_uv=False))[:2],
                                   rtol=1e-8, err_msg=case)
        U, V = ranks[0][f"{case}__U"], ranks[0][f"{case}__V"]
        np.testing.assert_allclose(B @ V, U * s[None, :], atol=1e-8,
                                   err_msg=case)


def test_sweep_checkpoint_on_the_mesh_crosses_to_jax(ranks, tmp_path):
    """A sweep cut after 3 chunks on 2 ranks leaves one file of whole
    blocks (rank 0's write, the JAX package's keys); resumed on the mesh
    it ends with the uninterrupted solve's eigenvalues and removes the
    file; the JAX package resumes the same cut file on one device."""
    import shutil

    from rbl_tpu.utils.checkpoint import load_sweep_state

    assert bool(ranks[0]["ck_sweep__aborted"]) and bool(ranks[1]["ck_sweep__aborted"])
    assert not bool(ranks[0]["ck_sweep__left"])
    np.testing.assert_allclose(ranks[0]["ck_sweep__w"], ranks[0]["lap__w"],
                               rtol=1e-12)
    cut = tmp_path / "cut.npz"
    shutil.copy(ranks[0]["_outdir"].item() + "/sweep_cut.npz", cut)
    st = load_sweep_state(str(cut))
    assert st["basis"].shape[0] == 32 * 32 and st["Q_i"].shape == (32 * 32, 4)
    jres = rt.rbl(rt.Laplacian2D(nx=32, ny=32), 4, 4, cfg=rt.RBLConfig(
        block_size=4, max_kryl_dim=256, sweep_checkpoint_path=str(cut)))
    np.testing.assert_allclose(jres.eigenvalues, J.lap_exact(32, 32, 4),
                               rtol=1e-9)


def test_restart_and_polish_checkpoints_on_the_mesh(ranks):
    """rbl_restarted resumed from a mesh-written restart file, and the
    polish restarted from its one-pass X (whole rows), both to the gates."""
    exact = J.lap_exact(24, 24, 4)
    np.testing.assert_allclose(np.sort(ranks[0]["ck_restart__w"])[::-1],
                               exact, rtol=1e-9)
    assert bool(ranks[0]["ck_restart__converged"])
    assert not bool(ranks[0]["ck_polish__first_converged"])
    assert int(ranks[0]["ck_polish__rows"]) == 24 * 24
    np.testing.assert_allclose(np.sort(ranks[0]["ck_polish__w"])[::-1],
                               exact, rtol=1e-8)
    assert bool(ranks[0]["ck_polish__converged"])
    assert not bool(ranks[0]["ck_polish__left"])


@pytest.mark.parametrize("case", ["f64", "bf16"])
def test_checkpoint_save_gathers_to_rank_zero_only(case, ranks):
    """A save on the mesh sends each rank's rows to rank 0's host, with no
    all-gather on any rank; rank 0's file holds the whole block (bf16
    upcast to f32, as a single device writes it)."""
    import torch

    for rk in ranks:
        assert list(rk[f"ck_gather_{case}__counts"]) == [0, 1]
    X = J.gather_block()
    if case == "bf16":
        X = torch.from_numpy(X).to(torch.bfloat16).float().double().numpy()
    with np.load(ranks[0]["_outdir"].item() + f"/gathered_{case}.npz") as z:
        assert z["X"].shape == (J.GATHER_N, 3)
        assert np.array_equal(z["X"], X)


def test_failed_checkpoint_write_raises_on_every_rank(ranks):
    """The write fails on rank 0 (its directory does not exist): rank 0
    raises the write's own error and rank 1 raises too, after the ranks
    agree, instead of waiting for a file that never comes."""
    assert str(ranks[0]["ck_fail__raised"]) == "FileNotFoundError"
    assert str(ranks[1]["ck_fail__raised"]) == "RuntimeError"


def test_householder_on_the_mesh(ranks):
    """Householder on row slabs (289 and 288 rows) needs the global n; its
    Q equals the single-device Q up to column signs and R is replicated."""
    assert str(ranks[0]["qr__no_n"]) == "ValueError"
    Q1, R1 = np.linalg.qr(J.gather_block())
    Q, R = ranks[0]["qr__Q"], ranks[0]["qr__R"]
    s = np.sign(np.diag(R)) * np.sign(np.diag(R1))
    np.testing.assert_allclose(Q * s[None, :], Q1, atol=1e-12)
    np.testing.assert_allclose(R * s[:, None], R1, atol=1e-12)
    assert ranks[1]["qr__R"].tobytes() == R.tobytes()


def test_poll_race_ranks_agree(ranks):
    """Rank 0's polls were done at once, rank 1's only when waited for:
    every non-blocking harvest asked the mesh (an all-reduce MIN of
    done()), rank 0 was overruled there, and both ranks still finished
    with the same converged spectrum.  Without the agreement rank 0 would
    harvest alone, and the ranks would diverge or hang."""
    for rk in ranks:
        assert int(rk["race__agree"]) > 0
    assert int(ranks[0]["race__overruled"]) == int(ranks[0]["race__agree"])
    assert int(ranks[1]["race__overruled"]) == 0
    np.testing.assert_allclose(ranks[0]["race__w"],
                               J.lap_exact(J.RACE_NX, J.RACE_NX, J.RACE_K),
                               rtol=1e-9)
    assert bool(ranks[0]["race__converged"])


def test_fault_retry_on_the_mesh(ranks):
    """FloatingPointError injected into both ranks' first dispatch of
    _rbl_impl: both re-dispatch together and end where the solve without
    a fault ends; an OOM on the mesh propagates at the first dispatch (one
    rank's OOM would leave the others in a collective)."""
    for rk in ranks:
        assert int(rk["retry__dispatches"]) == 2
        assert str(rk["retry__raised"]) == "nothing"
        np.testing.assert_allclose(rk["retry__w"], rk["lap__w"], rtol=1e-12)
        assert int(rk["retry_oom__dispatches"]) == 1
        assert str(rk["retry_oom__raised"]) == "OutOfMemoryError"
    np.testing.assert_allclose(ranks[0]["retry__w"], J.lap_exact(32, 32, 4),
                               rtol=1e-9)


def test_cluster_info_keys(ranks):
    from rbl_tpu.parallel.distributed import cluster_info

    want = sorted(cluster_info())
    for r, rk in enumerate(ranks):
        assert list(rk["info__keys"]) == want
        assert list(rk["info__count"]) == [r, J.SOLVE_RANKS, J.SOLVE_RANKS]


def test_make_row_mesh_needs_a_card():
    import torch

    from rbl_tpu_torch.parallel.mesh import make_row_mesh as torch_mesh

    if torch.cuda.device_count():
        pytest.skip("a card is present")  # the check needs a CPU-only machine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_mesh()


def test_config_from_fields_refuses_a_jax_mesh(jmesh):
    from rbl_tpu_torch.utils.convert import config_from_fields

    with pytest.raises(TypeError, match="RowMesh"):
        config_from_fields(dict(block_size=4, mesh=jmesh))
    assert config_from_fields(dict(block_size=4, mesh=None)).mesh is None
