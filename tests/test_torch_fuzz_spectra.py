"""tests/test_fuzz_spectra.py on the port, on the CPU: every spectrum shape,
seed and configuration of the JAX package's fuzz, against the exact
diagonal spectrum at its 1e-10 gate (each relative error), the sparse
operators against ARPACK, f32 exhaustion, the restarted sweeps and the
generalized pencils.  The cases live in tests/_torch_gates.py, which
chip_smoke.py's phase 26 runs on the card.  The mesh case
("gap_clusters" under a row mesh) runs in tests/_torch_parallel_job.py's
solve job.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import rbl_tpu_torch as rtt
from _torch_gates import (
    F32_HEAD_TOL,
    FUZZ_TOL,
    HOST_OFFLOAD_SHAPES,
    RESTARTED_SHAPES,
    SHAPES,
    SPARSE_CASES,
    f32_exhaustion,
    f32_exhaustion_head_error,
    fuzz_case,
    restarted_case,
    sparse_vs_eigsh,
)
from _torch_parity import CPU


def _check(case):
    rel, res = fuzz_case(case, CPU)
    assert np.all(rel < FUZZ_TOL), (
        f"{case}: rel errors {rel}, got {res.eigenvalues}, "
        f"converged={res.converged}, kryl={res.kryl_dim}"
    )


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_spectrum(shape, seed):
    _check(f"fuzz_{shape}_seed{seed}")


@pytest.mark.parametrize("shape", HOST_OFFLOAD_SHAPES)
def test_fuzz_spectrum_with_host_offload(shape):
    """The two-tier basis store: leaks along offloaded dominant directions
    re-amplify per step, a regime the all-device cases cannot reach."""
    _check(f"host_offload_{shape}")


def test_fuzz_grown_chunks_narrow_window():
    """A slowly separating spectrum whose convergence window is narrower
    than a grown chunk."""
    _check("grown_chunks_narrow_window")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fuzz_spectrum_adaptive_reorth(shape):
    """The adaptive full-scrub stretch must snap back before any ghost
    regime exploits the sparser scrubs: the fixed-cadence gate holds."""
    _check(f"adaptive_{shape}")


def test_fuzz_adaptive_reorth_slow_separation():
    """Maximum stretch and grown chunks on the calmest spectrum."""
    _check("adaptive_slow_separation")


def test_fuzz_negative_dominant():
    """The largest-|λ| eigenvalue is negative."""
    _check("negative_dominant")


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_fuzz_sparse_operators_vs_eigsh(case):
    """Solves on sparse operators (layout routing and solver together)
    against ARPACK."""
    rel, res = sparse_vs_eigsh(case, CPU)
    assert res.converged
    assert np.all(rel < FUZZ_TOL), (res.eigenvalues, rel)


@pytest.mark.slow
def test_f32_large_laplacian_no_false_convergence():
    """Large-n f32 on the bench's clustered top: a false convergence with
    eigenvalues 10% off while the bounds read 1e-7 must not come back."""
    nx = ny = 256
    op = rtt.Laplacian2D(nx, ny, dtype=torch.float32, device=CPU)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:20]
    cfg = rtt.RBLConfig(
        block_size=8, basis_dtype=torch.float32, compute_dtype=torch.float32,
        qr_method="cholqr2", tol=1e-3, max_kryl_dim=512, eig_poll_cadence=16,
        device=CPU,
    )
    res = rtt.rbl(op, 20, cfg=cfg)
    rel = np.abs(res.eigenvalues - lam) / lam
    assert np.max(rel) < 0.02, (res.eigenvalues[:5], lam[:5])
    if res.converged:
        assert np.max(res.residual_bounds) < 10 * cfg.tol


def test_f32_precision_exhaustion_graceful():
    """f32 past eps's resolvable dominance: finite values, finite true
    residuals, the dominant and structural pairs still right."""
    res, true_top = f32_exhaustion(CPU)
    assert f32_exhaustion_head_error(res, true_top) < F32_HEAD_TOL


@pytest.mark.parametrize("shape", sorted(RESTARTED_SHAPES))
def test_fuzz_restarted(shape):
    """The restarted sweep against its lock set on the spectra that broke
    the earlier fixed-length sweep."""
    rel, res = restarted_case(shape, CPU)
    assert res.converged
    assert np.all(rel < FUZZ_TOL), (res.eigenvalues, rel)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_generalized_pencils(seed):
    """Random SPD pencils through rbl_generalized against the dense
    scipy.linalg.eigh(A, M): both ends and one interior probe."""
    rng = np.random.default_rng(100 + seed)
    n = 260
    A = sp.random(n, n, density=0.03, random_state=seed + 1)
    A = sp.csr_matrix(A + A.T)
    A.setdiag(rng.standard_normal(n) * 3.0)
    Md = sp.random(n, n, density=0.02, random_state=seed + 50)
    Md = (Md + Md.T) * 0.1
    Md.setdiag(rng.uniform(1.0, 3.0, n))
    M = sp.csr_matrix(Md)
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    cfg = rtt.RBLConfig(block_size=4, tol=1e-9, device=CPU)
    for which, exact in (("LA", w[::-1][:4]), ("SA", w[:4])):
        res = rtt.rbl_generalized(A, M, 4, cfg=cfg, which=which)
        assert res.converged, (seed, which)
        rel = np.max(np.abs(res.eigenvalues - exact)
                     / np.maximum(np.abs(exact), 1e-12))
        assert rel < 1e-8, (seed, which, rel)
    sig = w[n // 2] + 0.29 * (w[n // 2 + 1] - w[n // 2])
    res = rtt.rbl_generalized(A, M, 3, cfg=cfg, which="LM", sigma=sig)
    exact = w[np.argsort(np.abs(w - sig), kind="stable")[:3]]
    rel = np.max(np.abs(res.eigenvalues - exact) / np.abs(exact))
    assert rel < 1e-8, (seed, rel)
