"""``rbl_filtered``, ``chebyshev_refine`` and ``rbl_polished`` of the port on
the CPU, against the truth and the JAX package.

Solves compare eigenvalues and residuals, never vectors (the random
generators differ).  Tolerances: 1e-12 relative between the packages'
``chebyshev_refine`` from the same warm block (both are Rayleigh–Ritz
values of subspaces converged to tol 1e-9), 1e-9 relative against the
analytic spectrum elsewhere.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.solver import filtered as jfiltered

import rbl_tpu_torch as rtt
from _torch_parity import CPU
from rbl_tpu_torch.solver import filtered as tfiltered
from rbl_tpu_torch.solver import polish as tpolish
from rbl_tpu_torch.utils.checkpoint import load_polish_state

NX = 20


def _lap_spectrum(nx=NX):
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())


def _lap(nx=NX):
    return rtt.Laplacian2D(nx, nx, dtype=torch.float64, device=CPU)


def _true_residuals(res, nx=NX):
    V = res.eigenvectors
    R = _lap(nx).apply(V.contiguous()) - V * torch.as_tensor(res.eigenvalues.copy())[None, :]
    return torch.linalg.norm(R, dim=0).numpy()


@pytest.mark.parametrize("which", ["LA", "SA"])
def test_filtered_ends_with_info(which):
    """Auto cutoff and degree: the wanted end to 1e-9 relative with true
    residuals ≤ 10·tol, in rbl's order (LA descending, SA ascending), and
    a FilterInfo that describes the filter used."""
    lam = _lap_spectrum()
    k = 6
    res, info = rtt.rbl_filtered(_lap(), k, 4, cfg=rtt.RBLConfig(tol=1e-8),
                                 which=which, return_info=True)
    want = lam[::-1][:k] if which == "LA" else lam[:k]
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, want, rtol=1e-9)
    assert _true_residuals(res).max() <= 1e-7
    np.testing.assert_allclose(res.residual_bounds, _true_residuals(res), atol=1e-10)
    lo, hi = info.bounds
    assert lo < info.cutoff < hi and 6 <= info.degree <= 200
    assert info.presweep_kryl > 0 and 0 < info.tau <= 1e-3 * 1.0001
    assert info.degree == jfiltered._auto_degree(lo, info.cutoff, hi, 1e-3)


def test_filtered_matches_jax_given_the_same_cutoff():
    """The same explicit cutoff and PSD bounds through both packages: the
    same auto degree, and eigenvalues equal to 1e-9 relative."""
    lam = _lap_spectrum()
    k, cutoff, bounds = 6, 7.2, (0.0, 8.0)
    jres, jinfo = rbl_tpu.rbl_filtered(
        rbl_tpu.Laplacian2D(nx=NX, ny=NX, _dtype=jnp.float64), k, 4,
        cfg=rbl_tpu.RBLConfig(tol=1e-8), cutoff=cutoff, bounds=bounds,
        return_info=True)
    tres, tinfo = rtt.rbl_filtered(_lap(), k, 4, cfg=rtt.RBLConfig(tol=1e-8),
                                   cutoff=cutoff, bounds=bounds, return_info=True)
    assert tinfo.degree == jinfo.degree and tinfo.presweep_kryl == 0
    assert tinfo.cutoff == jinfo.cutoff and abs(tinfo.tau - jinfo.tau) < 1e-12
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, lam[::-1][:k], rtol=1e-9)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=1e-9)


def test_filtered_bisects_an_overshot_cutoff_and_checks_arguments(monkeypatch):
    """A pre-sweep estimate above λ_k damps wanted pairs: the solve detects
    it (a recovered λ under the filter edge) and bisects toward the
    certified floor; an explicit cutoff is never moved."""
    lam = _lap_spectrum()
    k = 6
    real = tfiltered._presweep_cutoff

    def overshoot(op, k_, pad, cfg, hi):
        cut, floor, top, m = real(op, k_, pad, cfg, hi)
        return lam[-3], floor, top, m  # above λ_4..λ_6 from the top

    monkeypatch.setattr(tfiltered, "_presweep_cutoff", overshoot)
    res, info = rtt.rbl_filtered(_lap(), k, 4, cfg=rtt.RBLConfig(tol=1e-8),
                                 return_info=True)
    assert info.cutoff < lam[-3] and res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[::-1][:k], rtol=1e-9)
    with pytest.raises(ValueError, match="LM cannot be filtered"):
        rtt.rbl_filtered(_lap(), k, which="LM")
    with pytest.raises(ValueError, match="not an interval"):
        rtt.rbl_filtered(_lap(), k, bounds=(3.0, 1.0))
    with pytest.raises(ValueError, match="out of range"):
        rtt.rbl_filtered(_lap(), 0)


def _warm_block(k, extra, noise, seed=0, nx=NX):
    """The true top-(k+extra) eigenvectors of the Laplacian, perturbed."""
    n = nx * nx
    j = np.arange(1, nx + 1)
    S = np.sqrt(2.0 / (nx + 1)) * np.sin(np.pi * np.outer(j, j) / (nx + 1))
    ev1 = 2 - 2 * np.cos(np.pi * j / (nx + 1))
    order = np.argsort(-np.add.outer(ev1, ev1).ravel())[: k + extra]
    V = np.stack([np.kron(S[:, p // nx], S[:, p % nx]) for p in order], axis=1)
    return V + noise * np.random.default_rng(seed).standard_normal((n, k + extra))


def test_chebyshev_refine_matches_jax_from_the_same_warm_block():
    """Both packages polish the same warm block (no random pad) with the
    same certified bounds: eigenvalues equal to 1e-12 relative, pass counts
    within one, residuals under tol."""
    lam = _lap_spectrum()
    k = 8
    warm = _warm_block(k, 8, 1e-3)
    kw = dict(which="LA", bounds=(0.0, 8.0), extra_random=0)
    jres = rbl_tpu.chebyshev_refine(
        rbl_tpu.Laplacian2D(nx=NX, ny=NX, _dtype=jnp.float64), warm, k,
        cfg=rbl_tpu.RBLConfig(tol=1e-9), **kw)
    tres = rtt.chebyshev_refine(_lap(), warm, k, cfg=rtt.RBLConfig(tol=1e-9), **kw)
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, lam[::-1][:k], rtol=1e-12)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=1e-12)
    assert abs(tres.iterations - jres.iterations) <= 1
    assert tres.kryl_dim == jres.kryl_dim == 16
    assert tres.residual_bounds.max() < 1e-9 and _true_residuals(tres).max() < 1e-8


@pytest.mark.parametrize("which", ["LM", "LA", "SA"])
def test_chebyshev_refine_each_end(which):
    """A mixed-sign diagonal: LM (symmetric damped interval), LA and SA
    (solved as LA of −A, bounds mapped) from a noisy warm block plus the
    default random pad."""
    n, k = 300, 4
    d = np.concatenate([np.linspace(-60.0, -50.0, 6), np.linspace(-5.0, 30.0, n - 6)])
    order = {"LM": np.argsort(-np.abs(d)), "LA": np.argsort(-d), "SA": np.argsort(d)}[which]
    warm = np.zeros((n, k + 4))
    warm[order[: k + 4], np.arange(k + 4)] = 1.0
    warm += 1e-3 * np.random.default_rng(1).standard_normal(warm.shape)
    res = rtt.chebyshev_refine(rtt.DiagonalOperator(torch.from_numpy(d)), warm, k,
                               cfg=rtt.RBLConfig(tol=1e-9, block_size=2), which=which)
    assert res.converged and res.kryl_dim == k + 4 + 2
    np.testing.assert_allclose(res.eigenvalues, d[order[:k]], rtol=1e-10)
    V = res.eigenvectors.numpy()
    assert np.linalg.norm(d[:, None] * V - V * res.eigenvalues[None, :], axis=0).max() < 1e-8


@pytest.mark.parametrize("filter_dtype", ["auto", "compute"])
def test_filter_dtype_modes(filter_dtype, monkeypatch):
    """"auto" runs the early filter chains in f32 and the last in f64;
    "compute" pins every chain to f64.  Same eigenvalues (1e-12)."""
    seen = []
    real = tpolish._filter_only
    monkeypatch.setattr(tpolish, "_filter_only",
                        lambda op, X, a, b, degree, fdt=None: seen.append(fdt)
                        or real(op, X, a, b, degree, fdt=fdt))
    lam = _lap_spectrum()
    k = 6
    res = rtt.chebyshev_refine(_lap(), _warm_block(k, 6, 1e-2), k,
                               cfg=rtt.RBLConfig(tol=1e-10), which="LA",
                               bounds=(0.0, None), filter_dtype=filter_dtype)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[::-1][:k], rtol=1e-12)
    if filter_dtype == "auto":
        assert seen[0] == torch.float32 and seen[-1] is None
    else:
        assert all(f is None for f in seen)
    with pytest.raises(ValueError, match="filter_dtype"):
        rtt.chebyshev_refine(_lap(), _warm_block(k, 6, 1e-2), k, filter_dtype="f16")


def test_refine_checkpoint_written_each_pass_and_removed_on_success(tmp_path):
    lam = _lap_spectrum()
    k = 6
    path = str(tmp_path / "polish.npz")
    warm = _warm_block(k, 6, 1e-2)
    cfg = rtt.RBLConfig(tol=1e-10)
    cut = rtt.chebyshev_refine(_lap(), warm, k, cfg=cfg, which="LA", max_passes=2,
                               checkpoint_path=path)
    assert not cut.converged and os.path.exists(path)  # kept: the solve is not done
    st = load_polish_state(path)
    assert st["X"].shape == (NX * NX, cut.kryl_dim) and st["npass"] == 1
    # what solve_with_retry did in the JAX package is open to the caller
    res = rtt.chebyshev_refine(_lap(), st["X"], k, cfg=cfg, which="LA",
                               extra_random=0, checkpoint_path=path)
    assert res.converged and not os.path.exists(path)
    np.testing.assert_allclose(res.eigenvalues, lam[::-1][:k], rtol=1e-12)
    # a stale file is never read: garbage at the path changes nothing
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    again = rtt.chebyshev_refine(_lap(), warm, k, cfg=cfg, which="LA",
                                 checkpoint_path=path)
    assert again.converged and not os.path.exists(path)


def test_polished_warm_matches_jax():
    """The two-stage solve in both packages (f32 discovery, f64 polish):
    each reaches the analytic top-k to 1e-12 with residuals under tol."""
    lam = _lap_spectrum()
    k = 6
    kw = dict(b=4, bounds=(0.0, None), buffer=8)
    jres = rbl_tpu.rbl_polished(rbl_tpu.Laplacian2D(nx=NX, ny=NX, _dtype=jnp.float64),
                                k, cfg=rbl_tpu.RBLConfig(tol=1e-9), **kw)
    tres = rtt.rbl_polished(_lap(), k, cfg=rtt.RBLConfig(tol=1e-9), **kw)
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, lam[::-1][:k], rtol=1e-12)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=1e-12)
    assert tres.residual_bounds.max() < 1e-9
    assert tres.kryl_dim == jres.kryl_dim == k + 8 + 4
    assert tres.eigenvectors.dtype == torch.float64


@pytest.mark.parametrize("kryl,first_sweep", [(None, 16), (48, 48)])
def test_polished_cold_fallback_goes_through_rbl_restarted(monkeypatch, tmp_path,
                                                           kryl, first_sweep):
    """A coarse stage that returns garbage (non-finite vectors): the solve
    falls back to a cold f64 ``rbl_restarted`` with the derived sweep
    length, which checkpoints at restart boundaries.  The first sweep is
    the JAX package's max(8b, 2k) rounded up to b, or the caller's
    ``cfg.restart_kryl_dim``."""
    from rbl_tpu_torch.solver import restarted as trestarted

    lam = _lap_spectrum()
    k, b = 4, 2
    real = tpolish.rbl
    real_restarted = trestarted.rbl_restarted
    calls = []
    sweeps = []

    def spy(A, k_, cfg=None, **kw):
        sweeps.append(cfg.restart_kryl_dim)
        return real_restarted(A, k_, cfg=cfg, **kw)

    def garbage(A, k_, cfg=None, **kw):
        res = real(A, k_, cfg=cfg, **kw)
        res.eigenvectors = res.eigenvectors * float("nan")
        calls.append(cfg.compute_dtype)
        return res

    monkeypatch.setattr(tpolish, "rbl", garbage)
    monkeypatch.setattr(trestarted, "rbl_restarted", spy)
    path = str(tmp_path / "cold.npz")
    cfg = rtt.RBLConfig(tol=1e-8)
    if kryl is not None:
        cfg = cfg.replace(restart_kryl_dim=kryl)
    res = rtt.rbl_polished(_lap(), k, cfg=cfg, b=b, checkpoint_path=path)
    assert calls == [torch.float32] and sweeps == [first_sweep]
    assert res.converged and os.path.exists(path)  # the restart-boundary file
    np.testing.assert_allclose(res.eigenvalues, lam[::-1][:k], rtol=1e-9)
    # iterations counts restarts on this path
    assert res.kryl_dim >= first_sweep and res.iterations >= 1


@pytest.mark.parametrize("entry", [
    "rbl_restarted", "rbl_filtered", "chebyshev_refine", "rbl_polished",
    "rbl_svd_dense", "rbl_svd_sparse", "capped_rbl",
])
def test_new_entry_points_raise_without_a_card(entry, monkeypatch):
    """device=None means the card: with none, host data raises the
    resolve_device error and nothing runs on the CPU unasked."""
    import scipy.sparse as sp

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    A = sp.diags(np.arange(1.0, 41.0)).tocsr()
    B = np.random.default_rng(0).standard_normal((30, 12))
    call = {
        "rbl_restarted": lambda: rtt.rbl_restarted(A, 2),
        "rbl_filtered": lambda: rtt.rbl_filtered(A, 2),
        "chebyshev_refine": lambda: rtt.chebyshev_refine(A, np.eye(40)[:, :3], 2),
        "rbl_polished": lambda: rtt.rbl_polished(A, 2),
        "rbl_svd_dense": lambda: rtt.rbl_svd(B, 2),
        "rbl_svd_sparse": lambda: rtt.rbl_svd(sp.csr_matrix(B), 2),
        "capped_rbl": lambda: rtt.rbl(A, 2, 2, cfg=rtt.RBLConfig(basis_device_cap_cols=16)),
    }[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
