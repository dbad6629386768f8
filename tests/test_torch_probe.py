"""Device probes and the fault retry of the port (rbl_tpu_torch/utils/
probe.py) against tests/test_probe.py: each case of the JAX package's
file has its counterpart here, with the same structure and assertions.
``test_retry_catches_xla_runtime_error`` becomes the port's retryable
set: an injected ``torch.OutOfMemoryError`` is retried.  Then the port's
own cases: the retry of ``chebyshev_refine`` and ``rbl_polished``, a
plain ``RuntimeError`` never retried, a checkpoint that an earlier solve
left never read by a retry (and the failed attempt's own read), the mesh
rule and ``resolve_fault_retries``.  One case runs the JAX package's
solver-level retry and the port's on the same seeded diagonal.
"""

import os

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 — caps torch's threads
import rbl_tpu_torch as rtt
from rbl_tpu_torch.solver.lanczos import LanczosResult
from rbl_tpu_torch.utils.probe import (
    _retryable_exceptions,
    backend_healthy,
    dispatch,
    resolve_fault_retries,
    solve_with_retry,
    wait_until_healthy,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread: OpenBLAS's spinning threads slow this file's many
    small host factorizations ~10x when the tier-1 workers share the
    cores."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _result(vals):
    return LanczosResult(
        eigenvalues=np.asarray(vals), eigenvectors=None,
        iterations=1, kryl_dim=8, converged=True,
    )


def _diag(d):
    return rtt.DiagonalOperator(torch.from_numpy(np.asarray(d, dtype=np.float64)))


def test_backend_healthy_on_cpu():
    assert backend_healthy(device=CPU)
    assert wait_until_healthy(attempts=1, sleep_s=0, device=CPU)


def test_backend_unhealthy_without_a_card(monkeypatch):
    # the default device is the card: with none, the probes fail instead
    # of passing on the host
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not backend_healthy()
    assert not wait_until_healthy(attempts=2, sleep_s=0)


def test_retry_after_floating_point_error():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise FloatingPointError("non-finite T blocks (injected)")
        return _result([3.0, 2.0])

    res = solve_with_retry(flaky, retries=1, attempts=1, sleep_s=0, device=CPU)
    assert calls["n"] == 2
    np.testing.assert_allclose(res.eigenvalues, [3.0, 2.0])


def test_retry_after_nonfinite_result():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            return _result([np.nan, 2.0])
        return _result([3.0, 2.0])

    res = solve_with_retry(flaky, retries=2, attempts=1, sleep_s=0, device=CPU)
    assert calls["n"] == 2
    assert np.all(np.isfinite(res.eigenvalues))


def test_exhausted_retries_propagate_error():
    def always_bad():
        raise FloatingPointError("injected")

    with pytest.raises(FloatingPointError):
        solve_with_retry(always_bad, retries=1, attempts=1, sleep_s=0,
                         device=CPU)


def test_exhausted_retries_return_last_result():
    # genuine numerical failure (always non-finite) must still surface —
    # the final attempt's result returns as-is for the caller to inspect
    res = solve_with_retry(
        lambda: _result([np.nan]), retries=1, attempts=1, sleep_s=0,
        device=CPU,
    )
    assert np.isnan(res.eigenvalues).all()


def test_retry_catches_out_of_memory(monkeypatch):
    # CUDA's out-of-memory error is retried, after the allocator's cache
    # is released
    excs = _retryable_exceptions()
    assert excs == (FloatingPointError, torch.OutOfMemoryError)
    freed = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: freed.append(1))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return _result([3.0])

    res = solve_with_retry(flaky, retries=1, attempts=1, sleep_s=0, device=CPU)
    assert calls["n"] == 2 and freed == [1]
    np.testing.assert_allclose(res.eigenvalues, [3.0])


@pytest.mark.parametrize("exc", [RuntimeError, torch.AcceleratorError])
def test_runtime_error_not_retried(exc):
    # a sticky CUDA error kills the context: it propagates at once instead
    # of waiting out the health probes
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise exc("an illegal memory access was encountered (injected)")

    with pytest.raises(exc):
        solve_with_retry(broken, retries=3, attempts=1, sleep_s=0, device=CPU)
    assert calls["n"] == 1


def _nan_first_start(monkeypatch, module):
    real = module.random_start_block
    calls = {"n": 0}

    def flaky(*a, **kw):
        blk = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            return torch.full_like(blk, torch.nan)
        return blk

    monkeypatch.setattr(module, "random_start_block", flaky)
    return calls


def test_solver_level_fault_retry_rbl(monkeypatch):
    """An injected garbage start block fires the non-finite-T guard; with
    cfg.fault_retries=1 the solve re-dispatches and completes, with 0 it
    propagates."""
    import rbl_tpu_torch.solver.rbl as rblmod

    calls = _nan_first_start(monkeypatch, rblmod)
    d = np.arange(1.0, 301.0)
    cfg = rtt.RBLConfig(tol=1e-8, block_size=4, fault_retries=1, seed=0,
                        device=CPU)
    res = rtt.rbl(_diag(d), 5, cfg=cfg)
    assert res.converged and calls["n"] >= 2
    np.testing.assert_allclose(res.eigenvalues, d[::-1][:5], rtol=1e-10)

    calls["n"] = 0
    with pytest.raises(FloatingPointError):
        rtt.rbl(_diag(d), 5, cfg=cfg.replace(fault_retries=0))


def test_solver_level_fault_retry_restarted(monkeypatch):
    import rbl_tpu_torch.solver.restarted as rmod

    calls = _nan_first_start(monkeypatch, rmod)
    d = np.arange(1.0, 301.0)
    cfg = rtt.RBLConfig(tol=1e-7, block_size=2, restart_kryl_dim=24,
                        fault_retries=1, seed=0, device=CPU)
    res = rtt.rbl_restarted(_diag(d), 4, b=2, cfg=cfg)
    assert res.converged and calls["n"] >= 2
    np.testing.assert_allclose(
        np.sort(res.eigenvalues)[::-1], d[::-1][:4], rtol=1e-9
    )


def test_custom_validate():
    # validator sees the result; a False verdict triggers the retry path
    seen = []

    def solve():
        return _result([1.0])

    def validate(res):
        seen.append(res)
        return len(seen) >= 2

    res = solve_with_retry(solve, retries=3, attempts=1, sleep_s=0,
                           validate=validate, device=CPU)
    assert len(seen) == 2
    np.testing.assert_allclose(res.eigenvalues, [1.0])


def test_retried_solve_matches_jax(monkeypatch):
    """The JAX package's solver-level retry and the port's on the same
    seeded diagonal, each with a garbage first start block: both
    re-dispatch, and the retried eigenvalues agree at 1e-10."""
    import jax.numpy as jnp

    import rbl_tpu as rt
    import rbl_tpu.solver.rbl as jrblmod
    import rbl_tpu_torch.solver.rbl as rblmod
    from rbl_tpu.config import RBLConfig as JCfg

    jreal = jrblmod.random_start_block
    jcalls = {"n": 0}

    def jflaky(*a, **kw):
        blk = jreal(*a, **kw)
        jcalls["n"] += 1
        return jnp.full_like(blk, jnp.nan) if jcalls["n"] == 1 else blk

    monkeypatch.setattr(jrblmod, "random_start_block", jflaky)
    calls = _nan_first_start(monkeypatch, rblmod)
    d = np.sort(np.random.default_rng(7).uniform(1.0, 50.0, 400))
    jres = rt.rbl(rt.DiagonalOperator(jnp.asarray(d)), 6, cfg=JCfg(
        tol=1e-9, block_size=4, fault_retries=1, seed=0))
    tres = rtt.rbl(_diag(d), 6, cfg=rtt.RBLConfig(
        tol=1e-9, block_size=4, fault_retries=1, seed=0, device=CPU))
    assert jcalls["n"] >= 2 and calls["n"] >= 2
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, np.asarray(jres.eigenvalues),
                               rtol=1e-10)
    np.testing.assert_allclose(tres.eigenvalues, d[::-1][:6], rtol=1e-10)


def _raise_first(monkeypatch, module, name, exc):
    """Make ``module.name`` raise ``exc`` on its first call; returns the
    call count."""
    real = getattr(module, name)
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise exc("injected")
        return real(*a, **kw)

    monkeypatch.setattr(module, name, flaky)
    return calls


def _lap(nx=16, ny=15):
    return rtt.Laplacian2D(nx, ny, dtype=torch.float64, device=CPU)


def _lap_top(nx=16, ny=15, k=4):
    ex = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    ey = 2 - 2 * np.cos(np.pi * np.arange(1, ny + 1) / (ny + 1))
    return np.sort(np.add.outer(ex, ey).ravel())[::-1][:k]


@pytest.mark.parametrize("exc", [FloatingPointError, torch.OutOfMemoryError])
def test_solver_level_fault_retry_chebyshev_refine(monkeypatch, exc):
    """chebyshev_refine, and so rbl_polished's polish stage, re-dispatches
    once after the guard's error or an OOM; with retries 0 it
    propagates."""
    import rbl_tpu_torch.solver.polish as pmod

    calls = _raise_first(monkeypatch, pmod, "_chebyshev_refine_impl", exc)
    cfg = rtt.RBLConfig(block_size=2, tol=1e-8, fault_retries=1, device=CPU)
    res = rtt.rbl_polished(_lap(), 4, cfg=cfg, b=2)
    assert calls["n"] == 2 and res.converged
    np.testing.assert_allclose(res.eigenvalues, _lap_top(), rtol=1e-10)

    calls["n"] = 0
    with pytest.raises(exc):
        rtt.rbl_polished(_lap(), 4, cfg=cfg.replace(fault_retries=0), b=2)
    assert calls["n"] == 1


def test_solver_level_runtime_error_not_retried(monkeypatch):
    import rbl_tpu_torch.solver.rbl as rblmod

    calls = _raise_first(monkeypatch, rblmod, "_rbl_impl", RuntimeError)
    cfg = rtt.RBLConfig(block_size=4, fault_retries=3, device=CPU)
    with pytest.raises(RuntimeError, match="injected"):
        rtt.rbl(_diag(np.arange(1.0, 101.0)), 3, cfg=cfg)
    assert calls["n"] == 1


def _restart_fault(monkeypatch, tmp_path, stale):
    """rbl_restarted with checkpoint_path and fault_retries=1.  With
    ``stale`` a checkpoint of another solve lies at the path and the first
    attempt fails before it writes; otherwise the first attempt fails
    right after its first restart-boundary write.  Returns (result, files
    loaded)."""
    import rbl_tpu_torch.solver.restarted as rmod
    import rbl_tpu_torch.utils.checkpoint as ck

    path = str(tmp_path / "restart.npz")
    cfg = rtt.RBLConfig(tol=1e-9, restart_kryl_dim=40, fault_retries=1,
                        device=CPU)
    if stale:
        # an earlier solve of another matrix, stopped after one restart
        rtt.rbl_restarted(_diag(np.arange(1.0, 241.0) * 3.0), 4, cfg=cfg, b=2,
                          max_restarts=1, checkpoint_path=path)
        assert os.path.exists(path)
        _raise_first(monkeypatch, rmod, "_rbl_restarted_impl",
                     FloatingPointError)
    else:
        real_save = ck.save_restart_state
        saves = {"n": 0}

        def save_then_fail(*a, **kw):
            real_save(*a, **kw)
            saves["n"] += 1
            if saves["n"] == 1:
                raise FloatingPointError("injected after the first write")

        monkeypatch.setattr(ck, "save_restart_state", save_then_fail)
    loaded = []
    real_load = ck.load_restart_state

    def spy(p, *a, **kw):
        loaded.append(p)
        return real_load(p, *a, **kw)

    monkeypatch.setattr(ck, "load_restart_state", spy)
    res = rtt.rbl_restarted(_lap(), 4, cfg=cfg, b=2, checkpoint_path=path)
    return res, loaded


@pytest.mark.parametrize("stale", [True, False], ids=["stale", "own"])
def test_restarted_retry_reads_only_its_own_checkpoint(monkeypatch, tmp_path,
                                                       stale):
    res, loaded = _restart_fault(monkeypatch, tmp_path, stale)
    assert loaded == ([] if stale else [str(tmp_path / "restart.npz")])
    assert res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues)[::-1], _lap_top(),
                               rtol=1e-9)


@pytest.mark.parametrize("stale", [True, False], ids=["stale", "own"])
def test_polish_retry_reads_only_its_own_checkpoint(monkeypatch, tmp_path,
                                                    stale):
    """chebyshev_refine's pass-boundary checkpoint: a retry never resumes
    from a file an earlier solve left (the JAX package's polish can,
    rbl_tpu/solver/polish.py:248), and does resume from the failed
    attempt's own."""
    import rbl_tpu_torch.solver.polish as pmod
    import rbl_tpu_torch.utils.checkpoint as ck

    path = str(tmp_path / "polish.npz")
    cfg = rtt.RBLConfig(block_size=2, tol=1e-8, fault_retries=1, device=CPU)
    if stale:
        # an earlier solve's pass: the wrong subspace, of the right shape
        rng = np.random.default_rng(3)
        X = np.linalg.qr(rng.standard_normal((240, 38)))[0]
        ck.save_polish_state(path, X, np.zeros(38), np.ones(38), 1)
        _raise_first(monkeypatch, pmod, "_chebyshev_refine_impl",
                     FloatingPointError)
    else:
        real_save = ck.save_polish_state
        saves = {"n": 0}

        def save_then_fail(*a, **kw):
            real_save(*a, **kw)
            saves["n"] += 1
            if saves["n"] == 1:
                raise FloatingPointError("injected after the first write")

        monkeypatch.setattr(ck, "save_polish_state", save_then_fail)
    loaded = []
    real_load = ck.load_polish_state
    monkeypatch.setattr(ck, "load_polish_state",
                        lambda p: loaded.append(p) or real_load(p))
    res = rtt.rbl_polished(_lap(), 4, cfg=cfg, b=2, target_gain=1e3,
                           checkpoint_path=path)
    assert loaded == ([] if stale else [path])
    assert res.converged and not os.path.exists(path)
    np.testing.assert_allclose(res.eigenvalues, _lap_top(), rtol=1e-10)


class _FakeMesh:
    """The one method of a RowMesh that the retry reads."""

    def __init__(self):
        self.agreed = []

    def agree(self, flag):
        self.agreed.append(flag)
        return flag


def test_mesh_retries_only_the_guard():
    """On a mesh an OOM propagates (the other ranks would wait in a
    collective), the guard's error is retried, and the verdict on a result
    goes through RowMesh.agree."""
    mesh = _FakeMesh()
    cfg = rtt.RBLConfig(device=CPU, fault_retries=1, mesh=mesh)
    assert _retryable_exceptions(mesh) == (FloatingPointError,)
    calls = {"n": 0}

    def oom():
        calls["n"] += 1
        raise torch.OutOfMemoryError("injected")

    with pytest.raises(torch.OutOfMemoryError):
        dispatch(oom, cfg, CPU)
    assert calls["n"] == 1

    def fpe_then_nan_then_ok():
        calls["n"] += 1
        if calls["n"] == 1:
            raise FloatingPointError("injected")
        return _result([np.nan] if calls["n"] == 2 else [1.0])

    calls["n"] = 0
    res = dispatch(fpe_then_nan_then_ok, cfg.replace(fault_retries=2), CPU)
    assert calls["n"] == 3 and mesh.agreed == [False, True]
    np.testing.assert_allclose(res.eigenvalues, [1.0])


def test_resolve_fault_retries(monkeypatch):
    assert resolve_fault_retries(rtt.RBLConfig(device=CPU)) == 0
    assert resolve_fault_retries(rtt.RBLConfig(device=CPU, fault_retries=3)) == 3
    assert resolve_fault_retries(rtt.RBLConfig(fault_retries=0), "cuda") == 0
    # the solve's own device decides: the card gets one retry by default
    assert resolve_fault_retries(rtt.RBLConfig(), torch.device("cuda")) == 1
    assert resolve_fault_retries(rtt.RBLConfig(device="cuda")) == 1
    assert resolve_fault_retries(rtt.RBLConfig(device="cuda"), CPU) == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_fault_retries(rtt.RBLConfig())
    with pytest.raises(ValueError, match="fault_retries"):
        rtt.RBLConfig(fault_retries=-1)


def test_default_cpu_solve_is_not_retried(monkeypatch):
    """By default a solve on the CPU never re-dispatches: the guard's
    error is a genuine numerical failure there."""
    import rbl_tpu_torch.solver.rbl as rblmod

    calls = _raise_first(monkeypatch, rblmod, "_rbl_impl", FloatingPointError)
    with pytest.raises(FloatingPointError):
        rtt.rbl(_diag(np.arange(1.0, 101.0)), 3, 4,
                cfg=rtt.RBLConfig(device=CPU))
    assert calls["n"] == 1
