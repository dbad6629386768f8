"""The three eig backends of the port (``RBLConfig.eig_backend``) on the
CPU: "banded_host" (scipy's LAPACK), "native" (the port's C++ tred2/tql2,
``rbl_tpu_torch.native``) and "device" (``torch.linalg.eigh`` of the dense
T on the solve's device).  Each factorization against scipy (eigenvalues
1e-12 relative to ‖T‖, vectors up to sign); a poll of the solver through
each; ``rbl`` solves in f64 giving the "banded_host" eigenvalues to 1e-10
and the JAX package's with the same backend; a JAX ``RBLConfig`` with
``eig_backend="native"`` converted by ``utils.convert`` runs.
"""

import dataclasses

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu

import rbl_tpu_torch as rtt
from _torch_parity import CPU, random_sym, rel_err
from rbl_tpu_torch.ops import eig as teig
from rbl_tpu_torch.solver.lanczos import _poll_task
from rbl_tpu_torch.utils.convert import config_from_fields
from rbl_tpu_torch.utils.profiling import Timer

BACKENDS = ("native", "device")


def _band(m=60, bw=6, seed=0):
    band = np.random.default_rng(seed).standard_normal((bw + 1, m))
    for r in range(1, bw + 1):
        band[r, m - r:] = 0.0
    return band


@pytest.mark.parametrize("backend", BACKENDS)
def test_eig_banded_host_backends_match_scipy(backend):
    band = _band()
    w, V = teig.eig_banded_host(band, backend=backend, device=CPU)
    w_ref, V_ref = scipy.linalg.eig_banded(band, lower=True)
    assert isinstance(w, np.ndarray) and isinstance(V, np.ndarray)
    assert w.dtype == np.float64 and V.shape == V_ref.shape
    np.testing.assert_allclose(w, w_ref, rtol=0,
                               atol=1e-12 * np.abs(w_ref).max())
    signs = np.sign(np.sum(V * V_ref, axis=0))
    np.testing.assert_allclose(V * signs, V_ref, rtol=0, atol=1e-9)


def test_eigh_device_is_torch_eigh_on_the_tensor_device():
    from rbl_tpu_torch.ops.band import band_to_dense

    T = torch.from_numpy(band_to_dense(_band(30, 3, seed=1)))
    w, V = teig.eigh_device(T)
    assert w.device == T.device and w.dtype == torch.float64
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(T.numpy()),
                               rtol=0, atol=1e-12 * float(w.abs().max()))
    np.testing.assert_allclose((T @ V - V * w).abs().max().item(), 0.0,
                               atol=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_poll_task_factorizes_with_the_backend(backend):
    """A poll forced to factorize returns the top-k pairs the scipy poll
    returns (vectors up to sign) and the seconds it took."""
    band, k = _band(90, 6, seed=2), 8
    ws, _, (w_s, V_s), secs_s = _poll_task(band, k, "scipy", None, {}, 1e-8,
                                           True)
    wb, _, (w_b, V_b), secs_b = _poll_task(band, k, backend, torch.device(CPU),
                                           {}, 1e-8, True)
    np.testing.assert_allclose(wb, ws, rtol=1e-12)
    w_b, V_b = teig.sort_eig_abs(w_b, V_b, k)
    np.testing.assert_allclose(w_b, w_s, rtol=1e-12)
    signs = np.sign(np.sum(V_b * V_s, axis=0))
    np.testing.assert_allclose(V_b * signs, V_s, atol=1e-9)
    assert secs_s > 0 and secs_b > 0


def _jax_cfg(backend, **kw):
    return rbl_tpu.RBLConfig(block_size=4, tol=1e-10, eig_backend=backend,
                             basis_dtype=jnp.float64,
                             compute_dtype=jnp.float64, **kw)


@pytest.mark.parametrize("which", ["LM", "SA"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_rbl_with_backend_matches_banded_host_and_jax(backend, which):
    A = random_sym(300, 0.03, seed=5)
    cfg = rtt.RBLConfig(block_size=4, tol=1e-10, device=CPU)
    timer = Timer()
    res = rtt.rbl(A, 6, cfg=cfg.replace(eig_backend=backend), which=which,
                  timer=timer)
    ref = rtt.rbl(A, 6, cfg=cfg, which=which)
    jres = rbl_tpu.rbl(A, 6, cfg=_jax_cfg(backend), which=which)
    assert res.converged and ref.converged
    assert rel_err(res.eigenvalues, ref.eigenvalues) < 1e-10
    assert rel_err(res.eigenvalues, np.asarray(jres.eigenvalues)) < 1e-10
    # every factorization of the backend is one call of the worker's
    # "eig_poll" section or of the serial final "eig"
    polls = timer.counts["eig_poll"] + timer.counts["eig"]
    assert polls >= 1 and timer.times["eig_poll"] + timer.times["eig"] > 0
    V = res.eigenvectors.numpy()
    R = A @ V - V * res.eigenvalues[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-8


def test_restarted_and_capped_solve_with_device_backend():
    """The restarted sweep and a solve that ends at its Krylov cap (the
    final factorization outside the polls) run through the backend too."""
    d = np.concatenate([np.linspace(0.0, 1.0, 246), np.arange(10.0, 16.0)])
    cfg = rtt.RBLConfig(block_size=2, tol=1e-10, device=CPU,
                        eig_backend="device")
    res = rtt.rbl_restarted(sp.diags(d), 4, cfg=cfg, b=2, max_restarts=30)
    np.testing.assert_allclose(np.sort(res.eigenvalues), d[-4:], rtol=1e-10)
    capped = rtt.rbl(sp.diags(d), 4, cfg=cfg.replace(max_kryl_dim=8,
                                                      eig_backend="native"))
    plain = rtt.rbl(sp.diags(d), 4, cfg=cfg.replace(max_kryl_dim=8,
                                                     eig_backend="banded_host"))
    assert not capped.converged
    np.testing.assert_allclose(capped.eigenvalues, plain.eigenvalues,
                               rtol=1e-12)


def test_jax_config_with_native_backend_converts_and_runs():
    jcfg = _jax_cfg("native")
    tcfg = config_from_fields(dataclasses.asdict(jcfg)).replace(device=CPU)
    assert tcfg.eig_backend == "native"
    d = np.arange(1.0, 401.0)
    res = rtt.rbl(d, 5, cfg=tcfg)
    np.testing.assert_allclose(res.eigenvalues, d[::-1][:5], rtol=1e-12)
    np.testing.assert_allclose(
        res.eigenvalues, np.asarray(rbl_tpu.rbl(d, 5, cfg=jcfg).eigenvalues),
        rtol=1e-12)
