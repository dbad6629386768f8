"""The three eig backends of the port (``RBLConfig.eig_backend``) on the
CPU: "banded_host" (scipy's LAPACK), "native" (the port's C++ tred2/tql2,
``rbl_tpu_torch.native``) and "device" (``torch.linalg.eigh`` of the dense
T on the solve's device).  Each factorization against scipy (eigenvalues
1e-12 relative to ‖T‖, vectors up to sign); a poll of the solver through
each; ``rbl`` solves in f64 giving the "banded_host" eigenvalues to 1e-10
and the JAX package's with the same backend; a JAX ``RBLConfig`` with
``eig_backend="native"`` converted by ``utils.convert`` runs.  The route of
a capped sweep's last factorization (``last_eig_backend``): the card only
for host polls on CUDA with no mesh and T at least ``CARD_EIG_MIN_COLS``
wide; a capped CPU solve stays on the host bit for bit and counts
``eig_on_card`` 0; the card route forced onto the CPU gives the host
route's eigenvalues and bounds to 1e-10.
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
from rbl_tpu_torch.solver import lanczos
from rbl_tpu_torch.solver.lanczos import CARD_EIG_MIN_COLS, _poll_task, last_eig_backend
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


_MESH = object()  # any mesh: the route only asks whether there is one


@pytest.mark.parametrize("backend, device, mesh, m, expected", [
    ("scipy", "cuda", None, CARD_EIG_MIN_COLS, "device"),
    ("scipy", "cuda", None, 1400, "device"),
    ("scipy", "cpu", None, 1400, "scipy"),
    ("scipy", "cuda", _MESH, 1400, "scipy"),
    ("scipy", "cuda", None, CARD_EIG_MIN_COLS - 1, "scipy"),
    ("native", "cuda", None, 1400, "native"),
    ("device", "cuda", None, 1400, "device"),
    ("device", "cpu", None, 1400, "device"),
])
def test_last_eig_backend_routes(backend, device, mesh, m, expected):
    """The capped sweep's last factorization goes to the card only with
    host polls, a CUDA device, no mesh and T at least CARD_EIG_MIN_COLS
    wide; "native" and "device" keep their own."""
    assert last_eig_backend(backend, torch.device(device), mesh, m) == expected


def _capped(compute_eigenvectors=True):
    """A solve of a random f64 matrix that ends at its Krylov cap, which
    lies above the crossover (the tolerance is out of reach)."""
    A = random_sym(1500, 0.01, seed=7)
    cap = -(-(CARD_EIG_MIN_COLS + 64) // 8) * 8
    cfg = rtt.RBLConfig(block_size=8, tol=1e-30, max_kryl_dim=cap, device=CPU)
    timer = Timer()
    res = rtt.rbl(A, 10, cfg=cfg, timer=timer,
                  compute_eigenvectors=compute_eigenvectors)
    assert not res.converged and res.kryl_dim == cap
    return res, timer


def test_capped_cpu_solve_stays_on_the_host(monkeypatch):
    """On the CPU the route keeps the host: the capped solve counts
    eig_on_card 0 and gives, bit for bit, the eigenpairs of the solve whose
    last factorization is held to the polls' backend."""
    res, timer = _capped()
    assert timer.counters["eig_on_card"] == 0
    monkeypatch.setattr(lanczos, "last_eig_backend", lambda bk, dev, mesh, m: bk)
    held, _ = _capped()
    np.testing.assert_array_equal(res.eigenvalues, held.eigenvalues)
    np.testing.assert_array_equal(res.eigenvectors.numpy(), held.eigenvectors.numpy())
    np.testing.assert_array_equal(res.residual_bounds, held.residual_bounds)


@pytest.mark.parametrize("compute_eigenvectors", [False, True])
def test_card_route_on_the_cpu_matches_the_host_route(monkeypatch,
                                                      compute_eigenvectors):
    """The card route (torch's eigh of the densified T, the top k chosen
    on the device), forced onto the CPU, is counted once and gives the host
    route's eigenvalues and residuals (the Lanczos bounds without vectors,
    the true residuals with them) to 1e-10 relative to |λ|max."""
    host, _ = _capped(compute_eigenvectors)
    route = lanczos.last_eig_backend
    monkeypatch.setattr(lanczos, "last_eig_backend",
                        lambda bk, dev, mesh, m: route(bk, torch.device("cuda"), mesh, m))
    card, timer = _capped(compute_eigenvectors)
    assert timer.counters["eig_on_card"] == 1
    scale = np.abs(host.eigenvalues).max()
    assert rel_err(card.eigenvalues, host.eigenvalues) < 1e-10
    np.testing.assert_allclose(card.residual_bounds, host.residual_bounds,
                               rtol=0, atol=1e-10 * scale)
