"""Checkpoints of the port on the CPU: the three .npz surfaces
(utils/checkpoint.py) round-trip, cross between the JAX package and the
port in both directions, and the sweep checkpoint of ``rbl`` (abort by
fault injection, resume, removal) works alone and across packages.

Resumed solves are held to the uninterrupted solve's eigenvalues at 1e-10
relative within one package (the resume restores the state exactly) and to
1e-9 across packages (two start blocks, both converged at tol 1e-9).
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.utils import checkpoint as jck

import rbl_tpu_torch as rtt
from _torch_parity import CPU
from rbl_tpu_torch.solver.restarted import RestartState
from rbl_tpu_torch.utils import checkpoint as tck
from rbl_tpu_torch.utils.convert import config_from_fields

# tests/test_sweep_checkpoint.py's configuration
BASE = dict(block_size=5, eig_poll_cadence=4, chunk_growth_cap=1,
            pipeline_depth=1, max_kryl_dim=280, tol=1e-9)


def _slow_diag(n):
    return sp.diags(np.arange(1.0, n + 1.0)).tocsr()


def _cfg(**kw):
    return rtt.RBLConfig(**{**BASE, **kw}, device=CPU)


def _sweep_state(rng):
    return dict(
        n=100, b=4, i=7, flag=True, x=2.5,
        arr=rng.standard_normal((5, 4)),
        B_hist={1: rng.standard_normal((4, 4)), 3: rng.standard_normal((4, 4))},
    )


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
])
def test_sweep_state_round_trip(writer, reader, tmp_path):
    path = str(tmp_path / "state.npz")
    state = _sweep_state(np.random.default_rng(0))
    mods = {"torch": tck, "jax": jck}
    if writer == "torch":
        # the port's own keys: a tensor, sub-f32 storage, the generator
        g = torch.Generator().manual_seed(3)
        state.update(Q=torch.ones((6, 2), dtype=torch.bfloat16),
                     gen_state=g.get_state().numpy(), gen_device="cpu")
    mods[writer].save_sweep_state(path, state)
    out = mods[reader].load_sweep_state(path)
    assert out["n"] == 100 and out["b"] == 4 and out["i"] == 7
    assert out["flag"] is True and out["x"] == 2.5
    np.testing.assert_array_equal(out["arr"], state["arr"])
    assert sorted(out["B_hist"]) == [1, 3]
    np.testing.assert_array_equal(out["B_hist"][3], state["B_hist"][3])
    if writer == "torch":
        assert out["Q"].dtype == np.float32 and out["Q"].shape == (6, 2)
        assert out["gen_device"] == "cpu"
        g2 = torch.Generator()
        g2.set_state(torch.from_numpy(np.ascontiguousarray(out["gen_state"])))
        assert torch.equal(torch.randn(4, generator=g2), torch.randn(4, generator=g))
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # atomic write


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
])
def test_restart_and_polish_state_round_trip(writer, reader, tmp_path):
    rng = np.random.default_rng(1)
    lock, Qi = rng.standard_normal((30, 4)), rng.standard_normal((30, 2))
    vals = np.array([9.0, 8.0, 0.0, 0.0])
    path = str(tmp_path / "restart.npz")
    if writer == "torch":
        tck.save_restart_state(path, RestartState(
            lock_buf=torch.from_numpy(lock), locked_values=vals, count=2,
            kryl_dim=110, Qi=torch.from_numpy(Qi), restarts=3, low_yield_streak=1))
    else:
        from rbl_tpu.solver.restarted import RestartState as JaxState

        jck.save_restart_state(path, JaxState(
            lock_buf=jnp.asarray(lock), locked_values=vals, count=2,
            kryl_dim=110, Qi=jnp.asarray(Qi), restarts=3, low_yield_streak=1))
    st = (tck.load_restart_state(path, device=CPU) if reader == "torch"
          else jck.load_restart_state(path))
    assert (st.count, st.kryl_dim, st.restarts, st.low_yield_streak) == (2, 110, 3, 1)
    np.testing.assert_array_equal(np.asarray(st.lock_buf), lock)
    np.testing.assert_array_equal(np.asarray(st.Qi), Qi)
    np.testing.assert_array_equal(st.locked_values, vals)
    if reader == "torch":
        assert st.lock_buf.device.type == "cpu" and st.Qi.dtype == torch.float64

    ppath = str(tmp_path / "polish.npz")
    X = rng.standard_normal((30, 5))
    save = tck.save_polish_state if writer == "torch" else jck.save_polish_state
    save(ppath, torch.from_numpy(X) if writer == "torch" else jnp.asarray(X),
         np.arange(5.0), np.full(5, 1e-3), 4)
    out = (tck if reader == "torch" else jck).load_polish_state(ppath)
    np.testing.assert_array_equal(out["X"], X)
    assert out["npass"] == 4 and out["res"][0] == 1e-3


def test_load_restart_state_without_a_card_raises(monkeypatch, tmp_path):
    path = str(tmp_path / "restart.npz")
    tck.save_restart_state(path, RestartState(
        lock_buf=torch.zeros((4, 2)), locked_values=np.zeros(2), count=0,
        kryl_dim=8, Qi=torch.zeros((4, 1))))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tck.load_restart_state(path)


@pytest.mark.parametrize("variant", ["base", "speculation", "host_tier", "every_2"])
def test_abort_resume_matches_clean_run(variant, tmp_path):
    """tests/test_sweep_checkpoint.py's cases on the port: pinned-off and
    default speculation (the save must take THIS chunk's triple while the
    device state already holds speculated chunks), the host tier (the
    snapshot spans panels and the device buffer), and a save every second
    chunk only."""
    n, k = 300, 5
    A = _slow_diag(n)
    kw = {"base": {}, "every_2": dict(sweep_checkpoint_every=2),
          "speculation": dict(chunk_growth_cap=4, pipeline_depth=2),
          "host_tier": dict(basis_device_cap_cols=60)}[variant]
    abort = {"base": 3, "speculation": 2, "host_tier": 6, "every_2": 4}[variant]
    ref = rtt.rbl(A, k, cfg=_cfg(**kw))
    assert ref.converged
    ck = str(tmp_path / "sweep.npz")
    cfg = _cfg(**kw, sweep_checkpoint_path=ck,
               fault_inject_abort_after_chunks=abort)
    with pytest.raises(rtt.SweepAborted):
        rtt.rbl(A, k, cfg=cfg)
    assert os.path.exists(ck)
    saved_i = int(np.load(ck)["i"])
    assert saved_i > 1  # real mid-sweep progress was saved
    if variant == "base":
        # the resume CONTINUES rather than restarts: abort again one chunk
        # later — the new checkpoint must sit beyond the first one
        with pytest.raises(rtt.SweepAborted):
            rtt.rbl(A, k, cfg=cfg.replace(fault_inject_abort_after_chunks=4))
        assert int(np.load(ck)["i"]) > saved_i
    res = rtt.rbl(A, k, cfg=cfg.replace(fault_inject_abort_after_chunks=None))
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-10)
    V = res.eigenvectors.numpy()
    R = A @ V - V * res.eigenvalues[None, :]
    assert np.max(np.linalg.norm(R, axis=0)) < 1e-6
    assert not os.path.exists(ck)  # a finished solve removes its checkpoint
    assert res.iterations >= saved_i


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sweep_checkpoint_crosses_between_packages(writer, tmp_path):
    """A sweep aborted after 2 chunks in one package is resumed by the
    other from the same file; the final eigenvalues meet the truth and the
    other package's clean solve at 1e-9 relative (tol 1e-9)."""
    n, k = 300, 5
    A = _slow_diag(n)
    ck = str(tmp_path / "cross.npz")
    jcfg = rbl_tpu.RBLConfig(**BASE, sweep_checkpoint_path=ck)
    tcfg = _cfg(sweep_checkpoint_path=ck)
    if writer == "jax":
        with pytest.raises(rbl_tpu.SweepAborted):
            rbl_tpu.rbl(A, k, cfg=jcfg.replace(fault_inject_abort_after_chunks=2))
        saved = np.load(ck)
        assert "gen_state" not in saved.files  # the port seeds a fresh generator
        res = rtt.rbl(A, k, cfg=tcfg)
        V = res.eigenvectors.numpy()
    else:
        with pytest.raises(rtt.SweepAborted):
            rtt.rbl(A, k, cfg=tcfg.replace(fault_inject_abort_after_chunks=2))
        saved = np.load(ck)
        assert saved["key"].dtype == np.uint32 and saved["key"].shape == (2,)
        res = rbl_tpu.rbl(A, k, cfg=jcfg)
        V = np.asarray(res.eigenvectors)
    saved_i = int(saved["i"])
    assert res.converged and res.iterations >= saved_i > 1
    assert not os.path.exists(ck)
    np.testing.assert_allclose(res.eigenvalues, np.arange(n, n - k, -1.0), rtol=1e-9)
    R = A @ V - V * np.asarray(res.eigenvalues)[None, :]
    assert np.max(np.linalg.norm(R, axis=0)) < 1e-6


@pytest.mark.parametrize("wrong", ["n", "b", "cap"])
def test_resume_refuses_a_checkpoint_of_another_shape(wrong, tmp_path):
    k = 5
    ck = str(tmp_path / "mismatch.npz")
    cfg = _cfg(sweep_checkpoint_path=ck)
    with pytest.raises(rtt.SweepAborted):
        rtt.rbl(_slow_diag(300), k, cfg=cfg.replace(fault_inject_abort_after_chunks=3))
    if wrong == "n":
        with pytest.raises(ValueError, match="mismatch"):
            rtt.rbl(_slow_diag(200), k, cfg=cfg)
    elif wrong == "b":
        with pytest.raises(ValueError, match="mismatch"):
            rtt.rbl(_slow_diag(300), k, cfg=cfg.replace(block_size=4))
    else:
        with pytest.raises(ValueError, match="exceeds the current cap"):
            rtt.rbl(_slow_diag(300), k, cfg=cfg.replace(max_kryl_dim=20))
    assert os.path.exists(ck)  # a refused file is left for the right solve


def test_config_from_fields_carries_the_checkpoint_and_restart_knobs():
    jcfg = rbl_tpu.RBLConfig(
        sweep_checkpoint_path="/x/sweep.npz", sweep_checkpoint_every=3,
        fault_inject_abort_after_chunks=7, restart_kryl_dim=64,
        restart_growth=6, restart_reorth_cadence=2,
        restart_growth_policy="always", basis_device_cap_cols=96)
    tcfg = config_from_fields(dataclasses.asdict(jcfg))
    for name in ("sweep_checkpoint_path", "sweep_checkpoint_every",
                 "fault_inject_abort_after_chunks", "restart_kryl_dim",
                 "restart_growth", "restart_growth_policy",
                 "basis_device_cap_cols"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    # the deflation cadence nothing reads is dropped, not carried
    assert not hasattr(tcfg, "restart_reorth_cadence")
    assert tcfg.basis_dtype == torch.float64
    with pytest.raises(NotImplementedError):
        config_from_fields(dict(rows_axis="cols"))
    with pytest.raises(ValueError, match="sweep_checkpoint_every"):
        rtt.RBLConfig(sweep_checkpoint_every=0)
