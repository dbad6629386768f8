"""``rbl_restarted`` of the port on the CPU, against the truth, the JAX
package and its restart checkpoints (tests/test_restarted.py's fixtures).

Eigenvalues are compared (1e-9 relative in f64 unless stated), never
vectors: the two packages draw different start blocks.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.utils.checkpoint import save_restart_state as jax_save_restart_state

import rbl_tpu_torch as rtt
from _torch_parity import CPU
from rbl_tpu_torch.solver import restarted as trestarted
from rbl_tpu_torch.utils.checkpoint import load_restart_state


def _moderate(n):
    return np.cumsum(np.arange(1.0, n + 1.0))


def _op(a, dtype=torch.float64):
    return rtt.DiagonalOperator(torch.from_numpy(np.asarray(a)).to(dtype))


def _mixed():
    return np.concatenate([np.linspace(-50.0, -45.0, 5), np.linspace(1.0, 40.0, 95)])


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("which", ["LM", "LA", "SA"])
def test_restarted_ends_of_the_spectrum(which, b):
    """A mixed-sign spectrum: LM, LA and SA each lock the right k pairs,
    return them in descending |λ| (LanczosResult's contract, even after the
    un-shift), with true eigenvectors."""
    d = _mixed()
    k = 3
    res = rtt.rbl_restarted(_op(d), k, cfg=rtt.RBLConfig(tol=1e-9), b=b, which=which)
    want = {"LM": d[np.argsort(-np.abs(d))][:k], "LA": np.sort(d)[::-1][:k],
            "SA": np.sort(d)[:k]}[which]
    want = want[np.argsort(-np.abs(want), kind="stable")]
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, want, rtol=1e-9)
    assert np.all(np.diff(np.abs(res.eigenvalues)) <= 1e-12)
    V = res.eigenvectors.numpy()
    r = d[:, None] * V - V * res.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-6 * np.abs(d).max()


def test_restarted_matches_jax_and_aliases():
    """The same diagonal through both packages (b = 1, the reference's
    width): both lock the true top 6 to 1e-10 and agree to 1e-10; the
    reference-shaped aliases return (D, V)."""
    n, k = 400, 6
    a = _moderate(n)
    jres = rbl_tpu.rbl_restarted(rbl_tpu.DiagonalOperator(jnp.asarray(a)), k)
    tres = rtt.rbl_restarted(_op(a), k)
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, a[::-1][:k], rtol=1e-10)
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=1e-10)
    V = tres.eigenvectors.numpy()
    r = a[:, None] * V - V * tres.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-5 * a.max()
    for alias in (rtt.RBL_restarted, rtt.RBL_gpu_restarted):
        D, V = alias(_op(_moderate(300)), 4)
        np.testing.assert_allclose(D, _moderate(300)[::-1][:4], rtol=1e-10)
        assert tuple(V.shape) == (300, 4)


def test_restart_checkpoint_resume(tmp_path):
    n, k = 400, 6
    a = _moderate(n)
    ckpt = os.fspath(tmp_path / "state.npz")
    partial = rtt.rbl_restarted(_op(a), k, max_restarts=1, checkpoint_path=ckpt)
    assert not partial.converged  # one restart can't lock all 6
    state = load_restart_state(ckpt, device=CPU)
    assert state.restarts == 1 and state.count == len(partial.eigenvalues)
    resumed = rtt.rbl_restarted(_op(a), k, state=state)
    assert resumed.converged and resumed.iterations > 1
    np.testing.assert_allclose(resumed.eigenvalues, a[::-1][:k], rtol=1e-10)


def test_jax_restart_file_resumed_by_the_port(tmp_path):
    """One restart in the JAX package, its ``save_restart_state`` file
    resumed by the port: the lock set and the next start block cross as
    arrays, and the port locks the rest (1e-10 relative)."""
    n, k = 400, 6
    a = _moderate(n)
    ckpt = os.fspath(tmp_path / "jax_state.npz")
    partial = rbl_tpu.rbl_restarted(rbl_tpu.DiagonalOperator(jnp.asarray(a)), k,
                                    max_restarts=1, checkpoint_path=ckpt)
    assert not partial.converged
    state = load_restart_state(ckpt, device=CPU)
    locked = state.count
    assert state.restarts == 1 and locked == len(partial.eigenvalues)
    resumed = rtt.rbl_restarted(_op(a), k, state=state)
    assert resumed.converged and resumed.iterations > 1
    np.testing.assert_allclose(resumed.eigenvalues, a[::-1][:k], rtol=1e-10)
    # what the JAX package locked stayed locked
    np.testing.assert_array_equal(
        np.sort(resumed.eigenvalues)[::-1][:locked],
        np.sort(np.asarray(partial.eigenvalues))[::-1])
    # and a state saved by the JAX package's writer from the port's arrays
    # loads again (the keys are the same)
    jax_save_restart_state(ckpt, state)
    assert load_restart_state(ckpt, device=CPU).count == k


def test_poll_ahead_breaks_sweeps_early():
    """poll_ahead targets only the next pairs: same eigenvalues, and no
    more sweep columns than the all-pairs poll needs."""
    n, k, b = 400, 8, 2
    a = _moderate(n)
    cfg = rtt.RBLConfig(tol=1e-8, restart_kryl_dim=40)
    full = rtt.rbl_restarted(_op(a), k, cfg=cfg, b=b, max_restarts=60)
    ahead = rtt.rbl_restarted(_op(a), k, cfg=cfg, b=b, max_restarts=60, poll_ahead=2 * b)
    assert full.converged and ahead.converged
    np.testing.assert_allclose(ahead.eigenvalues, a[::-1][:k], rtol=1e-9)
    np.testing.assert_allclose(ahead.eigenvalues, full.eigenvalues, rtol=1e-9)


def test_warm_V_seeds_the_sweeps(monkeypatch):
    """warm_V (a perturbed copy of the true eigenvectors, as a
    low-precision solve would give) seeds the first block and the block
    after every productive restart; narrower warm blocks are random-padded;
    the result is the plain solve's."""
    n, k, b = 300, 6, 2
    a = np.arange(1.0, n + 1.0)
    rng = np.random.default_rng(0)
    warm = np.zeros((n, k))
    warm[n - 1 - np.arange(k), np.arange(k)] = 1.0
    warm += 1e-4 * rng.standard_normal((n, k))
    starts = []
    real = trestarted._warm_block
    monkeypatch.setattr(trestarted, "_warm_block",
                        lambda wv, start, *a_, **kw: starts.append(start) or real(wv, start, *a_, **kw))
    cfg = rtt.RBLConfig(tol=1e-9, restart_kryl_dim=60)
    res = rtt.rbl_restarted(_op(a), k, cfg=cfg, b=b, warm_V=warm)
    cold = rtt.rbl_restarted(_op(a), k, cfg=cfg, b=b)
    assert res.converged and starts[0] == 0 and len(starts) >= 1
    assert all(s <= k for s in starts)
    np.testing.assert_allclose(res.eigenvalues, a[::-1][:k], rtol=1e-9)
    assert res.iterations <= cold.iterations
    blk = real(warm[:, :1], 0, 3, cfg, torch.device(CPU))
    assert tuple(blk.shape) == (n, 3) and bool(torch.isfinite(blk).all())


def test_f32_extreme_dominance_no_ghost_lock():
    """tests/test_restarted.py:80 — the step-decay spectrum in f32, where
    deflation leaks re-amplify by ~2e6 a step and a sweep re-converges
    locked directions with lying bounds: the overlap gate must keep
    duplicates out.  Locked values match the true top-k to 1e-4."""
    n, k = 100_000, 6
    d = np.ones(n)
    d[: 2 * k] = np.arange(2 * k, 0, -1) * float(n)
    exact = np.sort(d)[::-1][:k]
    res = rtt.rbl_restarted(
        _op(d, torch.float32), k, b=2,
        cfg=rtt.RBLConfig(seed=0, basis_dtype=torch.float32,
                          compute_dtype=torch.float32),
    )
    w = np.sort(np.asarray(res.eigenvalues))[::-1]
    assert len(w) == k
    assert np.abs((w - exact) / exact).max() < 1e-4
    assert res.eigenvectors.dtype == torch.float32


def test_ghost_gate_truncates_at_the_first_duplicate(monkeypatch):
    """A recovery that hands back an already-locked direction as the second
    newly converged pair (what a leaking deflation does at low precision):
    the gate keeps the clean prefix, the duplicate is never locked, and the
    solve still ends at the true top-k with an orthonormal lock set."""
    n, k, b = 200, 6, 3
    a = np.arange(1.0, n + 1.0)
    seen = dict(lock=None, fresh=False, injected=0)
    real_sweep, real_recover = trestarted._restarted_sweep, trestarted.recover_eigvec

    def sweep(op, cfg, Qi, store, lock_buf, timer, k_rem):
        seen.update(lock=lock_buf, fresh=True)
        return real_sweep(op, cfg, Qi, store, lock_buf, timer, k_rem)

    def recover(store, Vk):
        QV = real_recover(store, Vk)
        first, seen["fresh"] = seen["fresh"], False  # the locking call of a sweep
        if (first and not seen["injected"] and Vk.shape[1] >= 2
                and bool(seen["lock"][:, 0].any())):
            QV[:, 1] = seen["lock"][:, 0]
            seen["injected"] = Vk.shape[1]
        return QV

    monkeypatch.setattr(trestarted, "_restarted_sweep", sweep)
    monkeypatch.setattr(trestarted, "recover_eigvec", recover)
    cfg = rtt.RBLConfig(tol=1e-9, restart_kryl_dim=45)
    res = rtt.rbl_restarted(_op(a), k, cfg=cfg, b=b, max_restarts=60)
    assert seen["injected"] >= 2  # a duplicate was offered
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, a[::-1][:k], rtol=1e-9)
    V = res.eigenvectors.numpy()
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-8


def test_restart_growth_policy_stall_pins_sweep_length():
    """tests/test_restarted.py:104 — productive restarts keep the sweep
    length; 'always' restores the reference's unconditional +10."""
    n, k, b = 400, 6, 2
    d = _moderate(n)
    cfg = rtt.RBLConfig(tol=1e-6, restart_kryl_dim=24, seed=0)
    res = rtt.rbl_restarted(_op(d), k, b=b, cfg=cfg, max_restarts=30)
    res2 = rtt.rbl_restarted(_op(d), k, b=b, max_restarts=30,
                             cfg=cfg.replace(restart_growth_policy="always"))
    assert res.converged and res2.converged
    assert res2.kryl_dim == 24 + 10 * res2.iterations
    assert res.kryl_dim < 24 + 10 * res.iterations
    np.testing.assert_allclose(np.sort(res.eigenvalues), np.sort(res2.eigenvalues),
                               rtol=1e-9)


def test_restarted_strips_the_sweep_checkpoint_and_takes_the_host_tier(tmp_path):
    """The main solver's mid-sweep knobs must not leak into the inner
    sweeps (they would share one file); a device cap passes through to
    each sweep's store."""
    ck = str(tmp_path / "never_written.npz")
    a = np.arange(1.0, 201.0)
    cfg = rtt.RBLConfig(tol=1e-7, restart_kryl_dim=60, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=1)
    res = rtt.rbl_restarted(_op(a), 3, cfg=cfg)
    assert res.converged and not os.path.exists(ck)
    np.testing.assert_allclose(res.eigenvalues, [200, 199, 198], rtol=1e-9)
    capped = rtt.rbl_restarted(_op(a), 3, b=2, cfg=rtt.RBLConfig(
        tol=1e-7, restart_kryl_dim=80, basis_device_cap_cols=24))
    np.testing.assert_allclose(capped.eigenvalues, [200, 199, 198], rtol=1e-9)


def test_restarted_argument_checks():
    op = _op(np.arange(1.0, 51.0))
    with pytest.raises(ValueError, match="out of range"):
        rtt.rbl_restarted(op, 0)
    with pytest.raises(ValueError, match="which"):
        rtt.rbl_restarted(op, 2, which="BE")
    with pytest.raises(ValueError, match="v0 has length"):
        rtt.rbl_restarted(op, 2, v0=np.ones(7))
    res = rtt.rbl_restarted(op, 2, v0=np.ones(50), cfg=rtt.RBLConfig(restart_kryl_dim=30))
    np.testing.assert_allclose(res.eigenvalues, [50.0, 49.0], rtol=1e-9)


def _lap_spectrum_2d(nx, ny):
    e = [2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1)) for m in (nx, ny)]
    return np.sort(np.add.outer(*e).ravel())


def _foreign(values, spectrum, rtol=1e-6):
    """Values within rtol of no eigenvalue of A."""
    return [v for v in np.asarray(values)
            if np.min(np.abs(spectrum - v)) > rtol * abs(v)]


def test_restarted_lock_can_lock_a_value_that_is_no_eigenvalue(monkeypatch):
    """Both packages from one start state, with the same knobs: the 24×23
    Laplacian (a clustered top, no double eigenvalue), f64, k = 20, b = 8,
    64-column sweeps, tol 1e-7.  Their sweeps agree restart by restart
    and, from the 14th on, both report Ritz values that are no eigenvalue
    of A with bounds below tol: the sweep basis leaks into the locked
    directions, and the overlap gate keeps these ghosts out of the lock.
    After 14 restarts the locked sets agree at 1e-9.  Later the two runs
    part by rounding alone, and within 30 restarts the JAX package locks
    a value above λmax(A) = 7.97 (it is the reference's behaviour, which
    the port keeps; ROADMAP C)."""
    from rbl_tpu.config import RBLConfig as JaxConfig
    from rbl_tpu.solver import restarted as jrestarted

    nx, ny, k, b, kryl = 24, 23, 20, 8, 64
    n = nx * ny
    spectrum = _lap_spectrum_2d(nx, ny)
    Q = np.random.default_rng(1).standard_normal((n, b))
    ghosts = {"port": [], "jax": []}

    def record(mod, key):
        real = mod._restarted_sweep

        def sweep(*args, **kw):
            w, V, bounds = real(*args, **kw)
            ghosts[key].append(_foreign(np.asarray(w)[np.asarray(bounds) < 1e-7], spectrum))
            return w, V, bounds
        monkeypatch.setattr(mod, "_restarted_sweep", sweep)

    record(trestarted, "port")
    record(jrestarted, "jax")

    def port(restarts):
        state = trestarted.RestartState(
            lock_buf=torch.zeros((n, k), dtype=torch.float64), locked_values=np.zeros(k),
            count=0, kryl_dim=kryl, Qi=torch.from_numpy(Q.copy()))
        return rtt.rbl_restarted(rtt.Laplacian2D(nx, ny, dtype=torch.float64, device=CPU), k,
                                 cfg=rtt.RBLConfig(tol=1e-7, restart_kryl_dim=kryl), b=b,
                                 max_restarts=restarts, state=state)

    def jax(restarts):
        state = jrestarted.RestartState(
            lock_buf=jnp.zeros((n, k)), locked_values=np.zeros(k), count=0,
            kryl_dim=kryl, Qi=jnp.asarray(Q))
        return rbl_tpu.rbl_restarted(rbl_tpu.Laplacian2D(nx, ny), k,
                                     cfg=JaxConfig(tol=1e-7, restart_kryl_dim=kryl), b=b,
                                     max_restarts=restarts, state=state)

    tres, jres = port(14), jax(14)
    assert not tres.converged and not jres.converged
    np.testing.assert_allclose(np.sort(tres.eigenvalues), np.sort(np.asarray(jres.eigenvalues)),
                               rtol=1e-9)
    assert not _foreign(tres.eigenvalues, spectrum)
    # the same ghosts, first seen in the same sweep
    first = [next(i for i, g in enumerate(ghosts[key]) if g) for key in ("port", "jax")]
    assert first[0] == first[1] < 14
    np.testing.assert_allclose(ghosts["port"][first[0]], ghosts["jax"][first[1]], rtol=1e-6)
    assert max(_foreign(jax(30).eigenvalues, spectrum)) > spectrum[-1]
