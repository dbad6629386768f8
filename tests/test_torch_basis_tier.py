"""The two-tier Krylov-basis store of the port (device buffer + host panels)
against the JAX package's, and solves through it, on the CPU.

The same seeded blocks go into both stores; panels, blocks, snapshots and
rewinds must agree exactly (the stores only move data: tolerance 0, stated
as 1e-15 where a dtype round trip is involved).  Solves compare eigenvalues
(1e-12 relative in f64 between converged solves), never vectors: the two
packages draw different start blocks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rbl_tpu
from rbl_tpu.solver.basis import BasisStore as JaxStore
from rbl_tpu.solver.lanczos import _zero_cols_range

import rbl_tpu_torch as rtt
from _torch_parity import CPU
from rbl_tpu_torch.solver.basis import BasisStore

N, B, CAP, NBLOCKS = 40, 4, 16, 14


def _stores(nblocks=NBLOCKS, cap=CAP, seed=0):
    """Both packages' stores fed the same ``nblocks`` seeded blocks."""
    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal((N, B)) for _ in range(nblocks)]
    js = JaxStore(N, B, max_cols=96, dtype=jnp.float64, device_cap_cols=cap)
    ts = BasisStore(N, B, max_cols=96, dtype=torch.float64, device=CPU,
                    device_cap_cols=cap)
    for blk in blocks:
        js.append(jnp.asarray(blk))
        ts.append(torch.from_numpy(blk))
    return js, ts, np.concatenate(blocks, axis=1)


def _tiers(store, to_np):
    """(panels, device-tier prefix) of either store as numpy arrays."""
    dev = to_np(store.view())[:, : store.dev_ncols]
    return [to_np(p) for p in store.host_tier()], dev


def _same_tiers(js, ts):
    jp, jd = _tiers(js, np.asarray)
    tp, td = _tiers(ts, lambda t: t.numpy())
    assert [p.shape for p in tp] == [p.shape for p in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td, jd)
    assert (ts.ncols, ts.dev_base, ts.host_ncols, ts.dev_ncols) == (
        js.ncols, js.dev_base, js.host_ncols, js.dev_ncols)


@pytest.mark.parametrize("case", [
    "panels", "read_block", "snapshot", "rewind_in_device",
    "rewind_into_panel", "rewind_to_panel_edge", "rewind_then_append",
    "load_snapshot", "reset", "stream",
])
def test_store_matches_jax_store(case):
    js, ts, full = _stores()
    assert ts.host_ncols > 20  # the offload happened
    if case == "panels":
        _same_tiers(js, ts)
        got = np.concatenate([p.numpy() for p in ts.host_tier()]
                             + [ts.view().numpy()], axis=1)
        np.testing.assert_array_equal(got, full)
    elif case == "read_block":
        # by GLOBAL column, across both tiers
        for col in range(0, NBLOCKS * B, B):
            blk = ts.read_block(col, B).numpy()
            np.testing.assert_array_equal(blk, np.asarray(js.read_block(col, B)))
            np.testing.assert_array_equal(blk, full[:, col : col + B])
        with pytest.raises(IndexError):
            ts.read_block(NBLOCKS * B, B)
    elif case == "snapshot":
        for ncols in (NBLOCKS * B, 24, ts.host_ncols, 8):
            snap = ts.snapshot(ncols)
            assert np.abs(snap - js.snapshot(ncols)).max() <= 1e-15
            np.testing.assert_array_equal(snap, full[:, :ncols])
    elif case.startswith("rewind"):
        target = {"rewind_in_device": ts.dev_base + B,
                  "rewind_into_panel": 20 if 20 % ts.host_tier()[0].shape[1] else 22,
                  "rewind_to_panel_edge": ts.host_tier()[0].shape[1],
                  "rewind_then_append": 20}[case]
        target -= target % B
        js.rewind(target, _zero_cols_range)
        ts.rewind(target)
        _same_tiers(js, ts)
        assert ts.ncols == target
        np.testing.assert_array_equal(ts.snapshot(target), full[:, :target])
        # discarded device columns are zero again (the padding invariant)
        assert not ts.buf[:, ts.dev_ncols :].any()
        if case == "rewind_then_append":
            blk = np.random.default_rng(9).standard_normal((N, B))
            for _ in range(5):
                js.append(jnp.asarray(blk))
                ts.append(torch.from_numpy(blk))
            _same_tiers(js, ts)
    elif case == "load_snapshot":
        js2 = JaxStore(N, B, max_cols=96, dtype=jnp.float64, device_cap_cols=CAP)
        ts2 = BasisStore(N, B, max_cols=96, dtype=torch.float64, device=CPU,
                         device_cap_cols=CAP)
        js2.load_snapshot(full[:, :40])
        ts2.load_snapshot(full[:, :40])
        _same_tiers(js2, ts2)
        np.testing.assert_array_equal(ts2.snapshot(40), full[:, :40])
    elif case == "reset":
        ts.reset()
        assert (ts.ncols, ts.dev_base, ts.host_tier()) == (0, 0, [])
        assert not ts.buf.any()
    else:  # stream: the panels as the split step sees them
        seen = [p.numpy().copy() for p in ts.stream_host_tier()]
        for a, b in zip(seen, ts.host_tier()):
            np.testing.assert_array_equal(a, b.numpy())
        assert sum(p.shape[1] for p in seen) == ts.host_ncols


def test_sub_f32_snapshot_upcasts_and_round_trips():
    """A bf16 store's snapshot is f32 (numpy has no portable bf16) and
    refills a bf16 store exactly."""
    ts = BasisStore(N, B, max_cols=64, dtype=torch.bfloat16, device=CPU,
                    device_cap_cols=CAP)
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        ts.append(torch.randn((N, B), generator=g).to(torch.bfloat16))
    snap = ts.snapshot(ts.ncols)
    assert snap.dtype == np.float32
    ts2 = BasisStore(N, B, max_cols=64, dtype=torch.bfloat16, device=CPU,
                     device_cap_cols=CAP)
    ts2.load_snapshot(snap)
    np.testing.assert_array_equal(ts2.snapshot(ts2.ncols), snap)


def test_cap_rounding_and_small_cap_rejected():
    """The cap rounds down to a multiple of b and up to 4b, as in the JAX
    store; an append window the cap cannot hold raises instead of
    overwriting the newest blocks."""
    for cap in (5, 16, 18, 50):
        js = JaxStore(64, 4, max_cols=64, dtype=jnp.float64, device_cap_cols=cap)
        ts = BasisStore(64, 4, max_cols=64, dtype=torch.float64, device=CPU,
                        device_cap_cols=cap)
        assert ts.device_cap_cols == js.device_cap_cols
        assert ts.capacity == min(64, ts.device_cap_cols)
    ts = BasisStore(64, 4, max_cols=64, dtype=torch.float64, device=CPU,
                    device_cap_cols=16)
    with pytest.raises(ValueError, match="too small"):
        ts._ensure(20)  # a 20-column window on a 16-column cap


def _residuals(d, res):
    V = res.eigenvectors.numpy()
    return np.linalg.norm(d[:, None] * V - V * res.eigenvalues[None, :], axis=0)


def test_capped_solve_matches_uncapped_and_jax():
    """tests/test_ops.py:227's fixture with a steeper top (the solves must
    converge for two start blocks to agree): a cap far below the Krylov
    need forces offload, the split step and the two-tier recovery.  The
    capped solve equals the port's uncapped one and the JAX package's
    capped one to 1e-12 relative (f64, all converged at tol 1e-7)."""
    n, k, b = 600, 5, 4
    d = np.linspace(1.0, 20.0, n) ** 4
    base = rtt.RBLConfig(block_size=b, max_kryl_dim=280, device=CPU)
    full = rtt.rbl(d, k, b, cfg=base)
    off = rtt.rbl(d, k, b, cfg=base.replace(basis_device_cap_cols=48))
    assert full.converged and off.converged and off.kryl_dim > 48
    np.testing.assert_allclose(off.eigenvalues, full.eigenvalues, rtol=1e-12)
    assert _residuals(d, off).max() < 1e-6 * d.max()
    jres = rbl_tpu.rbl(d, k, b, cfg=rbl_tpu.RBLConfig(
        block_size=b, max_kryl_dim=280, basis_device_cap_cols=48))
    assert jres.converged
    np.testing.assert_allclose(off.eigenvalues, jres.eigenvalues, rtol=1e-12)


def test_capped_solve_dominant_spectrum_keeps_orthogonality():
    """tests/test_ops.py:249's fixture (dominant outliers atop a bulk):
    every full-scrub step must see the host tier.  Capped equals uncapped
    to 1e-10 relative, residuals agree, the Ritz vectors are orthonormal to
    1e-10."""
    n, k, b = 300, 6, 4
    d = np.linspace(1.0, 50.0, n)
    d[:3] = [-80.0, 85.0, 90.0]
    base = rtt.RBLConfig(block_size=b, max_kryl_dim=160, device=CPU)
    res = rtt.rbl(d, k, b, cfg=base.replace(basis_device_cap_cols=64))
    expect = d[np.argsort(-np.abs(d))][:k]
    np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-7)
    ctrl = rtt.rbl(d, k, b, cfg=base)
    np.testing.assert_allclose(res.eigenvalues, ctrl.eigenvalues, rtol=1e-10)
    np.testing.assert_allclose(res.residual_bounds, ctrl.residual_bounds,
                               rtol=1e-3, atol=1e-12)
    V = res.eigenvectors.numpy()
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-10


def test_host_tier_keeps_T_consistent():
    """With offload active T equals QᵀAQ to 1e-10·‖A‖: the host panels
    scrub the newborn residual, never the live pair (tests/test_ops.py:281)."""
    from rbl_tpu_torch.ops.band import band_to_dense
    from rbl_tpu_torch.solver.lanczos import lanczos_iteration, random_start_block

    n, k, b, cap = 500, 6, 4, 48
    d = np.linspace(1.0, 50.0, n)
    cfg = rtt.RBLConfig(block_size=b, max_kryl_dim=120, tol=1e-300,
                        basis_device_cap_cols=cap)
    op = rtt.as_operator(d, dtype=cfg.compute_dtype, device=CPU)
    gen = torch.Generator().manual_seed(cfg.seed)
    Qi = random_start_block(op, gen, b, cfg)
    store = BasisStore(n, b, max_cols=cfg.max_kryl_dim + b, dtype=cfg.basis_dtype,
                       device=CPU, device_cap_cols=cap)
    _, _, T, _, _, _ = lanczos_iteration(op, k, cfg, Qi, store)
    assert store.host_ncols > 0
    Q = store.snapshot(store.ncols)
    Td = band_to_dense(T.view(store.ncols))
    assert np.abs(Td - Q.T @ (d[:, None] * Q)).max() < 1e-10 * d.max()
    assert np.abs(Q.T @ Q - np.eye(store.ncols)).max() < 1e-10
