"""Tests of the port's CUDA kernels on the card (marker ``gpu``); they skip
without a CUDA device.  This file imports neither JAX nor the JAX package,
so that it runs on a machine with torch for CUDA alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances: 1e-5
relative in f32, 1e-12 in f64, kernel against its plain PyTorch version.
"""

import numpy as np
import pytest
import torch

from _torch_parity import messy_sym, random_sym, rel_err
import rbl_tpu_torch as rtt
from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
from rbl_tpu_torch.ops.spmm import bsr as tbsr
from rbl_tpu_torch.utils.fem import fem_elasticity_3d


# the edges of the kernel's column blocks: 16-byte vectors of 4 f32 (2
# f64), register blocks of 4 or 8 columns, CTAs of up to 32 columns
WIDTHS = (1, 3, 4, 5, 7, 8, 9, 16, 17, 33, 100)


def gappy_sym():
    """messy_sym with rows and columns 512-1023 removed: block-rows with
    no tile at every tile height up to 128."""
    import scipy.sparse as sp

    A = messy_sym()
    keep = np.ones(A.shape[0])
    keep[512:1024] = 0.0
    D = sp.diags(keep)
    return (D @ A @ D).tocsr()


def _empty_rows_dropped(A, op):
    """op's hcount with 0 for every block-row of A that holds no nonzero,
    so that the kernel meets rows with no tile at all."""
    per_row = np.add.reduceat(np.diff(A.indptr), np.arange(0, A.shape[0], op.bm))
    hc = op.hcount.cpu().numpy().copy()
    hc[per_row == 0] = 0
    assert (hc == 0).any()
    return torch.from_numpy(hc).to(op.hcount.device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_reference(dtype):
    """The packed kernel (B1/B2) against its plain version at every width
    of WIDTHS: tile heights 16, 64, 100 (128 % bm != 0, rows of the
    register block idle) and 128; block-rows with no tile (hcount 0); and
    bk = 32 with U = 1, whose single-tile rows have one ring stage, fewer
    than the ring holds.  Two runs agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = gappy_sym()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for bm, bk, U in ((16, 128, 4), (64, 128, 4), (100, 128, 4), (128, 128, 8),
                      (64, 32, 1)):
        op = tbsr.BlockSparseOperator.from_scipy(
            A, dtype=dtype, bm=bm, bk=bk, unroll=U, device="cuda"
        )
        assert (op.hcount.cpu().numpy() == 1).any()
        ncb = -(-A.shape[0] // bk)
        for hcount in (op.hcount, _empty_rows_dropped(A, op)):
            for b in WIDTHS:
                X = torch.randn((ncb * bk, b), dtype=dtype, device="cuda")
                args = (op.tile_cols, hcount, op.rptr, op.vals, X)
                n0 = tbsr.bsr_spmm_packed.launches
                Y = tbsr.bsr_spmm_packed(*args, bm=bm, bk=bk, H=op.H, unroll=U)
                again = tbsr.bsr_spmm_packed(*args, bm=bm, bk=bk, H=op.H, unroll=U)
                Yr = tbsr.bsr_spmm_packed_reference(*args, bm=bm, bk=bk, unroll=U)
                torch.cuda.synchronize()
                assert tbsr.bsr_spmm_packed.launches == n0 + 2
                assert rel_err(Y.cpu().numpy(), Yr.cpu().numpy()) < tol, (bm, bk, b)
                assert torch.equal(Y, again)


@pytest.mark.gpu
def test_cuda_solve_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = fem_elasticity_3d(6)
    n0 = tbsr.bsr_spmm_packed_resident.launches
    op = rtt.as_operator(A, dtype=torch.float64, device="cuda", format="bsr")
    res = rtt.rbl(op, 8, 4)
    assert res.eigenvectors.device.type == "cuda"
    assert tbsr.bsr_spmm_packed_resident.launches > n0
    w = np.linalg.eigvalsh(A.toarray())[::-1][:8]
    assert np.abs((res.eigenvalues - w) / w).max() < 1e-12


def _ell_operands(A, bm, U, dtype):
    """Blocked-ELL arrays of A on the card, L padded to a multiple of U."""
    bc, bv, nb, ncb, L = tbsr._blocked_ell_from_scipy(A, bm, 128, np.float64)
    Lp = L + (-L) % U
    bc = np.pad(bc, ((0, 0), (0, Lp - L)))
    bv = np.pad(bv, ((0, 0), (0, Lp - L), (0, 0), (0, 0)))
    return (torch.from_numpy(bc.reshape(-1)).cuda(),
            torch.from_numpy(bv.reshape(-1, bm, 128)).to("cuda", dtype),
            ncb, Lp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_blocked_ell_kernel_matches_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = gappy_sym()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for bm, U in ((16, 4), (64, 2), (100, 2), (128, 1)):
        bc, bv, ncb, L = _ell_operands(A, bm, U, dtype)
        for b in WIDTHS:
            X = torch.randn((ncb * 128, b), dtype=dtype, device="cuda")
            n0 = tbsr.bsr_spmm.launches
            Y = tbsr.bsr_spmm(bc, bv, X, bm=bm, bk=128, L=L, unroll=U)
            again = tbsr.bsr_spmm(bc, bv, X, bm=bm, bk=128, L=L, unroll=U)
            Yr = tbsr.bsr_spmm_reference(bc, bv, X, bm=bm, bk=128, L=L)
            torch.cuda.synchronize()
            assert tbsr.bsr_spmm.launches == n0 + 2
            assert rel_err(Y.cpu().numpy(), Yr.cpu().numpy()) < tol, (bm, b)
            assert torch.equal(Y, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_panel_kernel_matches_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = random_sym(768, 0.03, seed=3)
    for bm, U in ((16, 4), (32, 2), (16, 8), (100, 4), (128, 8)):
        op = tbsr.BlockSparseOperator.from_scipy(
            A, dtype=dtype, bm=bm, unroll=U, panel=True, device="cuda"
        )
        for b in (1, 5, 8, 33, 100):
            X = torch.randn((6 * 128, b), dtype=dtype, device="cuda")
            args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
            n0 = tbsr.bsr_spmm_panel.launches
            Ys = tbsr.bsr_spmm_panel(*args, bm=bm, bk=128, H=op.H, unroll=U)
            Yc = tbsr.bsr_spmm_panel(*args, bm=bm, bk=128, H=op.H, unroll=U,
                                     gather="concat")
            Yr = tbsr.bsr_spmm_panel_reference(*args, bm=bm, bk=128, unroll=U)
            torch.cuda.synchronize()
            assert tbsr.bsr_spmm_panel.launches == n0 + 2
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert rel_err(Ys.cpu().numpy(), Yr.cpu().numpy()) < tol
            assert torch.equal(Ys, Yc)


@pytest.mark.gpu
def test_cuda_solve_goes_through_the_panel_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = fem_elasticity_3d(6)
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64,
                                            panel=True, device="cuda")
    n0 = tbsr.bsr_spmm_panel.launches
    res = rtt.rbl(op, 8, 4)
    assert tbsr.bsr_spmm_panel.launches > n0
    w = np.linalg.eigvalsh(A.toarray())[::-1][:8]
    assert np.abs((res.eigenvalues - w) / w).max() < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["stream", "stream_dot", "manual"])
def test_cuda_tile_stream_kernels_match_reference(variant):
    """B5-B7 against their plain versions, held to 1e-5 · Σ|terms| per
    entry: one chunk, two and three (the ring's slots reused), chunks
    taller than a ring stage, fewer chunks than SMs and a count that is
    not a multiple of the SM count; bit for bit from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.randn((8, 128), generator=g, device="cuda")
    xt = torch.randn((8, 128), generator=g, device="cuda")
    launches = getattr(tds, {"stream": "dma_stream", "stream_dot": "dma_stream_dot",
                             "manual": "dma_stream_manual"}[variant])
    for S, bm, U in ((1, 8, 2), (2, 8, 2), (3, 8, 2), (3, 40, 5), (2, 125, 8),
                     (100, 8, 2), (1001, 16, 4)):
        CH = bm * U
        vals = torch.randn((S * CH, 128), generator=g, device="cuda")
        if variant == "stream":
            fn, plain = tds.make_stream(S, CH), tds.stream_reference
            args, kw = (vals, seed), dict(S=S, CH=CH)
        elif variant == "stream_dot":
            fn, plain = tds.make_stream_dot(S, CH, bm, U), tds.stream_dot_reference
            args, kw = (vals, seed, xt), dict(S=S, CH=CH, bm=bm, U=U)
        else:
            fn, plain = tds.make_manual(S, CH), tds.manual_reference
            args, kw = (vals, seed), dict(S=S, CH=CH)
        n0 = launches.launches
        out = fn(*args)
        again = fn(*args)
        ref, scale = tds.reference_f64(variant, *args)
        torch.cuda.synchronize()
        assert launches.launches == n0 + 2
        assert tds.error_ratio(out, ref, scale) <= 1.0
        assert tds.error_ratio(plain(*args, **kw), ref, scale) <= 1.0
        assert torch.equal(out, again)


# --- the pinned-host basis tier and the sweep checkpoint on the card -------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned panels and copy streams")


@pytest.mark.gpu
def test_host_panels_are_pinned_and_copied_before_their_columns_are_reused():
    """A store under a cap, fed 50 blocks whose column j holds the value
    j: every panel is pinned memory, and every stored column — read back
    through read_block, the panels, stream_host_tier and snapshot — holds
    its own index, so each panel's device→host copy had read its columns
    before the compaction overwrote them."""
    _needs_card()
    from rbl_tpu_torch.solver.basis import BasisStore

    n, b, cap = 200_000, 4, 64
    store = BasisStore(n, b, max_cols=50 * b, dtype=torch.float32,
                       device="cuda", device_cap_cols=cap)
    for i in range(50):
        cols = torch.arange(i * b, (i + 1) * b, dtype=torch.float32, device="cuda")
        store.append(cols.expand(n, b))
    assert len(store.host_tier()) >= 2
    assert all(p.is_pinned() and p.device.type == "cpu" for p in store.host_tier())
    assert store.host_ncols + store.dev_ncols == 200
    want = np.arange(200, dtype=np.float32)
    snap = store.snapshot(200)
    assert np.array_equal(snap[0], want) and np.array_equal(snap[-1], want)
    assert np.array_equal(snap.min(axis=0), want) and np.array_equal(snap.max(axis=0), want)
    for col in range(0, 200, b):
        blk = store.read_block(col, b)
        assert blk.device.type == "cuda"
        assert torch.equal(blk[::50_000], torch.arange(
            col, col + b, dtype=torch.float32, device="cuda").expand(4, b))
    off = 0
    for panel in store.stream_host_tier():
        w = panel.shape[1]
        assert panel.device.type == "cuda"
        lo, hi = panel.min(dim=0).values, panel.max(dim=0).values
        ref = torch.arange(off, off + w, dtype=torch.float32, device="cuda")
        assert torch.equal(lo, ref) and torch.equal(hi, ref)
        off += w
    assert off == store.host_ncols


def _fem_cfg(**kw):
    return rtt.RBLConfig(block_size=4, basis_dtype=torch.float32,
                         compute_dtype=torch.float32, qr_method="cholqr2",
                         tol=1e-3, max_kryl_dim=400, **kw)


@pytest.mark.gpu
def test_capped_solve_equals_the_uncapped_one_on_the_card():
    """fem_elasticity_3d(12) through the packed kernel, f32, tol 1e-3: the
    solve under basis_device_cap_cols=64 passes the cap, writes pinned
    panels, and returns the uncapped solve's eigenvalues within 1e-4
    relative (both stop at the same residual bound)."""
    _needs_card()
    from rbl_tpu_torch.utils.profiling import Timer

    op = rtt.as_operator(fem_elasticity_3d(12), dtype=torch.float32,
                         device="cuda", format="bsr")
    ref = rtt.rbl(op, 12, cfg=_fem_cfg())
    timer = Timer()
    res = rtt.rbl(op, 12, cfg=_fem_cfg(basis_device_cap_cols=64), timer=timer)
    assert res.kryl_dim > 64 and timer.counters["basis_host_panels"] >= 1
    assert timer.counters["basis_h2d_bytes"] > 0
    assert rel_err(res.eigenvalues, ref.eigenvalues) < 1e-4
    V = res.eigenvectors
    assert float((V.T @ V - torch.eye(12, device="cuda")).abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [None, 64])
def test_sweep_resume_on_the_card(cap, tmp_path):
    """Abort after 4 chunks, resume from the file: the resumed solve ends as
    the uninterrupted one (eigenvalues within the solve's 1e-3) and removes
    its file; with a cap the resume refills the host tier."""
    _needs_card()
    op = rtt.as_operator(fem_elasticity_3d(12), dtype=torch.float32,
                         device="cuda", format="bsr")
    path = str(tmp_path / "sweep.npz")
    ref = rtt.rbl(op, 12, cfg=_fem_cfg(basis_device_cap_cols=cap))
    cfg = _fem_cfg(basis_device_cap_cols=cap, sweep_checkpoint_path=path)
    with pytest.raises(rtt.SweepAborted):
        rtt.rbl(op, 12, cfg=cfg.replace(fault_inject_abort_after_chunks=4))
    assert (tmp_path / "sweep.npz").exists()
    res = rtt.rbl(op, 12, cfg=cfg)
    assert not (tmp_path / "sweep.npz").exists()
    assert res.converged == ref.converged
    assert rel_err(res.eigenvalues, ref.eigenvalues) < 1e-3


@pytest.mark.gpu
def test_cuda_minres_solve_goes_through_the_packed_kernel(monkeypatch):
    """An SM solve of fem_elasticity_3d(6) in f64 through the shift-invert
    operator on a packed-BSR A: every inner MINRES iteration launches B1
    (b = 4, X under the resident limit), and the eigenvalues agree with the
    dense spectrum's low end within 1e-10 relative."""
    _needs_card()
    from rbl_tpu_torch.ops import minres as minres_mod
    from rbl_tpu_torch.ops.minres import ShiftInvertOperator, block_minres

    A = fem_elasticity_3d(6)
    op = rtt.as_operator(A, dtype=torch.float64, device="cuda", format="bsr")
    B = torch.randn((A.shape[0], 4), dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    n0 = tbsr.bsr_spmm_packed_resident.launches
    with monkeypatch.context() as m:
        m.setattr(minres_mod, "DEFAULT_CHECK_EVERY", 1)
        X, (itn, rel) = block_minres(op.apply, B, tol=1e-12)
    assert tbsr.bsr_spmm_packed_resident.launches - n0 == itn > 0
    ref = np.linalg.solve(A.toarray(), B.cpu().numpy())
    assert rel_err(X.cpu().numpy(), ref) < 1e-9
    si = ShiftInvertOperator.shift(op, 0.0, inner_tol=1e-12)
    res = rtt.rbl(si, 4, 4, cfg=rtt.RBLConfig(tol=1e-10 / np.linalg.eigvalsh(A.toarray())[0]))
    w = np.linalg.eigvalsh(A.toarray())[:4]
    assert rel_err(np.sort(1.0 / res.eigenvalues), w) < 1e-10
    assert si.counts["iterations"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("build", ["grid", "sa"])
def test_cuda_amg_cycle_matches_the_cpu_cycle(dtype, build):
    """One V-cycle of the same hierarchy (fem_elasticity_3d(8), a 300-row
    coarsest) on the card and on the CPU: 1e-5 relative in f32, 1e-12 in
    f64.  The card's levels take the router's route (BSR or DIA)."""
    _needs_card()
    from rbl_tpu_torch.ops.amg import AssembledMultigrid

    A = fem_elasticity_3d(8)
    make = (lambda dev: AssembledMultigrid.from_grid(A, (8, 9, 9), dof=3, dtype=dtype,
                                                     device=dev, coarsest_n=300)) \
        if build == "grid" else \
        (lambda dev: AssembledMultigrid.smoothed_aggregation(A, dof=3, dtype=dtype,
                                                             device=dev, coarsest_n=300))
    card, host = make("cuda"), make("cpu")
    X = torch.randn((A.shape[0], 8), dtype=dtype,
                    generator=torch.Generator().manual_seed(1))
    got = card.psolve(X.cuda()).cpu().numpy()
    want = host.psolve(X).numpy()
    assert rel_err(got, want) < (1e-5 if dtype == torch.float32 else 1e-12)
