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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    A = messy_sym()
    # bm=100 leaves threads idle (128 % bm != 0); b=33 and 100 span two
    # and four column groups
    for bm, U in ((16, 4), (100, 4), (128, 8)):
        op = tbsr.BlockSparseOperator.from_scipy(
            A, dtype=dtype, bm=bm, unroll=U, device="cuda"
        )
        for b in (1, 5, 8, 33, 100):
            X = torch.randn((16 * 128, b), dtype=dtype, device="cuda")
            args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
            n0 = tbsr.bsr_spmm_packed.launches
            Y = tbsr.bsr_spmm_packed(*args, bm=bm, bk=128, H=op.H, unroll=U)
            Yr = tbsr.bsr_spmm_packed_reference(*args, bm=bm, bk=128, unroll=U)
            torch.cuda.synchronize()
            assert tbsr.bsr_spmm_packed.launches == n0 + 1
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert rel_err(Y.cpu().numpy(), Yr.cpu().numpy()) < tol


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
    A = messy_sym()
    for bm, U in ((16, 4), (100, 2), (128, 1)):
        bc, bv, ncb, L = _ell_operands(A, bm, U, dtype)
        for b in (1, 5, 8, 33, 100):
            X = torch.randn((ncb * 128, b), dtype=dtype, device="cuda")
            n0 = tbsr.bsr_spmm.launches
            Y = tbsr.bsr_spmm(bc, bv, X, bm=bm, bk=128, L=L, unroll=U)
            Yr = tbsr.bsr_spmm_reference(bc, bv, X, bm=bm, bk=128, L=L)
            torch.cuda.synchronize()
            assert tbsr.bsr_spmm.launches == n0 + 1
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert rel_err(Y.cpu().numpy(), Yr.cpu().numpy()) < tol


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
