"""Tests of the port's CUDA kernel on the card (marker ``gpu``); they skip
without a CUDA device.  This file imports neither JAX nor the JAX package,
so that it runs on a machine with torch for CUDA alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances: 1e-5
relative in f32, 1e-12 in f64, kernel against its plain PyTorch version.
"""

import numpy as np
import pytest
import torch

from _torch_parity import messy_sym, rel_err
import rbl_tpu_torch as rtt
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
    res = rtt.rbl(A, 8, 4, cfg=rtt.RBLConfig(device="cuda"))
    assert res.eigenvectors.device.type == "cuda"
    assert tbsr.bsr_spmm_packed_resident.launches > n0
    w = np.linalg.eigvalsh(A.toarray())[::-1][:8]
    assert np.abs((res.eigenvalues - w) / w).max() < 1e-12
