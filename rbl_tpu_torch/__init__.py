"""rbl_tpu_torch — randomized block Lanczos eigensolver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``rbl_tpu`` (the reference it is tested against):
k largest-magnitude eigenpairs of large sparse symmetric matrices via
randomized block Lanczos with local + partial reorthogonalization, banded
Rayleigh–Ritz solves on the host, residual-bound convergence and Ritz-vector
recovery.  The packed block-sparse SpMM runs as a CUDA kernel
(``csrc/bsr_spmm.cu``) on the card.

Public surface:
  rbl / RBL / RBL_gpu      — RBL(A, k, b)            (RBL.jl:119)
  RBLConfig                — every knob the reference hardcodes
  operators                — DiagonalOperator, DenseOperator,
                             BlockSparseOperator, Laplacian2D/3D;
                             as_operator coerces scipy/numpy/torch input
"""

from .config import RBLConfig
from .ops.spmm.bsr import BlockSparseOperator
from .ops.spmm.operator import (
    DenseOperator,
    DiagonalOperator,
    Laplacian2D,
    Laplacian3D,
    as_operator,
)
from .solver.lanczos import LanczosResult
from .solver.rbl import RBL, RBL_gpu, rbl

__all__ = [
    "RBLConfig",
    "rbl",
    "RBL",
    "RBL_gpu",
    "as_operator",
    "BlockSparseOperator",
    "DiagonalOperator",
    "DenseOperator",
    "Laplacian2D",
    "Laplacian3D",
    "LanczosResult",
]

__version__ = "0.1.0"
