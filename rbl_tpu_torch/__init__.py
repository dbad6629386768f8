"""rbl_tpu_torch — randomized block Lanczos eigensolver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``rbl_tpu`` (the reference it is tested against):
k largest-magnitude eigenpairs of large sparse symmetric matrices via
randomized block Lanczos with local + partial reorthogonalization, banded
Rayleigh–Ritz solves on the host, residual-bound convergence and Ritz-vector
recovery.  The block-sparse SpMMs run as CUDA kernels (``csrc/*.cu``) on
the card.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Public surface:
  rbl / RBL / RBL_gpu      — RBL(A, k, b)            (RBL.jl:119)
  RBLConfig                — every knob the reference hardcodes
  operators                — DiagonalOperator, DenseOperator,
                             BlockSparseOperator, DiaOperator,
                             SparseEllOperator, CooOperator, HybOperator,
                             Laplacian2D/3D; as_operator coerces
                             scipy/numpy/torch input and picks the sparse
                             layout (format="auto"|"dia"|"bsr"|"ell"|"hyb"|"coo")
"""

from .config import RBLConfig
from .ops.spmm.bsr import BlockSparseOperator
from .ops.spmm.coo import CooOperator, HybOperator
from .ops.spmm.dia import DiaOperator
from .ops.spmm.ell import SparseEllOperator
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
    "DiaOperator",
    "SparseEllOperator",
    "CooOperator",
    "HybOperator",
    "DiagonalOperator",
    "DenseOperator",
    "Laplacian2D",
    "Laplacian3D",
    "LanczosResult",
]

__version__ = "0.1.0"
