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
  rbl_restarted / RBL_restarted / RBL_gpu_restarted
                           — restarted + deflated    (restarted.jl:97,196)
  rbl_polished / chebyshev_refine
                           — f32 discovery, f64 Chebyshev-filtered polish
  rbl_filtered             — Chebyshev-filtered sweep for LA / SA
  rbl_svd                  — truncated SVD on a matrix-free Gram operator
                             (which="LM" or "SM")
  rbl_generalized / PencilInfo
                           — pencils A·x = λ·M·x: Chebyshev M^(-1/2)
                             transform, shift-invert modes normal /
                             buckling / cayley
  ShiftInvertOperator / block_minres
                           — (A − σI)⁻¹ by blocked MINRES, the exact FDM
                             solve or a multigrid-preconditioned one
  AssembledMultigrid / block_jacobi_psolve / rigid_body_modes
                           — preconditioners for assembled SPD matrices
  ChebyshevSeriesOperator / PencilOperator /
  GeneralizedShiftInvertOperator
                           — the pencil transforms as operators
  RBLConfig                — every knob the reference hardcodes, the
                             pinned-host basis tier and the sweep
                             checkpoint among them
  operators                — DiagonalOperator, DenseOperator,
                             BlockSparseOperator, DiaOperator,
                             SparseEllOperator, CooOperator, HybOperator,
                             Laplacian2D/3D, GramOperator,
                             SparseGramOperator, FunctionOperator,
                             AffineOperator, ChebyshevFilterOperator;
                             as_operator coerces
                             scipy/numpy/torch input and picks the sparse
                             layout (format="auto"|"dia"|"bsr"|"ell"|"hyb"|"coo")
"""

from .config import RBLConfig
from .ops.amg import AssembledMultigrid, block_jacobi_psolve, rigid_body_modes
from .ops.generalized import (
    ChebyshevSeriesOperator,
    GeneralizedShiftInvertOperator,
    PencilOperator,
)
from .ops.minres import ShiftInvertOperator, block_minres
from .ops.spmm.bsr import BlockSparseOperator
from .ops.spmm.coo import CooOperator, HybOperator
from .ops.spmm.dia import DiaOperator
from .ops.spmm.ell import SparseEllOperator
from .ops.chebyshev import ChebyshevFilterOperator
from .ops.spmm.operator import (
    AffineOperator,
    DenseOperator,
    DiagonalOperator,
    FunctionOperator,
    GramOperator,
    Laplacian2D,
    Laplacian3D,
    LinearOperator,
    SparseGramOperator,
    as_operator,
)
from .solver.filtered import FilterInfo, rbl_filtered
from .solver.generalized import PencilInfo, rbl_generalized
from .solver.lanczos import LanczosResult, SweepAborted
from .solver.polish import chebyshev_refine, rbl_polished
from .solver.rbl import RBL, RBL_gpu, rbl
from .solver.restarted import RBL_gpu_restarted, RBL_restarted, rbl_restarted
from .solver.svd import SVDResult, rbl_svd

__all__ = [
    "RBLConfig",
    "rbl",
    "RBL",
    "RBL_gpu",
    "rbl_restarted",
    "RBL_restarted",
    "RBL_gpu_restarted",
    "chebyshev_refine",
    "rbl_polished",
    "rbl_filtered",
    "FilterInfo",
    "rbl_svd",
    "SVDResult",
    "rbl_generalized",
    "PencilInfo",
    "ShiftInvertOperator",
    "block_minres",
    "AssembledMultigrid",
    "block_jacobi_psolve",
    "rigid_body_modes",
    "ChebyshevSeriesOperator",
    "GeneralizedShiftInvertOperator",
    "PencilOperator",
    "SweepAborted",
    "as_operator",
    "LinearOperator",
    "AffineOperator",
    "FunctionOperator",
    "GramOperator",
    "SparseGramOperator",
    "ChebyshevFilterOperator",
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
