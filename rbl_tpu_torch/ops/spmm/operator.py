"""Linear-operator abstraction for the sparse symmetric matrix A.

The solver core is written against one abstract ``LinearOperator``.  Each
implementation is a plain class holding its tensors on an explicit device:
dense, diagonal, the matrix-free stencils, the DIA/ELL/COO/HYB sparse
layouts (``dia.py``, ``ell.py``, ``coo.py``) and the block-sparse operator
whose SpMM is a hand-written CUDA kernel (``bsr.py``).  ``as_operator``
routes a sparse matrix to one of them (``_pick_sparse_format``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ...config import resolve_device

# numpy counterparts of the torch dtypes an operator may hold.  numpy has
# no bfloat16: such operators are built in float32 on the host and cast on
# the way to the device.
_NP_OF = {torch.float16: np.float16, torch.float32: np.float32,
          torch.float64: np.float64}


def _pet(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: accumulate sub-f32 inputs in f32."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def host_dtype(dtype, like) -> np.dtype:
    """numpy dtype in which the host builds the arrays of an operator of
    torch ``dtype`` (None: ``like``, the input matrix's own dtype)."""
    if dtype is None:
        return np.dtype(like)
    return np.dtype(_NP_OF.get(dtype, np.float32))


def to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` (None: its own) on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def dot(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` computed and returned in ``acc``.  Operands are upcast
    first: a bf16 matmul in torch returns (and rounds to) bf16, where the
    JAX package asked for an f32 result (``preferred_element_type``)."""
    return torch.matmul(a.to(acc), b.to(acc))


class LinearOperator:
    """A symmetric n×n linear operator.

    Required:
      - ``shape`` -> (n, n)
      - ``dtype`` and ``device``
      - ``apply(X)``: block matvec, (n, b) -> (n, b)
    """

    @property
    def shape(self):
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diagonal(self):
        """The matrix diagonal as an (n,) tensor, or None when extraction
        is not supported."""
        return None

    def __matmul__(self, X):
        return self.apply(X)

    @property
    def n(self) -> int:
        return self.shape[0]


def cast_operator(op, dtype: torch.dtype):
    """An operator equal to ``op`` with every floating tensor field (and a
    ``dtype`` field, for the matrix-free stencils) cast to ``dtype``."""

    def cast(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(dtype)
        if (dataclasses.is_dataclass(v) and not isinstance(v, type)
                and hasattr(v, "apply")):
            return cast_operator(v, dtype)  # a nested operator or factor
        return v

    kw = {f.name: cast(getattr(op, f.name)) for f in dataclasses.fields(op)}
    if "dtype" in kw:
        kw["dtype"] = dtype
    return dataclasses.replace(op, **kw)


@dataclasses.dataclass
class DiagonalOperator(LinearOperator):
    """A = diag(d).  The reference's unit-test matrices are exactly this
    (Unit Testing/test.jl:17-50 builds sparse(Diagonal(a)))."""

    diag: torch.Tensor  # (n,)

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def apply(self, X):
        return self.diag[:, None] * X

    def diagonal(self):
        return self.diag


@dataclasses.dataclass
class DenseOperator(LinearOperator):
    """A as a dense matrix (the image demo's Gram matrix, images.jl:21-25,
    and the reference oracle in tests)."""

    mat: torch.Tensor  # (n, n)

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def apply(self, X):
        return dot(self.mat, X, _pet(X.dtype))

    def diagonal(self):
        return torch.diagonal(self.mat)


@dataclasses.dataclass
class GramOperator(LinearOperator):
    """A = BᵀB (or B·Bᵀ) of a rectangular factor B, applied matrix-free as
    two chained GEMMs — the Gram matrix is never materialized.

    The reference's image demo forms the n×n Gram densely before solving
    (images.jl:21 ``RBL(B'B, k)``); matrix-free keeps device memory at
    O(m·n) instead of O(n²) + O(m·n).  Used by ``rbl_svd``
    (solver/svd.py)."""

    B: torch.Tensor  # (m, n)
    left: bool = False  # True: A = B·Bᵀ (m×m)

    @property
    def shape(self):
        s = self.B.shape[0] if self.left else self.B.shape[1]
        return (s, s)

    @property
    def dtype(self):
        return self.B.dtype

    @property
    def device(self):
        return self.B.device

    def apply(self, X):
        acc = _pet(X.dtype)
        F, S = (self.B.T, self.B) if self.left else (self.B, self.B.T)
        return dot(S, dot(F, X, acc), acc)

    def diagonal(self):
        # diag(BᵀB) = squared column norms (rows for the B·Bᵀ side)
        ax = 1 if self.left else 0
        Ba = self.B.to(_pet(self.B.dtype))
        return torch.sum(Ba * Ba, dim=ax).to(self.B.dtype)


@dataclasses.dataclass
class FunctionOperator(LinearOperator):
    """Matrix-free operator from a user-supplied function
    ``fun(X) -> A·X`` on (n, b) tensors of ``dtype`` on ``device``.  The
    function must be symmetric as a linear map.  The scipy-LinearOperator
    migration path for matrix-free users — except the map stays on the
    device instead of calling back to the host."""

    fun: Any
    _n: int = 0
    dtype: torch.dtype = torch.float64
    device: torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def shape(self):
        return (self._n, self._n)

    def apply(self, X):
        return self.fun(X)


@dataclasses.dataclass
class SparseGramOperator(LinearOperator):
    """A = BᵀB (or B·Bᵀ) of a SPARSE rectangular factor B, applied
    matrix-free as two chained sparse SpMMs — neither the Gram matrix nor
    a dense copy of B is ever materialized.  The sparse upgrade of
    GramOperator for ``rbl_svd`` on large sparse factors (the reference's
    images.jl:21 forms BᵀB densely; scipy's ``svds`` keeps B sparse).

    Bf is the (m, n) forward factor, Bt its (n, m) transpose — both
    pre-sorted COO layouts built once at construction (coo.py
    RectCooOperator)."""

    Bf: Any  # RectCooOperator (m, n)
    Bt: Any  # RectCooOperator (n, m)
    left: bool = False  # True: A = B·Bᵀ (m×m)

    @property
    def shape(self):
        s = self.Bf.shape[0] if self.left else self.Bf.shape[1]
        return (s, s)

    @property
    def dtype(self):
        return self.Bf.dtype

    @property
    def device(self):
        return self.Bf.device

    def apply(self, X):
        if self.left:
            return self.Bf.apply(self.Bt.apply(X))
        return self.Bt.apply(self.Bf.apply(X))

    def diagonal(self):
        # diag(BᵀB)_j = Σ_{nnz with col j} val² (rows for the B·Bᵀ side);
        # COO pad slots carry val 0, so they contribute nothing.  Row-banded
        # factors (parallel/dist_spmm.py) hold LOCAL row ids and global
        # column ids: the B·Bᵀ side is the rank's own; the BᵀB side sums
        # every rank's band, then keeps the rank's rows of n.
        mesh = getattr(self.Bf, "mesh", None)
        sq = self.Bf.vals * self.Bf.vals
        if self.left:
            rows = self.Bf.shape[0] if mesh is None else self.Bf.shape[0] // mesh.size
            out = torch.zeros((rows,), dtype=self.dtype, device=self.device)
            return out.index_add_(0, self.Bf.rows.long(), sq)
        n = self.Bf.shape[1]
        out = torch.zeros((n,), dtype=self.dtype, device=self.device)
        out = out.index_add_(0, self.Bf.cols.long(), sq)
        if mesh is None:
            return out
        return mesh.all_reduce_sum(out)[slice(*mesh.row_range(n))]

    @classmethod
    def from_scipy(cls, B, dtype=None, left: bool = False, device=None):
        """Build from a scipy sparse (m, n) factor on ``device`` (default:
        the CUDA card)."""
        from .coo import RectCooOperator

        Bf = RectCooOperator.from_scipy(B, dtype=dtype, device=device)
        return cls(Bf=Bf, Bt=Bf.transpose(), left=left)


@dataclasses.dataclass
class AffineOperator(LinearOperator):
    """α·A + β·I of a base operator — the spectral-shift combinator behind
    ``rbl(..., which="LA"/"SA")``: shifting by β ≥ ‖A‖₂ moves the
    algebraic extreme of the spectrum to the magnitude extreme."""

    base: LinearOperator
    alpha: float
    beta: float

    @classmethod
    def shift(cls, base, alpha: float, beta: float):
        return cls(base=base, alpha=float(alpha), beta=float(beta))

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def apply(self, X):
        return self.alpha * self.base.apply(X) + self.beta * X

    def diagonal(self):
        d = self.base.diagonal()
        return None if d is None else self.alpha * d + self.beta


@dataclasses.dataclass
class Laplacian2D(LinearOperator):
    """Matrix-free 5-point 2D Laplacian stencil on an nx×ny grid
    (Dirichlet).  n = nx*ny.

    The block is processed as the folded (nx, ny·b) view of the JAX
    package: y-neighbours are ±b column shifts and x-neighbours row
    shifts.  The shifted terms are subtracted in place from one output
    buffer, in the same order as the JAX expression, instead of building
    two padded copies of X."""

    nx: int
    ny: int
    dtype: torch.dtype = torch.float64
    device: torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def shape(self):
        return (self.nx * self.ny, self.nx * self.ny)

    def apply(self, X):
        b = X.shape[1]
        G = X.reshape(self.nx, self.ny * b)
        out = 4.0 * G
        out[1:] -= G[:-1]
        out[:-1] -= G[1:]
        out[:, b:] -= G[:, :-b]
        out[:, :-b] -= G[:, b:]
        return out.reshape(self.nx * self.ny, b)

    def diagonal(self):
        return torch.full((self.n,), 4.0, dtype=self.dtype, device=self.device)


@dataclasses.dataclass
class Laplacian3D(LinearOperator):
    """Matrix-free 7-point 3D Laplacian on an nx×ny×nz grid (Dirichlet),
    in the folded (nx, ny, nz·b) layout of ``Laplacian2D``."""

    nx: int
    ny: int
    nz: int
    dtype: torch.dtype = torch.float64
    device: torch.device | None = None  # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def shape(self):
        n = self.nx * self.ny * self.nz
        return (n, n)

    def apply(self, X):
        b = X.shape[1]
        G = X.reshape(self.nx, self.ny, self.nz * b)
        out = 6.0 * G
        out[1:] -= G[:-1]
        out[:-1] -= G[1:]
        out[:, 1:] -= G[:, :-1]
        out[:, :-1] -= G[:, 1:]
        out[:, :, b:] -= G[:, :, :-b]
        out[:, :, :-b] -= G[:, :, b:]
        return out.reshape(-1, b)

    def diagonal(self):
        return torch.full((self.n,), 6.0, dtype=self.dtype, device=self.device)


# Effective bandwidth of DiaOperator.apply on the card, in bytes of the
# router's DIA model (per diagonal and row: 4 B of data + b = 8 columns of
# 4 B of X) per second.  Fit by tools/fit_router.py to the f32, b = 8
# apply times of fem_elasticity_3d(42) (99 diagonals, 1.440 ms: 577 GB/s)
# and the assembled 512² Laplacian (5 diagonals, 0.196 ms: 240 GB/s) on
# an NVIDIA H100 80GB HBM3, 700.00 W.
_DIA_BYTES_PER_S = 5.362e11


def _pick_sparse_format(A, dtype, device):
    """Choose the layout for a scipy sparse matrix bound for ``device``;
    returns (format, packed-BSR tile plan or None).

    Banded matrices (≤ 64 populated diagonals) go to DIA.  On a CUDA
    device, for f32 or f64 (the dtypes of the CUDA kernel), DIA and the
    packed-BSR kernel are compared by their time models, and a block-
    structured matrix with adequate tile fill goes to BSR.  Otherwise DIA
    while the matrix fits it, HYB under row-length skew, ELL for the rest.
    On the CPU this is the JAX package's route off the TPU."""
    from .bsr import _tile_census, modeled_bsr_apply_seconds, pick_tile_plan
    from .dia import count_diagonals

    n = A.shape[0]
    ndiags = count_diagonals(A)
    if ndiags <= 64:
        return "dia", None
    # the operator is built at dtype or, when unspecified, A's own dtype
    dt = dtype if dtype is not None else torch.from_numpy(
        np.zeros(0, dtype=A.dtype)).dtype
    if torch.device(device).type == "cuda" and dt in (torch.float32,
                                                      torch.float64):
        # one plan computation, threaded through to from_scipy
        plan = pick_tile_plan(A)
        bsr_s = modeled_bsr_apply_seconds(A, plan=plan)
        if ndiags <= 256:  # DiaOperator's max_diags guard
            dia_s = ndiags * n * (4 + 4 * 8) / _DIA_BYTES_PER_S
            if dia_s < bsr_s:
                return "dia", None
        # probe fill at the tuned height
        bm = plan[0]
        _, ukey, _, _, _, _, _ = _tile_census(A.tocoo(), bm, 128)
        fill = A.nnz / max(len(ukey) * bm * 128, 1)
        if fill >= 0.02:
            return "bsr", plan
    # no kernel tier: DIA's shifted multiply-adds beat the gathers of ELL
    # whenever the matrix fits the diagonal format at all
    if ndiags <= 256:
        return "dia", None
    # ELL pads every row to the longest: under row-length skew route to
    # HYB (capped ELL + COO overflow)
    row_nnz = np.diff(A.tocsr().indptr)
    if row_nnz.size and row_nnz.max() > 4 * max(row_nnz.mean(), 1.0):
        return "hyb", None
    return "ell", None


_FORMATS = ("auto", "dia", "bsr", "ell", "hyb", "coo")


def _scipy_from_torch_sparse(A):
    """A torch sparse COO or CSR matrix as scipy CSR, through host COO
    triplets (explicit zeros dropped, duplicates summed)."""
    import scipy.sparse as sp

    if A.ndim != 2 or A.dense_dim() != 0:
        raise TypeError(
            "batched or block sparse tensors are not supported — pass an "
            "unbatched 2-D sparse matrix"
        )
    C = A.to_sparse_coo().coalesce().cpu()
    idx = C.indices().numpy()
    dat = C.values().numpy()
    live = dat != 0
    return sp.coo_matrix((dat[live], (idx[0, live], idx[1, live])),
                         shape=tuple(A.shape)).tocsr()


def as_operator(A, dtype=None, device=None, format: str = "auto") -> LinearOperator:
    """Coerce a user-supplied matrix into a LinearOperator on ``device``.

    Accepts: LinearOperator (returned as-is, cast to ``dtype`` if it
    differs; it keeps its own device), a tensor (it keeps its own device
    unless ``device`` is given; a torch sparse COO/CSR matrix is routed
    through scipy triplets so that the layout choice applies), a numpy
    array (2-D dense, 1-D diagonal), or a scipy sparse matrix.  Host data
    goes to ``device``, by default the CUDA card: pass ``device="cpu"`` for
    the CPU.

    An exactly diagonal sparse matrix becomes a DiagonalOperator; any other
    picks its layout with ``format="auto"`` (``_pick_sparse_format``), or
    takes the one forced by format="dia" | "bsr" | "ell" | "hyb" | "coo".
    """
    if isinstance(A, LinearOperator):
        if dtype is not None and A.dtype != dtype:
            return cast_operator(A, dtype)
        return A
    if format not in _FORMATS:
        raise ValueError(f"unknown format {format!r}; one of {_FORMATS}")
    if isinstance(A, torch.Tensor):
        if device is None:
            device = A.device
        if A.layout in (torch.sparse_coo, torch.sparse_csr):
            A = _scipy_from_torch_sparse(A)
    device = resolve_device(device)
    if hasattr(A, "tocsr"):  # scipy.sparse
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"operator must be square, got {A.shape}")
        if format == "auto" and A.nnz <= A.shape[0]:
            # cheap screen (diagonal ⇒ nnz ≤ n), then the exact test
            import scipy.sparse as sp

            coo = sp.coo_matrix(A)
            if coo.nnz == 0 or bool(np.all(coo.row == coo.col)):
                d = np.zeros(A.shape[0], dtype=coo.data.dtype)
                np.add.at(d, coo.row, coo.data)
                return DiagonalOperator(to_device(d, dtype, device))
        plan = None
        fmt = format
        if format == "auto":
            fmt, plan = _pick_sparse_format(A, dtype, device)
        if fmt == "dia":
            from .dia import DiaOperator

            return DiaOperator.from_scipy(A, dtype=dtype, device=device)
        if fmt == "bsr":
            from .bsr import BlockSparseOperator

            return BlockSparseOperator.from_scipy(
                A, dtype=dtype or torch.float32,
                bm=plan[0] if plan else None,
                unroll=plan[1] if plan else None, device=device,
            )
        if fmt == "hyb":
            from .coo import HybOperator

            return HybOperator.from_scipy(A, dtype=dtype, device=device)
        if fmt == "coo":
            from .coo import CooOperator

            return CooOperator.from_scipy(A, dtype=dtype, device=device)
        from .ell import SparseEllOperator

        return SparseEllOperator.from_scipy(A.tocsr(), dtype=dtype,
                                            device=device)
    T = torch.as_tensor(A, device=device)
    if dtype is not None:
        T = T.to(dtype)
    if T.ndim == 1:
        return DiagonalOperator(T)
    if T.ndim == 2:
        return DenseOperator(T)
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")
