"""Linear-operator abstraction for the sparse symmetric matrix A.

The solver core is written against one abstract ``LinearOperator``.  Each
implementation is a plain class holding its tensors on an explicit device:
dense, diagonal, the matrix-free stencils, and the packed block-sparse
operator whose SpMM is a hand-written CUDA kernel (``bsr.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _pet(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: accumulate sub-f32 inputs in f32."""
    return torch.float32 if dtype.itemsize < 4 else dtype


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
        if isinstance(v, LinearOperator):
            return cast_operator(v, dtype)
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
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)

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
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)

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


def as_operator(A, dtype=None, device=None, format: str = "auto") -> LinearOperator:
    """Coerce a user-supplied matrix into a LinearOperator on ``device``
    (default: the CPU).

    Accepts: LinearOperator (returned as-is, cast to ``dtype`` if it
    differs; it keeps its own device), a tensor or numpy array (2-D dense,
    1-D diagonal), or a scipy sparse matrix.  An exactly diagonal sparse
    matrix becomes a DiagonalOperator; every other one the packed
    block-sparse operator ("auto" or "bsr").  The DIA, ELL, HYB and COO
    layouts are not ported yet.
    """
    if isinstance(A, LinearOperator):
        if dtype is not None and A.dtype != dtype:
            return cast_operator(A, dtype)
        return A
    device = torch.device(device) if device is not None else torch.device("cpu")
    if hasattr(A, "tocsr"):  # scipy.sparse
        if format not in ("auto", "bsr"):
            raise NotImplementedError(
                f"format={format!r} is not ported yet: the DIA/ELL/HYB/COO "
                "layouts are ROADMAP.md section A, item 1"
            )
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"operator must be square, got {A.shape}")
        if format == "auto" and A.nnz <= A.shape[0]:
            # cheap screen (diagonal ⇒ nnz ≤ n), then the exact test
            import scipy.sparse as sp

            coo = sp.coo_matrix(A)
            if coo.nnz == 0 or bool(np.all(coo.row == coo.col)):
                d = np.zeros(A.shape[0], dtype=coo.data.dtype)
                np.add.at(d, coo.row, coo.data)
                t = torch.as_tensor(d, device=device)
                return DiagonalOperator(t if dtype is None else t.to(dtype))
        from .bsr import BlockSparseOperator

        return BlockSparseOperator.from_scipy(
            A, dtype=dtype or torch.float32, device=device
        )
    T = torch.as_tensor(A, device=device)
    if dtype is not None:
        T = T.to(dtype)
    if T.ndim == 1:
        return DiagonalOperator(T)
    if T.ndim == 2:
        return DenseOperator(T)
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")
