"""The 5-point stencil of ``Laplacian2D`` and one step of the Chebyshev
product filter on it (``ops/chebyshev.py``):

    Z = ((A − r·I)·Y)·s,   s_c = 1/√sumsq_in[c] (1 where that is not > 0),

and, on request, Σ_rows Z² a column, which the next step takes as its
``sumsq_in``: the filter's per-step column normalisation folded into the
next step's read.

On the card this is one launch of K3 (``csrc/stencil.cu``); ``step.launches``
counts them.  CPU tensors take the plain versions: ``_plain_apply`` below,
the torch expression ``Laplacian2D.apply`` ran before the kernel, and the
step's ``LinearOperator.filter_step`` around it, so that on the CPU the
stencil's filter gives every operator's bits.
"""

from __future__ import annotations

import torch


def apply(X: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """A·X on the grid nx × ny: one launch of K3 for a CUDA block, the
    plain version for a CPU one."""
    if X.device.type == "cpu":
        return _plain_apply(X, nx, ny)
    return step(X, nx, ny)[0]


def step(Y: torch.Tensor, nx: int, ny: int, r=None, sumsq_in=None,
         sumsq: bool = False) -> tuple:
    """(Z, Σ Z² a column or None) for a CUDA block Y (nx·ny, b) on the grid
    nx × ny, by one launch of K3 (copied first where its layout is not one
    the kernel reads); r a 0-d tensor of Y's dtype (None: the plain apply
    A·Y), ``sumsq_in`` the previous step's sums (None: s = 1).  Any other
    device raises."""
    from ._kernels import launch_stencil

    if Y.dim() != 2 or Y.shape[0] != nx * ny:
        raise ValueError(f"stencil: a ({nx * ny}, b) block, got {tuple(Y.shape)}")
    if (Y.shape[1] > 1 and Y.stride(1) != 1) or Y.stride(0) < Y.shape[1]:
        Y = Y.contiguous()
    out = launch_stencil(Y, ny, r, sumsq_in, sumsq)
    step.launches += 1
    return out


def _plain_apply(X: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """A·X on the folded (nx, ny·b) view: y-neighbours are ±b column shifts
    and x-neighbours row shifts, subtracted in place from one output
    buffer in the JAX package's order."""
    b = X.shape[1]
    G = X.reshape(nx, ny * b)
    out = 4.0 * G
    out[1:] -= G[:-1]
    out[:-1] -= G[1:]
    out[:, b:] -= G[:, :-b]
    out[:, :-b] -= G[:, b:]
    return out.reshape(nx * ny, b)


# K3 launches (csrc/stencil.cu): a run can show it went through the kernel
step.launches = 0
