"""Accuracy-preserving long-axis contractions.

Every convergence-critical Gram / projection in the solver contracts over the
row dimension n (A_i = Q_iᵀU, reorthogonalization Grams, CholQR Grams).  A
single flat dot accumulates rounding linearly in n — enough to break the
1e-13 eigenvalue gate at n = 10⁵⁻⁶ (the reference reaches that accuracy
through OpenBLAS's register-blocked accumulation, RBL.jl:7-8).

``gram`` restores blocked accumulation portably: the row axis is split into
fixed chunks, each chunk contracted as one batched product, and the ~n/chunk
partials reduced pairwise.  Error drops from O(n·eps) to
O((chunk + n/chunk)·eps) worst-case.
"""

from __future__ import annotations

import torch

from .spmm.operator import _pet

_CHUNK = 8192


def _pairwise_sum(P):
    """Pairwise (tree) reduction over axis 0 of the (c, p, q) partials."""
    while P.shape[0] > 1:
        c = P.shape[0]
        half = c // 2
        even = P[: 2 * half : 2]
        odd = P[1 : 2 * half : 2]
        tail = P[2 * half :]
        P = torch.cat([even + odd, tail], dim=0)
    return P[0]


def gram(X, Y, chunk: int = _CHUNK, acc_dtype=None):
    """XᵀY with two-level row-chunked accumulation.  X: (n, p), Y: (n, q).

    The full chunks are contracted as strided views of X and Y (no copy
    unless a dtype cast is needed); the ragged tail rows form the last
    partial, which equals the JAX package's zero-padded last chunk."""
    n, p = X.shape
    q = Y.shape[1]
    acc = acc_dtype or _pet(torch.promote_types(X.dtype, Y.dtype))
    Xa, Ya = X.to(acc), Y.to(acc)
    if n <= chunk:
        return Xa.T @ Ya
    c_full = n // chunk
    body = c_full * chunk
    Xc = Xa[:body].reshape(c_full, chunk, p)
    Yc = Ya[:body].reshape(c_full, chunk, q)
    P = torch.bmm(Xc.transpose(1, 2), Yc)
    if body < n:
        P = torch.cat([P, (Xa[body:].T @ Ya[body:])[None]], dim=0)
    return _pairwise_sum(P)
