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

Under a row mesh (``mesh``, a ``parallel.mesh.RowMesh``) X and Y are the
rank's rows: each rank contracts its slab the same way and one all-reduce
sums the partials, in the accumulation dtype (never in bf16).

On the card both products against the stored basis are hand kernels
(``csrc/skinny.cu``, one launch each): ``gram`` (K1, the same chunks and
the same pairwise tree) and ``update``, W − V·round(G) (K2).  They read
every operand in its stored dtype, where the torch expressions below, kept
as the plain versions for CPU tensors, first copy it to the accumulation
dtype.  ``gram.launches`` and ``update.launches`` count the launches.
"""

from __future__ import annotations

import torch

from .spmm.operator import _pet, dot

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


def gram(X, Y, chunk: int = _CHUNK, acc_dtype=None, mesh=None):
    """XᵀY with two-level row-chunked accumulation.  X: (n, p), Y: (n, q)
    (the rank's rows under ``mesh``, the result summed over the ranks).

    The full chunks are contracted as strided views of X and Y (no copy
    unless a dtype cast is needed); the ragged tail rows form the last
    partial, which equals the JAX package's zero-padded last chunk."""
    G = _local_gram(X, Y, chunk, acc_dtype)
    return G if mesh is None else mesh.all_reduce_sum(G)


def _local_gram(X, Y, chunk, acc_dtype):
    acc = acc_dtype or _pet(torch.promote_types(X.dtype, Y.dtype))
    if X.device.type == "cpu":
        return _plain_gram(X, Y, chunk, acc)
    from .spmm._kernels import launch_gram

    G, launched = launch_gram(X, Y, chunk=chunk, acc=acc)
    gram.launches += launched
    return G


def _plain_gram(X, Y, chunk, acc):
    n, p = X.shape
    q = Y.shape[1]
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


def update(V, G, W=None, acc=None):
    """W − V·G with G (p, q) rounded to V's dtype first (the JAX package's
    coefficients in the basis dtype) and the product accumulated in
    ``acc`` (default: f32 at least, of W's dtype), returned in W's dtype;
    with ``W`` None, V·G in ``acc`` (default: of V's dtype)."""
    if acc is None:
        acc = _pet((V if W is None else W).dtype)
    if V.device.type == "cpu":
        return _plain_update(V, G, W, acc)
    from .spmm._kernels import launch_update

    out = launch_update(V, G, W, acc=acc)
    update.launches += 1
    return out


def _plain_update(V, G, W, acc):
    P = dot(V, G.to(V.dtype), acc)
    return P if W is None else W - P.to(W.dtype)


# CUDA kernel launches (csrc/skinny.cu): a run can show it went through them
gram.launches = 0
update.launches = 0
