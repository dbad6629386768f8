"""User-facing solver entry — the reference's `RBL(A, k, b)` / `RBL_gpu`
surface (RBL.jl:119-142, RBL_gpu.jl:205-221), as one device-agnostic
function: the same code runs on the CPU, on one CUDA device, or row-sharded
over the ranks of ``cfg.mesh`` (``parallel/mesh.py``), wherever the
operator lives.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..config import RBLConfig, matmul_precision
from ..ops.spmm.operator import as_operator
from ..parallel.dist_spmm import on_mesh
from ..parallel.memory import clamp_kryl_dim
from ..parallel.mesh import local_rows, mesh_size
from .basis import BasisStore
from .lanczos import (
    LanczosResult,
    _rayleigh_refine,
    lanczos_iteration,
    random_start_block,
    recover_eigvec,
)


def rbl(
    A: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    compute_eigenvectors: bool = True,
    which: str = "LM",
    timer=None,
    v0=None,
    deflate=None,
    norm_bound: Optional[float] = None,
) -> LanczosResult:
    """Compute k eigenpairs of the symmetric operator A with randomized
    block Lanczos.

    Parameters mirror the reference's ``RBL(A, k, b) -> (D, V)``
    (RBL.jl:119-142): A may be a LinearOperator, a dense/diagonal tensor or
    array, or a scipy sparse matrix (built on ``cfg.device``); k is the
    number of eigenpairs; b the block size.

    which selects the spectrum end:
      "LM" (default) — largest magnitude; eigenvalues descending by |λ|.
      "LA" — largest algebraic, descending; solved as LM of A + sI.
      "SA" — smallest algebraic, ascending; solved as LM of sI − A.
    For LA/SA the shift s ≥ ‖A‖₂ comes from a power-method bound (or
    ``norm_bound``, which must be a TRUE upper bound on ‖A‖₂).

    v0 optionally seeds the first column of the random sampling block Ω.

    deflate optionally supplies an (n, j) block of known eigenvectors (or
    any directions) to exclude: the sweep deflates every newborn residual
    against their orthonormalized span, so the returned k pairs are the
    dominant ones of the complement.

    Returns a LanczosResult with (optionally) the matching Ritz vectors, on
    the operator's device.

    Under ``cfg.mesh`` every rank calls ``rbl`` with its part of a sharded
    operator (``parallel.dist_spmm``), or with the whole of any other
    operator, which is then applied replicated; ``v0`` and ``deflate``
    are global, and the eigenvectors come back as the rank's rows.
    """
    cfg = cfg or RBLConfig()
    if b is not None:
        cfg = cfg.replace(block_size=b)
    op = on_mesh(as_operator(A, dtype=cfg.compute_dtype, device=cfg.device),
                 cfg.mesh)
    n = op.n
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    which = which.upper()
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which={which!r} not in ('LM', 'LA', 'SA')")

    with matmul_precision(cfg.matmul_precision):
        shift = 0.0
        if which != "LM":
            from ..ops.eig import spectral_norm_bound
            from ..ops.spmm.operator import AffineOperator

            if norm_bound is not None:
                shift = float(norm_bound)
            else:
                gen = torch.Generator(device=op.device)
                gen.manual_seed(cfg.seed + 1)
                shift = spectral_norm_bound(op, gen, mesh=cfg.mesh)
            op = AffineOperator.shift(
                op, 1.0 if which == "LA" else -1.0, shift
            )
        res = _rbl_impl(op, k, cfg, compute_eigenvectors, timer, v0=v0,
                        deflate=deflate)
    if which == "LA":
        res.eigenvalues = res.eigenvalues - shift
    elif which == "SA":
        # θ descending ↦ λ = s − θ ascending (natural SA order); the
        # vectors and residual norms are shift-invariant
        res.eigenvalues = shift - res.eigenvalues
    return res


def _rbl_impl(op, k, cfg, compute_eigenvectors, timer, v0=None, deflate=None):
    b = cfg.block_size
    n = op.n
    dev = op.device
    mesh = cfg.mesh
    rows = local_rows(n, mesh)  # this rank's rows of every n-sized block
    if v0 is not None:
        v0 = torch.as_tensor(v0).reshape(-1)
        if v0.shape[0] != n:
            raise ValueError(f"v0 has length {v0.shape[0]}, expected {n}")
    lock = None
    if deflate is not None:
        lock = np.asarray(torch.as_tensor(deflate).cpu(), dtype=np.float64)
        if lock.ndim == 1:
            lock = lock[:, None]
        if lock.ndim != 2 or lock.shape[0] != n:
            raise ValueError(
                f"deflate must be (n, j) with n={n}, got {lock.shape}"
            )
        # Orthonormalize the user-supplied span once via SVD and keep only
        # the NUMERICAL-RANK columns: plain QR of a rank-deficient span
        # fills the dead columns with arbitrary orthonormal directions,
        # silently deflating eigenvectors the user never asked to exclude.
        u, sv, _ = np.linalg.svd(lock, full_matrices=False)
        tol = (sv[0] if sv.size else 0.0) * max(lock.shape) * np.finfo(np.float64).eps
        r = int(np.sum(sv > tol))
        if mesh is not None:
            u = u[slice(*mesh.row_range(n))]
        lock = (torch.as_tensor(u[:, :r], device=dev).to(cfg.basis_dtype)
                if r else None)
    max_kryl = clamp_kryl_dim(
        cfg.max_kryl_dim, n, b, cfg.basis_dtype, cfg.compute_dtype,
        budget_fraction=cfg.hbm_budget_fraction, device=dev,
        n_devices=mesh_size(mesh),
    )  # the same clamp under basis_device_cap_cols, as in the JAX package
    if mesh is not None:
        # free memory differs between ranks (ranks may share a card): the
        # cap every rank sweeps to is the smallest
        max_kryl = int(mesh.all_reduce_min(
            torch.tensor([max_kryl], dtype=torch.int64, device=mesh.device)))
    if max_kryl < k:
        # The final Rayleigh–Ritz can produce at most max_kryl pairs;
        # proceeding would silently return fewer than k eigenpairs.
        raise ValueError(
            f"k={k} exceeds the Krylov cap {max_kryl} "
            f"({'memory-clamped from ' + str(cfg.max_kryl_dim) if max_kryl < cfg.max_kryl_dim else 'cfg.max_kryl_dim'}) — "
            "raise max_kryl_dim or shrink the problem"
        )
    cfg = cfg.replace(max_kryl_dim=max_kryl)

    # one generator draws the start block and every breakdown repair
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    Qi = random_start_block(op, gen, b, cfg, v0=v0)
    if lock is not None:
        # the start block must begin clean of the deflated span
        from ..ops.qr import block_qr
        from ..ops.reorth import deflate as _deflate

        Qi = _deflate(lock, Qi.to(cfg.compute_dtype), mesh)
        Qi, _ = block_qr(Qi, method=cfg.resolved_qr_method(), mesh=mesh,
                         n=op.n)
        Qi = Qi.to(cfg.basis_dtype)
    store = BasisStore(
        rows, b, max_cols=max_kryl + b, dtype=cfg.basis_dtype, device=dev,
        device_cap_cols=cfg.basis_device_cap_cols,
    )

    # Mid-sweep fault tolerance (SURVEY §5: the reference has none): an
    # existing checkpoint at sweep_checkpoint_path means a previous solve
    # was interrupted — resume it instead of restarting.  The file is
    # deleted once THIS solve completes, so a finished solve never leaks
    # stale state into the next call.
    resume = None
    ck_path = cfg.sweep_checkpoint_path
    if ck_path is not None:
        from ..utils.checkpoint import file_exists, load_sweep_state

        if file_exists(ck_path, mesh):
            resume = load_sweep_state(ck_path)

    w_sel, V_sel, T, bounds, converged, nblocks = lanczos_iteration(
        op, k, cfg, Qi, store, lock_basis=lock, timer=timer, generator=gen,
        resume=resume,
    )
    if ck_path is not None:
        from ..utils.checkpoint import remove_file

        remove_file(ck_path, mesh)
    if timer is not None and store.device_cap_cols is not None:
        timer.add("basis_host_panels", store.panels_written)
        timer.add("basis_d2h_bytes", store.d2h_bytes)

    # ascending-|λ| → descending, as the reference returns
    # (D[end:-1:1], V[:,end:-1:1] — RBL.jl:116)
    D = np.asarray(w_sel)[::-1].copy()
    bounds_desc = bounds[::-1].copy() if bounds is not None else None
    V = None
    if compute_eigenvectors:
        Vk = np.asarray(V_sel)[:, ::-1]
        V = recover_eigvec(store, Vk)
        # Shifted Rayleigh-quotient refinement: the refined θ carries
        # O(eps·|θ|) rounding instead of the O(n·eps·‖A‖) accumulated in T.
        # The TRUE residual norms it computes along the way replace the
        # Lanczos bounds in the result.
        D_t, res_t = _rayleigh_refine(
            op, V, torch.as_tensor(D), cdt=cfg.compute_dtype, width=b,
            mesh=mesh,
        )
        D = D_t.cpu().numpy()
        bounds_desc = res_t.cpu().numpy()
        if converged and np.max(bounds_desc) > 10 * cfg.tol:
            # the Lanczos bound ‖B·y‖ assumes an orthonormal basis; if the
            # TRUE residuals contradict it, the basis degraded and the
            # convergence claim is not trustworthy
            converged = False
    if timer is not None and store.device_cap_cols is not None:
        # after the recovery, which streams the panels once more
        timer.add("basis_h2d_bytes", store.h2d_bytes)

    return LanczosResult(
        eigenvalues=D,
        eigenvectors=V,
        iterations=nblocks,
        kryl_dim=store.ncols,
        converged=converged,
        residual_bounds=bounds_desc,
    )


# Reference-shaped alias: RBL(A, k, b) -> (D, V)
def RBL(A, k: int, b: int, cfg: Optional[RBLConfig] = None):
    res = rbl(A, k, b, cfg=cfg)
    return res.eigenvalues, res.eigenvectors


def RBL_gpu(A, k: int, b: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (RBL_gpu.jl:205): the reference forks CPU and
    GPU solvers; here one device-agnostic core serves both, so this is
    `RBL` under the reference's GPU entry name (placement from cfg)."""
    return RBL(A, k, b, cfg=cfg)
