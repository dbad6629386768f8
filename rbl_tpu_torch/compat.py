"""scipy.sparse.linalg-compatible shims: ``eigsh`` and ``svds`` (port of
``rbl_tpu/compat.py``).

The reference validates itself against ARPACK through this exact surface —
``eigs(A, nev=100, tol=1e-7, which=:LM)`` at benchmark.jl:42 and
``svds(B, nsv=k)`` at images.jl:37-42.  A user migrating from the reference
(or from scipy/ARPACK directly) can keep their call sites: these wrappers
accept the scipy signatures and keep scipy's contract — numpy in, numpy
out (the device→host copy of the eigenvectors is part of the call), in
scipy's sort orders (eigenvalues ascending algebraic for ``eigsh``,
singular values ascending for ``svds``), with ``ArpackNoConvergence``
carrying the partial results — delegating to randomized block Lanczos.
Neither takes a ``device=``: ``cfg.device`` places the solve, as in every
other entry point (None: the CUDA card, which must exist;
``RBLConfig(device="cpu")`` for the CPU).

Differences from ARPACK, stated rather than hidden:

- The algorithm is *randomized block* Lanczos: ``v0`` seeds only the first
  column of the n×b sampling block Ω (the rest stay drawn from a
  ``torch.Generator`` seeded by ``cfg.seed``), and ``ncv`` maps onto the
  Krylov-dimension cap.
- ``maxiter`` (ARPACK's implicit-restart count) routes the solve through
  the explicitly restarted solver (``rbl_restarted``) with
  ``max_restarts = maxiter`` and per-cycle sweep length ``ncv``;
  non-convergence raises scipy's own ``ArpackNoConvergence`` carrying the
  partial results.  This holds on every path, including shift-invert
  (``sigma``/``which="SM"``, where the restarted sweep runs on the
  transformed operator and the inner MINRES keeps its own iteration cap)
  and generalized pencils.
- ``tol`` is the Ritz-pair residual-bound tolerance ‖A·x − θx‖ (the
  reference's absolute semantics, RBL.jl:109); scipy's ``tol=0``
  ("machine precision") maps to the solver default 1e-7 — the exact
  tolerance the reference uses for its own ARPACK comparison.  On the
  standard shift-invert paths the bound is rescaled by a ‖OP‖ estimate
  so it matches ARPACK's |θ|-relative convergence in OP space (an
  unscaled absolute bound on OP, whose norm is 1/dist(σ, spec A), would
  demand orders more accuracy than scipy does).
- Shift-invert (``sigma``) is supported in ``mode="normal"``: OP =
  (A − σI)⁻¹ applied by blocked MINRES (``ops.minres``), never factoring
  A.  ``which="SM"`` (no sigma) is the σ = 0 special case and requires A
  nonsingular.  For a host sparse operand and a shift near the bottom of
  the spectrum, a smoothed-aggregation AMG preconditions the inner solve
  (``_auto_inner_psolve``).
- Generalized problems (SPD ``M``) are supported without factorizing M
  (``rbl_generalized``): eigenvalues are true-pencil Rayleigh quotients and
  eigenvectors are M-orthonormal (ARPACK's convention).  With ``sigma``
  this becomes factorization-free mode-3 shift-invert, ``which`` selecting
  in ν = 1/(λ−σ) space exactly as ARPACK documents; buckling (mode 4) and
  Cayley (mode 5) are supported the same way.  ``which="SM"``-*with*-sigma
  (eigenvalues farthest from σ) is not implemented.
- The JAX package forces ``matmul_precision="highest"`` for the
  shift-invert and pencil paths on an accelerator, where its "high" tier
  loses digits in their inner recurrences.  The port has no such branch:
  its "high" is already full FP32 (``config.matmul_precision``).

Under ``cfg.mesh`` (a ``parallel.mesh.RowMesh``) every rank calls
``eigsh``/``svds`` with the same arguments; a matrix, or an operator that
is not sharded, is applied replicated (``parallel.dist_spmm.on_mesh``), as
the JAX package applies a scipy matrix under its mesh.  Every rank gets
the WHOLE numpy arrays back, scipy's contract and the JAX package's
single-controller result: the rank's rows of each vector block are
all-gathered on the mesh's device, then copied to the host.  That costs
one all-gather and a host copy of the whole block on every rank:
k = 100 vectors of fem_elasticity_3d(47) (n = 324,864) in f32 are 130 MB
on each rank's host (260 MB in f64).  A partial result that
``ArpackNoConvergence`` carries is gathered on every rank before the
raise, after the ranks agree that it is raised.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .config import RBLConfig


def _host(x) -> np.ndarray:
    """A result array as numpy on the host (tensors are copied back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _whole(V, mesh, n: Optional[int]) -> np.ndarray:
    """A vector block as numpy on the host; under ``mesh`` V holds the
    rank's rows of n, and every rank gets the whole (one all-gather).
    Every rank must call this: it is a collective."""
    if mesh is not None:
        V = mesh.gather_rows(V, n)
    return _host(V)


def _on_all_ranks(flag: bool, mesh) -> bool:
    """``flag`` as every rank of ``mesh`` sees it: True only if it is
    True on every rank, so that the ranks take a branch that holds a
    collective together."""
    return bool(flag) if mesh is None else mesh.agree(bool(flag))


def _scipy_eig_order(
    w: np.ndarray, which: str, return_eigenvectors: bool
) -> np.ndarray:
    """scipy.sparse.linalg.eigsh's documented sort order: ascending
    algebraic when eigenvectors are returned (and always for LA/BE);
    without eigenvectors LM/SA sort by ascending |λ| and SM by
    DESCENDING |λ|."""
    if return_eigenvectors or which in ("LA", "BE"):
        return np.argsort(w, kind="stable")
    if which == "SM":
        return np.argsort(-np.abs(w), kind="stable")
    return np.argsort(np.abs(w), kind="stable")  # LM, SA


def _operand_n(A) -> Optional[int]:
    """Problem size of a matrix-or-operator operand, if discoverable."""
    n = getattr(A, "shape", (None,))[0]
    return n if n is not None else getattr(A, "n", None)


def _no_convergence(msg: str, w, V, n, mesh=None):
    """scipy's ArpackNoConvergence carrying the partial results on the
    host (an empty (n, 0) block when there are no vectors); under
    ``mesh`` the whole vectors, gathered on every rank."""
    from scipy.sparse.linalg import ArpackNoConvergence

    V = _whole(V, mesh, n) if V is not None else np.zeros((n or 0, 0))
    return ArpackNoConvergence(msg, np.asarray(w, dtype=np.float64), V)


def _cfg_with_tol_ncv(cfg, tol, ncv, k):
    """The shared eigsh cfg plumbing: tol → cfg.tol, ncv → Krylov cap;
    under a mesh the solve runs on the mesh's device unless cfg.device
    says otherwise."""
    cfg = cfg or RBLConfig()
    if cfg.mesh is not None and cfg.device is None:
        cfg = cfg.replace(device=str(cfg.mesh.device))
    if tol and tol > 0:
        cfg = cfg.replace(tol=float(tol))
    if ncv is not None:
        if ncv <= k:
            raise ValueError(f"ncv={ncv} must exceed k={k}")
        cfg = cfg.replace(max_kryl_dim=int(ncv))
    return cfg


def _be_split(A, k, cfg, return_eigenvectors, solve_half, strict=False):
    """ARPACK's BE convention: ⌈k/2⌉ pairs from the high end, ⌊k/2⌋ from
    the low — two independent half-solves via ``solve_half(kk, end,
    cfg_be)``, concatenated and sorted ascending.

    k is validated against the FULL problem size up front (each half only
    checks its own kk ≤ n, so k > n would otherwise silently return k
    values with duplicates across the two ends), and the half-solves get
    the mid-sweep checkpoint knobs stripped (two different sweeps must
    not share one checkpoint file — a crash in the second would make a
    rerun's FIRST half resume the second's state)."""
    n = _operand_n(A)
    if n is not None and not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    cfg_be = cfg.replace(sweep_checkpoint_path=None,
                         fault_inject_abort_after_chunks=None)
    k_hi, k_lo = (k + 1) // 2, k // 2
    parts = [
        solve_half(kk, end, cfg_be)
        for kk, end in ((k_hi, "LA"), (k_lo, "SA"))
        if kk > 0
    ]
    w = np.concatenate(
        [np.asarray(r.eigenvalues, dtype=np.float64) for r in parts]
    )

    def vectors():
        if any(r.eigenvectors is None for r in parts):
            return None
        return np.concatenate([_whole(r.eigenvectors, cfg.mesh, n)
                               for r in parts], axis=1)

    if strict and not _on_all_ranks(all(r.converged for r in parts),
                                    cfg.mesh):
        # the maxiter/restarted path mirrors the non-BE contract: a
        # half-solve that ran out of restarts must raise, not return a
        # silently short or inaccurate spectrum (the plain paths stay
        # best-effort, like their non-BE counterparts)
        raise _no_convergence(
            f"BE half-solves did not converge ({len(w)}/{k} pairs)", w,
            vectors(), n)
    order = np.argsort(w, kind="stable")
    if not return_eigenvectors:
        return w[order]
    return w[order], vectors()[:, order]


def _auto_inner_psolve(A, sigma: float, dtype, device):
    """Auto-build a smoothed-aggregation AMG inner preconditioner
    (ops/amg.py) at ``dtype`` on ``device`` when the operand arrives as a
    HOST sparse matrix (the assembled-FEM class), the shift sits near the
    bottom of the spectrum (the cycle approximates A⁻¹), and the problem
    is big enough to amortize the one-time setup.  Returns None otherwise
    — callers fall through to the Jacobi default.

    The H100 computes f64 natively, so the hierarchy is built at the
    dtype of the inner solve (the JAX package builds it at f32 on a TPU).
    Only what the host-side aggregation raises for a matrix of unusual
    structure (a singular block or coarse matrix, a pattern that does not
    fit the detected node blocks: ``ValueError``, numpy's
    ``LinAlgError``, ``IndexError``) keeps the Jacobi tier; an error on
    the device (a CUDA error, a kernel that does not build) propagates."""
    import scipy.sparse as sp

    if not sp.issparse(A):
        return None
    n = A.shape[0]
    if n < 4000:
        return None  # setup not worth it; Jacobi handles small systems
    d = np.abs(np.asarray(A.diagonal()).ravel())
    if d.size == 0 or d.max() <= 0:
        return None
    if abs(sigma) > 0.25 * d.max():
        return None  # interior shift: A⁻¹ is the wrong preconditioner
    from .ops.amg import AssembledMultigrid

    try:
        return AssembledMultigrid.smoothed_aggregation(
            A, dtype=dtype, device=device
        ).psolve
    except (np.linalg.LinAlgError, ValueError, IndexError):
        return None  # unusual structure: keep the Jacobi tier


def _op_norm_scale(si, op, sigma: float, mesh=None) -> float:
    """‖OP‖ = ‖(A − σI)⁻¹‖ estimate for the θ-space tolerance rescale:
    exact (1/min-gap) for FDM-supported operators, else a short power
    estimate on OP itself (a handful of inner solves) from a generator
    seeded 17 on the operator's device.  Under ``mesh`` OP takes the
    rank's rows: every rank draws the whole start vector and keeps its
    rows, so the ranks, and one rank against the unsharded solve, get
    the same scale."""
    from .ops.fdm import fdm_min_shift_gap

    gap = fdm_min_shift_gap(op, sigma)
    if gap is not None and gap > 0:
        return 1.0 / gap
    from .ops.eig import spectral_norm_bound

    gen = torch.Generator(device=si.device)
    gen.manual_seed(17)
    # margin 1.0: an OVER-estimate of ‖OP‖ would loosen the tolerance;
    # the power under-estimate errs strict, like ARPACK's per-pair |θᵢ|
    return max(spectral_norm_bound(si, gen, iters=10, margin=1.0, mesh=mesh),
               1e-30)


def _rayleigh_from_op(op, res, sigma: float, mesh=None):
    """(λ, X) for a shift-invert solve, on the host: λ from the Rayleigh
    quotient with the ORIGINAL A — more accurate than σ + 1/θ, which
    inherits the inner MINRES error in θ.  A is applied on the device; the
    quotients are formed in f64 on the host.  Zero columns (defensive)
    fall back to σ + 1/θ.  Under ``mesh`` ``op`` and the eigenvectors
    hold the rank's rows: X and A·X are gathered whole on every rank
    first, so the quotients are the unsharded solve's arithmetic."""
    theta = np.asarray(res.eigenvalues, dtype=np.float64)
    Xd = res.eigenvectors
    n = op.n
    X = _whole(Xd, mesh, n)
    if X.shape[1] == 0:
        return theta[:0], X
    AX = _whole(op.apply(Xd.to(op.dtype)), mesh, n).astype(np.float64)
    X64 = X.astype(np.float64)
    num = np.einsum("ij,ij->j", X64, AX)
    den = np.einsum("ij,ij->j", X64, X64)
    w = np.where(den > 0, num / np.where(den > 0, den, 1.0),
                 sigma + 1.0 / theta)
    return w, X


def _default_block(k: int) -> int:
    # the reference benchmarks b ∈ {1,2,4,8} at k=100 (benchmark.jl:29-36)
    # and larger blocks amortize per-chunk dispatch cost; 8 for k ≳ 16
    return 8 if k >= 16 else max(4, min(8, k))


def eigsh(
    A: Any,
    k: int = 6,
    M: Any = None,
    sigma: Optional[float] = None,
    which: str = "LM",
    v0: Optional[np.ndarray] = None,
    ncv: Optional[int] = None,
    maxiter: Optional[int] = None,
    tol: float = 0,
    return_eigenvectors: bool = True,
    mode: str = "normal",
    cfg: Optional[RBLConfig] = None,
    b: Optional[int] = None,
    inner_psolve=None,
):
    """Drop-in ``scipy.sparse.linalg.eigsh`` replacement backed by ``rbl``.

    Returns numpy ``(w, v)`` with ``w`` in ascending algebraic order — or
    just ``w`` when ``return_eigenvectors=False``, in which case scipy's
    which-dependent sort order applies (LM/SA by ascending ``|λ|``, SM by
    descending ``|λ|``, LA/BE algebraic).
    Supported ``which``: "LM", "LA", "SA", "BE" (BE = ⌈k/2⌉ from the top
    of the spectrum + ⌊k/2⌋ from the bottom, ARPACK's split, as two
    shifted solves), "SM" (σ = 0 shift-invert; A must be nonsingular),
    and "LM"/"LA"/"SA" with ``sigma`` (eigenvalues nearest / just above /
    just below σ, via the blocked-MINRES shift-invert transform).  See the
    module docstring for the ARPACK-semantics differences.  ``cfg.device``
    places the solve.

    ``inner_psolve``: explicit SPD preconditioner for the inner MINRES
    solves on the shift-invert paths (the analogue of handing scipy an
    ``OPinv``) — e.g. ``ops.amg.AssembledMultigrid.from_grid(...).psolve``
    for grid-structured FEM matrices.  When omitted and the operand is a
    host sparse matrix, a smoothed-aggregation AMG preconditioner is
    auto-built for near-bottom shifts (``_auto_inner_psolve``).
    """
    from .solver.rbl import rbl

    which = which.upper()
    user_which = which  # the sort rules key on what the USER asked for
    if M is not None:
        if mode not in ("normal", "buckling", "cayley"):
            raise NotImplementedError(
                f"mode={mode!r} not supported with M "
                "(normal/buckling/cayley are)"
            )
        if mode != "normal" and sigma is None:
            raise ValueError(f"mode={mode!r} requires sigma")
        if sigma is None and which == "SM":
            # smallest-magnitude pencil eigenvalues = nearest zero: the
            # σ = 0 generalized shift-invert problem (requires A
            # nonsingular, same as the standard-form SM path)
            sigma, which = 0.0, "LM"
        if sigma is not None:
            if which not in ("LM", "LA", "SA"):
                raise NotImplementedError(
                    f"which={which!r} with M and sigma not supported "
                    "(LM/LA/SA are)"
                )
        elif which not in ("LM", "LA", "SA", "BE"):
            raise NotImplementedError(
                f"which={which!r} with M not supported (LM/LA/SA/BE/SM are)"
            )
        return _eigsh_generalized(
            A, k, M, which=which, user_which=user_which, sigma=sigma,
            mode=mode, v0=v0, ncv=ncv, tol=tol, maxiter=maxiter,
            return_eigenvectors=return_eigenvectors, cfg=cfg, b=b,
            inner_psolve=inner_psolve,
        )
    if sigma is None and which == "SM":
        # smallest-magnitude = eigenvalues nearest zero: the σ = 0
        # shift-invert problem (scipy's ARPACK solves SM directly and is
        # notoriously slow at it; shift-invert is its own recommended
        # alternative)
        sigma, which = 0.0, "LM"
    if sigma is not None:
        if mode != "normal":
            raise NotImplementedError(
                f"mode={mode!r} not supported (only 'normal' shift-invert)"
            )
        if which not in ("LM", "LA", "SA"):
            raise NotImplementedError(
                f"which={which!r} with sigma not supported (LM/LA/SA are)"
            )
    elif which not in ("LM", "LA", "SA", "BE"):
        raise NotImplementedError(
            f"which={which!r} not supported (LM/LA/SA/BE/SM are)"
        )
    cfg = _cfg_with_tol_ncv(cfg, tol, ncv, k)
    bsz = b or _default_block(k)
    mesh, n = cfg.mesh, _operand_n(A)

    if maxiter is not None and sigma is None:
        # ARPACK's maxiter bounds the number of implicit restarts; the
        # faithful analogue here is the explicitly restarted solver with
        # max_restarts = maxiter (restart sweep length = ncv, ARPACK's
        # Lanczos-vector count per cycle).  Non-convergence raises scipy's
        # own ArpackNoConvergence carrying the partial results, exactly as
        # scipy documents.
        from .solver.restarted import rbl_restarted

        if ncv is not None:
            cfg = cfg.replace(restart_kryl_dim=int(ncv))
        if which == "BE":
            return _be_split(
                A, k, cfg, return_eigenvectors,
                lambda kk, end, cfg_be: rbl_restarted(
                    A, kk, cfg=cfg_be, b=b or _default_block(kk),
                    max_restarts=int(maxiter), which=end, v0=v0,
                ),
                strict=True,
            )
        res = rbl_restarted(
            A, k, cfg=cfg, b=bsz, max_restarts=int(maxiter),
            which=which, v0=v0,
        )
        w = np.asarray(res.eigenvalues, dtype=np.float64)
        if not _on_all_ranks(res.converged, mesh):
            raise _no_convergence(
                f"No convergence within {maxiter} restarts "
                f"({len(w)}/{k} eigenpairs locked)", w, res.eigenvectors,
                n, mesh,
            )
        order = _scipy_eig_order(w, user_which, return_eigenvectors)
        if not return_eigenvectors:
            return w[order]
        return w[order], _whole(res.eigenvectors, mesh, n)[:, order]

    if sigma is not None:
        from .ops.minres import ShiftInvertOperator, default_inner_tol
        from .ops.spmm.operator import as_operator
        from .parallel.dist_spmm import on_mesh

        op = as_operator(A, device=cfg.device)
        # Inner-solve error perturbs OP in a way the outer residual bounds
        # cannot see, so the inner target sits well below the outer tol
        # (floored by what THIS dtype's MINRES can honestly reach).
        inner_tol = default_inner_tol(op.dtype, cfg.tol)
        if inner_psolve is None:
            inner_psolve = _auto_inner_psolve(A, float(sigma), op.dtype,
                                              op.device)
        # under a mesh MINRES runs on the rank's rows; an inner psolve
        # that takes whole blocks is applied replicated (ops/minres.py
        # ``mesh_psolve``)
        opm = on_mesh(op, mesh)
        si = ShiftInvertOperator.shift(
            opm, float(sigma), inner_tol=inner_tol, psolve=inner_psolve
        )
        # ARPACK's convergence under shift-invert is RELATIVE to |θ| in
        # OP space (scipy tol semantics); our solver's bound is absolute
        # in θ space, and ‖OP‖ = 1/dist(σ, spec A) can be huge — without
        # rescaling, eigsh(sigma=...) demands |θ|·tol-times more than
        # scipy and over-solves by orders of magnitude.
        cfg = cfg.replace(
            tol=cfg.tol * _op_norm_scale(si, op, float(sigma), mesh))
        if maxiter is not None:
            # ARPACK's maxiter bounds implicit restarts in shift-invert
            # mode too: run the explicitly restarted solver ON the
            # transformed operator (which selects in θ = 1/(λ−σ) space,
            # exactly as the plain path below), raising scipy's
            # ArpackNoConvergence on exhaustion.
            from .solver.restarted import rbl_restarted

            if ncv is not None:
                cfg = cfg.replace(restart_kryl_dim=int(ncv))
            res = rbl_restarted(
                si, k, cfg=cfg, b=bsz, max_restarts=int(maxiter),
                which=which, v0=v0,
            )
            if not _on_all_ranks(res.converged, mesh):
                w_p, X_p = _rayleigh_from_op(opm, res, float(sigma), mesh)
                raise _no_convergence(
                    f"No convergence within {maxiter} restarts "
                    f"({len(w_p)}/{k} eigenpairs locked)", w_p, X_p, op.n,
                )
        else:
            res = rbl(
                si, k, b=bsz, cfg=cfg, which=which,
                compute_eigenvectors=True, v0=v0,
            )
        w, X = _rayleigh_from_op(opm, res, float(sigma), mesh)
        order = _scipy_eig_order(w, user_which, return_eigenvectors)
        if not return_eigenvectors:
            return w[order]
        return w[order], X[:, order]

    if which == "BE":
        # each end is an LM problem of the correspondingly shifted
        # operator — see rbl(which="LA"/"SA") and _be_split; an explicit
        # user block size is honored, only the DEFAULT shrinks to the
        # half-solve's smaller k
        return _be_split(
            A, k, cfg, return_eigenvectors,
            lambda kk, end, cfg_be: rbl(
                A, kk, b=b or _default_block(kk), cfg=cfg_be, which=end,
                compute_eigenvectors=return_eigenvectors, v0=v0,
            ),
        )

    res = rbl(
        A, k, b=bsz, cfg=cfg, which=which,
        compute_eigenvectors=return_eigenvectors, v0=v0,
    )
    w = np.asarray(res.eigenvalues, dtype=np.float64)
    order = _scipy_eig_order(w, user_which, return_eigenvectors)
    if not return_eigenvectors:
        return w[order]
    return w[order], _whole(res.eigenvectors, mesh, n)[:, order]


def _eigsh_generalized(
    A, k, M, *, which, user_which, sigma, mode, v0, ncv, tol, maxiter,
    return_eigenvectors, cfg, b, inner_psolve=None
):
    """The M-branch of ``eigsh``: A·x = λ·M·x with SPD M, solved by
    ``rbl_generalized`` (Chebyshev-M^{−1/2} pencil transform — see
    solver/generalized.py; where ARPACK factorizes M, this streams SpMMs).
    With ``sigma``, mode-3 generalized shift-invert (the symmetric
    W = M^{1/2}·(A−σM)^{−1}·M^{1/2} with a blocked-MINRES inner solve) —
    ``which`` selects in ν = 1/(λ−σ) space, ARPACK's convention.
    ``maxiter`` routes the transformed sweep through the restarted solver
    (max_restarts = maxiter) and raises ``ArpackNoConvergence`` on
    exhaustion, exactly like the standard-problem paths.
    Returned eigenvectors are M-orthonormal, matching ARPACK."""
    from .solver.generalized import rbl_generalized

    cfg = _cfg_with_tol_ncv(cfg, tol, ncv, k)
    if maxiter is not None and ncv is not None:
        cfg = cfg.replace(restart_kryl_dim=int(ncv))
    mr = None if maxiter is None else int(maxiter)
    mesh, n = cfg.mesh, _operand_n(A)

    def _raise_if_exhausted(res):
        if mr is not None and not _on_all_ranks(res.converged, mesh):
            raise _no_convergence(
                f"No convergence within {maxiter} restarts "
                f"({len(res.eigenvalues)}/{k} eigenpairs locked)",
                res.eigenvalues, res.eigenvectors, n, mesh,
            )
        return res

    def _finish(res, sort_which):
        w = np.asarray(res.eigenvalues, dtype=np.float64)
        order = _scipy_eig_order(w, sort_which, return_eigenvectors)
        if not return_eigenvectors:
            return w[order]
        return w[order], _whole(res.eigenvectors, mesh, n)[:, order]

    if sigma is not None:
        if inner_psolve is None and mode == "normal":
            # the AMG tier approximates A⁻¹ ≈ (A − σM)⁻¹ at small σ
            # (buckling/cayley keep the Jacobi default: their B = A
            # inner product changes what "small shift" means)
            from .config import resolve_device

            inner_psolve = _auto_inner_psolve(
                A, float(sigma), cfg.compute_dtype, resolve_device(cfg.device))
        res = _raise_if_exhausted(rbl_generalized(
            A, M, k, b=b or _default_block(k), cfg=cfg, which=which,
            sigma=float(sigma), mode=mode, max_restarts=mr,
            compute_eigenvectors=return_eigenvectors, v0=v0,
            inner_psolve=inner_psolve,
        ))
        return _finish(res, user_which)

    if which == "BE":
        return _be_split(
            A, k, cfg, return_eigenvectors,
            lambda kk, end, cfg_be: rbl_generalized(
                A, M, kk, b=b or _default_block(kk), cfg=cfg_be, which=end,
                max_restarts=mr,
                compute_eigenvectors=return_eigenvectors, v0=v0,
            ),
            strict=mr is not None,
        )

    res = _raise_if_exhausted(rbl_generalized(
        A, M, k, b=b or _default_block(k), cfg=cfg, which=which,
        max_restarts=mr,
        compute_eigenvectors=return_eigenvectors, v0=v0,
    ))
    return _finish(res, which)


def svds(
    A: Any,
    k: int = 6,
    ncv: Optional[int] = None,
    tol: float = 0,
    which: str = "LM",
    v0: Optional[np.ndarray] = None,
    maxiter: Optional[int] = None,
    return_singular_vectors: bool = True,
    solver: Optional[str] = None,
    random_state: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    b: Optional[int] = None,
):
    """Drop-in ``scipy.sparse.linalg.svds`` replacement backed by
    ``rbl_svd`` (the reference's images.jl:37-42 comparison surface).

    Returns numpy ``(u, s, vh)`` with ``s`` ASCENDING (scipy's convention;
    note ``rbl_svd`` itself returns descending) — or just ``s`` when
    ``return_singular_vectors=False``.  ``which="LM"`` (largest, the
    truncated-SVD default) and ``which="SM"`` (smallest, via σ = 0
    blocked-MINRES shift-invert on the Gram operator — requires B full
    rank, same as scipy's LOBPCG/ARPACK paths) are supported.
    ``maxiter`` and ``solver`` are accepted for scipy's signature and not
    read; ``random_state`` seeds the solve's generator.  ``cfg.device``
    places the solve.  Under ``cfg.mesh`` ``rbl_svd`` returns the rank's
    rows of both U (m rows) and V (n rows); each is gathered, and every
    rank gets the whole u and vh.
    """
    from .solver.svd import rbl_svd

    which = which.upper()
    if which not in ("LM", "SM"):
        raise NotImplementedError(
            f"which={which!r} not supported (LM/SM are)"
        )
    cfg = _cfg_with_tol_ncv(cfg, tol, ncv, k)
    if random_state is not None:
        # scipy accepts int | Generator | RandomState | None — derive one
        # seed from whichever arrives
        if isinstance(random_state, np.random.Generator):
            seed = int(random_state.integers(0, 2**31 - 1))
        elif isinstance(random_state, np.random.RandomState):
            seed = int(random_state.randint(0, 2**31 - 1))
        else:
            seed = int(random_state)
        cfg = cfg.replace(seed=seed)

    res = rbl_svd(A, k, b=b or _default_block(k), cfg=cfg, v0=v0,
                  which=which)
    order = np.argsort(res.s, kind="stable")  # ascending, scipy-style
    s = np.asarray(res.s)[order]
    if not return_singular_vectors:
        return s
    m, n = A.shape
    U = _whole(res.U, cfg.mesh, m)[:, order]
    Vh = _whole(res.V, cfg.mesh, n)[:, order].T
    return U, s, Vh
