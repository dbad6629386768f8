"""Generalized symmetric eigenproblems A·x = λ·M·x — ``rbl_generalized``
(port of ``rbl_tpu/solver/generalized.py``).

The reference is standard-form only; scipy's ``eigsh`` covers M via ARPACK
modes that factorize M.  Here the pencil is transformed to the
exactly-symmetric standard form S = P·A·P with P ≈ M^{−1/2} as a Chebyshev
series in M (ops/generalized.py) — every apply is block SpMMs, no
factorization — and the unmodified solver core runs on S.

Interior pencil eigenvalues (``sigma``): the symmetric generalized
shift-invert transform W = B^{1/2}·(A − σM)^{−1}·B^{1/2} — ARPACK's
shift-invert modes with the factorization of (A − σM) replaced by blocked
MINRES and B^{±1/2} by Chebyshev series (``GeneralizedShiftInvertOperator``).
All three ARPACK flavors: ``mode="normal"`` (3, B = M), ``"buckling"``
(4, B = A, M may be indefinite), ``"cayley"`` (5, whose operator is
exactly I + 2σ·W_normal).  A diagonal B (a lumped mass) takes the exact
diagonal roots instead of series.

Honesty contract: the series only solves a *nearby* pencil, so the
returned eigenvalues are re-derived as Rayleigh quotients with the TRUE
(A, M) — λ = xᵀAx / xᵀMx — and ``residual_bounds`` are true pencil
residuals ‖A·x − λ·M·x‖ / ‖x‖_M; ``converged`` is demoted when they
contradict the transformed sweep's claim.  Returned eigenvectors are
M-orthonormal (XᵀMX ≈ I, ARPACK's convention for generalized problems),
as a tensor on the operators' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import RBLConfig, matmul_precision
from ..ops.eig import spectral_norm_bound
from ..ops.generalized import (
    ChebyshevSeriesOperator,
    GeneralizedShiftInvertOperator,
    PencilOperator,
)
from ..ops.spmm.operator import (
    AffineOperator,
    DiagonalOperator,
    LinearOperator,
    _pet,
    as_operator,
)
from ..parallel.dist_spmm import ReplicatedOperator, on_mesh
from ..parallel.mesh import all_reduce_sum, col_sumsq
from .lanczos import LanczosResult
from .rbl import rbl


@dataclasses.dataclass(frozen=True)
class PencilInfo:
    """Diagnostics of a generalized solve (returned with return_info=True)."""

    m_bounds: Tuple[float, float]  # certified [λ_min, λ_max](M) domain used
    degree: int                    # Chebyshev degree of P ≈ M^{−1/2}
    approx_err: float              # max relative fit error of P on domain
    # under sigma: the inner (A − σM) solves and their MINRES iterations
    inner_solves: int = 0
    inner_iterations: int = 0


def _norm_bound(op: LinearOperator, seed: int, mesh=None) -> float:
    gen = torch.Generator(device=op.device)
    gen.manual_seed(seed)
    return float(spectral_norm_bound(op, gen, mesh=mesh))


def _certify_m_bounds(opB: LinearOperator, cfg: RBLConfig, label: str = "M"
                      ) -> Tuple[float, float]:
    """Certified-ish spectrum interval of the SPD operator B (M in normal/
    cayley modes, A in buckling mode) from two short extreme-end solves:
    each end is widened by its Ritz residual bound (there is an eigenvalue
    within ‖r‖ of θ — Kato–Temple style), plus a 5% domain margin against
    directions the randomized probe missed.  A lower end that cannot be
    certified positive raises (B must be SPD)."""
    nbM = _norm_bound(opB, cfg.seed + 3, cfg.mesh)
    if not np.isfinite(nbM) or nbM <= 0:
        raise ValueError(f"{label} appears to be zero or non-finite")
    cfg_m = cfg.replace(
        block_size=4,
        max_kryl_dim=min(cfg.max_kryl_dim, 96),
        tol=1e-6 * nbM,
        # internal probe solves must not share the caller's mid-sweep
        # checkpoint file (they would resume each other's state)
        sweep_checkpoint_path=None,
        fault_inject_abort_after_chunks=None,
    )
    ends = {}
    for end in ("SA", "LA"):
        r = rbl(opB, 1, cfg=cfg_m, which=end, compute_eigenvectors=False)
        theta = float(np.asarray(r.eigenvalues)[0])
        rb = float(np.asarray(r.residual_bounds)[0])
        ends[end] = (theta, rb)
    lo = ends["SA"][0] - ends["SA"][1]
    hi = ends["LA"][0] + ends["LA"][1]
    if not (np.isfinite(lo) and np.isfinite(hi)) or lo <= 0:
        raise ValueError(
            f"could not certify {label} positive definite (estimated "
            f"λ_min({label}) − residual = {lo:.3g}) — this mode requires "
            f"SPD {label}; if {label} is known SPD with a tiny λ_min, pass "
            "m_bounds=(λ_min, λ_max)"
        )
    return 0.95 * lo, 1.05 * hi


def _pencil_refine(opA, opM, P, Y, cdt, bnorm="M", mesh=None):
    """x = P·y, then Rayleigh quotients and true residuals against the TRUE
    pencil: λ = xᵀAx/xᵀMx, r = ‖Ax − λMx‖/‖x‖_B, and B-normalized
    eigenvectors X (XᵀBX = I) — B is the mode's inner-product operator: M
    for normal/cayley (ARPACK's M-orthonormal convention), A for buckling
    (where M may be indefinite).  Returns tensors on the operators'
    device.  Under ``mesh`` Y is the rank's rows and the sums over rows
    are reduced over the ranks."""
    X = P.apply(Y.to(cdt))
    AX = opA.apply(X)
    MX = opM.apply(X)
    acc = _pet(cdt)
    num = all_reduce_sum(torch.sum(X.to(acc) * AX.to(acc), dim=0), mesh)
    den = all_reduce_sum(torch.sum(X.to(acc) * MX.to(acc), dim=0), mesh)
    if bnorm == "A":
        # buckling: M may be indefinite — only guard an exact-zero den
        dens = torch.where(den != 0, den, torch.ones_like(den))
        bq = num  # xᵀAx, A SPD in this mode
    else:
        dens = torch.where(den > 0, den, torch.ones_like(den))
        bq = dens
    lam = num / dens
    bqs = torch.where(bq > 0, bq, torch.ones_like(bq))  # degenerate guard
    R = AX.to(acc) - MX.to(acc) * lam[None, :]
    rn = torch.sqrt(col_sumsq(R, mesh)) / torch.sqrt(bqs)
    Xn = X / torch.sqrt(bqs).to(X.dtype)[None, :]
    return lam, rn, Xn


def _sweep_or_restarted(Wop, k, cfg, which, v0, max_restarts,
                        norm_bound=None):
    """The transformed-operator sweep, optionally under a restart budget
    (the ARPACK ``maxiter`` analogue)."""
    if max_restarts is not None:
        from .restarted import rbl_restarted

        return rbl_restarted(
            Wop, k, cfg=cfg, b=cfg.block_size,
            max_restarts=int(max_restarts), which=which, v0=v0,
        )
    return rbl(
        Wop, k, cfg=cfg, which=which, compute_eigenvectors=True, v0=v0,
        norm_bound=norm_bound,
    )


def rbl_generalized(
    A: Any,
    M: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    *,
    which: str = "LA",
    sigma: Optional[float] = None,
    mode: str = "normal",
    inner_tol: Optional[float] = None,
    m_bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    degree: Optional[int] = None,
    approx_tol: Optional[float] = None,
    max_degree: int = 1000,
    compute_eigenvectors: bool = True,
    v0=None,
    return_info: bool = False,
    max_restarts: Optional[int] = None,
    inner_psolve=None,
):
    """k extreme eigenpairs of the symmetric-definite pencil (A, M),
    A·x = λ·M·x with M SPD.

    A and M are LinearOperators, tensors, numpy or scipy matrices (host
    data is built on ``cfg.device``: None means the CUDA card, which must
    exist; pass ``RBLConfig(device="cpu")`` for the CPU).

    which: "LA" (largest algebraic, descending — default), "SA" (smallest
        algebraic, ascending), or "LM" (largest |λ|, descending by |λ|).
    sigma: optional shift — INTERIOR pencil eigenvalues via the symmetric
        generalized shift-invert transform W = M^{1/2}·(A−σM)^{−1}·M^{1/2}
        (ARPACK mode 3 made factorization-free: M^{±1/2} are Chebyshev
        series, the inner inverse is blocked MINRES — one SpMM with A and
        one with M per inner iteration).  With sigma, ``which`` follows
        ARPACK's transformed-eigenvalue convention on ν (for the normal
        mode ν = 1/(λ−σ)): "LM" → the k eigenvalues NEAREST σ (ascending
        distance), "LA" → nearest above σ, "SA" → nearest below σ.
    mode: the ARPACK shift-invert flavor (requires sigma): "normal" (mode
        3, default) — ν = 1/(λ−σ), M SPD, the B = M inner product;
        "buckling" (mode 4) — ν = λ/(λ−σ), A SPD and M merely symmetric,
        B = A, eigenvectors A-orthonormal; "cayley" (mode 5) —
        ν = (λ+σ)/(λ−σ), M SPD, B = M: the operator is exactly
        I + 2σ·W_normal.  ``m_bounds``/``degree``/``approx_tol`` describe
        the B operator (M, or A for buckling).  The series degree grows
        like √κ(B)·log(1/approx_tol).
    inner_tol: relative residual target of the blocked-MINRES inner solves
        under ``sigma`` (default: ``default_inner_tol``).
    max_restarts: when set, the transformed-operator sweep runs through
        ``rbl_restarted`` with this restart budget (sweep length =
        ``cfg.restart_kryl_dim``); ``converged=False`` on exhaustion.
    inner_psolve: explicit SPD preconditioner application for the inner
        (A − σM) MINRES solves under ``sigma`` — e.g. an
        ``AssembledMultigrid.psolve`` built from the assembled stiffness.
        Overrides the default Jacobi.
    m_bounds: optional (λ_min(M), λ_max(M)) overrides (either entry may be
        None); absent ends are certified by short extreme-end solves on M
        widened by their residual bounds.  λ_min must be POSITIVE and
        genuinely below the spectrum.
    degree: explicit Chebyshev degree of P ≈ M^{−1/2} (default: smallest
        degree reaching ``approx_tol``).
    approx_tol: target relative fit error of the series (default
        max(5e-14, min(1e-10, tol/1000)) for f64 compute, 2e-5 below).
    v0: optional seed direction for the sampling block (passed to the
        transformed sweep as-is).

    Returns a LanczosResult: eigenvalues as TRUE-pencil Rayleigh quotients
    (numpy), eigenvectors B-orthonormal (a tensor on the operators'
    device; under ``cfg.mesh`` the rank's rows, with A and M sharded
    operators or applied replicated, and the inner MINRES reduced over
    the ranks), residual_bounds the true ‖A·x − λ·M·x‖/‖x‖_B norms.  With
    return_info=True also returns a PencilInfo(m_bounds, degree,
    approx_err) describing the B-operator series, and under ``sigma`` the
    count of inner solves and their MINRES iterations.
    """
    cfg = cfg or RBLConfig()
    mesh = cfg.mesh
    if b is not None:
        cfg = cfg.replace(block_size=b)
    which = which.upper()
    if which not in ("LA", "SA", "LM"):
        raise ValueError(f"which={which!r} not in ('LA', 'SA', 'LM')")
    mode = mode.lower()
    if mode not in ("normal", "buckling", "cayley"):
        raise ValueError(
            f"mode={mode!r} not in ('normal', 'buckling', 'cayley')"
        )
    if mode != "normal":
        if sigma is None:
            raise ValueError(f"mode={mode!r} requires sigma")
        if float(sigma) == 0.0:
            raise ValueError(
                f"mode={mode!r} requires a nonzero sigma (at σ = 0 its "
                "spectral transform is constant/identity)"
            )
    cdt = cfg.compute_dtype
    if mesh is not None and cfg.device is None:
        cfg = cfg.replace(device=str(mesh.device))
    opA = on_mesh(as_operator(A, dtype=cdt, device=cfg.device), mesh)
    opM = on_mesh(as_operator(
        M, dtype=cdt, device=opA.device if cfg.device is None else cfg.device),
        mesh)
    if opA.shape != opM.shape:
        raise ValueError(
            f"A and M shapes differ: {opA.shape} vs {opM.shape}"
        )
    n = opA.n
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    dev = opA.device
    # B: the mode's SPD inner-product operator, whose ±1/2 powers we take
    opB, blabel = (opA, "A") if mode == "buckling" else (opM, "M")
    if approx_tol is None:
        # the series error shows up in true pencil residuals as a floor of
        # O(aerr·|λ|·λmax(M)) — keep it well under the tol·√λmax(M) the
        # sweep promises (the f64 fit bottoms out near 5e-14)
        if torch.finfo(cdt).bits >= 64:
            approx_tol = float(max(5e-14, min(1e-10, 1e-3 * cfg.tol)))
        else:
            approx_tol = 2e-5

    with matmul_precision(cfg.matmul_precision):
        # --- P ≈ B^{−1/2} (and, under sigma, Psqrt ≈ B^{1/2}) ---
        Psqrt: Optional[LinearOperator] = None
        counts = {}
        diagB = opB.base if isinstance(opB, ReplicatedOperator) else opB
        if isinstance(diagB, DiagonalOperator):
            # exact fast path (lumped/diagonal mass matrices); under a mesh
            # P and its root hold the rank's rows of the whole diagonal
            d = diagB.diag.detach().cpu().numpy().astype(np.float64)
            dmin, dmax = float(d.min()), float(d.max())
            if dmin <= 0:
                raise ValueError(
                    f"{blabel} has a non-positive diagonal entry "
                    f"({dmin:.3g}) — this mode requires SPD {blabel}"
                )
            own = slice(None) if mesh is None else slice(*mesh.row_range(n))
            P: LinearOperator = DiagonalOperator(
                torch.as_tensor(1.0 / np.sqrt(d[own]), dtype=cdt, device=dev)
            )
            if sigma is not None:
                Psqrt = DiagonalOperator(
                    torch.as_tensor(np.sqrt(d[own]), dtype=cdt, device=dev))
            lo, hi, deg, aerr = dmin, dmax, 0, 0.0
        else:
            lo = hi = None
            if m_bounds is not None:
                lo, hi = m_bounds
            if lo is None or hi is None:
                clo, chi = _certify_m_bounds(opB, cfg, label=blabel)
                lo = clo if lo is None else lo
                hi = chi if hi is None else hi
            lo, hi = float(lo), float(hi)
            # aerr: the MEASURED fit error in both paths (the target
            # approx_tol enters the residual floor below, not this field)
            if degree is not None:
                P, aerr = ChebyshevSeriesOperator.inv_sqrt(
                    opB, lo, hi, degree=int(degree), return_err=True
                )
            else:
                P, aerr = ChebyshevSeriesOperator.inv_sqrt(
                    opB, lo, hi, rel_tol=approx_tol,
                    max_degree=max_degree, return_err=True,
                )
            deg = P.degree
            if sigma is not None:
                # √t is smooth on [lo, hi] (no nearby singularity), so this
                # fit's degree is a small fraction of the inverse root's
                Psqrt = ChebyshevSeriesOperator.sqrt(
                    opB, lo, hi, rel_tol=approx_tol, max_degree=max_degree
                )

        if sigma is None:
            # --- standard-form solve on S = P·A·P ---
            S = PencilOperator(A=opA, P=P)
            nb_S = None
            if which in ("LA", "SA"):
                # analytic shift bound ‖S‖ ≤ ‖A‖·‖P‖² ≤ ‖A‖/λmin(M): the
                # power estimate runs on the CHEAP operator A instead of
                # ~24 applies of S (each 2·degree SpMMs with M)
                nb_S = 1.05 * _norm_bound(opA, cfg.seed + 7, mesh) / lo
            res = _sweep_or_restarted(
                S, k, cfg, which, v0, max_restarts, norm_bound=nb_S,
            )
        else:
            # --- interior: W = B^{1/2}·(A − σM)^{−1}·B^{1/2} ---
            # normal (mode 3): B = M;  buckling (mode 4): B = A;
            # cayley (mode 5): I + 2σ·W_normal (same eigenvectors as W).
            # Inner-solve error perturbs W invisibly to the outer residual
            # bounds; target it well below the outer tol, floored at what
            # THIS compute dtype's MINRES can honestly reach
            from ..ops.minres import default_inner_tol

            it = inner_tol if inner_tol is not None \
                else default_inner_tol(cdt, cfg.tol)
            W: LinearOperator = GeneralizedShiftInvertOperator(
                A=opA, M=opM, msqrt=Psqrt,
                sigma=torch.as_tensor(float(sigma), dtype=cdt, device=dev),
                inner_tol=float(it), psolve=inner_psolve, counts=counts,
            )
            if mode == "cayley":
                W = AffineOperator.shift(W, 2.0 * float(sigma), 1.0)
            res = _sweep_or_restarted(W, k, cfg, which, v0, max_restarts)

        # --- recovery + true-pencil validation ---
        # (both branches: x = P·y = B^{−1/2}·y up to series error, then
        # Rayleigh quotients and residuals against the TRUE pencil)
        lam_t, rn_t, X = _pencil_refine(
            opA, opM, P, res.eigenvectors, cdt=cdt,
            bnorm="A" if mode == "buckling" else "M", mesh=mesh,
        )
        lam = lam_t.cpu().numpy().astype(np.float64)
        rn = rn_t.cpu().numpy()
        if sigma is not None:
            # re-sort by the mode's transformed eigenvalue ν(λ) — ARPACK's
            # which-convention (the pole at λ = σ maps "near σ" to "large ν")
            dist = lam - float(sigma)
            safe = np.where(dist != 0.0, dist, 1.0)
            if mode == "normal":
                nu_fin = 1.0 / safe
            elif mode == "buckling":
                nu_fin = lam / safe
            else:  # cayley
                nu_fin = (lam + float(sigma)) / safe
            nu = np.where(dist != 0.0, nu_fin, np.inf)
            if which == "LM":
                order = np.argsort(-np.abs(nu), kind="stable")
            elif which == "LA":
                order = np.argsort(-nu, kind="stable")
            else:  # SA
                order = np.argsort(nu, kind="stable")
        elif which == "SA":
            order = np.argsort(lam, kind="stable")
        elif which == "LA":
            order = np.argsort(-lam, kind="stable")
        else:  # LM
            order = np.argsort(-np.abs(lam), kind="stable")
        lam, rn = lam[order], rn[order]
        X = X[:, torch.as_tensor(order, device=X.device)]
        # the sweep's tol promises ‖S·y − θy‖ ≤ tol; pulled back through
        # x = P·y the pencil residual satisfies ‖Ax − λMx‖ ≤ √λmax(B)·tol
        # PLUS the series-perturbation floor: P² = B̃⁻¹ for ‖B̃ − B‖ ≤
        # 2·err·λmax(B), contributing ≤ 2·err·|λ|·λmax(B)/√λmin(B) per
        # column.  The floor uses the TARGET approx_tol, not the measured
        # fit error: a user-supplied coarse ``degree`` whose error exceeds
        # the target must demote, while the unavoidable floor of a proper
        # fit must not.
        floor = 2.0 * approx_tol * (np.abs(lam) + abs(sigma or 0.0)) \
            * hi / np.sqrt(lo)
        if sigma is None:
            promise = cfg.tol * np.sqrt(hi) + floor
        else:
            # outer tol lives in ν-space: ‖W·y − νy‖ ≤ tol pulls back as
            # ‖Ax − λMx‖ ≤ |λ−σ|·‖A − σM‖·tol·c_mode/√λmin(B), where
            # c_mode comes from dν/dλ at the pole (1 for normal, 1/|σ| for
            # buckling, 1/(2|σ|) for cayley) and ‖A − σM‖ is bounded by
            # power estimates of ‖A‖ and ‖M‖
            nrmA = _norm_bound(opA, cfg.seed + 5, mesh)
            if mode == "buckling":
                # hi bounds λmax(A) here; ‖M‖ needs its own estimate
                nrmM = _norm_bound(opM, cfg.seed + 6, mesh)
                cmode = 1.0 / abs(float(sigma))
            else:
                nrmM = hi
                cmode = 1.0 if mode == "normal" \
                    else 1.0 / (2.0 * abs(float(sigma)))
            amp = (np.abs(lam - float(sigma)) * cmode
                   * (nrmA + abs(float(sigma)) * nrmM) / np.sqrt(lo))
            promise = cfg.tol * amp + floor
        converged = bool(res.converged) and bool(
            np.all(rn <= 10.0 * promise)
        )

    out = LanczosResult(
        eigenvalues=lam,
        eigenvectors=X if compute_eigenvectors else None,
        iterations=res.iterations,
        kryl_dim=res.kryl_dim,
        converged=converged,
        residual_bounds=rn,
    )
    if return_info:
        return out, PencilInfo(
            m_bounds=(lo, hi), degree=deg, approx_err=aerr,
            inner_solves=counts.get("applies", 0),
            inner_iterations=counts.get("iterations", 0))
    return out
