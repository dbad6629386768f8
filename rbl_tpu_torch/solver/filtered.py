"""Chebyshev-filtered randomized block Lanczos — ``rbl_filtered`` (port of
``rbl_tpu/solver/filtered.py``).

Beyond-parity accelerator (the reference has no polynomial filtering): on
slowly-decaying spectra the plain sweep must grow a deep Krylov basis
before the top-k separate, and late-sweep cost is dominated by
reorthogonalization traffic proportional to basis-length × n.  Running the
sweep on p(A) — a scaled Chebyshev filter that damps [λ_min, cutoff] to
|p| ≤ τ and spreads the wanted [cutoff, λ_max] across [τ, 1]
(ops/chebyshev.py) — collapses the Krylov dimension at the price of
``degree`` extra SpMMs per iteration.  Eigenvalues are recovered from
Rayleigh quotients with the ORIGINAL A, and the returned residual bounds
are true ‖Ax − λx‖ norms, so the filter cannot silently distort the
answers.

Pipeline:
  1. certified spectrum bounds: λ ∈ [−‖A‖₂, ‖A‖₂] from the power-method
     bound (user-overridable when λ_min is known, e.g. 0 for PSD);
  2. cutoff from a short raw-probe pre-sweep, two estimates at once:
     - sharp: block stochastic Lanczos quadrature — the pre-sweep's block
       tridiagonal T yields quadrature nodes θ_i with weights
       (n/b)·‖first-b rows of y_i‖², an unbiased estimate of the
       eigenvalue counting function; the cutoff is placed where the
       estimated count from the top reaches k + pad.  (This is why the
       pre-sweep starts from qr(Ω), NOT the solver's usual qr(A·Ω): the
       A-multiply weights the probe measure by ~λ² and inflates top
       counts.)
     - certified floor: the (k+pad)-th Ritz value — Ritz values from any
       Krylov subspace underestimate (Courant–Fischer), so a cutoff at
       the floor provably damps no wanted eigenvalue.
     The solve runs at the sharp estimate and self-corrects: if the
     recovered λ_k falls below the cutoff or a true residual fails, the
     cutoff bisects toward the floor and the sweep re-runs with a degree
     re-derived from the new geometry;
  3. degree: smallest d with 1/T_d(x̂) ≤ tau_target (filter attenuation),
     clamped to [6, 200];
  4. main sweep on p(A) with which="LM" (the damped sea lies in [−τ, τ],
     the wanted values in (τ, 1]);
  5. Rayleigh recovery of λ from the converged filtered Ritz vectors +
     true-residual validation against A.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import RBLConfig, matmul_precision
from ..ops.chebyshev import ChebyshevFilterOperator
from ..ops.spmm.operator import AffineOperator, as_operator
from .lanczos import LanczosResult, _rayleigh_refine
from .rbl import rbl


@dataclasses.dataclass(frozen=True)
class FilterInfo:
    """Diagnostics of a filtered solve (returned with return_info=True)."""

    bounds: Tuple[float, float]   # certified [λ_min, λ_max] interval used
    cutoff: float                 # damped-interval upper edge
    degree: int                   # Chebyshev degree
    tau: float                    # attenuation 1/T_d(x̂) on the damped set
    presweep_kryl: int            # Krylov dim spent on the cutoff estimate


def _auto_degree(lo: float, cutoff: float, gamma: float,
                 tau_target: float) -> int:
    c = (lo + cutoff) / 2.0
    e = (cutoff - lo) / 2.0
    xhat = (gamma - c) / e
    if xhat <= 1.0 + 1e-12:
        return 200
    d = math.acosh(1.0 / tau_target) / math.acosh(xhat)
    return int(min(200, max(6, math.ceil(d))))


def _presweep_cutoff(op, k: int, pad: int, cfg: RBLConfig, hi: float):
    """Short raw-probe block sweep → (cutoff estimate, certified floor,
    certified ceiling, Krylov dim spent).

    The sweep starts from qr(Ω) (``raw=True`` — NOT the solver's usual
    qr(A·Ω), whose A-multiply weights the probe measure by ~λ² and
    inflates top counts).  Its block tridiagonal T gives both estimates:

    - block stochastic Lanczos quadrature: eigenpairs (θ_i, y_i) of T are
      quadrature nodes/weights of the probe subspace's spectral measure;
      w_i = (n/b)·‖first-b rows of y_i‖² estimates the eigenvalue count at
      each node, and the cutoff sits at the first node (from the top)
      where the cumulative count reaches k + pad;
    - certified floor: the (k+pad)-th Ritz value, a guaranteed
      underestimate of λ_{k+pad} (Courant–Fischer) — the safe fallback the
      caller bisects toward when the counting estimate overshoots.
    """
    import scipy.linalg

    from .basis import BasisStore
    from .lanczos import lanczos_iteration, random_start_block

    b = cfg.block_size
    n = op.n
    kpre = min(n, k + pad)
    mpre = min(cfg.max_kryl_dim, max(2 * kpre, kpre + 4 * b))
    mpre = max(mpre, kpre + b)
    # unreachable tol: the pre-sweep must run to its small cap so the
    # estimates are as tight as mpre allows.  Mid-sweep checkpoint knobs
    # are stripped: a pre-sweep checkpoint resumed by the MAIN filtered
    # solve would splice an unfiltered-operator basis into the filtered
    # sweep (T ≠ QᵀfopQ)
    cfg_pre = cfg.replace(
        max_kryl_dim=mpre, tol=float(np.finfo(np.float64).tiny),
        sweep_checkpoint_path=None, fault_inject_abort_after_chunks=None,
    )
    gen = torch.Generator(device=op.device)
    gen.manual_seed(cfg.seed + 2)
    Qi = random_start_block(op, gen, b, cfg_pre, raw=True)
    store = BasisStore(
        n, b, max_cols=mpre + b, dtype=cfg_pre.basis_dtype, device=op.device,
        device_cap_cols=cfg_pre.basis_device_cap_cols,
    )
    _w, _V, T, _bounds, _conv, _nb = lanczos_iteration(
        op, kpre, cfg_pre, Qi, store
    )
    m = store.ncols
    th, Y = scipy.linalg.eigh(T.dense(m))
    desc = np.argsort(th)[::-1]
    th = th[desc]
    wts = (n / b) * np.sum(Y[:b, desc] ** 2, axis=0)
    idx = int(np.searchsorted(np.cumsum(wts), k + pad))
    cut_est = float(th[min(idx, len(th) - 1)])
    theta_floor = float(th[min(kpre, len(th)) - 1])
    # θ₁ ≤ λ₁ (Courant–Fischer): a certified ceiling — a cutoff above it
    # could place the ENTIRE spectrum in the damped interval
    theta_top = float(th[0])
    # small shoulder so the targeted eigenvalue is not AT the filter edge
    cut_est -= 0.02 * max(hi - cut_est, 0.0)
    cut_est = min(cut_est, theta_floor + 0.95 * (theta_top - theta_floor))
    return max(cut_est, theta_floor), theta_floor, theta_top, m


def rbl_filtered(
    A: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    *,
    which: str = "LA",
    degree: Optional[int] = None,
    cutoff: Optional[float] = None,
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    pad: Optional[int] = None,
    tau_target: float = 1e-3,
    compute_eigenvectors: bool = True,
    v0=None,
    return_info: bool = False,
):
    """k extreme eigenpairs of symmetric A via Chebyshev-filtered
    randomized block Lanczos.

    A host matrix is built on ``cfg.device`` (None: the CUDA card, which
    must exist); an operator or tensor keeps its own device.

    which: "LA" (largest algebraic, descending — default) or "SA"
        (smallest algebraic, ascending; solved as LA of −A).  "LM" needs a
        single spectrum end to filter toward and is not supported — use
        plain ``rbl`` for LM, or "LA"/"SA" when the sign of the dominant
        end is known (any PSD operator: LM ≡ LA).
    degree: Chebyshev degree (default: derived from tau_target).
    cutoff: damped-interval upper edge.  Must satisfy cutoff ≤ λ_k or
        wanted eigenvalues are damped; when None a short unfiltered
        pre-sweep supplies a certified underestimate of λ_{k+pad}.
    bounds: optional (λ_min, λ_max) overrides for the certified spectrum
        interval of the SOLVED operator (−A for which="SA"); either entry
        may be None.  λ_min matters: an eigenvalue BELOW the damped
        interval is amplified with alternating sign — only pass a λ_min
        you can certify (e.g. 0 for PSD operators, which also halves the
        damped interval and roughly halves the degree needed for the same
        attenuation).
    pad: cutoff safety margin in eigenvalue count (default max(2b, 8)):
        the pre-sweep estimates λ_{k+pad} so the wanted k sit strictly
        inside the amplified region, not at its compressed edge.
    tau_target: damped-set attenuation the auto-degree aims for.
    return_info: also return a FilterInfo with the chosen geometry.

    Returns a LanczosResult whose eigenvalues are Rayleigh quotients with
    the ORIGINAL A and whose residual_bounds are true ‖Ax − λx‖ column
    norms (converged is demoted if they contradict the filtered sweep's
    claim).
    """
    cfg = cfg or RBLConfig()
    if b is not None:
        cfg = cfg.replace(block_size=b)
    if cfg.sweep_checkpoint_path is not None:
        # every internal sweep here runs against a DIFFERENT operator (the
        # pre-sweep on A, then one filtered operator per retry degree) —
        # a shared mid-sweep checkpoint file would resume the wrong sweep
        cfg = cfg.replace(sweep_checkpoint_path=None,
                          fault_inject_abort_after_chunks=None)
    b = cfg.block_size
    which = which.upper()
    if which not in ("LA", "SA"):
        raise ValueError(
            f"which={which!r} not in ('LA', 'SA') — see the docstring for "
            "why LM cannot be filtered directly"
        )
    base = as_operator(A, dtype=cfg.compute_dtype, device=cfg.device)
    n = base.n
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    # SA = LA of the negated operator (λ ↦ −λ; vectors invariant)
    op = base if which == "LA" else AffineOperator.shift(base, -1.0, 0.0)
    cdt = cfg.compute_dtype

    with matmul_precision(cfg.matmul_precision):
        # 1. certified bounds (they describe the SOLVED operator's
        # spectrum, i.e. −A's for which="SA")
        lo = hi = None
        if bounds is not None:
            lo, hi = bounds
        if lo is None or hi is None:
            from ..ops.eig import spectral_norm_bound

            gen = torch.Generator(device=op.device)
            gen.manual_seed(cfg.seed + 1)
            nb = float(spectral_norm_bound(op, gen))
            if lo is None:
                lo = -nb
            if hi is None:
                hi = nb
        lo, hi = float(lo), float(hi)
        if not lo < hi:
            raise ValueError(f"bounds ({lo}, {hi}) are not an interval")

        # 2. cutoff: counting estimate (sharp) + certified Ritz floor
        gamma = hi
        span = hi - lo
        explicit_cutoff = cutoff is not None
        presweep_kryl = 0
        theta_floor = None
        if cutoff is None:
            npad = pad if pad is not None else max(2 * b, 8)
            cutoff, theta_floor, _theta_top, presweep_kryl = (
                _presweep_cutoff(op, k, npad, cfg, hi)
            )

        def _clamp(c):
            # keep a valid geometry even for degenerate estimates
            return float(min(max(c, lo + 0.02 * span),
                             hi - 1e-12 * max(1.0, abs(hi))))

        cutoff = _clamp(cutoff)
        if theta_floor is not None:
            theta_floor = _clamp(theta_floor)

        # 3./4./5. filtered sweep + Rayleigh recovery against the SOLVED
        # operator, with cutoff self-correction: the counting estimate can
        # overshoot λ_{k+pad} (damping wanted pairs — detected as a true
        # residual failing or a recovered λ below the filter edge), in
        # which case the cutoff bisects toward the certified floor.  The
        # degree is re-derived from EACH attempt's geometry: a retry means
        # the previous geometry was wrong — keeping its degree would
        # over-attenuate the widened passband below the sweep tolerance
        # and everything would "converge" to noise.
        attempts = 0
        while True:
            deg = degree if degree is not None else _auto_degree(
                lo, cutoff, gamma, tau_target
            )
            fop = ChebyshevFilterOperator.make(
                op, lo, cutoff, gamma, degree=deg
            )
            # The sweep's tol applies to FILTERED residuals on the
            # [τ, 1]-scaled spectrum; accuracy in A units is enforced by
            # the true residuals below, not by this knob.
            res = rbl(
                fop, k, cfg=cfg, which="LM",
                compute_eigenvectors=True, v0=v0,
            )
            X = res.eigenvectors
            lam_t, res_t = _rayleigh_refine(
                op, X, torch.zeros((X.shape[1],), dtype=cdt, device=X.device),
                cdt=cdt, width=b,
            )
            lam = lam_t.cpu().numpy().astype(np.float64)
            true_res = res_t.cpu().numpy()
            order = np.argsort(lam)[::-1].copy()  # descending, solved operator
            lam, true_res = lam[order], true_res[order]
            X = X[:, torch.as_tensor(order, device=X.device)]
            ok_res = bool(np.max(true_res) <= 10 * cfg.tol)
            ok_edge = bool(lam[-1] >= cutoff)
            if ok_res and ok_edge:
                break
            if (
                explicit_cutoff
                or theta_floor is None
                or attempts >= 2
                or cutoff <= theta_floor * (1 + 1e-12) + 1e-300
            ):
                break
            attempts += 1
            cutoff = _clamp((cutoff + theta_floor) / 2.0)

    tau = 1.0 / float(
        np.cosh(deg * np.arccosh((gamma - (lo + cutoff) / 2)
                                 / ((cutoff - lo) / 2)))
    )
    converged = bool(res.converged) and ok_res and ok_edge
    if which == "SA":
        # solved-operator (−A) values descend, so −λ already ascends —
        # same column order, matching rbl's SA convention
        lam = -lam

    out = LanczosResult(
        eigenvalues=lam,
        eigenvectors=X if compute_eigenvectors else None,
        iterations=res.iterations,
        kryl_dim=res.kryl_dim,
        converged=converged,
        residual_bounds=true_res,
    )
    if return_info:
        return out, FilterInfo(
            bounds=(lo, hi), cutoff=cutoff, degree=deg, tau=tau,
            presweep_kryl=presweep_kryl,
        )
    return out
