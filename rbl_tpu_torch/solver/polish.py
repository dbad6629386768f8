"""Warm-started mixed-precision solve: f32 discovery → f64 Chebyshev polish
(port of ``rbl_tpu/solver/polish.py``).

At the reference's absolute 1e-7 residual bound (RBL.jl:109) a clustered
spectrum defeats short Krylov sweeps: the 2-D Laplacian's top-50 relative
gaps are ~1e-5, so a 104-column restarted sweep barely reduces a warm
1e-4 residual.  ARPACK solves it by implicit restarting over thousands of
effective iterations; here the f32 stage already delivers the whole wanted
subspace to ~1e-5 accuracy, and polishing a KNOWN subspace is a job for
**Chebyshev-filtered subspace iteration** (Zhou–Saad Chebyshev–Davidson /
ChASE lineage), not for growing a new Krylov basis:

  1. coarse: f32/f32 plain sweep (`rbl`) for k + buffer pairs at a relaxed
     tolerance.
  2. polish: f64 block iteration on the warm (n, k+q+r) block:
     Rayleigh–Ritz → true residuals → one degree-d Chebyshev filter pass →
     repeat.  Per pass the unwanted component of every wanted pair shrinks
     by p(λ_i)/τ = cosh(d·acosh(x_i)) — with a q ≈ 32-pair buffer setting
     the cutoff at θ_{k+q}, a degree of a few hundred gains 10³–10⁵ per
     pass, so 2–3 passes close 1e-4 → 1e-7.  Everything is block SpMM and
     tall GEMM, the cluster is handled *inside* the Rayleigh–Ritz (cluster
     rotation is invisible to subspace error), and memory is O(n·(k+q)) —
     no Krylov basis at all.

This plays the role of the reference's FLOAT/DOUBLE precision pair
(common.jl:5-6, README.md:69): the reference spends FLOAT on the
reorth/buffer tier inside one f64 sweep; the JAX package, written for a
chip without native f64, spends f32 on the WHOLE subspace discovery and f64
only on the final filtered polish.  The port keeps that split.  It leaves
out the JAX package's host-side Rayleigh–Ritz branch, which exists because
that chip's long f64 contractions are f32-grade: a CUDA device's are not,
so the Gram, the rotation and the QR all stay on the device.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import RBLConfig, matmul_precision
from ..ops.chebyshev import ChebyshevProductFilter
from ..ops.contract import gram
from ..ops.qr import block_qr
from ..ops.spmm.operator import AffineOperator, as_operator, cast_operator, dot
from ..parallel.dist_spmm import on_mesh, op_mesh
from ..parallel.mesh import col_sumsq, local_rows, randn_rows
from .lanczos import LanczosResult
from .rbl import rbl


def _rr_gram(op, X, mesh=None):
    """A·X and the (m, m) Rayleigh–Ritz matrix XᵀAX."""
    AX = op.apply(X)
    return gram(X, AX, mesh=mesh), AX


def _rotate_dev(X, Y):
    """X·Y on the device, in X's dtype."""
    return dot(X, Y, X.dtype)


def _rr_rotate(X, AX, Y, theta, mesh=None):
    """Rotate the block onto the Ritz vectors and return TRUE absolute
    residual norms ‖A·x_i − θ_i·x_i‖ (the reference's convergence quantity,
    common.jl:56-65 — not the Lanczos bound, which lies once a basis
    degrades)."""
    Xr = _rotate_dev(X, Y)
    AXr = _rotate_dev(AX, Y)
    R = AXr - Xr * theta[None, :]
    return Xr, torch.sqrt(col_sumsq(R, mesh))


def _filter_only(op, X, a, b, degree, fdt=None):
    """One Chebyshev filter pass (the PRODUCT form, ChebyshevProductFilter:
    built from the `(A·Y − r·Y)` pattern alone, with per-step column
    normalization, so no intermediate leaves O(1) at any degree), columns
    normalized, WITHOUT the QR.

    ``fdt`` optionally runs the FILTER CHAIN in a lower precision.  The
    subspace noise this injects (~√d·eps_f32 relative) is repaired by the
    enclosing loop: the post-filter QR and the Rayleigh–Ritz always run in
    X's own (compute) dtype, and that loop switches fdt to the compute
    dtype once the residuals approach the f32 floor.  Under a row mesh
    (the operator's) X is the rank's rows and the norms are reduced."""
    mesh = op_mesh(op)
    xdt = X.dtype
    if fdt is not None and fdt != xdt:
        fop = ChebyshevProductFilter(
            base=cast_operator(op, fdt), a=a.to(fdt), b=b.to(fdt),
            degree=degree, mesh=mesh,
        )
        Y = fop.apply(X.to(fdt)).to(xdt)
    else:
        fop = ChebyshevProductFilter(base=op, a=a, b=b, degree=degree,
                                     mesh=mesh)
        Y = fop.apply(X)
    nrm = torch.sqrt(col_sumsq(Y, mesh))
    return Y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def _filter_qr(op, X, frozen, a, b, degree, qr_method, fdt=None):
    """One Chebyshev filter pass + re-orthonormalization.

    Frozen (already-converged) columns pass through UNFILTERED, and are
    stable-partitioned to LEAD the QR: passthrough via R₁₁ ≈ I only holds
    for a PREFIX of orthonormal columns — an interleaved lock pattern
    would project a frozen column against a filtered unfrozen one ahead of
    it, perturbing the converged vector (possibly back above tol).  With
    the permutation, frozen columns emerge stable and the unfrozen ones are
    deflated against them inside the same QR (run in the COMPUTE dtype,
    which also re-orthogonalizes low-precision filter output against the
    frozen set in full precision)."""
    Y = _filter_only(op, X, a, b, degree, fdt=fdt)
    Y = torch.where(frozen[None, :], X, Y)
    order = torch.argsort((~frozen).to(torch.int8), stable=True)
    inv = torch.argsort(order)
    Q, _ = block_qr(Y[:, order], method=qr_method, mesh=op_mesh(op), n=op.n)
    return Q[:, inv]


def _auto_degree(x: float, gain: float, cap: int) -> int:
    """Smallest d with cosh(d·acosh(x)) ≥ gain (filter gain at relative
    coordinate x > 1), clamped to [8, cap]."""
    if not np.isfinite(x) or x <= 1.0 + 1e-15:
        return cap
    d = math.acosh(2.0 * gain) / math.acosh(x)
    return int(min(cap, max(8, math.ceil(d))))


def chebyshev_refine(
    A: Any,
    warm_V: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    *,
    which: str = "LM",
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    degree: Optional[int] = None,
    max_passes: int = 12,
    extra_random: Optional[int] = None,
    target_gain: float = 1e6,
    degree_cap: int = 500,
    filter_dtype: str = "auto",
    timer=None,
    checkpoint_path: Optional[str] = None,
) -> LanczosResult:
    """Polish approximate eigenvectors to cfg.tol (absolute residual) by
    Chebyshev-filtered subspace iteration in cfg.compute_dtype.

    A host matrix is built on ``cfg.device`` (None: the CUDA card, which
    must exist); an operator or tensor keeps its own device, and
    ``warm_V`` goes to the operator's.

    warm_V: (n, m) block of approximate eigenvectors for the wanted end,
        m ≥ k; extra columns beyond k act as the convergence buffer — the
        filter cutoff sits below the m-th Ritz value, so the wanted k gain
        cosh(d·acosh(x_k)) per pass while the buffer absorbs the slow edge.
    which: "LM" (descending |λ|), "LA" (descending λ), "SA" (ascending λ —
        solved as LA of −A).  LM with no certified lower bound uses the
        symmetric damped interval [−θ̃, θ̃] (correct for mixed-sign
        spectra; √2 more degree than one-sided).
    bounds: optional (λ_min, λ_max) certification for A's spectrum (either
        entry None).  λ_min = 0 for PSD operators halves the damped
        interval — the filter degree drops ~√2.
    degree: fixed filter degree (default: per-pass auto from the Ritz
        geometry, targeting ``target_gain`` per pass, capped at
        ``degree_cap``; raised 1.5× on a stalled pass).  The 1e6 gain is
        the default of the JAX package.
    extra_random: random columns appended to warm_V (default block_size) —
        rank-deficiency repair and the escape hatch for any wanted
        direction the coarse stage missed entirely (the filter amplifies
        its component out of the random seed).
    filter_dtype: "auto" (default) runs filter chains in f32 while the
        residuals sit far above the f32 noise floor, switching to the
        compute dtype for the final passes; "compute" pins every chain to
        cfg.compute_dtype.
    checkpoint_path: written atomically after every filter pass
        (``utils.checkpoint.save_polish_state``) and removed when the
        solve converges.  It is never read here: to continue from a file,
        pass ``warm_V=load_polish_state(path)["X"], extra_random=0``.

    Returns LanczosResult with eigenvalues/eigenvectors/residual_bounds
    for the k wanted pairs (Rayleigh–Ritz values against the true A);
    ``iterations`` counts filter passes.

    Under ``cfg.mesh`` warm_V is global (n rows) or the rank's rows, and
    the eigenvectors come back as the rank's rows; a checkpoint holds the
    whole block (rank 0 writes it).
    """
    cfg = cfg or RBLConfig()
    mesh = cfg.mesh
    which = which.upper()
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which={which!r} not in ('LM', 'LA', 'SA')")
    if filter_dtype not in ("auto", "compute"):
        raise ValueError(f"filter_dtype={filter_dtype!r} not in ('auto', 'compute')")
    from ..utils.profiling import null_timer

    timer = timer or null_timer()
    cdt = cfg.compute_dtype
    base = on_mesh(as_operator(A, dtype=cdt, device=cfg.device), mesh)
    n = base.n
    rows = local_rows(n, mesh)  # this rank's rows of every n-sized block
    dev = base.device
    # SA = LA of −A (eigenvectors invariant; values negated back at exit)
    op = base if which != "SA" else AffineOperator.shift(base, -1.0, 0.0)

    lo_u = hi_u = None
    if bounds is not None:
        lo_u, hi_u = bounds
    if which == "SA":  # bounds describe A itself; map to the solved −A
        lo_u, hi_u = (
            None if hi_u is None else -hi_u,
            None if lo_u is None else -lo_u,
        )

    with matmul_precision(cfg.matmul_precision):
        r = cfg.block_size if extra_random is None else int(extra_random)
        W = torch.as_tensor(warm_V).to(device=dev, dtype=cdt)
        if mesh is not None and W.ndim == 2 and W.shape[0] == n != rows:
            W = W[slice(*mesh.row_range(n))]
        if W.ndim != 2 or W.shape[0] != rows or W.shape[1] < k:
            raise ValueError(
                f"warm_V must be (n={rows}, m>={k}), got {tuple(W.shape)}"
            )
        if r:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed * 1_000_003 + 104729)
            W = torch.cat([W, randn_rows(n, r, gen, cdt, dev, mesh)], dim=1)
        m = int(W.shape[1])
        # entry orthonormalization: column-normalize first so duplicate /
        # garbage warm columns degrade into noise directions instead of
        # sinking the Cholesky (same rationale as _filter_qr)
        nrm = torch.sqrt(col_sumsq(W, mesh))
        W = W / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        qr_method = ("cholqr2" if cdt.itemsize >= 8
                     else cfg.resolved_qr_method())
        X, _ = block_qr(W, method=qr_method, mesh=mesh, n=n)

        hi = hi_u
        if hi is None:
            from ..ops.eig import spectral_norm_bound

            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed + 1)
            hi = float(spectral_norm_bound(op, gen, mesh=mesh))

        import scipy.linalg

        debug = bool(os.environ.get("RBL_DEBUG"))
        t_last = time.perf_counter()
        deg = degree
        prev_top = np.inf
        th = np.zeros(m)
        res = np.full(m, np.inf)
        converged = False
        npass = 0
        for p in range(max_passes):
            with timer.section("polish_rr"):
                H, AX = _rr_gram(op, X, mesh)
                Hh = H.cpu().numpy().astype(np.float64)
            if not np.all(np.isfinite(Hh)):
                raise FloatingPointError(
                    "non-finite Rayleigh-Ritz matrix in chebyshev_refine "
                    f"(pass {p}) — operator output is unstable"
                )
            Hh = (Hh + Hh.T) / 2.0
            th_a, Y_a = scipy.linalg.eigh(Hh)
            order = (
                np.argsort(-np.abs(th_a), kind="stable") if which == "LM"
                else np.argsort(-th_a, kind="stable")
            )
            th, Yh = th_a[order], Y_a[:, order]
            with timer.section("polish_rr"):
                X, res_t = _rr_rotate(
                    X, AX,
                    torch.as_tensor(np.ascontiguousarray(Yh), dtype=cdt, device=dev),
                    torch.as_tensor(th, dtype=cdt, device=dev), mesh,
                )
                res = res_t.cpu().numpy().astype(np.float64)
            npass = p + 1
            top = float(np.max(res[:k]))
            if top < cfg.tol:
                converged = True
                break
            if p == max_passes - 1:
                break

            # ---- filter geometry from the CURRENT Ritz values ----------
            # Cutoff at the (k + half-buffer)-th Ritz value, NOT the m-th:
            # trailing columns can be garbage (a cap-hit coarse stage, the
            # random pad) whose Rayleigh quotients sit far below the
            # cluster — keying on θ_m drags the cutoff toward 0, gutting
            # the per-pass gain (and, for LM, collapsing the damped
            # interval entirely).  θ_ci ≤ λ_ci ≤ λ_k by interlacing
            # (ci ≥ k), so the wanted pairs are never damped; pairs
            # between the cutoff and λ_k merely converge along with the
            # wanted ones.
            ci = min(m - 1, k - 1 + max(1, (m - k) // 2))
            scale = max(float(np.max(np.abs(th))), 1e-300)
            margin = 1e-10 * scale  # θ_i ≤ λ_i (interlacing) — the margin
            #                         only covers f64 RR rounding
            if which == "LM":
                tilde = float(np.abs(th[ci])) - margin
                a_ = -tilde if (lo_u is None or lo_u < -tilde) else float(lo_u)
                b_ = tilde
            else:
                a_ = float(lo_u) if lo_u is not None else -hi
                b_ = float(th[ci]) - margin
            span = max(float(np.abs(th[0])) - a_, 1e-300)
            if not (b_ - a_ > 1e-12 * max(span, 1.0)):
                # degenerate geometry (subspace ≈ whole space, or a flat
                # cluster down to a_): nothing left to damp — plain RR
                # iteration can't improve either, so stop honestly
                break

            c_ = (a_ + b_) / 2.0
            e_ = (b_ - a_) / 2.0
            # Lock: columns whose TRUE residual already clears the bound
            # freeze through the filter (see _filter_qr) — on spread
            # spectra the converged dominant pairs would otherwise set an
            # astronomically larger gain than the laggards and every
            # column would collapse onto them (λ₁/λ_k = 10/6 at
            # auto-degree 80 gives a e⁸⁸ gain ratio — f64 cannot hold
            # both).
            frozen = res < cfg.tol
            unfrozen_wanted = np.nonzero(~frozen[:k])[0]

            # mixed-precision filter phase: run the chain in f32 while the
            # residual target is far above the f32 noise floor; the QR/RR
            # stay in the compute dtype throughout
            fdt = None
            if (
                filter_dtype == "auto"
                and cdt.itemsize >= 8
                and top > 64 * float(np.finfo(np.float32).eps) * scale
            ):
                fdt = torch.float32
            # ratio-cap headroom e^head: leakage along the fast directions
            # reaches own·eps·e^{d·Δy} before QR; since those directions
            # are REPRESENTED in the block, QR-deflation strips what
            # lands on them — the cap only has to keep the transient
            # below ~1e-3 of the column's own content (f64: e²⁷·2e-16 ≈
            # 1e-4; f32: e⁹·1.2e-7 ≈ 1e-3)
            head = 9.0 if fdt is not None else 27.0

            def _y(i):
                x = abs((float(th[i]) - c_) / e_)
                return math.acosh(x) if x > 1.0 + 1e-15 else 0.0

            if degree is None:
                i_lo = int(unfrozen_wanted[-1])
                d_new = _auto_degree(
                    abs((float(th[i_lo]) - c_) / e_), target_gain,
                    degree_cap,
                )
                # gain-RATIO cap vs the GLOBAL spectral top (frozen pairs
                # included): rounding inside the filter reinjects
                # eps-level leakage along the fastest directions into
                # every unfrozen column, amplified by up to
                # e^{d·(y_top − y_lo)} over the remaining degree — it must
                # stay ≥ 1e-6 below the slow pair's own gain or the
                # column is annihilated before QR-deflation can strip it.
                y_spread = _y(0) - _y(i_lo)
                ratio_cap = (
                    max(8, int(head / y_spread)) if y_spread > 1e-9
                    else degree_cap
                )
                d_new = min(d_new, ratio_cap)
                if deg is None or top <= 0.3 * prev_top:
                    deg = d_new
                else:
                    # stalled: the geometry estimate was optimistic —
                    # escalate, but never past the ratio cap
                    deg = min(
                        degree_cap, max(d_new, int(deg * 1.5) + 8),
                        ratio_cap,
                    )
                # the JAX package's √2-geometric degree grid (there it
                # bounds the number of compiled filters; kept so that the
                # two packages take the same degrees): rounding UP costs
                # ≤ 41% extra SpMMs and only ADDS gain.  Never round past
                # the safety caps.
                if deg < degree_cap:
                    b_deg = 8
                    while b_deg < deg:
                        b_deg = int(b_deg * 1.4142) + 1
                    deg = min(b_deg, degree_cap, ratio_cap)
            prev_top = top
            if debug:
                t_now = time.perf_counter()
                print(
                    f"[chebyshev_refine] pass {p}: top={top:.3e} "
                    f"locked={int(np.sum(res[:k] < cfg.tol))}/{k} "
                    f"deg={deg} fdt={fdt} cut={b_:.6g} "
                    f"th0={float(th[0]):.8g} thk={float(th[k-1]):.8g} "
                    f"thci={float(th[ci]):.8g} dt={t_now - t_last:.2f}s",
                    flush=True,
                )
                t_last = t_now
            with timer.section("polish_filter"):
                X = _filter_qr(
                    op, X, torch.as_tensor(frozen, device=dev),
                    torch.as_tensor(a_, dtype=cdt, device=dev),
                    torch.as_tensor(b_, dtype=cdt, device=dev),
                    deg, qr_method, fdt=fdt,
                )
            if checkpoint_path is not None:
                from ..utils.checkpoint import save_polish_state

                with timer.section("checkpoint"):
                    save_polish_state(checkpoint_path, X, th, res, p + 1,
                                      mesh=mesh, n=n)

    if converged and checkpoint_path is not None:
        from ..utils.checkpoint import remove_file

        remove_file(checkpoint_path, mesh)
    lam = th[:k].astype(np.float64)
    if which == "SA":
        lam = -lam
    return LanczosResult(
        eigenvalues=lam,
        eigenvectors=X[:, :k],
        iterations=npass,
        kryl_dim=m,
        converged=converged,
        residual_bounds=res[:k].copy(),
    )


def rbl_polished(
    A: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    b: int = 8,
    coarse_tol: float = 1e-2,
    coarse_b: Optional[int] = None,
    coarse_cfg: Optional[RBLConfig] = None,
    buffer: Optional[int] = None,
    which: str = "LM",
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    degree: Optional[int] = None,
    max_passes: int = 12,
    target_gain: float = 1e6,
    timer=None,
    checkpoint_path: Optional[str] = None,
) -> LanczosResult:
    """Two-stage solve: f32 subspace discovery, f64 Chebyshev-filtered
    subspace polish (module docstring).

    ``cfg`` governs the POLISH stage (its ``tol`` is the final absolute
    residual bar; dtypes default f64).  The coarse stage runs ``rbl`` with
    f32 basis/compute at ``coarse_tol`` for k + ``buffer`` pairs (buffer
    default max(2b, min(k, 32)) — the extra pairs set the filter cutoff
    below the wanted cluster; see chebyshev_refine).  ``coarse_tol`` 1e-2
    and the buffer are the defaults of the JAX package.  ``bounds``
    optionally certifies (λ_min, λ_max) of A — λ_min = 0 for PSD operators
    roughly halves the filter degree.

    Returns the polish stage's ``LanczosResult``; ``iterations`` counts
    filter passes.  If the coarse stage finds nothing usable
    (pathological), the solve falls back to a cold f64 ``rbl_restarted``
    — identical to the plain restarted solver — whose sweeps start at
    max(8b, 2k) columns rounded up to b, as in the JAX package, or at
    ``cfg.restart_kryl_dim`` when the caller sets it to another value than
    its default, under a budget of 4·⌈k/b⌉ + 16 restarts.

    ``checkpoint_path`` is honored on BOTH paths: the warm polish writes
    an atomic filter-pass-boundary checkpoint and removes it on success,
    the cold fallback checkpoints at restart boundaries.  Neither reads an
    existing file.
    """
    cfg = cfg or RBLConfig()
    if buffer is None:
        buffer = max(2 * b, min(k, 32))
    if coarse_cfg is None:
        coarse_cfg = cfg.replace(
            basis_dtype=torch.float32,
            compute_dtype=torch.float32,
            tol=max(coarse_tol, float(np.finfo(np.float32).eps)),
            qr_method="auto",  # resolve per-dtype (cholqr2 for f32)
            sweep_checkpoint_path=None,
        )
    # one operator for both stages: built once on the device at the
    # polish dtype, cast for the coarse sweep
    op = on_mesh(as_operator(A, dtype=cfg.compute_dtype, device=cfg.device),
                 cfg.mesh)
    k_coarse = min(k + buffer, op.n)
    # coarse_b: the discovery sweep's block size, decoupled from the
    # polish block.  None keeps the caller's b.
    coarse = rbl(op, k_coarse, cfg=coarse_cfg, b=coarse_b or b,
                 which=which, timer=timer)
    warm_V = coarse.eigenvectors
    if warm_V is not None:
        finite = bool(torch.isfinite(warm_V).all())
        if cfg.mesh is not None:
            finite = cfg.mesh.agree(finite)  # one rank's rows decide for all
        if not finite:
            warm_V = None  # garbage from the coarse stage: run the polish cold

    if warm_V is None:
        # cold fallback: the restarted polish path (no warm subspace to
        # filter — grow one the Krylov way)
        kryl = cfg.restart_kryl_dim
        if kryl == RBLConfig.restart_kryl_dim:
            kryl = max(8 * b, 2 * k)
            kryl += (-kryl) % b
        from .restarted import rbl_restarted

        return rbl_restarted(
            op, k, cfg=cfg.replace(restart_kryl_dim=kryl), b=b,
            max_restarts=4 * (k + b - 1) // b + 16, timer=timer,
            checkpoint_path=checkpoint_path, which=which,
        )

    return chebyshev_refine(
        op, warm_V, k, cfg=cfg.replace(block_size=b), which=which,
        bounds=bounds, degree=degree, max_passes=max_passes,
        target_gain=target_gain, timer=timer,
        checkpoint_path=checkpoint_path,
    )
