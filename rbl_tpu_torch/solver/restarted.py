"""Explicitly restarted, deflating randomized block Lanczos (port of
``rbl_tpu/solver/restarted.py``).

Reference: restarted.jl — `RBL_gpu_restarted` / `RBL_restarted`
(restarted.jl:97-146, 196-246) run fixed-length Lanczos sweeps with no
convergence polling, deflate against a lock set of converged Ritz vectors
every 3rd iteration (restarted.jl:53-57), then after one banded eigensolve
lock every Ritz pair whose residual bound clears 1e-7, seed the next sweep
with the first unconverged Ritz vector, and grow the sweep by 10
(restarted.jl:131-142).  Memory stays bounded by the sweep length — the
variant trades restarts for basis storage.

Build notes:
- One device-agnostic implementation replaces the CPU/GPU twins.
- The lock set is a zero-padded (n, k) buffer on the operator's device;
  deflation is the same projection as partial reorth.
- The sweep state at a restart boundary (lock set, locked values, count,
  sweep length, next start block) is the checkpoint/resume surface
  (``utils.checkpoint.save_restart_state``, the JAX package's file format).
- Unlike the reference, which returns V = zeros and discards the locked
  vectors (restarted.jl:99-100,145), the locked Ritz vectors are returned.
- What the JAX package does only for XLA is left out: the power-of-two
  bucket of the store's capacity, the fixed-width padded recovery (both
  pin compiled shapes) and the probe-and-retry wrapper of its TPU tunnel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import RBLConfig, matmul_precision
from ..ops.qr import block_qr
from ..ops.reorth import deflate
from ..ops.spmm.operator import as_operator
from .basis import BasisStore
from .lanczos import (
    LanczosResult,
    lanczos_iteration,
    random_start_block,
    recover_eigvec,
)


@dataclasses.dataclass
class RestartState:
    """Checkpointable restart-boundary state (SURVEY §5)."""

    lock_buf: Any              # (n, k) zero-padded locked Ritz vectors
    locked_values: np.ndarray  # (k,)
    count: int
    kryl_dim: int
    Qi: Any                    # next start block (n, b)
    restarts: int = 0
    low_yield_streak: int = 0  # consecutive restarts locking < b/2 pairs


def _restarted_sweep(op, cfg: RBLConfig, Qi, store: BasisStore, lock_buf,
                     timer, k_rem: int):
    """One restart sweep — the MAIN sweep run against the lock set.

    The reference implements the restarted sweep as a separate fixed-length
    loop with no convergence polls and no safety machinery
    (lanczos_iteration_res, restarted.jl:23-95).  Here it IS
    ``lanczos_iteration`` with ``lock_basis`` set, so the sweep inherits
    convergence polling (it may finish early), breakdown re-randomization,
    danger/selective reorth escalation, and birth-scrub T consistency.
    Returns (w desc-|λ|, V desc, bounds desc); V has store.ncols rows."""
    cdt = cfg.compute_dtype
    qr_method = cfg.resolved_qr_method()
    # deflate + re-orthonormalize the start block (the reference deflates
    # without renormalizing, restarted.jl:40; we renormalize for a properly
    # scaled T)
    Qi = deflate(lock_buf, Qi)
    Qi, _ = block_qr(Qi.to(cdt), method=qr_method)
    Qi = Qi.to(cfg.basis_dtype)

    # restart-boundary checkpoints (RestartState) are this variant's
    # fault-tolerance surface — strip the MAIN solver's mid-sweep knobs so
    # successive inner sweeps can't fight over one checkpoint file
    sweep_cfg = cfg.replace(
        max_kryl_dim=cfg.restart_kryl_dim,
        sweep_checkpoint_path=None,
        fault_inject_abort_after_chunks=None,
    )
    w, V, T, bounds, converged, nb = lanczos_iteration(
        op, k_rem, sweep_cfg, Qi, store, lock_basis=lock_buf, timer=timer
    )
    # descending by |λ| (the reference orders by algebraic value,
    # restarted.jl:93-94; |λ| keeps parity with the main solver's
    # largest-magnitude contract)
    w = np.asarray(w)
    V = np.asarray(V)
    bounds = np.asarray(bounds)
    order = np.argsort(-np.abs(w))
    return w[order], V[:, order], bounds[order]


def rbl_restarted(
    A: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    b: int = 1,
    max_restarts: int = 200,
    timer=None,
    checkpoint_path: Optional[str] = None,
    state: Optional[RestartState] = None,
    which: str = "LM",
    v0: Optional[Any] = None,
    warm_V: Optional[Any] = None,
    poll_ahead: Optional[int] = None,
) -> LanczosResult:
    """Restarted + deflated RBL — reference `RBL_gpu_restarted(A, k)`
    (restarted.jl:97-146) with block size b (reference fixes b=1).

    A host matrix is built on ``cfg.device`` (None: the CUDA card, which
    must exist); an operator or tensor keeps its own device.

    ``which`` selects the spectrum end exactly as ``rbl`` does (the
    reference is LM-only): LA/SA run the sweep on the spectrally shifted
    operator A ± sI and map the locked values back.  Checkpointed
    ``RestartState.locked_values`` live in the SHIFTED (θ) space; resuming
    must pass the same ``which``.  ``v0`` seeds the first column of the
    initial sampling block (scipy convention).

    Pass ``checkpoint_path`` to persist the restart state each sweep, and/or
    ``state`` (e.g. from utils.checkpoint.load_restart_state) to resume.

    ``warm_V`` optionally supplies an (n, ≥1) block of approximate
    eigenvectors ordered as this solve locks (descending |λ| for LM) —
    e.g. from a converged low-precision solve (solver/polish.py).  The
    initial block and, after each productive restart, the next start block
    are seeded from the columns aligned with the not-yet-locked pairs
    instead of from randomness / the sweep's own Ritz vectors; a restart
    that locks nothing falls back to the sweep-Ritz seed, which is the
    progress guarantee.  Eigenvectors are shift-invariant, so the same
    ``warm_V`` is valid for LA/SA.

    ``poll_ahead`` caps how many UNLOCKED pairs each sweep's convergence
    poll targets (the locking is prefix-only regardless).  The reference's
    all-or-nothing bound over every remaining pair (common.jl:56-65) makes
    a sweep run to its cap whenever the trailing pairs are slow.  Polling
    just the next ~2b pairs lets a sweep break as soon as its seeded group
    converges.  None keeps the reference semantics."""
    cfg = cfg or RBLConfig()
    cfg = cfg.replace(block_size=b)
    op = as_operator(A, dtype=cfg.compute_dtype, device=cfg.device)
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

            gen = torch.Generator(device=op.device)
            gen.manual_seed(cfg.seed + 1)
            shift = spectral_norm_bound(op, gen)
            op = AffineOperator.shift(op, 1.0 if which == "LA" else -1.0,
                                      shift)
        res = _rbl_restarted_impl(
            op, k, cfg, b, max_restarts, timer, checkpoint_path, state, v0,
            warm_V=warm_V, poll_ahead=poll_ahead,
        )
    if which != "LM":
        # un-shift, then restore LanczosResult's documented order
        # (descending |λ|): the sweep ordered by θ of the SHIFTED
        # operator, which after un-shifting is ascending algebraic for
        # SA / descending algebraic for LA, neither of which is
        # descending |λ| when mixed signs are present
        res.eigenvalues = (
            res.eigenvalues - shift if which == "LA"
            else shift - res.eigenvalues
        )
        order = np.argsort(-np.abs(res.eigenvalues), kind="stable")
        res.eigenvalues = res.eigenvalues[order]
        if res.eigenvectors is not None:
            res.eigenvectors = res.eigenvectors[
                :, torch.as_tensor(order, device=res.eigenvectors.device)]
        if res.residual_bounds is not None:
            res.residual_bounds = np.asarray(res.residual_bounds)[order]
    return res


def _pad_random(blk, b: int, gen: torch.Generator):
    """``blk`` widened to b columns with fresh randomness from ``gen``."""
    if blk.shape[1] >= b:
        return blk
    pad = torch.randn((blk.shape[0], b - blk.shape[1]), generator=gen,
                      dtype=torch.float32, device=blk.device).to(blk.dtype)
    return torch.cat([blk, pad], dim=1)


def _warm_block(warm_V, start: int, b: int, cfg, device):
    """Start block from warm_V[:, start:start+b], random-padded to width b.

    The sweep entry deflates + re-orthonormalizes (see _restarted_sweep), so
    raw warm columns are fine here."""
    blk = torch.as_tensor(warm_V)[:, start : start + b].to(
        device=device, dtype=cfg.basis_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed * 1_000_003 + 7919 + start)
    return _pad_random(blk, b, gen)


def _rbl_restarted_impl(op, k, cfg, b, max_restarts, timer,
                        checkpoint_path, state, v0=None, warm_V=None,
                        poll_ahead=None):
    n = op.n
    dev = op.device
    lock_cols = max(k, 1)
    warm_cols = None if warm_V is None else int(torch.as_tensor(warm_V).shape[1])

    if state is None:
        if warm_V is not None:
            Qi = _warm_block(warm_V, 0, b, cfg, dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed)
            if v0 is not None:
                v0 = torch.as_tensor(v0).reshape(-1)
                if v0.shape[0] != n:
                    raise ValueError(
                        f"v0 has length {v0.shape[0]}, expected {n}")
            Qi = random_start_block(op, gen, b, cfg, v0=v0)
        state = RestartState(
            lock_buf=torch.zeros((n, lock_cols), dtype=cfg.basis_dtype,
                                 device=dev),
            locked_values=np.zeros(k),
            count=0,
            kryl_dim=cfg.restart_kryl_dim,
            Qi=Qi,
        )
    else:
        state.lock_buf = state.lock_buf.to(device=dev, dtype=cfg.basis_dtype)
        state.Qi = state.Qi.to(device=dev, dtype=cfg.basis_dtype)

    while state.count < k and state.restarts < max_restarts:
        sweep_cfg = cfg.replace(restart_kryl_dim=state.kryl_dim)
        store = BasisStore(
            n, b, max_cols=state.kryl_dim + b, dtype=cfg.basis_dtype,
            device=dev, device_cap_cols=cfg.basis_device_cap_cols,
        )
        k_rem = max(k - state.count, 1)
        if poll_ahead is not None:
            k_rem = min(k_rem, max(int(poll_ahead), 1))
        w, V, bounds = _restarted_sweep(
            op, sweep_cfg, state.Qi, store, state.lock_buf, timer,
            k_rem=k_rem,
        )
        # Converged prefix: pairs are locked in order until the first
        # unconverged one (which seeds the restart) or k is reached.
        ncomp = 0
        while (
            state.count + ncomp < k
            and ncomp < len(w)
            and bounds[ncomp] < cfg.tol
        ):
            ncomp += 1
        QV = None
        if ncomp:
            # ONE batched basis GEMM for all newly locked pairs
            QV = recover_eigvec(store, V[:, :ncomp])
            nrm = torch.linalg.norm(QV, dim=0)
            QV = QV / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            # GHOST GATE: on extreme-dominance spectra at low precision,
            # deflation leaks (eps-level) re-amplify by |λ|max/|λ|min per
            # iteration and the sweep re-converges an ALREADY-LOCKED
            # direction with a small (lying) residual bound — locking it
            # displaces a true pair.  A true new pair of a symmetric
            # matrix is orthogonal to the locked set, so reject candidates
            # with significant overlap; the truncated prefix seeds the
            # restart instead.  The overlap product stays on the device:
            # only each candidate's largest overlap crosses to the host.
            if state.count:
                locked = state.lock_buf[:, : state.count].to(QV.dtype)
                ov = (locked.T @ QV).abs().amax(dim=0).cpu().numpy()
                bad = np.nonzero(ov > 0.1)[0]
                if bad.size:
                    ncomp = int(bad[0])  # keep the clean prefix only
        if ncomp:
            state.lock_buf[:, state.count : state.count + ncomp].copy_(
                QV[:, :ncomp])
            state.locked_values[state.count : state.count + ncomp] = w[:ncomp]
        next_start = None
        j = ncomp
        # warm-started polish (rbl_polished): after a PRODUCTIVE restart,
        # seed from the warm columns aligned with the next unlocked pairs —
        # the low-precision eigenvector of pair count+ncomp is a far better
        # start than a short sweep's trailing Ritz vector.  A restart that
        # locked nothing keeps the sweep-Ritz seed so stalls still progress.
        warm_seed = (
            warm_V is not None
            and ncomp > 0
            and state.count + ncomp < k
            and warm_cols > state.count + ncomp
        )
        if state.count + ncomp < k and j < len(w) and not warm_seed:
            # restart block: the first b unconverged Ritz vectors (the
            # reference takes one, b=1 — restarted.jl:131-133); fewer
            # than b available → pad with fresh randomness, which the
            # sweep entry deflates and re-orthonormalizes
            width = min(b, V.shape[1] - j)
            next_start = recover_eigvec(store, V[:, j : j + width])
        state.count += ncomp
        # growth is the STALL remedy — a productive restart keeps its
        # sweep length.  "stall" also grows after 2 consecutive LOW-yield
        # (< b/2 locked) restarts: a spectrum that locks one easy pair per
        # round would otherwise never grow and can plateau where the
        # reference's unconditional per-restart growth (restarted.jl:142)
        # escapes.
        low = ncomp < max(1, b // 2)
        state.low_yield_streak = state.low_yield_streak + 1 if low else 0
        if (
            ncomp == 0
            or cfg.restart_growth_policy == "always"
            or state.low_yield_streak >= 2
        ):
            state.kryl_dim += cfg.restart_growth
            state.low_yield_streak = 0
        state.restarts += 1
        if warm_seed:
            state.Qi = _warm_block(warm_V, state.count, b, cfg, dev)
        elif next_start is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed * 1_000_003 + state.restarts)
            state.Qi = _pad_random(next_start, b, gen).to(cfg.basis_dtype)
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_restart_state

            save_restart_state(checkpoint_path, state)

    converged = state.count >= k
    # order descending by |λ|
    order = np.argsort(-np.abs(state.locked_values[: state.count]))
    D = state.locked_values[: state.count][order]
    V_cols = state.lock_buf[:, : state.count][
        :, torch.as_tensor(order, device=dev)]
    return LanczosResult(
        eigenvalues=D,
        eigenvectors=V_cols,
        iterations=state.restarts,
        kryl_dim=state.kryl_dim,
        converged=converged,
    )


def RBL_restarted(A, k: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (restarted.jl:196): returns (D, V)."""
    res = rbl_restarted(A, k, cfg=cfg)
    return res.eigenvalues, res.eigenvectors


def RBL_gpu_restarted(A, k: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (restarted.jl:97): the GPU/CPU restarted twins
    collapse into one device-agnostic solve here, so this is `RBL_restarted`
    under the reference's GPU entry name.  UNLIKE the reference (which
    returns V=zeros, restarted.jl:99-100,145), V holds the locked
    eigenvectors."""
    return RBL_restarted(A, k, cfg=cfg)
