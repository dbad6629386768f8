"""Randomized block Lanczos iteration driver.

One device-agnostic driver replaces the reference's near-duplicate loops
(CPU lanczos_iteration RBL.jl:74-117, GPU lanczos_iteration
RBL_gpu.jl:134-203): the hot path is a small set of eager step functions
(SpMM + three-term recurrence + tall-skinny QR, reorthogonalization of the
newborn residual), driven by a host loop that owns only the tiny replicated
state — the banded T, convergence polling, and iteration cadences (partial
reorth every 2nd iteration RBL.jl:93, eig poll every 4th RBL.jl:106).  The
n-sized state never leaves the device; only b×b blocks (A_i, B_i) cross to
the host, one stacked copy per chunk, as the reference ships only T's
blocks across the PCIe boundary (RBL_gpu.jl:159-161,185).

Design invariants (carried over from the JAX package):

- Solver state invariant between chunks: stored basis = Q_1..Q_{i-1},
  Qprev = Q_i (not yet stored), Bi couples the in-flight pair. Breakdown
  and speculation rewinds must restore exactly this.
- The basis buffer is zero-padded; padding columns must stay zero (all
  reorth contractions rely on it).
- T-consistency: reorthogonalization applies to the RESIDUAL U at birth
  (inside `_sweep_chunk`), never to already-created blocks.  Scrubbing a
  recorded block retroactively makes T ≠ QᵀAQ by O(‖delta‖·‖A‖) — the
  failure is invisible until a big scrub is needed (dominant eigenvalue
  spectra), then T's band goes wrong by O(100) while ‖QᵀQ−I‖ stays 1e-15.
  Diagnostic for "impossible" Ritz values (> ‖A‖): compare T.dense()
  against QᵀAQ from the stored basis, panel by panel.
- `danger` mode (lanczos.py): every-step CGS2 reorth while min ‖B‖ <
  1e-2·tscale — required for large-gap spectra; do not remove.
- `selective` mode (sticky, values-triggered): every-step CGS2 once the
  dominant Ritz value is eps-stable AND its dominance compounds above
  noise over the remaining sweep (ghosts re-amplify ~|θ|max/|θ|min per
  iteration WITHOUT ‖B‖ collapse, so danger mode misses this).  The
  screen-to-screen comparisons feeding it are chained through the eig
  worker (`poll_chain`) — harvest-time comparison was nondeterministic.
- Locked directions are deflated from U every step (their |λ| exceeds
  the active window's, so any leak grows; a block born between cadence
  deflations would freeze the leak into the basis).
- Convergence lives in a WINDOW: past it, converged Ritz directions
  re-amplify and corrupt the basis (T eigenvalues exceed ‖A‖ — the
  symptom).  Polls are therefore decoupled from chunk boundaries (T
  factorizes at any panel prefix from the chunk's stacked blocks) and
  drop to base-cadence "fine polling" once ≥25% of pairs meet the bound.
- Chunk growth + deep pipelining (chunk_growth_cap / pipeline_depth) are
  gated on a calm spectrum (calm_chunks ≥ 2): danger flips discard all
  in-flight chunks, so grown speculation on gap spectra is wasted work
  (measured 2.3× suite slowdown without the gate).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config import RBLConfig
from ..ops.band import BlockTridiagonalT
from ..ops.contract import gram, update
from ..ops.eig import (
    eig_banded_host,
    eig_banded_topk_dense,
    eig_banded_values_topk,
    eigh_banded_device,
    ritz_residual_bounds,
    sort_eig_abs,
)
from ..ops.qr import block_qr
from ..ops.reorth import deflate, project_out
from ..ops.spmm.operator import LinearOperator, _pet, dot
from ..parallel.mesh import col_sumsq, randn_rows
from ..utils.profiling import clock_ns, null_timer, timed_spmm
from .basis import BasisStore

# Observability: RBL_DEBUG=1 prints solver state transitions (danger /
# selective mode, breakdowns, rewinds) with iteration numbers.
_DEBUG = bool(int(os.environ.get("RBL_DEBUG", "0")))


def _dbg(msg):
    if _DEBUG:
        print(f"[rbl] {msg}", flush=True)


class SweepAborted(RuntimeError):
    """Raised by the deterministic preemption injector
    (``RBLConfig.fault_inject_abort_after_chunks``) — simulates losing the
    process mid-sweep so the checkpoint/resume path can be tested without
    actually killing anything."""


# T's width from which the last factorization of a capped sweep is faster
# with torch.linalg.eigh on an idle H100 than with host LAPACK on the
# solve's 4 host threads (PERF.md, the crossover table of the eig polls).
CARD_EIG_MIN_COLS = 256


def _factorize(band, k, backend, device):
    """The k largest-|λ| eigenpairs of T, ascending by |λ|: "scipy" forms
    only those on the host (``eig_banded_topk_dense``); "device" factorizes
    fully on ``device`` and copies back only those
    (``eigh_banded_device``); "native" factorizes fully on the host
    and keeps the top k."""
    if backend == "scipy":
        return eig_banded_topk_dense(band, k)
    if backend == "device":
        return eigh_banded_device(band, device, k)
    return sort_eig_abs(*eig_banded_host(band, backend=backend), k)


def last_eig_backend(backend, device, mesh, m: int) -> str:
    """The backend of a sweep's last factorization of T (m columns wide)
    when the sweep ends at its Krylov cap: nothing overlaps it, the card
    is idle, and above ``CARD_EIG_MIN_COLS`` columns the card factorizes
    faster than host LAPACK.  So with host polls ("scipy") on a CUDA
    device, no mesh (ranks must keep producing identical V) and
    m ≥ CARD_EIG_MIN_COLS it is "device"; else the polls' own."""
    if (backend == "scipy" and mesh is None and torch.device(device).type == "cuda"
            and m >= CARD_EIG_MIN_COLS):
        return "device"
    return backend


def _poll_task(snapshot, k, backend, device, chain, tol, force_full,
               spans=None):
    """One convergence poll, run on the eig worker thread: a values-only
    screen (dsbevd eigenvalues path) gates the full factorization — the
    residual bounds need eigenvectors, but they cannot pass while the top-k
    Ritz values are still moving by more than tol·|λ|max between polls.

    ``backend`` and ``device`` are the factorization's (``_factorize``):
    the polls' own, or for the capped sweep's last poll
    ``last_eig_backend``'s.

    ``chain`` carries the previous poll's screen between tasks ON the
    worker thread (single worker → sequential), so the screen-to-screen
    comparisons feeding both the stability gate and the solver's selective
    trigger are deterministic.
    ``spans``, when given, receives (name, start_ns, end_ns, thread) of the
    screen ("eig_screen") and of the factorization ("eig_poll"), stamped
    on the worker with ``clock_ns``, for the main thread's Timer.
    Returns (screen, previous poll's screen, (w, V) or None, seconds of the
    factorization or None)."""
    w_prev = chain.get("w")
    spans = [] if spans is None else spans
    thread = threading.current_thread().name

    def factorize():
        t0 = clock_ns()
        full = _factorize(snapshot, k, backend, device)
        t1 = clock_ns()
        spans.append(("eig_poll", t0, t1, thread))
        return full, (t1 - t0) / 1e9

    if force_full:
        # the factorization runs regardless — its eigenvalues subsume the
        # values-only screen, so skip it
        full, secs = factorize()
        w_all = full[0]
        idx = np.argsort(np.abs(w_all))[-min(k, len(w_all)):]
        chain["w"] = w_all[idx]
        return w_all[idx], w_prev, full, secs
    t0 = clock_ns()
    w_scr = eig_banded_values_topk(snapshot, k)
    spans.append(("eig_screen", t0, clock_ns(), thread))
    stable = (
        w_prev is not None
        and len(w_prev) == len(w_scr)
        and np.max(np.abs(w_scr - w_prev))
        <= tol * max(np.abs(w_scr).max(), np.finfo(np.float64).tiny)
    )
    full = secs = None
    if stable:
        full, secs = factorize()
    chain["w"] = w_scr
    return w_scr, w_prev, full, secs


# --- poll schedule arithmetic -------------------------------------------


def poll_stride_cols(j: int, b: int, cadence: int, fine_poll: bool) -> int:
    """Columns from panel ``j``'s poll to the next one: the base cadence
    once ``fine_poll`` is set, else the geometric ~m/4 backoff (never
    below the base cadence)."""
    return cadence * b if fine_poll else max(cadence * b, (j * b) // 4)


def poll_panel_for(next_poll_cols: int, i: int, b: int, k: int) -> int:
    """The panel to poll when ``next_poll_cols`` columns are due by panel
    ``i``: never beyond ``i``, never before the first panel whose T can
    hold k Ritz pairs."""
    return min(i, max((next_poll_cols + b - 1) // b, k // b + 1))


def fine_poll_reset_cols(next_poll_cols: int, i_poll: int, b: int,
                         cadence: int) -> int:
    """On the fine-poll flip (≥ 25% of pairs at the bound) the schedule
    is pulled back to base cadence from the flipping poll's panel."""
    return min(next_poll_cols, i_poll * b + cadence * b)


@dataclasses.dataclass
class LanczosResult:
    eigenvalues: np.ndarray                 # (k,), descending by |λ|
    eigenvectors: Optional[torch.Tensor]    # (n, k) on the operator's
    #   device; under cfg.mesh the rank's rows (RowMesh.gather_rows: all)
    iterations: int                         # number of Lanczos blocks generated
    kryl_dim: int                           # final Krylov dimension used
    converged: bool
    residual_bounds: Optional[np.ndarray] = None  # (k,), matching order


# ----------------------------------------------------------------------------
# step functions
# ----------------------------------------------------------------------------

def _step(op: LinearOperator, Qi, Qprev, Bi, *, cdt, qr_method, scrub=None,
          lock_basis=None, mesh=None, timer=None):
    """One block Lanczos step (reference RBL.jl:79-89 first, 97-104 after):
    U = A·Q_i − Q_{i−1}·B_iᵀ (no subtraction on the first step, ``Qprev``
    None);  A_i = Q_iᵀU;  U −= Q_i·A_i;  ``scrub(U, Qi, Qc, Qp)``
    reorthogonalizes the newborn residual (Qc, Qp: the compute-dtype copies
    of Q_i, Q_{i−1});  U is deflated against ``lock_basis``;
    Q_{i+1}B_{i+1} = qr(U).  The basis-precision blocks are promoted to
    compute precision on entry — the mixed-precision seam of
    RBL_gpu.jl:142-143,173-175.  Under ``mesh`` the blocks are the rank's
    rows; the Gram and the QR reduce over the ranks.

    Returns (Q_{i+1} in Qi's dtype, B_{i+1}, A_i).  ``timer`` times the
    step's "spmm", "project" (the three-term subtraction to the deflation)
    and "qr"."""
    tm = timer or null_timer()
    acc = _pet(cdt)
    Qc = Qi.to(cdt)
    Qp = None if Qprev is None else Qprev.to(cdt)
    U = timed_spmm(op.apply, timer)(Qc)
    with tm.section("project"):
        if Qp is not None:
            U = U - dot(Qp, Bi.T, acc)
        Ai = gram(Qc, U, mesh=mesh)
        U = U - dot(Qc, Ai, acc)
        if scrub is not None:
            U = scrub(U, Qi, Qc, Qp)
        if lock_basis is not None:
            # deflate the newborn residual EVERY step: locked directions
            # re-enter U through A, and a block born between cadence
            # deflations would freeze that content into the basis
            U = deflate(lock_basis, U, mesh)
    with tm.section("qr"):
        Qn, Bn = block_qr(U, method=qr_method, mesh=mesh, n=op.n)
    return Qn.to(Qi.dtype), Bn, Ai


def _local_scrub(U, Qi, Qc, Qp, *, passes, mesh):
    """Local scrub (reference loc_reorth!'s role): the newborn residual
    orthogonal to its two parents."""
    for _ in range(passes):
        U = project_out(Qp, U, mesh)
        U = project_out(Qc, U, mesh)
    return U


def _full_scrub(stored, U, Qi, Qc, Qp, *, passes, mesh):
    """Full scrub on the device: each pass projects the newborn residual
    against the stored prefix (which now holds Q_{i−1}) and then the
    not-yet-stored Q_i."""
    for _ in range(passes):
        U = project_out(stored, U, mesh)
        U = project_out(Qc, U, mesh)
    return U


def _tiered_full_scrub(store, timer, stored, U, Qi, Qc, Qp, *, passes, mesh):
    """Full scrub of a store with a host tier (reference
    hybrid_part_reorth!, RBL_gpu.jl:59-81, re-designed for
    T-consistency): the offloaded panels re-enter the device and project
    the newborn residual of EVERY full-scrub step, never the live pair
    (Qi, Qprev), whose T couplings (A_{i−1}, B_i) are already recorded — a
    retroactive edit makes T ≠ QᵀAQ by O(‖leak‖·‖A‖).  One tiered scrub
    per window is NOT enough: leaks along offloaded dominant directions
    re-amplify by ~|λ|max/|λ|min per step.

    Panel-major, not pass-major: each host panel crosses to the device once
    and is projected ``passes`` times consecutively.  Pass-major (the
    textbook BCGS2 sweep order) would either re-transfer the whole host
    tier per pass or hold every panel on the device at once — and the tier
    exists precisely because device memory is full.  Reordering is safe
    because the panels are mutually orthonormal to basis precision:
    cross-panel re-injection from a later projection is
    O(‖QᵢᵀQⱼ‖·eps·‖U‖), far below the CGS2 floor.  Q_i is projected as
    stored, in the basis dtype.  Counts "basis_split_steps"."""
    for _ in range(passes):
        U = project_out(stored, U, mesh)
    for panel in store.stream_host_tier():
        for _ in range(passes):
            U = project_out(panel, U, mesh)
    for _ in range(passes):
        U = project_out(Qi, U, mesh)
    timer.add("basis_split_steps", 1)
    return U


def _sweep_chunk(
    op: LinearOperator,
    basis_buf,
    Qi,
    Qprev,
    Bi,
    col0,
    lock_basis,
    *,
    cdt,
    qr_method,
    nsteps,
    reorth_pattern,
    loc_passes,
    reorth_passes=1,
    mesh=None,
    timer=None,
    full_scrub=_full_scrub,
):
    """``nsteps`` Lanczos iterations between two host reads.

    Fusing the sweep between eigenvalue polls means the n-sized state never
    leaves the device; the b×b T blocks of all nsteps iterations come back
    in one stacked copy.  ``basis_buf`` is updated in place: step s writes
    Q_{j-1} at columns col0 + s·b and its scrub contracts over the stored
    prefix up to and including that block.

    reorth_pattern: booleans per step (full scrub or local scrub);
    ``full_scrub`` is the full scrub's order: ``_full_scrub``, or with a
    host tier ``_tiered_full_scrub`` bound to the store and the timer.
    Returns (basis_buf, Qi, Qprev, Bi, TB) with TB = (2·nsteps, b, b):
    TB[2s] = A_i, TB[2s+1] = B_{i+1} of step s.

    Reorthogonalization applies to the RESIDUAL U at birth, never to
    already-created blocks (the T-consistency invariant): scrubbing U before
    its QR gives B_{j+1} of the *scrubbed* residual and leaves every
    recorded block untouched, so T ≡ QᵀAQ up to rounding, by construction.

    ``timer`` times each step's "spmm", "project" and "qr"."""
    b = Qi.shape[1]
    local = functools.partial(_local_scrub, passes=loc_passes, mesh=mesh)
    out = []
    for s in range(nsteps):
        # archive Q_{j-1} first: blocks are final at creation, and having
        # it in the buffer lets the residual projection cover it
        c = col0 + s * b
        basis_buf[:, c : c + b].copy_(Qprev)
        scrub = (functools.partial(full_scrub, basis_buf[:, : c + b],
                                   passes=max(reorth_passes, 1), mesh=mesh)
                 if reorth_pattern[s] else local)
        Qnext, Bnext, Ai = _step(op, Qi, Qprev, Bi, cdt=cdt, qr_method=qr_method,
                                 scrub=scrub, lock_basis=lock_basis, mesh=mesh,
                                 timer=timer)
        out.append(Ai)
        out.append(Bnext)
        Qprev, Qi, Bi = Qi, Qnext, Bnext
    TB = torch.stack(out)
    return basis_buf, Qi, Qprev, Bi, TB


def _start_host_copy(TB):
    """Start the device→host copy of a chunk's T blocks (the only per-chunk
    transfer); returns a handle for ``_finish_host_copy``.  On the card the
    copy goes to pinned memory on the current stream, so it overlaps the
    host's work until the read."""
    if TB.device.type != "cuda":
        return TB, None
    host = torch.empty(TB.shape, dtype=TB.dtype, pin_memory=True)
    host.copy_(TB, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_host_copy(handle) -> np.ndarray:
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.numpy()


def _fresh_directions(store, extras, lock_basis, gen, shape, dtype, qr_method,
                      mesh=None, n=None):
    """Breakdown recovery: fresh random directions orthogonalized (CGS2 +
    QR) against the WHOLE stored state — device tier, host-offloaded
    panels, the lock set, and the given live ``extras`` blocks.  The reference has no breakdown
    handling (SURVEY §5) — after an invariant subspace converges, its QR
    renormalizes noise and re-injects converged directions ("ghost" Ritz
    values).  Re-randomizing keeps the basis orthonormal and the sweep
    productive.

    The host tier and lock set must be included: a random block has
    ~√(cols/n) expected overlap with any stored span, and a leak frozen in
    here re-amplifies every subsequent step.  Breakdowns are rare, so the
    cost of streaming the panels once per pass does not matter.

    ``extras`` must contain ONLY kept state (Q_i = the new Qprev):
    projecting against the dead chunk-end block as well reinjects whatever
    polluted it.  Under ``mesh`` ``shape`` is the rank's and ``n`` the
    global row count: the whole (n, w) block is drawn on every rank."""
    n = shape[0] if n is None else n
    Z = randn_rows(n, shape[1], gen, dtype, store.buf.device, mesh)
    for _ in range(2):
        Z = project_out(store.view(), Z, mesh)
        for panel in store.stream_host_tier():
            Z = project_out(panel, Z, mesh)
        if lock_basis is not None:
            Z = project_out(lock_basis, Z, mesh)
        for blk in extras:
            Z = project_out(blk, Z, mesh)
        Z, _ = block_qr(Z, method=qr_method, mesh=mesh, n=n)
    return Z


def _split_coupling(B_s: np.ndarray, r0: int):
    """Host-side factorization for a partial-breakdown repair: split the
    rank-deficient coupling block B_s = P·Σ·Wᵀ into a rotation Pf for the
    device block and an UPPER-TRIANGULAR honest coupling B_new (zero rows
    past r0), such that Q_old·B_s = (Q_old·Pf)[:, :r0]·B_new[:r0] up to the
    discarded O(σ_dead) part.  Triangularity matters: T's band layout
    records only B's upper triangle (insertB! semantics, common.jl:20-26),
    so the QR rotation g of the honest rows is folded into Pf."""
    P_, sv_, Wt_ = np.linalg.svd(B_s.astype(np.float64))
    M = sv_[:r0, None] * Wt_[:r0]           # (r0, b) honest coupling
    g, r = np.linalg.qr(M)                  # g: (r0, r0), r: (r0, b) upper
    Pf = P_.copy()
    Pf[:, :r0] = P_[:, :r0] @ g
    B_new = np.zeros_like(B_s)
    B_new[:r0] = r.astype(B_s.dtype)
    return Pf, B_new


def _repair_block(store, Qprev, Qold, B_s, rank, lock_basis, gen, qr_method,
                  mesh=None, n=None):
    """Partial-breakdown repair: the residual U = Q_old·B_s lost rank —
    σ_{rank+1..b}(B_s) sit at the breakdown floor while σ_{1..rank} are
    healthy.  QR of a rank-deficient residual orthonormalizes ROUNDING NOISE
    into the dead columns, which the next application of A re-amplifies
    into ghost eigenvalues.

    Repair: rotate Q_old by B_s's left singular basis (_split_coupling) so
    the honest residual directions land in the first ``rank`` columns —
    exactly preserved, keeping T ≡ QᵀAQ — and replace the dead columns with
    fresh randomness orthogonalized against everything
    (_fresh_directions).  rank == 0 degenerates to full re-randomization
    with a zero coupling, exactly the total-collapse treatment.  Returns
    (Q_new, B_new host array)."""
    if rank == 0:
        Qnew = _fresh_directions(
            store, (Qprev,), lock_basis, gen,
            tuple(Qprev.shape), Qprev.dtype, qr_method, mesh, n,
        )
        return Qnew, np.zeros_like(B_s)
    Pf, B_new = _split_coupling(B_s, rank)
    P = torch.as_tensor(Pf, device=Qold.device)
    H = dot(Qold, P.to(Qold.dtype), _pet(Qold.dtype))[:, :rank]  # healthy part
    Z = _fresh_directions(
        store, (Qprev, H), lock_basis, gen,
        (Qold.shape[0], Qold.shape[1] - rank), Qold.dtype, qr_method, mesh, n,
    )
    return torch.cat([H, Z], dim=1), B_new


def _rayleigh_refine(op: LinearOperator, X, theta0, cdt, width=None, mesh=None,
                     timer=None):
    """Shifted Rayleigh-quotient refinement of converged Ritz values:
    θ = θ₀ + xᵀ(Ax − θ₀x)/xᵀx.  The correction contracts residual-scale
    quantities, so the refined value carries O(eps·|θ|) rounding instead of
    the O(n·eps·‖A‖) accumulated through T's assembly.

    Also returns the TRUE relative residual norms ‖A·x − θx‖/‖x‖ of the
    refined pairs — unlike the Lanczos bound ‖B·y‖ it stays honest when the
    basis degraded.

    ``width`` applies A to at most that many columns at a time (the
    solve's block width, which every operator took during the sweep: the
    panel layout refuses an X above 8 MB); None applies it to all k.
    Under ``mesh`` X is the rank's rows and every sum over rows is reduced
    over the ranks.  ``timer`` times the applies as "spmm"."""
    Xc = X.to(cdt)
    theta0 = theta0.to(device=Xc.device, dtype=cdt)
    k = Xc.shape[1]
    w = width or max(k, 1)
    apply = timed_spmm(op.apply, timer)
    AX = torch.cat([apply(Xc[:, j : j + w]) for j in range(0, k, w)], dim=1)
    Y = AX - Xc * theta0[None, :]
    num = torch.diagonal(gram(Xc, Y, mesh=mesh))
    den = torch.diagonal(gram(Xc, Xc, mesh=mesh))
    theta = theta0 + num / den
    R = Y - Xc * (theta - theta0)[None, :]
    res = torch.sqrt(col_sumsq(R, mesh) / den)
    return theta, res


def recover_eigvec(store: BasisStore, Vk: np.ndarray) -> torch.Tensor:
    """Ritz-vector recovery V = Q_basis · Ṽ; Vk has store.ncols rows.
    Host-tier panels (columns [0, dev_base)) and the device tier (columns
    [dev_base, ncols)) contribute contiguous GEMMs — the reference's
    panelled GPU recovery + CPU overflow accumulation (RBL_gpu.jl:106-132)
    with no per-block loop and no permutation."""
    basis = store.view()
    acc = _pet(basis.dtype)
    Vt = torch.as_tensor(np.ascontiguousarray(Vk), device=basis.device)
    Vt = Vt.to(basis.dtype)
    out = None
    off = 0
    for panel in store.stream_host_tier():
        w = panel.shape[1]
        part = dot(panel, Vt[off : off + w], acc)
        out = part if out is None else out + part
        off += w
    dev_part = update(basis, Vt[store.dev_base :], None, acc)
    return dev_part if out is None else out + dev_part


def random_start_block(op: LinearOperator, gen: torch.Generator, b: int,
                       cfg: RBLConfig, v0=None, raw: bool = False, timer=None):
    """Randomized start: Q₁ = qr(A·Ω).Q with Ω ~ N(0,1)ⁿˣᵇ drawn from
    ``gen`` (reference RBL.jl:136-137 — note the single power-iteration
    step A·Ω).  ``v0`` optionally seeds Ω's first column (scipy-compat
    surface).  ``raw=True`` skips the A-multiply (Q₁ = qr(Ω).Q).

    Under ``cfg.mesh`` every rank draws the whole (n, b) Ω and keeps its
    own rows (the JAX package's sharding constraint on Ω), so the start
    block equals the single-device one; ``v0`` is global.  ``timer`` times
    the apply as "spmm"."""
    cdt = cfg.compute_dtype
    mesh = cfg.mesh
    Omega = randn_rows(op.n, b, gen, cdt, op.device, mesh)
    if v0 is not None:
        v0 = torch.as_tensor(v0).reshape(-1)
        if mesh is not None:
            lo, hi = mesh.row_range(op.n)
            v0 = v0[lo:hi]
        Omega[:, 0] = v0.to(device=op.device, dtype=cdt)
    Y = Omega if raw else timed_spmm(op.apply, timer)(Omega)
    Q1, _ = block_qr(Y, method=cfg.resolved_qr_method(), mesh=mesh, n=op.n)
    return Q1.to(cfg.basis_dtype)


def lanczos_iteration(
    op: LinearOperator,
    k: int,
    cfg: RBLConfig,
    Qi,
    store: BasisStore,
    lock_basis=None,
    timer=None,
    generator: Optional[torch.Generator] = None,
    resume: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray, "BlockTridiagonalT", Optional[np.ndarray], bool, int]:
    """Run the block Lanczos sweep until convergence or the Krylov cap.

    Returns (w_sel ascending-|λ|, V_sel, T, residual_bounds, converged, nblocks)
    where V_sel has nblocks*b rows and k columns.  ``store`` holds all
    nblocks basis blocks on return.  ``generator`` draws every breakdown
    re-randomization (default: a fresh one seeded ``cfg.seed + 1`` on the
    operator's device).

    ``resume``: a ``utils.checkpoint.load_sweep_state`` dict — restores the
    between-chunks invariant (basis prefix in ``store``, which must come in
    EMPTY; recurrence triple; T band; flags) and continues the sweep from
    the saved iteration instead of running the first step on ``Qi``.  The
    generator's state is restored from the file's ``gen_state`` when it was
    saved on the same kind of device; a file without one (written by the
    JAX package, whose ``key`` does not cross) continues with a fresh
    generator seeded ``cfg.seed + 1``.  The generator only matters after a
    breakdown.
    """
    timer = timer or null_timer()
    b = cfg.block_size
    n = op.n
    cdt = cfg.compute_dtype
    dev = Qi.device
    qr_method = cfg.resolved_qr_method()
    eig_bk = {"native": "native", "device": "device"}.get(cfg.eig_backend, "scipy")
    max_kryl = min(cfg.max_kryl_dim, ((n + b - 1) // b) * b)
    # Under a row mesh the n-sized blocks are the rank's rows, every
    # contraction over rows is reduced over the ranks, and the host state
    # below (T, the flags, the polls) is replicated bit for bit.
    mesh = cfg.mesh

    def fresh():
        """The block after Qprev re-randomized (_fresh_directions)."""
        with timer.section("rerandomize"):
            return _fresh_directions(
                store, (Qprev,), lock_basis, gen, tuple(Qprev.shape),
                Qprev.dtype, qr_method, mesh, n,
            )

    def repair(Qold, B_s, rank):
        """The block after Qprev with its rank-``rank`` coupling block B_s
        repaired (_repair_block): (Q_new, the honest B as a host array)."""
        with timer.section("rerandomize"):
            return _repair_block(store, Qprev, Qold, B_s, rank, lock_basis,
                                 gen, qr_method, mesh, n)

    # the sweep's set-up: T, the first step and its read (or the resumed
    # state), the first coupling block's rank check
    with timer.section("solve_setup"):
        T = BlockTridiagonalT(b, max_cols=max_kryl + b)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(cfg.seed + 1)
        gen = generator
        eps = float(torch.finfo(cdt).eps)

        def on_device(B):
            return torch.as_tensor(np.asarray(B), dtype=cdt, device=dev)

        if resume is not None:
            if int(resume["n"]) != n or int(resume["b"]) != b:
                raise ValueError(
                    f"checkpoint shape mismatch: saved (n={resume['n']}, "
                    f"b={resume['b']}) vs current (n={n}, b={b})"
                )
            if int(resume["T_ncols"]) > T.band.shape[1]:
                raise ValueError(
                    f"checkpoint Krylov prefix {resume['T_ncols']} exceeds the "
                    f"current cap {max_kryl} — raise max_kryl_dim"
                )
            AB0 = None
        else:
            # --- first iteration, unrolled ---
            with timer.section("recurrence"):
                Qnext, Bnext, Ai = _step(op, Qi, None, None, cdt=cdt,
                                         qr_method=qr_method, mesh=mesh,
                                         timer=timer)
            AB0 = torch.stack([Ai, Bnext.to(Ai.dtype)]).cpu().numpy()  # one transfer
            T.append_diag(AB0[0])
            T.set_subdiag(AB0[1], 0)
            tscale = np.abs(AB0[0]).max()
            B_last = AB0[1]  # host copy of the newest B (degenerate-cap fallback)
            Qprev, Qi, Bi = Qi, Qnext, Bnext

        # --- chunked, speculatively pipelined sweep ---
        # (a) one host read per chunk, returning all of its T blocks in a
        # single stacked copy; (b) up to cfg.pipeline_depth later chunks are
        # queued on the device before the current chunk's blocks are read, so
        # the device sweeps windows c+1.. while the host factorizes T for
        # window c; (c) chunk lengths grow geometrically (chunk_growth_cap).
        # Speculation only wastes work on the final windows (convergence) or
        # on breakdown — both rare, both handled by zeroing the speculated
        # basis columns.
        w_sel = V_sel = bounds = None
        poll_chain = {}    # previous screen, threaded through the eig worker
        converged = False
        i_max = max_kryl // b
        pr = cfg.partial_reorth_cadence
        if resume is None:
            next_poll_cols = 0  # geometric poll backoff (see the poll block)
            fine_poll = False  # near convergence: pin polls to the base cadence
            danger = False     # near-invariant-subspace reorth escalation
            selective = False  # sticky: dominant Ritz pair converged on a
            #                    spectrum with compounding dominance — harvest()
            calm_chunks = 0    # consecutive chunks clear of the danger regime
            B_hist = {1: AB0[1]}  # B_{j+1} produced at iteration j, host copies
            i = 1              # Lanczos iterations completed (host view)
            i_next = 2         # first iteration of the next chunk to dispatch
            dev_state = (Qi, Qprev, Bi)  # device-side recurrence state (dispatch order)
            pr_stretch = 1  # adaptive full-scrub stretch (adaptive_reorth_max)
        else:
            # --- restore the between-chunks invariant from a checkpoint ---
            # (stored basis = Q_1..Q_{i-1} goes into the empty store; the
            # recurrence triple is (Q_{i+1}, Q_i, B_{i+1}); T's band already
            # includes the edge subdiag written at the end of the saved chunk)
            bdt = store.buf.dtype
            basis = np.asarray(resume["basis"])
            store.load_snapshot(basis if mesh is None
                                else basis[slice(*mesh.row_range(n))])
            tc = int(resume["T_ncols"])
            T.band[:, :tc] = resume["band"][:, :tc]
            T.ncols = tc
            tscale = float(resume["tscale"])
            B_last = np.asarray(resume["B_last"], dtype=np.float64)
            B_hist = {
                int(j): np.asarray(v, dtype=np.float64)
                for j, v in resume["B_hist"].items()
            }
            i = int(resume["i"])
            i_next = i + 1
            next_poll_cols = int(resume["next_poll_cols"])
            fine_poll = bool(resume["fine_poll"])
            danger = bool(resume["danger"])
            selective = bool(resume["selective"])
            calm_chunks = int(resume["calm_chunks"])
            pr_stretch = int(resume["pr_stretch"])

            def _dev_arr(x, dt, rows=False):
                # the file holds whole (n, b) blocks: a rank keeps its rows
                x = np.asarray(x)
                if rows and mesh is not None:
                    x = x[slice(*mesh.row_range(n))]
                return torch.as_tensor(x).to(device=dev, dtype=dt)

            Qprev = _dev_arr(resume["Q_i"], bdt, rows=True)
            dev_state = (_dev_arr(resume["Q_ip1"], bdt, rows=True), Qprev,
                         _dev_arr(resume["B_ip1"], cdt))
            if (resume.get("gen_state") is not None
                    and str(resume.get("gen_device")) == gen.device.type):
                gen.set_state(torch.from_numpy(
                    np.ascontiguousarray(resume["gen_state"], dtype=np.uint8)))
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(cfg.seed + 1)
            _dbg(f"resumed sweep at i={i} ({(i - 1) * b} basis columns)")

        # Rank check of the FIRST coupling block (the chunk scan below covers
        # later steps): a start block wider than the reachable subspace makes
        # U₁ rank-deficient, and its QR seeds ghost columns into Q₂ before the
        # first chunk even launches.  The discard threshold is the ROUNDING
        # floor (~eps·‖A‖), NOT the scan's √eps·‖A‖ breakdown level; between
        # the two levels the coupling is honest but ghost-prone — danger-mode
        # reorth, no discard.
        if AB0 is not None:  # first-step path only (a resume skips iteration 1)
            if not np.all(np.isfinite(AB0)):
                raise FloatingPointError(
                    "non-finite T blocks at iteration 1 — operator output or "
                    "precision configuration is unstable "
                    f"(basis_dtype={cfg.basis_dtype}, compute_dtype={cfg.compute_dtype})"
                )
            sv0 = np.linalg.svd(AB0[1], compute_uv=False)
            thr0 = 100.0 * eps * max(tscale, np.finfo(np.float64).tiny)
            if thr0 <= sv0[-1] < np.sqrt(eps) * tscale:
                danger = True
            if sv0[-1] < thr0:
                r0 = int(np.sum(sv0 >= thr0))  # may be 0: all σ at the floor
                Q2, B_new0 = repair(Qi, AB0[1], r0)
                _dbg(f"partial breakdown at i=1: rank {r0}/{b} — repaired")
                T.set_subdiag(B_new0, 0)
                B_last = B_hist[1] = B_new0
                dev_state = (Q2, Qprev, on_device(B_new0))
                danger = True  # at an invariant subspace: every-step CGS2

    def compounds(gamma, i_at, margin=3.0):
        """Whether a ghost re-amplified ×``gamma`` per iteration, compounded
        over the iterations left after ``i_at``, lifts eps-level rounding
        above ~1% of scale (``margin``: the factor on that threshold)."""
        return (gamma > 1.0 and
                max(i_max - i_at, 0) * np.log(gamma) > margin * np.log(0.01 / eps))

    # chunks dispatched so far (drives geometric chunk growth)
    n_chunks = int(resume["n_chunks"]) if resume is not None else 0
    chunks_done = int(resume["chunks_done"]) if resume is not None else 0
    # checkpoint-policy plumbing: see RBLConfig.sweep_checkpoint_path
    ck_path = cfg.sweep_checkpoint_path
    ck_every = cfg.sweep_checkpoint_every
    abort_after = cfg.fault_inject_abort_after_chunks
    growth_cap = cfg.chunk_growth_cap

    def dispatch():
        """Queue one chunk against the current device state (async on the
        card: nothing here waits for the device)."""
        nonlocal dev_state, i_next, n_chunks
        i0 = i_next
        # Geometric chunk growth: chunks double every second eligible
        # dispatch up to chunk_growth_cap× the poll cadence.  Growth
        # requires a *calm* spectrum (≥ 2 consecutive chunks with healthy
        # ‖B‖): near the danger regime, policy flips discard every
        # in-flight chunk, so a grown speculated chunk is wasted work.
        # selective mode is sticky, so its chunks are never discarded by a
        # policy flip — growth and deep pipelining stay on (unlike danger)
        if (
            growth_cap > 1
            and not danger
            and calm_chunks >= 2
            and lock_basis is None
        ):
            grow = min(growth_cap, 2 << (n_chunks // 2))
            n_chunks += 1
        else:
            grow = 1
        S = min(cfg.eig_poll_cadence * grow, i_max - i0 + 1)
        if cfg.basis_device_cap_cols is not None:
            # the two-tier store needs ≥ 2·window + 2b device-resident
            # columns per append window (BasisStore._ensure feasibility)
            S = max(1, min(S, (cfg.basis_device_cap_cols // b - 2) // 2))
        # danger mode: ‖B‖ has collapsed toward an invariant subspace, where
        # ghost components of converged directions re-amplify by ~‖A‖/‖B‖
        # per iteration — reorthogonalize EVERY step with CGS2 against the
        # basis until ‖B‖ recovers
        if danger or selective:
            reorth_pattern = (True,) * S
        else:
            pr_eff = pr * pr_stretch
            reorth_pattern = tuple((i0 + s) % pr_eff == 0 for s in range(S))
        npass = 2 if (danger or selective) else 1
        with timer.section("sweep_dispatch"):
            store._ensure(store.ncols + S * b)
            col0 = store.ncols                  # global column
            _, Qi_n, Qprev_n, Bi_n, TB = _sweep_chunk(
                op, store.buf, *dev_state, col0 - store.dev_base, lock_basis,
                cdt=cdt, qr_method=qr_method, nsteps=S,
                reorth_pattern=reorth_pattern,
                loc_passes=cfg.loc_reorth_passes,
                reorth_passes=npass, mesh=mesh, timer=timer,
                full_scrub=(functools.partial(_tiered_full_scrub, store, timer)
                            if store.host_ncols else _full_scrub),
            )
            copy = _start_host_copy(TB)
        store.ncols = col0 + S * b
        dev_state = (Qi_n, Qprev_n, Bi_n)
        i_next = i0 + S
        return dict(i0=i0, S=S, col0=col0, TB=copy,
                    Qi=Qi_n, Qprev=Qprev_n, Bi=Bi_n,
                    danger=danger or selective, stretch=pr_stretch)

    def chunk_block(cur, s):
        """The block that step s of chunk ``cur`` wrote to the store
        (Q_{i0+s−1}), or past the chunk's end the blocks it left live:
        ``cur["Qprev"]`` at s = S, ``cur["Qi"]`` at s = S + 1."""
        if s < cur["S"]:
            return store.read_block(cur["col0"] + s * b, b)
        return cur["Qprev"] if s == cur["S"] else cur["Qi"]

    def restart_at(nxt, regrow=False):
        """Discard the sweep past iteration i (speculated chunks, a
        degenerate tail, a stale policy): rewind the store to the invariant
        "stored = Q_1..Q_{i−1}, Qprev = Q_i" (Qprev already holds Q_i) and
        drop the in-flight chunks.  ``nxt()`` gives the (Q_{i+1}, B_{i+1})
        the device recurrence restarts from (a host B is copied to the
        device); it runs after the rewind, so a re-randomization sees only
        the kept basis.  ``nxt`` None ends the sweep at i.  ``regrow``
        restarts chunk growth from the base cadence.  Returns B_{i+1} as
        ``nxt`` gave it."""
        nonlocal dev_state, i_next, n_chunks
        # tier-aware: a breakdown can target columns already offloaded
        store.rewind((i - 1) * b)
        B_new = None
        if nxt is None:
            i_next = i_max + 1  # terminal: no further dispatches
        else:
            Q_new, B_new = nxt()
            dev_state = (Q_new, Qprev,
                         B_new if torch.is_tensor(B_new) else on_device(B_new))
            i_next = i + 1
        inflight.clear()
        if regrow:
            n_chunks = 0
        return B_new

    # Full eig factorizations run in a worker thread (LAPACK releases the
    # GIL), overlapped with the next chunk's transfer + screening + device
    # sweep.  Convergence is then detected one chunk late; the extra chunk
    # is rewound exactly like a mispredicted speculation.
    pending = None  # in-flight poll: dict(future, i_poll, B_snap, Qprev)
    executor = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="rbl-eig"
    )

    def harvest(block: bool) -> None:
        """Collect a finished (or, if block, in-flight) eig poll; on
        convergence rewind everything past the poll's basis prefix."""
        nonlocal pending, w_sel, V_sel, bounds, converged, Qprev
        nonlocal fine_poll, next_poll_cols, selective
        if pending is None:
            return
        if not block:
            done = pending["future"].done()
            # The poll's finish is a wall-clock race that differs between
            # ranks: one rank harvesting (and rewinding, or stopping) while
            # another runs on would leave a collective unanswered.  Under a
            # mesh the ranks harvest only when every rank's poll is done.
            if mesh is not None:
                done = mesh.agree(done)
            if not done:
                return
        with timer.section("eig_wait"):
            w_scr, w_old, full, _ = pending["future"].result()
        for name, t0, t1, thread in pending["spans"]:
            timer.record(name, t0, t1, thread)  # the screen and factorization
        if pending["on_card"]:
            timer.add("eig_on_card", 1)
        if not selective and len(w_scr) > 1:
            mx = abs(w_scr[-1])
            gamma = mx / max(abs(w_scr[0]), np.finfo(np.float64).tiny)
            # Immediate tier: at extreme dominance the ghost of the top
            # pair reaches O(1) within ~10 iterations of its convergence —
            # waiting for two stable screens is already too late.  Trigger
            # on the first screen when the compounding margin is ≥ 3× the
            # threshold; a false positive merely costs extra reorth.
            if compounds(gamma, pending["i_poll"]):
                selective = True
            # Selective-orthogonalization trigger (Parlett–Scott flavored,
            # from Ritz VALUES alone).  Once the dominant Ritz value has
            # stabilized to its eps-level noise floor, its eigenvector is
            # nearly converged and ghost components of it re-amplify
            # ≈ |θ|max/|θ|min per iteration; when that growth compounded
            # over the remaining sweep can lift eps-level rounding noise
            # above ~1% of scale, cadence-2 single-pass reorth loses the
            # basis.  Sticky: converged directions stay in the basis.
            elif (w_old is not None and len(w_old) == len(w_scr) and mx > 0
                  and abs(w_scr[-1] - w_old[-1]) <= 10.0 * eps * mx
                  and compounds(gamma, pending["i_poll"], margin=1.0)):
                selective = True
                _dbg(f"selective ON (stable-max) at poll panel "
                     f"{pending['i_poll']}: gamma={gamma:.3g}")
        if full is not None:
            w_sel, V_sel = sort_eig_abs(full[0], full[1], k)
            bounds_now = ritz_residual_bounds(
                np.asarray(pending["B_snap"]), np.asarray(V_sel[:, :k]), b
            )
            if not fine_poll and np.mean(bounds_now <= cfg.tol) >= 0.25:
                # a meaningful fraction of the Ritz pairs already meets the
                # residual bound: the convergence window is near.  Pin polls
                # back to the base cadence — the geometric stride can step
                # clean over the window.
                fine_poll = True
                next_poll_cols = fine_poll_reset_cols(
                    next_poll_cols, pending["i_poll"], b,
                    cfg.eig_poll_cadence,
                )
            if bool(np.all(bounds_now <= cfg.tol)):
                bounds = bounds_now
                converged = True
                Qp = pending["Qprev"]
                if Qp is None:
                    # mid-chunk poll: Q_{i_poll} lives in the basis store
                    # (read before the rewind truncates it away)
                    Qp = store.read_block((pending["i_poll"] - 1) * b, b)
                store.rewind((pending["i_poll"] - 1) * b)
                Qprev = Qp
        pending = None

    # In-flight chunk pipeline: up to cfg.pipeline_depth chunks are queued
    # ahead of the one whose T blocks the host reads next.
    inflight: deque = deque()

    def top_up():
        # deep speculation only on a calm spectrum: near the danger regime
        # every policy flip discards all in-flight chunks (see dispatch)
        depth = cfg.pipeline_depth if (not danger and calm_chunks >= 2) else 1
        while len(inflight) < max(1, depth) and i_next <= i_max and not converged:
            inflight.append(dispatch())

    try:
        top_up()
        while inflight:
            cur = inflight.popleft()
            top_up()  # keep the pipeline full while we block on cur's TB
            with timer.section("transfer"):
                TB = _finish_host_copy(cur["TB"])  # (2S, b, b): [A_s, B_s] pairs
            with timer.section("chunk_scan"):
                i0, S = cur["i0"], cur["S"]
                if not np.all(np.isfinite(TB)):
                    # numerical health check (SURVEY §5: the reference has no
                    # failure detection) — the T blocks cross to the host anyway
                    raise FloatingPointError(
                        f"non-finite T blocks at iterations {i0}..{i0 + S - 1} — "
                        "operator output or precision configuration is unstable "
                        f"(basis_dtype={cfg.basis_dtype}, compute_dtype={cfg.compute_dtype})"
                    )
                # host-side T assembly + breakdown scan.  Step s is iteration
                # j = i0+s; it consumed (Q_j, Q_{j-1}, B_j), wrote Q_{j-1} to
                # the basis, and produced (A_j, B_{j+1}).
                collapse_at = None
                partial_at = None   # first step whose coupling block lost rank
                partial_rank = 0    # its number of healthy singular directions
                danger_at = None  # first mid-chunk step entering the danger regime
                chunk_min_sv = np.inf  # min σ_min(B_s) over this chunk
                chunk_scale = 0.0  # max |A_s| over this chunk: the ACTIVE
                # Rayleigh scale.  Breakdown/danger thresholds compare ‖B‖
                # against THIS, not the historical tscale: once a dominant
                # direction is captured, tscale stays at |λ|max while the live
                # sweep works at the bulk scale.
                explosion_at = None  # first step whose ‖B‖ exceeds the ‖A‖ bound
                for s in range(S):
                    A_s, B_s = TB[2 * s], TB[2 * s + 1]
                    if np.abs(B_s).max() > 10.0 * max(tscale, np.abs(A_s).max()):
                        # ‖B_{j+1}‖ ≤ ‖A‖ for any orthonormal basis — a larger
                        # value means the dtype's precision floor has crossed
                        # the active spectral scale: no further directions are
                        # resolvable in this precision.  Discard this step too.
                        explosion_at = s
                        break
                    B_hist[i0 + s] = B_s
                    T.append_diag(A_s)
                    a_s = np.abs(A_s).max()
                    tscale = max(tscale, a_s)
                    chunk_scale = max(chunk_scale, a_s)
                    if np.abs(B_s).max() < np.sqrt(eps) * max(a_s, tscale * eps):
                        collapse_at = s  # B_{j+1} ≈ 0: steps after s are noise
                        break
                    B_svals = np.linalg.svd(B_s, compute_uv=False)
                    chunk_min_sv = min(chunk_min_sv, B_svals[-1])
                    # Partial-collapse discard threshold: the ROUNDING floor,
                    # not the √eps breakdown level — an honest-but-small σ must
                    # stay in T; between the levels the hysteresis below
                    # escalates to danger reorth.
                    rank_thr = 100.0 * eps * max(tscale, np.finfo(np.float64).tiny)
                    if B_svals[-1] < rank_thr:
                        # PARTIAL rank collapse: the QR has already
                        # orthonormalized ghost noise into the dead columns (see
                        # _repair_block).  Steps after s consumed the
                        # poisoned block.
                        partial_at = s
                        partial_rank = int(np.sum(B_svals >= rank_thr))
                        break
                    if (
                        not selective
                        and not cur["danger"]
                        and s < S - 1
                        and tscale > 10.0 * a_s
                    ):
                        # Per-STEP dominance transition: the active Rayleigh
                        # scale just dropped an order of magnitude below the
                        # captured top — the dominant direction converged THIS
                        # chunk, and its ghost re-amplifies ×γ per iteration.
                        # Truncate at the transition and resume in selective
                        # mode.
                        gp = tscale / max(a_s, np.finfo(np.float64).tiny)
                        if compounds(gp, i0 + s):
                            danger_at = s
                            selective = True
                            _dbg(
                                f"selective ON (step-scale) at i={i0 + s}: "
                                f"gamma≈{gp:.3g}"
                            )
                            break
                    if (
                        not cur["danger"]
                        and np.abs(B_s).max() < 1e-2 * a_s
                        and s < S - 1
                    ):
                        # ‖B‖ entered the ghost re-amplification regime
                        # mid-chunk, and the rest of the chunk ran under the
                        # calm cadence-2 policy.  Truncate processing here; the
                        # handler below rewinds to this step and resumes in
                        # danger mode.
                        danger_at = s
                        break
                    if s < S - 1:
                        T.set_subdiag(B_s, i0 + s - 1)
                done = S
                for stop in (collapse_at, danger_at, partial_at):
                    if stop is not None:
                        done = stop + 1
                        break
                if explosion_at is not None:
                    done = explosion_at  # step s itself is discarded
                i = i0 + done - 1
                B_last = (
                    TB[2 * (done - 1) + 1] if done >= 1 else np.asarray(B_hist[i])
                )
                # Q_i: the chunk-end Qprev, or read back from the store before
                # a handler below rewinds past a stop
                Qprev = chunk_block(cur, done)

                if explosion_at is not None:
                    # Precision exhaustion (see the scan): restore the invariant
                    # at the last valid iteration and either finish with the
                    # basis in hand or re-randomize and keep sweeping if the
                    # basis is still smaller than k.
                    if i * b >= k:
                        _dbg(
                            f"precision exhaustion at i={i}: terminating sweep "
                            f"(‖B‖ exceeded 10·tscale={tscale:.3g})"
                        )
                        restart_at(None)
                    else:
                        # the honest coupling to the re-randomized block is zero
                        restart_at(lambda: (fresh(), torch.zeros_like(cur["Bi"])))

                if collapse_at is not None:
                    # Breakdown: an (almost) invariant subspace was hit — the
                    # reference has no handling for this (SURVEY §5).  Discard
                    # the degenerate tail and the speculated chunk, and replace
                    # the dead block with fresh orthogonalized randomness.  T
                    # keeps the honest (tiny) B out of its band.
                    restart_at(lambda: (fresh(), B_last))

                if partial_at is not None or danger_at is not None:
                    # Partial rank collapse at iteration i (keep the healthy
                    # singular directions of the coupling block exactly,
                    # re-randomize the dead ones with zero coupling; see
                    # _repair_block), or a mid-chunk danger onset (see the
                    # scan): discard the later steps of this chunk, which
                    # consumed the poisoned block or ran under the stale calm
                    # policy, and the speculated chunks, and resume at i with
                    # every-step CGS2 reorth.  Q_{i+1} was written to the basis
                    # by a discarded later step (or is the chunk-end Qprev).
                    Q_ip1 = chunk_block(cur, done + 1)
                    if partial_at is not None:
                        B_last = B_hist[i] = restart_at(
                            lambda: repair(Q_ip1, TB[2 * partial_at + 1], partial_rank),
                            regrow=True,
                        )
                        _dbg(
                            f"partial breakdown at i={i}: rank {partial_rank}/{b} "
                            f"(σ_min={B_svals[-1]:.3g}) — repaired"
                        )
                    else:
                        restart_at(lambda: (Q_ip1, B_last), regrow=True)
                    # A rank-deficient residual means the sweep is AT an
                    # invariant subspace, where the repaired random directions
                    # re-excite converged eigendirections through A; a danger
                    # onset is the ghost regime.  Every-step CGS2 until the
                    # spectrum calms.
                    danger = True
                    calm_chunks = 0

                # danger-mode hysteresis: enter every-step CGS2 reorth while any
                # ‖B_s‖ sits below 1e-2·tscale (ghost re-amplification regime);
                # leave only after 3 consecutive chunks clear of 1e-1·tscale —
                # danger reorth itself restores ‖B‖, so an eager exit
                # oscillates, and every policy flip discards the speculated
                # chunk.
                min_B = min(
                    (float(np.abs(TB[2 * s + 1]).max()) for s in range(done)),
                    default=None,
                )
                # σ_min in the ghost-prone band (above the partial-collapse
                # rounding floor, below the √eps breakdown level): an honest
                # but nearly-converged interior direction — its ghost
                # re-amplifies like any converged direction, and the max-entry
                # min_B test cannot see it inside a healthy block.  The danger
                # mode this triggers persists DELIBERATELY while σ_min stays in
                # the band (the calm exit below IS a σ_min-recovery test).
                sv_ghostly = chunk_min_sv < np.sqrt(eps) * max(
                    chunk_scale, tscale * eps
                )
                if min_B is None:
                    pass  # empty chunk (explosion at step 0): keep current mode
                elif min_B < 1e-2 * chunk_scale or sv_ghostly:
                    if not danger:
                        _dbg(f"danger ON at i={i}: min|B|={min_B:.3g} "
                             f"min sv={chunk_min_sv:.3g} "
                             f"active scale={chunk_scale:.3g}")
                    danger = True
                    calm_chunks = 0
                elif min_B > 1e-1 * chunk_scale:
                    calm_chunks += 1
                    if calm_chunks >= 3:
                        danger = False
                else:
                    calm_chunks = 0
                if not selective and chunk_scale > 0 and compounds(tscale / chunk_scale, i):
                    # Chunk-stats selective trigger (no poll needed): once the
                    # sweep's ACTIVE Rayleigh scale has dropped below the
                    # historical tscale, converged dominant directions exist and
                    # their ghosts re-amplify by ≈ tscale/active per iteration.
                    # 3× margin like the immediate poll tier.
                    selective = True
                    _dbg(f"selective ON (chunk-stats) at i={i}: "
                         f"gamma≈{tscale / chunk_scale:.3g}")
                if cfg.adaptive_reorth_max > 1:
                    # Adaptive full-scrub stretch: double the interval per calm
                    # chunk; snap back to base on ANY risk signal.
                    calm_for_stretch = (
                        not danger and not selective and lock_basis is None
                        and not fine_poll and calm_chunks >= 3
                        and min_B is not None
                        and chunk_min_sv >= 0.1 * chunk_scale
                        and tscale <= 2.0 * chunk_scale
                    )
                    pr_stretch = (
                        min(pr_stretch * 2, cfg.adaptive_reorth_max)
                        if calm_for_stretch else 1
                    )
                if inflight and (inflight[0]["danger"] != (danger or selective)
                                 or inflight[0]["stretch"] > pr_stretch):
                    # a speculated chunk dispatched under the other policy, or
                    # under a STRETCHED cadence after the stretch snapped back
                    # (fewer scrubs than the risk now demands) — discard it
                    restart_at(lambda: (cur["Qi"], cur["Bi"]), regrow=True)

                # Convergence polls (reference cadence RBL.jl:106; immediately
                # on breakdown — the Krylov space is nearly invariant then).
                # Every poll runs on the eig worker thread (values-only screen
                # gating the full factorization — see _poll_task) overlapped
                # with device sweeps, and polls back off geometrically.
                #
                # Polls are DECOUPLED from chunk boundaries: the chunk's TB
                # carries every per-step T block, so T can be factorized at any
                # panel prefix j ≤ i — a grown chunk does not coarsen the poll
                # schedule (convergence lives in a window).
                force_poll = (
                    i >= i_max or collapse_at is not None or explosion_at is not None
                )
                polled = False

                def submit_poll(j):
                    """Queue a poll of T's j-panel prefix on the eig worker, and
                    advance the backoff schedule."""
                    nonlocal pending, next_poll_cols, polled
                    snapshot = T.view(j * b).copy()  # T keeps growing under the thread
                    if j == i:
                        B_snap, Qp = B_last, Qprev
                    else:
                        # prefix poll: the coupling block B_{j+1} from the
                        # host-side history; Q_j is read from the basis store
                        # only if this poll converges
                        B_snap, Qp = B_hist[j], None
                    spans = []  # the worker's stamps, recorded at the harvest
                    bk = (last_eig_backend(eig_bk, dev, mesh, j * b)
                          if i >= i_max and j == i else eig_bk)
                    pending = dict(
                        future=executor.submit(
                            _poll_task, snapshot, k, bk, dev, poll_chain, cfg.tol,
                            poll_chain.get("w") is None or (force_poll and j == i),
                            spans,
                        ),
                        spans=spans,
                        on_card=bk != eig_bk,
                        i_poll=j,
                        B_snap=B_snap,
                        Qprev=Qp,
                        npanels=j,
                    )
                    next_poll_cols = j * b + poll_stride_cols(
                        j, b, cfg.eig_poll_cadence, fine_poll
                    )
                    polled = True

                if i * b > k:
                    while next_poll_cols <= i * b and not converged:
                        harvest(block=True)  # at most one poll in flight
                        if converged:
                            break
                        # fine_poll may have just flipped — next_poll_cols reflects it
                        if next_poll_cols > i * b:
                            break
                        submit_poll(poll_panel_for(next_poll_cols, i, b, k))
                    if (
                        force_poll
                        and not converged
                        and (pending is None or pending["i_poll"] < i)
                    ):
                        harvest(block=True)
                        if not converged:
                            submit_poll(i)
                if converged:
                    break
                if not polled:
                    harvest(block=False)
                    if converged:
                        break
                if collapse_at is None and explosion_at is None:
                    T.set_subdiag(B_last, i - 1)
                chunks_done += 1
                handler_fired = any(
                    x is not None
                    for x in (collapse_at, danger_at, partial_at, explosion_at)
                )
                if ck_path and not handler_fired and chunks_done % ck_every == 0:
                    # Clean chunk boundary: the invariant state is exactly what
                    # resume needs — basis prefix Q_1..Q_{i-1}, the triple
                    # (Q_{i+1}, Q_i, B_{i+1}) from THIS chunk's snapshot
                    # (``dev_state`` may already hold speculated later state),
                    # T including the edge subdiag just written, and the
                    # policy flags.  The basis prefix is read on the host, so
                    # the save waits for the device.
                    from ..utils.checkpoint import save_sweep_state

                    with timer.section("checkpoint"):
                        save_sweep_state(ck_path, dict(
                            n=n, b=b, k=k, i=i, chunks_done=chunks_done,
                            n_chunks=n_chunks,
                            T_ncols=T.ncols, band=T.band[:, : T.ncols],
                            basis=store.snapshot((i - 1) * b),
                            Q_ip1=cur["Qi"], Q_i=cur["Qprev"], B_ip1=cur["Bi"],
                            tscale=float(tscale), B_last=B_last, B_hist=B_hist,
                            danger=danger, selective=selective,
                            calm_chunks=calm_chunks, pr_stretch=pr_stretch,
                            fine_poll=fine_poll, next_poll_cols=next_poll_cols,
                            # the JAX package reads ``key`` on resume: the
                            # threefry key it would itself start from
                            key=np.array([0, (cfg.seed + 1) & 0xFFFFFFFF],
                                         dtype=np.uint32),
                            gen_state=gen.get_state().numpy(),
                            gen_device=gen.device.type,
                        ), mesh=mesh)
                if abort_after is not None and chunks_done >= abort_after:
                    raise SweepAborted(
                        f"fault injection: aborting after {chunks_done} processed "
                        f"chunks (i={i})"
                    )
                top_up()

        final_panels = None if pending is None else pending["npanels"]
        # the last poll, waited for, and at the cap the serial factorization
        with timer.section("eig_last"):
            harvest(block=True)
            if w_sel is not None and not converged and final_panels is not None:
                # the final poll may have produced only a screen; its stale
                # V_sel (from an earlier, shorter T) must not masquerade as
                # the final factorization
                final_panels = (final_panels if V_sel.shape[0] == final_panels * b
                                else None)

            # the newest block Q_i completes the basis (cols = i·b); on the
            # converged path this mirrors the reference's final push
            # (RBL.jl:113), on the cap path its final append before recovery
            store.append(Qprev)

            if converged:
                # a prefix poll may have converged mid-chunk: the harvest
                # rewound the store to the poll's panel prefix, so the
                # chunk's iteration counter overstates the basis.  nblocks
                # must match V_sel's rows.
                i = store.ncols // b

            if not converged:
                # Cap reached: final Rayleigh–Ritz with everything we have
                # (unless the final async poll already factorized the full T).
                i_final = store.ncols // b
                if final_panels != i_final or w_sel is None:
                    bk = last_eig_backend(eig_bk, dev, mesh, store.ncols)
                    with timer.section("eig"):
                        w_sel, V_sel = _factorize(T.view(store.ncols), k, bk, dev)
                    if bk != eig_bk:
                        timer.add("eig_on_card", 1)
                bounds = ritz_residual_bounds(np.asarray(B_last), V_sel, b)
                i = i_final
    finally:
        executor.shutdown(wait=True)

    return w_sel, V_sel, T, np.asarray(bounds) if bounds is not None else None, converged, i
