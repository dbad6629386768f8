#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rbl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, compares
each kernel entry point with its plain PyTorch version on the card, then
drives the port's paths — ``rbl_tpu_torch.rbl`` — through the entry points
a user calls, and checks the answers:

  1. the card's name and power limit, torch's and CUDA's versions;
  2. the kernel build (csrc/*.cu → rbl_tpu_torch/build/, one nvcc each);
  3. packed kernel (B1/B2) against plain version, f32 and f64, on the
     packed arrays of the assembled 3-D elasticity matrix
     fem_elasticity_3d(42) (n = 232,974, 18.0 M nonzeros) at b = 8
     (resident entry point) and b = 16 (streaming entry point), and on a
     small matrix with ragged edges; per-apply times (CUDA events, median
     of 20);
  4. rbl on the 512² Laplacian with bench.py's configuration, held to
     bench.py's analytic check (max relative error < 0.025);
  5. rbl on fem42 (format="bsr") at k = 100, b = 8 and b = 16 (f32), held
     to the first 90 ARPACK eigenvalues (benchmarks/groundtruth/
     fem42_lm_k100.npz) within 1e-2 relative, with the kernel launch
     counts of the run;
  6. the blocked-ELL (B3) and panel (B4) kernels against their plain
     versions, f32 (1e-5) and f64 (1e-12): B3 on fem42's blocked-ELL at
     bm = 128 (b = 8, 16), B4 on fem42's panel layout of the auto plan
     (b = 8, f32 and f64), both on the ragged matrix at b = 5, 8, 16, 40,
     and B4 on a gappy ragged matrix at bk 32/64/128, b = 1, 8, 33, with
     block-rows given no chunk (hcount 0) and rows deeper than its ring;
     per-apply times beside the plain version, torch.sparse CSR and the
     bound (B3 at b = 16 too, recorded as its row's b16_* keys; B4 beside
     B1 on the same plan and, in f32, B7 over the same bytes, its f64
     numbers as f64_* keys); the register block and ring of
     csrc/bsr_spmm.cu and the plan of csrc/bsr_spmm_panel.cu for each
     timed shape; then B4 on fem42 at bk 32, 64 and 128 (each on
     pick_tile_plan's plan, f32, b = 8: stored MB, fill, B4, B1, CSR,
     share of the bound; the row's bk_sweep key).  B3's entry point,
     which no solve calls, checks phase 5's fem42 Ritz vectors (A·V
     against torch.sparse CSR, and the true residuals);
  7. rbl on fem42 through BlockSparseOperator.from_scipy(..., panel=True)
     (k = 100, b = 8, f32), held to the ARPACK head, with B4's launches;
  8. the same fem42 solve through format="dia", "ell", "hyb", "coo" and
     "auto", each held to the ARPACK head; the route "auto" took;
  9. rbl (format="auto", which must pick HYB) on a Chung-Lu power-law
     graph (n = 262,144, mean degree 16, Pareto weights of exponent 2.1),
     k = 20, b = 8, tol 1e-3, f32, held to scipy's eigsh within 1e-3;
 10. the tile-stream probes B5-B7 (rbl_tpu_torch.benchmarks.
     dma_stream_bench): (a) each kernel against its plain version, held to
     1e-5 · Σ|terms| per entry, at 256 MB of vals for (bm, U) = (16, 8) and
     (128, 8), at ragged chunk counts (1, 2, 3, 100, 1001; chunks taller
     than a ring stage) and on fem42's packed vals; (b) the probe's sweep
     over its default configurations and the card's plan for fem42; (c)
     the three variants over fem42's own packed vals (phase 3's plan), each
     beside B1's (b = 8) and B2's (b = 16) times on that plan, timed the
     same way, and their excess over it;
 11. the pinned-host basis tier: the phase-5 fem42 solve (k = 100, b = 8,
     f32, tol 1e-3, cap 1400) with basis_device_cap_cols=256: the Krylov
     dimension must pass 256 and at least one pinned panel be written, the
     head 90 meet phase 5's gate and agree with phase 5's uncapped solve
     within 1e-4 relative, and max |VᵀV − I| over the Ritz vectors stay
     under 1e-3; the solve's time beside the uncapped one, the panels and
     the bytes moved each way;
 12. the sweep checkpoint: the same solve with sweep_checkpoint_path in a
     temporary directory, sweep_checkpoint_every=3 and an injected abort
     after 3 chunks raises SweepAborted and leaves the file; the same call
     without the abort resumes, ends as the uninterrupted solve did,
     removes the file and agrees with it within 1e-3 relative on the head
     90; once more through the host tier (cap 256);
 13. rbl_restarted on fem42 (k = 20, b = 8, f32, restart_kryl_dim=200,
     tol 1e-3) with checkpoint_path, and once more cut after one restart
     and resumed from load_restart_state; both held to the ARPACK head;
 14. rbl_polished on the 512² Laplacian in bench.py's at-1e-7
     configuration (k = 50, b = 8, f64, cholqr2, poll cadence 16,
     bounds=(0, None)), held to the analytic spectrum within 1e-9 relative
     with every residual ≤ 1e-7, and on fem42 (k = 20, b = 8, f64 tiles
     through the packed kernel; residuals ≤ 1e-7·‖A‖);
     rbl_filtered(which="LA") on the Laplacian (k = 50) against the same
     spectrum;
 15. rbl_svd of a seeded dense 20,000 × 2,000 f64 matrix with singular
     values 0.9^i (k = 20) and of a seeded sparse 200,000 × 50,000 matrix
     with 10 nonzeros a row and decaying column scales (k = 10), against
     scipy.sparse.linalg.svds (1e-8 and 1e-6 relative) and by
     ‖B·V − U·diag(s)‖;
 16. shift-invert on the 512² Laplacian: rbl (k = 4, b = 4) on
     ShiftInvertOperator.shift(Laplacian2D(512, 512), σ) through the exact
     FDM solve at σ = 0 in f64 and f32, through the multigrid-preconditioned
     MINRES (precond="mg") in f64, and through FDM at an interior σ between
     two eigenvalues (the 4 nearest); eigenvalues by Rayleigh quotients with
     A in f64 against the analytic spectrum (1e-9 relative in f64, 1e-4 in
     f32), with each run's inner MINRES iterations an apply;
 17. the FEM vibration problem K·x = λ·M·x: K = fem_elasticity_3d(42), M
     its lumped mass (each node's share of its adjacent hexes, over the 3
     dofs), rbl_generalized(K, M, k = 8, b = 8, σ = 0, f64, tol 1e-6) with
     AssembledMultigrid.from_grid(K, (42, 43, 43), dof=3).psolve as the
     inner preconditioner, held to ‖K·x − λ·M·x‖ ≤ 1e-6·‖K‖ and
     M-orthonormality; the same on fem_elasticity_3d(16) with from_grid and
     with smoothed_aggregation, each within 1e-8 of scipy's factorized
     eigsh(K, 8, M, sigma=0) on the host; the AMG set-up's host seconds,
     each level's n, nonzeros and route, inner iterations a solve, B1/B2
     launches.  Then both packed entry points against the plain version at
     b = 8 on fem42 in f64 and on every AMG level routed to BSR, f32 and
     f64, timed (the ``path_shapes`` of their kernel rows);
 18. rbl_svd(which="SM"): a seeded dense 20,000 × 2,000 f64 matrix with
     singular values 1 + 9·√t over [1, 10] (k = 10) against
     svds(which="SM") within 1e-8, and phase 15's sparse factor (k = 5)
     held by ‖B·V − U·diag(s)‖ and ‖Bᵀ·U − V·diag(s)‖;
 19. rbl_tpu_torch.eigsh(A, k=100) on fem42's f64 CSR with scipy's defaults
     (which="LM", tol=0 → 1e-7), the reference's own ARPACK comparison:
     numpy out, ascending, held to the ARPACK head within 1e-2, with the max
     true residual ‖A·v − λ·v‖ (on the card), the wall and the packed
     kernel's launches; once more with return_eigenvectors=False, in scipy's
     order (ascending |λ|);
 20. the three eig backends ("banded_host", "native", "device") on phase
     4's lap2d_512_k50_b16 and phase 5's fem42_k100_b8, each held to its
     solve's gate, with the seconds of a factorization (the Timer's
     "eig_poll" and "eig" sections over their count);
 21. eigsh(K, 8, M=M, sigma=0) on phase 17's fem3d-16 within 1e-8 of
     scipy's factorized eigsh, with the smoothed-aggregation AMG that
     eigsh's auto route builds for it, built once and passed as inner_psolve;
     svds(B, k=10) and svds(B, k=10, which="SM") on phases 15's and 18's
     dense factors within 1e-8 of rbl_svd's values (tol 1e-10), ascending;
 22. fem3d-16 written to a .mtx file: the native reader (csrc/host/mmio.cpp)
     and scipy.io.mmread give equal matrices, with both read times; one
     fem42 b=8 apply inside rbl_tpu_torch.utils.profiling.trace(), whose
     exported Chrome trace must hold csrc/bsr_spmm.cu's kernel as a device
     event;
 23. the row mesh (rbl_tpu_torch.parallel) on fem_elasticity_3d(47)
     (n = 324,864, f32, pick_tile_plan's plan): (a) one rank over NCCL in
     this process: one ShardedBlockSparseOperator apply (X of 10.4 MB:
     B2) equal bit for bit to BlockSparseOperator.apply on the same plan,
     B2 on the whole against its plain version, torch.sparse CSR and the
     bound, and the k = 100, b = 8, tol 1e-3, cap 1,400 solve sharded and
     unsharded from the same generator (head 90 within 1e-5), with both
     walls, the mesh layer's overhead and B2's launches; (b) two ranks
     sharing the card over gloo, spawned as ``chip_smoke.py --mesh-worker``
     with a timeout, reading fem47's CSR from one temporary .npz: each
     rank's band apply (X of ~5.4 MB with its ghost blocks: B1) within
     1e-5 of (a)'s rows, B1 on the band against its plain version, CSR of
     the band's nonzeros and the bound, the fem47 solve bitwise equal on
     both ranks with the head 90 within 1e-5 of (a), and
     lap2d_512_k50_b16 through ShardedLaplacian2D under bench.py's gate;
     the transport (gloo, host-staged point-to-point) and the collectives
     a solve.  A rank's failure or a timeout fails the script.
 24. the last two mesh paths.  First, outside the counted window, the
     unsharded references: phase 17's vibration solve on
     fem_elasticity_3d(47) (k = b = 8, σ = 0, f64, tol 1e-6, M lumped)
     with the grid AMG, eigsh(fem47, k=100) at scipy's defaults and
     svds(k=10) on phase 21's LM factor; then one NCCL rank's sharded K
     (a ShardedBlockSparseOperator) and AssembledMultigrid.from_grid(K,
     dims, mesh=, op0=K_sh), one all-reduce a V-cycle, ms a V-cycle on each
     side.  The counted window runs the mesh paths alone: (a) the fem47
     solve on one rank with the mesh V-cycle inner: eigenvalues within
     1e-10 of the unsharded solve's, true residuals ≤ 1e-6·‖K‖ and
     |XᵀMX − I| < 1e-8 on both; MINRES iterations and all-reduces a solve;
     fem_elasticity_3d(31)'s solve on one rank, stopped at a Krylov
     dimension of 48; (b) eigsh(fem47, k=100) with cfg.mesh on one rank:
     whole numpy arrays, eigenvalues equal bit for bit to the unsharded;
     (c) svds with cfg.mesh on one rank: s within 1e-8, U and Vh whole and
     orthonormal to 1e-8; then two gloo ranks sharing the card
     (``chip_smoke.py --scipy-mesh-worker``, 300 s timeout): B1 on each
     fem31 f64 band, fem31's vibration solve under the same cap
     (eigenvalues bitwise equal on both ranks, within 1e-8 of one rank's),
     eigsh(fem47, k=100) (eigenvalues and whole vectors bitwise equal on
     both ranks, head 90 within 1e-5 of one rank's) and the svds (s, U and
     Vh bitwise equal, s within 1e-8 of one rank's).  Then B2 on fem47's K
     (f64 b=8, one rank) and both entry points on the mesh hierarchy's
     replicated BSR levels against the plain version, timed.
 25. the port's examples through their ``main``, as a user runs them on
     the card: examples/torch_benchmark.py on fem_elasticity_3d(42) (k =
     100, one sweep at b = 4 and one at b = 8, tol 1e-3, f32, two repeats:
     cold and warm walls), each solve's head 90 within 1e-2 of the ARPACK
     ground truth, each sweep on BSR and launching B1, and on the 512²
     Laplacian (k = 50, b = 16) within bench.py's 0.025 of the
     analytic spectrum; examples/torch_images.py at its defaults (480 ×
     640, rank 50, f64): σ within 1e-8 of numpy's SVD, the relative
     Frobenius error within 1e-6 relative of the exact truncation's;
     examples/torch_generalized.py at its defaults (n = 2,000, k = 6): the
     vibration and mode-3 eigenvalues within 1e-8 of dense
     scipy.linalg.eigh(K, M), the buckling values within 1e-6 of the dense
     oracle, the 3-D grid-AMG solve's residual ≤ 1e-6·‖A‖; B1's
     launches by example.  Then both entry points against the plain
     version, timed, on each fem42 sweep's operator at its b and on every
     BSR level of the 3-D hierarchy at the 3-D solve's b = 4;
 26. the JAX package's exact-spectrum gates on the card, at its own
     tolerances (the cases of tests/_torch_gates.py, which the CPU tests
     run too): tests/test_spectra.py's 11 (1e-13), the fuzz shapes at
     seeds 0 and 1 and with adaptive_reorth_max=4, the narrow window, the
     slow separation, the negative dominant case and the host-offload
     shapes (pinned panels; 1e-10), the sparse operators against eigsh,
     f32 exhaustion (top 10, 1e-3), the restarted shapes (1e-10), then
     which="LA" (1e-9), "SA" (1e-8), deflate= (1e-10) and the two
     ValueError checks; one line a group with its count, worst error and
     wall.

Phases 11-14, 17, 19, 20 and 22 launch B1/B2 through BlockSparseOperator.apply.
Phase 14's fem42 polish applies A to k + buffer + random columns at once
(48 here), in f64 and in f32 filter chains, so after it both packed entry
points are held against the plain version on fem42 at that width, f32 and
f64, and timed, beside torch.sparse CSR at 48 and 90 columns.  In the
kernels' record ``launches`` is the count of the path the row's times were
taken on (phases 4-5 for B1/B2) and ``launches_by_phase`` holds every
path's own count; phases 11-13, 17, 20 and 22 must launch B1, phase 14
both B1 (its f32 coarse sweep) and B2, phase 19 one of them, phase 23
B2 (one rank) and B1 (each of two ranks), and phase 24 both B1 (the
replicated levels) and B2 (fem47's K) on one rank and B1 on two
(``launches_by_phase["24 (2 ranks)"]``), and phase 25 B1.  After
phase 17 each BSR level's product is also timed through torch.sparse CSR
(the level's nonzeros), and after phase 14 both entry points are timed at
90 columns too.  The last two lines are the kernels' JSON
record and the JSON result.  Any
failure raises, and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GROUNDTRUTH = os.path.join(ROOT, "benchmarks", "groundtruth", "fem42_lm_k100.npz")
# kernel → (source, the TPU kernel it replaces: function definition)
KERNELS = {
    "bsr_spmm_packed_resident": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                                 "rbl_tpu/ops/spmm/pallas_bsr.py:418"),
    "bsr_spmm_packed": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                        "rbl_tpu/ops/spmm/pallas_bsr.py:182"),
    "bsr_spmm": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                 "rbl_tpu/ops/spmm/pallas_bsr.py:80"),
    "bsr_spmm_panel": ("rbl_tpu_torch/csrc/bsr_spmm_panel.cu",
                       "rbl_tpu/ops/spmm/pallas_bsr.py:296"),
    "dma_stream": ("rbl_tpu_torch/csrc/dma_stream.cu",
                   "benchmarks/dma_stream_bench.py:65"),
    "dma_stream_dot": ("rbl_tpu_torch/csrc/dma_stream.cu",
                       "benchmarks/dma_stream_bench.py:83"),
    "dma_stream_manual": ("rbl_tpu_torch/csrc/dma_stream.cu",
                          "benchmarks/dma_stream_bench.py:130"),
}
TOL = {"float32": 1e-5, "float64": 1e-12}  # max |Y - Y_plain| / max |Y_plain|
# NVIDIA H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s
# and float32 FMA-unit operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Median per-call device time of ``fn`` (CUDA events), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM bandwidth, or the float32
    operations over the FMA units' peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sparse_need(vals, n: int, b: int) -> tuple[int, int]:
    """The bytes and operations a product of the n×n matrix whose nonzeros
    the tiles ``vals`` hold with ``b`` columns needs, whatever the layout:
    each nonzero's value and int32 column index read once, X read once, Y
    written once; two operations a nonzero and column.  The tiles' zero
    padding is neither bytes nor work the matrix needs."""
    import torch

    nnz = int(torch.count_nonzero(vals))
    es = vals.element_size()
    return nnz * (es + 4) + 2 * n * b * es, 2 * nnz * b


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(label: str, kernel, plain, dtype):
    """Run a kernel call and its plain version on the same card tensors;
    raises beyond the tolerance.  Returns (max abs error, relative error)."""
    import torch

    Y = kernel()
    Yp = plain()
    torch.cuda.synchronize()
    abs_err = float((Y - Yp).abs().max())
    rel = abs_err / max(float(Yp.abs().max()), 1e-300)
    dt = str(dtype).removeprefix("torch.")
    if not rel < TOL[dt]:
        raise AssertionError(f"{label} {dt}: kernel vs plain relative error "
                             f"{rel:.3e} ≥ {TOL[dt]:g}")
    return abs_err, rel


def padded_x(op, b: int, seed: int):
    import torch

    ncb = -(-op._n // op.bk)
    g = torch.Generator(device=op.device).manual_seed(seed)
    return torch.randn((ncb * op.bk, b), generator=g, dtype=op.dtype,
                       device=op.device)


def compare_entry(entry: str, op, b: int, seed: int, timing: bool):
    """Run one packed entry point and the plain version on the same card
    tensors; returns (max abs error, relative error, kernel ms, plain ms,
    bytes, operations)."""
    from rbl_tpu_torch.ops.spmm import bsr

    X = padded_x(op, b, seed)
    args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
    fn = getattr(bsr, entry)
    kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
    abs_err, rel = check(
        f"{entry} b={b}", lambda: fn(*args, H=op.H, **kw),
        lambda: bsr.bsr_spmm_packed_reference(*args, **kw), op.dtype)
    ms = plain_ms = None
    if timing:
        ms = time_ms(lambda: fn(*args, H=op.H, **kw))
        plain_ms = time_ms(lambda: bsr.bsr_spmm_packed_reference(*args, **kw))
    return abs_err, rel, ms, plain_ms, *sparse_need(op.vals, op._n, b)


def ragged_matrix(n: int = 1999, seed: int = 0):
    """Symmetric, n a multiple of neither bm nor bk, skewed tile counts,
    one heavy row and empty block-rows."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 300, 4000), np.full(1500, n - 222)])
    cols = np.concatenate([rng.integers(0, n, 4000), rng.integers(0, n, 1500)])
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def chung_lu(n: int = 262_144, mean_deg: float = 16.0, gamma: float = 2.1,
             seed: int = 0):
    """Symmetric 0/1 adjacency of a Chung-Lu random graph: node weights
    from a Pareto law whose degree tail has exponent ``gamma``, edge
    endpoints drawn in proportion to the weights, self-loops and repeats
    dropped, drawn until the mean degree reaches ``mean_deg``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    w = rng.pareto(gamma - 1.0, n) + 1.0
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    A = sp.csr_matrix((n, n), dtype=np.float32)
    while A.nnz < mean_deg * n:
        m = int((mean_deg * n - A.nnz) * 0.6) + 1
        i = np.searchsorted(cdf, rng.random(m))
        j = np.searchsorted(cdf, rng.random(m))
        keep = i != j
        E = sp.coo_matrix((np.ones(keep.sum(), np.float32), (i[keep], j[keep])),
                          shape=(n, n))
        A = (A + E + E.T).tocsr()
        A.data[:] = 1.0
    return A


def torch_csr(A, dtype, device: str = "cuda"):
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data).to(dtype), size=A.shape,
    ).to(device)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def laplacian_check(eigenvalues, nx: int) -> float:
    """bench.py's analytic check: max relative error against the top of
    the 2-D Dirichlet Laplacian spectrum."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(eigenvalues)]
    return float(np.max(np.abs(np.asarray(eigenvalues) - lam) / lam))


def solve(op, k: int, b: int, label: str, tol: float = 1e-3, timer=None,
          **cfg_kw):
    """One solve in f32 (cholqr2, cap 1400, further RBLConfig fields from
    ``cfg_kw``) on the card; returns the result and its wall seconds."""
    import torch

    import rbl_tpu_torch as rt

    cfg = rt.RBLConfig(block_size=b, basis_dtype=torch.float32,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=tol, max_kryl_dim=1400, **cfg_kw)
    t0 = time.perf_counter()
    res = rt.rbl(op, k, cfg=cfg, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = np.asarray(res.eigenvalues)
    if w.shape != (k,) or not np.all(np.isfinite(w)):
        raise AssertionError(f"{label}: eigenvalues not finite of shape ({k},)")
    if res.eigenvectors.device.type != "cuda":
        raise AssertionError(f"{label}: eigenvectors on {res.eigenvectors.device}")
    return res, wall


def fem_solve(op, k: int, b: int, head: np.ndarray, label: str = "fem42",
              **kw):
    """One fem42 solve (see ``solve``, tol 1e-3); returns the result, its
    wall seconds and its max relative error on the ARPACK head."""
    res, wall = solve(op, k, b, f"{label} b={b}", **kw)
    w = np.asarray(res.eigenvalues)
    err = float(np.max(np.abs(w[: len(head)] - head) / head))
    if not err < 1e-2:
        raise AssertionError(f"{label} b={b}: max rel error {err:.3e} vs "
                             "ARPACK head ≥ 1e-2")
    return res, wall, err


def head_error(w, ref, m: int) -> float:
    """Max relative error between the m largest-magnitude values of two
    spectra, each taken in ascending order."""
    top = lambda v: np.sort(v[np.argsort(-np.abs(v))][:m])
    a, r = top(np.asarray(w)), top(np.asarray(ref))
    return float(np.max(np.abs(a - r) / np.abs(r)))


def probe_calls(name: str, vals, xt, bm: int, U: int):
    """The tile-stream probe ``name`` on vals (S·bm·U, 128): (kernel call,
    plain call, library call), each taking the seed."""
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds

    CH = bm * U
    S = vals.shape[0] // CH
    if name == "stream_dot":
        return (lambda s: tds.make_stream_dot(S, CH, bm, U)(vals, s, xt),
                lambda s: tds.stream_dot_reference(vals, s, xt, S=S, CH=CH, bm=bm, U=U),
                lambda s: s + (vals.view(-1, bm, 128) @ xt.T).sum())
    make, plain = {"stream": (tds.make_stream, tds.stream_reference),
                   "manual": (tds.make_manual, tds.manual_reference)}[name]
    return (lambda s: make(S, CH)(vals, s), lambda s: plain(vals, s, S=S, CH=CH),
            lambda s: s + vals.sum(0))


def check_probe(name: str, vals, seed, xt, bm: int, U: int) -> float:
    """A probe kernel and its plain version on the same card tensors, each
    held to 1e-5 · Σ|terms| per entry (f64 reference), and the kernel to
    itself bit for bit; returns max |kernel − plain|."""
    import torch

    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds

    kern, plain, _ = probe_calls(name, vals, xt, bm, U)
    out, again, out_p = kern(seed), kern(seed), plain(seed)
    ref, scale = tds.reference_f64(name, vals, seed, xt if name == "stream_dot" else None)
    torch.cuda.synchronize()
    label = f"{name} S={vals.shape[0] // (bm * U)} bm={bm} U={U}"
    for who, y in (("kernel", out), ("plain", out_p)):
        ratio = tds.error_ratio(y, ref, scale)
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: {who} off by {ratio:.2f}× "
                                 f"{tds.TOL:g}·Σ|terms|")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two runs of the kernel differ")
    return float((out - out_p).abs().max())


def reset_launches(*fns):
    for f in fns:
        f.launches = 0


def band_csr(op):
    """A sharded packed operator's band as a torch.sparse CSR matrix of its
    own rows by its extended X's rows (own column blocks, then ghosts)."""
    import torch

    from rbl_tpu_torch.ops.spmm.bsr import _packed_chunks

    row, chunk = _packed_chunks(op.hcount, op.rptr)
    U = op.unroll
    tiles = (chunk[:, None] * U + torch.arange(U, device=op.device)).reshape(-1)
    tv = op.vals[tiles]
    t, r, q = torch.nonzero(tv, as_tuple=True)
    rows = row.repeat_interleave(U)[t] * op.bm + r
    cols = op.tile_cols.long()[tiles][t] * op.bk + q
    shape = (op.rptr.shape[0] * op.bm,
             (op.ncb_local + sum(op.caps)) * op.bk)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), tv[t, r, q], shape)
    return coo.coalesce().to_sparse_csr()


def band_kernel_row(op, X_local, Xe, entry: str, card: str, label: str) -> dict:
    """The packed entry point on a sharded operator's band (its extended
    X ``Xe``, made beforehand: the ghost exchange is a collective) against
    the plain version, timed beside torch.sparse CSR of the band's
    nonzeros and the bound of what the band needs: its nonzeros (value and
    int32 index) once, the extended X once, its rows of Y once."""
    import torch

    from rbl_tpu_torch.ops.spmm import bsr

    args = (op.tile_cols, op.hcount, op.rptr, op.vals, Xe)
    kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
    fn = getattr(bsr, entry)
    if op.kernel(X_local.shape[1]) is not fn:
        raise AssertionError(f"{label}: the band's apply takes "
                             f"{op.kernel(X_local.shape[1]).__name__}, not {entry}")
    abs_err, rel = check(f"{entry} {label}", lambda: fn(*args, H=op.H, **kw),
                         lambda: bsr.bsr_spmm_packed_reference(*args, **kw),
                         op.dtype)
    ms = time_ms(lambda: fn(*args, H=op.H, **kw))
    plain_ms = time_ms(lambda: bsr.bsr_spmm_packed_reference(*args, **kw))
    csr = band_csr(op)
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, Xe))
    es, b = op.vals.element_size(), X_local.shape[1]
    nnz = int(csr.values().numel())
    rows = op.rptr.shape[0] * op.bm
    lim = bound(nnz * (es + 4) + (Xe.shape[0] + rows) * b * es, 2 * nnz * b)
    print(f"{entry} {label}: rel err {rel:.2e}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CSR {lib_ms:.4f} ms, bound {lim['bound_ms']:.4f} "
          f"ms ({lim['bound_by']}; {100 * lim['bound_ms'] / ms:.1f}%), "
          f"X {Xe.shape[0]} rows ({Xe.numel() * es / 1e6:.2f} MB), "
          f"{rows} rows out, {nnz} nonzeros  [{card}]")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **lim)


MESH_HEAD = 90  # the fem47 solves are compared on their 90 largest values


def mesh_solve_cfg(mesh=None, **kw):
    """The fem47 solve of phase 23: k = 100, b = 8, f32, cholqr2, tol
    1e-3, cap 1,400 (the fem42 main path's configuration)."""
    import torch

    import rbl_tpu_torch as rt

    return rt.RBLConfig(block_size=8, basis_dtype=torch.float32,
                        compute_dtype=torch.float32, qr_method="cholqr2",
                        tol=1e-3, max_kryl_dim=1400, mesh=mesh, **kw)


def phase_mesh(card: str, kernels: dict, by_phase: dict, every) -> None:
    """Phase 23: the row mesh on fem47, one rank over NCCL here, then two
    ranks sharing the card over gloo in two spawned processes."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.parallel.dist_spmm import ShardedBlockSparseOperator
    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    B1, B2 = bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed
    t0 = time.perf_counter()
    A = fem_elasticity_3d(47)
    n = A.shape[0]
    bm, U = bsr.pick_tile_plan(A)
    print(f"fem47: n={n} nnz={A.nnz}, plan ({bm}, {U}), assembled and planned "
          f"in {time.perf_counter() - t0:.1f} s")

    # --- (a) one rank over NCCL ----------------------------------------------
    initialize_cluster(f"localhost:{free_port()}", 1, 0, device="cuda")
    mesh = make_row_mesh(1)
    mesh.all_reduce_sum(torch.zeros(1, device="cuda"))  # NCCL's set-up
    torch.cuda.synchronize()
    print(f"(a) {mesh.describe()}")
    t0 = time.perf_counter()
    opS = ShardedBlockSparseOperator.from_scipy(A, mesh, dtype=torch.float32,
                                                bm=bm, unroll=U)
    opU = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=bm,
                                             unroll=U, device="cuda")
    print(f"(a) both operators built in {time.perf_counter() - t0:.1f} s; "
          f"tile lists equal: "
          f"{bool(torch.equal(opS.tile_cols, opU.tile_cols))}, vals equal: "
          f"{bool(torch.equal(opS.vals, opU.vals))}")
    g = torch.Generator(device="cuda").manual_seed(47)
    X = torch.randn((n, 8), generator=g, dtype=torch.float32, device="cuda")
    reset_launches(*every)
    Ys, Yu = opS.apply(X), opU.apply(X)
    torch.cuda.synchronize()
    if B2.launches != 2 or B1.launches != 0:
        raise AssertionError(f"(a) fem47 b=8 applies launched B1 {B1.launches}"
                             f", B2 {B2.launches} times, not B2 twice")
    if not torch.equal(Ys, Yu):
        raise AssertionError("(a) the one-rank sharded apply differs from "
                             "BlockSparseOperator.apply: max abs "
                             f"{float((Ys - Yu).abs().max()):.3e}")
    print("(a) one-rank sharded apply (B2) equals BlockSparseOperator.apply "
          "bit for bit")
    row_b2 = band_kernel_row(opS, X, opS.extended_x(X), "bsr_spmm_packed", card,
                             "fem47 whole, one rank, f32 b=8")
    # solves from the same generator (seed 0): unsharded, then sharded
    walls, res = {}, {}
    for label, op, m in (("unsharded", opU, None), ("sharded", opS, mesh)):
        reset_launches(*every)
        mesh.reset_stats()
        t1 = time.perf_counter()
        r = rt.rbl(op, 100, cfg=mesh_solve_cfg(m))
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t1
        res[label] = r
        w = np.asarray(r.eigenvalues)
        if w.shape != (100,) or not np.all(np.isfinite(w)):
            raise AssertionError(f"(a) fem47 {label}: eigenvalues not finite")
        stats = dict(mesh.stats) if m is not None else {}
        print(f"(a) fem47 k=100 b=8 {label}: wall {walls[label]:.3f} s, "
              f"kryl_dim {r.kryl_dim}, converged {r.converged}, launches "
              f"B1 {B1.launches} B2 {B2.launches}, collectives {stats}  [{card}]")
        if label == "sharded":
            if B2.launches < 1:
                raise AssertionError("(a) the sharded solve never launched B2")
            by_phase["bsr_spmm_packed"]["23"] = B2.launches
    head_a = np.asarray(res["unsharded"].eigenvalues)[:MESH_HEAD]
    agree = rel_diff(np.asarray(res["sharded"].eigenvalues)[:MESH_HEAD], head_a)
    if not agree < 1e-5:
        raise AssertionError(f"(a) sharded vs unsharded head {MESH_HEAD}: "
                             f"{agree:.3e} ≥ 1e-5")
    print(f"(a) head {MESH_HEAD} sharded vs unsharded: max rel {agree:.3e}; "
          f"mesh layer overhead {walls['sharded'] - walls['unsharded']:+.3f} s "
          f"({100 * (walls['sharded'] / walls['unsharded'] - 1):+.1f}%)  [{card}]")
    kernels["bsr_spmm_packed"]["mesh"] = dict(
        shape=f"fem47 whole (one rank), plan ({bm}, {U}), f32 b=8",
        launches=by_phase["bsr_spmm_packed"]["23"],
        walls_s=dict(walls), head_agreement=agree, **row_b2)
    Y_a = Yu.cpu().numpy()
    X_h = X.cpu().numpy()
    w_a = np.asarray(res["unsharded"].eigenvalues)
    del opS, opU, Ys, Yu, X, res
    shutdown_cluster()
    torch.cuda.empty_cache()

    # --- (b) two ranks sharing the card over gloo ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        A32 = A.astype(np.float32)
        path = os.path.join(tmp, "fem47.npz")
        t0 = time.perf_counter()
        np.savez(path, indptr=A32.indptr, indices=A32.indices, data=A32.data,
                 shape=np.asarray(A32.shape), bm=bm, unroll=U, X=X_h, Y=Y_a,
                 w=w_a)
        print(f"(b) fem47 CSR written once ({os.path.getsize(path) / 1e6:.0f} "
              f"MB) in {time.perf_counter() - t0:.1f} s")
        del A, A32
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             str(r), "2", str(port), path, outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, cwd=ROOT) for r in range(2)]
        t0 = time.perf_counter()
        logs = []
        try:
            for p in procs:
                log, _ = p.communicate(
                    timeout=max(1.0, 240 - (time.perf_counter() - t0)))
                logs.append(log)
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                p.wait()
            raise AssertionError("(b) the two-rank run outlived 240 s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            for line in log.strip().splitlines():
                print(f"  [rank {r}] {line}")
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        os.killpg(q.pid, 9)
                raise AssertionError(f"(b) rank {r} exited {p.returncode}")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    w0, w1 = (np.array([float.fromhex(v) for v in rk["w_hex"]]) for rk in ranks)
    if w0.tobytes() != w1.tobytes():
        raise AssertionError("(b) the two ranks' fem47 eigenvalues differ")
    agree_b = rel_diff(w0[:MESH_HEAD], w_a[:MESH_HEAD])
    if not agree_b < 1e-5:
        raise AssertionError(f"(b) two-rank head {MESH_HEAD} vs (a): "
                             f"{agree_b:.3e} ≥ 1e-5")
    b1 = sum(rk["b1_launches"] for rk in ranks)
    by_phase["bsr_spmm_packed_resident"]["23"] = b1
    print(f"(b) fem47 eigenvalues bitwise equal on both ranks; head "
          f"{MESH_HEAD} vs (a) {agree_b:.3e}; B1 launches {b1} "
          f"({[rk['b1_launches'] for rk in ranks]}); walls "
          f"{[round(rk['wall_s'], 3) for rk in ranks]} s; lap2d_512 max rel "
          f"err {ranks[0]['lap_err']:.3e}  [{card}]")
    kernels["bsr_spmm_packed_resident"]["mesh"] = dict(
        shape=ranks[0]["band_shape"], launches=b1,
        by_rank=[rk["band_row"] for rk in ranks],
        transport=ranks[0]["transport"], head_agreement=agree_b,
        walls_s=[rk["wall_s"] for rk in ranks],
        collectives=[rk["collectives"] for rk in ranks],
        **ranks[0]["band_row"])


def mesh_worker(argv) -> int:
    """One rank of phase 23 (b): ``--mesh-worker rank nranks port npz
    out.json``.  Joins the gloo group on cuda:0, checks its band apply and
    B1 on it, solves fem47 and lap2d_512_k50_b16 on the mesh, and writes
    its results to out.json."""
    import scipy.sparse as sp
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.parallel.dist_spmm import (
        ShardedBlockSparseOperator,
        ShardedLaplacian2D,
    )
    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh

    rank, nranks, port, path, out = (int(argv[0]), int(argv[1]), argv[2],
                                     argv[3], argv[4])
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    initialize_cluster(f"localhost:{port}", nranks, rank, device="cuda:0",
                       backend="gloo", timeout_s=120)
    mesh = make_row_mesh(nranks, device="cuda:0")
    print(mesh.describe())
    # gloo's collectives take CUDA tensors, its point-to-point does not
    # (tools/probe_mesh_transport.py): the ring exchange stages through
    # pinned host buffers.  The all-reduce and the all-gather the solve
    # calls are checked here on device tensors first.
    probe = torch.arange(4, dtype=torch.float32, device="cuda:0") + rank
    red = mesh.all_reduce_sum(probe).cpu()
    both = mesh.gather_rows(probe, 4 * nranks).cpu()
    ok_reduce = bool(torch.equal(red, torch.arange(4.0) * 2 + 1))
    ok_gather = bool(torch.equal(both, torch.cat(
        [torch.arange(4.0) + r for r in range(nranks)])))
    transport = (f"gloo on cuda:0 shared by {nranks} ranks; all-reduce and "
                 f"all-gather of CUDA tensors direct ("
                 f"{'ok' if ok_reduce and ok_gather else 'WRONG'}); "
                 f"point-to-point staged through pinned host buffers")
    print(transport)
    if not (ok_reduce and ok_gather):
        raise AssertionError("gloo all-reduce or all-gather of a CUDA tensor "
                             "is wrong")
    z = np.load(path)
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                      shape=tuple(z["shape"]))
    n = A.shape[0]
    t0 = time.perf_counter()
    op = ShardedBlockSparseOperator.from_scipy(
        A, mesh, dtype=torch.float32, bm=int(z["bm"]), unroll=int(z["unroll"]))
    lo, hi = mesh.row_range(n)
    print(f"band rows {lo}..{hi}, caps {op.caps}, ghost blocks "
          f"{op.comm_blocks_per_apply()}, built in {time.perf_counter() - t0:.1f} s")
    X = mesh.shard_rows(torch.from_numpy(z["X"]))
    reset_launches(bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed)
    Y = op.apply(X).cpu().numpy()
    if bsr.bsr_spmm_packed_resident.launches != 1:
        raise AssertionError("the band apply did not launch B1")
    err = float(np.abs(Y - z["Y"][lo:hi]).max() / np.abs(z["Y"][lo:hi]).max())
    if not err < 1e-5:
        raise AssertionError(f"band apply vs (a)'s rows: {err:.3e} ≥ 1e-5")
    print(f"band apply (B1) vs (a)'s rows: max rel {err:.3e}")
    # the ranks share the card: each times its band while the others wait
    Xe = op.extended_x(X)
    for r in range(nranks):
        if r == rank:
            row = band_kernel_row(op, X, Xe, "bsr_spmm_packed_resident", card,
                                  f"fem47 band of rank {rank}/{nranks}, f32 b=8")
        mesh.barrier()
    row["band_apply_rel"] = err
    B1 = bsr.bsr_spmm_packed_resident
    reset_launches(B1, bsr.bsr_spmm_packed)
    mesh.reset_stats()
    t0 = time.perf_counter()
    res = rt.rbl(op, 100, cfg=mesh_solve_cfg(mesh))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1 = B1.launches
    if b1 < 1 or bsr.bsr_spmm_packed.launches:
        raise AssertionError(f"the fem47 solve launched B1 {b1}, B2 "
                             f"{bsr.bsr_spmm_packed.launches} times")
    coll = dict(mesh.stats)
    w = np.asarray(res.eigenvalues)
    if w.shape != (100,) or not np.all(np.isfinite(w)):
        raise AssertionError("fem47 on the mesh: eigenvalues not finite")
    print(f"fem47 k=100 b=8 on {nranks} ranks: wall {wall:.3f} s, kryl_dim "
          f"{res.kryl_dim}, converged {res.converged}, B1 launches {b1}, "
          f"collectives {coll}  [{card}]")
    # the headline through the sharded stencil
    lap = ShardedLaplacian2D(nx=512, ny=512, mesh=mesh, dtype=torch.float32)
    cfg = rt.RBLConfig(block_size=16, basis_dtype=torch.bfloat16,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=768, eig_poll_cadence=16,
                       mesh=mesh)
    for seed in (0, 1):  # the second, warm run is timed
        mesh.reset_stats()
        t0 = time.perf_counter()
        lres = rt.rbl(lap, 50, cfg=cfg.replace(seed=seed))
        torch.cuda.synchronize()
        lwall = time.perf_counter() - t0
    lap_err = laplacian_check(lres.eigenvalues, 512)
    if not lap_err < 0.025:
        raise AssertionError(f"lap2d 512² on the mesh: off by {lap_err:.3f}")
    print(f"lap2d 512² k=50 b=16 (bench config) on {nranks} ranks: warm wall "
          f"{lwall:.3f} s, max rel err {lap_err:.3e}, kryl_dim "
          f"{lres.kryl_dim}, collectives {dict(mesh.stats)}  [{card}]")
    mesh.barrier()
    shutdown_cluster()
    with open(out, "w") as f:
        json.dump(dict(
            w_hex=[float(v).hex() for v in w], wall_s=wall, b1_launches=b1,
            collectives=coll, lap_err=lap_err, lap_wall_s=lwall,
            lap_collectives=dict(mesh.stats), transport=transport,
            band_row=row, band_shape=(
                f"fem47 band ({hi - lo} rows, {op.comm_blocks_per_apply()} "
                f"ghost blocks), plan ({op.bm}, {op.unroll}), f32 b=8")), f)
    return 0


VIB_K = 8  # phase 17's vibration solve: k = b = 8, σ = 0, f64, tol 1e-6
SVD_K = 10  # phase 21's svds call
# the fem31 legs of phase 24 stop at this Krylov dimension (8 inner solves
# where the converged run takes 55), so that the two gloo ranks' thousands
# of host round trips fit the phase's time; both legs take the same cap
FEM31_KRYL = 48


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def vibration_run(opK, mass, psolve, mesh=None, device: str = "cuda",
                  max_kryl_dim: int | None = None):
    """The vibration solve of phases 17 and 24, rbl_generalized(K, M, 8, 8,
    σ = 0, f64, tol 1e-6) with M lumped and ``psolve`` as the inner
    preconditioner; K sharded over ``mesh`` when given.  Returns (result, info, wall, max
    ‖K·x − λ·M·x‖, max |XᵀMX − I|, all-reduces), the checks on the whole
    X."""
    import torch

    import rbl_tpu_torch as rt

    f64 = torch.float64
    opM = rt.DiagonalOperator(torch.as_tensor(mass, dtype=f64, device=device))
    if mesh is not None:
        mesh.reset_stats()
    t0 = time.perf_counter()
    res, info = rt.rbl_generalized(
        opK, opM, VIB_K, VIB_K, cfg=rt.RBLConfig(
            tol=1e-6, device=device, mesh=mesh,
            **({} if max_kryl_dim is None else dict(max_kryl_dim=max_kryl_dim))),
        which="LM", sigma=0.0, inner_psolve=psolve, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reduces = mesh.stats["all_reduce"] if mesh is not None else 0
    X, KX = res.eigenvectors, opK.apply(res.eigenvectors)
    if mesh is not None:
        X, KX = mesh.gather_rows(X, opK.n), mesh.gather_rows(KX, opK.n)
    lam = torch.as_tensor(res.eigenvalues, dtype=f64, device=X.device)
    MX = opM.diag[:, None] * X
    resid = float((KX - MX * lam[None, :]).norm(dim=0).max())
    orth = float((X.T @ MX - torch.eye(VIB_K, dtype=f64, device=X.device)).abs().max())
    return res, info, wall, resid, orth, reduces


def vibration_line(label: str, res, info, wall, resid, orth, reduces, card: str):
    its = info.inner_iterations / max(info.inner_solves, 1)
    print(f"{label} k={VIB_K} b={VIB_K} f64 σ=0 tol 1e-6: wall {wall:.3f} s, "
          f"{info.inner_solves} inner solves, {its:.1f} MINRES iterations a "
          f"solve, all-reduces {reduces}, kryl_dim {res.kryl_dim}, converged "
          f"{res.converged}, λ {res.eigenvalues[0]:.9e}..{res.eigenvalues[-1]:.9e}, "
          f"max ‖K·x − λ·M·x‖ {resid:.3e}, max |XᵀMX − I| {orth:.3e}  [{card}]")


def mesh_scipy_refs(card: str) -> dict:
    """Phase 24's unsharded references, run before its counted window:
    fem47's grid AMG and its vibration solve, eigsh(fem47, k=100) and svds
    on phase 21's factor, none on a mesh.  Then one NCCL rank: fem47's
    sharded K, its mesh hierarchy, and a V-cycle timed on each side.
    Returns what the counted window and the kernel rows read."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.eig import spectral_norm_bound
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.parallel.dist_spmm import ShardedBlockSparseOperator
    from rbl_tpu_torch.parallel.distributed import initialize_cluster
    from rbl_tpu_torch.parallel.mesh import make_row_mesh
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    f64 = torch.float64
    A = fem_elasticity_3d(47)
    n, dims = A.shape[0], (47, 48, 48)
    st = dict(A=A, mass=lumped_mass(47))
    t0 = time.perf_counter()
    amg_u = rt.AssembledMultigrid.from_grid(A, dims, dof=3, device="cuda")
    setup_u = time.perf_counter() - t0
    opK = amg_u.levels[0].op
    if not isinstance(opK, bsr.BlockSparseOperator):
        raise AssertionError(f"fem47 f64 took the {type(opK).__name__} route, not BSR")
    g = torch.Generator(device="cuda").manual_seed(5)
    st["normK"] = float(spectral_norm_bound(opK, g, margin=1.0))
    print(f"(a) fem47 unsharded grid AMG set up in {setup_u:.2f} s ({amg_u.report()}); "
          f"‖K‖ ≥ {st['normK']:.6f} (24 power steps)")
    st["base"] = vibration_run(opK, st["mass"], amg_u.psolve)
    vibration_line("(a) fem47 vibration, unsharded", *st["base"], card)
    t0 = time.perf_counter()
    st["eig"] = rt.eigsh(A, k=100, cfg=rt.RBLConfig(device="cuda"))
    st["eig_wall"] = time.perf_counter() - t0
    st["Bh"] = dense_factor(15, 0.9 ** torch.arange(2_000, dtype=f64, device="cuda")
                            ).cpu().numpy()
    t0 = time.perf_counter()
    st["svd"] = (*rt.svds(st["Bh"], k=SVD_K, cfg=rt.RBLConfig(device="cuda")),
                 time.perf_counter() - t0)
    print(f"(b, c) unsharded: eigsh(fem47 f64 CSR, k=100) {st['eig_wall']:.3f} s, "
          f"svds(k={SVD_K}) {st['svd'][3]:.3f} s  [{card}]")

    initialize_cluster(f"localhost:{free_port()}", 1, 0, device="cuda")
    mesh = make_row_mesh(1)
    mesh.all_reduce_sum(torch.zeros(1, device="cuda"))  # NCCL's set-up
    t0 = time.perf_counter()
    K_sh = ShardedBlockSparseOperator.from_scipy(A, mesh, dtype=f64, bm=opK.bm,
                                                 unroll=opK.unroll)
    amg_m = rt.AssembledMultigrid.from_grid(A, dims, dof=3, mesh=mesh, op0=K_sh)
    print(f"(a) {mesh.describe()}; sharded K and the mesh hierarchy set up in "
          f"{time.perf_counter() - t0:.2f} s ({amg_m.report()})")
    Xv = torch.randn((n, VIB_K), generator=g, dtype=f64, device="cuda")
    vc_u = time_ms(lambda: amg_u.psolve(Xv))
    before = mesh.stats["all_reduce"]
    vc_m = time_ms(lambda: amg_m.psolve(Xv))
    per_cycle = (mesh.stats["all_reduce"] - before) / 21  # warm-up + 20
    if per_cycle != 1:
        raise AssertionError(f"(a) the mesh V-cycle made {per_cycle} all-reduces a cycle")
    print(f"(a) ms a V-cycle at b={VIB_K}: {vc_m:.3f} (mesh, one all-reduce) vs "
          f"{vc_u:.3f} (unsharded)  [{card}]")
    st.update(mesh=mesh, K_sh=K_sh, amg_m=amg_m)
    return st


def phase_mesh_scipy(st: dict, card: str):
    """Phase 24's counted window, the mesh paths alone: (a) the fem47
    vibration pencil on one NCCL rank with the mesh V-cycle, held against
    the unsharded solve of ``mesh_scipy_refs``, and fem31's capped at
    ``FEM31_KRYL``; (b) eigsh(fem47, k=100) and (c) svds on phase 21's
    factor with cfg.mesh; then the same on two gloo ranks sharing the card,
    spawned as ``chip_smoke.py --scipy-mesh-worker``.  Returns the ranks'
    records."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.parallel.dist_spmm import ShardedBlockSparseOperator
    from rbl_tpu_torch.parallel.distributed import shutdown_cluster
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    f64 = torch.float64
    B1, B2 = bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed
    mesh, A, n, normK = st["mesh"], st["A"], st["A"].shape[0], st["normK"]

    # --- (a) the vibration pencil on one NCCL rank -------------------------
    base = st["base"]
    sh = vibration_run(st["K_sh"], st["mass"], st["amg_m"].psolve, mesh)
    vibration_line("(a) fem47 vibration, one rank (mesh V-cycle)", *sh, card)
    print(f"(a) the one-rank solve launched B1 {B1.launches} (levels 1-2), "
          f"B2 {B2.launches} (K)")
    agree = rel_diff(np.asarray(sh[0].eigenvalues), np.asarray(base[0].eigenvalues))
    for label, (res, _, _, resid, orth, _) in (("unsharded", base), ("one rank", sh)):
        if not (res.converged and resid <= 1e-6 * normK and orth < 1e-8
                and np.all(res.eigenvalues > 0)):
            raise AssertionError(f"(a) fem47 vibration {label}: converged "
                                 f"{res.converged}, max residual {resid:.3e} "
                                 f"(bound {1e-6 * normK:.3e}), max |XᵀMX − I| {orth:.3e}")
    if not agree < 1e-10:
        raise AssertionError(f"(a) fem47 one rank vs unsharded: {agree:.3e} ≥ 1e-10")
    its = [r[1].inner_iterations / max(r[1].inner_solves, 1) for r in (base, sh)]
    print(f"(a) fem47 one rank vs unsharded: eigenvalues max rel {agree:.3e}; MINRES "
          f"iterations a solve {its[1]:.1f} vs {its[0]:.1f}; all-reduces a solve "
          f"{sh[5]} (one a V-cycle); walls {sh[2]:.3f} vs {base[2]:.3f} s  [{card}]")
    del base, sh
    A31 = fem_elasticity_3d(31)
    bm31, U31 = bsr.pick_tile_plan(A31)
    K31 = ShardedBlockSparseOperator.from_scipy(A31, mesh, dtype=f64, bm=bm31,
                                                unroll=U31)
    amg31 = rt.AssembledMultigrid.from_grid(A31, (31, 32, 32), dof=3, mesh=mesh,
                                            op0=K31)
    one31 = vibration_run(K31, lumped_mass(31), amg31.psolve, mesh,
                          max_kryl_dim=FEM31_KRYL)
    vibration_line(f"(a) fem31 vibration, one rank, Krylov cap {FEM31_KRYL}",
                   *one31, card)
    w31 = np.asarray(one31[0].eigenvalues)
    if not (one31[4] < 1e-8 and np.all(w31 > 0)):
        raise AssertionError(f"(a) fem31 on one rank: max |XᵀMX − I| {one31[4]:.3e}, "
                             f"λ {w31}")
    del K31, amg31, one31
    torch.cuda.empty_cache()

    # --- (b) eigsh(fem47, k=100), scipy's defaults, on one rank ------------
    w_u, V_u = st["eig"]
    t0 = time.perf_counter()
    w_m, V_m = rt.eigsh(A, k=100, cfg=rt.RBLConfig(device="cuda", mesh=mesh))
    wall = time.perf_counter() - t0
    if not (isinstance(V_m, np.ndarray) and V_m.shape == (n, 100)
            and w_m.tobytes() == w_u.tobytes()):
        raise AssertionError("(b) eigsh(fem47) on one rank: not whole numpy "
                             "arrays, or eigenvalues not equal bit for bit")
    print(f"(b) eigsh(fem47 f64 CSR, k=100) scipy defaults: unsharded {st['eig_wall']:.3f} "
          f"s, cfg.mesh one rank {wall:.3f} s; eigenvalues equal bit for "
          f"bit, vectors {'equal bit for bit' if V_m.tobytes() == V_u.tobytes() else 'differ'}"
          f"; whole ({V_m.shape[0]}, {V_m.shape[1]}) {V_m.dtype} on the rank's host  [{card}]")
    head47 = w_u[::-1][:MESH_HEAD].copy()
    del V_m, V_u

    # --- (c) svds on phase 21's factor, on one rank -------------------------
    t0 = time.perf_counter()
    U, s, Vh = rt.svds(st["Bh"], k=SVD_K, cfg=rt.RBLConfig(device="cuda", mesh=mesh))
    wall = time.perf_counter() - t0
    s_u = st["svd"][1]
    errs = (rel_diff(s, s_u), float(np.abs(U.T @ U - np.eye(SVD_K)).max()),
            float(np.abs(Vh @ Vh.T - np.eye(SVD_K)).max()))
    if not (U.shape == (st["Bh"].shape[0], SVD_K) and Vh.shape == (SVD_K, st["Bh"].shape[1])
            and errs[0] < 1e-8 and max(errs[1:]) < 1e-8):
        raise AssertionError(f"(c) svds on one rank: s vs unsharded {errs[0]:.3e}, "
                             f"orthonormality {errs[1]:.3e} / {errs[2]:.3e}")
    print(f"(c) svds(dense 20000×2000 of phase 15, k={SVD_K}): one rank {wall:.3f} s, "
          f"unsharded {st['svd'][3]:.3f} s; s vs unsharded {errs[0]:.3e}; U and "
          f"Vh whole, |UᵀU − I| {errs[1]:.3e}, |VhVhᵀ − I| {errs[2]:.3e}  [{card}]")
    del U, Vh
    shutdown_cluster()
    torch.cuda.empty_cache()

    # --- two gloo ranks sharing the card ----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.npz")
        np.savez(ref, w31=w31, head47=head47, s=s_u)
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--scipy-mesh-worker",
             str(r), "2", str(port), ref, outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, cwd=ROOT) for r in range(2)]
        t0 = time.perf_counter()
        logs = []
        try:
            for p in procs:
                log, _ = p.communicate(
                    timeout=max(1.0, 300 - (time.perf_counter() - t0)))
                logs.append(log)
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                p.wait()
            raise AssertionError("(2 ranks) the two-rank run outlived 300 s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            for line in log.strip().splitlines():
                print(f"  [rank {r}] {line}")
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        os.killpg(q.pid, 9)
                raise AssertionError(f"(2 ranks) rank {r} exited {p.returncode}")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    for key in ("w31_hex", "w47_hex", "v47_sha", "s_hex", "u_sha", "vh_sha"):
        if ranks[0][key] != ranks[1][key]:
            raise AssertionError(f"(2 ranks) {key} differs between the ranks")
    w31_2 = np.array([float.fromhex(v) for v in ranks[0]["w31_hex"]])
    agree31 = rel_diff(w31_2, w31)
    if not agree31 < 1e-8:
        raise AssertionError(f"(2 ranks) fem31 eigenvalues vs one rank: {agree31:.3e} ≥ 1e-8")
    print(f"(2 ranks) bitwise equal on both ranks: fem31 eigenvalues, eigsh(fem47) "
          f"eigenvalues and vectors, svds s, U and Vh; fem31 vs one rank "
          f"{agree31:.3e}; eigsh head {MESH_HEAD} vs one rank "
          f"{ranks[0]['head_agreement']:.3e}; svds s vs one rank "
          f"{ranks[0]['s_agreement']:.3e}  [{card}]")
    return ranks


def mesh_scipy_rows(K_sh, amg, ranks, kernels: dict, by_phase: dict, card: str):
    """After phase 24's counts: B2 on fem47's K (f64 b=8, one rank) and both
    packed entry points on the mesh hierarchy's replicated BSR levels
    against the plain version, timed; B1 on each two-rank fem31 band (timed
    by the ranks) and the ranks' launches."""
    import torch

    from rbl_tpu_torch.ops.spmm import bsr

    g = torch.Generator(device="cuda").manual_seed(24)
    X = torch.randn((K_sh.n, VIB_K), generator=g, dtype=torch.float64, device="cuda")
    row = band_kernel_row(K_sh, X, K_sh.extended_x(X), "bsr_spmm_packed", card,
                          "fem47 K, one rank, f64 b=8")
    kernels["bsr_spmm_packed"]["mesh_vibration"] = dict(
        shape="fem47 K (one rank of the mesh), f64 b=8 (X 20.8 MB); launches: "
              "the one-rank window's (the vibration solve's K, eigsh's A)",
        launches=by_phase["bsr_spmm_packed"]["24"], **row)
    for i, lv in enumerate(amg.levels[1:], start=1):
        if isinstance(lv.op, bsr.BlockSparseOperator):
            level_shape_rows(lv.op, f"fem47 mesh AMG level {i} (replicated)",
                             kernels, card, phase=24)
    for name in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
        by_phase[name]["24 (2 ranks)"] = sum(rk["launches"][name] for rk in ranks)
    if not by_phase["bsr_spmm_packed_resident"]["24 (2 ranks)"]:
        raise AssertionError("phase 24's two ranks never launched B1")
    kernels["bsr_spmm_packed_resident"]["mesh_vibration"] = dict(
        shape=ranks[0]["band_shape"],
        launches=by_phase["bsr_spmm_packed_resident"]["24 (2 ranks)"],
        by_rank=[rk["band_row"] for rk in ranks], **ranks[0]["band_row"])


def scipy_mesh_worker(argv) -> int:
    """One rank of phase 24's two-rank run: ``--scipy-mesh-worker rank nranks
    port ref.npz out.json``.  Joins the gloo group on cuda:0, times B1 on
    its fem31 band, solves the fem31 vibration pencil with the mesh
    V-cycle, eigsh(fem47, k=100) and svds on phase 21's factor with
    cfg.mesh, and writes its results to out.json."""
    import hashlib

    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.parallel.dist_spmm import ShardedBlockSparseOperator
    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    rank, nranks, port, ref, out = (int(argv[0]), int(argv[1]), argv[2],
                                    argv[3], argv[4])
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    initialize_cluster(f"localhost:{port}", nranks, rank, device="cuda:0",
                       backend="gloo", timeout_s=120)
    mesh = make_row_mesh(nranks, device="cuda:0")
    print(mesh.describe())
    z = np.load(ref)
    every = (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    # fem31's vibration pencil
    A31 = fem_elasticity_3d(31)
    bm, U = bsr.pick_tile_plan(A31)
    t0 = time.perf_counter()
    K31 = ShardedBlockSparseOperator.from_scipy(A31, mesh, dtype=torch.float64,
                                                bm=bm, unroll=U)
    amg = rt.AssembledMultigrid.from_grid(A31, (31, 32, 32), dof=3, mesh=mesh,
                                          op0=K31)
    lo, hi = mesh.row_range(A31.shape[0])
    print(f"fem31 band rows {lo}..{hi}, {K31.comm_blocks_per_apply()} ghost blocks, "
          f"set up in {time.perf_counter() - t0:.1f} s ({amg.report()})")
    g = torch.Generator(device="cuda:0").manual_seed(31)
    X = mesh.shard_rows(torch.randn((A31.shape[0], VIB_K), generator=g,
                                    dtype=torch.float64, device="cuda:0"))
    Xe = K31.extended_x(X)
    for r in range(nranks):  # the ranks share the card: one times at a time
        if r == rank:
            row = band_kernel_row(K31, X, Xe, "bsr_spmm_packed_resident", card,
                                  f"fem31 band of rank {rank}/{nranks}, f64 b=8")
        mesh.barrier()
    reset_launches(*every)
    res, info, wall, resid, orth, reduces = vibration_run(
        K31, lumped_mass(31), amg.psolve, mesh, device="cuda:0",
        max_kryl_dim=FEM31_KRYL)
    vibration_line(f"fem31 vibration on {nranks} ranks, Krylov cap {FEM31_KRYL}",
                   res, info, wall, resid, orth, reduces, card)
    if not orth < 1e-8:
        raise AssertionError(f"fem31 on {nranks} ranks: max |XᵀMX − I| {orth:.3e}")
    w31 = np.asarray(res.eigenvalues)
    ghosts = K31.comm_blocks_per_apply()
    del K31, amg, X, Xe, res
    torch.cuda.empty_cache()

    # eigsh(fem47, k=100) with cfg.mesh: the whole arrays on every rank
    A47 = fem_elasticity_3d(47)
    t0 = time.perf_counter()
    w47, V47 = rt.eigsh(A47, k=100, cfg=rt.RBLConfig(device="cuda:0", mesh=mesh))
    eig_wall = time.perf_counter() - t0
    if not (isinstance(V47, np.ndarray) and V47.shape == (A47.shape[0], 100)):
        raise AssertionError(f"eigsh(fem47) on {nranks} ranks: vectors not whole")
    head = rel_diff(w47[::-1][:MESH_HEAD], z["head47"])
    if not head < 1e-5:
        raise AssertionError(f"eigsh(fem47) head {MESH_HEAD} vs one rank: {head:.3e}")
    print(f"eigsh(fem47, k=100) on {nranks} ranks: wall {eig_wall:.3f} s, whole "
          f"({V47.shape[0]}, {V47.shape[1]}) on this rank's host, head "
          f"{MESH_HEAD} vs one rank {head:.3e}  [{card}]")
    v47 = sha(V47)
    del V47

    # svds on phase 21's factor with cfg.mesh
    Bh = dense_factor(15, 0.9 ** torch.arange(2_000, dtype=torch.float64,
                                              device="cuda:0"),
                      device="cuda:0").cpu().numpy()
    t0 = time.perf_counter()
    Us, s, Vh = rt.svds(Bh, k=SVD_K, cfg=rt.RBLConfig(device="cuda:0", mesh=mesh))
    svd_wall = time.perf_counter() - t0
    s_agree = rel_diff(s, z["s"])
    orth_s = max(float(np.abs(Us.T @ Us - np.eye(SVD_K)).max()),
                 float(np.abs(Vh @ Vh.T - np.eye(SVD_K)).max()))
    if not (s_agree < 1e-8 and orth_s < 1e-8):
        raise AssertionError(f"svds on {nranks} ranks: s vs one rank {s_agree:.3e}, "
                             f"orthonormality {orth_s:.3e}")
    print(f"svds k={SVD_K} on {nranks} ranks: wall {svd_wall:.3f} s, s vs one rank "
          f"{s_agree:.3e}, orthonormality {orth_s:.3e}  [{card}]")
    launches = {f.__name__: f.launches for f in every}
    mesh.barrier()
    shutdown_cluster()
    with open(out, "w") as f:
        json.dump(dict(
            w31_hex=[float(v).hex() for v in w31], wall_s=wall, launches=launches,
            collectives=reduces, inner_solves=info.inner_solves,
            inner_iterations=info.inner_iterations,
            w47_hex=[float(v).hex() for v in w47], v47_sha=v47,
            head_agreement=head, eig_wall_s=eig_wall,
            s_hex=[float(v).hex() for v in s], u_sha=sha(Us), vh_sha=sha(Vh),
            s_agreement=s_agree, svd_wall_s=svd_wall, band_row=row,
            band_shape=(f"fem31 band ({hi - lo} rows, {ghosts} ghost blocks), "
                        f"plan ({bm}, {U}), f64 b=8")), f)
    return 0


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_host_tier(op32, head, ref, ref_wall: float, card: str):
    """Phase 11; returns the capped solve's result."""
    import torch

    from rbl_tpu_torch.utils.profiling import Timer

    cap = 256
    timer = Timer()
    res, wall, err = fem_solve(op32, 100, 8, head, "fem42 host tier",
                               timer=timer, basis_device_cap_cols=cap)
    c = timer.counters
    if not res.kryl_dim > cap:
        raise AssertionError(f"host tier: kryl_dim {res.kryl_dim} never passed "
                             f"the cap {cap}")
    if c["basis_host_panels"] < 1:
        raise AssertionError("host tier: no pinned panel was written")
    agree = rel_diff(res.eigenvalues[:90], ref.eigenvalues[:90])
    if not agree < 1e-4:
        raise AssertionError(f"host tier: head 90 off the uncapped solve by "
                             f"{agree:.3e} ≥ 1e-4")
    V = res.eigenvectors
    orth = float((V.T @ V - torch.eye(V.shape[1], device=V.device,
                                      dtype=V.dtype)).abs().max())
    if not orth < 1e-3:
        raise AssertionError(f"host tier: max |VᵀV − I| = {orth:.3e} ≥ 1e-3")
    print(f"fem42 host tier (cap {cap}) k=100 b=8 f32: wall {wall:.3f} s "
          f"(uncapped {ref_wall:.3f} s), max rel err (ARPACK head 90) "
          f"{err:.3e}, against the uncapped solve {agree:.3e}, max |VᵀV − I| "
          f"{orth:.3e}, kryl_dim {res.kryl_dim} (uncapped {ref.kryl_dim}), "
          f"converged {res.converged}, pinned panels {c['basis_host_panels']} "
          f"({c['basis_d2h_bytes'] / 1e6:.1f} MB device→host), host→device "
          f"{c['basis_h2d_bytes'] / 1e9:.3f} GB over {c['basis_split_steps']} "
          f"split steps ({c['basis_h2d_bytes'] / max(c['basis_split_steps'], 1) / 1e6:.0f}"
          f" MB and {(wall - ref_wall) / max(c['basis_split_steps'], 1) * 1e3:.2f} ms "
          f"of added wall a split step)  [{card}]")
    return res


def phase_sweep_checkpoint(op32, head, ref, card: str):
    """Phase 12."""
    from rbl_tpu_torch import SweepAborted
    from rbl_tpu_torch.utils.profiling import Timer

    for cap in (None, 256):
        label = "fem42 checkpoint" + (f" (cap {cap})" if cap else "")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "sweep.npz")
            kw = dict(sweep_checkpoint_path=path, sweep_checkpoint_every=3,
                      basis_device_cap_cols=cap)
            t0 = time.perf_counter()
            try:
                solve(op32, 100, 8, label, fault_inject_abort_after_chunks=3, **kw)
            except SweepAborted as e:
                aborted = str(e)
            else:
                raise AssertionError(f"{label}: the injected abort never fired")
            abort_s = time.perf_counter() - t0
            if not os.path.exists(path):
                raise AssertionError(f"{label}: no checkpoint after the abort")
            size = os.path.getsize(path)
            timer = Timer()
            res, wall, err = fem_solve(op32, 100, 8, head, label, timer=timer, **kw)
            if os.path.exists(path):
                raise AssertionError(f"{label}: the checkpoint outlived the solve")
        if res.converged != ref.converged:
            raise AssertionError(f"{label}: resumed solve converged="
                                 f"{res.converged}, uninterrupted {ref.converged}")
        agree = rel_diff(res.eigenvalues[:90], ref.eigenvalues[:90])
        if not agree < 1e-3:
            raise AssertionError(f"{label}: resumed head 90 off the "
                                 f"uninterrupted solve by {agree:.3e} ≥ 1e-3")
        saves = timer.counts["checkpoint"]
        save_ms = timer.times["checkpoint"] / max(saves, 1) * 1e3
        print(f"{label}: {aborted}; file {size / 1e6:.1f} MB after "
              f"{abort_s:.3f} s; resumed in {wall:.3f} s, kryl_dim "
              f"{res.kryl_dim}, converged {res.converged}, max rel err (ARPACK "
              f"head 90) {err:.3e}, against the uninterrupted solve "
              f"{agree:.3e}, {saves} more saves at {save_ms:.0f} ms each, file "
              f"removed  [{card}]")


def phase_restarted(op32, head, card: str):
    """Phase 13."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.checkpoint import load_restart_state

    cfg = rt.RBLConfig(basis_dtype=torch.float32, compute_dtype=torch.float32,
                       qr_method="cholqr2", tol=1e-3, restart_kryl_dim=200)

    def held(res, label):
        w = np.asarray(res.eigenvalues)
        if w.shape != (20,) or not res.converged:
            raise AssertionError(f"{label}: locked {w.shape[0]}/20 pairs")
        err = rel_diff(w, head[:20])
        if not err < 1e-2:
            raise AssertionError(f"{label}: max rel error {err:.3e} vs ARPACK ≥ 1e-2")
        return err

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "restart.npz")
        t0 = time.perf_counter()
        res = rt.rbl_restarted(op32, 20, cfg=cfg, b=8, checkpoint_path=path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = held(res, "fem42 restarted")
        print(f"fem42 rbl_restarted k=20 b=8 f32 restart_kryl_dim=200: wall "
              f"{wall:.3f} s, {res.iterations} restarts, final kryl_dim "
              f"{res.kryl_dim}, max rel err (ARPACK head 20) {err:.3e}  [{card}]")
        os.remove(path)
        t0 = time.perf_counter()
        cut = rt.rbl_restarted(op32, 20, cfg=cfg, b=8, checkpoint_path=path,
                               max_restarts=1)
        state = load_restart_state(path)
        locked = state.count  # the resumed solve updates the state in place
        if state.restarts != 1 or locked != len(cut.eigenvalues):
            raise AssertionError(f"restart checkpoint holds restarts="
                                 f"{state.restarts}, count={locked}")
        res2 = rt.rbl_restarted(op32, 20, cfg=cfg, b=8, state=state)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        err2 = held(res2, "fem42 restarted, resumed")
        print(f"fem42 rbl_restarted cut after 1 restart ({locked} locked) "
              f"and resumed from its checkpoint: wall {wall2:.3f} s, "
              f"{res2.iterations} restarts, final kryl_dim {res2.kryl_dim}, max "
              f"rel err {err2:.3e}, against the uncut solve "
              f"{rel_diff(res2.eigenvalues, res.eigenvalues):.3e}  [{card}]")


def phase_polish(A, head, card: str):
    """Phase 14; returns fem42's f64 operator and the width (columns) the
    polish applied it at."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.profiling import Timer

    lap = rt.Laplacian2D(512, 512, dtype=torch.float64, device="cuda")
    cfg = rt.RBLConfig(block_size=8, tol=1e-7, qr_method="cholqr2",
                       eig_poll_cadence=16, seed=0)
    for seed in (0, 1):  # the second, warm run is timed
        timer = Timer(sync=True)
        t0 = time.perf_counter()
        res = rt.rbl_polished(lap, 50, cfg=cfg.replace(seed=seed), b=8,
                              bounds=(0.0, None), timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    err = laplacian_check(np.sort(res.eigenvalues)[::-1], 512)
    worst = float(np.max(res.residual_bounds))
    if not (res.converged and err < 1e-9 and worst <= 1e-7):
        raise AssertionError(f"rbl_polished lap2d 512²: converged {res.converged}, "
                             f"max rel err {err:.3e}, worst residual {worst:.3e}")
    sections = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
        timer.times.items(), key=lambda kv: -kv[1])[:4])
    print(f"rbl_polished lap2d 512² k=50 b=8 f64 tol 1e-7 (bench config): warm "
          f"wall {wall:.3f} s, {res.iterations} passes over {res.kryl_dim} "
          f"columns, max rel err {err:.3e}, worst residual {worst:.3e}; "
          f"{sections}  [{card}]")

    t0 = time.perf_counter()
    fres, info = rt.rbl_filtered(lap, 50, 8, cfg=cfg, which="LA",
                                 bounds=(0.0, None), return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = laplacian_check(fres.eigenvalues, 512)
    if not (fres.converged and err < 1e-9):
        raise AssertionError(f"rbl_filtered lap2d 512²: converged {fres.converged}, "
                             f"max rel err {err:.3e}")
    print(f"rbl_filtered lap2d 512² which=LA k=50 b=8 f64: wall {wall:.3f} s, "
          f"degree {info.degree}, cutoff {info.cutoff:.6f}, pre-sweep "
          f"{info.presweep_kryl} columns, kryl_dim {fres.kryl_dim}, max rel err "
          f"{err:.3e}, worst true residual {np.max(fres.residual_bounds):.3e}  "
          f"[{card}]")
    del lap

    op64 = rt.as_operator(A, dtype=torch.float64, device="cuda", format="bsr")
    norm = float(head[0])
    t0 = time.perf_counter()
    res = rt.rbl_polished(op64, 20, cfg=rt.RBLConfig(tol=1e-7 * norm), b=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = rel_diff(res.eigenvalues, head[:20])
    worst = float(np.max(res.residual_bounds)) / norm
    if not (res.converged and worst <= 1e-7 and err < 1e-6):
        raise AssertionError(f"rbl_polished fem42: converged {res.converged}, worst "
                             f"residual {worst:.3e}·‖A‖, max rel err {err:.3e}")
    print(f"rbl_polished fem42 (bsr, f64 tiles) k=20 b=8 tol 1e-7·‖A‖: wall "
          f"{wall:.3f} s, {res.iterations} passes over {res.kryl_dim} columns, "
          f"worst residual {worst:.3e}·‖A‖, max rel err (ARPACK head 20) "
          f"{err:.3e}  [{card}]")
    return op64, int(res.kryl_dim)


def dense_factor(seed: int, s, m: int = 20_000, device: str = "cuda"):
    """A seeded dense m × len(s) f64 matrix Q1·diag(s)·Q2ᵀ with orthonormal
    Q1, Q2 drawn on ``device`` (phases 15, 18 and 21)."""
    import torch

    n = s.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    Q1, _ = torch.linalg.qr(torch.randn((m, n), generator=g, dtype=torch.float64,
                                        device=device))
    Q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64,
                                        device=device))
    return (Q1 * s) @ Q2.T


def sm_spectrum(n: int = 2_000, device: str = "cuda"):
    """Phase 18's singular values σ = 1 + 9·√t over t ∈ [0, 1], descending:
    the small end sparser than a linear spread, so scipy's ARPACK reaches it
    in seconds."""
    import torch

    return 1.0 + 9.0 * torch.sqrt(torch.linspace(1.0, 0.0, n, dtype=torch.float64,
                                                 device=device))


def phase_svd(card: str):
    """Phase 15."""
    import scipy.sparse.linalg as spla
    import torch

    import rbl_tpu_torch as rt

    m, n, k = 20_000, 2_000, 20
    B = dense_factor(15, 0.9 ** torch.arange(n, dtype=torch.float64, device="cuda"), m)
    t0 = time.perf_counter()
    ref = np.sort(spla.svds(B.cpu().numpy(), k=k, return_singular_vectors=False))[::-1]
    svds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = rt.rbl_svd(B, k, 8, cfg=rt.RBLConfig(tol=1e-10))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = torch.as_tensor(res.s, device="cuda")
    err = rel_diff(res.s, ref)
    back = float((B @ res.V - res.U * s).abs().max())
    if not (res.converged and err < 1e-8 and back < 1e-8):
        raise AssertionError(f"rbl_svd dense: converged {res.converged}, max rel "
                             f"err {err:.3e}, max |B·V − U·s| {back:.3e}")
    print(f"rbl_svd dense {m}×{n} f64 k={k} b=8: wall {wall:.3f} s (svds "
          f"{svds_s:.1f} s on the host), max rel err vs svds {err:.3e}, max "
          f"|B·V − U·diag(s)| {back:.3e}, kryl_dim {res.kryl_dim}  [{card}]")
    del B

    m, n, k = 200_000, 50_000, 10
    S = sparse_factor(m, n)
    t0 = time.perf_counter()
    ref = np.sort(spla.svds(S, k=k, return_singular_vectors=False))[::-1]
    svds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = rt.rbl_svd(S, k, 8, cfg=rt.RBLConfig(tol=1e-9 * ref[0] ** 2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = rel_diff(res.s, ref)
    back = float(np.abs(S @ res.V.cpu().numpy() - res.U.cpu().numpy() * res.s).max())
    if not (res.converged and err < 1e-6 and back < 1e-6 * ref[0]):
        raise AssertionError(f"rbl_svd sparse: converged {res.converged}, max rel "
                             f"err {err:.3e}, max |B·V − U·s| {back:.3e}")
    print(f"rbl_svd sparse {m}×{n}, {S.nnz} nonzeros, f64 k={k} b=8: wall "
          f"{wall:.3f} s (svds {svds_s:.1f} s on the host), max rel err vs svds "
          f"{err:.3e}, max |B·V − U·diag(s)| {back:.3e} (σ₁ {ref[0]:.3f}), "
          f"kryl_dim {res.kryl_dim}  [{card}]")


def laplacian_spectrum(nx: int) -> np.ndarray:
    """Every eigenvalue of the nx² Dirichlet Laplacian, ascending."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())


def interior_shift(lam: np.ndarray, k: int = 4) -> float:
    """A shift between two eigenvalues near the middle of ``lam``, away from
    both, whose k nearest eigenvalues are whole degenerate groups with the
    (k+1)-th at least 1.2× farther than the k-th."""
    u = np.unique(np.round(lam, 12))
    for j in range(len(u) // 3, len(u) - 1):
        sig = u[j] + 0.37 * (u[j + 1] - u[j])
        d = np.sort(np.abs(lam - sig))
        if d[k] > 1.2 * d[k - 1] and d[0] > 0.2 * (u[j + 1] - u[j]):
            return float(sig)
    raise AssertionError("no interior shift found")


def phase_stencil_shift_invert(card: str, nx: int = 512, device: str = "cuda"):
    """Phase 16: rbl on ShiftInvertOperator.shift(Laplacian2D(nx, nx), σ),
    k = 4, b = 4, eigenvalues by Rayleigh quotients with A in f64 against
    the analytic spectrum.  Returns {label: (wall, inner iterations an
    apply)}."""
    import torch

    import rbl_tpu_torch as rt

    lam = laplacian_spectrum(nx)
    lap64 = rt.Laplacian2D(nx, nx, dtype=torch.float64, device=device)
    sig_in = interior_shift(lam)
    out = {}
    for label, dtype, sigma, precond, tol_rel, gate in (
            ("fdm f64", torch.float64, 0.0, "auto", 1e-11, 1e-9),
            ("fdm f32", torch.float32, 0.0, "auto", 1e-5, 1e-4),
            ("mg f64", torch.float64, 0.0, "mg", 1e-10, 1e-9),
            ("fdm f64 interior", torch.float64, sig_in, "auto", 1e-11, 1e-9)):
        lap = rt.Laplacian2D(nx, nx, dtype=dtype, device=device)
        si = rt.ShiftInvertOperator.shift(lap, sigma, precond=precond)
        theta_max = float(np.max(np.abs(1.0 / (lam - sigma))))
        cfg = rt.RBLConfig(block_size=4, compute_dtype=dtype, basis_dtype=dtype,
                           tol=tol_rel * theta_max, device=device)
        t0 = time.perf_counter()
        res = rt.rbl(si, 4, cfg=cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        V = res.eigenvectors.to(torch.float64)
        rq = ((V * lap64.apply(V)).sum(0) / (V * V).sum(0)).cpu().numpy()
        want = np.sort(lam[np.argsort(np.abs(lam - sigma), kind="stable")[:4]])
        err = float(np.max(np.abs(np.sort(rq) - want) / np.abs(want)))
        if not (err < gate and np.all(np.isfinite(rq))):
            raise AssertionError(f"shift-invert lap2d {nx}² {label} σ={sigma}: max rel "
                                 f"err {err:.3e} ≥ {gate:g} against the analytic "
                                 "spectrum")
        per = si.counts["iterations"] / max(si.counts["applies"], 1)
        out[label] = (wall, per)
        print(f"shift-invert lap2d {nx}² {label} (precond {si.precond}) σ={sigma:.9g} "
              f"k=4 b=4: wall {wall:.3f} s, {si.counts['applies']} applies, "
              f"{per:.1f} inner MINRES iterations an apply, kryl_dim {res.kryl_dim}, "
              f"converged {res.converged}, max rel err (Rayleigh quotients vs "
              f"analytic) {err:.3e}  [{card}]")
    return out


def vibration_solve(A, m, node_dims, build: str, label: str, card: str,
                    device: str = "cuda"):
    """``vibration_run`` with an AssembledMultigrid inner preconditioner
    built here; K is the hierarchy's finest operator.  Returns (result,
    info, wall, set-up s, max residual, max |XᵀMX − I|, the hierarchy)."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr

    t0 = time.perf_counter()
    if build == "grid":
        amg = rt.AssembledMultigrid.from_grid(A, node_dims, dof=3, device=device)
    else:
        amg = rt.AssembledMultigrid.smoothed_aggregation(A, dof=3, device=device)
    setup_s = time.perf_counter() - t0
    # K is the finest level's operator: as_operator(A, f64) on the device
    opK = amg.levels[0].op if amg.levels else rt.as_operator(
        A, dtype=torch.float64, device=device)
    b1, b2 = bsr.bsr_spmm_packed_resident.launches, bsr.bsr_spmm_packed.launches
    res, info, wall, resid, orth, _ = vibration_run(opK, m, amg.psolve,
                                                    device=device)
    print(f"{label} vibration (AMG {build}, set-up {setup_s:.2f} s on the host; "
          f"{amg.report()}; K route {type(opK).__name__}) k=8 b=8 f64 σ=0 tol 1e-6: "
          f"wall {wall:.3f} s, {info.inner_solves} inner solves, "
          f"{info.inner_iterations / max(info.inner_solves, 1):.1f} MINRES iterations "
          f"a solve, kryl_dim {res.kryl_dim}, converged {res.converged}, "
          f"λ {res.eigenvalues[0]:.6e}..{res.eigenvalues[-1]:.6e}, max "
          f"‖K·x − λ·M·x‖ {resid:.3e}, max |XᵀMX − I| {orth:.3e}, launches B1 "
          f"{bsr.bsr_spmm_packed_resident.launches - b1} B2 "
          f"{bsr.bsr_spmm_packed.launches - b2}  [{card}]")
    return res, info, wall, setup_s, resid, orth, amg


def phase_vibration(A, norm: float, card: str, device: str = "cuda",
                    small_nx: int = 16, large_nx: int = 42):
    """Phase 17: the FEM vibration problem K·x = λ·M·x (lumped M) on
    fem_elasticity_3d(large_nx) with the grid AMG, and on
    fem_elasticity_3d(small_nx) with both AMG builds against scipy's
    factorized eigsh(K, 8, M, sigma=0) on the host.  Returns fem42's f64
    operator and its AMG hierarchy."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    m = lumped_mass(large_nx)
    res, info, wall, setup_s, resid, orth, amg = vibration_solve(
        A, m, (large_nx, large_nx + 1, large_nx + 1), "grid", f"fem{large_nx}", card,
        device)
    if not (res.converged and resid <= 1e-6 * norm and orth < 1e-8
            and np.all(res.eigenvalues > 0)):
        raise AssertionError(f"fem{large_nx} vibration: converged {res.converged}, "
                             f"max residual {resid:.3e} (bound {1e-6 * norm:.3e}), "
                             f"max |XᵀMX − I| {orth:.3e}")
    A16 = fem_elasticity_3d(small_nx)
    m16 = lumped_mass(small_nx)
    t0 = time.perf_counter()
    ref = np.sort(spla.eigsh(A16, 8, M=sp.diags(m16), sigma=0.0, which="LM",
                             return_eigenvectors=False))
    eigsh_s = time.perf_counter() - t0
    for build in ("grid", "sa"):
        r16, _, _, _, _, _, _ = vibration_solve(
            A16, m16, (small_nx, small_nx + 1, small_nx + 1), build, f"fem{small_nx}",
            card, device)
        err = float(np.max(np.abs(np.sort(r16.eigenvalues) - ref) / ref))
        if not err < 1e-8:
            raise AssertionError(f"fem{small_nx} vibration ({build}): max rel err "
                                 f"{err:.3e} ≥ 1e-8 against scipy's eigsh")
        print(f"fem{small_nx} vibration ({build}): max rel err against scipy's "
              f"factorized eigsh(K, 8, M, sigma=0) {err:.3e} (eigsh {eigsh_s:.2f} s on "
              f"the host)")
    return amg.levels[0].op if amg.levels else None, amg


def phase_svd_sm(card: str, device: str = "cuda", m: int = 20_000, n: int = 2_000,
                 sparse_shape=(200_000, 50_000)):
    """Phase 18: rbl_svd(which="SM") of a seeded dense m × n f64 matrix with
    singular values 1 + 9·√t spread over [1, 10] (k = 10) against scipy's
    svds(which="SM"), and of phase 15's sparse factor (k = 5) held by
    ‖B·V − U·diag(s)‖ and ‖Bᵀ·U − V·diag(s)‖."""
    import scipy.sparse.linalg as spla
    import torch

    import rbl_tpu_torch as rt

    k = 10
    s_true = sm_spectrum(n, device)
    B = dense_factor(18, s_true, m, device)
    t0 = time.perf_counter()
    ref = np.sort(spla.svds(B.cpu().numpy(), k=k, which="SM",
                            return_singular_vectors=False))
    svds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = rt.rbl_svd(B, k, 8, cfg=rt.RBLConfig(tol=1e-10, device=device), which="SM")
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = rel_diff(np.sort(res.s), ref)
    exact = rel_diff(np.sort(res.s), np.sort(s_true.cpu().numpy())[:k])
    st = torch.as_tensor(res.s, device=B.device)
    back = max(float((B @ res.V - res.U * st).abs().max()),
               float((B.T @ res.U - res.V * st).abs().max()))
    if not (res.converged and err < 1e-8 and back < 1e-8):
        raise AssertionError(f"rbl_svd SM dense: converged {res.converged}, max rel err "
                             f"vs svds {err:.3e}, max residual {back:.3e}")
    print(f"rbl_svd SM dense {m}×{n} f64 k={k} b=8 (σ = 1 + 9√t over [1, 10]): wall {wall:.3f} s "
          f"(svds SM {svds_s:.1f} s on the host), max rel err vs svds {err:.3e}, vs "
          f"the constructed σ {exact:.3e}, max |B·V − U·s|, |Bᵀ·U − V·s| {back:.3e}, "
          f"kryl_dim {res.kryl_dim}  [{card}]")
    del B

    mm, nn = sparse_shape
    S = sparse_factor(mm, nn)
    k = 5
    # θ = 1/σ² of the σ = 0 transform is at least 1/min‖B·e_j‖²: a tolerance
    # 1e-8 relative to that
    cmin = float(np.sqrt(np.min(np.asarray(S.multiply(S).sum(axis=0)))))
    t0 = time.perf_counter()
    res = rt.rbl_svd(S, k, 8, cfg=rt.RBLConfig(tol=1e-8 / cmin ** 2, device=device),
                     which="SM")
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    U, V = res.U.cpu().numpy(), res.V.cpu().numpy()
    r1 = float(np.abs(S @ V - U * res.s).max())
    r2 = float(np.abs(S.T @ U - V * res.s).max())
    if not (res.converged and max(r1, r2) < 1e-6 * res.s.min() and np.all(res.s > 0)):
        raise AssertionError(f"rbl_svd SM sparse: converged {res.converged}, residuals "
                             f"{r1:.3e}, {r2:.3e}, s {res.s}")
    print(f"rbl_svd SM sparse {mm}×{nn}, {S.nnz} nonzeros, f64 k={k} b=8: wall "
          f"{wall:.3f} s, s {np.array2string(res.s, precision=6)}, max "
          f"|B·V − U·s| {r1:.3e}, |Bᵀ·U − V·s| {r2:.3e}, kryl_dim {res.kryl_dim}  "
          f"[{card}]")


def sparse_factor(m: int = 200_000, n: int = 50_000, per_row: int = 10):
    """Phase 15's seeded sparse factor: ``per_row`` nonzeros a row, column
    scales decaying as 1/√(1 + j)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(15)
    cols = rng.integers(0, n, (m, per_row))
    vals = rng.standard_normal((m, per_row)) / np.sqrt(1.0 + cols)
    S = sp.csr_matrix((vals.ravel(), cols.ravel(),
                       np.arange(0, m * per_row + 1, per_row)), shape=(m, n))
    S.sum_duplicates()
    return S


def csr_from_packed(op):
    """The packed operator's nonzeros as a torch.sparse CSR matrix on its
    device (padding tiles and the padded rows and columns dropped)."""
    import torch

    from rbl_tpu_torch.ops.spmm.bsr import _packed_chunks

    row, chunk = _packed_chunks(op.hcount, op.rptr)
    U = op.unroll
    tiles = (chunk[:, None] * U + torch.arange(U, device=op.device)).reshape(-1)
    tv = op.vals[tiles]
    t, r, q = torch.nonzero(tv, as_tuple=True)
    rows = row.repeat_interleave(U)[t] * op.bm + r
    cols = op.tile_cols.long()[tiles][t] * op.bk + q
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), tv[t, r, q],
                                  (op._n, op._n))
    return coo.coalesce().to_sparse_csr()


def check_path_shapes(opK, amg, kernels: dict, card: str):
    """After phase 17: both packed entry points against the plain version,
    timed, at b = 8 on every AMG level that ``as_operator`` routed to BSR,
    f32 and f64 (level 0 is fem42's K, in the f64 of the solve); each row
    is added to ``kernels[entry]["path_shapes"]``."""
    import torch

    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.ops.spmm.operator import cast_operator

    if not isinstance(opK, bsr.BlockSparseOperator):
        raise AssertionError(f"fem42 f64 took the {type(opK).__name__} route, not BSR")
    for i, lv in enumerate(amg.levels):
        if not isinstance(lv.op, bsr.BlockSparseOperator):
            continue
        label = "fem42 K = AMG level 0" if i == 0 else f"AMG level {i}"
        for dtype in ((torch.float64,) if i == 0 else (torch.float32, torch.float64)):
            op = lv.op if lv.op.dtype == dtype else cast_operator(lv.op, dtype)
            level_shape_rows(op, label, kernels, card, phase=17)


def level_shape_rows(op, label: str, kernels: dict, card: str, phase: int,
                     b: int = 8):
    """Both packed entry points against the plain version on one BSR
    operator at ``b`` columns (the width of the solve that applies it),
    timed beside torch.sparse CSR of its nonzeros and the bound; one row
    each in ``kernels[entry]["path_shapes"]``.  The entry the operator
    dispatches to is observed: one apply at ``b``, and the launch count
    that moved."""
    import torch

    from rbl_tpu_torch.ops.spmm import bsr

    dtype = op.dtype
    entries = ("bsr_spmm_packed_resident", "bsr_spmm_packed")
    before = [getattr(bsr, e).launches for e in entries]
    op.apply(torch.zeros((op._n, b), dtype=dtype, device="cuda"))
    moved = [e for e, n0 in zip(entries, before) if getattr(bsr, e).launches > n0]
    if len(moved) != 1:
        raise AssertionError(f"{label} {dtype} b={b} launched {moved or 'no packed entry'}")
    used = moved[0]
    # the library's time for the same product: the level's nonzeros as
    # torch.sparse CSR
    csr = csr_from_packed(op)
    Xl = padded_x(op, b, seed=17)[: op._n]
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, Xl))
    Yp = bsr.bsr_spmm_packed_reference(
        op.tile_cols, op.hcount, op.rptr, op.vals, padded_x(op, b, seed=17),
        bm=op.bm, bk=op.bk, unroll=op.unroll)[: op._n]
    lib_rel = float((torch.sparse.mm(csr, Xl) - Yp).abs().max() / Yp.abs().max())
    if not lib_rel < TOL[str(dtype)[6:]]:
        raise AssertionError(f"{label} {dtype}: CSR of the packed tiles off "
                             f"the plain version by {lib_rel:.3e}")
    del csr
    for entry in entries:
        abs_err, rel, ms, plain_ms, moved, ops = compare_entry(
            entry, op, b, seed=17, timing=True)
        lim = bound(moved, ops)
        kernels[entry].setdefault("path_shapes", []).append(dict(
            phase=phase, shape=f"{label} n={op._n} plan ({op.bm}, {op.unroll}) "
            f"{str(dtype)[6:]} b={b}", dispatched=entry == used,
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            **lim))
        tag = " (the path's entry)" if entry == used else ""
        print(f"{entry} {label} (n={op._n}, plan ({op.bm}, {op.unroll}), "
              f"{op.nnz_blocks} tiles) b={b} {dtype}{tag}: "
              f"rel err {rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.sparse CSR {lib_ms:.4f} ms, "
              f"bound {lim['bound_ms']:.4f} ms ({lim['bound_ms'] / ms:.0%})  "
              f"[{card}]")


def phase_eigsh(A, head, card: str, device: str = "cuda"):
    """Phase 19: the reference's own ARPACK comparison through scipy's
    signature, eigsh(A, k=100) with scipy's defaults (which="LM", tol=0 →
    1e-7) on fem42's f64 CSR; held to the ARPACK head and by the true
    residuals on the card, then once more without eigenvectors."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr

    cfg = rt.RBLConfig(device=device)  # scipy's call, on the card by default
    t0 = time.perf_counter()
    w, V = rt.eigsh(A, k=100, cfg=cfg)
    wall = time.perf_counter() - t0
    if not (isinstance(w, np.ndarray) and isinstance(V, np.ndarray)
            and w.shape == (100,) and V.shape == (A.shape[0], 100)
            and np.all(np.isfinite(w)) and np.all(np.diff(w) >= 0)):
        raise AssertionError("eigsh fem42: not 100 finite ascending values "
                             "with numpy vectors")
    err = float(np.max(np.abs(w[::-1][: len(head)] - head) / head))
    if not err < 1e-2:
        raise AssertionError(f"eigsh fem42: max rel error {err:.3e} vs ARPACK "
                             "head ≥ 1e-2")
    csr = torch_csr(A, torch.float64, device)
    Vd = torch.from_numpy(V).to(device)
    wd = torch.from_numpy(w).to(device)
    resid = float((torch.sparse.mm(csr, Vd) - Vd * wd).norm(dim=0).max())
    del csr, Vd
    routes = {f.__name__: f.launches for f in (bsr.bsr_spmm_packed_resident,
                                                bsr.bsr_spmm_packed)}
    t0 = time.perf_counter()
    w2 = rt.eigsh(A, k=100, return_eigenvectors=False, cfg=cfg)
    wall2 = time.perf_counter() - t0
    if not np.all(np.diff(np.abs(w2)) >= 0):
        raise AssertionError("eigsh fem42 without vectors: not scipy's LM order "
                             "(ascending |λ|)")
    err2 = float(np.max(np.abs(w2[::-1][: len(head)] - head) / head))
    if not err2 < 1e-2:
        raise AssertionError(f"eigsh fem42 without vectors: max rel error "
                             f"{err2:.3e} vs ARPACK head ≥ 1e-2")
    print(f"eigsh(fem42 f64 CSR, k=100) scipy defaults (LM, tol 0 → 1e-7, b=8): "
          f"wall {wall:.3f} s incl. the operator build and the copy back, max rel "
          f"err (ARPACK head 90) {err:.3e}, max ‖A·v − λ·v‖ {resid:.3e} "
          f"(λmax {w[-1]:.6f}), route: auto → the packed kernel ({routes}); "
          f"return_eigenvectors=False: wall {wall2:.3f} s, order ascending |λ| "
          f"({w2[0]:.6f} .. {w2[-1]:.6f}), max rel err {err2:.3e}  [{card}]")


def phase_eig_backends(op32, head, lap_cfg, card: str, nx: int = 512):
    """Phase 20: phase 4's lap2d_512_k50_b16 and phase 5's fem42_k100_b8
    with each eig backend, each held to its solve's gate; the seconds of a
    factorization (the Timer's "eig_poll" and "eig" sections, the worker's
    polls and the serial final one, over their count)."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch import native
    from rbl_tpu_torch.ops.eig import eig_banded_host
    from rbl_tpu_torch.utils.profiling import Timer

    t0 = time.perf_counter()
    native.build()
    print(f"host library (csrc/host/*.cpp, g++) built in {time.perf_counter() - t0:.2f} s")
    warm = np.random.default_rng(0).standard_normal((9, 64))
    for bk in ("scipy", "native", "device"):
        eig_banded_host(warm, backend=bk, device=op32.device)
    lap = rt.Laplacian2D(nx, nx, dtype=torch.float32, device=op32.device)
    for bk in ("banded_host", "native", "device"):
        rows = []
        for label in (f"lap2d {nx}² k=50 b=16", "fem42 k=100 b=8"):
            timer = Timer()
            if label.startswith("lap"):
                t0 = time.perf_counter()
                res = rt.rbl(lap, 50, cfg=lap_cfg.replace(eig_backend=bk, seed=1),
                             timer=timer)
                sync(op32.device)
                wall = time.perf_counter() - t0
                err = laplacian_check(res.eigenvalues, nx)
                if not err < 0.025:
                    raise AssertionError(f"lap2d eig_backend={bk}: eigenvalues off "
                                         f"by {err:.3f}")
            else:
                res, wall, err = fem_solve(op32, 100, 8, head, timer=timer,
                                           label=f"fem42 eig_backend={bk}",
                                           eig_backend=bk)
            polls = timer.counts["eig_poll"] + timer.counts["eig"]
            secs = timer.times["eig_poll"] + timer.times["eig"]
            rows.append(f"{label}: wall {wall:.3f} s, max rel err {err:.3e}, "
                        f"kryl_dim {res.kryl_dim}, {polls} factorizations at "
                        f"{secs / max(polls, 1) * 1e3:.2f} ms each, "
                        f"host wait on polls {timer.times['eig_wait']:.3f} s")
        print(f"eig_backend={bk}: " + "; ".join(rows) + f"  [{card}]")


def phase_scipy_pencil_svd(card: str, device: str = "cuda", small_nx: int = 16,
                           m: int = 20_000, n: int = 2_000):
    """Phase 21: eigsh(K, 8, M=M, sigma=0) on phase 17's fem3d-16 against
    scipy's factorized eigsh within 1e-8, preconditioned by the
    smoothed-aggregation AMG that eigsh's auto route builds for this
    operand (n = 13,872 ≥ 4,000, σ at the bottom), built once here and
    passed as ``inner_psolve`` so that its levels can be printed;
    svds(B, k=10) and svds(B, k=10, which="SM") on phases 15's and 18's
    dense factors against rbl_svd's values within 1e-8, ascending."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    K = fem_elasticity_3d(small_nx)
    mass = lumped_mass(small_nx)
    M = sp.diags(mass)
    cfg = rt.RBLConfig(device=device)  # scipy's call, on the card by default
    t0 = time.perf_counter()
    ref = np.sort(spla.eigsh(K, 8, M=M, sigma=0.0, which="LM",
                             return_eigenvectors=False))
    eigsh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    amg = rt.AssembledMultigrid.smoothed_aggregation(K, dtype=torch.float64,
                                                     device=device)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w, X = rt.eigsh(K, 8, M=M, sigma=0.0, cfg=cfg, inner_psolve=amg.psolve)
    wall = time.perf_counter() - t0
    err = float(np.max(np.abs(w - ref) / ref))
    resid = float(np.linalg.norm(K @ X - (mass[:, None] * X) * w, axis=0).max())
    orth = float(np.abs(X.T @ (mass[:, None] * X) - np.eye(8)).max())
    if not (err < 1e-8 and np.all(np.diff(w) >= 0) and orth < 1e-8):
        raise AssertionError(f"eigsh(K, 8, M, sigma=0) fem3d-16: max rel err "
                             f"{err:.3e} against scipy, max |XᵀMX − I| {orth:.3e}")
    print(f"eigsh(fem3d-16 K, 8, M=lumped, sigma=0) (SA AMG, {amg.report()}, "
          f"set up in {setup_s:.3f} s): wall {wall:.3f} s, "
          f"max rel err against scipy's factorized eigsh {err:.3e} (scipy "
          f"{eigsh_s:.2f} s on the host), max ‖K·x − λ·M·x‖ {resid:.3e}, max "
          f"|XᵀMX − I| {orth:.3e}  [{card}]")
    del amg

    for which, seed, s in (("LM", 15, 0.9 ** torch.arange(
            n, dtype=torch.float64, device=device)), ("SM", 18, sm_spectrum(n, device))):
        B = dense_factor(seed, s, m, device)
        Bh = B.cpu().numpy()
        t0 = time.perf_counter()
        U, sv, Vh = rt.svds(Bh, k=10, which=which, cfg=cfg)
        wall = time.perf_counter() - t0
        res = rt.rbl_svd(B, 10, 8, cfg=cfg.replace(tol=1e-10), which=which)
        want = np.sort(res.s)
        err = rel_diff(sv, want)
        back = float(np.abs(Bh @ Vh.T - U * sv).max())
        if not (np.all(np.diff(sv) >= 0) and err < 1e-8 and back < 1e-8
                and U.shape == (m, 10) and Vh.shape == (10, n)):
            raise AssertionError(f"svds(B, 10, which={which!r}): max rel err "
                                 f"{err:.3e} against rbl_svd, max |B·V − U·s| "
                                 f"{back:.3e}")
        print(f"svds(dense {m}×{n} of phase {seed}, k=10, which={which!r}): wall "
              f"{wall:.3f} s incl. the copies, s ascending {sv[0]:.6f} .. "
              f"{sv[-1]:.6f}, max rel err against rbl_svd (tol 1e-10) {err:.3e}, "
              f"max |B·V − U·diag(s)| {back:.3e}  [{card}]")
        del B, Bh


def phase_load_and_trace(op32, card: str, small_nx: int = 16):
    """Phase 22: fem3d-16 through a .mtx file, the native reader against
    scipy.io.mmread; one fem42 b=8 apply inside trace(), whose exported
    trace must hold the packed kernel's device events by name."""
    import json

    import scipy.io
    import scipy.sparse as sp

    from rbl_tpu_torch.native import read_matrix_market
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d
    from rbl_tpu_torch.utils.profiling import trace
    from rbl_tpu_torch.utils.suitesparse import load_matrix

    K = fem_elasticity_3d(small_nx)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fem16.mtx")
        scipy.io.mmwrite(path, K, symmetry="symmetric")
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        An = read_matrix_market(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        As = scipy.io.mmread(path)
        scipy_s = time.perf_counter() - t0
        L = load_matrix(path)
        same = abs(An.tocsr() - sp.csr_matrix(As)).max()
        off = abs(L - K).max() / abs(K).max()
        if not (An.shape == As.shape and same == 0 and off < 1e-15):
            raise AssertionError(f"fem3d-16 .mtx: native vs mmread differ by {same}, "
                                 f"load_matrix vs the assembled K by {off:.3e}")
        print(f"fem3d-16 .mtx ({mb:.1f} MB, {K.nnz} nonzeros, symmetric storage): "
              f"native reader {native_s:.3f} s, scipy.io.mmread {scipy_s:.3f} s, "
              f"equal entries; load_matrix against the assembled K {off:.1e}  [{card}]")

        X = padded_x(op32, 8, seed=22)[: op32._n]
        op32.apply(X)
        sync(op32.device)
        log = os.path.join(d, "trace")
        with trace(log):
            op32.apply(X)
            sync(op32.device)
        with open(os.path.join(log, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "bsr_spmm_kernel" in e.get("name", "")]
    if not kern:
        names = sorted({e.get("name", "")[:60] for e in events
                        if e.get("cat") == "kernel"})
        raise AssertionError(f"trace(): no bsr_spmm_kernel device event; kernels "
                             f"seen: {names}")
    print(f"trace() of one fem42 b=8 apply: {len(kern)} device event(s) of "
          f"csrc/bsr_spmm.cu's kernel, {kern[0]['name'][:80]!r}, "
          f"{kern[0].get('dur', 0):.1f} µs  [{card}]")


def gappy_ragged():
    """ragged_matrix with rows and columns 1024-1535 removed: block-rows with
    no nonzero at every tile height up to 128."""
    import scipy.sparse as sp

    R = ragged_matrix()
    keep = np.ones(R.shape[0])
    keep[1024:1536] = 0.0
    D = sp.diags(keep)
    return (D @ R @ D).tocsr()


def panel_calls(op, X, hcount=None):
    """(kernel call, plain call) of B4 on the panels of ``op`` and X, with
    ``op``'s chunk counts or ``hcount``."""
    from rbl_tpu_torch.ops.spmm import bsr

    args = (op.tile_cols, op.hcount if hcount is None else hcount, op.rptr,
            op.vals, X)
    kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
    return (lambda: bsr.bsr_spmm_panel(*args, H=op.H, **kw),
            lambda: bsr.bsr_spmm_panel_reference(*args, **kw))


def tiles_of_panels(op):
    """The panels of ``op`` repacked as B1's (T, bm, bk) tiles."""
    T = op.tile_cols.shape[0]
    return (op.vals.reshape(T // op.unroll, op.unroll, op.bk, op.bm)
            .transpose(2, 3).reshape(T, op.bm, op.bk).contiguous())


def b1_call(op, tiles, X):
    """B1 (the resident packed entry point) on ``op``'s plan and X."""
    from rbl_tpu_torch.ops.spmm import bsr

    return lambda: bsr.bsr_spmm_packed_resident(
        op.tile_cols, op.hcount, op.rptr, tiles, X, bm=op.bm, bk=op.bk, H=op.H,
        unroll=op.unroll)


def plan_text(p: dict) -> str:
    return (f"{p['stages']} stages of kc {p['kc']}, R×C {p['R']}×{p['C']}, "
            f"K-split {p['ksplit']}, {p['threads']} threads, {p['smem_bytes']} B")


def check_panel_shapes(card: str):
    """B4 against its plain version, f32 (1e-5) and f64 (1e-12), at the
    shapes the ragged loop leaves out: bk 32 and 64 beside 128, b = 1 and
    b = 33 (two column groups), block-rows that hold no nonzero given no
    chunk at all (hcount 0), and block-rows with more chunks than the ring
    has stages (the heavy row at U = 1)."""
    import torch

    from rbl_tpu_torch.ops.spmm import _kernels, bsr

    R = gappy_ragged()
    checked, deep = 0, []
    for dtype in (torch.float32, torch.float64):
        for bm, bk, U in ((64, 32, 4), (64, 64, 2), (16, 128, 1), (128, 64, 1),
                          (100, 32, 1), (5, 64, 2)):
            op = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, bk=bk,
                                                    unroll=U, panel=True,
                                                    device="cuda")
            per_row = np.add.reduceat(np.diff(R.indptr), np.arange(0, R.shape[0], bm))
            hc = op.hcount.clone()
            hc[torch.from_numpy(per_row == 0).to(hc.device)] = 0
            if not (hc == 0).any():
                raise AssertionError(f"bm={bm}: no block-row without a chunk")
            for b in (1, 8, 33):
                plan = _kernels.panel_plan(bm, b, dtype, bk=bk)
                X = padded_x(op, b, seed=b)
                for h, note in ((None, ""), (hc, ", empty rows with hcount 0")):
                    call, plain = panel_calls(op, X, h)
                    check(f"bsr_spmm_panel gappy bm={bm} bk={bk} U={U} b={b}{note}",
                          call, plain, dtype)
                    checked += 1
                if int(op.hcount.max()) > plan["stages"]:
                    deep.append(f"bm={bm} bk={bk} U={U} b={b}: {int(op.hcount.max())} "
                                f"chunks > {plan['stages']} stages")
    if not deep:
        raise AssertionError("no checked block-row had more chunks than the ring "
                             "has stages")
    print(f"bsr_spmm_panel (B4) on the gappy ragged matrix: {checked} checks within "
          f"tolerance (bk 32/64/128, b 1/8/33, f32 and f64, with and without "
          f"hcount-0 rows); deep rows: {'; '.join(deep[:4])}")


def panel_fem42(A, csr32, kernels: dict, card: str):
    """B4 on fem42's panel layout of the auto plan at b = 8, f32 and f64:
    held to its plain version, then timed beside B1 on the same plan (the
    panels repacked as tiles), B7 over the same bytes (f32), the plain
    version and torch.sparse CSR; the plan of each timed shape."""
    import torch

    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.ops.spmm.operator import cast_operator

    t0 = time.perf_counter()
    pan64 = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, panel=True,
                                               device="cuda")
    print(f"fem42 panel operator (auto plan bm={pan64.bm}, unroll={pan64.unroll}, "
          f"{pan64.vals.shape[0]} panels) built in {time.perf_counter() - t0:.1f} s")
    b = 8
    seed = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    for op in (cast_operator(pan64, torch.float32), pan64):
        dt = str(op.dtype)[6:]
        X = padded_x(op, b, seed=b)
        call, plain = panel_calls(op, X)
        abs_err, rel = check(f"bsr_spmm_panel fem42 b={b}", call, plain, op.dtype)
        tiles = tiles_of_panels(op)
        b1 = b1_call(op, tiles, X)
        csr = csr32 if op.dtype == torch.float32 else torch_csr(A, op.dtype)
        Xl = X[: A.shape[0]]
        lib = lambda: torch.sparse.mm(csr, Xl)
        # in turns: B4, B1, B1, B4 (single calls, then back to back)
        ms, b1_ms, b1_ms2, ms2 = (time_ms(f) for f in (call, b1, b1, call))
        ms, b1_ms = min(ms, ms2), min(b1_ms, b1_ms2)
        seq = {name: tds.kernel_ms(f) for name, f in (("B4", call), ("B1", b1))}
        plain_ms, lib_ms = time_ms(plain), time_ms(lib)
        lim = bound(*sparse_need(op.vals, A.shape[0], b))
        plan = _kernels.panel_plan(op.bm, b, op.dtype, bk=op.bk)
        mb = op.vals.numel() * op.vals.element_size() / 1e6
        extra = ""
        if op.dtype == torch.float32:
            flat = op.vals.view(-1, 128)
            CH = op.bm * op.unroll
            S = flat.shape[0] // CH
            b7 = lambda: tds.dma_stream_manual(flat, seed, S=S, CH=CH)
            b7_ms = time_ms(b7)
            seq["B7"] = tds.kernel_ms(b7)
            extra = (f", B7 over the same {mb:.1f} MB {b7_ms:.4f} ms (B4 at "
                     f"{b7_ms / ms:.0%} of its rate; back to back B4 "
                     f"{seq['B4']:.4f}, B1 {seq['B1']:.4f}, B7 {seq['B7']:.4f} ms)")
            kernels["bsr_spmm_panel"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **lim, b1_same_plan_ms=b1_ms, b7_same_bytes_ms=b7_ms,
                back_to_back_ms=seq, plan=plan)
        else:
            kernels["bsr_spmm_panel"].update(
                f64_max_abs_err=abs_err, f64_ms=ms, f64_plain_ms=plain_ms,
                f64_library_ms=lib_ms, f64_bound_ms=lim["bound_ms"],
                f64_b1_same_plan_ms=b1_ms, f64_back_to_back_ms=seq, f64_plan=plan)
            extra = f", back to back B4 {seq['B4']:.4f}, B1 {seq['B1']:.4f} ms"
        print(f"bsr_spmm_panel (B4) fem42 plan ({op.bm}, {op.unroll}) b={b} {dt}: rel "
              f"err {rel:.2e}, kernel {ms:.4f} ms ({mb / ms:.0f} GB/s of panels), "
              f"B1 on the same plan {b1_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.sparse CSR {lib_ms:.4f} ms, bound {lim['bound_ms']:.4f} ms "
              f"({lim['bound_ms'] / ms:.1%}){extra}; plan {plan_text(plan)}  [{card}]")
        del tiles, X, csr
    del pan64
    torch.cuda.empty_cache()


def panel_bk_sweep(A, csr32, card: str):
    """B4 on fem42 at bk 32, 64 and 128, each on pick_tile_plan(A, bk)'s
    plan, f32, b = 8: the stored panel MB, the fill, B4, B1 on the same
    plan, torch.sparse CSR and the share of the nonzeros' bound; returns
    the rows."""
    import torch

    from rbl_tpu_torch.ops.spmm import _kernels, bsr

    rows = []
    b = 8
    for bk in (32, 64, 128):
        t0 = time.perf_counter()
        bm, U = bsr.pick_tile_plan(A, bk=bk)
        op = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=bm, bk=bk,
                                                unroll=U, panel=True, device="cuda")
        pack_s = time.perf_counter() - t0
        X = padded_x(op, b, seed=b)
        call, plain = panel_calls(op, X)
        check(f"bsr_spmm_panel fem42 bk={bk} b={b}", call, plain, op.dtype)
        tiles = tiles_of_panels(op)
        b1 = b1_call(op, tiles, X)
        ms, b1_ms, b1_ms2, ms2 = (time_ms(f) for f in (call, b1, b1, call))
        Xl = X[: A.shape[0]]
        lib_ms = time_ms(lambda: torch.sparse.mm(csr32, Xl))
        lim = bound(*sparse_need(op.vals, A.shape[0], b))
        stored = op.vals.numel()
        row = dict(bk=bk, bm=bm, unroll=U, stored_mb=stored * 4 / 1e6,
                   fill=A.nnz / stored, ms=min(ms, ms2), b1_ms=min(b1_ms, b1_ms2),
                   library_ms=lib_ms, bound_ms=lim["bound_ms"],
                   bound_share=lim["bound_ms"] / min(ms, ms2), pack_s=pack_s,
                   plan=_kernels.panel_plan(bm, b, torch.float32, bk=bk))
        rows.append(row)
        print(f"bk sweep fem42 bk={bk}: plan ({bm}, {U}), {row['stored_mb']:.1f} MB of "
              f"panels, fill {row['fill']:.3f}, B4 {row['ms']:.4f} ms, B1 "
              f"{row['b1_ms']:.4f} ms, torch.sparse CSR {lib_ms:.4f} ms, "
              f"{row['bound_share']:.1%} of the {lim['bound_ms']:.4f} ms bound; "
              f"packed in {pack_s:.1f} s; plan {plan_text(row['plan'])}  [{card}]")
        del op, X, tiles
        torch.cuda.empty_cache()
    return rows


def torch_gates():
    """tests/_torch_gates.py: the JAX package's exact-spectrum cases and
    the loader of the examples/ scripts."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_gates

    return _torch_gates


def example_sweep(bench, argv, gate, label: str, card: str):
    """One examples/torch_benchmark.py sweep through its ``main``; each
    solve's eigenvalues must pass ``gate`` (a function returning the
    error, raising past its tolerance).  Returns the operator it solved
    and the B1 launches of the sweep."""
    from rbl_tpu_torch.ops.spmm import bsr

    n0 = bsr.bsr_spmm_packed_resident.launches
    runs, op = bench.main(argv)
    launches = bsr.bsr_spmm_packed_resident.launches - n0
    for b, reps in runs.items():
        errs = [gate(res.eigenvalues, f"{label} b={b}") for res, _ in reps]
        res, _ = reps[-1]
        walls = ", ".join(f"{w:.3f}" for _, w in reps)
        print(f"25 {label} b={b}: walls {walls} s (cold first), max rel err "
              f"{max(errs):.3e}, kryl_dim {res.kryl_dim}, converged "
              f"{res.converged}, {type(op).__name__}, B1 launches {launches}  "
              f"[{card}]")
    return op, launches


def phase_examples(head: np.ndarray, card: str):
    """Phase 25: the port's three examples through their ``main``, as a
    user runs them on the card.  (a) examples/torch_benchmark.py on fem42
    (k = 100; tol 1e-3; f32), one sweep at b = 4 and one at b = 8, each
    solve's head 90 within 1e-2 of the ARPACK ground truth, each sweep on
    BSR and launching B1; (b) the same on the 512² Laplacian (b = 16, k =
    50), within bench.py's 0.025 of the analytic spectrum; (c)
    examples/torch_images.py at its defaults (480 × 640, rank 50, f64):
    σ within 1e-8 of numpy's SVD, the relative Frobenius error within
    1e-6 relative of the exact truncation's; (d) examples/
    torch_generalized.py at its defaults (n = 2,000, k = 6): the
    vibration and mode-3 eigenvalues within 1e-8 of dense
    scipy.linalg.eigh(K, M), the buckling values within 1e-6 of the dense
    oracle the example computes, the 3-D AMG solve's residual ≤ 1e-6·‖A‖.
    Prints B1's launches by part; returns fem42's operator of each sweep
    (by b) and the 3-D solve's AMG hierarchy, for the shape checks."""
    import scipy.linalg
    import scipy.sparse.linalg as spla

    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    G = torch_gates()
    bench = G.load_example("torch_benchmark")
    dev = ["--device", "cuda"]
    B1 = bsr.bsr_spmm_packed_resident

    def fem_gate(w, label):
        err = float(np.max(np.abs(np.asarray(w)[: len(head)] - head) / head))
        if not err < 1e-2:
            raise AssertionError(f"{label}: max rel error {err:.3e} vs ARPACK head ≥ 1e-2")
        return err

    def lap_gate(w, label):
        err = laplacian_check(w, 512)
        if not err < 0.025:
            raise AssertionError(f"{label}: eigenvalues off by {err:.3e} ≥ 0.025")
        return err

    split, fem_ops = {}, {}
    for b in (4, 8):
        op, split[f"fem42 b={b}"] = example_sweep(
            bench, ["--fem3d", "42", "--k", "100", "--blocks", str(b), "--tol",
                    "1e-3", "--repeat", "2", *dev], fem_gate, "fem42", card)
        if not isinstance(op, bsr.BlockSparseOperator):
            raise AssertionError(f"fem42 b={b}: the example's operator took the "
                                 f"{type(op).__name__} route, not BSR")
        if split[f"fem42 b={b}"] < 1:
            raise AssertionError(f"fem42 b={b}: the example's sweep never launched B1")
        fem_ops[b] = op
    _, split["lap2d 512² b=16"] = example_sweep(
        bench, ["--laplacian", "512", "--k", "50", "--blocks", "16", "--tol",
                "1e-3", "--repeat", "2", *dev], lap_gate, "lap2d 512²", card)

    n0 = B1.launches
    img = G.load_example("torch_images").main(dev)
    split["images"] = B1.launches - n0
    k = len(img["sigma"])
    s_ref = img["S_svd"][:k]
    s_err = float(np.max(np.abs(img["sigma"] - s_ref) / s_ref))
    f_err = abs(img["err_rbl"] - img["err_svd"]) / img["err_svd"]
    if not (s_err < 1e-8 and f_err < 1e-6):
        raise AssertionError(f"images rank {k}: σ off by {s_err:.3e} (gate 1e-8), "
                             f"Frobenius error off by {f_err:.3e} (gate 1e-6)")
    print(f"25 images 480×640 rank {k} f64: rbl_svd {img['t_rbl']:.3f} s (svds "
          f"{img['t_svds']:.3f} s, full SVD {img['t_svd']:.3f} s on the host), σ "
          f"max rel err {s_err:.3e}, Frobenius error {img['err_rbl']:.6e} "
          f"({f_err:.3e} from the exact truncation's)  [{card}]")

    gen_mod = G.load_example("torch_generalized")
    n0 = B1.launches
    gen = gen_mod.main(dev)
    split["generalized"] = B1.launches - n0
    n, k = 2000, len(gen["vibration"])
    K, M = gen_mod.fem_bar(n)
    w = scipy.linalg.eigh(K.toarray(), M.toarray(), eigvals_only=True)
    near = w[np.argsort(np.abs(w - gen["sigma3"]), kind="stable")[:k]]
    errs = {
        "vibration": (np.max(np.abs(gen["vibration"] - w[:k]) / w[:k]), 1e-8),
        "mode 3": (np.max(np.abs(gen["mode3"] - near) / near), 1e-8),
        "buckling": (np.max(np.abs(gen["buckling"] - gen["buckling_dense"])
                            / np.abs(gen["buckling_dense"])), 1e-6),
    }
    A3 = fem_elasticity_3d(8)
    norm3 = float(spla.eigsh(A3, 1, which="LM", return_eigenvectors=False)[0])
    errs["3-D residual / ‖A‖"] = (gen["elastic3d_residual"] / norm3, 1e-6)
    bad = {name: e for name, (e, tol) in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"generalized n={n} k={k}: past the gate: {bad}")
    walls = ", ".join(f"{p} {t:.2f} s" for p, t in gen["walls"].items())
    print(f"25 generalized n={n} k={k}: " + ", ".join(
        f"{name} {e:.3e} (gate {tol:g})" for name, (e, tol) in errs.items())
        + f"; walls {walls}  [{card}]")
    print("25 B1 launches by part: " + ", ".join(f"{p} {c}" for p, c in split.items())
          + f"  [{card}]")
    return fem_ops, gen["amg3d"]


def example_path_shapes(fem_ops: dict, amg3d, kernels: dict, card: str):
    """After phase 25: both packed entry points against the plain version,
    timed, on the operator of each fem42 sweep of the benchmark example at
    that sweep's b (f32), and on every BSR level of the generalized
    example's fem3d-8 grid AMG at the 3-D solve's b = 4 (f64; eigsh's
    block for k = 4); rows in ``kernels[entry]["path_shapes"]``."""
    from rbl_tpu_torch.ops.spmm import bsr

    for b, op in fem_ops.items():
        level_shape_rows(op, "fem42 (torch_benchmark)", kernels, card, phase=25, b=b)
    routes = [type(lv.op).__name__ for lv in amg3d.levels]
    print(f"25 fem3d-8 grid AMG (torch_generalized) levels: {routes}  [{card}]")
    for i, lv in enumerate(amg3d.levels):
        if isinstance(lv.op, bsr.BlockSparseOperator):
            level_shape_rows(lv.op, f"fem3d-8 AMG level {i} (torch_generalized)",
                             kernels, card, phase=25, b=4)


def phase_reference_gates(card: str):
    """Phase 26: the JAX package's exact-spectrum gates on the card, each
    at its own tolerance (tests/_torch_gates.py holds the cases, which the
    CPU tests run too): tests/test_spectra.py's (norm of the relative
    errors < 1e-13, k = b = 5), the fuzz shapes at seeds 0 and 1, with
    adaptive_reorth_max=4, the narrow window, the slow separation and the
    negative dominant case, the host-offload shapes (pinned panels), the
    sparse operators against eigsh, f32 exhaustion, the restarted shapes
    (1e-10; the f32 head 1e-3), then which="LA"/"SA" and deflate=.  One
    line a group: its cases, the worst error, the wall."""
    G = torch_gates()
    device = "cuda"

    def worst(rel):
        return float(np.max(rel))

    def fuzz(name):
        return worst(G.fuzz_case(name, device)[0])

    def converged(rel, res, label):
        if not res.converged:
            raise AssertionError(f"26 {label}: not converged")
        return worst(rel)

    def sparse(case):
        return converged(*G.sparse_vs_eigsh(case, device), f"sparse {case}")

    def restarted(shape):
        return converged(*G.restarted_case(shape, device), f"restarted {shape}")

    def la():
        rel, lm = G.which_la(device)
        return max(worst(rel), lm)

    def sa_laplacian():
        rel, share = G.which_sa_laplacian(device)
        if not share < 1.0:
            raise AssertionError(f"26 SA Laplacian: residual {share:.3e} of its bound")
        return worst(rel)

    def deflate_next():
        rel, overlap = G.deflate_next_after_known(device)
        if not overlap < 1e-8:
            raise AssertionError(f"26 deflate: |VᵀW| {overlap:.3e} ≥ 1e-8")
        return worst(rel)

    def raised(ok):
        return 0.0 if ok else float("inf")

    fz = list(G.FUZZ_CASES)
    groups = [
        ("spectra (test_spectra.py)", G.SPECTRA_TOL,
         [(f"{kind} n={n}", lambda kind=kind, n=n: G.spectra_error(kind, n, device))
          for kind, n in G.GATES]),
        ("fuzz shapes, seeds 0 and 1", G.FUZZ_TOL,
         [(c, lambda c=c: fuzz(c)) for c in fz if c.startswith("fuzz_")]),
        ("fuzz, adaptive_reorth_max=4", G.FUZZ_TOL,
         [(c, lambda c=c: fuzz(c)) for c in fz if c.startswith("adaptive_")
          and c != "adaptive_slow_separation"]),
        ("narrow window, slow separation, negative dominant", G.FUZZ_TOL,
         [(c, lambda c=c: fuzz(c)) for c in ("grown_chunks_narrow_window",
                                             "adaptive_slow_separation",
                                             "negative_dominant")]),
        ("host offload (basis_device_cap_cols=64)", G.FUZZ_TOL,
         [(c, lambda c=c: fuzz(c)) for c in fz if c.startswith("host_offload_")]),
        ("sparse operators vs eigsh", G.FUZZ_TOL,
         [(c, lambda c=c: sparse(c)) for c in G.SPARSE_CASES]),
        ("f32 exhaustion, top 10", G.F32_HEAD_TOL,
         [("f32", lambda: G.f32_exhaustion_head_error(*G.f32_exhaustion(device)))]),
        ("restarted shapes", G.FUZZ_TOL,
         [(s, lambda s=s: restarted(s)) for s in sorted(G.RESTARTED_SHAPES)]),
        ('which="LA"', G.LA_TOL, [("sign-mixed diagonal", la)]),
        ('which="SA"', G.SA_TOL, [("24² Laplacian", sa_laplacian),
                                  ("sparse vs eigsh", lambda: worst(G.which_sa_sparse(device)))]),
        ("deflate=", G.DEFLATE_TOL,
         [("next after known", deflate_next)]
         + [(c, lambda c=c: worst(G.deflate_case(c, device))) for c in G.DEFLATE_CASES]),
        ("validation raises ValueError", 1.0,
         [("which=BE", lambda: raised(G.which_validation_raises(device))),
          ("deflate shape", lambda: raised(G.deflate_shape_raises(device)))]),
    ]
    total = 0
    for name, tol, cases in groups:
        t0 = time.perf_counter()
        errs = []
        for label, fn in cases:
            err = fn()
            if not err < tol:
                raise AssertionError(f"26 {name}, {label}: error {err:.3e} ≥ {tol:g}")
            errs.append(err)
        sync(device)
        total += len(cases)
        print(f"26 {name}: {len(cases)} cases, worst {max(errs):.3e} (gate {tol:g}), "
              f"{time.perf_counter() - t0:.2f} s  [{card}]")
    print(f"26: {total} cases at the reference's tolerances on {device}")


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--scipy-mesh-worker":
        return scipy_mesh_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    torch.set_float32_matmul_precision("highest")  # plain versions in full FP32
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    packed = (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed)
    every = (*packed, bsr.bsr_spmm, bsr.bsr_spmm_panel)
    probes = (tds.dma_stream, tds.dma_stream_dot, tds.dma_stream_manual)

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels._libraries()
    print(f"build: {', '.join(sorted(libs))} in {time.perf_counter() - t0:.2f} s")

    # --- 3. packed kernel against its plain version -----------------------
    t0 = time.perf_counter()
    A = fem_elasticity_3d(42)
    print(f"fem42: n={A.shape[0]} nnz={A.nnz}, assembled in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    op32 = rt.as_operator(A, dtype=torch.float32, device="cuda", format="bsr")
    print(f"fem42 packed operator (bm={op32.bm}, unroll={op32.unroll}, "
          f"tiles={op32.nnz_blocks}, vals {op32.vals.numel() * 4 / 1e6:.1f} MB f32) "
          f"built in {time.perf_counter() - t0:.1f} s")
    op64 = bsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.float64, bm=op32.bm, unroll=op32.unroll, device="cuda")
    kernels = {}
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        for op in (op32, op64):
            abs_err, rel, ms, plain_ms, moved, ops = compare_entry(
                entry, op, b, seed=b, timing=True)
            gbs = op.vals.numel() * op.vals.element_size() / (ms * 1e-3) / 1e9
            print(f"{entry} fem42 b={b} {op.dtype}: rel err {rel:.2e}, "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of vals), "
                  f"plain {plain_ms:.4f} ms  [{card}]")
            if op is op32:
                kernels[entry] = dict(max_abs_err=abs_err, ms=ms,
                                      plain_ms=plain_ms, **bound(moved, ops))
    del op64
    R = ragged_matrix()
    for dtype in (torch.float32, torch.float64):
        for bm, U in ((16, 4), (128, 8)):
            op = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, unroll=U,
                                                    device="cuda")
            for entry in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
                for b in (5, 8, 16, 40):
                    compare_entry(entry, op, b, seed=b, timing=False)
    print(f"ragged n={R.shape[0]}: both entry points, f32 and f64, bm 16/128, "
          "b 5/8/16/40 within tolerance")

    # --- 4./5. the main path ------------------------------------------------
    head = np.load(GROUNDTRUTH)["eigenvalues"][:90]
    reset_launches(*every)
    t_main = time.perf_counter()
    lap = rt.Laplacian2D(512, 512, dtype=torch.float32, device="cuda")
    cfg = rt.RBLConfig(block_size=16, basis_dtype=torch.bfloat16,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=768, eig_poll_cadence=16)
    for seed in (0, 1):  # the second, warm run is timed
        t0 = time.perf_counter()
        res = rt.rbl(lap, 50, cfg=cfg.replace(seed=seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lap_err = laplacian_check(res.eigenvalues, 512)
    if not lap_err < 0.025:
        raise AssertionError(f"lap2d 512²: eigenvalues off by {lap_err:.3f}")
    print(f"lap2d 512² k=50 b=16 (bench config): warm wall {wall:.3f} s, "
          f"max rel err {lap_err:.3e}, kryl_dim {res.kryl_dim}, "
          f"converged {res.converged}  [{card}]")
    fem_res, fem_wall = {}, {}
    for b in (8, 16):
        res, wall, err = fem_solve(op32, 100, b, head)
        fem_res[b], fem_wall[b] = res, wall
        print(f"fem42 k=100 b={b} f32: wall {wall:.3f} s, max rel err (ARPACK "
              f"head 90) {err:.3e}, kryl_dim {res.kryl_dim}, converged "
              f"{res.converged}, launches resident="
              f"{bsr.bsr_spmm_packed_resident.launches} streaming="
              f"{bsr.bsr_spmm_packed.launches}  [{card}]")
    launches = {f.__name__: f.launches for f in every}
    by_phase = {name: {} for name in KERNELS}
    print(f"main path: {time.perf_counter() - t_main:.1f} s")
    for f in packed:
        by_phase[f.__name__]["4-5"] = launches[f.__name__]
        if launches[f.__name__] < 1:
            raise AssertionError(f"main path never launched {f.__name__}")

    # --- 11.-14. the long-solve paths, each read on its own ------------------
    def long_phase(number, must_launch, fn, *args):
        reset_launches(*every)
        t0 = time.perf_counter()
        out = fn(*args)
        counts = {f.__name__: f.launches for f in packed}
        for f in must_launch:
            if counts[f.__name__] < 1:
                raise AssertionError(f"phase {number} never launched {f.__name__}")
        for name, c in counts.items():
            by_phase[name][str(number)] = c
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s, launches {counts}")
        return out

    B1, B2 = packed
    long_phase(11, (B1,), phase_host_tier, op32, head, fem_res[8], fem_wall[8], card)
    long_phase(12, (B1,), phase_sweep_checkpoint, op32, head, fem_res[8], card)
    long_phase(13, (B1,), phase_restarted, op32, head, card)
    op64, width = long_phase(14, (B1, B2), phase_polish, A, head, card)
    # the polish's own shape: both entry points at its width on fem42's
    # plan, in the f32 of its filter chains and the f64 of its Rayleigh-Ritz
    if (op64.bm, op64.unroll) != (op32.bm, op32.unroll):
        raise AssertionError(f"fem42's f64 plan ({op64.bm}, {op64.unroll}) differs "
                             f"from the f32 one ({op32.bm}, {op32.unroll})")
    # (and at 90 columns, the widest chain the filters have run, for its bound)
    for entry in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
        for op in (op32, op64):
            for cols in (width, 90):
                abs_err, rel, ms, plain_ms, moved, ops = compare_entry(
                    entry, op, cols, seed=cols, timing=True)
                lim = bound(moved, ops)
                kernels[entry].setdefault("path_shapes", []).append(dict(
                    phase=14, shape=f"fem42 plan ({op.bm}, {op.unroll}) "
                    f"{str(op.dtype)[6:]} b={cols}", max_abs_err=abs_err, ms=ms,
                    plain_ms=plain_ms, **lim))
                print(f"{entry} fem42 b={cols} {op.dtype} (the polish's width "
                      f"{width}, the filters' widest 90): rel err {rel:.2e}, kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{lim['bound_ms']:.4f} ms ({lim['bound_ms'] / ms:.0%})  [{card}]")
    del op64
    # the library's time for the same product at the filter chains' widths
    for dtype in (torch.float32, torch.float64):
        csr = torch_csr(A, dtype)
        for cols in (width, 90):
            g = torch.Generator(device="cuda").manual_seed(cols)
            Xl = torch.randn((A.shape[0], cols), generator=g, dtype=dtype,
                             device="cuda")
            lib_ms = time_ms(lambda: torch.sparse.mm(csr, Xl))
            kernels["bsr_spmm_packed"][f"library_ms_b{cols}_{str(dtype)[6:]}"] = lib_ms
            print(f"torch.sparse CSR fem42 b={cols} {dtype}: {lib_ms:.4f} ms  [{card}]")
        del csr, Xl

    # --- 6. blocked-ELL (B3) and panel (B4) against their plain versions --
    t6 = time.perf_counter()
    csr32 = torch_csr(A, torch.float32)
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        Xl = padded_x(op32, b, seed=b)[: A.shape[0]]
        kernels[entry]["library_ms"] = time_ms(lambda: torch.sparse.mm(csr32, Xl))
    fem_op = op32  # phase 10 streams B1's own tiles
    del op32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bc, bv, _, ncb, L = bsr._blocked_ell_from_scipy(A, 128, 128, np.float64)
    bc = torch.from_numpy(bc.reshape(-1)).cuda()
    bv64 = torch.from_numpy(bv.reshape(-1, 128, 128)).cuda()
    del bv
    print(f"fem42 blocked-ELL bm=128: L={L}, {bc.shape[0]} tiles, "
          f"{bv64.numel() * 4 / 1e6:.1f} MB f32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    # B3's user path: the solver has no blocked-ELL caller (nor has the JAX
    # package), so its entry point checks the phase-5 eigenpairs: A·V of
    # the b=8 fem42 solve through bsr_spmm, against torch.sparse CSR, and
    # the true residuals ‖A·v − λv‖/|λ| it gives
    V = fem_res[8].eigenvectors.float()
    lam = torch.as_tensor(fem_res[8].eigenvalues.copy(), dtype=torch.float32,
                          device="cuda")
    Vp = torch.nn.functional.pad(V, (0, 0, 0, ncb * 128 - A.shape[0])).contiguous()
    bv32 = bv64.float()
    reset_launches(*every)
    AV = bsr.bsr_spmm(bc, bv32, Vp, bm=128, bk=128, L=L)[: A.shape[0]]
    torch.cuda.synchronize()
    launches["bsr_spmm"] = by_phase["bsr_spmm"]["6"] = bsr.bsr_spmm.launches
    AV_csr = torch.sparse.mm(csr32, V)
    path_err = float((AV - AV_csr).abs().max() / AV_csr.abs().max())
    resid = ((AV - V * lam[None, :]).norm(dim=0) / lam.abs()).max().item()
    if not (path_err < TOL["float32"] and np.isfinite(resid)):
        raise AssertionError(f"bsr_spmm on the fem42 Ritz vectors: rel err "
                             f"{path_err:.3e} against torch.sparse CSR")
    if launches["bsr_spmm"] < 1:
        raise AssertionError("the Ritz-vector check never launched bsr_spmm")
    print(f"bsr_spmm (B3) on the 100 fem42 Ritz vectors of phase 5: rel err "
          f"{path_err:.2e} against torch.sparse CSR, max true residual "
          f"{resid:.3e} (|λ|-relative), launches {launches['bsr_spmm']}")
    del bv32, AV, AV_csr, Vp
    for dtype in (torch.float32, torch.float64):
        bvd = bv64.to(dtype)
        for b in (8, 16):
            g = torch.Generator(device="cuda").manual_seed(b)
            X = torch.randn((ncb * 128, b), generator=g, dtype=dtype, device="cuda")
            call = lambda: bsr.bsr_spmm(bc, bvd, X, bm=128, bk=128, L=L)
            plain = lambda: bsr.bsr_spmm_reference(bc, bvd, X, bm=128, bk=128, L=L)
            abs_err, rel = check(f"bsr_spmm fem42 b={b}", call, plain, dtype)
            ms, plain_ms = time_ms(call), time_ms(plain)
            lib = ""
            if dtype == torch.float32:
                Xl = X[: A.shape[0]]
                lib_ms = time_ms(lambda: torch.sparse.mm(csr32, Xl))
                lib = f", torch.sparse CSR {lib_ms:.4f} ms"
                lim = bound(*sparse_need(bvd, A.shape[0], b))
                if b == 8:
                    kernels["bsr_spmm"] = dict(
                        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, **lim)
                else:
                    kernels["bsr_spmm"].update(
                        b16_ms=ms, b16_plain_ms=plain_ms, b16_library_ms=lib_ms,
                        b16_bound_ms=lim["bound_ms"])
                lib += f", bound {lim['bound_ms']:.4f} ms"
            print(f"bsr_spmm (B3) fem42 blocked-ELL b={b} {dtype}: rel err "
                  f"{rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}  "
                  f"[{card}]")
        del bvd
    del bc, bv64
    plans = [(name, bm, b, dt) for name, bm, b in
             (("B1", fem_op.bm, 8), ("B2", fem_op.bm, 16), ("B3", 128, 8), ("B3", 128, 16))
             for dt in (torch.float32, torch.float64)]
    print("register plans (R rows × C columns a thread, ring stages, shared bytes, "
          "threads a CTA): " + "; ".join(
              f"{name} bm={bm} b={b} {str(dt)[6:]}: ({p['R']}, {p['C']}, {p['stages']}, "
              f"{p['smem_bytes']}, {p['threads']})"
              for name, bm, b, dt in plans for p in [_kernels.spmm_plan(bm, b, dt)]))
    torch.cuda.empty_cache()
    panel_fem42(A, csr32, kernels, card)
    for dtype in (torch.float32, torch.float64):
        for bm, U in ((16, 4), (128, 8)):
            bcr, bvr, nbr, ncbr, Lr = bsr._blocked_ell_from_scipy(R, bm, 128, np.float64)
            Lp = Lr + (-Lr) % U
            bcr = torch.from_numpy(np.pad(bcr, ((0, 0), (0, Lp - Lr))).reshape(-1)).cuda()
            bvr = torch.from_numpy(np.pad(bvr, ((0, 0), (0, Lp - Lr), (0, 0), (0, 0)))
                                   .reshape(-1, bm, 128)).to("cuda", dtype)
            pan = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, unroll=U,
                                                     panel=True, device="cuda")
            for b in (5, 8, 16, 40):
                X = padded_x(pan, b, seed=b)
                check(f"bsr_spmm ragged bm={bm} b={b}",
                      lambda: bsr.bsr_spmm(bcr, bvr, X, bm=bm, bk=128, L=Lp, unroll=U),
                      lambda: bsr.bsr_spmm_reference(bcr, bvr, X, bm=bm, bk=128, L=Lp),
                      dtype)
                args = (pan.tile_cols, pan.hcount, pan.rptr, pan.vals, X)
                for gather in ("swap", "concat"):
                    check(f"bsr_spmm_panel ragged bm={bm} b={b} {gather}",
                          lambda: bsr.bsr_spmm_panel(*args, bm=bm, bk=128, H=pan.H,
                                                     unroll=U, gather=gather),
                          lambda: bsr.bsr_spmm_panel_reference(
                              *args, bm=bm, bk=128, unroll=U, gather=gather),
                          dtype)
    print(f"ragged n={R.shape[0]}: B3 and B4 (both gathers), f32 and f64, bm 16/128, "
          f"b 5/8/16/40 within tolerance")
    check_panel_shapes(card)
    kernels["bsr_spmm_panel"]["bk_sweep"] = panel_bk_sweep(A, csr32, card)
    print(f"phase 6 in {time.perf_counter() - t6:.1f} s")

    # --- 7. a solve through B4 ----------------------------------------------
    pan32 = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, panel=True,
                                               device="cuda")
    reset_launches(*every)
    res, wall, err = fem_solve(pan32, 100, 8, head, "fem42 panel")
    launches["bsr_spmm_panel"] = by_phase["bsr_spmm_panel"]["7"] = \
        bsr.bsr_spmm_panel.launches
    print(f"fem42 panel k=100 b=8 f32: wall {wall:.3f} s, max rel err (ARPACK "
          f"head 90) {err:.3e}, kryl_dim {res.kryl_dim}, converged "
          f"{res.converged}, bsr_spmm_panel launches "
          f"{bsr.bsr_spmm_panel.launches}  [{card}]")
    if bsr.bsr_spmm_panel.launches < 1:
        raise AssertionError("the panel solve never launched bsr_spmm_panel")
    del pan32
    torch.cuda.empty_cache()

    # --- 8. fem42 through each format ---------------------------------------
    names = {"DiaOperator": "dia", "SparseEllOperator": "ell",
             "HybOperator": "hyb", "CooOperator": "coo",
             "BlockSparseOperator": "bsr"}
    for fmt in ("dia", "ell", "hyb", "coo", "auto"):
        t0 = time.perf_counter()
        op = rt.as_operator(A, dtype=torch.float32, device="cuda", format=fmt)
        build_s = time.perf_counter() - t0
        route = names[type(op).__name__]
        reset_launches(*every)
        res, wall, err = fem_solve(op, 100, 8, head, f"fem42 {fmt}")
        counts = {f.__name__: f.launches for f in every if f.launches}
        X8 = res.eigenvectors[:, :8].contiguous()
        apply_ms = time_ms(lambda: op.apply(X8))
        print(f"fem42 format={fmt} (route {route}) k=100 b=8 f32: built in "
              f"{build_s:.1f} s, wall {wall:.3f} s, max rel err {err:.3e}, "
              f"kryl_dim {res.kryl_dim}, converged {res.converged}, "
              f"launches {counts}, apply {apply_ms:.4f} ms at b=8  [{card}]")
        del op
        torch.cuda.empty_cache()

    # --- 9. a skewed graph through HYB --------------------------------------
    t0 = time.perf_counter()
    G = chung_lu()
    deg = np.diff(G.indptr)
    print(f"Chung-Lu graph: n={G.shape[0]} nnz={G.nnz}, mean degree "
          f"{deg.mean():.2f}, longest row {deg.max()} "
          f"({deg.max() / deg.mean():.0f}× the mean), built in "
          f"{time.perf_counter() - t0:.1f} s")
    if not deg.max() > 64 * deg.mean():
        raise AssertionError("the graph's longest row is not above 64× the mean")
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    ref = spla.eigsh(G.astype(np.float64), k=20, which="LM",
                     return_eigenvectors=False)
    eigsh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opg = rt.as_operator(G, dtype=torch.float32, device="cuda")
    build_s = time.perf_counter() - t0
    if type(opg).__name__ != "HybOperator":
        raise AssertionError(f"format='auto' routed the graph to {type(opg).__name__}")
    reset_launches(*every)
    res, wall = solve(opg, 20, 8, "Chung-Lu")
    w = np.asarray(res.eigenvalues, dtype=np.float64)
    err = head_error(w, ref, 20)
    compared = 20
    if not err < 1e-3:
        # a cluster at the 20th magnitude: compare the first 15, as fem42
        # compares its ARPACK head
        err, compared = head_error(w, ref, 15), 15
    if not err < 1e-3:
        raise AssertionError(f"Chung-Lu k=20: max rel error {err:.3e} vs eigsh ≥ 1e-3")
    print(f"Chung-Lu format=auto (route hyb; ELL slots {opg.ell.cols.shape[0]}, "
          f"COO overflow {opg.coo.nnz}) k=20 b=8 f32 tol 1e-3: built in "
          f"{build_s:.1f} s, wall {wall:.3f} s, max rel err vs eigsh on the "
          f"first {compared} {err:.3e} (eigsh {eigsh_s:.1f} s on the host), "
          f"kryl_dim {res.kryl_dim}, converged {res.converged}  [{card}]")

    # --- 10. the tile-stream probes (B5-B7) ---------------------------------
    t10 = time.perf_counter()
    g = torch.Generator(device="cuda")
    seed0 = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    xt = torch.randn((8, 128), generator=g.manual_seed(1), device="cuda")
    seed = torch.randn((8, 128), generator=g.manual_seed(2), device="cuda")
    names = {"stream": "dma_stream", "stream_dot": "dma_stream_dot",
             "manual": "dma_stream_manual"}
    # (a) kernels against their plain versions
    checked = []
    for S, bm, U in ((None, 16, 8), (None, 128, 8), (1, 8, 2), (2, 8, 2),
                     (3, 8, 2), (3, 40, 5), (2, 125, 8), (100, 8, 2),
                     (1001, 16, 4)):
        CH = bm * U
        S = S or (256 * 2**20) // (128 * 4) // CH
        vals = torch.randn((S * CH, 128), generator=g.manual_seed(S), device="cuda")
        for name in tds.VARIANTS:
            check_probe(name, vals, seed, xt, bm, U)
        checked.append(f"S={S} ({bm}, {U})")
        del vals
    fem_vals, fem_plan = fem_op.vals, (fem_op.bm, fem_op.unroll)
    fem_bm, fem_U = fem_plan
    fem_flat = fem_vals.view(-1, 128)
    for name in tds.VARIANTS:
        _, plain, library = probe_calls(name, fem_flat, xt, fem_bm, fem_U)
        moved = nbytes(fem_flat, seed, seed) + (nbytes(xt) if name == "stream_dot" else 0)
        ops = fem_flat.numel() * (16 if name == "stream_dot" else 1)
        kernels[names[name]] = dict(
            max_abs_err=check_probe(name, fem_flat, seed, xt, fem_bm, fem_U),
            plain_ms=time_ms(lambda: plain(seed), reps=3),
            library_ms=time_ms(lambda: library(seed)), **bound(moved, ops))
    print(f"B5-B7 against their plain versions within {tds.TOL:g}·Σ|terms|, bit "
          f"for bit from run to run: {', '.join(checked)}, and fem42's vals")
    # (b) the probe's sweep, (c) fem42's own tile stream: the path
    reset_launches(*probes)
    rows = tds.sweep(256, 8, (*tds.DEFAULT_CONFIGS, fem_plan), "cuda")
    # B1 (b=8) and B2 (b=16) on the same plan, timed as the probe times
    # its kernels
    spmm_ms = {}
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        X = padded_x(fem_op, b, seed=b)
        spmm_ms[b] = tds.kernel_ms(lambda: getattr(bsr, entry)(
            fem_op.tile_cols, fem_op.hcount, fem_op.rptr, fem_op.vals, X,
            bm=fem_bm, bk=fem_op.bk, H=fem_op.H, unroll=fem_U))
    T = fem_vals.shape[0]
    print(f"fem42 packed vals, plan {fem_plan}: {T} tiles, "
          f"{fem_vals.numel() * 4 / 1e6:.1f} MB f32, S={T // fem_U} chunks of "
          f"{fem_bm * fem_U} rows")
    for row in tds.probe(fem_flat, seed0, xt, bm=fem_bm, U=fem_U, reps=8):
        kernels[names[row["variant"]]]["ms"] = row["kernel_ms"]
        k_ms = row["kernel_ms"]
        print(f"fem42 {row['variant']}: kernel {k_ms:.4f} ms "
              f"({fem_flat.numel() * 4 / k_ms / 1e6:.0f} GB/s, "
              f"{row['bound_share']:.0%} of its {row['bound_ms']:.4f} ms bound), "
              f"chained {row['ms']:.4f} ms; on the same plan, back to back, "
              f"B1 b=8 {spmm_ms[8]:.4f} ms ({spmm_ms[8] - k_ms:+.4f} over it), "
              f"B2 b=16 {spmm_ms[16]:.4f} ms ({spmm_ms[16] - k_ms:+.4f}) (phase 3, "
              f"a single call each: {kernels['bsr_spmm_packed_resident']['ms']:.4f}, "
              f"{kernels['bsr_spmm_packed']['ms']:.4f} ms)  [{card}]")
    torch.cuda.synchronize()
    for f in probes:
        launches[f.__name__] = by_phase[f.__name__]["10"] = f.launches
        if f.launches < 1:
            raise AssertionError(f"the probe never launched {f.__name__}")
    print(f"probe launches {{{', '.join(f'{f.__name__}: {f.launches}' for f in probes)}}}"
          f", {len(rows)} sweep rows; phase 10 in {time.perf_counter() - t10:.1f} s")
    del fem_vals, fem_flat  # fem_op serves phases 20 and 22
    torch.cuda.empty_cache()

    # --- 15. truncated SVD (no kernel of the table on this path) ------------
    t15 = time.perf_counter()
    phase_svd(card)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # --- 16. shift-invert on the 512² stencil (no kernel of the table) -----
    t16 = time.perf_counter()
    phase_stencil_shift_invert(card)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    # --- 17. the FEM vibration solve, then B1/B2 at its shapes --------------
    opK, amg = long_phase(17, (B1,), phase_vibration, A, float(head[0]), card)
    check_path_shapes(opK, amg, kernels, card)
    del opK, amg
    torch.cuda.empty_cache()

    # --- 18. the smallest singular triplets ---------------------------------
    t18 = time.perf_counter()
    phase_svd_sm(card)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # --- 19.-22. the scipy front door, the eig backends, loading, tracing --
    long_phase(19, (), phase_eigsh, A, head, card)
    if not any(by_phase[f.__name__]["19"] for f in packed):
        raise AssertionError("phase 19 never launched the packed kernel")
    long_phase(20, (B1,), phase_eig_backends, fem_op, head, cfg, card)
    long_phase(21, (), phase_scipy_pencil_svd, card)
    long_phase(22, (B1,), phase_load_and_trace, fem_op, card)
    del fem_op
    torch.cuda.empty_cache()

    # --- 23. the row mesh: one rank over NCCL, two sharing the card -------
    t23 = time.perf_counter()
    phase_mesh(card, kernels, by_phase, every)
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")
    torch.cuda.empty_cache()

    # --- 24. the vibration pencil with the mesh V-cycle, eigsh/svds on the
    # mesh: one rank over NCCL, two sharing the card; then B1/B2 at its shapes
    # (the unsharded references and the set-up run before the counted window)
    t24 = time.perf_counter()
    st24 = mesh_scipy_refs(card)
    print(f"phase 24 references and set-up: {time.perf_counter() - t24:.1f} s")
    ranks24 = long_phase(24, (B1, B2), phase_mesh_scipy, st24, card)
    mesh_scipy_rows(st24["K_sh"], st24["amg_m"], ranks24, kernels, by_phase, card)
    del st24
    torch.cuda.empty_cache()

    # --- 25. the examples on the card; 26. the reference's gates -----------
    fem_ops, amg3d = long_phase(25, (B1,), phase_examples, head, card)
    example_path_shapes(fem_ops, amg3d, kernels, card)
    del fem_ops, amg3d
    torch.cuda.empty_cache()
    long_phase(26, (), phase_reference_gates, card)
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], launches_by_phase=by_phase[name],
             **kernels[name])
        for name, (src, rep) in KERNELS.items()
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
