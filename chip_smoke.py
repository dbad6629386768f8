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
     (b = 8), both on the ragged matrix at b = 5, 8, 16, 40; per-apply
     times beside the plain version, torch.sparse CSR and the bound (B3
     at b = 16 too, recorded as its row's b16_* keys); the register
     block and ring of csrc/bsr_spmm.cu for each timed shape.  B3's entry
     point, which no solve calls, checks phase 5's fem42 Ritz vectors
     (A·V against torch.sparse CSR, and the true residuals);
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
     held by ‖B·V − U·diag(s)‖ and ‖Bᵀ·U − V·diag(s)‖.

Phases 11-14 and 17 launch B1/B2 through BlockSparseOperator.apply.
Phase 14's fem42 polish applies A to k + buffer + random columns at once
(48 here), in f64 and in f32 filter chains, so after it both packed entry
points are held against the plain version on fem42 at that width, f32 and
f64, and timed, beside torch.sparse CSR at 48 and 90 columns.  In the
kernels' record ``launches`` is the count of the path the row's times were
taken on (phases 4-5 for B1/B2) and ``launches_by_phase`` holds every
path's own count; phases 11-13 and 17 must launch B1 and phase 14 both B1
(its f32 coarse sweep) and B2.  The last two lines are the kernels' JSON
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
    nrows = op.rptr.shape[0] * op.bm
    moved = nbytes(*args) + nrows * b * X.element_size()
    ops = 2 * op.vals.numel() * b
    return abs_err, rel, ms, plain_ms, moved, ops


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


def torch_csr(A, dtype):
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data).to(dtype), size=A.shape,
    ).to("cuda")


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


def phase_svd(card: str):
    """Phase 15."""
    import scipy.sparse.linalg as spla
    import torch

    import rbl_tpu_torch as rt

    g = torch.Generator(device="cuda").manual_seed(15)
    m, n, k = 20_000, 2_000, 20
    Q1, _ = torch.linalg.qr(torch.randn((m, n), generator=g, dtype=torch.float64,
                                        device="cuda"))
    Q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64,
                                        device="cuda"))
    B = (Q1 * (0.9 ** torch.arange(n, dtype=torch.float64, device="cuda"))) @ Q2.T
    del Q1, Q2
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


def lumped_mass(nx: int) -> np.ndarray:
    """The lumped (diagonal) mass of fem_elasticity_3d(nx): density 1, h = 1,
    each hex's volume shared equally by its 8 nodes, the z = 0 face clamped
    away, repeated over the 3 dofs of a node."""
    ax = np.arange(nx + 1)
    cells = np.where((ax > 0) & (ax < nx), 2.0, 1.0)  # hexes along an axis
    node = cells[1:, None, None] * cells[None, :, None] * cells[None, None, :] / 8.0
    return np.repeat(node.ravel(), 3)


def vibration_solve(A, m, node_dims, build: str, label: str, card: str,
                    device: str = "cuda"):
    """rbl_generalized(K, M, k=8, b=8, σ=0) with an AssembledMultigrid inner
    preconditioner, f64, tol 1e-6; K is the hierarchy's finest operator.
    Returns (result, info, wall, set-up s, max residual, max |XᵀMX − I|,
    the hierarchy)."""
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
    opM = rt.DiagonalOperator(torch.as_tensor(m, dtype=torch.float64, device=device))
    b1, b2 = bsr.bsr_spmm_packed_resident.launches, bsr.bsr_spmm_packed.launches
    t0 = time.perf_counter()
    res, info = rt.rbl_generalized(
        opK, opM, 8, 8, cfg=rt.RBLConfig(tol=1e-6, device=device), which="LM",
        sigma=0.0, inner_psolve=amg.psolve, return_info=True)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    X = res.eigenvectors
    lam = torch.as_tensor(res.eigenvalues, dtype=torch.float64, device=X.device)
    R = opK.apply(X) - opM.apply(X) * lam[None, :]
    resid = float(R.norm(dim=0).max())
    orth = float((X.T @ opM.apply(X) - torch.eye(8, dtype=X.dtype, device=X.device)
                  ).abs().max())
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
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

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

    g = torch.Generator(device=device).manual_seed(18)
    k = 10
    Q1, _ = torch.linalg.qr(torch.randn((m, n), generator=g, dtype=torch.float64,
                                        device=device))
    Q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64,
                                        device=device))
    # σ = 1 + 9·√t over t ∈ [0, 1]: the small end sparser than a linear
    # spread, so scipy's ARPACK reaches it in seconds
    s_true = 1.0 + 9.0 * torch.sqrt(torch.linspace(1.0, 0.0, n, dtype=torch.float64,
                                                    device=device))
    B = (Q1 * s_true) @ Q2.T
    del Q1, Q2
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


def check_path_shapes(opK, amg, kernels: dict, card: str):
    """After phase 17: both packed entry points against the plain version,
    timed, at b = 8 on every AMG level that ``as_operator`` routed to BSR,
    f32 and f64 (level 0 is fem42's K, in the f64 of the solve); each row
    is added to ``kernels[entry]["path_shapes"]``.  The entry a level
    dispatches to is observed: one apply at b = 8, and the launch count
    that moved."""
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
            entries = ("bsr_spmm_packed_resident", "bsr_spmm_packed")
            before = [getattr(bsr, e).launches for e in entries]
            op.apply(torch.zeros((op._n, 8), dtype=dtype, device="cuda"))
            moved = [e for e, n0 in zip(entries, before) if getattr(bsr, e).launches > n0]
            if len(moved) != 1:
                raise AssertionError(f"{label} {dtype} b=8 launched {moved or 'no packed entry'}")
            used = moved[0]
            for entry in entries:
                abs_err, rel, ms, plain_ms, moved, ops = compare_entry(
                    entry, op, 8, seed=17, timing=True)
                lim = bound(moved, ops)
                kernels[entry].setdefault("path_shapes", []).append(dict(
                    phase=17, shape=f"{label} n={op._n} plan ({op.bm}, {op.unroll}) "
                    f"{str(dtype)[6:]} b=8", dispatched=entry == used,
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **lim))
                tag = " (the path's entry)" if entry == used else ""
                print(f"{entry} {label} (n={op._n}, plan ({op.bm}, {op.unroll}), "
                      f"{op.nnz_blocks} tiles) b=8 {dtype}{tag}: "
                      f"rel err {rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {lim['bound_ms']:.4f} ms ({lim['bound_ms'] / ms:.0%})  "
                      f"[{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.ops.spmm.operator import cast_operator
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
    for entry in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
        for op in (op32, op64):
            _, rel, ms, plain_ms, moved, ops = compare_entry(
                entry, op, width, seed=width, timing=True)
            print(f"{entry} fem42 b={width} {op.dtype} (the polish's width): rel "
                  f"err {rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound(moved, ops)['bound_ms']:.4f} ms  [{card}]")
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
    bc, bv, nb, ncb, L = bsr._blocked_ell_from_scipy(A, 128, 128, np.float64)
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
                moved = nbytes(bc, bvd, X) + nb * 128 * b * 4
                lim = bound(moved, 2 * bvd.numel() * b)
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
    t0 = time.perf_counter()
    pan64 = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, panel=True,
                                               device="cuda")
    print(f"fem42 panel operator (auto plan bm={pan64.bm}, unroll={pan64.unroll}, "
          f"{pan64.vals.shape[0]} panels) built in {time.perf_counter() - t0:.1f} s")
    for op in (cast_operator(pan64, torch.float32), pan64):
        b = 8
        X = padded_x(op, b, seed=b)
        args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
        kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
        call = lambda: bsr.bsr_spmm_panel(*args, H=op.H, **kw)
        plain = lambda: bsr.bsr_spmm_panel_reference(*args, **kw)
        abs_err, rel = check(f"bsr_spmm_panel fem42 b={b}", call, plain, op.dtype)
        # B1 on the same plan, repacked from the panels, for the comparison
        T = op.tile_cols.shape[0]
        tiles = (op.vals.reshape(T // op.unroll, op.unroll, op.bk, op.bm)
                 .transpose(2, 3).reshape(T, op.bm, op.bk).contiguous())
        b1 = lambda: bsr.bsr_spmm_packed_resident(
            op.tile_cols, op.hcount, op.rptr, tiles, X, H=op.H, **kw)
        ms, plain_ms, b1_ms = time_ms(call), time_ms(plain), time_ms(b1)
        lib = ""
        if op.dtype == torch.float32:
            Xl = X[: A.shape[0]]
            lib_ms = time_ms(lambda: torch.sparse.mm(csr32, Xl))
            lib = f", torch.sparse CSR {lib_ms:.4f} ms"
            moved = nbytes(*args) + op.rptr.shape[0] * op.bm * b * 4
            kernels["bsr_spmm_panel"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **bound(moved, 2 * op.vals.numel() * b))
        print(f"bsr_spmm_panel (B4) fem42 b={b} {op.dtype}: rel err {rel:.2e}, "
              f"kernel {ms:.4f} ms, B1 on the same plan {b1_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{lib}  [{card}]")
        del tiles
    del pan64
    torch.cuda.empty_cache()
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
          f"b 5/8/16/40 within tolerance; phase 6 in {time.perf_counter() - t6:.1f} s")

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
    del fem_op, fem_vals, fem_flat
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
