"""Benchmark script of the PyTorch port (bench.py's counterpart): prints ONE
JSON line, its last line of output.

    python3 bench_torch.py              # on the CUDA card; raises without one
    python3 bench_torch.py --device cpu

The headline is bench.py's: the 2-D Dirichlet Laplacian on a 512×512 grid
(n = 262,144), the k = 50 largest eigenpairs, block b = 16 (RBL_BENCH_B),
a bf16 basis (RBL_BENCH_BASIS=f32 for the f32 control), f32 compute,
cholqr2, tol 1e-3, Krylov cap 768, eig poll cadence 16; one warm-up
solve, then the best of three seeds.  The eigenvalues are held to the
analytic spectrum (max relative error < 0.025, bench.py's assert).  Then
two rows, each one untimed and one timed solve:

- the f32 floor (RBL_BENCH_F32ROW=0 skips): b = 8, f32 basis, tol 1e-4,
  cap 1280; ``f32_floor_cap_hit`` says whether the cap ended the sweep;
- the reference's tolerance (RBL_BENCH_REF_TOL=0 skips): ``rbl_polished``
  in f64 at tol 1e-7, b = 8, bounds (0, None).

``vs_baseline`` is the reference-shaped loop's time
(``rbl_tpu_torch/benchmarks/baseline_loop.py``) over the headline's, both
measured here at the headline's b: the loop's min of two timed runs after
one warm-up, reported as ``baseline_measured_s``.

Hooks (measurement only; the recorded headline stays on the defaults):
RBL_BENCH_B (block size, parsed once as an int: the metric's name and the
baseline's b), RBL_BENCH_BASIS, RBL_BENCH_PRECISION (the f32 matmul
precision: default|high|highest), RBL_BENCH_ADAPTIVE
(cfg.adaptive_reorth_max), RBL_BENCH_FILTERED=1 or =<degree> (the
headline through ``rbl_filtered``), RBL_BENCH_F32ROW, RBL_BENCH_REF_TOL.

Differences from bench.py: the baseline is always measured live (the
recorded 8.05 s of bench.py was a TPU's), every time ends in
``torch.cuda.synchronize()`` instead of a scalar fetch, and there is no
``aot_cache_state`` key (no executable cache).  Every leg runs through
``utils.probe.solve_with_retry`` as bench.py's do.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from rbl_tpu_torch.benchmarks.blocksize_bench import laplacian_spectrum

# the geometry: a NX × NX grid, the K largest eigenpairs
NX = 512
K = 50


def bench_b() -> int:
    """RBL_BENCH_B as an int (default 16)."""
    return int(os.environ.get("RBL_BENCH_B", "16"))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(t) -> bool:
    return bool(np.all(np.isfinite(np.asarray(t[1].eigenvalues))))


def _retry(fn, *args, device):
    """bench.py's wrapper of every leg: one retry after a health wait.
    Calls ``fn(*args, device)``."""
    from rbl_tpu_torch.utils.probe import solve_with_retry

    return solve_with_retry(fn, *args, device, retries=1, attempts=6,
                            sleep_s=30, validate=_finite, device=device)


def run(seed: int, b: int, device):
    """One headline solve; returns (wall seconds, result)."""
    import torch

    import rbl_tpu_torch as rt

    op = rt.Laplacian2D(NX, NX, dtype=torch.float32, device=device)
    cfg = rt.RBLConfig(
        block_size=b,
        basis_dtype=torch.float32,
        compute_dtype=torch.float32,
        qr_method="cholqr2",
        tol=1e-3,
        max_kryl_dim=768,
        eig_poll_cadence=16,
        seed=seed,
        adaptive_reorth_max=int(os.environ.get("RBL_BENCH_ADAPTIVE", "1")),
    )
    prec = os.environ.get("RBL_BENCH_PRECISION")
    if prec:
        cfg = cfg.replace(matmul_precision=prec)
    basis = os.environ.get("RBL_BENCH_BASIS", "bf16")
    cfg = cfg.replace(
        basis_dtype=torch.float32 if basis == "f32" else torch.bfloat16)
    filt = os.environ.get("RBL_BENCH_FILTERED")
    t0 = time.perf_counter()
    if filt:
        from rbl_tpu_torch.solver.filtered import rbl_filtered

        kwargs = {} if filt in ("1", "auto") else {"degree": int(filt)}
        res = rbl_filtered(op, K, cfg=cfg, which="LA", bounds=(0.0, None),
                           compute_eigenvectors=True, **kwargs)
    else:
        res = rt.rbl(op, K, b, cfg=cfg, compute_eigenvectors=True)
    _sync(device)
    return time.perf_counter() - t0, res


def measure_baseline(b: int, device):
    """The reference-shaped loop at the headline's configuration: one
    warm-up, then two timed runs from distinct seeds.  Returns (the min
    wall seconds, the last run's eigenvalues, its iterations)."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.benchmarks.baseline_loop import reference_shaped_solve

    op = rt.Laplacian2D(NX, NX, dtype=torch.float32, device=device)
    reference_shaped_solve(op, K, b, seed=0)  # warm-up
    times = []
    for rep in (1, 2):
        t0 = time.perf_counter()
        w, iters = reference_shaped_solve(op, K, b, seed=rep)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), w, iters


def f32_floor_row(device, lam, out: dict) -> None:
    """The f32-floor row: b = 8, f32 basis, tol 1e-4, cap 1280."""
    import torch

    import rbl_tpu_torch as rt

    op32 = rt.Laplacian2D(NX, NX, dtype=torch.float32, device=device)
    cfg32 = rt.RBLConfig(
        block_size=8, basis_dtype=torch.float32, compute_dtype=torch.float32,
        qr_method="cholqr2", tol=1e-4, max_kryl_dim=1280, eig_poll_cadence=16,
        seed=0,
    )

    def _f32row(seed, device):
        t0 = time.perf_counter()
        r = rt.rbl(op32, K, 8, cfg=cfg32.replace(seed=seed))
        _sync(device)
        return time.perf_counter() - t0, r

    _retry(_f32row, 0, device=device)  # untimed
    dt5, res5 = _retry(_f32row, 1, device=device)
    w5 = np.sort(np.asarray(res5.eigenvalues))[::-1]
    out["f32_floor_s"] = round(dt5, 3)
    out["f32_floor_tol"] = 1e-4
    out["f32_floor_max_rel_err"] = float(np.max(np.abs(w5 - lam) / lam))
    out["f32_floor_converged"] = bool(res5.converged)
    out["f32_floor_cap_hit"] = bool(
        not res5.converged and res5.kryl_dim >= 1280)


def ref_tol_row(device, lam, out: dict) -> None:
    """The row at the reference's own tolerance (RBL.jl:109, absolute
    1e-7): rbl_polished in f64, error over all K pairs, ``locked`` counts
    the pairs whose true residual clears the bound."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.solver.polish import rbl_polished

    op = rt.Laplacian2D(NX, NX, dtype=torch.float64, device=device)
    cfg = rt.RBLConfig(block_size=8, tol=1e-7, qr_method="cholqr2",
                       eig_poll_cadence=16, seed=0)

    def _polish(seed, device):
        t0 = time.perf_counter()
        r = rbl_polished(op, K, cfg=cfg.replace(seed=seed), b=8,
                         bounds=(0.0, None))
        _sync(device)
        return time.perf_counter() - t0, r

    cold_dt, _ = _retry(_polish, 0, device=device)
    ref_dt, res7 = _retry(_polish, 1, device=device)
    w7 = np.sort(np.asarray(res7.eigenvalues))[::-1]
    out["at_ref_tol_s"] = round(ref_dt, 3)
    out["at_ref_tol_cold_s"] = round(cold_dt, 3)
    out["ref_tol"] = 1e-7
    out["ref_tol_max_rel_err"] = (
        float(np.max(np.abs(w7 - lam) / lam)) if len(w7) == len(lam) else None)
    out["ref_tol_locked"] = int(np.sum(np.asarray(res7.residual_bounds) < 1e-7))
    out["ref_tol_converged"] = bool(res7.converged)


def main(argv=None):
    """Run every leg and print the JSON line.  Returns the printed dict and
    the baseline loop's eigenvalues (descending), for a caller's own
    check."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    from rbl_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    b = bench_b()
    baseline_s, baseline_w, _ = measure_baseline(b, device)

    _retry(run, 0, b, device=device)  # warm-up
    best = None
    for rep in (1, 2, 3):  # best of three distinct seeds
        dt, res = _retry(run, rep, b, device=device)
        if best is None or dt < best[0]:
            best = (dt, res)
    dt, res = best
    lam = laplacian_spectrum(NX, len(res.eigenvalues))
    max_rel = float(np.max(np.abs(res.eigenvalues - lam) / lam))
    assert max_rel < 0.025, f"headline eigenvalues off by {max_rel:.3f}"
    out = {
        "metric": f"time_to_k_eigenpairs_lap2d_{NX}_k{K}_b{b}",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(baseline_s / dt, 2),
        "max_rel_err": round(max_rel, 6),
        "tol": 1e-3,
        "basis": os.environ.get("RBL_BENCH_BASIS", "bf16"),
    }
    lamk = laplacian_spectrum(NX, K)
    if os.environ.get("RBL_BENCH_F32ROW", "1") != "0":
        try:
            f32_floor_row(device, lamk, out)
        except Exception as e:  # never lose the headline row to this leg
            out["f32_floor_error"] = f"{type(e).__name__}: {e}"[:200]
    if os.environ.get("RBL_BENCH_REF_TOL", "1") != "0":
        try:
            ref_tol_row(device, lamk, out)
        except Exception as e:
            out["ref_tol_error"] = f"{type(e).__name__}: {e}"[:200]
    out["baseline_measured_s"] = round(baseline_s, 3)
    print(json.dumps(out))
    return out, baseline_w


if __name__ == "__main__":
    main()
