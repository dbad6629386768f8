#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rbl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, compares
each kernel entry point with its plain PyTorch version on the card, then
drives the main path — ``rbl_tpu_torch.rbl`` — through the entry points a
user calls, and checks the answers:

  1. the card's name and power limit, torch's and CUDA's versions;
  2. the kernel build (csrc/bsr_spmm.cu → rbl_tpu_torch/build/);
  3. kernel against plain version, f32 and f64, on the packed arrays of the
     assembled 3-D elasticity matrix fem_elasticity_3d(42) (n = 232,974,
     18.0 M nonzeros) at b = 8 (resident entry point) and b = 16 (streaming
     entry point), and on a small matrix with ragged edges; per-apply times
     (CUDA events, median of 20);
  4. rbl on the 512² Laplacian with bench.py's configuration, held to
     bench.py's analytic check (max relative error < 0.025);
  5. rbl on fem42 at k = 100, b = 8 and b = 16 (f32), held to the first 90
     ARPACK eigenvalues (benchmarks/groundtruth/fem42_lm_k100.npz) within
     1e-2 relative, with the kernel launch counts of the run.

The last two lines are the kernels' JSON record and the JSON result.  Any
failure raises, and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GROUNDTRUTH = os.path.join(ROOT, "benchmarks", "groundtruth", "fem42_lm_k100.npz")
KERNEL_SOURCE = "rbl_tpu_torch/csrc/bsr_spmm.cu"
# the TPU kernels the CUDA kernel replaces (function definitions)
REPLACES = {
    "bsr_spmm_packed_resident": "rbl_tpu/ops/spmm/pallas_bsr.py:418",
    "bsr_spmm_packed": "rbl_tpu/ops/spmm/pallas_bsr.py:182",
}
TOL = {"float32": 1e-5, "float64": 1e-12}  # max |Y - Y_plain| / max |Y_plain|


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


def compare_entry(entry: str, op, b: int, seed: int, timing: bool):
    """Run one entry point and the plain version on the same card tensors;
    returns (max abs error, relative error, kernel ms, plain ms)."""
    import torch

    from rbl_tpu_torch.ops.spmm import bsr

    ncb = -(-op._n // op.bk)
    g = torch.Generator(device=op.device).manual_seed(seed)
    X = torch.randn((ncb * op.bk, b), generator=g, dtype=op.dtype, device=op.device)
    args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
    fn = getattr(bsr, entry)
    Y = fn(*args, bm=op.bm, bk=op.bk, H=op.H, unroll=op.unroll)
    Yp = bsr.bsr_spmm_packed_reference(*args, bm=op.bm, bk=op.bk, unroll=op.unroll)
    torch.cuda.synchronize()
    abs_err = float((Y - Yp).abs().max())
    rel = abs_err / max(float(Yp.abs().max()), 1e-300)
    dt = str(op.dtype).removeprefix("torch.")
    if not rel < TOL[dt]:
        raise AssertionError(
            f"{entry} {dt} b={b}: kernel vs plain relative error {rel:.3e} "
            f"≥ {TOL[dt]:g}"
        )
    ms = plain_ms = None
    if timing:
        ms = time_ms(lambda: fn(*args, bm=op.bm, bk=op.bk, H=op.H, unroll=op.unroll))
        plain_ms = time_ms(lambda: bsr.bsr_spmm_packed_reference(
            *args, bm=op.bm, bk=op.bk, unroll=op.unroll))
    return abs_err, rel, ms, plain_ms


def ragged_matrix(n: int = 1999, seed: int = 0):
    """Symmetric, n a multiple of neither bm nor bk, skewed tile counts,
    one heavy row and empty block-rows."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 300, 4000), np.full(1500, n - 222)])
    cols = np.concatenate([rng.integers(0, n, 4000), rng.integers(0, n, 1500)])
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def laplacian_check(eigenvalues, nx: int) -> float:
    """bench.py's analytic check: max relative error against the top of
    the 2-D Dirichlet Laplacian spectrum."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(eigenvalues)]
    return float(np.max(np.abs(np.asarray(eigenvalues) - lam) / lam))


def fem_solve(op, k: int, b: int, head: np.ndarray):
    """One fem42 solve in f32 (cholqr2, tol 1e-3, cap 1400); returns the
    result, its wall seconds and its max relative error on the ARPACK head."""
    import torch

    import rbl_tpu_torch as rt

    cfg = rt.RBLConfig(block_size=b, basis_dtype=torch.float32,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=1400)
    t0 = time.perf_counter()
    res = rt.rbl(op, k, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = np.asarray(res.eigenvalues)
    if w.shape != (k,) or not np.all(np.isfinite(w)):
        raise AssertionError(f"fem42 b={b}: eigenvalues not finite of shape ({k},)")
    if res.eigenvectors.device.type != "cuda":
        raise AssertionError(f"fem42 b={b}: eigenvectors on {res.eigenvectors.device}")
    err = float(np.max(np.abs(w[: len(head)] - head) / head))
    if not err < 1e-2:
        raise AssertionError(f"fem42 b={b}: max rel error {err:.3e} vs ARPACK head ≥ 1e-2")
    return res, wall, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    torch.set_float32_matmul_precision("highest")  # plain versions in full FP32
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels._library()
    print(f"build: {KERNEL_SOURCE} in {time.perf_counter() - t0:.2f} s")

    # --- 3. kernels against their plain version ---------------------------
    t0 = time.perf_counter()
    A = fem_elasticity_3d(42)
    print(f"fem42: n={A.shape[0]} nnz={A.nnz}, assembled in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    op32 = rt.as_operator(A, dtype=torch.float32, device="cuda")
    print(f"fem42 packed operator (bm={op32.bm}, unroll={op32.unroll}, "
          f"tiles={op32.nnz_blocks}, vals {op32.vals.numel() * 4 / 1e6:.1f} MB f32) "
          f"built in {time.perf_counter() - t0:.1f} s")
    op64 = bsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.float64, bm=op32.bm, unroll=op32.unroll, device="cuda")
    kernels = {}
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        for op in (op32, op64):
            abs_err, rel, ms, plain_ms = compare_entry(entry, op, b, seed=b, timing=True)
            gbs = op.vals.numel() * op.vals.element_size() / (ms * 1e-3) / 1e9
            print(f"{entry} fem42 b={b} {op.dtype}: rel err {rel:.2e}, "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of vals), "
                  f"plain {plain_ms:.4f} ms  [{card}]")
            if op is op32:
                kernels[entry] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    R = ragged_matrix()
    for dtype in (torch.float32, torch.float64):
        for bm, U in ((16, 4), (128, 8)):
            op = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, unroll=U,
                                                    device="cuda")
            for entry in REPLACES:
                for b in (5, 8, 16, 40):
                    _, rel, _, _ = compare_entry(entry, op, b, seed=b, timing=False)
    print(f"ragged n={R.shape[0]}: both entry points, f32 and f64, bm 16/128, "
          "b 5/8/16/40 within tolerance")

    # --- 4./5. the main path ------------------------------------------------
    head = np.load(GROUNDTRUTH)["eigenvalues"][:90]
    for f in (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed):
        f.launches = 0
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
    for b in (8, 16):
        res, wall, err = fem_solve(op32, 100, b, head)
        print(f"fem42 k=100 b={b} f32: wall {wall:.3f} s, max rel err (ARPACK "
              f"head 90) {err:.3e}, kryl_dim {res.kryl_dim}, converged "
              f"{res.converged}, launches resident="
              f"{bsr.bsr_spmm_packed_resident.launches} streaming="
              f"{bsr.bsr_spmm_packed.launches}  [{card}]")
    launches = {f.__name__: f.launches
                for f in (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed)}
    print(f"main path: {time.perf_counter() - t_main:.1f} s")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"main path never launched {name}")

    record = {"kernels": [
        dict(name=name, route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES[name], launches=launches[name], **kernels[name])
        for name in REPLACES
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
