#!/usr/bin/env python3
"""Fit the format router's time models to apply times on one CUDA card.

    python3 tools/fit_router.py [--out router_fit.json]

Measures, in f32 at b = 8 (CUDA events, median of 20 applies, after a
warm-up), on the assembled 3-D elasticity matrix fem_elasticity_3d(42)
(n = 232,974, 99 diagonals) and the assembled 512² Dirichlet Laplacian
(n = 262,144, 5 diagonals):

  - ``DiaOperator.apply``;
  - the packed-BSR CUDA kernel (``bsr_spmm_packed_resident``) at several
    (tile height, unroll) plans;
  - for reference, the ELL, COO and HYB applies and ``torch.sparse`` CSR.

Then it fits the two models of ``_pick_sparse_format``:

  t_bsr = (stored tile bytes + tiles · STEP_COST_BYTES) / BSR_BYTES_PER_S
          (least squares over every measured plan of both matrices);
  t_dia = ndiags · n · (4 + 4·8) / DIA_BYTES_PER_S
          (total model bytes over total time of both matrices),

and prints one JSON object with every measurement and the constants.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FEM_PLANS = ((16, 4), (32, 4), (64, 4), (64, 8), (128, 4), (128, 8), (128, 16))
LAP_PLANS = ((16, 4), (32, 4), (64, 4), (128, 4), (128, 16))


def time_ms(fn, reps: int = 20) -> float:
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


def laplacian_2d(nx: int):
    import scipy.sparse as sp

    T = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    I = sp.eye(nx)
    return (sp.kron(T, I) + sp.kron(I, T)).tocsr()


def measure(name, A, plans, b: int = 8):
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.ops.spmm.dia import count_diagonals

    n = A.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, b), generator=g, dtype=torch.float32, device="cuda")
    out = {"n": n, "nnz": int(A.nnz), "ndiags": count_diagonals(A)}
    for fmt in ("dia", "ell", "coo", "hyb"):
        op = rt.as_operator(A, dtype=torch.float32, device="cuda", format=fmt)
        out[f"{fmt}_ms"] = time_ms(lambda: op.apply(X))
        del op
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data.astype(np.float32)), size=A.shape,
    ).to("cuda")
    out["torch_sparse_csr_ms"] = time_ms(lambda: torch.sparse.mm(csr, X))
    del csr
    out["bsr"] = []
    for bm, U in plans:
        op = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=bm,
                                                unroll=U, device="cuda")
        ncb = -(-n // op.bk)
        Xp = torch.nn.functional.pad(X, (0, 0, 0, ncb * op.bk - n)).contiguous()
        args = (op.tile_cols, op.hcount, op.rptr, op.vals, Xp)
        ms = time_ms(lambda: bsr.bsr_spmm_packed_resident(
            *args, bm=bm, bk=op.bk, H=op.H, unroll=U))
        out["bsr"].append(dict(bm=bm, unroll=U, tiles=op.nnz_blocks,
                               bytes=op.vals.numel() * 4, ms=ms))
        print(f"{name} bsr bm={bm} U={U}: {op.nnz_blocks} tiles, "
              f"{op.vals.numel() * 4 / 1e6:.1f} MB, {ms:.4f} ms", flush=True)
        del op, args
        torch.cuda.empty_cache()
    print(f"{name}: " + json.dumps({k: v for k, v in out.items() if k != "bsr"}),
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fit_router.py needs a CUDA card", file=sys.stderr)
        return 2
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    res = {"card": card,
           "fem42": measure("fem42", fem_elasticity_3d(42), FEM_PLANS),
           "lap512": measure("lap512", laplacian_2d(512), LAP_PLANS)}
    rows = [p for m in ("fem42", "lap512") for p in res[m]["bsr"]]
    M = np.array([[p["bytes"], p["tiles"]] for p in rows], dtype=np.float64)
    t = np.array([p["ms"] * 1e-3 for p in rows])
    (alpha, beta), *_ = np.linalg.lstsq(M, t, rcond=None)
    bsr_bw = 1.0 / alpha
    step = beta / alpha
    for p, tm in zip(rows, M @ np.array([alpha, beta])):
        p["model_ms"] = float(tm * 1e3)
    dia_bytes = [res[m]["ndiags"] * res[m]["n"] * (4 + 4 * 8)
                 for m in ("fem42", "lap512")]
    dia_s = [res[m]["dia_ms"] * 1e-3 for m in ("fem42", "lap512")]
    res["fit"] = dict(BSR_BYTES_PER_S=float(bsr_bw),
                      STEP_COST_BYTES=float(step),
                      DIA_BYTES_PER_S=float(sum(dia_bytes) / sum(dia_s)),
                      dia_bytes_per_s_each=[b / s for b, s in
                                            zip(dia_bytes, dia_s)])
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
