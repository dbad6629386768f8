"""Time to k eigenpairs against block size b, on the card.

The port's counterpart of ``benchmarks/blocksize_bench.py``, with the same
block sizes and JSON lines.  bench.py's headline configuration (the
512² Dirichlet Laplacian, k = 50, tol 1e-3, a bf16 basis, f32 compute,
cholqr2, an eig poll every 16 iterations, Krylov cap 768 rounded up to a
multiple of b) at each b: three solves from seeds 0, 1, 2, the first
warming up, the best wall of the other two reported (each wall ending in
a synchronize).  Wider blocks do more work per converged pair in larger
products; this sweep records where the trade lands at the solver level.
One JSON line a b: ``lap2d_512_k50_b{b}`` with ``warm_s``, ``kryl_dim``,
``max_rel_err`` against the analytic spectrum and ``converged``.

    python -m rbl_tpu_torch.benchmarks.blocksize_bench [4 8 16 32]
        [--nx 512] [--device cpu]

The card is the default; ``--nx`` shrinks the grid for the tests (the
metric keeps its JAX name).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

K = 50


def laplacian_spectrum(nx: int, k: int) -> np.ndarray:
    """The k largest eigenvalues of the nx × nx Dirichlet Laplacian,
    descending."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:k]


def max_rel_err(eigenvalues, lam) -> float:
    """Max relative error of the eigenvalues, sorted descending, against
    ``lam``."""
    w = np.sort(np.asarray(eigenvalues))[::-1]
    return float(np.max(np.abs(w - lam) / lam))


def main(argv=None):
    """Run the sweep; returns the JSON objects printed, one a b."""
    p = argparse.ArgumentParser()
    p.add_argument("blocks", type=int, nargs="*", default=[4, 8, 16, 32])
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import RBLConfig, resolve_device
    from .dma_stream_bench import sync

    dev = resolve_device(args.device)
    nx = args.nx
    op = rt.Laplacian2D(nx, nx, dtype=torch.float32, device=dev)
    lam = laplacian_spectrum(nx, K)
    out = []
    for b in args.blocks:
        cfg = RBLConfig(
            block_size=b, basis_dtype=torch.bfloat16,
            compute_dtype=torch.float32, qr_method="cholqr2", tol=1e-3,
            max_kryl_dim=768 + (-768) % b, eig_poll_cadence=16, seed=0,
        )
        times, res = [], None
        for seed in (0, 1, 2):
            t0 = time.perf_counter()
            r = rt.rbl(op, K, b, cfg=cfg.replace(seed=seed),
                       compute_eigenvectors=True)
            sync(dev)
            dt = time.perf_counter() - t0
            if seed:  # seed 0 warms up this b
                times.append(dt)
                res = r
        line = {
            "metric": f"lap2d_512_k50_b{b}",
            "warm_s": round(min(times), 3),
            "kryl_dim": int(res.kryl_dim),
            "max_rel_err": max_rel_err(res.eigenvalues, lam),
            "converged": bool(res.converged),
        }
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
