"""Coarse-stage cost A/B of ``rbl_polished``, on the card.

The port's counterpart of ``benchmarks/coarse_ab_bench.py``, with the same
legs and JSON lines.  The 512² Dirichlet Laplacian in f64, k = 50, b = 8,
tol 1e-7 (the reference's tolerance), cholqr2, an eig poll every 16
iterations, bounds (0, None), through three coarse stages:

  A: coarse_tol=1e-4
  B: coarse_tol=1e-2 (the sweep exits at the refine's self-start bar)
  C: coarse_tol=1e-2, buffer=16

All three legs run once from seed 0 to warm up, then once more from seed
3, timed (each wall ending in a synchronize).  One JSON line a leg,
``coarse_ab_{leg}``: ``warm_s``, ``locked`` (pairs whose residual bound
is under 1e-7), ``passes`` (the polish passes), ``max_rel_err`` against
the analytic spectrum and ``converged``.

    python -m rbl_tpu_torch.benchmarks.coarse_ab_bench [--nx 512]
        [--device cpu]

The card is the default; ``--nx`` shrinks the grid for the tests.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .blocksize_bench import laplacian_spectrum, max_rel_err

K = 50
LEGS = (
    ("A_tol1e-4", dict(coarse_tol=1e-4)),
    ("B_tol1e-2", dict(coarse_tol=1e-2)),
    ("C_tol1e-2_buf16", dict(coarse_tol=1e-2, buffer=16)),
)


def main(argv=None):
    """Run the legs; returns the JSON objects printed, one a leg."""
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import RBLConfig, resolve_device
    from ..solver.polish import rbl_polished
    from .dma_stream_bench import sync

    dev = resolve_device(args.device)
    op = rt.Laplacian2D(args.nx, args.nx, dtype=torch.float64, device=dev)
    lam = laplacian_spectrum(args.nx, K)
    out = []
    for seed_warmup in (True, False):
        for label, kw in LEGS:
            cfg = RBLConfig(block_size=8, tol=1e-7, qr_method="cholqr2",
                            eig_poll_cadence=16,
                            seed=(0 if seed_warmup else 3))
            t0 = time.perf_counter()
            r = rbl_polished(op, K, cfg=cfg, b=8, bounds=(0.0, None), **kw)
            sync(dev)
            dt = time.perf_counter() - t0
            if seed_warmup:
                continue  # the first pass warms up each leg
            line = {
                "metric": f"coarse_ab_{label}",
                "warm_s": round(dt, 3),
                "locked": int(np.sum(np.asarray(r.residual_bounds) < 1e-7)),
                "passes": int(r.iterations),
                "max_rel_err": max_rel_err(r.eigenvalues, lam),
                "converged": bool(r.converged),
            }
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    main()
