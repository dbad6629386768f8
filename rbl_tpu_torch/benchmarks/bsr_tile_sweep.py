"""Packed-BSR (tile height × unroll) sweep on the card.

The port's counterpart of ``benchmarks/bsr_tile_sweep.py``, with the same
flag, plans and printed rows.  A packed plan (bm, U) trades stored bytes
(finer tiles store fewer zeros) against tiles visited and per-row padding
(each row's tile list is padded to a multiple of U); the router's time
model (``ops/spmm/bsr.py``: ``_STEP_COST_BYTES``, ``_BSR_BYTES_PER_S``)
prices that trade.  This sweep measures it on the two benchmark-class
fixtures, fem_elasticity_3d(30) and blocky-64k, through
``BlockSparseOperator.from_scipy(bm=, unroll=)`` at b = 8 in f32: every
plan's apply is the packed CUDA kernel B1 (X at most 8 MiB).  One row a
plan: the marginal apply time (``spmm_bench.time_apply``), Gnnz/s, the
stored tiles, the steps (block-rows × H, the longest row's chunk count:
the JAX grid's size), the stored MB and the host seconds of the build and
the copy to the card.

Data: a fresh ``np.random.default_rng(0)`` draws blocky-64k, then each
fixture's X (n, 8) after both fixtures are built, as the JAX script does
(not spmm_bench's draws).

    python -m rbl_tpu_torch.benchmarks.bsr_tile_sweep [--reps 30]
        [--fem 30] [--blocky-n 65536] [--device cpu]

The card is the default; ``--fem`` and ``--blocky-n`` shrink the fixtures
for the tests.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .spmm_bench import blocky_matrix, fem3d, solver_block, time_apply

# most informative first, so that a run cut short still leaves a usable
# sweep (the JAX script's order)
CONFIGS = ((16, 16), (16, 8), (128, 8), (128, 16), (32, 8), (16, 4),
           (128, 4), (32, 16))


def main(argv=None):
    """Sweep every plan on both fixtures; returns one dict a printed row."""
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--fem", type=int, default=30,
                   help="fem_elasticity_3d size of the fem3d fixture")
    p.add_argument("--blocky-n", type=int, default=65536,
                   help="rows of the blocky fixture (a multiple of 16)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import resolve_device
    from .dma_stream_bench import sync

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    fixtures = [(f"fem3d-{args.fem}", fem3d(args.fem)),
                (f"blocky-{args.blocky_n // 1024}k",
                 blocky_matrix(rng, args.blocky_n))]
    rows = []
    for fname, A in fixtures:
        X = solver_block(rng.standard_normal((A.shape[0], 8)).astype(np.float32), dev)
        for bm, unroll in CONFIGS:
            t0 = time.perf_counter()
            try:
                op = rt.BlockSparseOperator.from_scipy(
                    A, dtype=torch.float32, bm=bm, unroll=unroll, device=dev)
            except ValueError as e:
                print(f"[{fname}] bm={bm} U={unroll}: skipped ({e})",
                      flush=True)
                continue
            sync(op.vals)
            build = time.perf_counter() - t0
            dt = time_apply(op, X, args.reps)
            nb = op.rptr.shape[0]
            steps = nb * op.H
            mb = op.vals.numel() * 4 / 1e6
            print(
                f"[{fname}] bm={bm:3d} U={unroll:2d}: "
                f"{dt*1e3:8.3f} ms  {A.nnz/dt/1e9:6.2f} Gnnz/s  "
                f"tiles={op.nnz_blocks:6d} steps={steps:6d} "
                f"stored={mb:7.1f} MB  (build+xfer {build:.1f}s)",
                flush=True,
            )
            rows.append(dict(fixture=fname, bm=bm, U=unroll, ms=dt * 1e3,
                             gnnz_per_s=A.nnz / dt / 1e9, tiles=op.nnz_blocks,
                             steps=steps, stored_mb=mb, build_s=build))
            del op
    return rows


if __name__ == "__main__":
    main()
