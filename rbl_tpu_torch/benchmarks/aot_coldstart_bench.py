"""One solve at the reference's tolerance, timed in a fresh process.

The port's counterpart of ``benchmarks/aot_coldstart_bench.py``: the same
one-shot ``rbl_polished`` solve (the 512² Dirichlet Laplacian in f64,
k = 50, b = 8, tol 1e-7, cholqr2, an eig poll every 16 iterations,
bounds (0, None), seed ``RBL_SEED``, default 0) and the same JSON line,
``at_ref_tol_oneshot_s``.  Run it as a fresh process, and the wall (ending
in a synchronize) includes everything a first solve pays in that process
after the imports: the CUDA context's first use, the first launch of each
kernel and library routine, the host's first allocations.

The JAX script measured its executable cache (utils/aot.py) cold and
warm; the port has no executable cache, so its line has no
``aot_cache_state`` and no ``blobs_before`` (ROADMAP C).

    python -m rbl_tpu_torch.benchmarks.aot_coldstart_bench [--nx 512]
        [--device cpu]

The card is the default; ``--nx`` shrinks the grid for the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .blocksize_bench import laplacian_spectrum, max_rel_err

K = 50


def main(argv=None):
    """Solve once; returns the JSON object printed."""
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
    seed = int(os.environ.get("RBL_SEED", "0"))
    op = rt.Laplacian2D(args.nx, args.nx, dtype=torch.float64, device=dev)
    cfg = RBLConfig(block_size=8, tol=1e-7, qr_method="cholqr2",
                    eig_poll_cadence=16, seed=seed)
    t0 = time.perf_counter()
    r = rbl_polished(op, K, cfg=cfg, b=8, bounds=(0.0, None))
    sync(dev)
    dt = time.perf_counter() - t0

    line = {
        "metric": "at_ref_tol_oneshot_s",
        "value": round(dt, 3),
        "locked": int(np.sum(np.asarray(r.residual_bounds) < 1e-7)),
        "max_rel_err": max_rel_err(r.eigenvalues, laplacian_spectrum(args.nx, K)),
        "converged": bool(r.converged),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
