"""Solver benchmark — time to k eigenpairs across block sizes, on the card.

The port's counterpart of ``benchmarks/solver_bench.py``, with the same
flags, lines and JSON line.  It mirrors the reference's benchmark
configuration (benchmark.jl:29-36: block sizes b ∈ {1, 2, 4, 8}, k = 100
largest eigenpairs): ``rbl`` at each b with the Krylov cap ``--max-kryl``,
``qr_method="auto"``, an eig poll every 8 iterations and
``adaptive_reorth_max=--adaptive-reorth``, in f32 (``--f64``: f64), on the
2-D Laplacian ``--laplacian`` (matrix-free) or on ``--matrix`` (read by
``load_matrix``, its layout picked by ``as_operator``).  One tiny solve
first (benchmark.jl:57-58), then for each b one warm-up solve and one
timed solve from seed b + 1, its wall ending in a synchronize.

``--arpack`` adds scipy's ``eigsh`` (the reference's Arpack.eigs
comparison, benchmark.jl:42) and its max relative difference from the
fastest b.  On a square grid ARPACK can miss a copy of a double eigenvalue
(ROADMAP C), so that line is no oracle there.

    python -m rbl_tpu_torch.benchmarks.solver_bench [--laplacian 512]
        [--k 100] [--blocks 1,2,4,8] [--arpack] [--f64] [--device cpu]
    python -m rbl_tpu_torch.benchmarks.solver_bench --matrix path.mtx

The card is the default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    """Run the sweep; returns [(b, seconds, LanczosResult)] and the JSON
    object printed."""
    p = argparse.ArgumentParser()
    p.add_argument("--laplacian", type=int, default=512)
    p.add_argument("--matrix")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--blocks", default="1,2,4,8")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--max-kryl", type=int, default=1024)
    p.add_argument("--arpack", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--adaptive-reorth", type=int, default=1,
                   help="cfg.adaptive_reorth_max stretch cap (1 = off)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import RBLConfig, resolve_device
    from .dma_stream_bench import sync

    dev = resolve_device(args.device)
    dt_ = torch.float64 if args.f64 else torch.float32
    if args.matrix:
        from ..utils.suitesparse import load_matrix

        A = load_matrix(args.matrix)
        op = rt.as_operator(A, dtype=dt_, device=dev)
        label = args.matrix
    else:
        s = args.laplacian
        op = rt.Laplacian2D(s, s, dtype=dt_, device=dev)
        A = None
        label = f"laplacian2d-{s}x{s}"

    # warm-up (reference benchmark.jl:57-58)
    rt.rbl(np.abs(np.random.default_rng(0).standard_normal(64)) + 1.0, 2, 2,
           cfg=RBLConfig(device=str(dev)))

    results = []
    for b in [int(x) for x in args.blocks.split(",")]:
        cfg = RBLConfig(
            block_size=b, tol=args.tol, max_kryl_dim=args.max_kryl,
            basis_dtype=dt_, compute_dtype=dt_,
            qr_method="auto", eig_poll_cadence=8,
            adaptive_reorth_max=args.adaptive_reorth,
        )
        rt.rbl(op, args.k, b, cfg=cfg)  # warm-up at this b
        t0 = time.perf_counter()
        res = rt.rbl(op, args.k, b, cfg=cfg.replace(seed=b + 1))
        sync(dev)
        dt = time.perf_counter() - t0
        results.append((b, dt, res))
        print(
            f"[b={b:2d}] {label}: {dt:7.3f}s  converged={res.converged} "
            f"kryl={res.kryl_dim}  λmax={res.eigenvalues[0]:.6e}"
        )

    if args.arpack:
        import scipy.sparse.linalg as spla

        if A is None:
            from ..utils.suitesparse import laplacian_2d

            A = laplacian_2d(args.laplacian, args.laplacian)
        t0 = time.perf_counter()
        d = spla.eigsh(A, k=args.k, which="LM", tol=args.tol,
                       return_eigenvectors=False)[::-1]
        t_arp = time.perf_counter() - t0
        best = min(results, key=lambda r: r[1])
        rel = np.abs((best[2].eigenvalues - d) / d).max()
        print(f"[ARPACK] {t_arp:.3f}s  max rel diff vs RBL: {rel:.3e}  "
              f"speedup x{t_arp/best[1]:.1f}")

    best = min(results, key=lambda r: r[1])
    line = {
        "metric": f"time_to_{args.k}_eigenpairs_{label}",
        "value": round(best[1], 3), "unit": "s", "block_size": best[0],
    }
    print(json.dumps(line))
    return results, line


if __name__ == "__main__":
    main()
