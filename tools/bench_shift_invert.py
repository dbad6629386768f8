#!/usr/bin/env python3
"""Time the inner blocked-MINRES solve of the shift-invert paths at several
stop-test cadences, and the assembled multigrid's host set-up.

    python3 tools/bench_shift_invert.py [--nx 512] [--fem 42]
                                        [--cadences 1,4,16] [--reps 3]
                                        [--device cuda] [--out FILE]

``block_minres`` reads its stop test ``any(φ̄ > tol·β₁)`` back to the host
every ``DEFAULT_CHECK_EVERY`` iterations (a module constant of
``rbl_tpu_torch.ops.minres``, which this script sets to each cadence in
turn); between two reads the host queues iterations ahead of the card.
For each cadence this times one inner solve
(tol 1e-11, f64, warm, host clock ending in a synchronize, median of
``--reps``) of

  - the nx² Laplacian with the geometric V-cycle (``precond="mg"``), b = 4;
  - fem_elasticity_3d(fem) (routed by ``as_operator``) with the grid AMG
    of ``AssembledMultigrid.from_grid``, b = 8 — the inner solve of
    chip_smoke.py phase 17;

and prints the iterations, the wall, its share a MINRES iteration and the
same beside cadence 1.  The AMG's set-up (host seconds, levels, routes) is
printed first.  One JSON line per measurement, with the card's name and
power limit; ``--device cpu`` runs it all on the CPU (small sizes only).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--fem", type=int, default=42)
    ap.add_argument("--cadences", default="1,4,16")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops import minres as minres_mod
    from rbl_tpu_torch.ops.minres import block_minres
    from rbl_tpu_torch.ops.multigrid import mg_psolve_for
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available():
            print("bench_shift_invert.py: no CUDA card (pass --device cpu)",
                  file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        card = "cpu"
    lines = []

    def emit(**rec):
        lines.append(json.dumps(dict(card=card, device=dev, **rec)))
        print(lines[-1], flush=True)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def timed(solve):
        solve()  # warm
        sync()
        walls, itn = [], None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            _, (itn, _) = solve()
            sync()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)), itn

    cadences = [int(c) for c in args.cadences.split(",")]
    f64 = torch.float64
    g = torch.Generator(device=dev)

    lap = rt.Laplacian2D(args.nx, args.nx, dtype=f64, device=dev)
    ps = mg_psolve_for(lap)
    B = torch.randn((lap.n, 4), generator=g.manual_seed(0), dtype=f64, device=dev)
    cases = [(f"lap{args.nx} mg b=4", lap.apply, ps, B)]

    A = fem_elasticity_3d(args.fem)
    t0 = time.perf_counter()
    amg = rt.AssembledMultigrid.from_grid(
        A, (args.fem, args.fem + 1, args.fem + 1), dof=3, device=dev)
    setup_s = time.perf_counter() - t0
    opK = rt.as_operator(A, dtype=f64, device=dev)
    emit(case=f"fem{args.fem} grid AMG set-up", host_s=setup_s,
         levels=[dict(n=lv.n, nnz=lv.nnz, route=lv.route) for lv in amg.levels],
         coarsest=int(amg.coarse_inv.shape[0]), K_route=type(opK).__name__)
    B = torch.randn((A.shape[0], 8), generator=g.manual_seed(1), dtype=f64, device=dev)
    cases.append((f"fem{args.fem} grid-AMG b=8", opK.apply, amg.psolve, B))

    for label, apply, psolve, B in cases:
        base = None
        for c in cadences:
            minres_mod.DEFAULT_CHECK_EVERY = c
            wall, itn = timed(lambda: block_minres(apply, B, tol=1e-11, psolve=psolve))
            per = wall / max(itn, 1)
            base = per if base is None else base
            emit(case=label, check_every=c, iterations=itn, wall_s=wall,
                 ms_per_iteration=per * 1e3, vs_first_cadence=per / base)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
