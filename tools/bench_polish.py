#!/usr/bin/env python3
"""Does the f32-discovery / f64-polish split earn its place on a card with
native f64?

    python3 tools/bench_polish.py [--device cpu] [--nx 512] [--k 50]
                                  [--tol 1e-7] [--cap 1400] [--big-cap 8000]
                                  [--long-restart-kryl 1024]
                                  [--long-max-restarts 100] [--out FILE]

Times, on the nx² Dirichlet Laplacian (matrix-free stencil, f64) at the
reference's own tolerance (absolute residual 1e-7, RBL.jl:109), the k
largest eigenpairs through four routes of ``rbl_tpu_torch``:

  - ``rbl`` with f64 basis and compute, b = 8 and b = 16, Krylov cap
    ``--cap`` (cholqr2, poll cadence 16: bench.py's at-1e-7 settings);
  - ``rbl_polished`` in bench.py's at-1e-7 configuration (b = 8,
    ``bounds=(0, None)``);
  - ``rbl_restarted`` in f64 (b = 8, ``--restart-kryl`` columns a sweep, at
    most ``--max-restarts`` restarts, ``poll_ahead=16``).

The caps above are bench.py's, not the card's: a 1,400-column f64 basis is
a few per cent of an 80 GB card.  So that the verdict does not rest on
them, two more rows give the plain routes room (0 turns a row off):

  - ``rbl`` f64, b = 8, with a Krylov cap of ``--big-cap`` columns (what
    ``clamp_kryl_dim`` still lets through on the card);
  - ``rbl_restarted`` f64, b = 8, with sweeps of ``--long-restart-kryl``
    columns and up to ``--long-max-restarts`` restarts.

Each route runs twice (seeds 0 and 1) and the second, warm run is timed on
the host's clock, ending in a device synchronisation; the two roomy rows
run once (seed 1), after the others have warmed the card.  Each row carries its
max relative eigenvalue error against the analytic spectrum (over the pairs
it returned), its worst residual, its converged flag and the pairs it
returned.  The ``rbl_restarted`` rows also name what the lock got wrong:
``missing`` lists the analytic values of the top ``pairs`` that no locked
value matches (1e-6 relative) — a pair skipped while one below it was
locked — and ``foreign`` the locked values that match no eigenvalue of A
at all.  The lock can take both, in the port as in the JAX package (it
takes each sweep's converged prefix).  Prints the card's name and power limit and one JSON object;
``--device cpu`` runs the same at whatever ``--nx`` the host can bear (a
smoke run: its times are no device metric).
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


def analytic_spectrum(nx: int) -> np.ndarray:
    """Every eigenvalue of the nx² Dirichlet Laplacian, descending."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[::-1]


def unmatched(values: np.ndarray, reference: np.ndarray, rtol: float = 1e-6):
    """The entries of ``values`` within ``rtol`` (relative) of no entry of
    ``reference``."""
    ref = np.sort(reference)
    out = []
    for v in values:
        i = np.clip(np.searchsorted(ref, v), 1, len(ref) - 1)
        if min(abs(ref[i] - v), abs(ref[i - 1] - v)) > rtol * abs(v):
            out.append(float(v))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help='device of the solves (default: the CUDA card; "cpu" '
                         "for a smoke run)")
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--cap", type=int, default=1400)
    ap.add_argument("--restart-kryl", type=int, default=256)
    ap.add_argument("--max-restarts", type=int, default=30)
    ap.add_argument("--big-cap", type=int, default=8000)
    ap.add_argument("--long-restart-kryl", type=int, default=1024)
    ap.add_argument("--long-max-restarts", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.config import resolve_device

    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    k, nx = args.k, args.nx
    spectrum = analytic_spectrum(nx)
    lam = spectrum[:k]
    op = rt.Laplacian2D(nx, nx, dtype=torch.float64, device=dev)
    base = rt.RBLConfig(tol=args.tol, qr_method="cholqr2", eig_poll_cadence=16,
                        max_kryl_dim=args.cap)

    def plain(b, cap):
        return lambda seed: rt.rbl(
            op, k, b, cfg=base.replace(seed=seed, max_kryl_dim=cap))

    def restarted(kryl, restarts):
        return lambda seed: rt.rbl_restarted(
            op, k, cfg=base.replace(seed=seed, restart_kryl_dim=kryl),
            b=8, max_restarts=restarts, poll_ahead=16)

    # route → (solve, seeds): the last seed's run is the one timed
    routes = {
        "rbl_f64_b8": (plain(8, args.cap), (0, 1)),
        "rbl_f64_b16": (plain(16, args.cap), (0, 1)),
        "rbl_polished_b8": (lambda seed: rt.rbl_polished(
            op, k, cfg=base.replace(seed=seed, block_size=8), b=8,
            bounds=(0.0, None)), (0, 1)),
        "rbl_restarted_f64_b8": (
            restarted(args.restart_kryl, args.max_restarts), (0, 1)),
    }
    if args.big_cap:
        routes[f"rbl_f64_b8_cap{args.big_cap}"] = (plain(8, args.big_cap), (1,))
    if args.long_restart_kryl and args.long_max_restarts:
        routes[f"rbl_restarted_f64_b8_kryl{args.long_restart_kryl}"
               f"_restarts{args.long_max_restarts}"] = (
            restarted(args.long_restart_kryl, args.long_max_restarts), (1,))
    rows = []
    for name, (run, seeds) in routes.items():
        for seed in seeds:
            t0 = time.perf_counter()
            res = run(seed)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        w = np.sort(np.asarray(res.eigenvalues, dtype=np.float64))[::-1]
        got = len(w)
        err = float(np.max(np.abs(w - lam[:got]) / lam[:got])) if got else None
        rb = res.residual_bounds
        row = dict(route=name, seconds=wall, converged=bool(res.converged),
                   pairs=got, max_rel_err=err,
                   worst_residual=None if rb is None else float(np.max(rb)),
                   iterations=int(res.iterations), kryl_dim=int(res.kryl_dim))
        if name.startswith("rbl_restarted"):
            row.update(missing=unmatched(lam[:got], w), foreign=unmatched(w, spectrum))
        rows.append(row)
        print(f"{name}: {wall:.3f} s, converged {row['converged']}, {got}/{k} "
              f"pairs, max rel err {err}, worst residual {row['worst_residual']}, "
              f"iterations {row['iterations']}, kryl_dim {row['kryl_dim']}"
              + (f", missing {row['missing']}, foreign {row['foreign']}"
                 if "missing" in row else "") + f"  [{card}]", flush=True)
    record = dict(card=card, nx=nx, k=k, tol=args.tol, cap=args.cap,
                  restart_kryl=args.restart_kryl, max_restarts=args.max_restarts,
                  big_cap=args.big_cap, long_restart_kryl=args.long_restart_kryl,
                  long_max_restarts=args.long_max_restarts,
                  rows=rows)
    text = json.dumps(record)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
