#!/usr/bin/env python3
"""Where does the capped sweep's last factorization of T run faster: host
LAPACK or the card?

    python3 tools/bench_eig_route.py [--device cpu] [--nx 512]
        [--widths 128,256,384,512,768,1024,1400] [--blocks 8:82,16:50]
        [--reps 7] [--threads 4] [--out FILE]

For each block size b (with its k: ``b:k``) one sweep of ``rbl_tpu_torch``
on the nx² Dirichlet Laplacian (matrix-free stencil, f32 compute; the b = 16
sweep with a bf16 basis, as the ``lap2d_512.k50_b16`` cell runs it) runs to
a Krylov cap of the widest width, and T's leading m columns stand in for
the last T of a sweep capped at m.  Each T is then factorized for its k
largest-|λ| pairs by the two routes of ``solver.lanczos._factorize``, in
turns, on a worker thread as the sweep driver's polls run, with the
card otherwise idle:

  - ``host``: "scipy", a values-only dsbevd and dsyevr subsets of the
    densified T (``eig_banded_topk_dense``);
  - ``card``: "device", ``torch.linalg.eigh`` of T densified on the card in
    f64, the k pairs chosen there and copied back
    (``eigh_banded_device``).

After one warm call of each, ``--reps`` calls of each are timed on the
host's clock (each ends with its pairs on the host); a row gives their
median and least ms, the host/card ratio of the medians, and the largest
eigenvalue difference between the routes relative to |λ|max.  The host's
thread pools run at ``--threads`` (the benchmark's ``host_threads``).
Prints the card's name and power limit, one line a row and one JSON
object; ``--device cpu`` runs the same at a small ``--nx`` as a smoke run
(its card column is torch's CPU eigh: no device metric).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def sweep_band(op, b: int, k: int, cap: int, basis_dtype, device):
    """T's band after one sweep of ``cap`` columns (tolerance 1e-30: the
    cap ends it)."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.solver.basis import BasisStore
    from rbl_tpu_torch.solver.lanczos import lanczos_iteration, random_start_block

    cfg = rt.RBLConfig(block_size=b, tol=1e-30, max_kryl_dim=cap,
                       compute_dtype=torch.float32, basis_dtype=basis_dtype,
                       qr_method="cholqr2", eig_poll_cadence=16, device=str(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    Qi = random_start_block(op, gen, b, cfg)
    store = BasisStore(op.n, b, max_cols=cap + b, dtype=basis_dtype, device=device)
    _, _, T, _, converged, _ = lanczos_iteration(op, k, cfg, Qi, store, generator=gen)
    assert not converged and T.ncols >= cap, (converged, T.ncols)
    return T.view(cap).copy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--widths", default="128,256,384,512,768,1024,1400")
    ap.add_argument("--blocks", default="8:82,16:50",
                    help="b:k pairs (the polish's coarse sweep, the k50 cell)")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(args.threads)

    import concurrent.futures

    import numpy as np
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.solver.lanczos import CARD_EIG_MIN_COLS, _factorize

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_eig_route.py: no CUDA card (pass --device cpu for a smoke run)",
              file=sys.stderr)
        return 1
    card = (power_limit() if dev.type == "cuda" else "cpu")
    print(f"card: {card}; host threads {args.threads}; "
          f"CARD_EIG_MIN_COLS {CARD_EIG_MIN_COLS}", flush=True)
    widths = [int(m) for m in args.widths.split(",")]
    worker = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="rbl-eig")

    def timed(band, k, backend):
        def call():
            t0 = time.perf_counter()
            w, _ = _factorize(band, k, backend, dev)
            return time.perf_counter() - t0, w
        return worker.submit(call).result()

    rows = []
    op = rt.Laplacian2D(args.nx, args.nx, dtype=torch.float32, device=dev)
    for pair in args.blocks.split(","):
        b, k = (int(x) for x in pair.split(":"))
        cap = -(-max(widths) // b) * b
        t0 = time.perf_counter()
        band = sweep_band(op, b, k, cap,
                          torch.bfloat16 if b == 16 else torch.float32, dev)
        print(f"b={b}: sweep of {cap} columns in {time.perf_counter() - t0:.3f} s",
              flush=True)
        for m in widths:
            Tm = np.ascontiguousarray(band[:, :m])
            times = {"host": [], "card": []}
            ws = {}
            for rep in range(args.reps + 1):
                for route, backend in (("host", "scipy"), ("card", "device")):
                    secs, ws[route] = timed(Tm, k, backend)
                    if rep:
                        times[route].append(1e3 * secs)
            scale = float(np.abs(ws["host"]).max())
            row = dict(b=b, k=k, m=m,
                       host_ms=float(np.median(times["host"])),
                       host_min_ms=min(times["host"]),
                       card_ms=float(np.median(times["card"])),
                       card_min_ms=min(times["card"]),
                       eig_diff=float(np.abs(np.sort(ws["host"]) - np.sort(ws["card"])).max()
                                      / scale))
            row["host_over_card"] = row["host_ms"] / row["card_ms"]
            rows.append(row)
            print(f"b={b:>2} k={k:>3} m={m:>5}: host {row['host_ms']:9.3f} ms "
                  f"(min {row['host_min_ms']:8.3f}), card {row['card_ms']:8.3f} ms "
                  f"(min {row['card_min_ms']:8.3f}), host/card "
                  f"{row['host_over_card']:6.2f}, eig diff {row['eig_diff']:.2e}",
                  flush=True)
    worker.shutdown()
    out = dict(card=card, device=str(dev), nx=args.nx, threads=args.threads,
               reps=args.reps, card_eig_min_cols=CARD_EIG_MIN_COLS, rows=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
