#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone, the row mesh on
``fem_elasticity_3d(47)``, for one or more checkouts in turn.

    python3 tools/bench_mesh.py --root A --root B --root B --root A [--out FILE]

Each ``--root`` is a checkout holding ``chip_smoke.py`` and
``rbl_tpu_torch/``; each leg runs that checkout's ``phase_mesh`` in a fresh
process: one rank over NCCL (the sharded and the unsharded solve from one
generator, B2 on the whole), then two ranks sharing the card over gloo (B1
on each band, the fem47 solve bitwise equal on both ranks, lap2d_512 under
bench.py's gate).  The legs run one after another on the same card, so two
versions are compared within one call; give them in turns (A B B A).
Prints each leg's phase-23 lines and one JSON object with every leg's
``kernels`` record and wall.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

LEG = r"""
import json, sys, time
import torch
import chip_smoke as c
from rbl_tpu_torch.ops.spmm import bsr

torch.set_float32_matmul_precision("highest")
every = (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed, bsr.bsr_spmm,
         bsr.bsr_spmm_panel)
kernels = {f.__name__: {} for f in every}
by_phase = {f.__name__: {} for f in every}
t0 = time.perf_counter()
c.phase_mesh(c.card_line(), kernels, by_phase, every)
print(json.dumps(dict(kernels=kernels, wall_s=time.perf_counter() - t0)))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout (repeat, in turns)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a leg may take")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    legs = []
    for i, root in enumerate(args.root):
        root = os.path.abspath(root)
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", LEG], cwd=root,
                           env=dict(os.environ, PYTHONPATH=root),
                           capture_output=True, text=True,
                           timeout=args.timeout)
        print(f"--- leg {i}: {root} (exit {p.returncode}, "
              f"{time.perf_counter() - t0:.1f} s)")
        lines = p.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line)
        if p.returncode != 0:
            print(p.stderr[-4000:])
            return 1
        legs.append(dict(root=root, **json.loads(lines[-1])))
    line = json.dumps(dict(legs=legs))
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
