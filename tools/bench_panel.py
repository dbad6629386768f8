#!/usr/bin/env python3
"""Time the panel kernel (B4, ``csrc/bsr_spmm_panel.cu``) on fem42 as
chip_smoke.py's phase 6 does, for one or more checkouts of the port, in
turns on one card.

    python3 tools/bench_panel.py [--root DIR ...] [--out FILE]

Each ``--root`` (default: this checkout) is a directory holding
``rbl_tpu_torch/`` and ``chip_smoke.py``; its kernels are built from its
own sources.  The legs run in separate processes in the order roots,
reversed roots (A B B A for two), so that a drift of the card over the
run does not favour one side.  A leg times, on fem_elasticity_3d(42):
B4 at the auto plan (64, 4), b = 8, f32 and f64, beside B1 on the same
plan, B7 over the same bytes and torch.sparse CSR (chip_smoke.panel_fem42),
then the bk sweep, bk = 32 / 64 / 128 at pick_tile_plan's plan, f32, b = 8
(chip_smoke.panel_bk_sweep).  Each leg prints one line, ``LEG <root>
<json>``; ``--out`` also writes the legs as JSON lines.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEG = r"""
import json, sys
import torch
import chip_smoke as cs
from rbl_tpu_torch.ops.spmm import _kernels
from rbl_tpu_torch.utils.fem import fem_elasticity_3d

torch.set_float32_matmul_precision("highest")
_kernels.build()
card = cs.card_line()
A = fem_elasticity_3d(42)
csr = cs.torch_csr(A, torch.float32)
kernels = {}
cs.panel_fem42(A, csr, kernels, card)
rows = cs.panel_bk_sweep(A, csr, card)
k = kernels["bsr_spmm_panel"]
print("LEG", sys.argv[1], json.dumps(dict(card=card, fem42=k, bk_sweep=rows)))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="checkout to time (repeatable; default: this one)")
    ap.add_argument("--out", default=None, help="also write the legs here")
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    order = roots + roots[::-1] if len(roots) > 1 else roots
    legs = []
    for root in order:
        proc = subprocess.run([sys.executable, "-c", LEG, root], cwd=root,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("LEG ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"the leg of {root} failed (exit {proc.returncode})")
        print(lines[0], flush=True)
        legs.append(dict(root=root, **json.loads(lines[0].split(" ", 2)[2])))
    for leg in legs:
        k = leg["fem42"]
        sweep = ", ".join(f"bk {r['bk']} B4 {r['ms']:.4f} / B1 {r['b1_ms']:.4f}"
                          for r in leg["bk_sweep"])
        print(f"{leg['root']}: f32 B4 {k['ms']:.4f} B1 {k['b1_same_plan_ms']:.4f} "
              f"B7 {k['b7_same_bytes_ms']:.4f} ms; f64 B4 {k['f64_ms']:.4f} B1 "
              f"{k['f64_b1_same_plan_ms']:.4f} ms; {sweep}  [{leg['card']}]")
    if args.out:
        with open(args.out, "w") as f:
            for leg in legs:
                f.write(json.dumps(leg) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
