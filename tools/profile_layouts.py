#!/usr/bin/env python3
"""Where a fem42 solve spends its device time, by sparse layout.

    python3 tools/profile_layouts.py [--out profile_layouts.json]

On one CUDA card, for fem_elasticity_3d(42) in f32 (k = 100, b = 8, tol
1e-3, cholqr2, cap 1400, as chip_smoke.py's phase 8):

  - times one apply of each layout (CUDA events, median of 20) on a
    row-major and on a column-major (n, 8) block;
  - profiles one warm solve per layout with torch.profiler and prints the
    wall, the summed device time of all kernels over the wall (the busy
    share), and the kernels that take the most device time.

Prints one JSON object with every number.
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

from fit_router import time_ms  # noqa: E402  (same directory)


def device_us(evt) -> float:
    """Self device time of a profiler event, in µs, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_solve(op, k: int, b: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import rbl_tpu_torch as rt

    cfg = rt.RBLConfig(block_size=b, basis_dtype=torch.float32,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=1400)
    rt.rbl(op, k, cfg=cfg)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.rbl(op, k, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    busy = sum(device_us(e) for e in kernels) * 1e-6
    top = sorted(kernels, key=device_us, reverse=True)[:10]
    return dict(profiled_wall_s=wall, device_s=busy, busy_share=busy / wall,
                top=[dict(name=e.key[:80], calls=e.count,
                          device_ms=device_us(e) / 1e3) for e in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_layouts.py needs a CUDA card", file=sys.stderr)
        return 2
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    A = fem_elasticity_3d(42)
    n = A.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, 8), generator=g, dtype=torch.float32, device="cuda")
    Xcol = X.T.contiguous().T  # same values, column-major strides
    res = {"card": card, "layouts": {}}
    for fmt in ("bsr", "dia", "ell", "coo"):
        op = rt.as_operator(A, dtype=torch.float32, device="cuda", format=fmt)
        row = dict(apply_ms_row_major=time_ms(lambda: op.apply(X)),
                   apply_ms_col_major=time_ms(lambda: op.apply(Xcol)),
                   **profile_solve(op, 100, 8))
        res["layouts"][fmt] = row
        print(f"{fmt}: apply {row['apply_ms_row_major']:.4f} ms (row-major X), "
              f"{row['apply_ms_col_major']:.4f} ms (column-major X); profiled "
              f"solve {row['profiled_wall_s']:.3f} s, device busy "
              f"{row['busy_share']:.2f}  [{card}]", flush=True)
        for t in row["top"]:
            print(f"  kernel {t['device_ms']:9.2f} ms {t['calls']:6d}x  {t['name']}")
        del op
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
