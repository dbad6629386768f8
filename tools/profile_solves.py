#!/usr/bin/env python3
"""Where three solves of the port spend their time, read from the trace
that ``rbl_tpu_torch.utils.profiling.trace`` writes.

    python3 tools/profile_solves.py [--out profile_solves.json] [--keep-traces DIR]
    python3 tools/profile_solves.py --device cpu --nx 64 --fem 8    # smoke run

The solves (chip_smoke.py's configurations): ``lap2d_512_k50_b16``
(bench.py's headline, f32, bf16 basis), ``fem42_k100_b8`` (f32, the packed
kernel) and ``fem42_vibration_k8_b8`` (K·x = λ·M·x, σ = 0, f64, the grid
AMG built once beforehand).  Each runs once to warm up, once timed (the
warm wall), then once inside ``trace()`` with a ``Timer``, whose sections
appear in the trace as named ranges.  From the trace's device events
(kernels, copies, fills) the tool reports, for the traced solve's window:

  - busy share: the union of device intervals over the window;
  - the top operations by summed device time (kernel names shortened);
  - the host gaps: idle stretches of the device, their count and sum over
    50 µs, and the largest, each with the Timer section and the innermost
    torch operation the host was in.

The profiler slows the host (every operation is recorded), so the busy
share within the traced window is a lower bound.  Beside it stands a
cross-run estimate: the traced run's device time over the untraced warm
run's wall (two runs of one solve, so not a share of either).  The Timer's
sections of the main thread are under ``sections_s``; the eig worker's
factorizations, which overlap them, under ``concurrent_s``.  Prints one
line a solve and one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_US = 50.0  # device idle stretches shorter than this are launch spacing


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:70] or name[:70]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, top: int = 8, gaps: int = 5) -> dict:
    """Busy share, top operations and host gaps of a Chrome trace's events
    (the ``traceEvents`` list), over the window from the first event's
    start to the last event's end."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and "dur" in e]
    host_ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    timed = [e for e in events if "dur" in e and "ts" in e]
    if not timed:
        return dict(window_ms=0.0, busy_share=0.0, device_ms=0.0, top=[],
                    gaps_over_50us=0, gap_ms=0.0, largest_gaps=[])
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name = {}
    for e in dev:
        k = _short(e.get("name", "")) if e["cat"] == "kernel" else e["cat"]
        tot, calls = by_name.get(k, (0.0, 0))
        by_name[k] = (tot + float(e["dur"]), calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    idle = [(s, e) for (_, s), (e, _) in zip(busy[:-1], busy[1:])]
    if busy:
        idle = [(t0, busy[0][0])] + idle + [(busy[-1][1], t1)]
    idle = [(s, e) for s, e in idle if e - s > GAP_US]

    def innermost(evts, t):
        inner = [r for r in evts
                 if float(r["ts"]) <= t <= float(r["ts"]) + float(r["dur"])]
        return min(inner, key=lambda r: float(r["dur"]))["name"] if inner else None

    largest = sorted(idle, key=lambda g: g[0] - g[1])[:gaps]
    window = t1 - t0
    return dict(
        window_ms=window / 1e3,
        busy_share=busy_us / window if window > 0 else 0.0,
        device_ms=busy_us / 1e3,
        top=[dict(name=k, device_ms=v[0] / 1e3, calls=v[1],
                  share_of_busy=v[0] / busy_us if busy_us else 0.0)
             for k, v in ranked],
        gaps_over_50us=len(idle),
        gap_ms=sum(e - s for s, e in idle) / 1e3,
        largest_gaps=[dict(ms=(e - s) / 1e3, at_ms=(s - t0) / 1e3,
                           host_section=innermost(ranges, (s + e) / 2),
                           host_op=innermost(host_ops, (s + e) / 2))
                      for s, e in largest],
    )


def _profile(label, run, sync, keep):
    """Run once to warm up, once timed, then once inside trace() with a
    Timer; returns the summary of the traced run beside the timed run's
    wall."""
    from rbl_tpu_torch.utils.profiling import Timer, trace

    run(None)
    sync()
    t0 = time.perf_counter()
    run(None)
    sync()
    warm = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(keep, label) if keep else d
        timer = Timer()
        with trace(log):
            t0 = time.perf_counter()
            run(timer)
            sync()
            traced = time.perf_counter() - t0
        with open(os.path.join(log, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    out = dict(warm_wall_s=warm, traced_wall_s=traced, **summarize(events))
    out["cross_run_busy_estimate"] = out["device_ms"] / 1e3 / warm
    by_time = sorted(timer.times.items(), key=lambda kv: -kv[1])
    out["sections_s"] = {k: v for k, v in by_time if k not in timer.concurrent}
    out["concurrent_s"] = {k: v for k, v in by_time if k in timer.concurrent}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=512, help="Laplacian grid side")
    ap.add_argument("--fem", type=int, default=42, help="fem_elasticity_3d size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--keep-traces", default=None,
                    help="directory to keep each solve's trace.json in")
    args = ap.parse_args()
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available():
            print("profile_solves.py: no CUDA card (pass --device cpu)",
                  file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        card = "cpu"

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    res = {"card": card, "solves": {}}
    nx, fx = args.nx, args.fem
    lap = rt.Laplacian2D(nx, nx, dtype=torch.float32, device=dev)
    lap_cfg = rt.RBLConfig(block_size=16, basis_dtype=torch.bfloat16,
                           compute_dtype=torch.float32, qr_method="cholqr2",
                           tol=1e-3, max_kryl_dim=768, eig_poll_cadence=16,
                           seed=1, device=dev)
    A = fem_elasticity_3d(fx)
    op32 = rt.as_operator(A, dtype=torch.float32, device=dev, format="bsr")
    fem_cfg = rt.RBLConfig(block_size=8, basis_dtype=torch.float32,
                           compute_dtype=torch.float32, qr_method="cholqr2",
                           tol=1e-3, max_kryl_dim=1400, device=dev)
    t0 = time.perf_counter()
    amg = rt.AssembledMultigrid.from_grid(A, (fx, fx + 1, fx + 1), dof=3,
                                          device=dev)
    setup_s = time.perf_counter() - t0
    opK = amg.levels[0].op
    opM = rt.DiagonalOperator(torch.as_tensor(lumped_mass(fx), dtype=torch.float64,
                                              device=dev))
    solves = {
        f"lap2d_{nx}_k50_b16": lambda t: rt.rbl(lap, 50, cfg=lap_cfg, timer=t),
        f"fem{fx}_k100_b8": lambda t: rt.rbl(op32, 100, cfg=fem_cfg, timer=t),
        f"fem{fx}_vibration_k8_b8": lambda t: rt.rbl_generalized(
            opK, opM, 8, 8, cfg=rt.RBLConfig(tol=1e-6, device=dev), which="LM",
            sigma=0.0, inner_psolve=amg.psolve),
    }
    for label, run in solves.items():
        row = _profile(label, run, sync, args.keep_traces)
        if label.startswith(f"fem{fx}_vib"):
            row["amg_setup_host_s"] = setup_s
        res["solves"][label] = row
        print(f"{label}: warm wall {row['warm_wall_s']:.3f} s, traced wall "
              f"{row['traced_wall_s']:.3f} s, window {row['window_ms']:.1f} ms, "
              f"device {row['device_ms']:.1f} ms: busy {row['busy_share']:.3f} of "
              f"the window, {row['cross_run_busy_estimate']:.3f} of the warm "
              f"run's wall (cross-run estimate); "
              f"{row['gaps_over_50us']} host gaps > 50 µs summing "
              f"{row['gap_ms']:.1f} ms  [{card}]", flush=True)
        for t in row["top"]:
            print(f"  {t['device_ms']:10.2f} ms {t['calls']:7d}x "
                  f"{t['share_of_busy']:6.1%}  {t['name']}")
        for g in row["largest_gaps"]:
            print(f"  gap {g['ms']:8.2f} ms at {g['at_ms']:9.1f} ms, host in "
                  f"{g['host_section']} / {g['host_op']}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
