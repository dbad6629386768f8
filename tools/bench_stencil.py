#!/usr/bin/env python3
"""The stencil of ``Laplacian2D`` and the Chebyshev product filter's step
on it at the main path's shapes: K3 (``csrc/stencil.cu``) beside its byte
bound, its plain version and one step of the torch loop it replaced.

    python3 tools/bench_stencil.py [--device cpu] [--reps 30] [--nx 512]
        [--solves 1] [--out FILE]

For each shape on the nx² grid (the applies A·Y of the capped sweep, f32 b
16, of the polish's Rayleigh-Ritz, f64 b 8, of the bf16 control at b 16;
the filter steps of the polish's chains, f32 and f64 at 48 and 90
columns) it times, with CUDA events around single calls and the L2 flushed
before each (median of ``--reps``):

  - ``k3``: ``ops/spmm/stencil.py`` ``step`` (one launch; a filter step
    with r, the previous step's sums and its own);
  - ``plain``: the plain version of the same call on the card (the torch
    expressions: the apply's five ops; a step's divide, apply, −r·Y and
    column sums);
  - ``loop``: for a filter step, one step of the loop the card ran before
    K3 (the torch apply, −r·Y, the column sums of squares, the square
    root, the where and the divide);

and the byte bound: Y read once and Z written once, 2·n·b·sizeof bytes at
3.35 TB/s.  Then ``--solves`` solves at ``lap2d_512.polish_k50_1e-7``'s
settings on the nx² Laplacian count the fused filter steps a solve (the
Timer's ``filter_fused_steps``) and K3's launches, and time the solve
against the same solve on the stencil with the plain ``filter_step`` and the
torch apply (the path before K3), in turns.

Prints the card's name and power limit, one line a row and one JSON
object; ``--device cpu`` runs the plain versions alone at a small size as
a smoke run (no device metric).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_S = 3.35e12

# (name, columns, dtype, a filter step: r and sums)
SHAPES = (
    ("k50 sweep apply", 16, "float32", False),
    ("polish RR apply", 8, "float64", False),
    ("bf16 control apply", 16, "bfloat16", False),
    ("polish f32 step", 48, "float32", True),
    ("polish f32 step", 90, "float32", True),
    ("polish f64 step", 48, "float64", True),
    ("polish f64 step", 90, "float64", True),
)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def timer(dev, reps: int):
    """Median ms of ``reps`` single calls of a function, each after an L2
    flush (CUDA events on the card, the host clock on the CPU)."""
    import torch

    flush = (torch.empty(64 << 20, dtype=torch.int32, device=dev)
             if dev.type == "cuda" else None)

    def run(fn) -> float:
        fn()  # warm: build, plan, allocator
        times = []
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        return times[len(times) // 2]
    return run


def shape_rows(dev, nx: int, reps: int) -> list:
    import torch

    from rbl_tpu_torch.ops.spmm import stencil
    from rbl_tpu_torch.ops.spmm.operator import LinearOperator
    from rbl_tpu_torch.parallel.mesh import col_sumsq

    class Plain(LinearOperator):
        """The plain apply with LinearOperator's plain filter step."""

        def apply(self, X):
            return stencil._plain_apply(X, nx, nx)

    run = timer(dev, reps)
    card = dev.type == "cuda"
    n = nx * nx
    rows = []
    for name, b, dt, is_step in SHAPES:
        dtype = getattr(torch, dt)
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        g = torch.Generator(device=dev).manual_seed(b)
        Y = torch.randn((n, b), generator=g, dtype=torch.float64, device=dev).to(dtype)
        r = torch.tensor(2.5, dtype=dtype, device=dev) if is_step else None
        S = torch.sum(Y.to(acc) ** 2, dim=0) if is_step else None

        def k3():
            return stencil.step(Y, nx, nx, r, S, sumsq=is_step)

        def plain():
            if is_step:
                return Plain().filter_step(Y, r, S)
            return stencil._plain_apply(Y, nx, nx)

        def loop():
            Z = stencil._plain_apply(Y, nx, nx) - r * Y
            nrm = torch.sqrt(col_sumsq(Z, None))
            return Z / torch.where(nrm > 0, nrm, torch.ones_like(nrm))

        row = dict(shape=name, n=n, b=b, dtype=dt,
                   bound_ms=2 * n * b * Y.element_size() / HBM_BYTES_S * 1e3,
                   plain_ms=run(plain))
        if is_step:
            row["loop_ms"] = run(loop)
        if card:
            n0 = stencil.step.launches
            row["k3_ms"] = run(k3)
            row["k3_launches"] = stencil.step.launches - n0
            row["share_pct"] = 100 * row["bound_ms"] / row["k3_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def polish_solves(dev, nx: int, solves: int) -> dict:
    """Solves at the lap2d polish cell's settings through K3 and through
    the torch loop, alternating: fused steps and K3 launches a solve, and
    the median wall of each."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import stencil
    from rbl_tpu_torch.ops.spmm.operator import LinearOperator
    from rbl_tpu_torch.utils.profiling import Timer

    @dataclasses.dataclass
    class TorchStencil(LinearOperator):
        """The stencil as the card ran it before K3: the torch apply, and
        LinearOperator's plain ``filter_step`` (the product filter's loop
        before K3, op for op)."""

        nx: int
        ny: int
        dtype: torch.dtype = torch.float64
        device: torch.device = None

        @property
        def shape(self):
            return (self.nx * self.ny, self.nx * self.ny)

        def apply(self, X):
            return stencil._plain_apply(X, self.nx, self.ny)

        def diagonal(self):
            return torch.full((self.n,), 4.0, dtype=self.dtype, device=self.device)

    cfg = rt.RBLConfig(block_size=8, compute_dtype=torch.float64,
                       basis_dtype=torch.float64, qr_method="cholqr2",
                       tol=1e-7, eig_poll_cadence=16, device=str(dev))
    ops = {"k3": rt.Laplacian2D(nx, nx, dtype=torch.float64, device=dev),
           "torch_loop": TorchStencil(nx, nx, torch.float64, dev)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    walls = {name: [] for name in ops}
    out = {}
    for i in range(solves + 1):  # the first round warms both
        for name, op in ops.items():
            timer_ = Timer()
            n0 = stencil.step.launches
            sync()
            t0 = time.perf_counter()
            res = rt.rbl_polished(op, 50, cfg=cfg, b=8, bounds=(0.0, None),
                                  timer=timer_)
            sync()
            wall = time.perf_counter() - t0
            if i:
                walls[name].append(wall)
            out[name] = dict(converged=bool(res.converged),
                             filter_fused_steps=timer_.counters["filter_fused_steps"],
                             spmm_sections=timer_.counts["spmm"],
                             k3_launches=stencil.step.launches - n0,
                             top=float(res.eigenvalues[0]))
    for name, w in walls.items():
        w.sort()
        out[name]["solve_s"] = w[len(w) // 2] if w else None
        out[name]["walls"] = w
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--nx", type=int, default=None,
                    help="grid side (512 on the card, 64 on the CPU)")
    ap.add_argument("--solves", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a smoke run")
    nx = args.nx or (512 if dev.type == "cuda" else 64)
    card = (f"{torch.cuda.get_device_name(dev)}; {power_limit()}"
            if dev.type == "cuda" else "cpu (smoke run: no device metric)")
    print(f"device: {card}", flush=True)
    result = dict(device=card, nx=nx, shapes=shape_rows(dev, nx, args.reps))
    if args.solves > 0:
        result["polish"] = polish_solves(dev, nx, args.solves)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
