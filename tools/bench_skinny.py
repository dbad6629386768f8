#!/usr/bin/env python3
"""The products against the stored basis at the main path's shapes: the
skinny Gram XᵀY (K1) and the update W − V·round(G) (K2) of
``csrc/skinny.cu``, beside their plain versions and one torch.matmul.

    python3 tools/bench_skinny.py [--device cpu] [--reps 20] [--nx 512]
        [--solves 1] [--polish CELL,...] [--rounds 3] [--out FILE]

For each shape (the lap2d_512.k50_b16 cell: a bf16 prefix of 400 and 768
columns against an f32 block of 16; petsc_ex56_ne42.k100_b8: f32 prefixes
of 700 and 1,400 columns at n 232,974 against 8; the polishes: f64 at 8
columns; and the narrow Grams of one block against one block) it times,
with CUDA events around single calls and the L2 flushed before each
(median of ``--reps``):

  - ``k1``, ``k2``: ``ops/contract.py`` ``gram`` and ``update`` (the kernels);
  - ``plain_gram``, ``plain_update``: their plain torch versions (the casts,
    the chunked bmm and its tree; the cast GEMM and the subtraction), which
    the card ran before the kernels;
  - ``lib_gram``, ``lib_update``: one torch.matmul of the same shape in V's
    dtype (the yardstick; the port never calls it);

and the byte bound of each kernel at 3.35 TB/s: K1 reads V and W once
(n·p·|V| + n·q·|W|), K2 reads V and W and writes the result (n·p·|V| +
2·n·q·|W|).  Then ``--solves`` capped solves at the k50 cell's and the
k100 cell's settings on the nx² Laplacian count the launches of each
kernel a solve.

``--polish`` takes benchmark cells (``perfbench/``'s, e.g.
``lap2d_512.polish_k50_1e-7``) and splits their products by kind: "wide"
(V or X more than 16 columns: a prefix, the deflation, the Rayleigh-Ritz
Gram) or "narrow" (one block), and dtype, and by product and shape.  Each cell's solve runs in three
variants: every product through the kernels (the program), the wide f64
products through the plain versions (the rest through the kernels), and
every product through the plain versions (the path the card ran before
the kernels).  Per variant: the median wall of ``--rounds`` solves (the
variants alternate) and, from one solve under torch.profiler, the device
time and the calls of each kind, and the device time of the 16 costliest
(product, p × q) shapes (each device event put down to the product whose
launcher launched it).

Prints the card's name and power limit, one line a row and one JSON
object; ``--device cpu`` runs the plain versions alone at a small size as
a smoke run (no device metric).
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

HBM_BYTES_S = 3.35e12

# (name, n, p, q, V dtype, W dtype)
SHAPES = (
    ("k50 prefix", 262_144, 400, 16, "bfloat16", "float32"),
    ("k50 prefix", 262_144, 768, 16, "bfloat16", "float32"),
    ("k50 narrow", 262_144, 16, 16, "float32", "float32"),
    ("k100 prefix", 232_974, 700, 8, "float32", "float32"),
    ("k100 prefix", 232_974, 1400, 8, "float32", "float32"),
    ("k100 narrow", 232_974, 8, 8, "float32", "float32"),
    ("polish f64", 262_144, 256, 8, "float64", "float64"),
    ("polish f64", 262_144, 720, 8, "float64", "float64"),
    ("polish narrow", 262_144, 8, 8, "float64", "float64"),
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
        fn()  # warm: builds, plans, allocator
        times = []
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def launches_per_solve(dev, nx: int, solves: int) -> list:
    """Kernel launches a solve at the two capped cells' settings on the
    nx² Laplacian (the stencil: no other kernel of the port runs)."""
    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops import contract

    rows = []
    for name, b, k, cap, basis in (("k50_b16", 16, 50, 768, torch.bfloat16),
                                   ("k100_b8", 8, 100, 1400, torch.float32)):
        cfg = rt.RBLConfig(block_size=b, compute_dtype=torch.float32,
                           basis_dtype=basis, qr_method="cholqr2", tol=1e-3,
                           max_kryl_dim=cap, eig_poll_cadence=16, device=str(dev))
        op = rt.Laplacian2D(nx, nx, dtype=torch.float32, device=dev)
        rt.rbl(op, k, cfg=cfg)  # warm
        c0 = (contract.gram.launches, contract.update.launches)
        t0 = time.perf_counter()
        for _ in range(solves):
            res = rt.rbl(op, k, cfg=cfg)
        wall = (time.perf_counter() - t0) / solves
        c1 = (contract.gram.launches, contract.update.launches)
        rows.append(dict(cell=name, kryl_cols=int(res.kryl_dim), solve_s=wall,
                         k1=(c1[0] - c0[0]) / solves, k2=(c1[1] - c0[1]) / solves))
        print(f"{name}: {rows[-1]}", flush=True)
    return rows


VARIANTS = ("kernels", "plain_wide_f64", "plain")
WIDE = 16  # columns of V or X past one block


def kind(t) -> str:
    """A product's kind: wide or narrow V (or X), and its dtype."""
    return f"{'wide' if t.shape[1] > WIDE else 'narrow'}_{str(t.dtype)[6:]}"


def routed_launchers(plain_for, calls, k1, k2):
    """Stand-ins for ``_kernels.launch_gram`` and ``launch_update`` (the
    launchers ``k1`` and ``k2``) that send the kinds in ``plain_for`` to
    the plain versions and the rest to the kernels, each call inside a
    ``skinny.<kind>`` profiler range and counted in ``calls``."""
    from torch.profiler import record_function

    from rbl_tpu_torch.ops import contract

    def gram(X, Y, *, chunk, acc):
        name = kind(X)
        calls[name] = calls.get(name, 0) + 1
        with record_function(f"skinny.{name}.gram.{X.shape[1]}x{Y.shape[1]}"):
            if name in plain_for:
                return contract._plain_gram(X, Y, chunk, acc), 0
            return k1(X, Y, chunk=chunk, acc=acc)

    def update(V, G, W, *, acc):
        name = kind(V)
        calls[name] = calls.get(name, 0) + 1
        with record_function(f"skinny.{name}.update.{V.shape[1]}x{G.shape[1]}"):
            if name in plain_for:
                return contract._plain_update(V, G, W, acc)
            return k2(V, G, W, acc=acc)

    return gram, update


def device_ms_by_range(events) -> dict:
    """Device ms of the events launched inside each ``skinny.<kind>.<op>.
    <p>x<q>`` range (matched by correlation id to the runtime call on the
    ranges' thread that launched them, as ``perfbench/harness/spans.py``
    does), by the range's name less ``skinny.``, and ``busy`` for all."""
    import bisect

    from perfbench.harness import profile, spans

    kinds = [profile._kind(e) for e in events]
    ranges, launch, device = [], {}, []
    for e, k in zip(events, kinds):
        s = e.start_ns()
        if k == "user_annotation" and e.name().startswith("skinny."):
            ranges.append((s, s + e.duration_ns(), e.name()[7:], e.start_thread_id()))
        elif spans._is_launch(e, k):
            launch[e.correlation_id()] = (s, e.start_thread_id())
        elif k in profile.DEVICE_KINDS:
            device.append((e.duration_ns(), e.correlation_id()))
    ranges.sort()
    starts = [r[0] for r in ranges]
    main = ranges[0][3] if ranges else None
    out = {"busy": 0.0}
    for dur, corr in device:
        out["busy"] += dur / 1e6
        t, thread = launch.get(corr, (None, None))
        i = bisect.bisect_right(starts, t) - 1 if thread == main else -1
        if i >= 0 and t <= ranges[i][1]:
            out[ranges[i][2]] = out.get(ranges[i][2], 0.0) + dur / 1e6
    return out


def polish_split(cells, dev, rounds: int) -> list:
    """Each cell's solve in the three ``VARIANTS``: walls, device ms and
    calls by kind (see the module's docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import problem, program, spec
    from rbl_tpu_torch.ops.spmm import _kernels

    k1, k2 = _kernels.launch_gram, _kernels.launch_update
    rows = []
    for name in cells:
        cell = spec.resolve(name)
        prog = program.Program(problem.build(cell.config), cell.mix, dev)
        plain_for = {"kernels": set(), "plain_wide_f64": {"wide_float64"},
                     "plain": {f"{w}_{d}" for w in ("wide", "narrow")
                               for d in ("bfloat16", "float32", "float64")}}
        out = {v: dict(cell=name, variant=v, walls=[]) for v in VARIANTS}
        try:
            for r in range(rounds + 1):  # round 0 warms each variant
                for v in VARIANTS:
                    calls = {}
                    _kernels.launch_gram, _kernels.launch_update = \
                        routed_launchers(plain_for[v], calls, k1, k2)
                    t0 = time.perf_counter()
                    prog.solve(1000 + r)  # ends in a synchronize
                    if r:
                        out[v]["walls"].append(time.perf_counter() - t0)
            for v in VARIANTS:
                calls = {}
                _kernels.launch_gram, _kernels.launch_update = \
                    routed_launchers(plain_for[v], calls, k1, k2)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    prog.solve(1000)
                    torch.cuda.synchronize()
                ms = device_ms_by_range(prof.profiler.kineto_results.events())
                by_kind = {"busy": ms.pop("busy")}
                for rng, t in ms.items():
                    k = rng.split(".")[0]
                    by_kind[k] = by_kind.get(k, 0.0) + t
                walls = sorted(out[v]["walls"])
                out[v].update(solve_s=walls[len(walls) // 2], calls=calls,
                              device_ms=by_kind,
                              top_shapes=dict(sorted(ms.items(), key=lambda kv: -kv[1])[:16]))
                print(json.dumps(out[v]), flush=True)
        finally:
            _kernels.launch_gram, _kernels.launch_update = k1, k2
        rows.extend(out.values())
        del prog
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--solves", type=int, default=1)
    ap.add_argument("--polish", default="",
                    help="benchmark cells to split by kind of product (comma list)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from rbl_tpu_torch.ops import contract

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    if card and not torch.cuda.is_available():
        print("bench_skinny.py: no CUDA card (pass --device cpu for a smoke run)",
              file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    name = power_limit() if card else "cpu"
    print(f"card: {name}", flush=True)
    run = timer(dev, args.reps)
    rows = []
    for label, n, p, q, vdt, wdt in SHAPES:
        if not card:
            n = min(n, 20_000)
        vdt, wdt = getattr(torch, vdt), getattr(torch, wdt)
        acc = torch.float64 if wdt == torch.float64 else torch.float32
        width = -(-(p + 16) // 8) * 8  # a basis buffer wider than the prefix
        buf = torch.zeros((n, width), dtype=vdt, device=dev)
        buf[:, :p] = (torch.randn((n, p), device=dev) / n ** 0.5).to(vdt)
        V = buf[:, :p]
        W = torch.randn((n, q), dtype=wdt, device=dev)
        G = contract._plain_gram(V, W, 8192, acc)
        Wv = W.to(vdt)
        Gv = G.to(vdt)
        sv, sw = V.element_size(), W.element_size()
        row = dict(shape=label, n=n, p=p, q=q, V=str(vdt)[6:], W=str(wdt)[6:],
                   bound_gram_ms=1e3 * (n * p * sv + n * q * sw) / HBM_BYTES_S,
                   bound_update_ms=1e3 * (n * p * sv + 2 * n * q * sw) / HBM_BYTES_S)
        if card:
            row["k1_ms"] = run(lambda: contract.gram(V, W))
            row["k2_ms"] = run(lambda: contract.update(V, G, W))
        row["plain_gram_ms"] = run(lambda: contract._plain_gram(V, W, 8192, acc))
        row["plain_update_ms"] = run(lambda: contract._plain_update(V, G, W, acc))
        row["lib_gram_ms"] = run(lambda: torch.matmul(V.mT, Wv))
        row["lib_update_ms"] = run(lambda: torch.matmul(V, Gv))
        if card:
            row["k1_share"] = row["bound_gram_ms"] / row["k1_ms"]
            row["k2_share"] = row["bound_update_ms"] / row["k2_ms"]
        rows.append(row)
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
        del buf, V, W, G, Wv, Gv
    solves = launches_per_solve(dev, args.nx if card else 48, args.solves)
    out = dict(card=name, device=str(dev), reps=args.reps, rows=rows,
               solves=solves)
    if args.polish:
        if not card:
            print("bench_skinny.py: --polish runs on the card only", file=sys.stderr)
            return 1
        out["polish"] = polish_split(args.polish.split(","), dev, args.rounds)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
