"""DMA-stream probe — splits the packed-BSR SpMM's time on the card.

The port's counterpart of ``benchmarks/dma_stream_bench.py``, with the
same names, flags, default configurations and output lines.  For each
(tile height bm, unroll U) it streams vals (S·CH, 128) f32, S chunks of
CH = bm·U rows — the byte stream of the packed kernel's tiles — through
three CUDA kernels (``csrc/dma_stream.cu``):

  stream      the pure tile stream, each chunk summed per column (B5): the
              cost of reading the tiles, and of one CTA per chunk.
  stream_dot  the same stream plus the per-tile FP32 products tile · xtᵀ
              against a resident (8, 128) xt (B6): the stream → stream_dot
              difference is the cost of the multiply-adds.
  manual      the stream through a 2-slot ring of shared memory filled by
              bulk asynchronous copies from a persistent grid (B7): what
              explicit copies buy over plain loads.

Each kernel has its plain PyTorch version beside it (``*_reference``),
which walks the stream chunk by chunk into an (8, 128) accumulator as the
Pallas grid did; a wrapper runs it for CPU tensors only, and on a CUDA
tensor launches its kernel or raises.

Timing, as in the JAX harness: calls chained through a flowing seed
(out / ‖out‖ fed back), the marginal cost between ``reps`` and ``4·reps``
chained calls.  Each chained step also launches a norm and a divide, so
beside it stands the kernel alone (CUDA events around calls launched
back to back, ``kernel_ms``), from which the share of the bound is taken.

    python -m rbl_tpu_torch.benchmarks.dma_stream_bench [--mb 256] [--reps 8]
        [--configs 16:8,16:32] [--device cuda|cpu]

The card is the default; ``--device cpu`` runs the plain versions (host
times, no device metric).
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5  # |out − ref| ≤ TOL · Σ|terms| for every output entry
# NVIDIA H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FMA-unit operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DEFAULT_CONFIGS = ((16, 8), (16, 32), (16, 64), (32, 16), (32, 32), (128, 8))
VARIANTS = ("stream", "stream_dot", "manual")


def _check(vals, seed, xt, S: int, CH: int):
    """Validate the operands; raises for a device with no kernel."""
    if S < 1 or CH < 1:
        raise ValueError(f"S={S} and CH={CH} must be positive")
    dev = vals.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no tile-stream kernel for {dev}")
    for name, t, shape in (("vals", vals, (S * CH, 128)), ("seed", seed, (8, 128)),
                           ("xt", xt, (8, 128))):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"the kernels read {name} in 16-byte vectors: "
                             "its storage must be 16-byte aligned")


# --- plain versions -----------------------------------------------------------

def stream_reference(vals, seed, *, S: int, CH: int):
    """B5's function, chunk by chunk: seed + every chunk's column sums."""
    acc = seed.clone()
    for i in range(S):
        acc += vals[i * CH:(i + 1) * CH].sum(0)[None, :]
    return acc


def stream_dot_reference(vals, seed, xt, *, S: int, CH: int, bm: int, U: int):
    """B6's function, chunk by chunk: seed + the sum of every (bm, 8)
    product tile · xtᵀ of the chunk's U tiles."""
    acc = seed.clone()
    for i in range(S):
        tiles = vals[i * CH:(i + 1) * CH].view(U, bm, 128)
        acc += (tiles @ xt.T).sum()
    return acc


def manual_reference(vals, seed, *, S: int, CH: int):
    """B7's function, which is B5's: the copies change how the chunks
    arrive, not what is summed."""
    return stream_reference(vals, seed, S=S, CH=CH)


# --- the kernels' wrappers ------------------------------------------------------

def dma_stream(vals, seed, *, S: int, CH: int):
    """B5: out (8, 128) = seed + the column sums of vals (S·CH, 128)."""
    _check(vals, seed, None, S, CH)
    if vals.device.type == "cpu":
        return stream_reference(vals, seed, S=S, CH=CH)
    from ..ops.spmm._kernels import launch_stream

    out = launch_stream(vals, seed, S=S, CH=CH)
    dma_stream.launches += 1
    return out


def dma_stream_dot(vals, seed, xt, *, S: int, CH: int, bm: int, U: int):
    """B6: out (8, 128) = seed + Σ of every product tile · xtᵀ, tiles
    (bm, 128), U of them in each chunk of CH = bm·U rows."""
    if bm < 1 or U < 1 or bm * U != CH:
        raise ValueError(f"CH={CH} is not bm·U = {bm}·{U}")
    _check(vals, seed, xt, S, CH)
    if vals.device.type == "cpu":
        return stream_dot_reference(vals, seed, xt, S=S, CH=CH, bm=bm, U=U)
    from ..ops.spmm._kernels import launch_stream_dot

    out = launch_stream_dot(vals, seed, xt, S=S, CH=CH, bm=bm, U=U)
    dma_stream_dot.launches += 1
    return out


def dma_stream_manual(vals, seed, *, S: int, CH: int):
    """B7: B5's function, through a ring of shared memory filled by bulk
    asynchronous copies."""
    _check(vals, seed, None, S, CH)
    if vals.device.type == "cpu":
        return manual_reference(vals, seed, S=S, CH=CH)
    from ..ops.spmm._kernels import launch_manual

    out = launch_manual(vals, seed, S=S, CH=CH)
    dma_stream_manual.launches += 1
    return out


# CUDA kernel launches per wrapper: a run can show it went through them
dma_stream.launches = 0
dma_stream_dot.launches = 0
dma_stream_manual.launches = 0


def make_stream(S: int, CH: int):
    """(vals, seed) → (8, 128), as the JAX package's ``make_stream``."""
    return functools.partial(dma_stream, S=S, CH=CH)


def make_stream_dot(S: int, CH: int, bm: int, U: int):
    """(vals, seed, xt) → (8, 128), as ``make_stream_dot``."""
    return functools.partial(dma_stream_dot, S=S, CH=CH, bm=bm, U=U)


def make_manual(S: int, CH: int):
    """(vals, seed) → (8, 128), as ``make_manual``."""
    return functools.partial(dma_stream_manual, S=S, CH=CH)


# --- accuracy rule ----------------------------------------------------------

def reference_f64(variant: str, vals, seed, xt=None):
    """The exact result of ``variant`` in f64, and Σ|terms| of each entry
    (|seed| plus the absolute values of every term summed into it)."""
    v, sd = vals.double(), seed.double()
    if variant == "stream_dot":
        x = xt.double()
        return sd + (v @ x.T).sum(), sd.abs() + (v.abs() @ x.abs().T).sum()
    return sd + v.sum(0), sd.abs() + v.abs().sum(0)


def error_ratio(out, ref, scale) -> float:
    """max over entries of |out − ref| / (TOL · Σ|terms|): at most 1 passes.
    Sums of many terms of both signs cancel, so a tolerance relative to
    the result would depend on the order of the additions."""
    out = torch.as_tensor(out).to(ref.device, torch.float64)
    return float(((out - ref).abs() / (TOL * scale.clamp_min(1e-300))).max())


# --- timing -------------------------------------------------------------------

def time_chained(call, vals, seed0, reps: int, extra=(), *,
                 clock=time.perf_counter):
    """Marginal seconds per call: ``call(vals, y, *extra)`` chained through
    the flowing seed y ← out / ‖out‖, so that no call repeats another's
    inputs; the difference between ``4·reps`` and ``reps`` chained calls
    (medians of 3) cancels the fixed cost of a run.  A marginal ≤ 0 is
    measured once more, and then raises."""
    salt = itertools.count(1)

    def run(r: int) -> float:
        y = seed0 + next(salt) * 1e-6
        t0 = clock()
        for _ in range(r):
            out = call(vals, y, *extra)
            n = torch.linalg.vector_norm(out)
            y = out / torch.where(n > 0, n, torch.ones_like(n))
        float(y[0, 0])  # waits for the chain
        return clock() - t0

    run(1)  # warm-up (and the kernels' build)
    for _ in range(2):
        lo = float(np.median([run(reps) for _ in range(3)]))
        hi = float(np.median([run(4 * reps) for _ in range(3)]))
        if hi > lo:
            return (hi - lo) / (3 * reps)
    raise RuntimeError(f"time_chained: marginal {hi - lo:.3e} s ≤ 0 twice "
                       f"(reps={reps}); no time can be given")


def kernel_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    calls launched back to back, over their count (median of ``reps``
    runs, warm).  A single call timed on an idle card would also count
    the host's enqueue of its launches, a large part of a 0.1 ms kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound_ms(variant: str, vals) -> float:
    """The least time the card could take: vals, seed and out (and xt)
    moved once over HBM bandwidth, or the operations (one add a value;
    8 FMAs of 2 operations for stream_dot) over the FP32 peak."""
    n = vals.numel()
    moved = 4 * n + 2 * 8 * 128 * 4 + (8 * 128 * 4 if variant == "stream_dot" else 0)
    ops = 16 * n if variant == "stream_dot" else n
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def probe(vals, seed0, xt, *, bm: int, U: int, reps: int) -> list[dict]:
    """Time each variant on vals (S·CH, 128), CH = bm·U: the chained
    marginal and, on the card, the kernel alone with its bound share.
    Prints one ``[row]`` line a variant; returns the rows."""
    CH = bm * U
    S = vals.shape[0] // CH
    calls = {"stream": (make_stream(S, CH), ()),
             "stream_dot": (make_stream_dot(S, CH, bm, U), (xt,)),
             "manual": (make_manual(S, CH), ())}
    nbytes = vals.numel() * vals.element_size()
    rows = []
    for name in VARIANTS:
        fn, extra = calls[name]
        dt = time_chained(fn, vals, seed0, reps, extra=extra)
        gbs = nbytes / dt / 1e9
        row = {"bm": bm, "U": U, "variant": name, "ms": dt * 1e3, "GBps": gbs,
               "kernel_ms": None, "bound_ms": bound_ms(name, vals),
               "bound_share": None}
        line = (f"  [row] bm={bm:4d} U={U:3d} {name:>10} "
                f"{dt*1e3:8.3f} ms  {gbs:7.1f} GB/s")
        if vals.is_cuda:
            y = seed0.clone()
            row["kernel_ms"] = kernel_ms(lambda: fn(vals, y, *extra))
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            line += (f"  kernel alone {row['kernel_ms']:.4f} ms, "
                     f"{nbytes / row['kernel_ms'] / 1e6:.1f} GB/s, "
                     f"{row['bound_share']:.0%} of the {row['bound_ms']:.4f} ms bound")
        print(line, flush=True)
        rows.append(row)
    return rows


def sweep(mb: int, reps: int, configs, device) -> list[dict]:
    """The probe over ``configs`` (bm, U) at ``mb`` MB of vals each, data
    drawn on ``device`` from explicit generators (seeds 0 and 1)."""
    total_rows = (mb * 2**20) // (128 * 4)
    seed0 = torch.zeros((8, 128), dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    xt = torch.randn((8, 128), generator=g.manual_seed(1), device=device)
    rows = []
    for bm, U in configs:
        CH = bm * U
        S = max(total_rows // CH, 2)
        vals = torch.randn((S * CH, 128), generator=g.manual_seed(0),
                           device=device)
        rows += probe(vals, seed0, xt, bm=bm, U=U, reps=reps)
        del vals
    return rows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mb", type=int, default=256)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--configs", type=str, default=None,
                   help="comma list bm:U, e.g. 16:8,16:32")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; the kernels) or cpu (plain versions)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probe runs on the card "
                               "(--device cpu runs the plain versions)")
        name = torch.cuda.get_device_name(device)
        print(f"card: {card_line()}", flush=True)
    else:
        name = "cpu"
        print("device: cpu (plain PyTorch versions, host times)", flush=True)
    torch.set_float32_matmul_precision("highest")  # FP32 products, never TF32
    configs = ([tuple(map(int, c.split(":"))) for c in args.configs.split(",")]
               if args.configs else DEFAULT_CONFIGS)
    rows = sweep(args.mb, args.reps, configs, device)
    print(json.dumps({"metric": "dma_stream_sweep", "mb": args.mb,
                      "device": name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
