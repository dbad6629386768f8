"""The packed block-sparse CUDA kernel (B1/B2) in a profiled solve, and
what each of its launches needs.

``profiled(ctx)`` runs one whole solve of the cell's program (a fixed
seed, so its counts repeat from run to run) under ``torch.profiler``,
inside the range ``perfbench.bsr``, after the run's own traced solves.
It runs once a run: the result is kept on ``ctx`` for every reader.  The
solve's Timer keeps the width of each "spmm" section: the program adds
the columns of every apply it times to the Timer's counter
``spmm_cols``, inside that section.

The kernel is found by its symbol: ``bsr_spmm_kernel`` instantiated for
the packed layout (``PackedRows``; the blocked-ELL B3 is ``EllRows``),
float32 or float64 by its template argument.  Each launch is matched by
correlation id to the runtime call that launched it, and that call to the
"spmm" range (the Timer section's ``record_function``) it falls in, the
i-th such range taking the i-th width the Timer kept.  A launch outside
every "spmm" range (the program's untimed applies, such as the power
iterations that bound ‖A‖) counts in the device time and the launches,
not in the roofline.

Each launch's bound is ``roofline.py``'s for one product at the
launch's width and dtype, whatever layout the program picks: each of the
matrix's nonzeros read once as a value and an int32 column index, X read
and Y written once, two operations a nonzero and column; the larger of
its bytes over 3.35 TB/s and its operations over the dtype's peak
outside the tensor cores (the H100 SXM at 700 W).

Nothing to read (None) off the card; no roofline where the program keeps
no widths (a program without the counter).
"""

from __future__ import annotations

import bisect

import torch

from . import profile
from .cell_run import SAMPLE, solve_seed
from .roofline import bound_seconds
from .spans import RUNTIME_KINDS

MARK = "perfbench.bsr"            # the range around the profiled solve
SEED = solve_seed(0, SAMPLE + 2)  # fixed, and never a window's seed
SYMBOL = "bsr_spmm_kernel"
PACKED = "PackedRows"
DTYPES = {"double": torch.float64, "float": torch.float32}


def kernel_dtype(name: str):
    """The dtype of a B1/B2 launch from the kernel's full name, None for
    any other kernel."""
    if SYMBOL + "<" not in name:   # bsr_spmm_kernel<float, 2, ...PackedRows>(...)
        return None
    args = name.split(SYMBOL + "<", 1)[1].split(">", 1)[0]
    return DTYPES.get(args.split(",", 1)[0].strip()) if PACKED in args else None


def width_timer():
    """The program's Timer, keeping the width of each "spmm" section in
    ``widths``, in the order the sections ran."""
    from rbl_tpu_torch.utils.profiling import Timer

    class WidthTimer(Timer):
        def add(self, name, value):
            super().add(name, value)
            if name == "spmm_cols":
                self.widths.append(int(value))

    timer = WidthTimer(sync=False)
    timer.widths = []
    return timer


def profiled(ctx):
    """The summary of this run's profiled solve (see ``summarize``),
    measured at the first call; None off the card."""
    if "bsr_trace" not in vars(ctx):
        ctx.bsr_trace = _measure(ctx)
    return ctx.bsr_trace


def _measure(ctx):
    if ctx.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    timer = width_timer()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            ctx.program.solve(SEED, timer=timer)  # ends in a synchronize
    out = summarize(prof.profiler.kineto_results.events(), timer.widths, ctx.problem)
    if out is not None:
        ctx.notes.append(out["note"])
    return out


def summarize(events, widths, problem) -> dict | None:
    """From the profiler's events of one marked solve and the widths the
    Timer kept: ``device_ms`` and ``launches`` of the B1/B2 kernels,
    ``busy_ms`` (every device event, a union), ``bound_ms`` and
    ``timed_ms`` (the launches matched to a width: their bound and their
    device time; None where the widths and the "spmm" ranges do not
    pair), and a note (with the matched launches and their device time by
    dtype and width).  None where no solve is marked."""
    kinds = [profile._kind(e) for e in events]
    marks = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e, k in zip(events, kinds)
             if k == "user_annotation" and e.name() == MARK]
    if len(marks) != 1:
        return None
    m0, m1, main = marks[0]
    launch, ranges, device, bsr = {}, [], [], []
    for e, k in zip(events, kinds):
        s, f = e.start_ns(), e.start_ns() + e.duration_ns()
        if k in RUNTIME_KINDS or (k == "cpu_op" and e.name().startswith("cu")):
            launch[e.correlation_id()] = s
        elif k == "user_annotation" and e.name() == "spmm" and e.start_thread_id() == main:
            if m0 <= s <= m1:
                ranges.append((s, f))
        elif k in profile.DEVICE_KINDS and m0 <= s <= m1:
            device.append((s, f))
            dt = kernel_dtype(e.name()) if k == "kernel" else None
            if dt is not None:
                bsr.append((f - s, dt, e.correlation_id()))
    ranges.sort()
    starts = [s for s, _ in ranges]
    paired = bool(widths) and len(widths) == len(ranges)
    bound = timed = 0.0
    matched = 0
    by_width: dict = {}   # (dtype, width) -> [launches, device ns]
    for dur, dt, corr in bsr:
        t = launch.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if paired and t is not None else -1
        if i >= 0 and t <= ranges[i][1]:
            bound += bound_seconds(problem, widths[i], dt)
            timed += dur / 1e9
            matched += 1
            tally = by_width.setdefault((str(dt).split(".")[-1], widths[i]), [0, 0])
            tally[0] += 1
            tally[1] += dur
    busy = sum(f - s for s, f in profile.union(device)) / 1e6
    device_ms = sum(d for d, _, _ in bsr) / 1e6
    out = dict(device_ms=device_ms if bsr else None, launches=len(bsr), busy_ms=busy,
               bound_ms=1e3 * bound if matched else None,
               timed_ms=1e3 * timed if matched else None)
    by_dtype = {str(dt).split(".")[-1]: sum(1 for _, d, _ in bsr if d == dt)
                for dt in DTYPES.values()}
    out["note"] = (
        f"bsr: one solve, device busy {busy:.3f} ms, B1/B2 {device_ms:.3f} ms in "
        f"{len(bsr)} launches ({', '.join(f'{k} {v}' for k, v in by_dtype.items())}); "
        + (f"{matched} inside 'spmm' ranges of known width: {1e3 * timed:.3f} ms "
           f"against a bound of {1e3 * bound:.3f} ms; by dtype and width: "
           + ", ".join(f"{d} {w}: {c} in {ns / 1e6:.3f} ms"
                       for (d, w), (c, ns) in sorted(by_width.items()))
           if matched else
           f"no widths paired ({len(widths)} widths, {len(ranges)} 'spmm' ranges)"))
    return out
