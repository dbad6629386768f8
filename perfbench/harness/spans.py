"""The program's Timer spans laid over the device's activity.

``profiled(ctx)`` runs one or two whole solves of the cell's program (two
where the window's solves took under 1 s each, as for the run's own traced
solves) under ``torch.profiler``, each with the program's ``Timer`` and
inside the range ``perfbench.spans``, after the run's own traced solves.
It runs once a run: the result is kept on ``ctx`` for every reader.  The
solves take a fixed seed, so their counts repeat from run to run.

Each kernel, copy and fill is put down to the innermost Timer span that
was open on the main thread when the runtime call that launched it ran,
matched by correlation id.  The Timer stamps with the clock the profiler
stamps its CPU events with; how far its main-thread spans sit from their
own ``record_function`` events is in the notes.  The eig worker's spans,
which the profiler does not see, are laid beside the trace on the same
clock.

Per solve, a line of ``ctx.notes``: device time by span, the idle time of
the device by innermost main-thread span, and, for the idle time inside
``eig_last``, how much of it the worker spent screening or factorizing
the poll that ``eig_last`` waits for, or on an earlier poll; and the
longest idle stretches outside every span, by the spans around them.

Nothing to read (None) off the card, or where the program's Timer keeps
no spans.  The helpers of ``profile.py`` are used as they are.
"""

from __future__ import annotations

import bisect
import statistics

from . import profile
from .cell_run import SAMPLE, solve_seed

MARK = "perfbench.spans"            # the range around each profiled solve
SEED = solve_seed(0, SAMPLE + 1)    # fixed, and never a window's seed
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
GOOD_CLOCK_NS = 50_000              # a span this close to its own event agrees
STEP_OPS = ("project", "qr")
NO_SPAN = "-"                       # launched on the main thread outside every span
OFF_MAIN = "(other thread)"         # launched by another thread (e.g. the eig worker)
NO_LAUNCH = "(no launch)"           # no runtime call of the same correlation id


def profiled(ctx):
    """The summary of this run's profiled solves (see ``summarize``),
    measured at the first call; None off the card or where the program's
    Timer keeps no spans."""
    if "span_trace" not in vars(ctx):
        ctx.span_trace = _measure(ctx)
    return ctx.span_trace


def _measure(ctx):
    if ctx.device.type != "cuda":
        return None
    from rbl_tpu_torch.utils import profiling

    if not hasattr(profiling, "Span"):
        return None
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    count = 2 if ctx.span / max(len(ctx.solves), 1) < 1.0 else 1
    timers = []
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(count):
            timer = profiling.Timer(sync=False)
            with record_function(MARK):
                ctx.program.solve(SEED + j, timer=timer)  # ends in a synchronize
            timers.append(timer)
    out = summarize(prof.profiler.kineto_results.events(), timers)
    if out is not None:
        ctx.notes.extend(out["notes"])
    return out


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals; each
    piece keeps what follows the start and end in ``b``'s item (a name)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e) + tuple(b[j][2:]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def by_name(pieces) -> dict:
    """Summed length of (start, end, name) pieces by name."""
    out: dict = {}
    for s, e, name in pieces:
        out[name] = out.get(name, 0) + e - s
    return out


def segments(spans, t0: int, t1: int):
    """[t0, t1] cut into (start, end, name) pieces, each named by the
    innermost of the properly nested ``spans`` (start, end, name) open
    over it, ``NO_SPAN`` where none is."""
    out, stack, t = [], [], t0

    def upto(stop, name):
        nonlocal t
        if stop > t:
            out.append((t, stop, name))
            t = stop

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            upto(*stack.pop())
        upto(s, stack[-1][1] if stack else NO_SPAN)
        stack.append((e, name))
    while stack:
        upto(*stack.pop())
    upto(t1, NO_SPAN)
    return [(max(s, t0), min(e, t1), n) for s, e, n in out if min(e, t1) > max(s, t0)]


def _is_launch(e, kind) -> bool:
    """A CUDA runtime or driver call: the call that launched a device
    event carries its correlation id.  Torch builds without
    ``activity_type`` list such calls as CPU events named ``cu...``."""
    return kind in RUNTIME_KINDS or (kind == "cpu_op" and e.name().startswith("cu"))


def _clock(rf_events, main_spans):
    """How far the Timer's main-thread spans sit from their own
    ``record_function`` events, matched in order of their starts: (median,
    largest, number over ``GOOD_CLOCK_NS``) of |event stamp − span stamp|
    in ns over the starts and ends; None where the two do not name the
    same sequence."""
    if not main_spans or [n for _, _, n in rf_events] != [sp.name for sp in main_spans]:
        return None
    dev = [abs(ev[0] - sp.start_ns) for ev, sp in zip(rf_events, main_spans)]
    dev += [abs(ev[1] - sp.end_ns) for ev, sp in zip(rf_events, main_spans)]
    return int(statistics.median(dev)), max(dev), sum(d > GOOD_CLOCK_NS for d in dev)


def summarize(events, timers) -> dict | None:
    """From the profiler's events and the Timer of each profiled solve
    (in the order of the ``MARK`` ranges): per solve (means over the
    solves) ``launches`` (kernels, copies and fills), ``spmm_ms`` and
    ``step_ops_ms`` (the device time, a union of intervals, of what was
    launched inside "spmm", and inside "project" or "qr"; None where
    nothing was), ``busy_ms``; ``covered`` (the share of device time
    launched inside some Timer span), ``clock_ns`` (see ``_clock``) and the
    notes."""
    kinds = [profile._kind(e) for e in events]
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
                   for e, k in zip(events, kinds)
                   if k == "user_annotation" and e.name() == MARK)
    if not marks or len(marks) != len(timers):
        return None
    main = marks[0][2]
    launch, device, rf = {}, [], []
    for e, k in zip(events, kinds):
        s = e.start_ns()
        if _is_launch(e, k):
            launch[e.correlation_id()] = (s, e.start_thread_id())
        elif k in profile.DEVICE_KINDS:
            device.append((s, s + e.duration_ns(), e.correlation_id()))
        elif (k == "user_annotation" and e.start_thread_id() == main
              and e.name() not in (MARK, profile.RANGE)):
            rf.append((s, s + e.duration_ns(), e.name()))
    rf.sort()
    main_spans = [sp for t in timers for sp in t.spans
                  if sp is not None and sp.name not in t.concurrent]
    clock = _clock(rf, main_spans)
    launched = []  # (device start, device end, launch time, launching thread)
    for s, f, corr in device:
        launched.append((s, f) + launch.get(corr, (None, None)))

    per = [_solve(j, mark, timer, main, launched, len(marks))
           for j, (mark, timer) in enumerate(zip(marks, timers))]
    n = len(per)

    def mean(key):
        vals = [p[key] for p in per]
        return None if None in vals else sum(vals) / n / 1e6

    total = sum(p["total"] for p in per)
    covered = sum(p["covered"] for p in per) / total if total else None
    notes = [p["note"] for p in per]
    notes.append(
        "spans: Timer against record_function: "
        + (f"apart by {clock[0] / 1e3:.1f} us at the median, {clock[1] / 1e3:.1f} us "
           f"at the most, {clock[2]} of {2 * len(main_spans)} stamps over "
           f"{GOOD_CLOCK_NS / 1e3:.0f} us" if clock else
           f"not matched ({len(main_spans)} spans, {len(rf)} events)")
        + "; device time launched inside a Timer span: "
        + (f"{100 * covered:.2f}%" if covered is not None else "none"))
    return dict(solves=n, launches=sum(p["launches"] for p in per) / n,
                spmm_ms=mean("spmm"), step_ops_ms=mean("step"), busy_ms=mean("busy"),
                covered=covered, clock_ns=clock, notes=notes)


def _ms(ns) -> str:
    return f"{ns / 1e6:.3f}"


def _listed(d: dict) -> str:
    return ", ".join(f"{n} {_ms(v)}" for n, v in sorted(d.items(), key=lambda kv: -kv[1]))


def _solve(j, mark, timer, main, launched, count) -> dict:
    """One profiled solve: its device events put down to its Timer's
    spans."""
    m0, m1, _ = mark
    spans = timer.spans
    segs = segments([(sp.start_ns, sp.end_ns, sp.name) for sp in spans
                     if sp is not None and sp.name not in timer.concurrent], m0, m1)
    starts = [sg[0] for sg in segs]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else NO_SPAN

    named = []  # (device start, device end, innermost span at the launch)
    for s, f, at, thread in launched:
        if not m0 <= (s if at is None else at) <= m1:
            continue
        named.append((s, f, NO_LAUNCH if at is None else
                      OFF_MAIN if thread != main else innermost(at)))
    busy = profile.union([(max(s, m0), min(f, m1)) for s, f, _ in named
                          if min(f, m1) > max(s, m0)])
    edges = [m0] + [x for iv in busy for x in iv] + [m1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    pieces = intersect(idle, segs)  # (start, end, innermost span) of the idle time
    dev_by, idle_by = by_name(named), by_name(pieces)
    spmm = [(s, f) for s, f, n in named if n == "spmm"]
    step = [(s, f) for s, f, n in named if n in STEP_OPS]

    # the idle time inside eig_last, by what the eig worker did meanwhile
    last = {i for i, sp in enumerate(spans) if sp is not None and sp.name == "eig_last"}
    waited = intersect(idle, profile.union([(spans[i].start_ns, spans[i].end_ns)
                                            for i in last]))
    worker = {"screening": [], "factorizing": [], "an earlier poll": []}
    for sp in spans:
        if sp is not None and sp.name in timer.concurrent:
            what = ("an earlier poll" if sp.parent not in last else
                    "screening" if sp.name == "eig_screen" else "factorizing")
            worker[what].append((sp.start_ns, sp.end_ns))
    split = {what: length(intersect(waited, profile.union(ivs)))
             for what, ivs in worker.items()}
    split["nothing"] = length(waited) - sum(split.values())

    # the longest idle stretches outside every span, by their neighbours
    outside = []
    for s, e, _ in sorted((p for p in pieces if p[2] == NO_SPAN),
                          key=lambda p: p[0] - p[1])[:3]:
        k = bisect.bisect_right(starts, s)
        before = next((sg[2] for sg in reversed(segs[:k]) if sg[2] != NO_SPAN), "start")
        after = next((sg[2] for sg in segs[k:] if sg[2] != NO_SPAN), "end")
        outside.append(f"{_ms(e - s)} after {before} before {after}")
    note = (f"spans: solve {j + 1} of {count}: {_ms(m1 - m0)} ms, device busy "
            f"{_ms(length(busy))} ms, {len(named)} launches; device ms by span: "
            f"{_listed(dev_by)}; idle ms by span: {_listed(idle_by)}; idle ms in "
            f"eig_last {_ms(length(waited))}, the worker {_listed(split)}; longest "
            f"idle ms outside every span: {', '.join(outside) or 'none'}")
    return dict(launches=len(named), busy=length(busy),
                spmm=length(profile.union(spmm)) if spmm else None,
                step=length(profile.union(step)) if step else None,
                covered=sum(v for n, v in dev_by.items()
                            if n not in (NO_SPAN, OFF_MAIN, NO_LAUNCH)),
                total=sum(dev_by.values()), note=note)
