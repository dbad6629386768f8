"""Per-phase timing — the TimerOutputs analogue.

The reference times every phase of the hot loop with a global
``TimerOutput`` (RBL.jl:80-107) and forces a device sync around each timed
region (RBL_gpu.jl:152).  Here: an explicit, passed-in Timer on the host's
wall clock.  With ``sync=True`` each section synchronises the CUDA device
on entry and exit, so a section's time includes the device work it queued.
Each section is also a ``torch.profiler.record_function`` range, so a
``trace`` shows the solver's phases by name around the kernels they
launch.

Besides the totals (``times``, ``counts``) the Timer keeps every section
as a ``Span`` in ``spans``, in the order the sections opened, stamped with
``clock_ns``: the clock ``torch.profiler`` stamps its CPU events with, so
that a span sits beside the kernels of a trace taken at the same time.
Work timed on another thread (the eig worker) is stamped there and handed
to ``record`` on the main thread: the Timer itself is single-threaded.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

# torch.profiler stamps CPU events with the Unix time in ns
clock_ns = time.time_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: str             # the name of the thread the work ran on
    parent: Optional[int]   # index in ``spans`` of the enclosing section


class Timer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)  # named totals (bytes, panels)
        self.concurrent = set()  # sections timed off the main thread
        self.spans: list[Span] = []
        self._open: list[int] = []  # indices of the open sections, innermost last

    def add(self, name: str, value) -> None:
        """Add ``value`` to the named counter (e.g. the bytes a solve's
        basis store moved between its tiers)."""
        self.counters[name] += value

    def record(self, name: str, start_ns: int, end_ns: int,
               thread: str = "worker") -> None:
        """Count one call of section ``name`` that ran from ``start_ns`` to
        ``end_ns`` (``clock_ns`` stamps) on another thread (e.g. the eig
        worker's factorizations).  It ran alongside the main thread's
        sections, so ``report`` lists it but leaves it out of the total;
        its parent is the section open on the main thread when it is
        recorded."""
        self.times[name] += (end_ns - start_ns) / 1e9
        self.counts[name] += 1
        self.concurrent.add(name)
        self.spans.append(Span(name, start_ns, end_ns, thread,
                               self._open[-1] if self._open else None))

    def _barrier(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name: str):
        self._barrier()
        idx = len(self.spans)
        parent = self._open[-1] if self._open else None
        self.spans.append(None)  # keeps the spans in the order they opened
        self._open.append(idx)
        t0 = clock_ns()
        try:
            with torch.profiler.record_function(name):
                yield
            self._barrier()
        finally:
            t1 = clock_ns()
            self._open.pop()
            self.spans[idx] = Span(name, t0, t1, threading.current_thread().name,
                                   parent)
            self.times[name] += (t1 - t0) / 1e9
            self.counts[name] += 1

    def self_times(self) -> dict:
        """Seconds by section, less the time of the sections nested in it
        (concurrent sections are nobody's children)."""
        inner = defaultdict(int)
        for sp in self.spans:
            if sp is not None and sp.parent is not None and sp.name not in self.concurrent:
                inner[self.spans[sp.parent].name] += sp.end_ns - sp.start_ns
        return {name: t - inner[name] / 1e9 for name, t in self.times.items()}

    def report(self) -> str:
        """The sections by self time, each with its share of the main
        thread's total; concurrent sections are marked and not in the
        total."""
        own = self.self_times()
        total = sum(t for name, t in own.items() if name not in self.concurrent)
        lines = [f"{'section':<18}{'calls':>8}{'self (s)':>12}{'%':>7}"]
        for name, t in sorted(own.items(), key=lambda kv: -kv[1]):
            if name in self.concurrent:
                lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}  (concurrent)")
                continue
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}{pct:>6.1f}%")
        lines.append(f"{'total':<18}{'':>8}{total:>12.4f}")
        return "\n".join(lines)


_NO_SECTION = contextlib.nullcontext()


class _NullTimer:
    def add(self, name: str, value) -> None:
        pass

    def record(self, name: str, start_ns: int, end_ns: int,
               thread: str = "worker") -> None:
        pass

    def section(self, name: str):
        return _NO_SECTION

    def report(self) -> str:
        return "(timing disabled)"


_NULL = _NullTimer()


def null_timer():
    return _NULL


def timed_spmm(apply, timer):
    """An operator's ``apply`` (or its ``filter_step``, whose further
    arguments pass through), or, with a timer, ``apply`` called inside
    the section "spmm", each call adding the columns of its block to the
    counter "spmm_cols" (the widths a solve applied its operator at, which
    the operator's bytes and operations are counted from)."""
    if timer is None or timer is _NULL:
        return apply

    def run(X, *args):
        with timer.section("spmm"):
            timer.add("spmm_cols", X.shape[1])
            return apply(X, *args)

    return run


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the ``with`` body, written as a Chrome
    trace (``trace.json``, open it in Perfetto or chrome://tracing) into
    ``log_dir``; CPU activity always, CUDA kernels too when a card is
    present.  Yields the profiler, whose ``key_averages()`` sums the
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
