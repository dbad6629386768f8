"""Per-phase timing — the TimerOutputs analogue.

The reference times every phase of the hot loop with a global
``TimerOutput`` (RBL.jl:80-107) and forces a device sync around each timed
region (RBL_gpu.jl:152).  Here: an explicit, passed-in Timer on the host's
wall clock.  With ``sync=True`` each section synchronises the CUDA device
on entry and exit, so a section's time includes the device work it queued.
Each section is also a ``torch.profiler.record_function`` range, so a
``trace`` shows the solver's phases by name around the kernels they
launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)  # named totals (bytes, panels)
        self.concurrent = set()  # sections timed off the main thread

    def add(self, name: str, value) -> None:
        """Add ``value`` to the named counter (e.g. the bytes a solve's
        basis store moved between its tiers)."""
        self.counters[name] += value

    def record(self, name: str, seconds: float) -> None:
        """Count one call of section ``name`` that took ``seconds``, timed
        on another thread (e.g. the eig worker's factorizations).  It ran
        alongside the main thread's sections, so ``report`` lists it but
        leaves it out of the total."""
        self.times[name] += seconds
        self.counts[name] += 1
        self.concurrent.add(name)

    def _barrier(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name: str):
        self._barrier()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self._barrier()
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        """The sections by time, each with its share of the main thread's
        total; concurrent sections are marked and not in the total."""
        total = sum(t for name, t in self.times.items() if name not in self.concurrent)
        lines = [f"{'section':<18}{'calls':>8}{'time (s)':>12}{'%':>7}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            if name in self.concurrent:
                lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}  (concurrent)")
                continue
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}{pct:>6.1f}%")
        lines.append(f"{'total':<18}{'':>8}{total:>12.4f}")
        return "\n".join(lines)


class _NullTimer:
    def add(self, name: str, value) -> None:
        pass

    def record(self, name: str, seconds: float) -> None:
        pass

    @contextlib.contextmanager
    def section(self, name: str):
        yield

    def report(self) -> str:
        return "(timing disabled)"


_NULL = _NullTimer()


def null_timer():
    return _NULL


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
