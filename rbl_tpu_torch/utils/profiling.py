"""Per-phase timing — the TimerOutputs analogue.

The reference times every phase of the hot loop with a global
``TimerOutput`` (RBL.jl:80-107) and forces a device sync around each timed
region (RBL_gpu.jl:152).  Here: an explicit, passed-in Timer on the host's
wall clock.  With ``sync=True`` each section synchronises the CUDA device
on entry and exit, so a section's time includes the device work it queued.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)  # named totals (bytes, panels)

    def add(self, name: str, value) -> None:
        """Add ``value`` to the named counter (e.g. the bytes a solve's
        basis store moved between its tiers)."""
        self.counters[name] += value

    def _barrier(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name: str):
        self._barrier()
        t0 = time.perf_counter()
        yield
        self._barrier()
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'section':<18}{'calls':>8}{'time (s)':>12}{'%':>7}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}{pct:>6.1f}%")
        lines.append(f"{'total':<18}{'':>8}{total:>12.4f}")
        return "\n".join(lines)


class _NullTimer:
    def add(self, name: str, value) -> None:
        pass

    @contextlib.contextmanager
    def section(self, name: str):
        yield

    def report(self) -> str:
        return "(timing disabled)"


_NULL = _NullTimer()


def null_timer():
    return _NULL
