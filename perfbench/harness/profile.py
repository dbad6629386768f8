"""Busy share, top device operations and host gaps of a profiled window.

The arithmetic is a copy of ``tools/profile_solves.py``'s ``summarize``
(kernel names without template arguments, the union of device intervals,
idle stretches over 50 µs named by the Timer section and torch operation
the host was in), read from the profiler's events in memory instead of a
Chrome trace written to disk.  The window is the benchmark's own range
``perfbench.profiled`` around whole solves that end in a synchronize.
"""

from __future__ import annotations

import contextlib
import re

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_NS = 50_000      # device idle stretches shorter than this are launch spacing
RANGE = "perfbench.profiled"


def short(name: str) -> str:
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


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@contextlib.contextmanager
def profiled(device):
    """Profile the body (CPU and, on a card, CUDA activity), inside the
    range that marks the window; yields a dict that holds the summary once
    the body has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    out: dict = {}
    with profile(activities=acts) as prof:
        with record_function(RANGE):
            yield out
            if on_card:
                torch.cuda.synchronize()
    out.update(summarize(prof.profiler.kineto_results.events()))


def _kind(e) -> str:
    """The event's kind as a Chrome trace's ``cat`` names it; older torch
    has no ``activity_type`` and is read from the device and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = "CPU" not in str(e.device_type())
    note = getattr(e, "is_user_annotation", lambda: False)()
    if on_device:
        if note:
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if note else "cpu_op"


def _innermost(spans, t):
    inner = [sp for sp in spans if sp[0] <= t <= sp[1]]
    return min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else None


def summarize(events, top: int = 10, gaps: int = 10) -> dict:
    """From the profiler's events: ``window_s`` (the marked range),
    ``busy_s`` (the union of device intervals inside it), the top device
    operations by summed time and the longest idle gaps, each named by
    the host's Timer section and innermost torch operation."""
    kinds = [_kind(e) for e in events]
    win = [e for e, kind in zip(events, kinds)
           if e.name() == RANGE and kind == "user_annotation"]
    if not win:
        return {}
    w = win[0]
    t0, t1, main = w.start_ns(), w.start_ns() + w.duration_ns(), w.start_thread_id()
    dev, sections, ops = [], [], []
    for e, kind in zip(events, kinds):
        s = e.start_ns()
        f = s + e.duration_ns()
        if kind in DEVICE_KINDS:
            s, f = max(s, t0), min(f, t1)
            if f > s:
                dev.append((s, f, short(e.name()) if kind == "kernel" else kind))
        elif e.start_thread_id() == main and s < t1 and f > t0:
            if kind == "user_annotation" and e.name() != RANGE:
                sections.append((s, f, e.name()))
            elif kind == "cpu_op":
                ops.append((s, f, e.name()))
    busy = union([(s, f) for s, f, _ in dev])
    busy_ns = sum(f - s for s, f in busy)
    by_name: dict = {}
    for s, f, k in dev:
        by_name[k] = by_name.get(k, 0) + (f - s)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [t0] + [x for s, f in busy for x in (s, f)] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] - edges[i] > GAP_NS]
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:gaps]
    named = []
    for s, f in longest:
        mid = (s + f) / 2
        sec, op = _innermost(sections, mid), _innermost(ops, mid)
        named.append([f"{sec or '-'} / {op or '-'}", (f - s) / 1e9])
    return dict(
        window_s=(t1 - t0) / 1e9,
        busy_s=busy_ns / 1e9,
        device_events=len(dev),
        device_ops=[[k, v / 1e9] for k, v in ranked],
        idle_gaps=named,
        gaps_over_50us=len(idle),
        gap_s=sum(f - s for s, f in idle) / 1e9,
    )
