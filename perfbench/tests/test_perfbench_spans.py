"""The five readers of the program's spans and counters, and
``harness/spans.py``'s putting down of device events to Timer spans: a
made-up trace with known answers, the tiny cells on the CPU (where the
device readers find nothing), and a program that keeps no spans."""

import time
import types

import pytest
import tiny

from perfbench.harness import cell_run, spans
from perfbench.harness.spec import load_module
from rbl_tpu_torch.utils.profiling import Span, Timer

US = 1000  # ns


class Event:
    """What ``summarize`` reads of a ``torch.profiler`` event."""

    def __init__(self, kind, name, start, end, thread=1, corr=0, linked=0):
        self.kind, self._name, self.s, self.e = kind, name, start * US, end * US
        self.thread, self.corr, self.linked = thread, corr, linked

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.thread

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


OFF = 5  # µs: each range's stamps after the Timer's


def _trace():
    """One solve: a sweep step (spmm, project, qr) and the last poll, whose
    factorization runs on the worker while the main thread waits."""
    t = Timer()
    main = [("sweep_dispatch", 100, 600, None), ("spmm", 150, 250, 0),
            ("project", 260, 400, 0), ("qr", 410, 500, 0),
            ("eig_last", 650, 950, None), ("eig_wait", 660, 940, 4)]
    for name, s, e, parent in main:
        t.spans.append(Span(name, s * US, e * US, "MainThread", parent))
    t.spans.append(Span("eig_screen", 300 * US, 350 * US, "rbl-eig_0", None))
    t.spans.append(Span("eig_poll", 640 * US, 930 * US, "rbl-eig_0", 4))
    t.concurrent.update({"eig_screen", "eig_poll"})
    events = [Event("user_annotation", spans.MARK, 0, 1000)]
    events += [Event("user_annotation", n, s + OFF, e + OFF) for n, s, e, _ in main]
    events += [
        Event("cuda_runtime", "cudaLaunchKernel", 160, 162, corr=1),
        Event("kernel", "void spmm_kernel<float>(int)", 200, 300, thread=7, corr=1),
        Event("cuda_runtime", "cudaLaunchKernel", 270, 272, corr=2),
        Event("kernel", "gemm", 300, 450, thread=7, corr=2),
        Event("cuda_runtime", "cudaLaunchKernel", 420, 422, corr=3),
        Event("kernel", "potrf", 460, 520, thread=7, corr=3),
        Event("cuda_runtime", "cudaLaunchKernel", 50, 52, corr=4),
        Event("kernel", "fill", 60, 90, thread=7, corr=4),
        Event("cuda_runtime", "cudaLaunchKernel", 700, 702, thread=2, corr=5),
        Event("kernel", "eigh", 710, 720, thread=7, corr=5),
        Event("gpu_memcpy", "Memcpy DtoH", 960, 980, thread=7, corr=6),
        # a torch op whose own id is the copy's correlation id: not its launch
        Event("cpu_op", "aten::copy_", 955, 958, corr=6),
    ]
    return events, t


def test_summarize_puts_each_launch_down_to_its_innermost_span():
    events, timer = _trace()
    out = spans.summarize(events, [timer])
    assert out["solves"] == 1 and out["launches"] == 6
    assert out["clock_ns"] == (OFF * US, OFF * US, 0)
    assert out["spmm_ms"] == pytest.approx(0.100)
    assert out["step_ops_ms"] == pytest.approx(0.150 + 0.060)
    # busy: [60, 90] ∪ [200, 450] ∪ [460, 520] ∪ [710, 720] ∪ [960, 980]
    assert out["busy_ms"] == pytest.approx(0.370)
    # under a span: the three step kernels, not the fill launched outside
    # every span, the worker's kernel or the copy with no launch
    assert out["covered"] == pytest.approx(310 / 370)
    line = out["notes"][0]
    assert "device ms by span: project 0.150, spmm 0.100, qr 0.060, - 0.030" in line
    # eig_last [655, 955] is idle over [655, 710] and [720, 955]; the
    # waited poll's factorization [645, 935] covers 270 µs of that
    assert "idle ms in eig_last 0.290, the worker factorizing 0.270, nothing 0.020" in line
    assert "apart by 5.0 us at the median, 5.0 us at the most, 0 of 12" in out["notes"][-1]
    assert "longest idle ms outside every span: 0.060 after start before sweep_dispatch" in line


def test_summarize_reads_launches_listed_as_cpu_events():
    """A torch build without ``activity_type`` (``profile._kind`` reads
    it from the device and the name) lists the runtime calls as CPU
    events named ``cuda...``: the same answers."""
    events, timer = _trace()
    for e in events:
        if e.kind == "cuda_runtime":
            e.kind = "cpu_op"
    out = spans.summarize(events, [timer])
    ref = spans.summarize(*_trace()[:1], [timer])
    assert out["launches"] == 6 and out["spmm_ms"] == pytest.approx(0.100)
    assert {k: v for k, v in out.items() if k != "notes"} == {
        k: v for k, v in ref.items() if k != "notes"}


def test_summarize_without_the_marks_or_with_unmatched_names():
    events, timer = _trace()
    assert spans.summarize(events[1:], [timer]) is None          # no solve marked
    assert spans.summarize(events, [timer, Timer()]) is None     # one mark, two timers
    renamed = [e for e in events if e.name() != "qr"]
    out = spans.summarize(renamed, [timer])
    assert out["clock_ns"] is None and "not matched" in out["notes"][-1]


@pytest.mark.parametrize("pieces,expected", [
    ([], [(0, 10, "-")]),
    ([(2, 8, "a"), (3, 5, "b")], [(0, 2, "-"), (2, 3, "a"), (3, 5, "b"), (5, 8, "a"),
                                  (8, 10, "-")]),
    ([(0, 4, "a"), (0, 2, "b"), (4, 10, "c")], [(0, 2, "b"), (2, 4, "a"), (4, 10, "c")]),
])
def test_segments_name_each_piece_by_its_innermost_span(pieces, expected):
    assert spans.segments(pieces, 0, 10) == expected


def _ctx(sections, device="cpu", trace=None):
    import torch

    ctx = types.SimpleNamespace(device=torch.device(device), notes=[],
                                solves=[{"sections": s} for s in sections],
                                span=1.0)
    if trace is not None:
        ctx.span_trace = trace
    return ctx


@pytest.mark.parametrize("name,sections,expected", [
    ("eig_last_ms", [{"eig_last": 0.1, "eig_wait": 0.1}, {"eig_last": 0.3}], 200.0),
    ("eig_busy_ms", [{"eig_screen": 0.01, "eig_poll": 0.05}, {"eig_screen": 0.02}], 40.0),
    # a program without the sections: nothing to read
    ("eig_last_ms", [{"eig_wait": 0.1, "eig": 0.2}], None),
    ("eig_busy_ms", [{"eig_wait": 0.1, "eig_poll": 0.2}], None),
])
def test_span_readers(name, sections, expected):
    value = load_module("metrics", name).read(_ctx(sections))
    assert value == (pytest.approx(expected) if expected is not None else None)


@pytest.mark.parametrize("name,key", [("spmm_device_ms", "spmm_ms"),
                                      ("step_ops_device_ms", "step_ops_ms"),
                                      ("launches", "launches")])
def test_device_readers_read_the_shared_profile(name, key):
    events, timer = _trace()
    trace = spans.summarize(events, [timer])
    reader = load_module("metrics", name)
    assert reader.read(_ctx([], "cuda", trace)) == trace[key]
    # off the card nothing is profiled and nothing read
    ctx = _ctx([])
    assert reader.read(ctx) is None and ctx.span_trace is None


def test_tiny_traced_run_reads_the_span_metrics():
    """The tiny cell's traced run on the CPU: the two span readers read,
    the last poll inside the host's eig waits; the device readers find
    nothing."""
    r = cell_run.run(tiny.cell("lap64", "rbl32"), 2**31 + 4321, 0.3, True, "cpu",
                     time.perf_counter())
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert {"eig_last_ms", "eig_busy_ms"} <= set(m) and r["correct"] is True
    assert 0 < m["eig_last_ms"] <= m["eig_wait_ms"] + 1.0
    assert m["eig_busy_ms"] > 0
    assert not {"spmm_device_ms", "step_ops_device_ms", "launches"} & set(m)
