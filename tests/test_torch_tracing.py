"""The port's Timer spans on the CPU (``utils.profiling``): sections nest
and ``report`` sums self times; the stamps sit on the clock
``torch.profiler`` stamps its CPU events with; the eig worker's spans are
recorded as concurrent with their own stamps; ``eig_last`` encloses the
sweep's final wait; the step spans ("spmm", "project", "qr") of small
``rbl`` and ``rbl_polished`` solves; and a solve with no timer adds no span
and wraps nothing.  The tracing has no counterpart in the JAX package, so
nothing here is held against it.
"""

import statistics
import threading

import numpy as np
import pytest
import torch

import rbl_tpu_torch as rtt
from _torch_parity import CPU
from rbl_tpu_torch.ops.chebyshev import ChebyshevProductFilter
from rbl_tpu_torch.solver.lanczos import _poll_task
from rbl_tpu_torch.solver.polish import rbl_polished
from rbl_tpu_torch.utils.profiling import Timer, clock_ns, null_timer, timed_spmm
from rbl_tpu_torch.utils.suitesparse import laplacian_2d

STEP_SPANS = ("spmm", "project", "qr")
RTOL = {"rbl": 1e-2, "rbl_polished": 1e-9}  # the capped f32 sweep; the f64 polish


def _rbl(timer=None):
    """A 24² Laplacian, k 6, b 4, f32 with a bf16 basis, stopped at a cap
    of 120 columns: every poll of the sweep, the serial last one too."""
    op = rtt.Laplacian2D(24, 24, dtype=torch.float32, device=CPU)
    cfg = rtt.RBLConfig(block_size=4, compute_dtype=torch.float32,
                        basis_dtype=torch.bfloat16, qr_method="cholqr2", tol=1e-6,
                        max_kryl_dim=120, eig_poll_cadence=4, device=CPU, seed=5)
    return rtt.rbl(op, 6, cfg=cfg, timer=timer)


def _polished(timer=None):
    op = rtt.Laplacian2D(24, 24, dtype=torch.float64, device=CPU)
    cfg = rtt.RBLConfig(tol=1e-7, qr_method="cholqr2", eig_poll_cadence=8,
                        device=CPU, seed=2)
    return rbl_polished(op, 6, cfg=cfg, b=4, bounds=(0.0, None), timer=timer)


SOLVES = {"rbl": _rbl, "rbl_polished": _polished}


@pytest.fixture(scope="module")
def solved():
    """Each solve once with a Timer: {name: (result, timer)}."""
    out = {}
    for name, solve in SOLVES.items():
        timer = Timer()
        out[name] = (solve(timer), timer)
    return out


def _dur(sp):
    return (sp.end_ns - sp.start_ns) / 1e9


@pytest.mark.parametrize("sync", [False, True])
def test_sections_nest_and_report_sums_self_times(sync):
    timer = Timer(sync=sync)
    with timer.section("outer"):
        with timer.section("inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with timer.section("inner"):
            pass
    outer, inner1, inner2 = timer.spans
    assert [sp.name for sp in timer.spans] == ["outer", "inner", "inner"]
    assert outer.parent is None and inner1.parent == inner2.parent == 0
    assert outer.start_ns <= inner1.start_ns <= inner1.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns
    assert timer.counts == {"outer": 1, "inner": 2}
    assert timer.times["outer"] == pytest.approx(_dur(outer))
    assert timer.times["inner"] == pytest.approx(_dur(inner1) + _dur(inner2))
    own = timer.self_times()
    assert own["outer"] == pytest.approx(_dur(outer) - _dur(inner1) - _dur(inner2))
    assert own["inner"] == pytest.approx(timer.times["inner"])
    total = float(timer.report().splitlines()[-1].split()[-1])
    assert total == pytest.approx(timer.times["outer"], abs=1e-4)  # counted once


def test_a_section_left_by_an_exception_closes_its_span():
    timer = Timer()
    with pytest.raises(ValueError):
        with timer.section("outer"):
            with timer.section("failing"):
                raise ValueError("x")
    with timer.section("after"):
        pass
    assert [sp.name for sp in timer.spans] == ["outer", "failing", "after"]
    assert timer.spans[2].parent is None and timer.counts["failing"] == 1


def test_stamps_sit_on_the_record_function_clock():
    """Each section's stamps against its own ``record_function`` event in
    a CPU profile (the first section, which pays the range's first-call
    cost, left out): the same clock, to well under a millisecond."""
    from torch.profiler import ProfilerActivity, profile

    timer = Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(21):
            with timer.section(f"probe_{i}"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe_")}
    gaps = []
    for sp in timer.spans[1:]:
        e = events[sp.name]
        gaps += [abs(e.start_ns() - sp.start_ns),
                 abs(e.start_ns() + e.duration_ns() - sp.end_ns)]
    assert statistics.median(gaps) < 50_000 and max(gaps) < 5_000_000


def test_record_keeps_a_worker_span_with_its_stamps_and_parent():
    timer = Timer()
    stamps = []

    def work():
        t0 = clock_ns()
        np.linalg.eigh(np.eye(50))
        stamps.append((t0, clock_ns(), threading.current_thread().name))

    worker = threading.Thread(target=work, name="rbl-eig_0")
    with timer.section("eig_wait"):
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        timer.record("eig_poll", *stamps[0])
    poll = timer.spans[1]
    assert (poll.name, poll.start_ns, poll.end_ns) == ("eig_poll",) + stamps[0][:2]
    assert poll.thread == "rbl-eig_0" and poll.parent == 0
    assert timer.concurrent == {"eig_poll"} and timer.counts["eig_poll"] == 1
    assert timer.times["eig_poll"] == pytest.approx(_dur(poll))
    # concurrent work is nobody's child: the wait keeps its whole time
    assert timer.self_times()["eig_wait"] == pytest.approx(timer.times["eig_wait"])
    assert "(concurrent)" in next(ln for ln in timer.report().splitlines()
                                  if ln.startswith("eig_poll"))


@pytest.mark.parametrize("force_full,expected", [(True, ["eig_poll"]),
                                                 (False, ["eig_screen", "eig_poll"])])
def test_poll_task_stamps_its_screen_and_factorization(force_full, expected):
    """A forced poll factorizes without a screen; an unforced one whose
    screen repeats the previous poll's screens first, then factorizes."""
    rng = np.random.default_rng(3)
    band = rng.standard_normal((5, 40))
    band[0] += 10.0
    chain = {}
    _poll_task(band, 4, "scipy", None, chain, 1e-8, True)  # seeds the chain
    spans = []
    t0 = clock_ns()
    _, _, full, secs = _poll_task(band, 4, "scipy", None, chain, 1e-8, force_full,
                                  spans)
    assert [s[0] for s in spans] == expected and full is not None
    assert all(t0 <= s[1] <= s[2] <= clock_ns() for s in spans)
    assert spans[-1][2] - spans[-1][1] == pytest.approx(secs * 1e9)
    assert {s[3] for s in spans} == {threading.current_thread().name}


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_timer_totals_equal_the_sum_of_the_spans(solved, solve):
    _, timer = solved[solve]
    assert None not in timer.spans
    for name, t in timer.times.items():
        mine = [sp for sp in timer.spans if sp.name == name]
        assert len(mine) == timer.counts[name]
        assert t == pytest.approx(sum(_dur(sp) for sp in mine), abs=1e-9)


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_main_thread_spans_nest_inside_their_parents(solved, solve):
    _, timer = solved[solve]
    for i, sp in enumerate(timer.spans):
        if sp.parent is None or sp.name in timer.concurrent:
            continue
        up = timer.spans[sp.parent]
        assert sp.parent < i and up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
        assert sp.thread == up.thread == threading.current_thread().name


def test_eig_last_encloses_the_final_wait(solved):
    """The sweep the cap ends: one ``eig_last``, after every chunk, holding
    the sweep's last ``eig_wait``; ``times["eig_wait"]`` still sums every
    wait, the pipelined ones too, and the worker's spans recorded at the
    last harvest are the children of ``eig_last``."""
    res, timer = solved["rbl"]
    assert not res.converged and res.kryl_dim == 120
    spans = timer.spans
    last = [i for i, sp in enumerate(spans) if sp.name == "eig_last"]
    waits = [sp for sp in spans if sp.name == "eig_wait"]
    assert len(last) == timer.counts["eig_last"] == 1 and len(waits) > 1
    final = max(waits, key=lambda sp: sp.start_ns)
    assert final.parent == last[0]
    assert all(sp.end_ns <= spans[last[0]].start_ns
               for sp in spans if sp.name == "chunk_scan")
    assert timer.times["eig_wait"] == pytest.approx(sum(_dur(w) for w in waits))
    worker = [sp for sp in spans if sp.parent == last[0] and sp.name in timer.concurrent]
    assert worker and {sp.name for sp in worker} <= {"eig_screen", "eig_poll"}
    assert {sp.thread for sp in worker} == {"rbl-eig_0"}


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_every_wait_on_a_poll_is_in_a_chunk_or_the_last_poll(solved, solve):
    """Each ``eig_wait`` sits in a chunk's host turn (``chunk_scan``) or in
    ``eig_last``: in the polish's coarse sweep, which its tolerance ends
    inside a chunk, the last poll's wait is a chunk's."""
    _, timer = solved[solve]
    homes = [timer.spans[sp.parent].name for sp in timer.spans if sp.name == "eig_wait"]
    assert homes and set(homes) <= {"chunk_scan", "eig_last"}
    assert timer.counts["eig_last"] == 1


@pytest.mark.parametrize("solve", sorted(SOLVES))
@pytest.mark.parametrize("name", STEP_SPANS)
def test_step_spans_of_small_solves(solved, solve, name):
    """Every step span is inside the sweep's dispatch (or first step), the
    Ritz recovery, or the polish's Rayleigh-Ritz and filter passes, and
    the solve's answer is right."""
    res, timer = solved[solve]
    assert timer.counts[name] >= 2
    homes = {"sweep_dispatch", "recurrence", "ritz", "solve_setup", "polish_rr",
             "polish_filter"}
    for sp in timer.spans:
        if sp.name == name:
            assert timer.spans[sp.parent].name in homes
    exact = np.linalg.eigvalsh(laplacian_2d(24, 24).toarray())
    np.testing.assert_allclose(np.sort(res.eigenvalues), exact[-6:], rtol=RTOL[solve])


def test_a_solve_without_a_timer_adds_no_span_and_wraps_nothing():
    """No timer: no range of the Timer's in a profile of the solve, the
    filter applies its operator's own ``apply``, and the null timer's
    sections are one shared context."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _rbl()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"spmm", "project", "qr", "sweep_dispatch", "eig_last",
                        "chunk_scan", "solve_setup", "ritz"}
    op = rtt.Laplacian2D(8, 8, device=CPU)
    assert timed_spmm(op.apply, None) == op.apply
    assert timed_spmm(op.apply, null_timer()) == op.apply
    calls = []

    class Counting:
        n, dtype, device = 64, torch.float64, torch.device(CPU)

        def apply(self, X):
            calls.append(X.shape)
            return op.apply(X)

    f = ChebyshevProductFilter.make(Counting(), 0.0, 4.0, degree=3)
    f.apply(torch.ones(64, 2, dtype=torch.float64))
    assert calls == [(64, 2)] * 3 and f.timer is None
    assert null_timer().section("a") is null_timer().section("b")
