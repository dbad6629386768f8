"""Each cell's control comes out as not correct.

The control is the program with the precision below the configuration's
switched on (``"control"`` in ``limits/<cell>.json``), run through the
harness's own ``cell_run.run`` at the cell's own size on three seeds: its
``correct`` must read false on each, and the program's own runs on the
same seeds true.  On the card only: the sizes are the cells'.
``control.py`` prints the same runs' readings for PERF.md."""

import json

import pytest
from control import judged

from perfbench.harness import spec
from perfbench.harness.spec import CHECKOUT

SEEDS = [2**31 + 7, 2**31 + 8, 2**31 + 9]


def _cells():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("name", _cells())
def test_every_cell_names_a_control(name):
    cell = spec.resolve(name)
    assert cell.limits["control"]
    for n, v in cell.limits["numbers"].items():
        if "stated" in v:   # the limit the configuration states
            assert v["lower"] < v["limit"], (name, n, v)
        else:
            assert 3 * v["lower"] <= v["upper"], (name, n, v)
            assert v["lower"] < v["limit"] < v["upper"], (name, n, v)


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells())
def test_control_fails_and_program_passes(card, name):
    cell = spec.resolve(name)
    ours = [judged(cell, s, card, {}) for s in SEEDS]
    assert all(r["correct"] for r in ours), ours
    ctl = [judged(cell, s, card, cell.limits["control"]) for s in SEEDS]
    assert not any(r["correct"] for r in ctl), ctl
