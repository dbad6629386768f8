"""The loop, the readers and the last line on CPU-sized cells; the card
check of run.py; the import check; and, on the card, each cell of
BENCHMARK.json run once, briefly, through run.py."""

import json
import os
import subprocess
import sys
import time

import pytest
import tiny

from perfbench.harness import cell_run
from perfbench.harness.spec import CHECKOUT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("config,mix", [("lap64a", "rbl"), ("lap64", "rbl32"),
                                        ("lap64", "pol")])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_prints_its_line(config, mix, trace):
    cell = tiny.cell(config, mix)
    readings = {}
    r = cell_run.run(cell, 2**31 + 12345, 0.5, trace, "cpu", time.perf_counter(),
                     readings=readings)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True, (r, readings)
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = set(r["metrics"])
    if trace:
        # device metrics are never read from a CPU run
        assert "device_idle" not in names and "spmm_roofline" not in names
        assert {"kryl_cols", "eig_wait_ms"} <= names and "breakdown" in r
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    else:
        assert {"setup_s", "solve_s", "solve_p95_s"} <= names
        assert "peak_mem_gib" not in names
    assert set(r["checks"]) == set(tiny.LIMITS[mix]) | (
        {"unconverged"} if tiny.CONVERGED[mix] else set())
    assert json.loads(json.dumps(r)) == r


def test_same_seed_same_solves():
    cell = tiny.cell("lap64", "rbl32")
    a, b = {}, {}
    cell_run.run(cell, 7, 0.0, False, "cpu", time.perf_counter(), readings=a)
    cell_run.run(cell, 7, 0.0, False, "cpu", time.perf_counter(), readings=b)
    assert a == b


def test_run_py_refuses_without_a_card():
    """No card here: run.py prints no result and exits non-zero; the look
    for the card happens when it runs, not when anything is imported."""
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        _cells()[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=CHECKOUT, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_a_run_loads_no_jax():
    """After a cell's imports and a whole tiny run, no module whose whole
    top-level name is jax, jaxlib, flax or rbl_tpu is loaded (rbl_tpu_torch
    is not rbl_tpu)."""
    code = (
        "import sys, time; sys.path[:0] = ['perfbench/tests', '.']\n"
        "import tiny\n"
        "from perfbench.harness import cell_run\n"
        "cell_run.run(tiny.cell('lap64a', 'rbl'), 3, 0.0, True, 'cpu', time.perf_counter())\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'rbl_tpu_torch' in tops\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'rbl_tpu'}))\n"
        "print(cell_run.banned_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rbl_tpu_torch_fake", object())
    assert cell_run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert cell_run.banned_modules() == ["jaxlib"]


def _cells():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", _cells())
@pytest.mark.parametrize("trace", ["0", "1"])
def test_each_cell_on_the_card(card, name, trace):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name,
                        "--seed", str(2**31 + 99), "--seconds", "2",
                        "--trace", trace], cwd=CHECKOUT, capture_output=True,
                       text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, (r, p.stderr[-3000:])
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_every_rblconfig_key_of_a_mix_reaches_the_solver():
    """A mix key that is an RBLConfig field is passed on whatever it is;
    a key that is neither shared, the entry's own nor such a field is an
    error, never silently dropped."""
    from perfbench.harness import problem
    from perfbench.harness.program import Program

    prob = problem.build(tiny.CONFIGS["lap64"])
    mix = dict(tiny.MIXES["rbl"], partial_reorth_cadence=3, eig_backend="device",
               basis_device_cap_cols=64, loc_reorth_passes=1)
    cfg = Program(prob, mix, "cpu").cfg
    assert (cfg.partial_reorth_cadence, cfg.eig_backend, cfg.basis_device_cap_cols,
            cfg.loc_reorth_passes, cfg.block_size) == (3, "device", 64, 1, 4)
    for bad in ({"sigma": 0.0}, {"seed": 1}, {"bounds": [0.0, None]}):
        with pytest.raises(ValueError, match="mix keys"):
            Program(prob, {**tiny.MIXES["rbl"], **bad}, "cpu")


def test_a_frozen_truth_file_is_read(tmp_path):
    """``"truth": {"file": ...}`` reads the wanted eigenvalues from a file:
    the analytic spectrum written out gives the same judgement."""
    import numpy as np

    from perfbench.harness import problem
    from perfbench.reference.spectra import Reference

    prob = problem.build(tiny.CONFIGS["lap64"])
    path = tmp_path / "lap64.npz"
    np.savez(path, eigenvalues=prob.generator.spectrum(prob)[::-1])
    mix = tiny.MIXES["rbl"]
    a, b = Reference(prob, "analytic", mix, "cpu"), Reference(prob, {"file": str(path)},
                                                              mix, "cpu")
    assert np.array_equal(a.truth, b.truth) and a.truth.size == mix["k"]
