"""BENCHMARK.json against the contract the harness keeps, and every cell
resolved by name to its files."""

import ast
import json
import re

import pytest

from perfbench.harness import spec
from perfbench.harness.spec import BENCH, CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "rbl_tpu"}


def _bench():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def _cells():
    return [w["name"] for w in _bench()["workloads"]]


def test_top_level_keys_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells: 2 + 14·24 runs of run_seconds + 60 s, 180 s
    # of compiling a cell, 1,200 s spare, within 43,200 s
    assert 1200 + (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 <= 43200
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    b = _bench()
    seen = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/") and (CHECKOUT / c["file"]).exists()
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("name", _cells())
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    assert cell.config and cell.mix and cell.limits["numbers"]
    assert int(spec.config_of(name)["host_threads"]) >= 1
    spec.load_module("generators", cell.config["generator"])
    spec.load_module("entries", cell.mix["entry"])
    assert cell.limits.get("control"), "every cell names its control"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m, reader in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves what {name} does not report"
        assert callable(reader.read)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & BANNED
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    """The reference and the generators (each configuration's plain
    reference) import numpy, scipy, torch and the benchmark alone."""
    allowed = {"numpy", "scipy", "torch", "warnings", "pathlib", "__future__",
               "perfbench"}
    for path in [*(BENCH / "reference").glob("*.py"),
                 *(BENCH / "generators").glob("*.py")]:
        assert set(_imports(path)) <= allowed, path


def test_nothing_reads_the_old_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not re.search(r"(^|[\s/'\"])benchmarks/", node.value), path
