"""Resolve a cell of ``BENCHMARK.json`` to its files, by name alone.

A cell names a configuration and a traffic mix.  The configuration is
``configs/<config>.json`` (its ``"generator"`` is ``generators/<name>.py``),
the mix ``traffic/<traffic>.json`` (its ``"entry"`` is
``entries/<name>.py``), the limits of its ``correct`` check
``limits/<cell>.json``, and each metric a reader ``metrics/<metric>.py``
with a function ``read(ctx)``.  Nothing here names a cell, a
configuration, a generator, an entry or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]      # perfbench/
CHECKOUT = BENCH.parent

# what each kind of module found by name has to define
NEEDS = {"metrics": ("read",), "generators": ("build",),
         "entries": ("KEYS", "solve")}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list       # (entry, reader module) pairs

    @property
    def truth(self):
        return self.config.get("truth")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH):
    """The module ``<kind>/<name>.py`` under ``root``, checked for what its
    kind has to define."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} module {name!r} ({path} is missing)")
    mod_name = f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [a for a in NEEDS[kind] if not hasattr(mod, a)]
    if missing:
        raise ValueError(f"{path} does not define {missing}")
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _workload(name: str, bench: dict) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    return cells[name]


def config_of(name: str, root: Path = BENCH) -> dict:
    """The configuration file of the cell ``name``: JSON alone, so that a
    run can read its host settings before numpy or torch is imported."""
    bench = _load_json(root.parent / "BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    return _load_json(root.parent / configs[_workload(name, bench)["config"]]["file"])


def resolve(name: str, bench: dict | None = None, root: Path = BENCH) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    BENCHMARK.json) with its configuration, mix, limits and readers."""
    if bench is None:
        bench = _load_json(root.parent / "BENCHMARK.json")
    w = _workload(name, bench)
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root.parent / configs[w["config"]]["file"])
    mix = _load_json(root / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "limits" / f"{name}.json"
    limits = _load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per = [(m, load_module("metrics", m["name"], root)) for m in bench["per_layer"]
           if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits, end_to_end=e2e, per_layer=per)
