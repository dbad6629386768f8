"""CPU-sized cells for the harness's tests: a 64² grid, matrix-free and
assembled (the program's ``as_operator`` route and the reference's CSR
product), with the mixes' entries at small k, limits set for these sizes,
and the per-layer readers of the checkout's BENCHMARK.json."""

from __future__ import annotations

import json

from perfbench.harness.spec import BENCH, Cell, load_module

CONFIGS = {
    "lap64": {"generator": "laplacian_2d", "operator": "Laplacian2D",
              "nx": 64, "ny": 64, "truth": "analytic"},
    "lap64a": {"generator": "laplacian_2d", "assembled": True,
               "nx": 64, "ny": 64, "truth": "analytic"},
}
MIXES = {
    "rbl": dict(entry="rbl", k=10, b=4, which="LM", compute_dtype="float64",
                basis_dtype="float64", tol=1e-6, max_kryl_dim=800),
    "rbl32": dict(entry="rbl", k=10, b=4, which="LM", compute_dtype="float32",
                  basis_dtype="bfloat16", qr_method="cholqr2", tol=1e-3,
                  max_kryl_dim=200, eig_poll_cadence=16),
    "pol": dict(entry="rbl_polished", k=10, b=4, which="LM", bounds=[0.0, None],
                compute_dtype="float64", basis_dtype="float64",
                qr_method="cholqr2", tol=1e-7, eig_poll_cadence=16),
}
# set from these cells' readings on the CPU, seeds 1-3 (lap64a rbl: eig_err
# 1.2e-13, resid 1.1e-7, orth 1.9e-15, rq_err 2.2e-16; lap64 rbl32 at its
# cap: 4.2e-3, 8.9e-3, 6.9e-4, 3.0e-8; lap64 pol: 1.3e-15, 3.2e-14,
# 1.1e-15, 1.1e-15), with room above
LIMITS = {
    "rbl": {"eig_err": 1e-10, "resid": 1e-6, "orth": 1e-10, "rq_err": 1e-12},
    "rbl32": {"eig_err": 2e-2, "resid": 3e-2, "orth": 5e-3, "rq_err": 1e-6},
    "pol": {"eig_err": 1e-12, "resid": 1e-11, "orth": 1e-12, "rq_err": 1e-12},
}
CONVERGED = {"rbl": True, "rbl32": False, "pol": True}


def cell(config: str, mix: str) -> Cell:
    with open(BENCH.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    return Cell(
        name=f"{config}.{mix}", chips=1, config=CONFIGS[config], mix=MIXES[mix],
        limits={"sample": 2, "converged": CONVERGED[mix],
                "numbers": {k: {"limit": v} for k, v in LIMITS[mix].items()}},
        end_to_end=bench["end_to_end"],
        per_layer=[(m, load_module("metrics", m["name"])) for m in bench["per_layer"]])
