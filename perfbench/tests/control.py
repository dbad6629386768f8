"""Readings of the numbers that decide ``correct``, for the program as a
cell runs it and for the cell's control, at the cell's own size.

    python3 perfbench/tests/control.py --workload <cell> --seeds 1,2,3 \
        [--control] [--out FILE]

For each seed, one run of the cell through the harness's own
``cell_run.run`` with a window of one solve; with ``--control``, the
program built with the mix keys that the cell's limits file names under
``"control"`` (a lower precision switched on).  A run that raises reads
as not correct.  Prints one JSON line a
seed: the run's ``correct``, its checks, and every number the reference
worked out (``readings``), compared or not; last, the largest reading of
each number over the seeds.  The benchmark's own runs never run the
control; ``test_perfbench_control.py`` does, on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def factory(overrides: dict):
    """A ``Program`` factory with the mix keys ``overrides`` switched on."""
    from perfbench.harness.program import Program

    return lambda problem, mix, device: Program(problem, mix, device,
                                                overrides=overrides)


def judged(cell, seed: int, device, overrides: dict) -> dict:
    """One run of the cell with a one-solve window; the run's verdict and
    the reference's readings."""
    from perfbench.harness import cell_run

    out: dict = {}
    try:
        r = cell_run.run(cell, seed, 0.0, False, device, time.perf_counter(),
                         program_factory=factory(overrides), readings=out)
    except Exception as e:  # a run that raises prints no result: not correct
        return {"seed": seed, "correct": False, "raised": repr(e)[:300],
                "readings": out}
    return {"seed": seed, "correct": r["correct"], "failed": r["failed"],
            "checks": r["checks"], "readings": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="append the lines here too")
    args = ap.parse_args(argv)
    from perfbench.harness import spec

    cell = spec.resolve(args.workload)
    overrides = cell.limits["control"] if args.control else {}
    sink = open(args.out, "a") if args.out else None

    def log(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    top: dict = {}
    for s in (int(x) for x in args.seeds.split(",")):
        row = judged(cell, s, args.device, overrides)
        log(json.dumps({"cell": cell.name, "control": overrides, **row}))
        for k, v in row["readings"].items():
            top[k] = max(top.get(k, 0.0), v)
    log(json.dumps({"cell": cell.name, "control": overrides, "max": top}))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
