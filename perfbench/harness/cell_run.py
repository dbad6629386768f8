"""One run of one cell: set-up, the closed-loop window, the traced solves,
the readers, then the reference's judgement.

The window is one caller who waits for each answer: whole solves back to
back until ``seconds`` have passed since the first one started; solve i
takes the seed (seed, i) and the operators stay resident.  A solve counts
as attempted when it starts and as failed when it raises or the reference
rejects it.  The eigenvalues of every solve are judged; the eigenvectors
of a sample of solves (drawn from the seed, kept on the device while the
window runs) are judged once the window has closed, the memory peak has
been read and the program's state has been freed.  Where the cell's
limits say ``"converged": true`` (the mix's tolerance, not the Krylov
cap, ends every solve), a solve that did not converge is rejected too.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
import types

import numpy as np
import torch

from . import problem as inputs
from . import profile
from .program import Program, sync

BANNED = ("jax", "jaxlib", "flax", "rbl_tpu")
WARM = 1 << 31            # the warm-up solve's index, never a window index
SAMPLE = WARM + 1         # the index that seeds the sample of solves


def solve_seed(seed: int, i: int) -> int:
    """The seed of solve i of a run with ``seed``: a 40-bit integer, so that
    the program's derived seeds (``seed * 1_000_003 + ...``) fit 64 bits."""
    hi, lo = np.random.SeedSequence([seed % (1 << 64), i]).generate_state(2, np.uint32)
    return (int(hi) << 8) | (int(lo) & 0xFF)


def banned_modules() -> list[str]:
    """Top-level names in sys.modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class _Reservoir:
    """Keeps up to ``size`` solves, each with equal chance, from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(solve_seed(seed, SAMPLE))

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = item


def _device_block(cell, device, mem_peak, prof):
    dev = torch.device(device)
    block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
             "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    if dev.type == "cuda":
        block["power_limit"] = power_limit()
    if prof:
        block["busy_s"] = prof.get("busy_s", 0.0)
        block["window_s"] = prof.get("window_s", 0.0)
    return block


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        program_factory=Program, readings: dict | None = None) -> dict:
    """Run the cell once; returns the result object (the last line).
    ``readings``, when given, receives every number the reference worked
    out (the largest over the judged solves), compared or not."""
    dev = torch.device(device)
    limits = cell.limits
    numbers = limits.get("numbers", {})

    # -- set-up: inputs, operators, one warm solve of the cell's shapes --
    marks = [("started", time.perf_counter())]
    problem = inputs.build(cell.config)
    marks.append(("inputs built", time.perf_counter()))
    program = program_factory(problem, cell.mix, dev)
    marks.append(("program built", time.perf_counter()))
    program.solve(solve_seed(seed, WARM))
    sync(dev)
    marks.append(("warm solve done", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    _log("set-up: " + ", ".join(f"{what} at {t - t_start:.3f} s" for what, t in marks))
    for key, val in program.setup_parts.items():
        _log(f"set-up: {key} {val:.6f} s")
    _log(f"set-up: setup_s {setup_s:.6f} s")

    # -- the window ---------------------------------------------------
    sample = _Reservoir(int(limits.get("sample", 2)), seed)
    solves, answers, errors = [], [], []
    timer_cls = None
    if trace:
        from rbl_tpu_torch.utils.profiling import Timer as timer_cls
    attempted = 0
    t0 = time.perf_counter()
    t_last = t0
    while attempted == 0 or time.perf_counter() - t0 < seconds:
        attempted += 1
        timer = timer_cls(sync=False) if timer_cls else None
        ts = time.perf_counter()
        try:
            out = program.solve(solve_seed(seed, attempted - 1), timer=timer)
        except Exception:  # a solve that raises is a failed answer
            errors.append(traceback.format_exc())
            sync(dev)
            t_last = time.perf_counter()
            continue
        t_last = time.perf_counter()
        solves.append(dict(wall=t_last - ts, kryl_dim=out.kryl_dim,
                           converged=out.converged,
                           sections=dict(timer.times) if timer else None))
        answers.append(out.eigenvalues)
        sample.offer((len(answers) - 1, out.eigenvectors))
    span = t_last - t0

    # -- the traced solves (whole solves; --trace 1 only) -------------
    prof, traced_converged = {}, []
    if trace:
        per = span / max(len(solves), 1)
        with profile.profiled(dev) as prof:
            for j in range(2 if per < 1.0 else 1):
                out = program.solve(solve_seed(seed, attempted + j),
                                    timer=timer_cls(sync=False) if timer_cls else None)
                answers.append(out.eigenvalues)
                traced_converged.append(out.converged)
    mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    ctx = types.SimpleNamespace(
        cell=cell, device=dev, problem=problem, program=program, solves=solves,
        walls=[s["wall"] for s in solves], span=span, setup_s=setup_s,
        memory_peak_bytes=mem_peak, profile=prof, notes=[])
    entries = cell.per_layer if trace else [(m, None) for m in cell.end_to_end]
    metrics = {}
    for entry, reader in entries:
        if reader is None:
            from .spec import load_module

            reader = load_module("metrics", entry["name"])
        value = reader.read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    for note in ctx.notes:
        _log(note)
    capped = sum(1 for s in solves if not s["converged"])
    _log(f"window: {len(solves)} solves of {attempted} attempted in {span:.6f} s; "
         f"{capped} ended by the Krylov cap, {len(solves) - capped} by the tolerance")

    # -- the judgement, with the program's state freed ----------------
    kept = sample.kept
    sample = out = program = ctx = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from perfbench.reference.spectra import Reference

    ref = Reference(problem, cell.truth, cell.mix, dev)
    found = {name: 0.0 for name in numbers}
    seen: dict = {}
    rejected = set()

    def judge(i, vals):
        for name, val in vals.items():
            if val is None:
                continue
            val = val if np.isfinite(val) else float("inf")
            seen[name] = max(seen.get(name, 0.0), val)
            if name in found:
                found[name] = max(found[name], val)
                if not val <= numbers[name]["limit"]:
                    rejected.add(i)

    for i, w in enumerate(answers):
        judge(i, {"eig_err": ref.eig_err(w)})
    converged = [s["converged"] for s in solves] + traced_converged
    if limits.get("converged"):
        rejected.update(i for i, c in enumerate(converged) if not c)
    for i, V in kept:
        judge(i, ref.vector_numbers(answers[i], V))
    for tb in errors:
        _log(tb)
    seen["unconverged"] = float(converged.count(False))
    if readings is not None:
        readings.update(seen)
    for name in sorted(set(seen) - set(numbers)):
        _log(f"reading {name} {seen[name]!r} (not compared)")
    failed = len(errors) + len({i for i in rejected if i < len(solves)})
    correct = (bool(numbers) and attempted > 0 and failed == 0 and not rejected
               and all(found[n] <= numbers[n]["limit"] for n in numbers))
    if not numbers:
        _log("no limits file for this cell: nothing compared, not correct")
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device_block(cell, dev, mem_peak, prof if trace else None),
    }
    if trace and prof:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {name: {"value": found[name], "limit": numbers[name]["limit"]}
                        for name in numbers}
    if limits.get("converged"):
        result["checks"]["unconverged"] = {"value": converged.count(False), "limit": 0}
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
