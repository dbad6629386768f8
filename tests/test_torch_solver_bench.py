"""The port's solver scripts (rbl_tpu_torch/benchmarks/{solver_bench,
blocksize_bench,coarse_ab_bench,aot_coldstart_bench}.py) against the JAX
package's benchmarks/, on the CPU, and every port script's device rule.

Configuration parity: both packages' ``main`` run with their solver entry
point replaced by a recorder, so that each solve's (k, b, RBLConfig
fields, polish arguments) is compared without solving.  Then real solves:
solver_bench's λmax against the JAX script's at a tiny f64 Laplacian, its
--matrix and --arpack legs against scipy, and the other three at a small
grid against the analytic spectrum, each with the JAX script's JSON keys
(aot_coldstart_bench without ``aot_cache_state`` and ``blobs_before``).
"""

import contextlib
import importlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse.linalg as spla
import torch

import _torch_parity as P
from rbl_tpu_torch.benchmarks import aot_coldstart_bench as taot
from rbl_tpu_torch.benchmarks import blocksize_bench as tbs
from rbl_tpu_torch.benchmarks import coarse_ab_bench as tcab
from rbl_tpu_torch.benchmarks import solver_bench as tsolv

BENCHES = ["spmm_bench", "bsr_tile_sweep", "bsr_lane_bench", "solver_bench",
           "blocksize_bench", "coarse_ab_bench", "aot_coldstart_bench",
           "scaling_bench"]
CFG_FIELDS = ("block_size", "tol", "max_kryl_dim", "qr_method",
              "eig_poll_cadence", "adaptive_reorth_max", "seed",
              "basis_dtype", "compute_dtype")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _jax(name):
    """The JAX script, imported without keeping the RBL_AOT_CACHE its
    import sets for the rest of this process."""
    had = os.environ.get("RBL_AOT_CACHE")
    try:
        return P.jax_bench(name)
    finally:
        if had is None:
            os.environ.pop("RBL_AOT_CACHE", None)
        else:
            os.environ["RBL_AOT_CACHE"] = had


def _dtype_name(d):
    if d is None:
        return None
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else np.dtype(d).name


def _cfg(cfg):
    return {f: (_dtype_name(getattr(cfg, f)) if f.endswith("dtype")
                else getattr(cfg, f)) for f in CFG_FIELDS}


class _Res:
    """A solve's result, without solving."""

    def __init__(self, k):
        self.eigenvalues = np.linspace(8.0, 7.0, k)
        self.eigenvectors = np.zeros((1, 1))
        self.residual_bounds = np.zeros(k)
        self.kryl_dim, self.converged, self.iterations = 0, True, 1


def _record_solves(mp, module, attr, log):
    def solve(A, k, *args, cfg=None, **kw):
        log.append((k, args, None if cfg is None else _cfg(cfg),
                    {key: v for key, v in kw.items()
                     if key in ("b", "bounds", "coarse_tol", "buffer")}))
        return _Res(k)

    mp.setattr(module, attr, solve)


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.mark.parametrize("f64", [False, True])
def test_solver_bench_solves_as_the_jax_script(f64, monkeypatch):
    """The warm-up (k = b = 2), then for each b ∈ {1, 2, 4, 8} an untimed
    solve and one from seed b + 1, with the JAX script's configuration."""
    import rbl_tpu
    import rbl_tpu_torch

    flags = ["--f64"] if f64 else []
    jlog, tlog = [], []
    _record_solves(monkeypatch, rbl_tpu, "rbl", jlog)
    monkeypatch.setattr(sys, "argv", ["solver_bench.py", *flags])
    _quiet(_jax("solver_bench").main)
    _record_solves(monkeypatch, rbl_tpu_torch, "rbl", tlog)
    _quiet(tsolv.main, [*flags, "--device", "cpu"])
    assert len(jlog) == len(tlog) == 9
    assert jlog[0][:2] == tlog[0][:2] == (2, (2,))
    assert jlog[1:] == tlog[1:]
    assert [e[2]["seed"] for e in tlog[2::2]] == [2, 3, 5, 9]


def test_solver_bench_lambda_max_matches_jax(monkeypatch):
    """One real solve in each package: the 12² Laplacian in f64, k = 4,
    b = 4; λmax printed by the JAX script (6 digits) against the port's,
    both within the solve's tol of the analytic top value."""
    monkeypatch.setattr(sys, "argv", ["solver_bench.py", "--laplacian", "12",
                                      "--k", "4", "--blocks", "4", "--f64"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax("solver_bench").main()
    lam_j = float(re.search(r"λmax=(\S+)", buf.getvalue()).group(1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results, line = tsolv.main(["--laplacian", "12", "--k", "4", "--blocks",
                                    "4", "--f64", "--device", "cpu"])
    lam_t = float(results[0][2].eigenvalues[0])
    assert abs(lam_t - lam_j) <= 1e-6 * lam_j
    top = tbs.laplacian_spectrum(12, 1)[0]
    assert abs(lam_t - top) <= 1e-3 * top
    assert json.loads(buf.getvalue().splitlines()[-1]) == line
    assert {frozenset(line)} == P.json_key_sets(f"{P.ROOT}/benchmarks/solver_bench.py")
    assert line["metric"] == "time_to_4_eigenpairs_laplacian2d-12x12"


def test_solver_bench_matrix_and_arpack_legs(tmp_path):
    """--matrix through load_matrix and as_operator, and --arpack: the
    port's eigenvalues against scipy's eigsh on a random sparse matrix
    (no repeated eigenvalue), and the ARPACK line printed."""
    A = P.random_sym(300, 0.03, seed=4)
    path = str(tmp_path / "a.mtx")
    scipy.io.mmwrite(path, A, symmetry="symmetric")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results, line = tsolv.main(["--matrix", path, "--k", "6", "--blocks", "2",
                                    "--tol", "1e-8", "--f64", "--arpack",
                                    "--device", "cpu"])
    w = spla.eigsh(A, k=6, which="LM", return_eigenvectors=False)
    w = w[np.argsort(-np.abs(w))]
    assert P.rel_err(results[0][2].eigenvalues, w) < 1e-7
    out = buf.getvalue()
    assert "[ARPACK]" in out and "max rel diff vs RBL" in out
    assert line["metric"] == f"time_to_6_eigenpairs_{path}"


def test_blocksize_bench_solves_as_the_jax_script(monkeypatch):
    import rbl_tpu
    import rbl_tpu_torch

    jlog, tlog = [], []
    _record_solves(monkeypatch, rbl_tpu, "rbl", jlog)
    monkeypatch.setattr(sys, "argv", ["blocksize_bench.py"])
    _quiet(_jax("blocksize_bench").main)
    _record_solves(monkeypatch, rbl_tpu_torch, "rbl", tlog)
    _quiet(tbs.main, ["--device", "cpu"])
    assert len(jlog) == 12 and jlog == tlog
    assert [e[2]["max_kryl_dim"] for e in tlog[::3]] == [768, 768, 768, 768]


def test_blocksize_bench_on_a_small_grid():
    """b = 8 on the 32² grid: within bench.py's 0.025 of the analytic
    spectrum, with the JAX script's JSON keys."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = tbs.main(["8", "--nx", "32", "--device", "cpu"])
    assert [json.loads(s) for s in buf.getvalue().splitlines()] == lines
    (line,) = lines
    assert line["metric"] == "lap2d_512_k50_b8" and line["max_rel_err"] < 0.025
    assert {frozenset(line)} == P.json_key_sets(f"{P.ROOT}/benchmarks/blocksize_bench.py")


@pytest.mark.parametrize("name", ["coarse_ab_bench", "aot_coldstart_bench"])
def test_polish_benches_solve_as_the_jax_scripts(name, monkeypatch, tmp_path):
    """Each rbl_polished call: k = 50, b = 8, bounds (0, None), the legs'
    coarse_tol and buffer, and the configuration (seeds 0 then 3 for the
    A/B; RBL_SEED for the one-shot)."""
    import rbl_tpu.solver.polish as jpol
    import rbl_tpu_torch.solver.polish as tpol

    monkeypatch.setenv("RBL_AOT_CACHE", str(tmp_path))
    monkeypatch.setenv("RBL_SEED", "5")
    jlog, tlog = [], []
    _record_solves(monkeypatch, jpol, "rbl_polished", jlog)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    _quiet(_jax(name).main)
    _record_solves(monkeypatch, tpol, "rbl_polished", tlog)
    _quiet(importlib.import_module(f"rbl_tpu_torch.benchmarks.{name}").main,
           ["--device", "cpu"])
    assert len(jlog) == (6 if name == "coarse_ab_bench" else 1)
    assert jlog == tlog
    seeds = [e[2]["seed"] for e in tlog]
    assert seeds == ([0, 0, 0, 3, 3, 3] if name == "coarse_ab_bench" else [5])


@pytest.fixture(scope="module")
def polish_runs():
    """coarse_ab_bench and aot_coldstart_bench on the 32² grid."""
    out = {}
    for name, mod in (("coarse_ab_bench", tcab), ("aot_coldstart_bench", taot)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = mod.main(["--nx", "32", "--device", "cpu"])
        out[name] = (got if isinstance(got, list) else [got], buf.getvalue())
    return out


@pytest.mark.parametrize("name", ["coarse_ab_bench", "aot_coldstart_bench"])
def test_polish_benches_on_a_small_grid(name, polish_runs):
    """Every leg converged, all 50 pairs locked at 1e-7, within 1e-7 of the
    analytic spectrum; the printed lines are the returned ones, with the
    JAX script's keys (the one-shot without the executable cache's two)."""
    lines, text = polish_runs[name]
    assert [json.loads(s) for s in text.splitlines()] == lines
    for line in lines:
        assert line["converged"] and line["locked"] == 50
        assert line["max_rel_err"] < 1e-7
    want = P.json_key_sets(f"{P.ROOT}/benchmarks/{name}.py")
    if name == "aot_coldstart_bench":
        want = {k - {"aot_cache_state", "blobs_before"} for k in want}
    assert {frozenset(ln) for ln in lines} == want


@pytest.mark.parametrize("name", BENCHES)
def test_bench_without_a_card_raises(name, monkeypatch):
    """Without --device every script runs on the card, and raises without
    one before any work."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mod = importlib.import_module(f"rbl_tpu_torch.benchmarks.{name}")
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: pytest.fail("drew data without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_benches_import_neither_jax_nor_rbl_tpu():
    import subprocess

    code = ("import sys\n"
            + "".join(f"import rbl_tpu_torch.benchmarks.{n}\n" for n in BENCHES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'rbl_tpu', 'benchmarks')]\n"
              "print('imported:', bad)\n"
              "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=P.ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
