"""The port's benchmark script (bench_torch.py) and its reference-shaped
loop (rbl_tpu_torch/benchmarks/baseline_loop.py) against the JAX
package's (bench.py, benchmarks/baseline_loop.py), on the CPU at a small
size: each numeric phase of the loop on the same numpy arrays, the loop's
solve against the analytic spectrum in both packages, and bench_torch's
JSON line (bench.py's keys but ``aot_cache_state``, plus
``baseline_measured_s``), hooks and device rule.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 — caps torch's threads
from rbl_tpu_torch.benchmarks import baseline_loop as tbl
from rbl_tpu_torch.ops.spmm.operator import Laplacian2D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

CPU = "cpu"
NX, NY, B = 12, 10, 4


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread: OpenBLAS's spinning threads slow this file's many
    small host factorizations ~10x when the tier-1 workers share the
    cores."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _jax_loop():
    spec = importlib.util.spec_from_file_location(
        "_jax_baseline_loop", os.path.join(ROOT, "benchmarks", "baseline_loop.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbl():
    return _jax_loop()


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    Qold = np.linalg.qr(rng.standard_normal((n, B)))[0]
    Qi = rng.standard_normal((n, B))
    Qprev = np.linalg.qr(rng.standard_normal((n, B)))[0]
    Bi = np.triu(rng.standard_normal((B, B))) + 3.0 * np.eye(B)
    return Qold, Qi, Qprev, Bi


def _agree(t, j):
    t = np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= 1e-12 * max(np.max(np.abs(j)), 1.0)


@pytest.mark.parametrize("phase", ["_project_pair", "_loc_reorth", "_three_term"])
def test_loop_phase_matches_jax(phase, jbl):
    """Each numeric phase of the loop, on the same f64 arrays and a small
    Laplacian2D in both packages, agrees at f64 rounding."""
    import jax.numpy as jnp

    import rbl_tpu as rt

    Qold, Qi, Qprev, Bi = _blocks(NX * NY, seed=len(phase))
    T = lambda a: torch.from_numpy(a)
    J = jnp.asarray
    if phase == "_project_pair":
        got = tbl._project_pair(T(Qold), T(Qi), T(Qprev))
        ref = jbl._project_pair(J(Qold), J(Qi), J(Qprev))
    elif phase == "_loc_reorth":
        got = (tbl._loc_reorth(T(Qi), T(Qprev), "cholqr2"),)
        ref = (jbl._loc_reorth(J(Qi), J(Qprev), "cholqr2"),)
    else:
        top = Laplacian2D(NX, NY, dtype=torch.float64, device=CPU)
        jop = rt.Laplacian2D(nx=NX, ny=NY, _dtype=jnp.float64)
        got = tbl._three_term(top, T(Qi), T(Qprev), T(Bi), "cholqr2")
        ref = jbl._three_term(jop, J(Qi), J(Qprev), J(Bi), "cholqr2")
    for g, r in zip(got, ref):
        _agree(g, r)


def test_reference_shaped_solve_matches_jax(jbl):
    """The loop on a 24² Laplacian (k = 5, b = 4, f64, tol 1e-3) in both
    packages: eigenvalues within the solve's tol-limited error (tol ·
    max|θ|) of the analytic spectrum, iteration counts within one poll."""
    import jax.numpy as jnp

    import rbl_tpu as rt

    nx, k, tol = 24, 5, 1e-3
    lam = bench_torch.laplacian_spectrum(nx, k)
    w_t, it_t = tbl.reference_shaped_solve(
        Laplacian2D(nx, nx, dtype=torch.float64, device=CPU), k, B, tol=tol)
    w_j, it_j = jbl.reference_shaped_solve(
        rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float64), k, B, tol=tol)
    for w in (w_t, np.asarray(w_j)):
        assert w.shape == (k,)
        assert np.max(np.abs(w - lam)) <= tol * np.max(np.abs(w))
    assert abs(it_t - it_j) <= 4
    assert it_t * B < nx * nx  # converged, not exhausted


def _bench_py_keys():
    """The keys bench.py's main can print, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "out"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def _main(monkeypatch, env=None, nx=32):
    """bench_torch.main on an nx² grid on the CPU; returns (its dict, the
    baseline's eigenvalues, the lines it printed)."""
    for name in ("RBL_BENCH_B", "RBL_BENCH_BASIS", "RBL_BENCH_PRECISION",
                 "RBL_BENCH_ADAPTIVE", "RBL_BENCH_FILTERED",
                 "RBL_BENCH_F32ROW", "RBL_BENCH_REF_TOL"):
        monkeypatch.delenv(name, raising=False)
    for name, value in (env or {}).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(bench_torch, "NX", nx)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, w = bench_torch.main(["--device", CPU])
    return out, w, buf.getvalue().splitlines()


def test_bench_main_line(monkeypatch):
    """One JSON line, last, with bench.py's keys (the error keys aside)
    but aot_cache_state, plus baseline_measured_s; the headline within
    bench.py's 0.025 and the loop's eigenvalues within it too."""
    out, w, lines = _main(monkeypatch)
    assert len(lines) == 1 and json.loads(lines[-1]) == out
    want = {k for k in _bench_py_keys() if not k.endswith("_error")}
    assert "aot_cache_state" in want and "baseline_measured_s" in want
    assert set(out) == (want - {"aot_cache_state"})
    assert out["metric"] == "time_to_k_eigenpairs_lap2d_32_k50_b16"
    assert out["max_rel_err"] < 0.025 and out["basis"] == "bf16"
    assert out["baseline_measured_s"] > 0 and out["vs_baseline"] > 0
    assert out["ref_tol_converged"] and out["ref_tol_locked"] == 50
    assert out["f32_floor_converged"] and not out["f32_floor_cap_hit"]
    lam = bench_torch.laplacian_spectrum(32, 50)
    assert np.max(np.abs(w - lam) / lam) < 0.025


def test_bench_b_parsed_once_and_rows_dropped(monkeypatch):
    """RBL_BENCH_B=08 is block size 8 (the metric's name and the loop's
    b); RBL_BENCH_F32ROW=0 and RBL_BENCH_REF_TOL=0 drop their rows."""
    seen = []
    real = bench_torch.measure_baseline
    monkeypatch.setattr(bench_torch, "measure_baseline",
                        lambda b, d: seen.append(b) or real(b, d))
    out, _, _ = _main(monkeypatch, {"RBL_BENCH_B": "08", "RBL_BENCH_F32ROW": "0",
                                    "RBL_BENCH_REF_TOL": "0"})
    assert out["metric"].endswith("_b8") and seen == [8]
    assert not [k for k in out if k.startswith(("f32_floor", "at_ref_tol", "ref_tol"))]
    assert out["max_rel_err"] < 0.025


def test_bench_filtered_hook(monkeypatch):
    """RBL_BENCH_FILTERED=1 takes the headline through rbl_filtered.  On
    a 48² grid: on 32² the filtered sweep's bf16 basis reaches 704 of the
    1,024 dimensions and its T turns non-finite (iterations 29-44), in
    the JAX package's rbl_filtered as in the port's."""
    import rbl_tpu_torch.solver.filtered as fmod

    calls = []
    real = fmod.rbl_filtered
    monkeypatch.setattr(fmod, "rbl_filtered",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    out, _, _ = _main(monkeypatch, {"RBL_BENCH_FILTERED": "1",
                                    "RBL_BENCH_F32ROW": "0",
                                    "RBL_BENCH_REF_TOL": "0"}, nx=48)
    assert len(calls) == 4 and all(kw["which"] == "LA" for kw in calls)
    assert out["max_rel_err"] < 0.025


def test_bench_without_a_card_raises(monkeypatch):
    """Without --device it runs on the card; with none it raises before
    any work."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(bench_torch, "measure_baseline",
                        lambda *a: pytest.fail("worked without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


def test_bench_and_new_modules_import_neither_jax_nor_rbl_tpu():
    code = (
        "import sys\n"
        "import bench_torch\n"
        "import rbl_tpu_torch.utils.probe\n"
        "from rbl_tpu_torch.benchmarks import baseline_loop\n"
        "bench_torch.NX = 16\n"
        "bench_torch.main(['--device', 'cpu'])\n"
        "baseline_loop.main(['--nx', '16', '--k', '5', '--b', '4', '--trials', '1',"
        " '--device', 'cpu'])\n"
        "bad = [m for m in ('jax', 'rbl_tpu') if m in sys.modules]\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               OPENBLAS_NUM_THREADS="1")
    for name in ("RBL_BENCH_F32ROW", "RBL_BENCH_REF_TOL", "RBL_BENCH_FILTERED"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "imported: []" in proc.stdout
    assert '"baseline_measured_s"' in proc.stdout
    assert "reference-shaped loop: best" in proc.stdout
