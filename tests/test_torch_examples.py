"""The port's examples (examples/torch_{benchmark,images,generalized}.py)
against the JAX package's (examples/{benchmark,images,generalized}.py) on
the CPU, at small sizes.

Each JAX example runs in-process with ``sys.argv`` patched; its printed
lines are parsed, and its solver calls are recorded through a wrapper on
the ``rbl_tpu`` entry point it calls, for the full-precision values that
the printed lines round.  Each port example runs through its ``main``
with ``--device cpu``.  The benchmark is held to dense ``eigvalsh`` and
never to its ARPACK line: on the square grid ARPACK's single-vector
Lanczos misses a copy of a double eigenvalue.  A last case runs the port's
examples in a subprocess and checks that neither ``jax`` nor ``rbl_tpu``
was imported.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import rbl_tpu
import _torch_parity  # noqa: F401  (caps torch's threads)
from _torch_gates import load_example as _load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax_example(name, args, monkeypatch, record):
    """Run examples/<name>.py's main in-process with ``args``; returns its
    standard output.  ``record`` names the rbl_tpu entry points whose
    results are kept (a list each, in call order)."""
    calls = {}
    for fn in record:
        real = getattr(rbl_tpu, fn)

        def wrapped(*a, _real=real, _fn=fn, **kw):
            out = _real(*a, **kw)
            calls.setdefault(_fn, []).append(out)
            return out

        monkeypatch.setattr(rbl_tpu, fn, wrapped)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load(name).main()
    return buf.getvalue(), calls


def _run_port_example(name, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _load(f"torch_{name}").main([*args, "--device", "cpu"])
    return buf.getvalue(), out


def _values(text, key):
    return [float(v) for v in re.findall(rf"{key}=([-+0-9.e]+)", text)]


def test_benchmark_matches_the_jax_example_and_eigvalsh(monkeypatch):
    from rbl_tpu_torch.utils.suitesparse import laplacian_2d

    args = ["--laplacian", "24", "--k", "5", "--blocks", "4", "--repeat", "1"]
    jtext, jcalls = _run_jax_example("benchmark", args, monkeypatch, ["rbl"])
    ttext, (runs, _) = _run_port_example("benchmark", args)
    (res, wall), = runs[4]
    jres = jcalls["rbl"][-1]  # the warm-up is the first call
    dense = np.linalg.eigvalsh(laplacian_2d(24, 24).toarray())[::-1][:5]
    np.testing.assert_allclose(res.eigenvalues, dense, rtol=1e-10)
    for got, want in ((res.eigenvalues[0], jres.eigenvalues[0]),
                      (res.eigenvalues[-1], jres.eigenvalues[-1])):
        assert abs(got - want) <= 1e-10 * abs(want)
    # the same lines, the printed values equal to the digits printed
    for key in ("largest", "smallest"):
        assert _values(ttext, key) == _values(jtext, key)
    assert re.search(r"\[RBL b=4 cold\] laplacian2d-24x24: [0-9.]+s, converged=True", ttext)
    assert wall > 0 and res.converged


def test_images_matches_the_jax_example(monkeypatch):
    args = ["--rank", "10"]
    jtext, jcalls = _run_jax_example("images", args, monkeypatch, ["rbl_svd"])
    ttext, out = _run_port_example("images", args)
    jsvd = jcalls["rbl_svd"][0]
    np.testing.assert_allclose(out["sigma"], jsvd.s, rtol=1e-8)
    B = _load("torch_images").load_or_make_image(None)
    U, V = np.asarray(jsvd.U), np.asarray(jsvd.V)
    j_err = np.linalg.norm(B - (U * jsvd.s[None, :]) @ V.T) / np.linalg.norm(B)
    assert abs(out["err_rbl"] - j_err) <= 1e-8 * j_err
    assert abs(out["err_rbl"] - out["err_svd"]) <= 1e-8 * out["err_svd"]
    for label in ("RBL\\(BᵀB\\)", "svds", "full SVD"):
        pat = rf"{label}:\s+[0-9.]+s\s+rel fro err ([0-9.e+-]+)"
        assert re.search(pat, ttext).group(1) == re.search(pat, jtext).group(1)


def test_generalized_matches_the_jax_example(monkeypatch):
    args = ["--n", "200", "--k", "4"]
    jtext, jcalls = _run_jax_example("generalized", args, monkeypatch,
                                     ["rbl_generalized", "eigsh"])
    ttext, out = _run_port_example("generalized", args)
    jvib, jmode3, jbuck = jcalls["rbl_generalized"]
    (w3, _), = jcalls["eigsh"]
    for got, want in ((out["vibration"], jvib.eigenvalues),
                      (out["mode3"], jmode3.eigenvalues),
                      (out["buckling"], jbuck.eigenvalues),
                      (out["elastic3d"], w3)):
        np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(out["buckling"], out["buckling_dense"], rtol=1e-6)
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    A3 = fem_elasticity_3d(8)
    norm = spla.eigsh(A3, 1, which="LM", return_eigenvectors=False)[0]
    assert out["elastic3d_residual"] <= 1e-6 * norm
    for head in ("== vibration: lowest 4 modes", "== buckling:", "== 3-D elasticity"):
        assert head in ttext and head in jtext


# each port example at the sizes above, run as a script
SCRIPTS = (
    ("torch_benchmark", ["--laplacian", "24", "--k", "5", "--blocks", "4", "--repeat", "1"]),
    ("torch_images", ["--rank", "10"]),
    ("torch_generalized", ["--n", "200", "--k", "4"]),
)


def test_examples_import_neither_jax_nor_rbl_tpu():
    code = (
        "import runpy, sys\n"
        f"for name, args in {SCRIPTS!r}:\n"
        "    sys.argv = [name, *args, '--device', 'cpu']\n"
        "    runpy.run_path(f'examples/{name}.py', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'rbl_tpu') if m in sys.modules]\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "imported: []" in proc.stdout
    assert "max residual" in proc.stdout  # the last example ran to its end


@pytest.mark.parametrize("name,args", SCRIPTS)
def test_example_without_a_card_raises(name, args, monkeypatch):
    """Without --device the examples run on the card; with none (as on a
    CPU-only machine) they raise before any work."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mod = _load(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
