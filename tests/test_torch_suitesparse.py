"""The port's loaders and profiling on the CPU (``utils.suitesparse``,
``utils.profiling.trace``) and its public surface: ``load_matrix`` on
.mtx, .mtx.gz and .mat files written here, equal to the JAX package's
``load_matrix``; ``laplacian_2d`` equal to the JAX package's and to
``Laplacian2D.apply``; ``trace()`` writing a Chrome trace that names a
``Timer`` section; ``Timer.report`` leaving the worker's concurrent
"eig_poll" out of its total; ``utils.fem.lumped_mass``;
``rbl_tpu_torch.__all__`` equal to ``rbl_tpu.__all__``.
"""

import gzip
import json
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import rbl_tpu
from rbl_tpu.utils import suitesparse as jss

import rbl_tpu_torch as rtt
from _torch_parity import CPU, random_sym
from rbl_tpu_torch.utils import suitesparse as tss
from rbl_tpu_torch.utils.profiling import Timer, trace


def _assert_same(A, B):
    assert sp.isspmatrix_csr(A) and A.shape == B.shape
    assert abs(A - B).max() == 0


def _write_mtx(path, M, **kw):
    scipy.io.mmwrite(str(path), M, **kw)
    return str(path)


@pytest.mark.parametrize("kind", ["symmetric", "general", "nonsymmetric",
                                  "dense_array"])
def test_load_matrix_mtx_matches_jax(tmp_path, kind):
    """Symmetric storage expands, a general file holding a symmetric matrix
    stays as it is, a nonsymmetric one is symmetrized, and the dense array
    flavour is read too."""
    S = random_sym(120, 0.05, seed=3)
    M = {"symmetric": S, "general": S, "dense_array": S.toarray(),
         "nonsymmetric": sp.random(120, 120, density=0.05, random_state=4)}[kind]
    kw = {"symmetric": dict(symmetry="symmetric")}.get(kind, {})
    path = _write_mtx(tmp_path / "a.mtx", M, **kw)
    A = tss.load_matrix(path)
    _assert_same(A, jss.load_matrix(path))
    Md = M if isinstance(M, np.ndarray) else M.toarray()
    np.testing.assert_allclose(A.toarray(), 0.5 * (Md + Md.T), rtol=0, atol=0)


def test_load_matrix_mtx_gz_and_mat_match_jax(tmp_path):
    S = random_sym(90, 0.06, seed=5)
    plain = _write_mtx(tmp_path / "b.mtx", S, symmetry="symmetric")
    gz = str(tmp_path / "b.mtx.gz")
    with open(plain, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    problem = str(tmp_path / "problem.mat")  # the SuiteSparse layout
    scipy.io.savemat(problem, {"Problem": {"A": S, "name": "b"}})
    bare = str(tmp_path / "bare.mat")
    scipy.io.savemat(bare, {"K": S})
    for path in (gz, problem, bare):
        A = tss.load_matrix(path)
        _assert_same(A, jss.load_matrix(path))
        _assert_same(A, sp.csr_matrix(S))
    for m in (tss, jss):
        with pytest.raises(ValueError, match="unsupported"):
            m.load_matrix(str(tmp_path / "b.txt"))


def test_load_matrix_mtx_needs_no_compiler(tmp_path, monkeypatch):
    """load_matrix reads .mtx with scipy, so a host library that cannot be
    built (the native reader raises) does not stop it."""
    from rbl_tpu_torch import native

    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    S = random_sym(60, 0.1, seed=7)
    path = _write_mtx(tmp_path / "c.mtx", S, symmetry="symmetric")
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.read_matrix_market(path)
    _assert_same(tss.load_matrix(path), sp.csr_matrix(S))


def test_laplacian_2d_matches_jax_and_the_stencil():
    nx, ny = 7, 5
    L = tss.laplacian_2d(nx, ny)
    _assert_same(L, jss.laplacian_2d(nx, ny))
    X = np.random.default_rng(0).standard_normal((nx * ny, 3))
    op = rtt.Laplacian2D(nx, ny, device=CPU)
    np.testing.assert_allclose(op.apply(torch.from_numpy(X)).numpy(), L @ X,
                               rtol=0, atol=1e-13)


def test_trace_writes_a_chrome_trace_naming_timer_sections(tmp_path):
    timer = Timer()
    A = random_sym(200, 0.05, seed=6)
    with trace(str(tmp_path)) as prof:
        res = rtt.rbl(A, 3, 4, cfg=rtt.RBLConfig(device=CPU, tol=1e-8),
                      timer=timer)
        with timer.section("probe_section"):
            torch.ones(4) @ torch.ones(4)
    assert res.converged and prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "probe_section" in names
    assert "sweep_dispatch" in names  # a section of the solver itself
    assert timer.counts["probe_section"] == 1


def test_timer_report_leaves_concurrent_sections_out_of_the_total():
    """A section recorded from another thread (the eig worker's "eig_poll")
    is listed but not summed with the main thread's sections."""
    timer = Timer()
    timer.record("eig_poll", 0, 3_000_000_000)  # the worker's stamps, in ns
    timer.record("eig_poll", 5_000_000_000, 6_000_000_000)
    timer.times["sweep_dispatch"] += 2.0
    timer.counts["sweep_dispatch"] += 1
    assert timer.concurrent == {"eig_poll"} and timer.counts["eig_poll"] == 2
    lines = timer.report().splitlines()
    assert lines[-1].split() == ["total", "2.0000"]
    poll = next(ln for ln in lines if ln.startswith("eig_poll"))
    assert poll.split() == ["eig_poll", "2", "4.0000", "(concurrent)"]
    dispatch = next(ln for ln in lines if ln.startswith("sweep_dispatch"))
    assert dispatch.split()[-1] == "100.0%"


def test_rbl_records_its_polls_as_concurrent():
    """The solver's worker factorizations land in "eig_poll", not in the
    serial "eig" section."""
    timer = Timer()
    A = random_sym(200, 0.05, seed=8)
    rtt.rbl(A, 3, 4, cfg=rtt.RBLConfig(device=CPU, tol=1e-8), timer=timer)
    assert timer.counts["eig_poll"] >= 1 and "eig_poll" in timer.concurrent
    assert "eig" not in timer.concurrent


def test_lumped_mass_matches_the_fem_matrix():
    """utils.fem.lumped_mass: one entry a free dof of fem_elasticity_3d, all
    positive, the unclamped nodes' volume shares summing to the mesh's
    volume less the clamped face's."""
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    nx = 4
    m = lumped_mass(nx)
    assert m.shape == (fem_elasticity_3d(nx).shape[0],) and np.all(m > 0)
    # the clamped z = 0 face's nodes: 1/2 inside it, 1/4 on its edges,
    # 1/8 at its corners
    face_mass = (nx - 1) ** 2 * 0.5 + 4 * (nx - 1) * 0.25 + 4 * 0.125
    assert m.sum() / 3 == pytest.approx(nx ** 3 - face_mass)


def test_port_exports_the_jax_package_surface():
    assert set(rtt.__all__) == set(rbl_tpu.__all__)
    for name in rtt.__all__:
        assert getattr(rtt, name) is not None
