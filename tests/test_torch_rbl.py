"""Solve-level gates of the port (rbl_tpu_torch.rbl) on the CPU: the JAX
package's own accuracy gates (tests/test_spectra.py, 1e-13 with k=5, b=5),
the packed block-sparse path on an assembled FEM matrix, the bench-shaped
f32 configuration against the analytic Laplacian spectrum, and the port's
eigenvalues against the JAX package's ``rbl`` on the same matrix.

Random start blocks differ between the packages (torch.Generator versus
jax.random), so solves compare eigenvalues and residuals, not vectors.
"""

import concurrent.futures
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rbl_tpu
import rbl_tpu_torch as rtt
from _torch_gates import GATES, SPECTRA_TOL, spectra_error
from _torch_parity import CPU, random_sym
from rbl_tpu_torch.ops.spmm import bsr as tbsr
from rbl_tpu_torch.utils.fem import fem_elasticity_3d


@pytest.mark.parametrize("kind,n", GATES)
def test_spectra_gates(kind, n):
    assert spectra_error(kind, n, CPU) < SPECTRA_TOL


def test_negative_eigenvalue_by_magnitude():
    a = np.arange(1.0, 401.0)
    a[-1] = -800.0
    res = rtt.rbl(rtt.DiagonalOperator(torch.from_numpy(a)), 4, 4)
    np.testing.assert_allclose(res.eigenvalues, sorted(a, key=abs)[::-1][:4], rtol=1e-10)


def test_fem_through_block_sparse_operator():
    """An assembled 3-D elasticity stiffness (scipy CSR) goes through the
    packed block-sparse operator, in f64, to the 1e-13 gate; the Ritz
    vectors are orthonormal with small true residuals."""
    A = fem_elasticity_3d(6)
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="bsr")
    assert isinstance(op, rtt.BlockSparseOperator)
    res = rtt.rbl(op, 8, 4)
    w = np.linalg.eigvalsh(A.toarray())[::-1][:8]
    assert res.converged
    assert np.abs((res.eigenvalues - w) / w).max() < 1e-13
    V = res.eigenvectors.numpy()
    assert np.abs(V.T @ V - np.eye(8)).max() < 1e-10
    r = A @ V - V * res.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-6 * w[0]


def test_bench_shaped_f32_laplacian_against_analytic():
    """bench.py's configuration (f32 compute, bf16 basis, cholqr2, tol 1e-3,
    poll cadence 16) on a 32² Laplacian, held to bench.py's analytic check."""
    nx = 32
    cfg = rtt.RBLConfig(block_size=16, basis_dtype=torch.bfloat16,
                        compute_dtype=torch.float32, qr_method="cholqr2",
                        tol=1e-3, max_kryl_dim=256, eig_poll_cadence=16,
                        device=CPU)
    res = rtt.rbl(rtt.Laplacian2D(nx, nx, dtype=torch.float32, device=CPU), 20, cfg=cfg)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:20]
    assert res.eigenvectors.dtype == torch.float32
    assert np.max(np.abs(res.eigenvalues - lam) / lam) < 0.025


def _image_gram(seed=0):
    """The large-gap Gram spectrum of tests/test_spectra.py (λ1/λ2 ≈ 700)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((480, 40)) @ rng.standard_normal((40, 640))
    img += 0.05 * rng.standard_normal((480, 640))
    img -= img.min()
    img /= img.max()
    return img.T @ img


@pytest.mark.parametrize("case", ["largegap_b1", "largegap_b4", "rank5", "dominant"])
def test_hard_spectra_take_the_repair_paths(case, monkeypatch):
    """Spectra that drive the driver's escalations: a large-gap Gram
    (selective and danger modes), a rank-5 Gram with k=8 (partial-breakdown
    repair of the coupling block) and a -5000 eigenvalue atop 1..399
    (selective mode).  The answers must match the truth all the same."""
    from rbl_tpu_torch.solver import lanczos

    repairs = []
    real = lanczos._repair_block
    monkeypatch.setattr(lanczos, "_repair_block",
                        lambda *a, **kw: repairs.append(1) or real(*a, **kw))
    if case.startswith("largegap"):
        M = _image_gram()
        k, b = 50, int(case[-1])
    elif case == "rank5":
        B = np.random.default_rng(1).standard_normal((5, 300))
        M = B.T @ B
        k, b = 8, 4
    else:
        M = np.diag(np.concatenate([np.arange(1.0, 400.0), [-5000.0]]))
        k, b = 10, 4
    w = np.linalg.eigvalsh(M)
    want = w[np.argsort(-np.abs(w))][:k]
    res = rtt.rbl(rtt.DenseOperator(torch.from_numpy(M)), k, b)
    scale = np.abs(want).max()
    assert np.abs(res.eigenvalues - want).max() / scale < 1e-10
    assert res.converged
    if case == "rank5":
        assert repairs  # the coupling block lost rank and was repaired


@dataclasses.dataclass
class _ExplodingDiagonal(rtt.DiagonalOperator):
    """diag(d) whose ``at``-th apply adds 1e8 times a random block
    orthogonal to its input: the Gram A_i stays honest while ‖B_{i+1}‖
    jumps past the sweep's 10·‖A‖ guard, the signature of a dtype whose
    floor crossed the active scale."""

    at: int = 0
    calls: list = dataclasses.field(default_factory=list)

    def apply(self, X):
        Y = self.diag[:, None] * X
        self.calls.append(X.shape[1])
        if len(self.calls) == self.at:
            R = torch.randn(X.shape, dtype=X.dtype,
                            generator=torch.Generator().manual_seed(7))
            Y = Y + 1e8 * (R - X @ (X.T @ R))
        return Y


class _InlineExecutor:
    """The eig worker run inline: a poll is done when it is submitted, so
    the harvest's wall-clock race cannot move the branches a test pins."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        done = concurrent.futures.Future()
        done.set_result(fn(*args, **kwargs))
        return done

    def shutdown(self, wait=True):
        pass


def _driver_state(kind, out):
    """Record, at a call made inside ``lanczos_iteration``, which of the
    sweep's handlers is running: the scan's stop markers, the chunk length,
    the policy flags and the first in-flight chunk's, and whether the call
    came through the eig harvest."""
    f = sys._getframe(2)
    via = []
    while f is not None and f.f_code.co_name != "lanczos_iteration":
        via.append(f.f_code.co_name)
        f = f.f_back
    loc = {} if f is None else f.f_locals
    inflight = loc.get("inflight")
    head = dict(inflight[0]) if inflight else None
    out.append(dict(
        kind=kind, via=via, head=head,
        **{x: loc.get(x) for x in ("explosion_at", "partial_at", "S", "i",
                                   "pr_stretch", "danger", "selective")},
    ))


def _spread(D, n=300):
    """D distinct positive eigenvalues and n − D zeros: the start block
    qr(A·Ω) lies in the D-dimensional range, so the Krylov space is
    exhausted at D columns and the coupling block of iteration D // 4
    (b = 4) keeps D mod 4 directions."""
    d = np.zeros(n)
    d[:D] = np.arange(D, 0, -1) * np.linspace(2.0, 1.0, D)
    return d


@pytest.mark.parametrize("case", [
    "explosion_rerandomize", "explosion_terminal",
    "partial_last_step", "partial_second_last_step", "stretch_flip",
])
def test_breakdown_branches_of_the_chunk_scan(case, monkeypatch):
    """The chunk scan's rarer handlers, each reached by a chosen input:
    the explosion guard re-randomizing (i·b < k) and ending the sweep
    (i·b ≥ k), the partial repair at the chunk's last and second-to-last
    step, and the discard of a chunk dispatched under a stretched scrub
    cadence after the stretch snapped back.  Each asserts that its handler
    ran and that the answer matches the truth."""
    from rbl_tpu_torch.solver import lanczos
    from rbl_tpu_torch.solver.basis import BasisStore

    monkeypatch.setattr(lanczos.concurrent.futures, "ThreadPoolExecutor",
                        _InlineExecutor)
    seen = []
    for mod, name in ((lanczos, "_fresh_directions"), (lanczos, "_repair_block"),
                      (BasisStore, "rewind")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw:
                            _driver_state(_n, seen) or _r(*a, **kw))
    cfg = dict(block_size=4, device=CPU)
    k = 8
    if case == "explosion_rerandomize":
        # four nonzero eigenvalues: Q₁ spans them, the first coupling block
        # is repaired to zero, and the explosion at iteration 2 (apply 3)
        # leaves i·b = 4 < k
        d = np.zeros(300)
        d[:4] = [4.0, 3.0, 2.0, 1.0]
        op = _ExplodingDiagonal(torch.from_numpy(d), at=3)
    elif case == "explosion_terminal":
        d = np.concatenate([[100.0, 80.0, 60.0, 50.0], np.linspace(0.0, 10.0, 296)])
        op = _ExplodingDiagonal(torch.from_numpy(d), at=8)  # iteration 7
        k, cfg["max_kryl_dim"] = 4, 64
    elif case.startswith("partial"):
        # iteration j = D // 4 sits at step j − 2 of the first 4-step chunk
        d = _spread(21 if case == "partial_last_step" else 17)
        op = rtt.DiagonalOperator(torch.from_numpy(d))
    else:
        d = np.random.default_rng(0).uniform(0.0, 1.0, 1000)
        op = rtt.DiagonalOperator(torch.from_numpy(d))
        k, cfg["adaptive_reorth_max"] = 4, 4
    res = rtt.rbl(op, k, cfg=rtt.RBLConfig(**cfg))
    want = d[np.argsort(-np.abs(d), kind="stable")][:k]
    assert np.abs(res.eigenvalues - want).max() < 1e-10 * np.abs(want).max()

    if case == "explosion_rerandomize":
        assert res.converged
        assert any(s["kind"] == "_fresh_directions" and s["explosion_at"] is not None
                   and "_repair_block" not in s["via"] for s in seen)
    elif case == "explosion_terminal":
        ends = [s for s in seen if s["explosion_at"] is not None]
        assert ends and all(s["kind"] == "rewind" for s in ends)
        assert ends[0]["i"] * 4 >= k and res.iterations == ends[0]["i"]
    elif case.startswith("partial"):
        assert res.converged
        step = {"partial_last_step": 1, "partial_second_last_step": 2}[case]
        repairs = [s for s in seen if s["kind"] == "_repair_block"]
        assert repairs and repairs[0]["partial_at"] == repairs[0]["S"] - step
    else:
        assert res.converged
        assert any(
            s["kind"] == "rewind" and "harvest" not in s["via"] and s["head"]
            and s["head"]["stretch"] > s["pr_stretch"]
            and s["head"]["danger"] == (s["danger"] or s["selective"])
            for s in seen
        )


def test_eigenvalues_match_jax_rbl():
    """The same matrix through both packages at f64: the port's packed
    block-sparse operator, the JAX package's dense one (the cheaper
    compile)."""
    A = random_sym(400, 0.03, seed=11) + sp.diags(np.linspace(0.0, 3.0, 400))
    jres = rbl_tpu.rbl(A.toarray(), 6, 3)
    tres = rtt.rbl(A.tocsr(), 6, 3, cfg=rtt.RBLConfig(device=CPU))
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, jres.eigenvalues, rtol=1e-12)
    assert np.max(tres.residual_bounds) < 1e-6


@pytest.mark.parametrize("which", ["LA", "SA"])
def test_which_algebraic_ends(which):
    a = np.linspace(-5.0, 3.0, 300)
    res = rtt.rbl(rtt.DiagonalOperator(torch.from_numpy(a)), 4, 4, which=which)
    want = np.sort(a)[::-1][:4] if which == "LA" else np.sort(a)[:4]
    np.testing.assert_allclose(res.eigenvalues, want, rtol=1e-10, atol=1e-10)


def test_deflate_and_v0():
    """deflate= excludes known eigenvectors (the next k come back);
    v0= seeds the start block and changes nothing else."""
    a = np.arange(1.0, 301.0)
    known = np.zeros((300, 3))
    known[[299, 298, 297], [0, 1, 2]] = 1.0
    op = rtt.DiagonalOperator(torch.from_numpy(a))
    res = rtt.rbl(op, 4, 4, deflate=known, v0=np.ones(300))
    np.testing.assert_allclose(res.eigenvalues, [297.0, 296.0, 295.0, 294.0], rtol=1e-12)
    D, V = rtt.RBL_gpu(op, 4, 4)
    np.testing.assert_allclose(D, a[::-1][:4], rtol=1e-12)
    assert V.shape == (300, 4)
    with pytest.raises(ValueError):
        rtt.rbl(op, 0, 4)


def test_cpu_solve_never_counts_kernel_launches():
    before = (tbsr.bsr_spmm_packed_resident.launches, tbsr.bsr_spmm_packed.launches)
    rtt.rbl(rtt.as_operator(fem_elasticity_3d(3), device=CPU, format="bsr"), 4, 4)
    assert (tbsr.bsr_spmm_packed_resident.launches, tbsr.bsr_spmm_packed.launches) == before


def test_import_leaves_jax_out():
    """Every module of the port, subpackages included, imports neither
    jax nor the JAX package."""
    code = ("import importlib, pkgutil, sys, rbl_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'rbl_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'rbl_tpu_torch.benchmarks.dma_stream_bench' in names, names; "
            "bad = [m for m in ('jax', 'rbl_tpu') if m in sys.modules]; "
            "print(len(names), bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_host_matrix_without_a_device_raises_instead_of_solving(monkeypatch):
    """Entry points run on the CUDA card unless asked for the CPU: with no
    card (as on a CPU-only machine) a scipy matrix and no device raise,
    and nothing is solved on the host."""
    from rbl_tpu_torch.solver import rbl as trbl

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    solved = []
    monkeypatch.setattr(trbl, "_rbl_impl", lambda *a, **kw: solved.append(1))
    A = random_sym(100, 0.05, seed=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rtt.rbl(A, 4, 4)
    for build in (lambda: rtt.as_operator(A), lambda: rtt.Laplacian2D(4, 4),
                  lambda: rtt.BlockSparseOperator.from_scipy(A),
                  lambda: rtt.DiaOperator.from_scipy(sp.eye(5)),
                  lambda: rtt.SparseEllOperator.from_scipy(A),
                  lambda: rtt.CooOperator.from_scipy(A),
                  lambda: rtt.HybOperator.from_scipy(A)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert not solved
    # a tensor keeps its own device; an operator keeps its own
    assert rtt.as_operator(torch.eye(3)).device.type == "cpu"
