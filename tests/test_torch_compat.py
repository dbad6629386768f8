"""The port's scipy front door (``rbl_tpu_torch.eigsh`` / ``svds``) against
the JAX package's and scipy's on the CPU: the twin of tests/test_compat.py.

Each case hands the same numpy inputs to ``rbl_tpu.eigsh``/``svds`` and to
the port's with ``RBLConfig(device="cpu")``, with scipy's ``eigsh``/``svds``
or a dense ``eigvalsh``/``svd`` as the second witness.  Eigenvalues and
singular values agree to 1e-7 relative (the solves stop at a residual
bound, so the two packages' randomized start blocks leave differences at
that level; tighter where the JAX test is tighter); true residuals meet the
JAX test's bounds; results are numpy in scipy's sort orders, the same
order in both packages; the same exception types are raised, and
``ArpackNoConvergence`` carries the same partial results.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch
from scipy.sparse.linalg import ArpackNoConvergence

import rbl_tpu as jt
from rbl_tpu import compat as jcompat

import rbl_tpu_torch as tt
from _torch_parity import CPU
from rbl_tpu_torch import compat as tcompat

C = tt.RBLConfig(device=CPU)
RTOL = 1e-7


def _sym_sparse(n=300, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng)
    A = sp.csr_matrix(A + A.T)
    A.setdiag(rng.standard_normal(n))
    return A


def _both(fn_name, *args, rtol=RTOL, **kw):
    """Run the JAX package's and the port's ``fn_name`` on the same
    inputs; returns (jax result, port result) with the values compared."""
    jres = getattr(jt, fn_name)(*args, **kw)
    tres = getattr(tt, fn_name)(*args, cfg=kw.pop("cfg", C), **kw)
    jw = jres if isinstance(jres, np.ndarray) else jres[0 if fn_name == "eigsh" else 1]
    tw = tres if isinstance(tres, np.ndarray) else tres[0 if fn_name == "eigsh" else 1]
    assert isinstance(tw, np.ndarray) and tw.shape == np.asarray(jw).shape
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=rtol)
    return jres, tres


def _residual(A, w, V):
    return np.linalg.norm(A @ V - V * w[None, :], axis=0).max()


class TestEigsh:
    def test_matches_scipy_lm(self):
        A = _sym_sparse()
        (jw, jV), (w, V) = _both("eigsh", A, k=6, tol=1e-9)
        w_ref = sla.eigsh(A, k=6, which="LM", tol=1e-10)[0]
        np.testing.assert_allclose(w, w_ref, rtol=RTOL)
        assert isinstance(V, np.ndarray) and V.shape == (300, 6)
        assert np.all(np.diff(w) >= 0)  # ascending algebraic
        assert _residual(A, w, V) < 1e-6
        assert _residual(A, jw, np.asarray(jV)) < 1e-6

    @pytest.mark.parametrize("which", ["LA", "SA"])
    def test_matches_scipy_ends(self, which):
        A = _sym_sparse(seed=1)
        jw, w = _both("eigsh", A, k=5, which=which, tol=1e-9,
                      return_eigenvectors=False)
        w_ref = sla.eigsh(A, k=5, which=which, tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(np.sort(w), np.sort(w_ref), rtol=1e-6)
        # scipy's order without vectors: LA ascending algebraic, SA
        # ascending |λ|
        key = w if which == "LA" else np.abs(w)
        assert np.all(np.diff(key) >= 0)

    def test_ascending_order_and_vector_match(self):
        # diagonal operator: exact spectrum, exact eigenvectors
        d = np.linspace(-10.0, 10.0, 200)
        A = sp.diags(d)
        (jw, _), (w, V) = _both("eigsh", A, k=4, tol=1e-11, rtol=1e-10)
        assert np.all(np.diff(w) >= 0)
        idx = np.argsort(np.abs(d))[-4:]
        np.testing.assert_allclose(
            np.sort(w), np.sort(d[idx]), rtol=1e-10, atol=1e-10
        )
        for j, wj in enumerate(w):
            i = int(np.argmin(np.abs(d - wj)))
            assert abs(abs(V[i, j]) - 1.0) < 1e-5

    def test_v0_seeds_start(self):
        A = _sym_sparse(seed=2)
        v0 = np.ones(A.shape[0])
        _both("eigsh", A, k=4, v0=v0, tol=1e-9)
        w1, _ = tt.eigsh(A, k=4, v0=v0, tol=1e-9, cfg=C)
        w2, _ = tt.eigsh(A, k=4, v0=v0, tol=1e-9, cfg=C)
        np.testing.assert_array_equal(w1, w2)  # deterministic
        w3 = sla.eigsh(A, k=4, which="LM", tol=1e-10,
                       return_eigenvectors=False)
        np.testing.assert_allclose(w1, np.sort(w3), rtol=1e-6)

    def test_ncv_caps_krylov(self):
        A = _sym_sparse(seed=3)
        # a 60-column cap may stop short of the 1e-8 residual target —
        # accuracy is only subspace-limited here, in both packages
        _both("eigsh", A, k=3, ncv=60, tol=1e-8, rtol=1e-4)
        w, _ = tt.eigsh(A, k=3, ncv=60, tol=1e-8, cfg=C)
        w_ref = sla.eigsh(A, k=3, which="LM", tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(w, np.sort(w_ref), rtol=1e-4)

    @pytest.mark.parametrize("b", [None, 16])
    def test_be_both_ends(self, b):
        # b=16: an explicit block size is honored on the BE path (not
        # shrunk to the half-solve's default)
        A = _sym_sparse(seed=4 if b is None else 7)
        k = 5 if b is None else 4
        (_, _), (w, V) = _both("eigsh", A, k=k, which="BE", b=b, tol=1e-9,
                               rtol=1e-6)
        w_ref = sla.eigsh(A, k=k, which="BE", tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(w, np.sort(w_ref), rtol=1e-6)
        assert _residual(A, w, V) < 1e-6

    @pytest.mark.parametrize("call, exc", [
        # each BE half-solve passes its own kk <= n check: the up-front
        # guard catches k > n
        (lambda m, A, cfg: m.eigsh(sp.diags(np.linspace(1.0, 8.0, 8)),
                                   k=10, which="BE", **cfg), ValueError),
        (lambda m, A, cfg: m.eigsh(A, k=3, sigma=1.0, mode="cayley", **cfg),
         NotImplementedError),
        (lambda m, A, cfg: m.eigsh(A, k=3, sigma=1.0, which="SM", **cfg),
         NotImplementedError),
        (lambda m, A, cfg: m.eigsh(A, k=5, ncv=5, **cfg), ValueError),
        (lambda m, A, cfg: m.svds(np.eye(10), k=2, which="LA", **cfg),
         NotImplementedError),
    ], ids=["be_k_exceeds_n", "cayley_without_M", "sigma_with_sm", "ncv_le_k",
            "svds_which_la"])
    def test_unsupported_modes_raise(self, call, exc):
        A = _sym_sparse()
        with pytest.raises(exc):
            call(jt, A, {})
        with pytest.raises(exc):
            call(tt, A, {"cfg": C})


class TestSvds:
    def test_matches_scipy(self):
        rng = np.random.default_rng(0)
        B = rng.standard_normal((160, 90))
        _, (U, s, Vh) = _both("svds", B, k=5, rtol=1e-8)
        s_ref = sla.svds(B, k=5, return_singular_vectors=False)
        np.testing.assert_allclose(s, np.sort(s_ref), rtol=1e-8)
        assert isinstance(U, np.ndarray) and isinstance(Vh, np.ndarray)
        assert U.shape == (160, 5) and Vh.shape == (5, 90)
        np.testing.assert_allclose(
            U * s[None, :], B @ Vh.T, atol=1e-8 * s.max()
        )

    def test_values_only(self):
        rng = np.random.default_rng(1)
        B = rng.standard_normal((64, 128))
        _, s = _both("svds", B, k=4, return_singular_vectors=False,
                     rtol=1e-9)
        s_exact = np.linalg.svd(B, compute_uv=False)[:4]
        np.testing.assert_allclose(s, np.sort(s_exact), rtol=1e-9)

    def test_sparse_input(self):
        B = sp.random(200, 80, density=0.1, random_state=3)
        _, s = _both("svds", B, k=3, return_singular_vectors=False)
        s_ref = sla.svds(B, k=3, return_singular_vectors=False)
        np.testing.assert_allclose(s, np.sort(s_ref), rtol=1e-7)

    @pytest.mark.parametrize("rs", [7, "generator", "randomstate"])
    def test_random_state_generator_and_randomstate(self, rs):
        # scipy accepts int | Generator | RandomState — all must work
        rng = np.random.default_rng(2)
        B = rng.standard_normal((50, 30))
        s_exact = np.sort(np.linalg.svd(B, compute_uv=False)[:3])
        make = {7: lambda: 7, "generator": lambda: np.random.default_rng(7),
                "randomstate": lambda: np.random.RandomState(7)}[rs]
        sj = jt.svds(B, k=3, return_singular_vectors=False,
                     random_state=make())
        s = tt.svds(B, k=3, return_singular_vectors=False,
                    random_state=make(), cfg=C)
        np.testing.assert_allclose(s, s_exact, rtol=1e-9)
        np.testing.assert_allclose(s, sj, rtol=1e-9)

    def test_v0_is_forwarded(self):
        # v0 seeds the Gram-side start block (scipy: length min(m, n));
        # a wrong-length v0 must raise instead of being silently ignored
        rng = np.random.default_rng(3)
        B = rng.standard_normal((60, 40))
        v0 = rng.standard_normal(40)  # min(m, n) = 40 (right Gram side)
        _, s = _both("svds", B, k=3, v0=v0, return_singular_vectors=False,
                     rtol=1e-9)
        s_exact = np.sort(np.linalg.svd(B, compute_uv=False)[:3])
        np.testing.assert_allclose(s, s_exact, rtol=1e-9)
        bad = rng.standard_normal(60)
        with pytest.raises(ValueError):
            jt.svds(B, k=3, v0=bad)
        with pytest.raises(ValueError):
            tt.svds(B, k=3, v0=bad, cfg=C)


def test_reference_gpu_entry_aliases():
    """All four reference entry names (RBL.jl:119, RBL_gpu.jl:205,
    restarted.jl:97,196) resolve to the single device-agnostic core: the
    port's aliases on the CPU against the JAX package's."""
    d = np.arange(1.0, 401.0)
    A = sp.diags(d)
    D, V = tt.RBL_gpu(A, 5, 5, cfg=C)
    np.testing.assert_allclose(D, d[::-1][:5], rtol=1e-12)
    np.testing.assert_allclose(D, jt.RBL_gpu(A, 5, 5)[0], rtol=1e-12)
    D2, V2 = tt.RBL_gpu_restarted(A, 3, cfg=C)
    np.testing.assert_allclose(np.sort(D2)[::-1], d[::-1][:3], rtol=1e-8)
    assert V2 is not None  # unlike the reference's V=zeros quirk


class TestMaxiterRestarted:
    """eigsh(maxiter=...) routes through the explicitly restarted solver
    (ARPACK's implicit-restart budget ↦ max_restarts)."""

    def test_maxiter_converged_matches_dense(self):
        A = _sym_sparse(160, seed=5)
        _, w = _both("eigsh", A, k=4, maxiter=50, return_eigenvectors=False,
                     rtol=1e-6)
        dense = np.linalg.eigvalsh(A.toarray())
        ref = dense[np.argsort(-np.abs(dense))[:4]]
        # scipy order for LM without vectors: ascending |λ|
        np.testing.assert_allclose(w, ref[np.argsort(np.abs(ref))], rtol=1e-6)

    def test_maxiter_with_vectors_and_which_sa(self):
        A = _sym_sparse(120, seed=6)
        w, V = tt.eigsh(A, k=3, which="SA", maxiter=60, b=2, cfg=C)
        dense = np.linalg.eigvalsh(A.toarray())
        np.testing.assert_allclose(w, dense[:3], rtol=1e-6)
        assert _residual(A, w, V) < 1e-5 * np.abs(dense).max()
        np.testing.assert_allclose(
            w, jt.eigsh(A, k=3, which="SA", maxiter=60, b=2)[0], rtol=1e-6)

    @pytest.mark.parametrize("spectrum", ["uniform", "three_isolated"])
    def test_maxiter_exhausted_raises_with_partial(self, spectrum):
        # one tiny sweep, one restart: cannot lock all 8 pairs.  With three
        # isolated values on top, both packages lock exactly those three
        # and the partial results ride on the exception, scipy-style.
        if spectrum == "uniform":
            d = np.arange(1.0, 201.0)
        else:
            d = np.concatenate([np.linspace(0.0, 1.0, 197),
                                [1000.0, 900.0, 800.0]])
        A = sp.diags(d).tocsr()
        with pytest.raises(ArpackNoConvergence) as ej:
            jt.eigsh(A, k=8, maxiter=1, ncv=10, b=1)
        with pytest.raises(ArpackNoConvergence) as et:
            tt.eigsh(A, k=8, maxiter=1, ncv=10, b=1, cfg=C)
        w = et.value.eigenvalues
        assert isinstance(w, np.ndarray) and w.shape[0] <= 8
        assert isinstance(et.value.eigenvectors, np.ndarray)
        assert et.value.eigenvectors.shape == (200, w.shape[0])
        np.testing.assert_allclose(np.sort(w), np.sort(ej.value.eigenvalues),
                                   rtol=1e-9)
        if spectrum == "three_isolated":
            np.testing.assert_allclose(np.sort(w), [800.0, 900.0, 1000.0],
                                       rtol=1e-9)
            V = et.value.eigenvectors
            assert _residual(A, w, V) < 1e-6


def test_svds_which_sm_ascending():
    """svds(which="SM"): smallest singular triplets, s ascending, scipy
    conventions, in both packages."""
    rng = np.random.default_rng(21)
    B = rng.standard_normal((70, 50)) + 5.0 * np.eye(70, 50)
    _, (u, s, vh) = _both("svds", B, k=4, which="SM", rtol=1e-8)
    s_true = np.sort(np.linalg.svd(B, compute_uv=False))[:4]
    np.testing.assert_allclose(s, s_true, rtol=1e-8)
    assert np.all(np.diff(s) >= 0)
    np.testing.assert_allclose(
        B @ vh.T, u * s[None, :], atol=1e-7 * s_true[-1]
    )
    s_only = tt.svds(B, k=4, which="SM", return_singular_vectors=False, cfg=C)
    np.testing.assert_allclose(s_only, s_true, rtol=1e-8)


def test_eigsh_be_maxiter_raises_on_nonconvergence():
    """BE with maxiter raises ArpackNoConvergence (like the non-BE maxiter
    path) instead of returning a partial spectrum, in both packages."""
    d = np.linspace(1.0, 1.001, 400)  # pathologically clustered
    A = sp.diags(d).tocsr()
    for m, kw in ((jt, {}), (tt, {"cfg": C})):
        with pytest.raises(ArpackNoConvergence):
            m.eigsh(A, k=8, which="BE", maxiter=1, ncv=10, tol=1e-14, **kw)


class TestMaxiterShiftInvert:
    """maxiter under shift-invert: the restart budget applies to the outer
    sweep on OP = (A − σI)⁻¹."""

    def test_sigma_maxiter_converged_matches_dense(self):
        d = np.concatenate([np.arange(1.0, 97.0), [200.0, 201.0]])
        A = sp.diags(d)
        (_, _), (w, V) = _both("eigsh", A, k=3, sigma=50.2, maxiter=40,
                               tol=1e-9, rtol=1e-8)
        exact = d[np.argsort(np.abs(d - 50.2))[:3]]
        np.testing.assert_allclose(np.sort(w), np.sort(exact), rtol=1e-8)
        assert _residual(A, w, V) < 1e-6 * d.max()

    @pytest.mark.parametrize("spectrum", ["clustered", "three_isolated"])
    def test_sm_maxiter_exhausted_raises(self, spectrum):
        # near zero: one restart of a tiny sweep cannot lock 8; with three
        # isolated values at the bottom both packages lock those three
        d = 1.0 + np.arange(300.0) / 1e5
        if spectrum == "three_isolated":
            d = np.concatenate([[1e-3, 2e-3, 3e-3], d[:197]])
        A = sp.diags(d)
        with pytest.raises(ArpackNoConvergence) as ej:
            jt.eigsh(A, k=8, which="SM", maxiter=1, ncv=10, b=1, tol=1e-12)
        with pytest.raises(ArpackNoConvergence) as et:
            tt.eigsh(A, k=8, which="SM", maxiter=1, ncv=10, b=1, tol=1e-12,
                     cfg=C)
        w = et.value.eigenvalues
        assert w.shape[0] <= 8
        assert et.value.eigenvectors.shape == (A.shape[0], w.shape[0])
        np.testing.assert_allclose(np.sort(w), np.sort(ej.value.eigenvalues),
                                   rtol=1e-9)
        if spectrum == "three_isolated":
            np.testing.assert_allclose(np.sort(w), [1e-3, 2e-3, 3e-3],
                                       rtol=1e-9)

    def test_generalized_sigma_maxiter_converged(self):
        rng = np.random.default_rng(11)
        d = np.arange(1.0, 81.0)
        A = sp.diags(d)
        m = 1.0 + rng.random(80)
        M = sp.diags(m)
        lam = d / m
        target = 10.0
        (_, _), (w, V) = _both("eigsh", A, k=3, M=M, sigma=target,
                               maxiter=40, tol=1e-9)
        exact = lam[np.argsort(np.abs(lam - target))[:3]]
        np.testing.assert_allclose(np.sort(w), np.sort(exact), rtol=1e-7)
        # ARPACK's convention: M-orthonormal eigenvectors
        np.testing.assert_allclose(V.T @ (m[:, None] * V), np.eye(3),
                                   atol=1e-8)

    def test_generalized_plain_maxiter_exhausted_raises(self):
        A = sp.diags(np.arange(1.0, 201.0))
        M = sp.diags(np.ones(200))
        for mod, kw in ((jt, {}), (tt, {"cfg": C})):
            with pytest.raises(ArpackNoConvergence):
                mod.eigsh(A, k=8, M=M, maxiter=1, ncv=10, b=1, tol=1e-13,
                          **kw)


def test_sm_sort_order_without_vectors():
    """which="SM" without eigenvectors: scipy's DESCENDING |λ|, the same
    order in both packages (σ = 0 shift-invert on a small indefinite
    diagonal)."""
    d = np.concatenate([[-0.5, 0.7, -0.9, 1.1], 5.0 + np.arange(100.0)])
    A = sp.diags(d).tocsr()
    _, w = _both("eigsh", A, k=4, which="SM", tol=1e-10,
                 return_eigenvectors=False, rtol=1e-9)
    np.testing.assert_allclose(w, [1.1, -0.9, 0.7, -0.5], rtol=1e-9)


def _fem_operand():
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    return fem_elasticity_3d(11)  # n = 4,752 ≥ the AMG's 4,000


def test_auto_inner_psolve_builds_amg_near_the_bottom_only():
    """At n ≥ 4,000 a host sparse operand gets the smoothed-aggregation AMG
    for σ near the bottom of the spectrum and None for an interior σ, in
    both packages; the two cycles agree on the same block."""
    A = _fem_operand()
    sigma_in = 0.5 * float(np.abs(A.diagonal()).max())
    assert jcompat._auto_inner_psolve(A, sigma_in) is None
    assert tcompat._auto_inner_psolve(A, sigma_in, torch.float64, CPU) is None
    jp = jcompat._auto_inner_psolve(A, 0.0)
    tp = tcompat._auto_inner_psolve(A, 0.0, torch.float64, CPU)
    assert jp is not None and tp is not None
    X = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    Y = tp(torch.from_numpy(X)).numpy()
    Yj = np.asarray(jp(X))
    np.testing.assert_allclose(Y, Yj, rtol=0, atol=1e-10 * np.abs(Yj).max())


@pytest.mark.parametrize("exc, propagates", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (np.linalg.LinAlgError("Singular matrix"), False),
])
def test_auto_inner_psolve_catches_host_aggregation_errors_only(
        monkeypatch, exc, propagates):
    """An error raised while the AMG's levels are built on the device (here
    a RuntimeError, as CUDA and kernel-build errors are) propagates out of
    ``eigsh(sigma=0)``; what the host aggregation raises for a matrix of
    unusual structure (a LinAlgError) keeps the Jacobi tier."""
    from rbl_tpu_torch.ops import amg

    def fail(*args, **kw):
        raise exc

    A = _fem_operand()
    if propagates:
        monkeypatch.setattr(amg._AMGLevel, "__init__", fail)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tt.eigsh(A, k=2, sigma=0.0, cfg=C)
    else:
        monkeypatch.setattr(amg, "_block_diag_inv", fail)
        assert tcompat._auto_inner_psolve(A, 0.0, torch.float64, CPU) is None
