"""The JAX package's exact-spectrum gates as cases of the port, run on a
given device: tests/test_spectra.py (1e-13, k = 5, b = 5),
tests/test_fuzz_spectra.py (1e-10) and tests/test_which.py, with the same
shapes, seeds, configurations and tolerances.

The CPU tests (test_torch_rbl.py, test_torch_fuzz_spectra.py,
test_torch_which.py) and chip_smoke.py's phase 26 on the card run these
same cases.  Each case returns its errors; the caller holds them to the
tolerance.  ``load_example`` loads a script of examples/ as a module, for
tests/test_torch_examples.py and chip_smoke.py's phase 25.  This module
imports torch and the port only.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import rbl_tpu_torch as rtt

SPECTRA_TOL = 1e-13  # tests/test_spectra.py: norm of the relative errors
FUZZ_TOL = 1e-10  # tests/test_fuzz_spectra.py: each relative error
F32_HEAD_TOL = 1e-3  # test_f32_precision_exhaustion_graceful: the top 10
LA_TOL, SA_TOL, DEFLATE_TOL = 1e-9, 1e-8, 1e-10  # tests/test_which.py

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_example(name):
    """examples/<name>.py as a module (the examples are scripts, not a
    package)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def diagonal(d, device, dtype=torch.float64):
    return rtt.DiagonalOperator(torch.as_tensor(np.asarray(d), dtype=dtype,
                                                device=device))


def top_by_magnitude(d, k):
    d = np.asarray(d, dtype=np.float64)
    return d[np.argsort(np.abs(d))[::-1][:k]]


# --- tests/test_spectra.py ------------------------------------------------

def _step(n, k):
    a = np.ones(n)
    for i in range(1, 2 * k + 1):
        a[2 * k - i] = i * n
    return a


GATES = (
    [("slow", n) for n in range(100, 1001, 200)]
    + [("moderate", n) for n in range(100, 1001, 200)]
    + [("step", 100_000)]
)


def spectra_diag(kind, n):
    return {"slow": lambda: np.arange(1.0, n + 1.0),
            "moderate": lambda: np.cumsum(np.arange(1.0, n + 1.0)),
            "step": lambda: _step(n, 5)}[kind]()


def spectra_error(kind, n, device, k=5, b=5):
    """The norm of the relative errors of rbl's k values against the top
    k of the spectrum."""
    diag = spectra_diag(kind, n)
    res = rtt.rbl(diagonal(diag, device), k, b)
    eig = np.sort(diag)[::-1][:k]
    return float(np.linalg.norm((res.eigenvalues - eig) / eig))


# --- tests/test_fuzz_spectra.py -------------------------------------------

SHAPES = {
    # two tight clusters separated by a huge gap (danger-regime stress)
    "gap_clusters": lambda rng, n: np.concatenate(
        [1e6 + rng.uniform(0, 1, 8), rng.uniform(1, 2, n - 8)]
    ),
    # geometric decay — fast convergence, early poll window
    "geometric": lambda rng, n: 0.9 ** np.arange(n) * 1e3 + 1e-3,
    # mixed signs, |λ| top-k straddles both ends of the spectrum
    "indefinite": lambda rng, n: np.concatenate(
        [-(n + 10.0 - np.arange(5.0)), np.arange(1.0, n - 4.0)]
    ),
    # near-degenerate top pairs (MRRR subset + convergence-bound stress)
    "near_degenerate": lambda rng, n: np.concatenate(
        [[1000.0, 1000.0 + 1e-8, 999.0, 999.0 + 1e-8], np.arange(1.0, n - 3.0)]
    ),
    # heavy uniform tail right under the wanted eigenvalues
    "crowded_top": lambda rng, n: np.concatenate(
        [n + np.arange(6.0), rng.uniform(0.9 * n, n, n - 6)]
    ),
    # random log-uniform — no structure at all
    "log_uniform": lambda rng, n: np.exp(rng.uniform(0, 12, n)),
}


def shape_diag(shape, seed, n=400):
    return SHAPES[shape](np.random.default_rng(seed), n)


SLOW_SEPARATION = np.arange(1.0, 701.0)
NEGATIVE_DOMINANT = np.concatenate([[-5000.0], np.arange(1.0, 400.0)])
HOST_OFFLOAD_SHAPES = ("gap_clusters", "indefinite", "near_degenerate", "log_uniform")
NARROW_WINDOW = dict(chunk_growth_cap=8, eig_poll_cadence=4)
ADAPTIVE = dict(adaptive_reorth_max=4)
HOST_OFFLOAD = dict(basis_device_cap_cols=64)

# name → (spectrum, RBLConfig fields): every diagonal case of the reference
FUZZ_CASES = {
    **{f"fuzz_{shape}_seed{seed}": (lambda s=shape, r=seed: shape_diag(s, r), {})
       for shape in sorted(SHAPES) for seed in (0, 1)},
    **{f"host_offload_{shape}": (lambda s=shape: shape_diag(s, 2), HOST_OFFLOAD)
       for shape in HOST_OFFLOAD_SHAPES},
    "grown_chunks_narrow_window": (lambda: SLOW_SEPARATION, NARROW_WINDOW),
    **{f"adaptive_{shape}": (lambda s=shape: shape_diag(s, 1), ADAPTIVE)
       for shape in sorted(SHAPES)},
    "adaptive_slow_separation": (lambda: SLOW_SEPARATION, {**ADAPTIVE, **NARROW_WINDOW}),
    "negative_dominant": (lambda: NEGATIVE_DOMINANT, {}),
}


def fuzz_case(name, device, k=5, b=5):
    """rbl on the case's diagonal as the reference's ``_check`` runs it;
    returns the relative errors against the top k by |λ| and the result."""
    make, cfg_kw = FUZZ_CASES[name]
    diag = make()
    true_k = top_by_magnitude(diag, k)
    cfg = rtt.RBLConfig(block_size=b, device=device, **cfg_kw)
    res = rtt.rbl(diagonal(diag, device), k, b, cfg=cfg)
    return np.abs(res.eigenvalues - true_k) / np.abs(true_k), res


SPARSE_CASES = ("random_sym", "banded_posdef", "power_law")


def sparse_matrix(case):
    A = {
        "random_sym": lambda: sp.random(400, 400, density=0.05, random_state=3),
        "banded_posdef": lambda: sp.diags(
            [np.full(600, 4.0), np.full(599, -1.0), np.full(599, -1.0)],
            [0, 1, -1],
        ),
        "power_law": lambda: sp.random(500, 500, density=0.02, random_state=5),
    }[case]()
    return sp.csr_matrix(A + A.T)


def sparse_vs_eigsh(case, device):
    """rbl(A, 5, 5) on a sparse operator (the router picks its layout)
    against ARPACK at tol 1e-10; returns the relative errors and the
    result."""
    A = sparse_matrix(case)
    w_ref = spla.eigsh(A, k=5, which="LM", tol=1e-10, return_eigenvectors=False)
    w_ref = w_ref[np.argsort(-np.abs(w_ref))]
    res = rtt.rbl(A, 5, 5, cfg=rtt.RBLConfig(block_size=5, device=device))
    return np.abs(res.eigenvalues - w_ref) / np.abs(w_ref), res


def f32_exhaustion(device):
    """f32 with dominance beyond eps's resolvable range (σ₁/σ_sea ≈ 1e5);
    returns the result and the true top 20."""
    rng = np.random.default_rng(3)
    diag = np.concatenate(
        [[8.0e4, 4.0e4], 100.0 - np.arange(40.0), rng.uniform(0.1, 0.4, 600)]
    )
    cfg = rtt.RBLConfig(block_size=8, basis_dtype=torch.float32,
                        compute_dtype=torch.float32, tol=1e-5,
                        max_kryl_dim=512, device=device)
    res = rtt.rbl(diagonal(diag.astype(np.float32), device, torch.float32), 20,
                  cfg=cfg)
    return res, np.sort(diag)[::-1][:20]


def f32_exhaustion_head_error(res, true_top) -> float:
    """The worst relative error of the top 10; raises where the values or
    the residual bounds are not finite."""
    if not (np.all(np.isfinite(res.eigenvalues)) and res.residual_bounds is not None
            and np.all(np.isfinite(res.residual_bounds))):
        raise AssertionError(f"f32 exhaustion: values {res.eigenvalues}, "
                             f"bounds {res.residual_bounds}")
    return float(np.max(np.abs(res.eigenvalues - true_top)[:10] / true_top[:10]))


RESTARTED_SHAPES = {
    # 8-dim dominant cluster over a tiny sea: breakdown + heavy deflation
    "gap_clusters": lambda: np.concatenate(
        [1e6 + np.random.default_rng(0).uniform(0, 1, 8),
         np.random.default_rng(1).uniform(1, 2, 392)]
    ),
    # dominant-value ghost regime (selective mode inside the sweep)
    "negative_dominant": lambda: NEGATIVE_DOMINANT,
    # locked near-degenerate pairs leak hardest
    "near_degenerate": lambda: np.concatenate(
        [[1000.0, 1000.0 + 1e-8, 999.0, 999.0 + 1e-8], np.arange(1.0, 397.0)]
    ),
    # slow separation: many restarts, growing sweeps
    "slow_uniform": lambda: np.arange(1.0, 401.0),
}


def restarted_case(shape, device):
    """rbl_restarted(diag, 4) at its defaults; returns the relative errors
    against the top 4 by |λ| and the result."""
    diag = np.asarray(RESTARTED_SHAPES[shape](), dtype=np.float64)
    true_k = top_by_magnitude(diag, 4)
    res = rtt.rbl_restarted(diagonal(diag, device), 4)
    return np.abs(res.eigenvalues - true_k) / np.abs(true_k), res


# --- tests/test_which.py --------------------------------------------------

def which_la(device):
    """LA on the sign-mixed diagonal, and LM's other end; returns the
    relative errors of each."""
    d = np.linspace(-50.0, 10.0, 400)
    cfg = rtt.RBLConfig(block_size=4, device=device)
    la = rtt.rbl(d, 5, 4, cfg=cfg, which="LA")
    lm = rtt.rbl(d, 5, 4, cfg=cfg)
    want = np.sort(d)[::-1][:5]
    return np.abs(la.eigenvalues - want) / np.abs(want), abs(lm.eigenvalues[0] + 50.0) / 50.0


def laplacian_smallest(nx, k):
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[:k]


def which_sa_laplacian(device, nx=24):
    """SA on the 24² Dirichlet Laplacian: relative errors against the
    analytic smallest 6, and the largest eigenvector residual over the
    residual bound the reference allows."""
    op = rtt.Laplacian2D(nx, nx, dtype=torch.float64, device=device)
    res = rtt.rbl(op, 6, 4, which="SA")
    lam = laplacian_smallest(nx, 6)
    V = res.eigenvectors
    R = op.apply(V) - V * torch.as_tensor(res.eigenvalues, device=V.device)[None, :]
    resid = float(torch.linalg.vector_norm(R, dim=0).max())
    return (np.abs(res.eigenvalues - lam) / lam,
            resid / (1e-6 * np.abs(lam).max() + 1e-8))


def which_sa_sparse(device):
    """SA on a sparse 500 × 500 matrix against eigsh(which="SA", tol=0)."""
    M = sp.random(500, 500, density=0.02, random_state=1)
    A = sp.csr_matrix(M + M.T)
    res = rtt.rbl(A, 5, 4, which="SA", cfg=rtt.RBLConfig(block_size=4, device=device))
    ref = np.sort(spla.eigsh(A, k=5, which="SA", tol=0)[0])
    return np.abs(res.eigenvalues - ref) / np.abs(ref)


def which_validation_raises(device) -> bool:
    try:
        rtt.rbl(np.ones(10), 2, 2, which="BE", cfg=rtt.RBLConfig(device=device))
    except ValueError:
        return True
    return False


def _host(V):
    return V.cpu().numpy() if isinstance(V, torch.Tensor) else np.asarray(V)


def deflate_next_after_known(device):
    """The next 3 after the top 3 of diag(1..500); returns the relative
    errors and max |VᵀW| between the deflated span and the new vectors."""
    A = sp.diags(np.arange(1.0, 501.0))
    cfg = rtt.RBLConfig(block_size=4, device=device)
    top = rtt.rbl(A, 3, b=4, cfg=cfg)
    nxt = rtt.rbl(A, 3, b=4, cfg=cfg, deflate=top.eigenvectors)
    want = np.array([497.0, 496.0, 495.0])
    X = _host(top.eigenvectors).T @ _host(nxt.eigenvectors)
    return np.abs(nxt.eigenvalues - want) / want, float(np.abs(X).max())


def _deflate_cases():
    un = np.zeros((300, 2))  # raw, scaled, non-orthonormal top-2 directions
    un[299, 0] = 7.5
    un[298, 1] = -0.03
    # 4 columns of rank 1: scaled copies of e_300 and a zero column; a QR
    # would invent 3 directions the user never excluded
    rd = np.zeros((300, 4))
    rd[299, 0] = 1.0
    rd[299, 1] = -2.5
    rd[299, 3] = 1e-3
    return {
        "unnormalized": (300, 2, un, [298.0, 297.0]),
        "rank_deficient": (300, 3, rd, [299.0, 298.0, 297.0]),
        "zero": (200, 2, np.zeros((200, 3)), [200.0, 199.0]),
    }


DEFLATE_CASES = ("unnormalized", "rank_deficient", "zero")


def deflate_case(case, device):
    n, k, X, want = _deflate_cases()[case]
    A = sp.diags(np.arange(1.0, n + 1.0))
    res = rtt.rbl(A, k, b=4, deflate=X, cfg=rtt.RBLConfig(block_size=4, device=device))
    want = np.asarray(want)
    return np.abs(res.eigenvalues - want) / want


def deflate_shape_raises(device) -> bool:
    A = sp.diags(np.arange(1.0, 101.0))
    try:
        rtt.rbl(A, 2, deflate=np.ones((55, 2)), cfg=rtt.RBLConfig(device=device))
    except ValueError:
        return True
    return False
