"""Generalized eigenproblem demo on the PyTorch port — examples/
generalized.py through rbl_tpu_torch: FEM vibration and buckling pencils,
end to end, cross-checked against dense LAPACK on the host.

1. Vibration modes: K·x = λ·M·x for a 1-D bar (stiffness K, consistent
   mass M — both tridiagonal).  Continuum eigenvalues are (kπ)²; we
   compute the lowest modes (σ = 0 shift-invert) and a cluster near a
   target frequency (sigma=..., mode 3).
2. Buckling: K·x = λ·K_G·x with an indefinite geometric stiffness K_G
   (mode 4, B = K inner product, A-orthonormal vectors).
3. 3-D elasticity vibration with the assembled grid AMG as the inner
   preconditioner, through the scipy-style ``eigsh``.

Usage: python examples/torch_generalized.py [--n 2000] [--k 6] [--device cpu]

It runs on the CUDA card (and raises without one) unless given
``--device cpu``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.linalg
import scipy.sparse as sp


def fem_bar(n):
    """1-D bar on (0,1): stiffness + consistent mass (both tridiag)."""
    h = 1.0 / (n + 1)
    K = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr() / h
    M = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).tocsr() * (h / 6)
    return K, M


def main(argv=None):
    """Run the three parts; returns a dict of each part's eigenvalues
    (``vibration``, ``mode3``, ``buckling`` with its ``buckling_dense``
    oracle, ``elastic3d``), the mode-3 shift (``sigma3``), the 3-D
    solve's max residual ‖A·v − λ·M·v‖ (``elastic3d_residual``), its
    grid-AMG hierarchy (``amg3d``) and each part's wall (``walls``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help='"cpu" or a CUDA device; default: the CUDA card')
    args = ap.parse_args(argv)

    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.config import resolve_device

    device = str(resolve_device(args.device))
    out = {"walls": {}}
    n, k = args.n, args.k
    K, M = fem_bar(n)

    print(f"== vibration: lowest {k} modes of K·x = λ·M·x (n={n}) ==")
    # The lowest modes of a stiff pencil (λ spans 9.87 … ~4n²) are an
    # interior problem in disguise: shift-invert at σ = 0 (ν = 1/λ,
    # which="LA" → nearest above 0) converges in a few outer iterations.
    t0 = time.perf_counter()
    res = rt.rbl_generalized(K, M, k, which="LA", sigma=0.0,
                             cfg=rt.RBLConfig(block_size=k, tol=1e-9, device=device))
    el = time.perf_counter() - t0
    cont = (np.arange(1, k + 1) * np.pi) ** 2
    print(f"  eigenvalues: {np.array2string(res.eigenvalues, precision=4)}")
    print(f"  continuum (kπ)²: {np.array2string(cont, precision=4)}")
    print(f"  converged={res.converged}  {el:.2f}s")
    out["vibration"], out["walls"]["vibration"] = res.eigenvalues, el

    sig = float(res.eigenvalues[-1] * 4.0)
    print(f"== vibration: {k} modes nearest σ={sig:.1f} (mode 3) ==")
    t0 = time.perf_counter()
    resi = rt.rbl_generalized(K, M, k, which="LM", sigma=sig,
                              cfg=rt.RBLConfig(block_size=k, tol=1e-8, device=device))
    el = time.perf_counter() - t0
    print(f"  eigenvalues: {np.array2string(resi.eigenvalues, precision=4)}")
    print(f"  converged={resi.converged}  {el:.2f}s")
    out["mode3"], out["sigma3"], out["walls"]["mode3"] = resi.eigenvalues, sig, el

    # Buckling on a smaller problem so the dense cross-check is cheap: it
    # takes B = K roots, so K is a mass-scaled stiffness with κ ~ 10 (a
    # κ ~ n² FEM stiffness needs explicit m_bounds/degree)
    nb = min(n, 400)
    rng = np.random.default_rng(0)
    Kb = sp.diags([-np.ones(nb - 1), rng.uniform(4.0, 9.0, nb),
                   -np.ones(nb - 1)], [-1, 0, 1]).tocsr()
    KG = sp.diags(np.where(np.arange(nb) % 2 == 0, 1.0, -1.0)) \
        + 0.2 * sp.diags([np.ones(nb - 1), np.ones(nb - 1)], [-1, 1])
    KG = sp.csr_matrix(KG)
    sigb = 9.7
    print(f"== buckling: K·x = λ·K_G·x, {3} modes nearest σ={sigb} "
          f"(mode 4, n={nb}) ==")
    t0 = time.perf_counter()
    resb = rt.rbl_generalized(Kb, KG, 3, which="LM", sigma=sigb,
                              mode="buckling",
                              cfg=rt.RBLConfig(block_size=3, tol=1e-8, device=device))
    el = time.perf_counter() - t0
    w = np.sort(np.real(scipy.linalg.eig(
        Kb.toarray(), KG.toarray(), right=False)))
    nu = w / (w - sigb)
    dense = w[np.argsort(-np.abs(nu))[:3]]
    print(f"  eigenvalues:  {np.array2string(resb.eigenvalues, precision=6)}")
    print(f"  dense oracle: {np.array2string(dense, precision=6)}")
    print(f"  converged={resb.converged}  {el:.2f}s")
    out.update(buckling=resb.eigenvalues, buckling_dense=dense)
    out["walls"]["buckling"] = el

    # 3-D elasticity vibration with the assembled grid AMG as the inner
    # preconditioner: it cuts the inner MINRES from hundreds of
    # iterations (scalar Jacobi) to ~25
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    N = 8
    A3 = fem_elasticity_3d(N)
    mlump = np.asarray(A3.sum(axis=1)).ravel()
    mlump = np.abs(mlump) + 1e-3 * np.abs(mlump).mean()
    amg = rt.AssembledMultigrid.from_grid(A3, (N, N + 1, N + 1), dof=3,
                                          device=device)
    print(f"== 3-D elasticity vibration: lowest 4 modes, grid-AMG "
          f"(n={A3.shape[0]}) ==")
    t0 = time.perf_counter()
    w3, V3 = rt.eigsh(
        A3, k=4,
        M=rt.DiagonalOperator(torch.as_tensor(mlump, dtype=torch.float64,
                                              device=device)),
        sigma=0.0, which="LM", tol=1e-8, inner_psolve=amg.psolve,
        cfg=rt.RBLConfig(device=device),
    )
    el = time.perf_counter() - t0
    R3 = A3 @ V3 - (mlump[:, None] * V3) * w3[None, :]
    resid = float(np.linalg.norm(R3, axis=0).max())
    print(f"  eigenvalues: {np.array2string(w3, precision=6)}")
    print(f"  max residual: {resid:.2e}  {el:.2f}s")
    out.update(elastic3d=w3, elastic3d_residual=resid, amg3d=amg)
    out["walls"]["elastic3d"] = el
    return out


if __name__ == "__main__":
    main()
