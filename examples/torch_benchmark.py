"""Benchmark harness on the PyTorch port — examples/benchmark.py (the
reference's benchmark.jl) through rbl_tpu_torch.

Loads a SuiteSparse matrix (or builds a synthetic Laplacian or a 3-D
elasticity stiffness), runs rbl across a block-size sweep, cross-checks
against scipy's ARPACK (`eigsh` on the host, the reference's Arpack.eigs
comparison — benchmark.jl:42) and prints the per-phase timing report.

Usage:
  python examples/torch_benchmark.py [--matrix path.mtx] [--k 100] [--blocks 1,2,4,8]
  python examples/torch_benchmark.py --laplacian 512   # 512x512 grid, n=262144
  python examples/torch_benchmark.py --fem3d 42 --blocks 4,8 --tol 1e-3
  python examples/torch_benchmark.py --laplacian 24 --k 5 --device cpu

It runs on the CUDA card (and raises without one) unless given
``--device cpu``; f32 on the card, f64 on the CPU or with ``--f64``.

On a grid with repeated eigenvalues (the square Laplacian) ARPACK's
single-vector Lanczos can miss one copy of a double eigenvalue, so the
"RBL vs ARPACK" line measures ARPACK there, not RBL: hold RBL to the
analytic or dense spectrum instead.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    """Run the sweep; returns ({b: [(LanczosResult, wall seconds) for each
    repeat]}, the operator the solves ran on)."""
    p = argparse.ArgumentParser()
    p.add_argument("--matrix", help=".mtx or .mat file (SuiteSparse)")
    p.add_argument("--laplacian", type=int, default=0, help="2D grid side")
    p.add_argument("--fem3d", type=int, default=0,
                   help="assemble a real 3D elasticity stiffness matrix on "
                        "an N^3 hex mesh (the ldoor/hood SuiteSparse family). "
                        "N=42 is hood-class (233k dof), N=64 ldoor-class (0.8M)")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--permute", action="store_true",
                   help="apply a random symmetric permutation first — the "
                        "worst-case irregular ordering (destroys diagonal "
                        "and block locality)")
    p.add_argument("--rcm", action="store_true",
                   help="apply reverse-Cuthill-McKee bandwidth reduction "
                        "first — the standard preprocessing for "
                        "irregularly-ordered matrices")
    p.add_argument("--blocks", default="4")
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--arpack", action="store_true", help="cross-check with scipy eigsh")
    p.add_argument("--repeat", type=int, default=2,
                   help="solves per block size; the first also pays the "
                        "kernels' first-use build and the CUDA context, "
                        "so the last repeat is the warm number")
    p.add_argument("--f64", action="store_true",
                   help="full f64 (the default on the CPU)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.config import resolve_device
    from rbl_tpu_torch.utils.profiling import Timer

    device = resolve_device(args.device)
    use_f64 = args.f64 or device.type == "cpu"
    dtype = torch.float64 if use_f64 else torch.float32

    def _reorder(A, label):
        import scipy.sparse as sp_

        if args.permute:
            perm = np.random.default_rng(0).permutation(A.shape[0])
            P = sp_.csr_matrix(
                (np.ones(len(perm)), (np.arange(len(perm)), perm)),
                shape=A.shape,
            )
            A = (P @ A @ P.T).tocsr()
            label += " [random-permuted]"
        if args.rcm:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)
            A = A.tocsr()[perm][:, perm].tocsr()
            label += " [RCM]"
        return A, label

    if args.matrix:
        from rbl_tpu_torch.utils.suitesparse import load_matrix

        A, label = _reorder(load_matrix(args.matrix), args.matrix)
        op = rt.as_operator(A, dtype=dtype, device=device)
    elif args.fem3d:
        from rbl_tpu_torch.utils.fem import fem_elasticity_3d

        A = fem_elasticity_3d(args.fem3d)
        A, label = _reorder(
            A, f"fem3d-elasticity-{args.fem3d}^3 (n={A.shape[0]}, nnz={A.nnz})"
        )
        op = rt.as_operator(A, dtype=dtype, device=device)
    elif args.laplacian:
        s = args.laplacian
        op = rt.Laplacian2D(s, s, dtype=dtype, device=device)
        A = None
        label = f"laplacian2d-{s}x{s}"
    else:
        p.error("need --matrix, --fem3d, or --laplacian")

    blocks = [int(x) for x in args.blocks.split(",")]

    # warm-up on a small random problem (benchmark.jl:57-58's JIT warm-up):
    # the CUDA context and the host eig's first call
    rt.rbl(np.abs(np.random.default_rng(0).standard_normal(64)) + 1.0, 2, 2,
           cfg=rt.RBLConfig(device=str(device)))

    results = {}
    for b in blocks:
        cfg = rt.RBLConfig(
            block_size=b, tol=args.tol,
            basis_dtype=dtype, compute_dtype=dtype,
            qr_method="auto" if use_f64 else "cholqr2",
            device=str(device),
        )
        results[b] = []
        for rep in range(max(args.repeat, 1)):
            timer = Timer(sync=False)
            t0 = time.perf_counter()
            res = rt.rbl(op, args.k, b, cfg=cfg, timer=timer)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt_solve = time.perf_counter() - t0
            results[b].append((res, dt_solve))
            tag = "cold" if rep == 0 else "warm"
            print(
                f"[RBL b={b} {tag}] {label}: {dt_solve:.3f}s, "
                f"converged={res.converged}, kryl={res.kryl_dim}, "
                f"largest={res.eigenvalues[0]:.6e}, "
                f"smallest={res.eigenvalues[-1]:.6e}"
            )
        print(timer.report())

    if args.arpack:
        import scipy.sparse.linalg as spla

        if A is None:
            from rbl_tpu_torch.utils.suitesparse import laplacian_2d

            A = laplacian_2d(args.laplacian, args.laplacian)
        t0 = time.perf_counter()
        d = spla.eigsh(A, k=args.k, which="LM", tol=args.tol,
                       return_eigenvectors=False)[::-1]
        print(f"[ARPACK eigsh] {time.perf_counter() - t0:.3f}s, "
              f"largest={d[0]:.6e}, smallest={d[-1]:.6e}")
        rel = np.abs((res.eigenvalues - d) / d)
        print(f"max |rel diff| RBL vs ARPACK: {rel.max():.3e}")
    return results, op


if __name__ == "__main__":
    main()
