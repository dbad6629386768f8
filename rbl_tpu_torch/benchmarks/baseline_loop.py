"""Reference-shaped solver loop, the live baseline of ``bench_torch.py``
(port of ``benchmarks/baseline_loop.py``).

The reference's iteration STRUCTURE (RBL_gpu.jl:134-203) on the port's
numerics: a separate set of launches for each numeric phase of each
iteration, the b×b coupling blocks pulled to the host every iteration for
T's assembly, the partial reorthogonalization as a Python loop over the
older blocks at cadence 2 (RBL_gpu.jl:63-71), an eig and convergence poll
on the host every 4th iteration (RBL_gpu.jl:186-192), and the basis kept
as a Python list of blocks.  The numerics are the port's solver's (the
same CGS projections, QR, banded Rayleigh-Ritz and convergence bound); only
the orchestration differs, and the orchestration is what it measures: no
phase is fused, batched or captured in a graph.

Run:  python -m rbl_tpu_torch.benchmarks.baseline_loop [--nx 512] [--k 50]
      [--b 8] [--trials 2] [--device cpu]
Import: ``reference_shaped_solve(op, k, b, ...)``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.band import BlockTridiagonalT
from ..ops.contract import gram
from ..ops.eig import check_convergence, eig_banded_host, sort_eig_abs
from ..ops.qr import block_qr
from ..ops.reorth import project_out
from ..ops.spmm.operator import dot


def _start_block(op, gen: torch.Generator, b: int, qr_method: str):
    """Q₁ = qr(A·Ω).Q with Ω ~ N(0,1)ⁿˣᵇ drawn from ``gen``."""
    omega = torch.randn((op.shape[0], b), generator=gen, dtype=op.dtype,
                        device=op.device)
    Q, _ = block_qr(op.apply(omega), method=qr_method)
    return Q


def _project_pair(Qold, Qi, Qprev):
    """One step of the reference's per-older-block partial reorth: project
    the two newest blocks against ONE stored block (part_reorth_gpu!,
    RBL_gpu.jl:29-57), launched apart for each block, as the reference
    loops (RBL_gpu.jl:63-71)."""
    return project_out(Qold, Qi), project_out(Qold, Qprev)


def _loc_reorth(Qi, Qprev, qr_method: str):
    """loc_reorth! intended semantics (RBL.jl:4-13): CGS against the
    previous block, then re-orthonormalize."""
    Q, _ = block_qr(project_out(Qprev, Qi), method=qr_method)
    return Q


def _three_term(op, Qi, Qprev, Bi, qr_method: str):
    """One recurrence step (RBL_gpu.jl:176-184): SpMM, two projections,
    QR.  Returns the new block and the b×b couplings (pulled to the host
    by the caller each iteration, like the reference's Array(Ai)/fact.R)."""
    U = op.apply(Qi) - dot(Qprev, Bi.T, Qi.dtype)
    Ai = gram(Qi, U)
    U = U - dot(Qi, Ai, Qi.dtype)
    Qn, Bn = block_qr(U, method=qr_method)
    return Qn, Ai, Bn


def reference_shaped_solve(op, k, b, tol=1e-3, max_kryl=768, seed=0,
                           qr_method="cholqr2"):
    """Solve with the reference's orchestration shape on ``op``'s device.
    Returns (eigenvalues descending by |λ|, iterations)."""
    gen = torch.Generator(device=op.device)
    gen.manual_seed(seed)
    Qi = _start_block(op, gen, b, qr_method)
    Qprev = torch.zeros_like(Qi)
    Bi = torch.zeros((b, b), dtype=Qi.dtype, device=Qi.device)
    T = BlockTridiagonalT(b, max_kryl)
    Q_list = []  # the reference's push!(Q, ...) basis archive
    w = V = None
    i = 0
    while (i + 1) * b <= max_kryl:
        i += 1
        if i > 1:
            if i % 2 == 0:  # partial reorth cadence 2 (RBL_gpu.jl:164)
                for Qold in Q_list[:-1]:  # per-block loop (RBL_gpu.jl:63-71)
                    Qi, Qprev = _project_pair(Qold, Qi, Qprev)
            Qi = _loc_reorth(Qi, Qprev, qr_method)
        Q_list.append(Qi)
        Qn, Ai, Bn = _three_term(op, Qi, Qprev, Bi, qr_method)
        # per-iteration D→H pull of the couplings (RBL_gpu.jl:159-161,185)
        T.append_diag(Ai.cpu().numpy().astype(np.float64))
        Bn_h = Bn.cpu().numpy().astype(np.float64)
        Qprev, Qi, Bi = Qi, Qn, Bn
        if i * b > k and i % 4 == 0:  # eig poll cadence 4 (RBL_gpu.jl:186)
            w_all, V_all = eig_banded_host(T.view(i * b))
            w, V = sort_eig_abs(w_all, V_all, k)
            if check_convergence(Bn_h, V, b, k, tol * np.abs(w).max()):
                break
        T.set_subdiag(Bn_h, i - 1)
    if w is None:
        w_all, V_all = eig_banded_host(T.view(i * b))
        w, V = sort_eig_abs(w_all, V_all, k)
    return np.asarray(w)[::-1], i


def main(argv=None):
    import argparse

    from ..config import resolve_device
    from ..ops.spmm.operator import Laplacian2D

    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--trials", type=int, default=2)
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    op = Laplacian2D(args.nx, args.nx, dtype=torch.float32, device=device)
    reference_shaped_solve(op, args.k, args.b)  # warm-up (benchmark.jl:57-58)
    times = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        w, iters = reference_shaped_solve(op, args.k, args.b)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    nx = args.nx
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(w)]
    print(f"reference-shaped loop: best {min(times):.3f} s "
          f"(trials: {[f'{t:.3f}' for t in times]}), {iters} iterations, "
          f"max rel err {np.max(np.abs(w - lam) / lam):.3e}")


if __name__ == "__main__":
    main()
