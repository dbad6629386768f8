"""SpMM format benchmark — nnz/s per sparse layout on the card.

The port's counterpart of ``benchmarks/spmm_bench.py``, with the same
flags, rows, printed lines and JSON line (``spmm_best_gnnz_per_s``).  It
times every operator layout of the port (the matrix-free stencil, DIA,
packed BSR, ELL, HYB, COO) on structurally matched problems, in f32 at
block width ``--b``:

  stencil-2d               Laplacian2D on the largest square grid ≤ n
  dia, bsr-pallas, ell-scan  a banded 9-diagonal matrix of n rows
  bsr-fem3d, bsr128-fem3d, dia-fem3d, auto-fem3d
                           fem_elasticity_3d(30) (n = 86,490, 6.6 M
                           nonzeros), the auto plan and bm = 128
  bsr-blocky, bsr128-blocky  "blocky-64k": 16×16 dense node blocks
                           scattered over 4,096 block-rows
  hyb(skew), coo-segsum(skew)  mean ~16 nonzeros a row and 8 rows
                           half full

The rows keep the JAX package's names: ``bsr-pallas`` and ``bsr128-*``
are the port's packed operator (CUDA kernel B1, or B2 when the padded X
exceeds 8 MiB: never at the default sizes), ``ell-scan`` its ELL gather,
``coo-segsum`` its COO scatter-add.

Every layout is timed on the block layout the solver hands it: an (n, b)
block in column-major order (the transpose of a contiguous (b, n)
tensor), as the solver's basis slices are.  ELL, COO and HYB gather rows
of X, and on a row-major block they ran 8× slower on the card
(``tools/profile_layouts.py``).

Timing (``time_apply``): applies chained through z ← A·y, y ← z / ‖z[:1024]‖,
the marginal cost between ``reps`` and ``4·reps`` chained applies
(``dma_stream_bench.marginal_seconds``), each run ending in a synchronize.

Data: one ``np.random.default_rng(0)`` draws, in the JAX script's order, X
(n, b), the stencil's X, the banded diagonals, fem3d's X, the blocky
blocks and values, blocky's X, the skew triplets; each fixture function
takes that generator.

    python -m rbl_tpu_torch.benchmarks.spmm_bench [--n 262144] [--b 8]
        [--reps 50] [--matrix path.mtx] [--fem 30] [--blocky-n 65536]
        [--device cpu]

The card is the default (``--device cpu`` for the tests); ``--fem`` and
``--blocky-n`` shrink the two fixtures the JAX script sizes itself.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .dma_stream_bench import marginal_seconds

BANDED_OFFSETS = (0, 1, -1, 128, -128, 256, -256, 4096, -4096)


def time_apply(op, X, reps: int, *, clock=time.perf_counter, agree=bool):
    """Marginal seconds per apply of ``op`` to the (n, b) block ``X``:
    applies chained through y ← z / ‖z[:1024]‖, z = op.apply(y), so that
    no apply repeats another's inputs and f32 cannot overflow (the JAX
    step).  On a row mesh, each rank normalizes by its own first rows and
    passes its ``agree``."""

    def step(y):
        z = op.apply(y)
        return z / torch.linalg.vector_norm(z[:1024])

    return marginal_seconds(step, X, reps, clock=clock, agree=agree)


def solver_block(a: np.ndarray, device) -> torch.Tensor:
    """The (n, b) host block ``a`` as an f32 tensor on ``device`` in the
    solver's column-major layout."""
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(device, torch.float32).T


# --- the fixtures, each drawing from the caller's generator ----------------

def stencil(rng, n: int, b: int):
    """The stencil's grid side (the largest square ≤ n) and its X."""
    side = int(np.sqrt(n))
    return side, rng.standard_normal((side * side, b)).astype(np.float32)


def banded_matrix(rng, n: int):
    """Symmetric 9-diagonal n×n f32 CSR (offsets 0, ±1, ±128, ±256,
    ±4096)."""
    import scipy.sparse as sp

    offs = list(BANDED_OFFSETS)
    A = sp.diags([rng.standard_normal(n) for _ in offs], offs, (n, n))
    return ((A + A.T) * 0.5).tocsr().astype(np.float32)


def fem3d(nx: int = 30):
    """fem_elasticity_3d(nx) in f32 (nx = 30: n = 86,490, 6.6 M nonzeros);
    draws nothing."""
    from ..utils.fem import fem_elasticity_3d

    return fem_elasticity_3d(nx).astype(np.float32)


def blocky_matrix(rng, n: int = 65536):
    """"blocky-64k": n/16 block-rows of dense 16×16 f32 blocks, 7 random
    block columns a row, symmetrized in pattern (~14 a row)."""
    import scipy.sparse as sp

    if n % 16:
        raise ValueError(f"blocky: n={n} is not a multiple of 16")
    nbn = n // 16
    bpr = 7
    rb = np.repeat(np.arange(nbn), bpr)
    cb = rng.integers(0, nbn, rb.size)
    key = np.unique(
        np.concatenate([rb, cb]).astype(np.int64) * nbn
        + np.concatenate([cb, rb])
    )
    rb, cb = key // nbn, key % nbn
    ii = (rb[:, None, None] * 16 + np.arange(16)[None, :, None]
          ).repeat(16, axis=2).ravel()
    jj = (cb[:, None, None] * 16 + np.arange(16)[None, None, :]
          ).repeat(16, axis=1).ravel()
    return sp.coo_matrix(
        (rng.standard_normal(ii.size).astype(np.float32), (ii, jj)),
        shape=(nbn * 16, nbn * 16),
    ).tocsr()


def skew_matrix(rng, n: int):
    """Symmetric f32 CSR with ~16 nonzeros a row and 8 rows half full,
    built from triplets."""
    import scipy.sparse as sp

    bulk = 8 * n
    heavy = rng.choice(n, 8, replace=False)
    hr = np.repeat(heavy, n // 2)
    hc = rng.integers(0, n, hr.size)
    r_ = np.concatenate([rng.integers(0, n, bulk), hr])
    c_ = np.concatenate([rng.integers(0, n, bulk), hc])
    v_ = rng.standard_normal(r_.size)
    S = sp.coo_matrix((v_, (r_, c_)), shape=(n, n))
    return ((S + S.T) * 0.5).tocsr().astype(np.float32)


def _row(rows, name, dt, gnnz):
    # print as we go: a run cut by its time limit keeps the finished rows
    print(f"  [row] {name:>14} {dt*1e3:9.3f} ms {gnnz:8.2f} Gnnz/s",
          flush=True)
    rows.append((name, dt, gnnz))


def _time_cases(rows, cases, X, nnz, reps, *, label=None, report=False,
                skippable=True):
    """Build and time each (name, constructor) of ``cases`` on X.  Where
    the JAX script skips a case whose constructor fails (``skippable``),
    a constructor that refuses the matrix (ValueError) is skipped."""
    for name, mk in cases:
        try:
            op = mk()
        except ValueError as e:
            if not skippable:
                raise
            print(f"{name:>12}: skipped ({e})")
            continue
        dt = time_apply(op, X, reps)
        if report:
            print(f"  {name}: {getattr(op, 'density_report', lambda: '')()}")
        _row(rows, name if label is None else label(name), dt, nnz / dt / 1e9)


def main(argv=None):
    """Time every layout and print the table and the JSON line.  Returns
    the rows (name, seconds, Gnnz/s) and the JSON object."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--matrix", help="optional .mtx/.mat to benchmark instead")
    p.add_argument("--fem", type=int, default=30,
                   help="fem_elasticity_3d size of the fem3d rows")
    p.add_argument("--blocky-n", type=int, default=65536,
                   help="rows of the blocky fixture (a multiple of 16)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import resolve_device
    from ..ops.spmm.coo import CooOperator, HybOperator

    dev = resolve_device(args.device)
    f32 = torch.float32
    n, b = args.n, args.b
    rng = np.random.default_rng(0)
    X = solver_block(rng.standard_normal((n, b)).astype(np.float32), dev)
    rows = []

    def bsr(A, **kw):
        return lambda: rt.BlockSparseOperator.from_scipy(A, dtype=f32,
                                                         device=dev, **kw)

    if args.matrix:
        from ..utils.suitesparse import load_matrix

        A = load_matrix(args.matrix).astype(np.float32)
        n = A.shape[0]
        X = solver_block(rng.standard_normal((n, b)).astype(np.float32), dev)
        _time_cases(rows, [
            ("bsr-pallas", bsr(A)),
            ("ell-scan", lambda: rt.SparseEllOperator.from_scipy(
                A, dtype=f32, device=dev)),
            ("auto", lambda: rt.as_operator(A, dtype=f32, device=dev)),
        ], X, A.nnz, args.reps)
    else:
        side, Xl = stencil(rng, n, b)
        lap = rt.Laplacian2D(side, side, dtype=f32, device=dev)
        dt = time_apply(lap, solver_block(Xl, dev), args.reps)
        _row(rows, "stencil-2d", dt, 5 * side * side / dt / 1e9)

        A = banded_matrix(rng, n)
        _time_cases(rows, [
            ("dia", lambda: rt.DiaOperator.from_scipy(A, dtype=f32, device=dev)),
            ("bsr-pallas", bsr(A)),
            ("ell-scan", lambda: rt.SparseEllOperator.from_scipy(
                A, dtype=f32, device=dev)),
        ], X, A.nnz, args.reps, skippable=False)

        # FEM-class problems, the matrices the BSR kernel exists for
        # (reference benchmark.jl:21-28 benchmarks ldoor/hood/audikw)
        F = fem3d(args.fem)
        Xf = solver_block(rng.standard_normal((F.shape[0], b)).astype(np.float32), dev)
        _time_cases(rows, [
            ("bsr-fem3d", bsr(F)),
            ("bsr128-fem3d", bsr(F, bm=128)),
            ("dia-fem3d", lambda: rt.DiaOperator.from_scipy(F, dtype=f32,
                                                            device=dev)),
            ("auto-fem3d", lambda: rt.as_operator(F, dtype=f32, device=dev)),
        ], Xf, F.nnz, args.reps, report=True)

        G = blocky_matrix(rng, args.blocky_n)
        Xg = solver_block(rng.standard_normal((G.shape[0], b)).astype(np.float32), dev)
        _time_cases(rows, [
            ("bsr-blocky", bsr(G)),
            ("bsr128-blocky", bsr(G, bm=128)),
        ], Xg, G.nnz, args.reps, report=True)

        # skewed rows: pure ELL would pad every row to n/2 (not run); HYB
        # caps the gather at the typical row length and spills to COO
        S = skew_matrix(rng, n)
        _time_cases(rows, [
            ("hyb", lambda: HybOperator.from_scipy(S, dtype=f32, device=dev)),
            ("coo-segsum", lambda: CooOperator.from_scipy(S, dtype=f32,
                                                          device=dev)),
        ], X, S.nnz, args.reps, label=lambda name: f"{name}(skew)",
            skippable=False)

    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={backend}  n={n}  b={b}")
    print(f"{'format':>12} {'ms':>9} {'Gnnz/s':>8}")
    for name, dt, gnnz in rows:
        print(f"{name:>12} {dt*1e3:9.3f} {gnnz:8.2f}")
    best = max(rows, key=lambda r: r[2])
    result = {
        "metric": "spmm_best_gnnz_per_s", "value": round(best[2], 3),
        "unit": "Gnnz/s", "format": best[0],
    }
    print(json.dumps(result))
    return rows, result


if __name__ == "__main__":
    main()
