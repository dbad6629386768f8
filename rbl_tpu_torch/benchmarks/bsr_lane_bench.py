"""Packed-BSR block-width and panel-layout sweep on the card.

The port's counterpart of ``benchmarks/bsr_lane_bench.py``, with the same
flags and JSON lines, on blocky-64k (4,096 block-rows of 16×16 dense
blocks, ~14 a row after symmetrization) in f32:

1. Block width: the auto-planned packed operator at b = 8, 16, 32, 64,
   128, the widths of the polish filters, the SVD and the AMG call sites.
   The padded X is b/4 MiB here, so b ≤ 32 runs the resident entry point
   (B1; b = 32 is exactly its 8 MiB) and b = 64, 128 the streaming one
   (B2): the same CUDA kernel either way.
2. Panel layout at b = 8 (``panel=True``, the kernel B4) with
   ``panel_gather`` "concat" and "swap".  The two gathers were two ways
   for the TPU to assemble the stacked X operand; on the card both launch
   the same B4 kernel (``ops/spmm/bsr.py``: ``bsr_spmm_panel``), so the
   two rows time one kernel, and their outputs must be bitwise equal.

Every variant is first held to scipy: max |y − A·x| / max |A·x| < 1e-5
(the JAX script's assert), raising otherwise.  Times: the marginal apply
(``spmm_bench.time_apply``) on the solver's column-major block layout.

Data: a fresh ``np.random.default_rng(0)`` draws blocky-64k, the (n, 8)
check block, then one X per width, as the JAX script does.

    python -m rbl_tpu_torch.benchmarks.bsr_lane_bench [--reps 50]
        [--widths 8 16 32 64 128] [--blocky-n 65536] [--device cpu]

The card is the default; ``--blocky-n`` shrinks the fixture for the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .spmm_bench import blocky_matrix, solver_block, time_apply

TOL = 1e-5  # max |y − A·x| / max |A·x|, the JAX script's


def _check(y, ref, scale, what) -> None:
    """Raise unless max |y − ref| / ``scale`` < TOL."""
    err = float(np.abs(y - ref).max() / scale)
    if not err < TOL:
        raise AssertionError(f"{what}: relative error {err:.3e} ≥ {TOL:g} "
                             "against scipy")


def main(argv=None):
    """Run both sweeps; returns the JSON objects printed, in order."""
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--widths", type=int, nargs="*",
                   default=[8, 16, 32, 64, 128])
    p.add_argument("--blocky-n", type=int, default=65536,
                   help="rows of the blocky fixture (a multiple of 16)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import rbl_tpu_torch as rt
    from ..config import resolve_device

    dev = resolve_device(args.device)
    tag = f"blocky{args.blocky_n // 1024}k"
    rng = np.random.default_rng(0)
    G = blocky_matrix(rng, args.blocky_n)
    n = G.shape[0]

    op = rt.BlockSparseOperator.from_scipy(G, dtype=torch.float32, device=dev)
    tile_bytes = op.vals.numel() * 4
    print(f"plan: bm={op.bm} U={op.unroll} H={op.H} "
          f"padded tiles {tile_bytes/1e9:.2f} GB", flush=True)

    Xc = rng.standard_normal((n, 8)).astype(np.float32)
    ref = G @ Xc
    scale = float(np.abs(ref).max())
    out = []

    # ---- 1. block width on the auto-planned packed operator -------------
    for b in args.widths:
        X = solver_block(rng.standard_normal((n, b)).astype(np.float32), dev)
        y = op.apply(solver_block(Xc[:, :1].repeat(b, axis=1), dev)).cpu().numpy()
        _check(y[:, 0], ref[:, 0], scale, f"b={b}")
        dt = time_apply(op, X, args.reps)
        line = {"metric": f"bsr_{tag}_b{b}", "ms": round(dt * 1e3, 3),
                "tile_gbps": round(tile_bytes / dt / 1e9, 1),
                "nnz_per_s_e9": round(G.nnz / dt / 1e9, 2)}
        print(json.dumps(line), flush=True)
        out.append(line)

    # ---- 2. the panel layout at b = 8, both gathers ---------------------
    opp = rt.BlockSparseOperator.from_scipy(
        G, dtype=torch.float32, bm=op.bm, unroll=op.unroll, panel=True,
        device=dev)
    Xp = solver_block(Xc, dev)
    ys = {}
    for gather in ("concat", "swap"):
        pop = dataclasses.replace(opp, panel_gather=gather)
        ys[gather] = pop.apply(Xp)
        _check(ys[gather].cpu().numpy(), ref, scale, f"panel {gather}")
        dt = time_apply(pop, Xp, args.reps)
        line = {"metric": f"bsr_{tag}_panel_{gather}_b8",
                "ms": round(dt * 1e3, 3),
                "tile_gbps": round(tile_bytes / dt / 1e9, 1)}
        print(json.dumps(line), flush=True)
        out.append(line)
    if not torch.equal(ys["concat"], ys["swap"]):
        raise AssertionError("the panel gathers 'concat' and 'swap' gave "
                             "different outputs")
    return out


if __name__ == "__main__":
    main()
