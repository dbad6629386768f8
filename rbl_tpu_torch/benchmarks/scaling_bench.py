"""Scaling benchmark — the sharded Lanczos step across mesh sizes.

The port's counterpart of ``benchmarks/scaling_bench.py``, with the same
flags, lines and JSON lines.  The JAX script ran on 8 virtual CPU devices
sharing the host's cores; the port spawns 8 ranks of one gloo process
group, each a process, sharing one card (or, with ``--device cpu``, the
CPU), and runs every mesh size on the first 1, 2, 4 and 8 of them.  NCCL takes one rank a card, so every size runs over
gloo and the sizes compare like with like.  Ranks sharing a device
time-slice it, so the honest metric is the serialization-normalized
efficiency ndev·T(1)/T(ndev): how little the sharding machinery (halo
exchanges, all-reduced Grams) adds beyond the ndev-fold work.  On one
card a rank a card would measure true weak scaling.

1. The sharded step: one fused 2-iteration ``_sweep_chunk`` (a full scrub,
   then a local one; the halo-exchange stencil, ``cholqr2`` with
   all-reduced Grams) of ``ShardedLaplacian2D`` (ny = 256, n =
   rows-per-dev·ndev), timed over ``--reps`` back-to-back calls ending in
   a synchronize.  Its T blocks are replicated state and must be bitwise
   equal on every rank.
2. ``ShardedCooSpMM`` on a banded matrix (bandwidth 64), boundary-only
   ghost rows against an all-gather of X, at the largest mesh.
3. The comm-growth table at 2, 4 and 8 ranks on one fixed banded matrix
   (bandwidth 256): the COO apply's time and ghost rows
   (``comm_rows_per_apply``), and the packed BSR plan's ghost blocks,
   ``comm_blocks_per_apply()`` (each rank's Σ caps) × ndev, which is the
   JAX script's ``sum(bsr.caps) * ndev``.

Every branch the ranks take on a clock goes through ``RowMesh.agree``;
rank 0 prints.  The apply times are ``spmm_bench.time_apply``'s marginal,
each rank normalizing the chain by its own first rows.

    python -m rbl_tpu_torch.benchmarks.scaling_bench [--rows-per-dev 32768]
        [--b 8] [--basis-cols 128] [--reps 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIZES = (1, 2, 4, 8)
NY = 256
TIMEOUT_S = 900.0  # a job that outlives it (a deadlock) is killed
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-dev", type=int, default=32768)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--basis-cols", type=int, default=128)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    return p


def step_arrays(rng, n: int, b: int):
    """The step's inputs, as the JAX script draws them: orthonormal Qi and
    Qprev (n, b) and Bi (b, b), in f64."""
    Qi = np.linalg.qr(rng.standard_normal((n, b)))[0]
    Qprev = np.linalg.qr(rng.standard_normal((n, b)))[0]
    return Qi, Qprev, rng.standard_normal((b, b))


def sharded_step(mesh, nx: int, ny: int, arrays, basis_cols: int,
                 dtype=torch.float32):
    """A zero-argument call of one fused 2-iteration ``_sweep_chunk`` of
    ``ShardedLaplacian2D(nx, ny)`` on this rank, from the global
    ``arrays`` (``step_arrays``).  It returns (basis, Qi, Qprev, Bi, TB)."""
    from ..parallel.dist_spmm import ShardedLaplacian2D
    from ..solver.lanczos import _sweep_chunk

    op = ShardedLaplacian2D(nx=nx, ny=ny, mesh=mesh, dtype=dtype)
    Qi, Qprev, Bi = (torch.from_numpy(a).to(dtype) for a in arrays)
    basis = torch.zeros((mesh.local_rows(nx * ny), basis_cols), dtype=dtype,
                        device=mesh.device)
    Qi, Qprev = mesh.shard_rows(Qi), mesh.shard_rows(Qprev)
    Bi = Bi.to(mesh.device)

    def step():
        return _sweep_chunk(op, basis, Qi, Qprev, Bi, 0, None, cdt=dtype,
                            qr_method="cholqr2", nsteps=2,
                            reorth_pattern=(True, False), loc_passes=2,
                            mesh=mesh)

    return step


def banded(rng, n: int, bw: int):
    """Symmetric f32 CSR with diagonals 0, ±1, ±bw, drawn as the JAX
    script draws them."""
    import scipy.sparse as sp

    diags = [rng.standard_normal(n) for _ in range(5)]
    A = sp.diags(diags, [0, 1, -1, bw, -bw], (n, n)).tocsr().astype(np.float32)
    return ((A + A.T) * 0.5).tocsr()


def comm_row(A, mesh, b: int):
    """The comm-growth row's counts at ``mesh.size`` ranks: the ghost-row
    COO operator (returned, to be timed) and a dict with
    ``coo_ghost_rows``, ``bsr_ghost_blocks`` and ``bsr_ghost_kb`` (or
    ``bsr_error``).  Host plans only: no collective."""
    from ..parallel.dist_spmm import ShardedBlockSparseOperator, ShardedCooSpMM

    coo = ShardedCooSpMM.from_scipy(A, mesh, dtype=torch.float32,
                                    exchange="ghost")
    row = {"coo_ghost_rows": int(coo.comm_rows_per_apply())}
    try:
        bsr = ShardedBlockSparseOperator.from_scipy(A, mesh,
                                                    dtype=torch.float32)
        gblocks = bsr.comm_blocks_per_apply() * mesh.size
        row["bsr_ghost_blocks"] = gblocks
        row["bsr_ghost_kb"] = round(gblocks * bsr.bk * b * 4 / 1024, 1)
    except ValueError as e:
        row["bsr_error"] = str(e)[:80]
    return coo, row


def run_legs(args, device):
    """Every leg on the initialized process group, the mesh sizes on its
    first 1, 2, 4, 8 ranks (every rank draws every array, so that each
    generator stays in the JAX script's order).  Returns, on rank 0, the
    JSON objects printed and one dict a mesh size (``ndev``, ``n``,
    ``step_ms``, ``equal_across_ranks``: the step's T blocks bitwise
    equal on its ranks); None on the other ranks."""
    import torch.distributed as dist

    from ..parallel.mesh import make_row_mesh
    from .dma_stream_bench import sync
    from .spmm_bench import time_apply

    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = [s for s in SIZES if s <= world]
    groups = {s: dist.new_group(list(range(s))) for s in sizes}
    meshes = {s: make_row_mesh(s, device=device, group=groups[s])
              for s in sizes if rank < s}
    b, rows_per_dev = args.b, args.rows_per_dev
    out, steps = [], []

    def say(line):
        if rank == 0:
            print(line, flush=True)

    # ---- 1. the sharded step --------------------------------------------
    results = []
    for ndev in sizes:
        nx = (rows_per_dev // NY) * ndev
        n = nx * NY
        rng = np.random.default_rng(0)
        arrays = step_arrays(rng, n, b)
        if ndev in meshes:
            mesh = meshes[ndev]
            step = sharded_step(mesh, nx, NY, arrays, args.basis_cols)
            res = step()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                res = step()
            sync(device)
            dt = (time.perf_counter() - t0) / args.reps
            TB = res[-1]
            equal = mesh.agree(bool(torch.equal(mesh.all_reduce_min(TB), TB)))
            results.append((ndev, n, dt))
            eff_ser = results[0][2] * ndev / dt * 100
            say(f"devices={ndev}: n={n:>9}  step={dt*1e3:8.2f} ms  "
                f"serialization-normalized eff={eff_ser:6.1f}%")
            steps.append({"ndev": ndev, "n": n, "step_ms": dt * 1e3,
                          "equal_across_ranks": equal})
        dist.barrier()
    last = results[-1] if rank == 0 else None
    if rank == 0:
        eff = results[0][2] * last[0] / last[2]
        line = {
            "metric": f"sharding_eff_virtual_{last[0]}dev",
            "value": round(eff, 3), "unit": "x",
            "note": (f"ndev*T(1)/T(ndev) on gloo ranks sharing one "
                     f"{'card' if device.type == 'cuda' else 'CPU'}"),
        }
        say(json.dumps(line))
        out.append(line)

    # ---- 2. general sparse: boundary-only ghosts against an all-gather --
    ndev = sizes[-1]
    n = rows_per_dev * ndev
    A = banded(rng, n, 64)
    Xs = rng.standard_normal((n, b))
    if ndev in meshes:
        mesh = meshes[ndev]
        Xl = mesh.shard_rows(torch.from_numpy(Xs).to(torch.float32))
        from ..parallel.dist_spmm import ShardedCooSpMM

        for exch in ("ghost", "allgather"):
            op = ShardedCooSpMM.from_scipy(A, mesh, dtype=torch.float32,
                                           exchange=exch)
            comm = op.comm_rows_per_apply()
            dt = time_apply(op, Xl, args.reps, agree=mesh.agree)
            say(f"coo-{exch:>9}: {dt*1e3:8.2f} ms/apply  "
                f"comm_rows={comm} ({comm/n:.1%} of n)")
            line = {"metric": f"sharded_coo_{exch}_{ndev}dev",
                    "value": round(dt * 1e3, 3), "unit": "ms",
                    "comm_rows": int(comm)}
            say(json.dumps(line))
            out.append(line)
    dist.barrier()

    # ---- 3. the comm-growth table on one fixed banded matrix ------------
    n_fix = rows_per_dev * sizes[-1]
    bw_fix = 256  # two 128-column block neighbours
    A_fix = banded(rng, n_fix, bw_fix)
    say("\ncomm-growth table (fixed n=%d, band=%d):" % (n_fix, bw_fix))
    for ndev in (2, 4, 8):
        if ndev > sizes[-1]:
            break
        Xs = rng.standard_normal((n_fix, b))
        if ndev in meshes:
            mesh = meshes[ndev]
            coo, counts = comm_row(A_fix, mesh, b)
            Xl = mesh.shard_rows(torch.from_numpy(Xs).to(torch.float32))
            dt = time_apply(coo, Xl, args.reps, agree=mesh.agree)
            line = {"metric": f"comm_growth_{ndev}dev",
                    "coo_ms_per_apply": round(dt * 1e3, 3), **counts}
            say(json.dumps(line))
            out.append(line)
        dist.barrier()
    return (out, steps) if rank == 0 else None


def _worker(rank: int, world: int, port: str, outdir: str, spec: str) -> None:
    from ..parallel.distributed import initialize_cluster, shutdown_cluster

    args = argparse.Namespace(**json.loads(spec))
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.set_float32_matmul_precision("highest")
    initialize_cluster(f"localhost:{port}", world, rank, device=device,
                       backend="gloo", timeout_s=TIMEOUT_S)
    got = run_legs(args, device)
    shutdown_cluster()
    if rank == 0:
        with open(os.path.join(outdir, "scaling.json"), "w") as f:
            json.dump(got, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Spawn the ranks and run every leg; returns rank 0's ``run_legs``:
    the JSON objects printed and the step's dict a mesh size."""
    from ..config import resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    world = SIZES[-1]
    spec = json.dumps(dict(vars(args), device=str(device)))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as d:
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rbl_tpu_torch.benchmarks.scaling_bench",
             "--worker", str(r), str(world), port, d, spec],
            env=env, start_new_session=True) for r in range(world)]
        deadline = time.monotonic() + TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"scaling_bench: the {world} ranks outlived "
                               f"{TIMEOUT_S} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"scaling_bench: ranks {failed} failed")
        with open(os.path.join(d, "scaling.json")) as f:
            out, steps = json.load(f)
    return out, steps


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                sys.argv[6])
    else:
        main()
