#!/usr/bin/env python3
"""What the row mesh's transport takes and what its collectives cost.

    python3 tools/probe_mesh_transport.py [--reps 2000] [--b 8] [--out FILE]
    python3 tools/probe_mesh_transport.py --device cpu --reps 50   # smoke run

Two questions, each answered on the device given (default: the card):

1. Which collectives gloo runs on CUDA tensors.  torch.distributed's backend
   table lists gloo with CUDA tensors in all-reduce and broadcast only; the
   mesh (``rbl_tpu_torch/parallel/mesh.py``) stages what gloo cannot move
   (``RowMesh.stage_p2p``) through pinned host buffers.  Two gloo ranks sharing the device try each
   collective the mesh calls on device tensors of known values and check
   the result: all_reduce (SUM, MIN), broadcast, the list all_gather,
   all_gather_into_tensor and gather in one pair of processes, then
   batch_isend_irecv and send/recv each in a pair of their own (a rank
   that crashes or hangs there is killed at ``--timeout``).
2. What one collective costs.  One rank over NCCL (in this process; gloo
   on the CPU): ``RowMesh.all_reduce_sum`` of a b×b f32 tensor ``--reps``
   times, its host wall per call and the device time per call between two
   CUDA events, beside the same loop of the ``clone`` alone, and
   ``RowMesh.agree`` (one all-reduce and a host read).  Then two gloo
   ranks sharing the device: the all-reduce of a b×b tensor on the device
   and on the host, and ``RowMesh.exchange`` of a fem47 ghost slab
   (56 blocks of 128 rows, b columns, f32) as the mesh sends it, and
   ``RowMesh.gather_rows_host`` (a checkpoint's gather) of an (n, 100)
   f32 block at fem47's n to rank 0's host, checked there.

Prints one line a result and one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SUPPORT = ("all_reduce_sum", "all_reduce_min", "broadcast", "all_gather",
           "all_gather_into_tensor", "gather")
P2P = ("batch_isend_irecv", "send_recv")
GHOST_ROWS = 56 * 128  # the ghost slab of a fem47 band on two ranks
FEM47_N = 324_864


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pair(mode: str, args) -> dict:
    """Run ``mode`` on two gloo ranks; rank 0's JSON, or what went wrong."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", mode,
         str(r), port, args.device, str(args.reps), str(args.b)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True) for r in range(2)]
    t0 = time.monotonic()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, args.timeout - (time.monotonic() - t0))))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        return {"error": f"timed out after {args.timeout:.0f} s"}
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            tail = (err or out).strip().splitlines()[-1:] or [""]
            return {"error": f"rank {r} exited {p.returncode}: {tail[0][:200]}"}
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _attempt(fn) -> str:
    try:
        return "works" if fn() else "wrong result"
    except Exception as e:  # reported, not raised: the table is the result
        return f"raises {type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _support(rank: int, dev, res: dict) -> None:
    import torch
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    both = [torch.arange(4.0) + 10 * r for r in range(2)]

    def reduce(op, want):
        t = x.clone()
        dist.all_reduce(t, op=op)
        return torch.equal(t.cpu(), want)

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=1)
        return torch.equal(t.cpu(), both[1])

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return all(torch.equal(p.cpu(), w) for p, w in zip(parts, both))

    def all_gather_into_tensor():
        out = x.new_empty(8)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out.cpu(), torch.cat(both))

    def gather():
        parts = [torch.empty_like(x) for _ in range(2)] if rank == 0 else None
        dist.gather(x, parts, dst=0)
        return rank != 0 or all(torch.equal(p.cpu(), w)
                                for p, w in zip(parts, both))

    calls = dict(
        all_reduce_sum=lambda: reduce(dist.ReduceOp.SUM, both[0] + both[1]),
        all_reduce_min=lambda: reduce(dist.ReduceOp.MIN, both[0]),
        broadcast=broadcast, all_gather=all_gather,
        all_gather_into_tensor=all_gather_into_tensor, gather=gather)
    for name in SUPPORT:
        res[name] = _attempt(calls[name])
        dist.barrier()


def _p2p(mode: str, rank: int, dev, res: dict) -> None:
    import torch
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    other = 1 - rank
    want = torch.arange(4.0) + 10 * other

    def batch():
        recv = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, other), dist.P2POp(dist.irecv, recv, other)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(recv.cpu(), want)

    def send_recv():
        recv = torch.empty_like(x)
        if rank == 0:
            dist.send(x, other)
            dist.recv(recv, other)
        else:
            dist.recv(recv, other)
            dist.send(x, other)
        return torch.equal(recv.cpu(), want)

    res[mode] = _attempt(batch if mode == "batch_isend_irecv" else send_recv)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_call_us(fn, reps: int, dev) -> dict:
    """Host wall per call of ``fn`` over ``reps`` calls (synchronized at the
    ends), and on a card the device time per call between two events."""
    import torch

    for _ in range(min(reps, 50)):
        fn()
    _sync(dev)
    ev = None
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if ev is not None:
        ev[1].record()
    _sync(dev)
    out = {"host_us": 1e6 * (time.perf_counter() - t0) / reps}
    if ev is not None:
        out["device_us"] = 1e3 * ev[0].elapsed_time(ev[1]) / reps
    return out


def _timing_pair(rank: int, dev, mesh, reps: int, b: int, res: dict) -> None:
    import torch

    g_dev = torch.ones((b, b), dtype=torch.float32, device=dev)
    g_cpu = torch.ones((b, b), dtype=torch.float32)
    slab = torch.ones((GHOST_ROWS, b), dtype=torch.float32, device=dev)
    for name, fn in (("all_reduce_device", lambda: mesh.all_reduce_sum(g_dev)),
                     ("all_reduce_host", lambda: mesh.all_reduce_sum(g_cpu)),
                     ("exchange_ghost_slab", lambda: mesh.exchange(slab, 1))):
        mesh.barrier()
        res[name] = _per_call_us(fn, reps if name != "exchange_ghost_slab"
                                 else max(reps // 10, 5), dev)
    res["ghost_slab_bytes"] = GHOST_ROWS * b * 4
    # a checkpoint's gather: every rank's rows of an (n, 100) f32 block
    # (fem47's n) to rank 0's host, one slab at a time
    import numpy as np

    n, cols = FEM47_N, 100
    lo, hi = mesh.row_range(n)
    V = torch.arange(lo, hi, dtype=torch.float32, device=dev)[:, None]
    V = V.repeat(1, cols)
    mesh.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    whole = mesh.gather_rows_host(V, n)
    res["gather_rows_host_s"] = time.perf_counter() - t0
    res["gather_rows_host_bytes"] = n * cols * 4
    if rank == 0:
        res["gather_rows_host"] = (
            "works" if whole.shape == (n, cols)
            and np.array_equal(whole[:, 0], np.arange(n, dtype=np.float32))
            and np.array_equal(whole[:, -1], whole[:, 0]) else "wrong result")
    res["stage_p2p"] = mesh.stage_p2p


def rank_worker(argv) -> int:
    mode, rank, port, device, reps, b = (argv[0], int(argv[1]), argv[2],
                                         argv[3], int(argv[4]), int(argv[5]))
    import torch
    import torch.distributed as dist

    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh

    torch.set_num_threads(1)
    dev = initialize_cluster(f"localhost:{port}", 2, rank, device=device,
                             backend="gloo", timeout_s=60)
    res: dict = {}
    if mode == "support":
        _support(rank, dev, res)
    elif mode in P2P:
        _p2p(mode, rank, dev, res)
    else:
        _timing_pair(rank, dev, make_row_mesh(2, device=dev), reps, b, res)
    dist.barrier()
    shutdown_cluster()
    print(json.dumps(res))
    return 0


def one_rank_timing(args) -> dict:
    import torch

    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh

    dev = initialize_cluster(f"localhost:{_free_port()}", 1, 0,
                             device=args.device, timeout_s=60)
    mesh = make_row_mesh(1, device=dev)
    g = torch.ones((args.b, args.b), dtype=torch.float32, device=dev)
    out = dict(backend=mesh.backend,
               clone=_per_call_us(lambda: g.clone(), args.reps, dev),
               all_reduce=_per_call_us(lambda: mesh.all_reduce_sum(g),
                                       args.reps, dev),
               agree=_per_call_us(lambda: mesh.agree(True), args.reps // 4, dev))
    shutdown_cluster()
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank-worker":
        return rank_worker(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--b", type=int, default=8, help="block width")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a pair of ranks may take")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    res: dict = dict(torch=torch.__version__, device=args.device)
    if args.device.startswith("cuda"):
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    support = _pair("support", args)
    for mode in P2P:
        r = _pair(mode, args)
        support[mode] = r.get(mode, r.get("error"))
    res["gloo_support"] = support
    for name, v in support.items():
        print(f"gloo {name} on {args.device} tensors: {v}")
    res["one_rank"] = one_rank_timing(args)
    print(f"one rank ({res['one_rank']['backend']}): {res['one_rank']}")
    res["two_ranks_gloo"] = _pair("timing", args)
    print(f"two gloo ranks on {args.device}: {res['two_ranks_gloo']}")
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
