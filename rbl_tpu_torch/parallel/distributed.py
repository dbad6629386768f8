"""Multi-process set-up on torch.distributed (port of
``rbl_tpu/parallel/distributed.py``).

One process a rank, one ``initialize_cluster()`` call a process, then the
same solver code on every rank with ``RBLConfig(mesh=make_row_mesh())``:
each rank holds its slab of A's rows, of every (n, b) block and of the
basis, and the solver reduces over rows with explicit collectives
(``parallel/mesh.py``).

Launch under torchrun (one process a card; torchrun sets the rendezvous
environment, so no arguments are needed)::

    torchrun --nproc-per-node 4 solve.py

    # solve.py
    from rbl_tpu_torch.parallel.distributed import initialize_cluster
    from rbl_tpu_torch.parallel.mesh import make_row_mesh
    import rbl_tpu_torch as rtt

    initialize_cluster()                       # NCCL on the card
    mesh = make_row_mesh()
    op = ShardedBlockSparseOperator.from_scipy(A, mesh)
    res = rtt.rbl(op, k=100, cfg=rtt.RBLConfig(mesh=mesh, block_size=8))
    # res.eigenvectors holds this rank's rows; mesh.gather_rows gives all

or by hand, with the address given explicitly::

    initialize_cluster("localhost:29500", num_processes=2, process_id=rank,
                       device="cpu")            # gloo CPU ranks

The backend is NCCL for a CUDA device and gloo for the CPU.  NCCL refuses
two ranks on one card; ``backend="gloo"`` runs them there, with the
point-to-point exchanges staged through the host (``RowMesh.stage_p2p``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import resolve_device


def initialize_cluster(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    device=None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> torch.device:
    """Join the process group of a multi-process run; returns this rank's
    device.

    ``coordinator`` is ``host:port`` of rank 0 (None: the environment's
    ``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets them);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  ``local_device_ids`` picks this process's card (its first
    entry; default: ``LOCAL_RANK`` modulo the card count).  ``device``
    None means the card and raises without one; ``device="cpu"`` makes a
    CPU rank.  The backend is NCCL for a card and gloo for the CPU;
    ``backend="gloo"`` on a card is for ranks that share one card, which
    NCCL refuses.  Call once a process, before ``make_row_mesh``."""
    import datetime

    import torch.distributed as dist

    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids is not None:
            ids = (list(local_device_ids)
                   if not isinstance(local_device_ids, int)
                   else [local_device_ids])
            idx = int(ids[0])
        elif dev.index is not None:
            idx = dev.index
        else:
            idx = (int(os.environ.get("LOCAL_RANK", rank))
                   % torch.cuda.device_count())
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r} not in ('nccl', 'gloo')")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    kw = {}
    if coordinator is not None:
        kw["init_method"] = f"tcp://{coordinator}"
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)
    return dev


def cluster_info() -> dict:
    """Process and device topology of the current run, under the JAX
    package's four keys: this process's index, the process count, this
    process's devices and the global device count (one device a rank)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        rank, world, backend = 0, 1, None
    if backend == "nccl" or (backend is None and torch.cuda.is_available()):
        local = [f"cuda:{torch.cuda.current_device()}"]
    else:
        local = ["cpu"]
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": local,
        "global_device_count": world,
    }


def shutdown_cluster() -> None:
    """Leave the process group (``destroy_process_group``), if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
