"""The 1-D row mesh over torch.distributed (port of
``rbl_tpu/parallel/mesh.py``).

The JAX package shards A's rows, every (n, b) Krylov block, the basis
buffer and the lock set over one "rows" mesh axis, keeps the small state
(T, B_i, Ritz values, the eig polls) replicated, and lets GSPMD insert the
psum of each Gram and the ppermute of each halo.  Here the same split is
explicit SPMD: one process a rank, each holding its own contiguous slab of
every n-sized array, and every reduction over rows an explicit collective
through the helpers of ``RowMesh``.

Replicated state must stay bitwise identical on every rank: every host
decision is taken on every rank, and two ranks that branch differently
leave one of them waiting in a collective that never completes.  All-reduce
gives every rank the same bits (gloo and NCCL both), so a decision that
reads only replicated state is safe; one that reads a clock, a thread's
state or free memory goes through ``agree`` or ``all_reduce_min`` first.

Transport.  NCCL moves device tensors.  gloo's collectives take CUDA
tensors too (all-reduce, broadcast, both all-gathers and gather, checked
on the H100 by tools/probe_mesh_transport.py, though the backend table
lists the first two only), but its point-to-point send reads a CUDA
tensor's pointer as host memory and fails.  So under gloo a CUDA tensor's
ring exchange stages through pinned host buffers (``RowMesh.stage_p2p``),
and ``RowMesh.describe()`` prints the choice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import resolve_device


@dataclasses.dataclass(eq=False)
class RowMesh:
    """A 1-D mesh over the matrix rows: ``size`` ranks of the process
    ``group`` (None: the default group), this process being ``rank``,
    its slab on ``device``.  Rank r owns the contiguous rows
    ``row_range(n)``, in rank order."""

    group: Any
    size: int
    rank: int
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    # gloo on a card: point-to-point goes through pinned host buffers
    stage_p2p: bool = False
    # traffic counters of this rank, read by benchmarks and tests
    stats: dict = dataclasses.field(default_factory=lambda: {
        "all_reduce": 0, "all_gather": 0, "gather_host": 0, "exchange": 0,
        "agree": 0, "agree_overruled": 0, "staged_bytes": 0,
        "exchanged_bytes": 0,
    })

    # --- layout ----------------------------------------------------------

    def chunk(self, n: int) -> int:
        """Rows of every slab but possibly the last: ⌈n / size⌉, the split
        GSPMD makes of an axis that does not divide."""
        return -(-n // self.size)

    def row_range(self, n: int, rank: Optional[int] = None) -> tuple[int, int]:
        """[lo, hi) of the rows rank ``rank`` (default: this one) owns."""
        r = self.rank if rank is None else rank
        c = self.chunk(n)
        return min(r * c, n), min((r + 1) * c, n)

    def local_rows(self, n: int) -> int:
        lo, hi = self.row_range(n)
        return hi - lo

    def shard_rows(self, x):
        """The own rows of a global (n, ...) array or tensor, as a tensor on
        the mesh's device."""
        x = torch.as_tensor(x)
        lo, hi = self.row_range(x.shape[0])
        return x[lo:hi].to(self.device)

    def replicated(self, x):
        """No-op: replicated state is a plain tensor or array on every rank
        (kept for the name of the JAX package's helper)."""
        return x

    # --- collectives -----------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of ``t`` (a new tensor; ``t`` is left as it was)."""
        return self._all_reduce(t, torch.distributed.ReduceOp.SUM)

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(t, torch.distributed.ReduceOp.MIN)

    def _all_reduce(self, t, op):
        import torch.distributed as dist

        self.stats["all_reduce"] += 1
        out = t.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The global (n, ...) tensor from every rank's slab of an n-row
        array (the inverse of ``shard_rows``); every rank gets the whole.
        Uneven slabs travel padded to ``chunk(n)`` rows."""
        import torch.distributed as dist

        self.stats["all_gather"] += 1
        c = self.chunk(n)
        xs = x
        if x.shape[0] != c:
            xs = x.new_zeros((c, *x.shape[1:]))
            xs[: x.shape[0]] = x
        xs = xs.contiguous()
        out = xs.new_empty((self.size * c, *x.shape[1:]))
        if self.size == 1:
            out.copy_(xs)
        else:
            dist.all_gather_into_tensor(out, xs, group=self.group)
        return out[:n]

    def gather_rows_host(self, x, n: int):
        """The global (n, ...) array of every rank's slab of an n-row array,
        as a host numpy array on rank 0 and None on the others.  Each slab
        goes to rank 0 alone, one at a time (NCCL: from the device; gloo:
        from host memory), so no rank holds the whole on its device.
        Sub-f32 floats travel and arrive as f32."""
        import torch.distributed as dist

        self.stats["gather_host"] += 1
        wire = self.device if self.backend == "nccl" else torch.device("cpu")
        x = torch.as_tensor(x).to(wire)
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        x = x.contiguous()
        if self.rank != 0:
            if x.shape[0]:
                dist.send(x, self._global_rank(0), group=self.group)
            return None
        out = None
        for r in range(self.size):
            lo, hi = self.row_range(n, r)
            part = x
            if r != 0 and hi > lo:
                part = torch.empty((hi - lo, *x.shape[1:]), dtype=x.dtype,
                                   device=wire)
                dist.recv(part, self._global_rank(r), group=self.group)
            part = part.cpu().numpy()
            if out is None:
                out = np.empty((n, *x.shape[1:]), dtype=part.dtype)
            out[lo:hi] = part
        return out

    def exchange(self, send: torch.Tensor, shift: int) -> torch.Tensor:
        """One circular shift of the ring: send ``send`` to rank
        r + shift and return what rank r − shift sent (the same shape and
        dtype on every rank) — ``jax.lax.ppermute`` with
        perm = [(i, (i + shift) % size)]."""
        import torch.distributed as dist

        self.stats["exchange"] += 1
        s = shift % self.size
        if s == 0:
            return send.clone()
        staged = self.stage_p2p and send.device.type == "cuda"
        src_t = _pinned_copy(send) if staged else send.contiguous()
        recv = torch.empty_like(src_t)
        self.stats["exchanged_bytes"] += src_t.numel() * src_t.element_size()
        if staged:
            self.stats["staged_bytes"] += 2 * src_t.numel() * src_t.element_size()
        dst = self._global_rank((self.rank + s) % self.size)
        src = self._global_rank((self.rank - s) % self.size)
        ops = [dist.P2POp(dist.isend, src_t, dst, group=self.group),
               dist.P2POp(dist.irecv, recv, src, group=self.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return recv.to(send.device) if staged else recv

    def agree(self, flag: bool) -> bool:
        """True on every rank iff ``flag`` is True on every rank (an
        all-reduce MIN).  Every branch that reads a clock or a thread's
        state goes through here, so that all ranks take it together."""
        self.stats["agree"] += 1
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
        out = bool(int(self._all_reduce(t, torch.distributed.ReduceOp.MIN)))
        if flag and not out:
            self.stats["agree_overruled"] += 1  # another rank said no
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def _global_rank(self, r: int) -> int:
        import torch.distributed as dist

        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def describe(self) -> str:
        p2p = ("staged through pinned host memory" if self.stage_p2p
               else "direct")
        return (f"RowMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend}, "
                f"point-to-point {p2p})")

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")
    h.copy_(t)
    return h


def make_row_mesh(n_devices: Optional[int] = None, device=None,
                  group=None) -> RowMesh:
    """The 1-D row mesh over the initialized process group (``group``, or
    the default one; see ``parallel.distributed.initialize_cluster``).

    ``device`` holds this rank's slab: None means the CUDA card (the
    process's current device), and raises without one, like every entry
    point of the package; pass ``device="cpu"`` for CPU ranks.
    ``n_devices``, when given, must equal the group's size."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_row_mesh needs an initialized process group: call "
            "rbl_tpu_torch.parallel.distributed.initialize_cluster first "
            "(or launch under torchrun and call it with no arguments)"
        )
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {size} ranks: "
            "one rank a device"
        )
    backend = str(dist.get_backend(group))
    return RowMesh(group=group, size=size, rank=dist.get_rank(group),
                   device=dev, backend=backend,
                   stage_p2p=backend == "gloo" and dev.type == "cuda")


def mesh_size(mesh: Optional[RowMesh]) -> int:
    return 1 if mesh is None else mesh.size


def local_rows(n: int, mesh: Optional[RowMesh]) -> int:
    """Rows of an n-row array this rank holds (n without a mesh)."""
    return n if mesh is None else mesh.local_rows(n)


def all_reduce_sum(t: torch.Tensor, mesh: Optional[RowMesh]) -> torch.Tensor:
    """Σ over the mesh's ranks (``t`` itself without a mesh)."""
    return t if mesh is None else mesh.all_reduce_sum(t)


def col_sumsq(X: torch.Tensor, mesh: Optional[RowMesh]) -> torch.Tensor:
    """Σ over rows of X², reduced over the mesh: the squared column norms
    of a row-sharded block."""
    return all_reduce_sum(torch.sum(X * X, dim=0), mesh)


def randn_rows(n: int, cols: int, generator: torch.Generator, dtype,
               device, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """An (n, cols) standard-normal block drawn from ``generator``, of which
    this rank keeps its own rows.  Every rank draws the whole block, so
    the generators stay in step and the rows equal the single-device
    draw's (the JAX package's ``with_sharding_constraint`` on Ω)."""
    Z = torch.randn((n, cols), generator=generator, dtype=dtype,
                    device=device)
    if mesh is None:
        return Z
    lo, hi = mesh.row_range(n)
    return Z[lo:hi].contiguous()
