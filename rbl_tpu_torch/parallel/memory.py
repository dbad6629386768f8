"""Device-memory budgeting for the Krylov basis.

The reference's VRAM accounting: ``gpu_buffer_size`` (RBL_gpu.jl:95-104)
budgets 0.8·free VRAM minus the working set (6 FLOAT + 5 DOUBLE blocks)
minus A, in units of one (n, b) block.  Here the same arithmetic caps the
Krylov dimension, with free memory from ``torch.cuda.mem_get_info`` taken
after the operator is on the device (so A is already accounted for).
"""

from __future__ import annotations

import torch


def device_free_memory(device) -> int | None:
    """Free bytes on a CUDA device, or None ("unknown") for any other
    device (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def krylov_capacity(
    n: int,
    block_size: int,
    basis_dtype: torch.dtype,
    compute_dtype: torch.dtype,
    budget_fraction: float = 0.8,
    free_bytes: int | None = None,
    device=None,
    n_devices: int = 1,
) -> int | None:
    """Max Krylov dimension (columns) the basis buffer can hold in device
    memory.

    Mirrors gpu_buffer_size: budget = frac·free − working set, in units of
    one basis block; returns a column count (multiple of block_size),
    or None when free memory is unknown.  ``device`` is read only when
    ``free_bytes`` is not given.  Under a row mesh of ``n_devices`` ranks
    each holds ⌈n / n_devices⌉ rows of every block."""
    if free_bytes is None:
        free_bytes = device_free_memory(device)
    if free_bytes is None:
        return None
    b = block_size
    rows_local = -(-n // n_devices)
    bl_f = rows_local * b * basis_dtype.itemsize
    bl_d = rows_local * b * compute_dtype.itemsize
    budget = budget_fraction * free_bytes - 6 * bl_f - 5 * bl_d
    nblocks = int(budget // bl_f) if bl_f else 0
    return max(nblocks, 0) * b


def clamp_kryl_dim(cfg_max: int, n: int, block_size: int, basis_dtype,
                   compute_dtype, budget_fraction: float = 0.8, *,
                   device, n_devices: int = 1) -> int:
    """Final Krylov cap = min(config cap, n rounded up to b, memory
    capacity)."""
    b = block_size
    cap = min(cfg_max, ((n + b - 1) // b) * b)
    mem = krylov_capacity(
        n, b, basis_dtype, compute_dtype,
        budget_fraction=budget_fraction, device=device, n_devices=n_devices,
    )
    if mem is not None:
        # mem == 0 is a real answer (zero basis blocks fit), not "unknown":
        # the max(cap, b) floor below keeps one block, and the caller's
        # k-vs-cap guard turns exhaustion into a clean ValueError instead
        # of an opaque device OOM
        cap = min(cap, mem)
    return max(cap, b)
