"""Peaks of one NVIDIA H100 and what a sparse product needs.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates outside the tensor cores (the port's SpMM runs FP32/FP64 FMA):
67 TFLOP/s in float32, 34 TFLOP/s in float64, 3.35 TB/s of HBM3.
``need`` counts what the matrix needs, whatever layout the program picks
(a copy of ``chip_smoke.py``'s ``sparse_need``, counted from the
benchmark's own matrix): each nonzero's value and int32 column index read
once (the assembly's stored exact zeros are neither bytes nor work), X
read once and Y written once, two operations a nonzero and column; a
matrix-free stencil reads X and writes Y only.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
L2_FLUSH_BYTES = 256 << 20   # over five times the H100's 50 MB L2


def need(problem, b: int, dtype) -> tuple[int, int]:
    """(bytes, operations) of one product A·X with b columns."""
    es = torch.tensor([], dtype=dtype).element_size()
    nnz = problem.nonzeros
    io = 2 * problem.n * b * es
    matrix = nnz * (es + 4) if problem.A is not None else 0
    return matrix + io, 2 * nnz * b


def bound_seconds(problem, b: int, dtype) -> float:
    nbytes, ops = need(problem, b, dtype)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def time_apply(op, n: int, b: int, dtype, device, reps: int = 30,
               seed: int = 0) -> float:
    """Median seconds of ``op.apply`` on an (n, b) block, each apply timed
    by CUDA events with the L2 flushed before it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.randn(n, b, dtype=dtype, device=device, generator=gen)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    for _ in range(3):
        op.apply(X)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        op.apply(X)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in pairs)
    del flush, X
    return ms[len(ms) // 2] / 1e3
