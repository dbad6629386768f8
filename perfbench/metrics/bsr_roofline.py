"""The packed block-sparse CUDA kernel (B1/B2) against its roofline, in
percent: the sum over its launches in the profiled solve of
``harness/bsr_kernel.py`` of each launch's bound, max(bytes / 3.35 TB/s,
operations / 67 (f32) or 34 (f64) TFLOP/s), counted from the matrix's
nonzeros and the launch's width (the program's counter ``spmm_cols``),
over those launches' device time.  Nothing to read off the card, where no
such kernel ran, or where the program keeps no widths."""

from perfbench.harness import bsr_kernel


def read(ctx):
    trace = bsr_kernel.profiled(ctx)
    if not trace or not trace["timed_ms"]:
        return None
    return 100.0 * trace["bound_ms"] / trace["timed_ms"]
