"""Device milliseconds a solve of the kernels launched inside the
program's Timer span ``spmm`` (every ``apply`` of the operator the solver
makes), from the profiled solves of ``harness/spans.py``."""

from perfbench.harness import spans


def read(ctx):
    trace = spans.profiled(ctx)
    return trace and trace["spmm_ms"]
