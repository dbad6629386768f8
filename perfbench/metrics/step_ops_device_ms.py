"""Device milliseconds a solve of the kernels launched inside the
program's Timer spans ``project`` (the three-term subtraction, the Gram
and the scrubs of a step) and ``qr`` (its block QR), from the profiled
solves of ``harness/spans.py``."""

from perfbench.harness import spans


def read(ctx):
    trace = spans.profiled(ctx)
    return trace and trace["step_ops_ms"]
