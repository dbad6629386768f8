"""Device milliseconds a solve of the packed block-sparse CUDA kernel
(B1/B2, found by its symbol), from the profiled solve of
``harness/bsr_kernel.py`` (a fixed seed, so it repeats from run to run).
Nothing to read off the card or where no such kernel ran."""

from perfbench.harness import bsr_kernel


def read(ctx):
    trace = bsr_kernel.profiled(ctx)
    return trace and trace["device_ms"]
