"""Kernels, copies and fills a solve launched on the card, from the
profiled solves of ``harness/spans.py`` (a fixed seed, so the count
repeats from run to run)."""

from perfbench.harness import spans


def read(ctx):
    trace = spans.profiled(ctx)
    return trace and trace["launches"]
