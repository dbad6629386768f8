"""Seconds from the process's start to the first solve of the window:
imports, the CUDA context, the kernels' load (their nvcc build in a fresh
checkout), the inputs, the operator build and one warm solve of the cell's
shapes."""


def read(ctx):
    return ctx.setup_s
