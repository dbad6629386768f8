"""Seconds of ``as_operator`` on the configuration's assembled matrix, as
the harness timed it (the host clock, ending in a synchronize): the
format router, the layout's packing and the upload.  Nothing to read for
a matrix-free operator."""


def read(ctx):
    return ctx.program.setup_parts.get("operator_build_s")
