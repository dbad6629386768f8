"""The cell operator's ``apply`` at the mix's b and compute dtype against its
roofline: the median of CUDA-event timed applies, the L2 flushed before each,
over max(bytes / 3.35 TB/s, operations / peak of the dtype outside the
tensor cores), with bytes and operations counted from what the benchmark's
matrix needs (``harness/roofline.py``)."""

from perfbench.harness import roofline


def read(ctx):
    prog = ctx.program
    if ctx.device.type != "cuda" or prog.op is None:
        return None
    seconds = roofline.time_apply(prog.op, ctx.problem.n, prog.b, prog.dtype,
                                  ctx.device)
    bound = roofline.bound_seconds(ctx.problem, prog.b, prog.dtype)
    ctx.notes.append(f"spmm_roofline: apply {seconds * 1e3:.4f} ms at b={prog.b} "
                     f"{str(prog.dtype).split('.')[-1]}, bound {bound * 1e3:.4f} ms")
    return 100.0 * bound / seconds
