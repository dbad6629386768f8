"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.memory_peak_bytes / 2**30
