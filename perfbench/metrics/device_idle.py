"""Share of the traced window (whole solves, ending in a synchronize) in
which no kernel, copy or fill ran on the card, from ``torch.profiler``."""


def read(ctx):
    prof = ctx.profile
    if ctx.device.type != "cuda" or not prof.get("busy_s") or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
