"""Milliseconds a solve the host waits on the eig polls: the Timer sections
``eig_wait`` (the pipelined polls) and ``eig`` (the serial last
factorization at the cap), summed over the window's solves and divided by
their count.  Nothing to read where the entry takes no timer."""


def read(ctx):
    timed = [s["sections"] for s in ctx.solves if s.get("sections") is not None]
    if not timed or not any("eig_wait" in t or "eig" in t for t in timed):
        return None
    total = sum(t.get("eig_wait", 0.0) + t.get("eig", 0.0) for t in timed)
    return 1e3 * total / len(timed)
