"""Milliseconds a solve in the Timer section ``eig_last``: the wait for
the last eig poll of the sweep and, at the Krylov cap, the serial
factorization after it (``eig_wait`` and ``eig`` nested inside), summed
over the window's solves and divided by their count.  Nothing to read
where the program has no such section."""


def read(ctx):
    timed = [s["sections"] for s in ctx.solves if s.get("sections") is not None]
    if not any("eig_last" in t for t in timed):
        return None
    return 1e3 * sum(t.get("eig_last", 0.0) for t in timed) / len(timed)
