"""Milliseconds a solve the eig worker spends on the polls: the spans
``eig_screen`` (the values-only screen) and ``eig_poll`` (the full
factorization), stamped on the worker thread and recorded by the Timer,
summed over the window's solves and divided by their count.  Nothing to
read where the program records no screen."""


def read(ctx):
    timed = [s["sections"] for s in ctx.solves if s.get("sections") is not None]
    if not any("eig_screen" in t for t in timed):
        return None
    total = sum(t.get("eig_screen", 0.0) + t.get("eig_poll", 0.0) for t in timed)
    return 1e3 * total / len(timed)
