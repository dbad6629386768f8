"""The window's span over its whole solves (the first one's start to the
last one's end, each ending in a synchronize) divided by their count: the
mean time to k pairs of a warm solve."""


def read(ctx):
    return ctx.span / len(ctx.walls) if ctx.walls else None
