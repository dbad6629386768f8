"""The 95th percentile (linear between order statistics) of the walls of
all the window's solves."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.walls, 95)) if ctx.walls else None
