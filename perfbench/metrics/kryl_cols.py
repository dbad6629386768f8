"""Mean Krylov dimension (``LanczosResult.kryl_dim``) a solve of the window."""


def read(ctx):
    dims = [s["kryl_dim"] for s in ctx.solves if s.get("kryl_dim")]
    return sum(dims) / len(dims) if dims else None
