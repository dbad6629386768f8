"""``rbl_tpu_torch.solver.polish.rbl_polished``: an f32 coarse solve, then
the f64 Chebyshev-filtered polish to the mix's ``tol``; ``bounds`` certifies
(λ_min, λ_max) of the matrix, null for one not known."""

KEYS = ("bounds",)


def solve(rt, op, k, cfg, mix, timer):
    from rbl_tpu_torch.solver.polish import rbl_polished

    bounds = mix.get("bounds")
    return rbl_polished(op, k, cfg=cfg, b=cfg.block_size,
                        which=mix.get("which", "LM"),
                        bounds=tuple(bounds) if bounds else None, timer=timer)
