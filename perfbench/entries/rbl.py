"""``rbl_tpu_torch.rbl``: the k eigenpairs that the mix's ``which`` names."""

KEYS = ()             # mix keys of this entry's own, besides the shared ones


def solve(rt, op, k, cfg, mix, timer):
    return rt.rbl(op, k, cfg=cfg, which=mix.get("which", "LM"), timer=timer)
