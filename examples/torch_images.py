"""Low-rank image compression demo on the PyTorch port — examples/images.py
(the reference's images.jl) through rbl_tpu_torch.

Rank-k approximation of a grayscale image B three ways (images.jl:14-48):
  1. rbl_svd — RBL on the Gram operator BᵀB: right singular vectors V and
     σ, the left factor recovered as U = (B·V)/σ (images.jl:21-25);
  2. scipy's ARPACK svds on the host (the reference's Arpack.svds);
  3. numpy's exact SVD on the host (stand-in for LowRankApprox.psvd).

Without an image file a synthetic low-rank-plus-noise image is generated,
so the demo runs hermetically.

Usage: python examples/torch_images.py [--image path.png] [--rank 50]
       [--f32] [--out DIR|file.npy] [--device cpu]

It runs on the CUDA card (and raises without one) unless given
``--device cpu``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_or_make_image(path):
    if path:
        try:
            from PIL import Image

            return np.asarray(Image.open(path).convert("L"), dtype=np.float64) / 255.0
        except ImportError:
            print("PIL unavailable; using synthetic image")
    rng = np.random.default_rng(0)
    h, w, r = 480, 640, 40
    img = rng.standard_normal((h, r)) @ rng.standard_normal((r, w))
    img += 0.05 * rng.standard_normal((h, w))
    img -= img.min()
    return img / img.max()


def main(argv=None):
    """Run the three approximations; returns a dict with ``sigma`` (RBL's
    σ), ``err_rbl``/``err_svds``/``err_svd`` (relative Frobenius errors),
    ``t_rbl``/``t_svds``/``t_svd`` (walls, seconds) and ``S_svd`` (the
    exact singular values)."""
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None)
    p.add_argument("--rank", type=int, default=50)
    p.add_argument("--out", default=None,
                   help="directory: write original + the three rank-k "
                        "reconstruction PNGs (images.jl:44-55 plots them; "
                        "a .npy path saves the RBL reconstruction array "
                        "instead)")
    p.add_argument("--f32", action="store_true",
                   help="f32 compute (this Gram matrix squares the "
                        "dominance: σ₁²/σ_sea² ≈ 1e5 exceeds what f32's eps "
                        "can resolve — expect degraded σ beyond the "
                        "structural rank; the reference runs this demo in "
                        "Float64 too)")
    p.add_argument("--device", default=None,
                   help='"cpu" or a CUDA device; default: the CUDA card')
    args = p.parse_args(argv)

    import torch

    import rbl_tpu_torch as rt
    from rbl_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    B = load_or_make_image(args.image)
    k = args.rank
    print(f"image {B.shape}, rank-{k} approximation")

    # 1. rbl_svd on the matrix-free Gram operator; f64 by default, like the
    # reference: the Gram squares the spectral dominance, which puts the sea
    # of small σ² beneath f32's resolvable range
    dt_ = torch.float32 if args.f32 else torch.float64
    cfg = rt.RBLConfig(block_size=8, basis_dtype=dt_, compute_dtype=dt_,
                       tol=1e-5 if args.f32 else 1e-7, device=str(device))
    t0 = time.perf_counter()
    res = rt.rbl_svd(B, k, cfg=cfg)
    sigma = res.s
    U, V = res.U.double().cpu().numpy(), res.V.double().cpu().numpy()
    B_rbl = (U * sigma[None, :]) @ V.T
    t_rbl = time.perf_counter() - t0
    err_rbl = np.linalg.norm(B - B_rbl) / np.linalg.norm(B)

    # 2. ARPACK svds
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    U2, S2, Vt2 = spla.svds(B, k=k, tol=1e-7)
    order = np.argsort(-S2)
    B_svds = (U2[:, order] * S2[order][None, :]) @ Vt2[order, :]
    t_svds = time.perf_counter() - t0
    err_svds = np.linalg.norm(B - B_svds) / np.linalg.norm(B)

    # 3. exact truncated SVD
    t0 = time.perf_counter()
    Uf, Sf, Vtf = np.linalg.svd(B, full_matrices=False)
    B_svd = (Uf[:, :k] * Sf[:k][None, :]) @ Vtf[:k, :]
    t_svd = time.perf_counter() - t0
    err_svd = np.linalg.norm(B - B_svd) / np.linalg.norm(B)

    print(f"RBL(BᵀB):  {t_rbl:.3f}s  rel fro err {err_rbl:.4e}")
    print(f"svds:      {t_svds:.3f}s  rel fro err {err_svds:.4e}")
    print(f"full SVD:  {t_svd:.3f}s  rel fro err {err_svd:.4e}")
    print(f"top σ: RBL {sigma[:3]}, svds {np.sort(S2)[::-1][:3]}, svd {Sf[:3]}")

    if args.out:
        if args.out.endswith(".npy"):
            np.save(args.out, B_rbl)
            print(f"saved reconstruction to {args.out}")
        else:
            # original + RBL + svds + exact-SVD rank-k images, one PNG each
            # (images.jl:44-55 plots them side by side)
            from PIL import Image

            os.makedirs(args.out, exist_ok=True)

            def save(name, arr):
                g = np.clip(arr, 0.0, 1.0)
                path = os.path.join(args.out, f"{name}.png")
                Image.fromarray((g * 255).astype(np.uint8), "L").save(path)
                return path

            paths = [
                save("original", B),
                save(f"rbl_rank{k}", B_rbl),
                save(f"svds_rank{k}", B_svds),
                save(f"svd_rank{k}", B_svd),
            ]
            print("wrote " + ", ".join(paths))
    return dict(sigma=sigma, err_rbl=err_rbl, err_svds=err_svds, err_svd=err_svd,
                t_rbl=t_rbl, t_svds=t_svds, t_svd=t_svd, S_svd=Sf)


if __name__ == "__main__":
    main()
