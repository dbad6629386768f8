#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rbl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, compares
each kernel entry point with its plain PyTorch version on the card, then
drives the port's paths — ``rbl_tpu_torch.rbl`` — through the entry points
a user calls, and checks the answers:

  1. the card's name and power limit, torch's and CUDA's versions;
  2. the kernel build (csrc/*.cu → rbl_tpu_torch/build/, one nvcc each);
  3. packed kernel (B1/B2) against plain version, f32 and f64, on the
     packed arrays of the assembled 3-D elasticity matrix
     fem_elasticity_3d(42) (n = 232,974, 18.0 M nonzeros) at b = 8
     (resident entry point) and b = 16 (streaming entry point), and on a
     small matrix with ragged edges; per-apply times (CUDA events, median
     of 20);
  4. rbl on the 512² Laplacian with bench.py's configuration, held to
     bench.py's analytic check (max relative error < 0.025);
  5. rbl on fem42 (format="bsr") at k = 100, b = 8 and b = 16 (f32), held
     to the first 90 ARPACK eigenvalues (benchmarks/groundtruth/
     fem42_lm_k100.npz) within 1e-2 relative, with the kernel launch
     counts of the run;
  6. the blocked-ELL (B3) and panel (B4) kernels against their plain
     versions, f32 (1e-5) and f64 (1e-12): B3 on fem42's blocked-ELL at
     bm = 128 (b = 8, 16), B4 on fem42's panel layout of the auto plan
     (b = 8), both on the ragged matrix at b = 5, 8, 16, 40; per-apply
     times beside the plain version and torch.sparse CSR.  B3's entry
     point, which no solve calls, checks phase 5's fem42 Ritz vectors
     (A·V against torch.sparse CSR, and the true residuals);
  7. rbl on fem42 through BlockSparseOperator.from_scipy(..., panel=True)
     (k = 100, b = 8, f32), held to the ARPACK head, with B4's launches;
  8. the same fem42 solve through format="dia", "ell", "hyb", "coo" and
     "auto", each held to the ARPACK head; the route "auto" took;
  9. rbl (format="auto", which must pick HYB) on a Chung-Lu power-law
     graph (n = 262,144, mean degree 16, Pareto weights of exponent 2.1),
     k = 20, b = 8, tol 1e-3, f32, held to scipy's eigsh within 1e-3;
 10. the tile-stream probes B5-B7 (rbl_tpu_torch.benchmarks.
     dma_stream_bench): (a) each kernel against its plain version, held to
     1e-5 · Σ|terms| per entry, at 256 MB of vals for (bm, U) = (16, 8) and
     (128, 8), at ragged chunk counts (1, 2, 3, 100, 1001; chunks taller
     than a ring stage) and on fem42's packed vals; (b) the probe's sweep
     over its default configurations and the card's plan for fem42; (c)
     the three variants over fem42's own packed vals (phase 3's plan), each
     beside B1's time on that plan.

The last two lines are the kernels' JSON record and the JSON result.  Any
failure raises, and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GROUNDTRUTH = os.path.join(ROOT, "benchmarks", "groundtruth", "fem42_lm_k100.npz")
# kernel → (source, the TPU kernel it replaces: function definition)
KERNELS = {
    "bsr_spmm_packed_resident": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                                 "rbl_tpu/ops/spmm/pallas_bsr.py:418"),
    "bsr_spmm_packed": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                        "rbl_tpu/ops/spmm/pallas_bsr.py:182"),
    "bsr_spmm": ("rbl_tpu_torch/csrc/bsr_spmm.cu",
                 "rbl_tpu/ops/spmm/pallas_bsr.py:80"),
    "bsr_spmm_panel": ("rbl_tpu_torch/csrc/bsr_spmm_panel.cu",
                       "rbl_tpu/ops/spmm/pallas_bsr.py:296"),
    "dma_stream": ("rbl_tpu_torch/csrc/dma_stream.cu",
                   "benchmarks/dma_stream_bench.py:65"),
    "dma_stream_dot": ("rbl_tpu_torch/csrc/dma_stream.cu",
                       "benchmarks/dma_stream_bench.py:83"),
    "dma_stream_manual": ("rbl_tpu_torch/csrc/dma_stream.cu",
                          "benchmarks/dma_stream_bench.py:130"),
}
TOL = {"float32": 1e-5, "float64": 1e-12}  # max |Y - Y_plain| / max |Y_plain|
# NVIDIA H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s
# and float32 FMA-unit operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Median per-call device time of ``fn`` (CUDA events), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM bandwidth, or the float32
    operations over the FMA units' peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(label: str, kernel, plain, dtype):
    """Run a kernel call and its plain version on the same card tensors;
    raises beyond the tolerance.  Returns (max abs error, relative error)."""
    import torch

    Y = kernel()
    Yp = plain()
    torch.cuda.synchronize()
    abs_err = float((Y - Yp).abs().max())
    rel = abs_err / max(float(Yp.abs().max()), 1e-300)
    dt = str(dtype).removeprefix("torch.")
    if not rel < TOL[dt]:
        raise AssertionError(f"{label} {dt}: kernel vs plain relative error "
                             f"{rel:.3e} ≥ {TOL[dt]:g}")
    return abs_err, rel


def padded_x(op, b: int, seed: int):
    import torch

    ncb = -(-op._n // op.bk)
    g = torch.Generator(device=op.device).manual_seed(seed)
    return torch.randn((ncb * op.bk, b), generator=g, dtype=op.dtype,
                       device=op.device)


def compare_entry(entry: str, op, b: int, seed: int, timing: bool):
    """Run one packed entry point and the plain version on the same card
    tensors; returns (max abs error, relative error, kernel ms, plain ms,
    bytes, operations)."""
    from rbl_tpu_torch.ops.spmm import bsr

    X = padded_x(op, b, seed)
    args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
    fn = getattr(bsr, entry)
    kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
    abs_err, rel = check(
        f"{entry} b={b}", lambda: fn(*args, H=op.H, **kw),
        lambda: bsr.bsr_spmm_packed_reference(*args, **kw), op.dtype)
    ms = plain_ms = None
    if timing:
        ms = time_ms(lambda: fn(*args, H=op.H, **kw))
        plain_ms = time_ms(lambda: bsr.bsr_spmm_packed_reference(*args, **kw))
    nrows = op.rptr.shape[0] * op.bm
    moved = nbytes(*args) + nrows * b * X.element_size()
    ops = 2 * op.vals.numel() * b
    return abs_err, rel, ms, plain_ms, moved, ops


def ragged_matrix(n: int = 1999, seed: int = 0):
    """Symmetric, n a multiple of neither bm nor bk, skewed tile counts,
    one heavy row and empty block-rows."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 300, 4000), np.full(1500, n - 222)])
    cols = np.concatenate([rng.integers(0, n, 4000), rng.integers(0, n, 1500)])
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def chung_lu(n: int = 262_144, mean_deg: float = 16.0, gamma: float = 2.1,
             seed: int = 0):
    """Symmetric 0/1 adjacency of a Chung-Lu random graph: node weights
    from a Pareto law whose degree tail has exponent ``gamma``, edge
    endpoints drawn in proportion to the weights, self-loops and repeats
    dropped, drawn until the mean degree reaches ``mean_deg``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    w = rng.pareto(gamma - 1.0, n) + 1.0
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    A = sp.csr_matrix((n, n), dtype=np.float32)
    while A.nnz < mean_deg * n:
        m = int((mean_deg * n - A.nnz) * 0.6) + 1
        i = np.searchsorted(cdf, rng.random(m))
        j = np.searchsorted(cdf, rng.random(m))
        keep = i != j
        E = sp.coo_matrix((np.ones(keep.sum(), np.float32), (i[keep], j[keep])),
                          shape=(n, n))
        A = (A + E + E.T).tocsr()
        A.data[:] = 1.0
    return A


def torch_csr(A, dtype):
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data).to(dtype), size=A.shape,
    ).to("cuda")


def laplacian_check(eigenvalues, nx: int) -> float:
    """bench.py's analytic check: max relative error against the top of
    the 2-D Dirichlet Laplacian spectrum."""
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(eigenvalues)]
    return float(np.max(np.abs(np.asarray(eigenvalues) - lam) / lam))


def solve(op, k: int, b: int, label: str, tol: float = 1e-3):
    """One solve in f32 (cholqr2, cap 1400) on the card; returns the
    result and its wall seconds."""
    import torch

    import rbl_tpu_torch as rt

    cfg = rt.RBLConfig(block_size=b, basis_dtype=torch.float32,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=tol, max_kryl_dim=1400)
    t0 = time.perf_counter()
    res = rt.rbl(op, k, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = np.asarray(res.eigenvalues)
    if w.shape != (k,) or not np.all(np.isfinite(w)):
        raise AssertionError(f"{label}: eigenvalues not finite of shape ({k},)")
    if res.eigenvectors.device.type != "cuda":
        raise AssertionError(f"{label}: eigenvectors on {res.eigenvectors.device}")
    return res, wall


def fem_solve(op, k: int, b: int, head: np.ndarray, label: str = "fem42"):
    """One fem42 solve (see ``solve``, tol 1e-3); returns the result, its
    wall seconds and its max relative error on the ARPACK head."""
    res, wall = solve(op, k, b, f"{label} b={b}")
    w = np.asarray(res.eigenvalues)
    err = float(np.max(np.abs(w[: len(head)] - head) / head))
    if not err < 1e-2:
        raise AssertionError(f"{label} b={b}: max rel error {err:.3e} vs "
                             "ARPACK head ≥ 1e-2")
    return res, wall, err


def head_error(w, ref, m: int) -> float:
    """Max relative error between the m largest-magnitude values of two
    spectra, each taken in ascending order."""
    top = lambda v: np.sort(v[np.argsort(-np.abs(v))][:m])
    a, r = top(np.asarray(w)), top(np.asarray(ref))
    return float(np.max(np.abs(a - r) / np.abs(r)))


def probe_calls(name: str, vals, xt, bm: int, U: int):
    """The tile-stream probe ``name`` on vals (S·bm·U, 128): (kernel call,
    plain call, library call), each taking the seed."""
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds

    CH = bm * U
    S = vals.shape[0] // CH
    if name == "stream_dot":
        return (lambda s: tds.make_stream_dot(S, CH, bm, U)(vals, s, xt),
                lambda s: tds.stream_dot_reference(vals, s, xt, S=S, CH=CH, bm=bm, U=U),
                lambda s: s + (vals.view(-1, bm, 128) @ xt.T).sum())
    make, plain = {"stream": (tds.make_stream, tds.stream_reference),
                   "manual": (tds.make_manual, tds.manual_reference)}[name]
    return (lambda s: make(S, CH)(vals, s), lambda s: plain(vals, s, S=S, CH=CH),
            lambda s: s + vals.sum(0))


def check_probe(name: str, vals, seed, xt, bm: int, U: int) -> float:
    """A probe kernel and its plain version on the same card tensors, each
    held to 1e-5 · Σ|terms| per entry (f64 reference), and the kernel to
    itself bit for bit; returns max |kernel − plain|."""
    import torch

    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds

    kern, plain, _ = probe_calls(name, vals, xt, bm, U)
    out, again, out_p = kern(seed), kern(seed), plain(seed)
    ref, scale = tds.reference_f64(name, vals, seed, xt if name == "stream_dot" else None)
    torch.cuda.synchronize()
    label = f"{name} S={vals.shape[0] // (bm * U)} bm={bm} U={U}"
    for who, y in (("kernel", out), ("plain", out_p)):
        ratio = tds.error_ratio(y, ref, scale)
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: {who} off by {ratio:.2f}× "
                                 f"{tds.TOL:g}·Σ|terms|")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two runs of the kernel differ")
    return float((out - out_p).abs().max())


def reset_launches(*fns):
    for f in fns:
        f.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.ops.spmm.operator import cast_operator
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    torch.set_float32_matmul_precision("highest")  # plain versions in full FP32
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    packed = (bsr.bsr_spmm_packed_resident, bsr.bsr_spmm_packed)
    every = (*packed, bsr.bsr_spmm, bsr.bsr_spmm_panel)
    probes = (tds.dma_stream, tds.dma_stream_dot, tds.dma_stream_manual)

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels._libraries()
    print(f"build: {', '.join(sorted(libs))} in {time.perf_counter() - t0:.2f} s")

    # --- 3. packed kernel against its plain version -----------------------
    t0 = time.perf_counter()
    A = fem_elasticity_3d(42)
    print(f"fem42: n={A.shape[0]} nnz={A.nnz}, assembled in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    op32 = rt.as_operator(A, dtype=torch.float32, device="cuda", format="bsr")
    print(f"fem42 packed operator (bm={op32.bm}, unroll={op32.unroll}, "
          f"tiles={op32.nnz_blocks}, vals {op32.vals.numel() * 4 / 1e6:.1f} MB f32) "
          f"built in {time.perf_counter() - t0:.1f} s")
    op64 = bsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.float64, bm=op32.bm, unroll=op32.unroll, device="cuda")
    kernels = {}
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        for op in (op32, op64):
            abs_err, rel, ms, plain_ms, moved, ops = compare_entry(
                entry, op, b, seed=b, timing=True)
            gbs = op.vals.numel() * op.vals.element_size() / (ms * 1e-3) / 1e9
            print(f"{entry} fem42 b={b} {op.dtype}: rel err {rel:.2e}, "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of vals), "
                  f"plain {plain_ms:.4f} ms  [{card}]")
            if op is op32:
                kernels[entry] = dict(max_abs_err=abs_err, ms=ms,
                                      plain_ms=plain_ms, **bound(moved, ops))
    del op64
    R = ragged_matrix()
    for dtype in (torch.float32, torch.float64):
        for bm, U in ((16, 4), (128, 8)):
            op = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, unroll=U,
                                                    device="cuda")
            for entry in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
                for b in (5, 8, 16, 40):
                    compare_entry(entry, op, b, seed=b, timing=False)
    print(f"ragged n={R.shape[0]}: both entry points, f32 and f64, bm 16/128, "
          "b 5/8/16/40 within tolerance")

    # --- 4./5. the main path ------------------------------------------------
    head = np.load(GROUNDTRUTH)["eigenvalues"][:90]
    reset_launches(*every)
    t_main = time.perf_counter()
    lap = rt.Laplacian2D(512, 512, dtype=torch.float32, device="cuda")
    cfg = rt.RBLConfig(block_size=16, basis_dtype=torch.bfloat16,
                       compute_dtype=torch.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=768, eig_poll_cadence=16)
    for seed in (0, 1):  # the second, warm run is timed
        t0 = time.perf_counter()
        res = rt.rbl(lap, 50, cfg=cfg.replace(seed=seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lap_err = laplacian_check(res.eigenvalues, 512)
    if not lap_err < 0.025:
        raise AssertionError(f"lap2d 512²: eigenvalues off by {lap_err:.3f}")
    print(f"lap2d 512² k=50 b=16 (bench config): warm wall {wall:.3f} s, "
          f"max rel err {lap_err:.3e}, kryl_dim {res.kryl_dim}, "
          f"converged {res.converged}  [{card}]")
    fem_res = {}
    for b in (8, 16):
        res, wall, err = fem_solve(op32, 100, b, head)
        fem_res[b] = res
        print(f"fem42 k=100 b={b} f32: wall {wall:.3f} s, max rel err (ARPACK "
              f"head 90) {err:.3e}, kryl_dim {res.kryl_dim}, converged "
              f"{res.converged}, launches resident="
              f"{bsr.bsr_spmm_packed_resident.launches} streaming="
              f"{bsr.bsr_spmm_packed.launches}  [{card}]")
    launches = {f.__name__: f.launches for f in every}
    print(f"main path: {time.perf_counter() - t_main:.1f} s")
    for f in packed:
        if launches[f.__name__] < 1:
            raise AssertionError(f"main path never launched {f.__name__}")

    # --- 6. blocked-ELL (B3) and panel (B4) against their plain versions --
    t6 = time.perf_counter()
    csr32 = torch_csr(A, torch.float32)
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        Xl = padded_x(op32, b, seed=b)[: A.shape[0]]
        kernels[entry]["library_ms"] = time_ms(lambda: torch.sparse.mm(csr32, Xl))
    fem_op = op32  # phase 10 streams B1's own tiles
    del op32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bc, bv, nb, ncb, L = bsr._blocked_ell_from_scipy(A, 128, 128, np.float64)
    bc = torch.from_numpy(bc.reshape(-1)).cuda()
    bv64 = torch.from_numpy(bv.reshape(-1, 128, 128)).cuda()
    del bv
    print(f"fem42 blocked-ELL bm=128: L={L}, {bc.shape[0]} tiles, "
          f"{bv64.numel() * 4 / 1e6:.1f} MB f32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    # B3's user path: the solver has no blocked-ELL caller (nor has the JAX
    # package), so its entry point checks the phase-5 eigenpairs: A·V of
    # the b=8 fem42 solve through bsr_spmm, against torch.sparse CSR, and
    # the true residuals ‖A·v − λv‖/|λ| it gives
    V = fem_res[8].eigenvectors.float()
    lam = torch.as_tensor(fem_res[8].eigenvalues.copy(), dtype=torch.float32,
                          device="cuda")
    Vp = torch.nn.functional.pad(V, (0, 0, 0, ncb * 128 - A.shape[0])).contiguous()
    bv32 = bv64.float()
    reset_launches(*every)
    AV = bsr.bsr_spmm(bc, bv32, Vp, bm=128, bk=128, L=L)[: A.shape[0]]
    torch.cuda.synchronize()
    launches["bsr_spmm"] = bsr.bsr_spmm.launches
    AV_csr = torch.sparse.mm(csr32, V)
    path_err = float((AV - AV_csr).abs().max() / AV_csr.abs().max())
    resid = ((AV - V * lam[None, :]).norm(dim=0) / lam.abs()).max().item()
    if not (path_err < TOL["float32"] and np.isfinite(resid)):
        raise AssertionError(f"bsr_spmm on the fem42 Ritz vectors: rel err "
                             f"{path_err:.3e} against torch.sparse CSR")
    if launches["bsr_spmm"] < 1:
        raise AssertionError("the Ritz-vector check never launched bsr_spmm")
    print(f"bsr_spmm (B3) on the 100 fem42 Ritz vectors of phase 5: rel err "
          f"{path_err:.2e} against torch.sparse CSR, max true residual "
          f"{resid:.3e} (|λ|-relative), launches {launches['bsr_spmm']}")
    del bv32, AV, AV_csr, Vp
    for dtype in (torch.float32, torch.float64):
        bvd = bv64.to(dtype)
        for b in (8, 16):
            g = torch.Generator(device="cuda").manual_seed(b)
            X = torch.randn((ncb * 128, b), generator=g, dtype=dtype, device="cuda")
            call = lambda: bsr.bsr_spmm(bc, bvd, X, bm=128, bk=128, L=L)
            plain = lambda: bsr.bsr_spmm_reference(bc, bvd, X, bm=128, bk=128, L=L)
            abs_err, rel = check(f"bsr_spmm fem42 b={b}", call, plain, dtype)
            ms, plain_ms = time_ms(call), time_ms(plain)
            lib = ""
            if dtype == torch.float32:
                Xl = X[: A.shape[0]]
                lib_ms = time_ms(lambda: torch.sparse.mm(csr32, Xl))
                lib = f", torch.sparse CSR {lib_ms:.4f} ms"
                if b == 8:
                    moved = nbytes(bc, bvd, X) + nb * 128 * b * 4
                    kernels["bsr_spmm"] = dict(
                        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, **bound(moved, 2 * bvd.numel() * b))
            print(f"bsr_spmm (B3) fem42 blocked-ELL b={b} {dtype}: rel err "
                  f"{rel:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}  "
                  f"[{card}]")
        del bvd
    del bc, bv64
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pan64 = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, panel=True,
                                               device="cuda")
    print(f"fem42 panel operator (auto plan bm={pan64.bm}, unroll={pan64.unroll}, "
          f"{pan64.vals.shape[0]} panels) built in {time.perf_counter() - t0:.1f} s")
    for op in (cast_operator(pan64, torch.float32), pan64):
        b = 8
        X = padded_x(op, b, seed=b)
        args = (op.tile_cols, op.hcount, op.rptr, op.vals, X)
        kw = dict(bm=op.bm, bk=op.bk, unroll=op.unroll)
        call = lambda: bsr.bsr_spmm_panel(*args, H=op.H, **kw)
        plain = lambda: bsr.bsr_spmm_panel_reference(*args, **kw)
        abs_err, rel = check(f"bsr_spmm_panel fem42 b={b}", call, plain, op.dtype)
        # B1 on the same plan, repacked from the panels, for the comparison
        T = op.tile_cols.shape[0]
        tiles = (op.vals.reshape(T // op.unroll, op.unroll, op.bk, op.bm)
                 .transpose(2, 3).reshape(T, op.bm, op.bk).contiguous())
        b1 = lambda: bsr.bsr_spmm_packed_resident(
            op.tile_cols, op.hcount, op.rptr, tiles, X, H=op.H, **kw)
        ms, plain_ms, b1_ms = time_ms(call), time_ms(plain), time_ms(b1)
        lib = ""
        if op.dtype == torch.float32:
            Xl = X[: A.shape[0]]
            lib_ms = time_ms(lambda: torch.sparse.mm(csr32, Xl))
            lib = f", torch.sparse CSR {lib_ms:.4f} ms"
            moved = nbytes(*args) + op.rptr.shape[0] * op.bm * b * 4
            kernels["bsr_spmm_panel"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **bound(moved, 2 * op.vals.numel() * b))
        print(f"bsr_spmm_panel (B4) fem42 b={b} {op.dtype}: rel err {rel:.2e}, "
              f"kernel {ms:.4f} ms, B1 on the same plan {b1_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{lib}  [{card}]")
        del tiles
    del pan64
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        for bm, U in ((16, 4), (128, 8)):
            bcr, bvr, nbr, ncbr, Lr = bsr._blocked_ell_from_scipy(R, bm, 128, np.float64)
            Lp = Lr + (-Lr) % U
            bcr = torch.from_numpy(np.pad(bcr, ((0, 0), (0, Lp - Lr))).reshape(-1)).cuda()
            bvr = torch.from_numpy(np.pad(bvr, ((0, 0), (0, Lp - Lr), (0, 0), (0, 0)))
                                   .reshape(-1, bm, 128)).to("cuda", dtype)
            pan = bsr.BlockSparseOperator.from_scipy(R, dtype=dtype, bm=bm, unroll=U,
                                                     panel=True, device="cuda")
            for b in (5, 8, 16, 40):
                X = padded_x(pan, b, seed=b)
                check(f"bsr_spmm ragged bm={bm} b={b}",
                      lambda: bsr.bsr_spmm(bcr, bvr, X, bm=bm, bk=128, L=Lp, unroll=U),
                      lambda: bsr.bsr_spmm_reference(bcr, bvr, X, bm=bm, bk=128, L=Lp),
                      dtype)
                args = (pan.tile_cols, pan.hcount, pan.rptr, pan.vals, X)
                for gather in ("swap", "concat"):
                    check(f"bsr_spmm_panel ragged bm={bm} b={b} {gather}",
                          lambda: bsr.bsr_spmm_panel(*args, bm=bm, bk=128, H=pan.H,
                                                     unroll=U, gather=gather),
                          lambda: bsr.bsr_spmm_panel_reference(
                              *args, bm=bm, bk=128, unroll=U, gather=gather),
                          dtype)
    print(f"ragged n={R.shape[0]}: B3 and B4 (both gathers), f32 and f64, bm 16/128, "
          f"b 5/8/16/40 within tolerance; phase 6 in {time.perf_counter() - t6:.1f} s")

    # --- 7. a solve through B4 ----------------------------------------------
    pan32 = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, panel=True,
                                               device="cuda")
    reset_launches(*every)
    res, wall, err = fem_solve(pan32, 100, 8, head, "fem42 panel")
    launches["bsr_spmm_panel"] = bsr.bsr_spmm_panel.launches
    print(f"fem42 panel k=100 b=8 f32: wall {wall:.3f} s, max rel err (ARPACK "
          f"head 90) {err:.3e}, kryl_dim {res.kryl_dim}, converged "
          f"{res.converged}, bsr_spmm_panel launches "
          f"{bsr.bsr_spmm_panel.launches}  [{card}]")
    if bsr.bsr_spmm_panel.launches < 1:
        raise AssertionError("the panel solve never launched bsr_spmm_panel")
    del pan32
    torch.cuda.empty_cache()

    # --- 8. fem42 through each format ---------------------------------------
    names = {"DiaOperator": "dia", "SparseEllOperator": "ell",
             "HybOperator": "hyb", "CooOperator": "coo",
             "BlockSparseOperator": "bsr"}
    for fmt in ("dia", "ell", "hyb", "coo", "auto"):
        t0 = time.perf_counter()
        op = rt.as_operator(A, dtype=torch.float32, device="cuda", format=fmt)
        build_s = time.perf_counter() - t0
        route = names[type(op).__name__]
        reset_launches(*every)
        res, wall, err = fem_solve(op, 100, 8, head, f"fem42 {fmt}")
        counts = {f.__name__: f.launches for f in every if f.launches}
        X8 = res.eigenvectors[:, :8].contiguous()
        apply_ms = time_ms(lambda: op.apply(X8))
        print(f"fem42 format={fmt} (route {route}) k=100 b=8 f32: built in "
              f"{build_s:.1f} s, wall {wall:.3f} s, max rel err {err:.3e}, "
              f"kryl_dim {res.kryl_dim}, converged {res.converged}, "
              f"launches {counts}, apply {apply_ms:.4f} ms at b=8  [{card}]")
        del op
        torch.cuda.empty_cache()

    # --- 9. a skewed graph through HYB --------------------------------------
    t0 = time.perf_counter()
    G = chung_lu()
    deg = np.diff(G.indptr)
    print(f"Chung-Lu graph: n={G.shape[0]} nnz={G.nnz}, mean degree "
          f"{deg.mean():.2f}, longest row {deg.max()} "
          f"({deg.max() / deg.mean():.0f}× the mean), built in "
          f"{time.perf_counter() - t0:.1f} s")
    if not deg.max() > 64 * deg.mean():
        raise AssertionError("the graph's longest row is not above 64× the mean")
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    ref = spla.eigsh(G.astype(np.float64), k=20, which="LM",
                     return_eigenvectors=False)
    eigsh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opg = rt.as_operator(G, dtype=torch.float32, device="cuda")
    build_s = time.perf_counter() - t0
    if type(opg).__name__ != "HybOperator":
        raise AssertionError(f"format='auto' routed the graph to {type(opg).__name__}")
    reset_launches(*every)
    res, wall = solve(opg, 20, 8, "Chung-Lu")
    w = np.asarray(res.eigenvalues, dtype=np.float64)
    err = head_error(w, ref, 20)
    compared = 20
    if not err < 1e-3:
        # a cluster at the 20th magnitude: compare the first 15, as fem42
        # compares its ARPACK head
        err, compared = head_error(w, ref, 15), 15
    if not err < 1e-3:
        raise AssertionError(f"Chung-Lu k=20: max rel error {err:.3e} vs eigsh ≥ 1e-3")
    print(f"Chung-Lu format=auto (route hyb; ELL slots {opg.ell.cols.shape[0]}, "
          f"COO overflow {opg.coo.nnz}) k=20 b=8 f32 tol 1e-3: built in "
          f"{build_s:.1f} s, wall {wall:.3f} s, max rel err vs eigsh on the "
          f"first {compared} {err:.3e} (eigsh {eigsh_s:.1f} s on the host), "
          f"kryl_dim {res.kryl_dim}, converged {res.converged}  [{card}]")

    # --- 10. the tile-stream probes (B5-B7) ---------------------------------
    t10 = time.perf_counter()
    g = torch.Generator(device="cuda")
    seed0 = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    xt = torch.randn((8, 128), generator=g.manual_seed(1), device="cuda")
    seed = torch.randn((8, 128), generator=g.manual_seed(2), device="cuda")
    names = {"stream": "dma_stream", "stream_dot": "dma_stream_dot",
             "manual": "dma_stream_manual"}
    # (a) kernels against their plain versions
    checked = []
    for S, bm, U in ((None, 16, 8), (None, 128, 8), (1, 8, 2), (2, 8, 2),
                     (3, 8, 2), (3, 40, 5), (2, 125, 8), (100, 8, 2),
                     (1001, 16, 4)):
        CH = bm * U
        S = S or (256 * 2**20) // (128 * 4) // CH
        vals = torch.randn((S * CH, 128), generator=g.manual_seed(S), device="cuda")
        for name in tds.VARIANTS:
            check_probe(name, vals, seed, xt, bm, U)
        checked.append(f"S={S} ({bm}, {U})")
        del vals
    fem_vals, fem_plan = fem_op.vals, (fem_op.bm, fem_op.unroll)
    fem_bm, fem_U = fem_plan
    fem_flat = fem_vals.view(-1, 128)
    for name in tds.VARIANTS:
        _, plain, library = probe_calls(name, fem_flat, xt, fem_bm, fem_U)
        moved = nbytes(fem_flat, seed, seed) + (nbytes(xt) if name == "stream_dot" else 0)
        ops = fem_flat.numel() * (16 if name == "stream_dot" else 1)
        kernels[names[name]] = dict(
            max_abs_err=check_probe(name, fem_flat, seed, xt, fem_bm, fem_U),
            plain_ms=time_ms(lambda: plain(seed), reps=3),
            library_ms=time_ms(lambda: library(seed)), **bound(moved, ops))
    print(f"B5-B7 against their plain versions within {tds.TOL:g}·Σ|terms|, bit "
          f"for bit from run to run: {', '.join(checked)}, and fem42's vals")
    # (b) the probe's sweep, (c) fem42's own tile stream: the path
    reset_launches(*probes)
    rows = tds.sweep(256, 8, (*tds.DEFAULT_CONFIGS, fem_plan), "cuda")
    # B1 (b=8) and B2 (b=16) on the same plan, timed as the probe times
    # its kernels
    spmm_ms = {}
    for entry, b in (("bsr_spmm_packed_resident", 8), ("bsr_spmm_packed", 16)):
        X = padded_x(fem_op, b, seed=b)
        spmm_ms[b] = tds.kernel_ms(lambda: getattr(bsr, entry)(
            fem_op.tile_cols, fem_op.hcount, fem_op.rptr, fem_op.vals, X,
            bm=fem_bm, bk=fem_op.bk, H=fem_op.H, unroll=fem_U))
    T = fem_vals.shape[0]
    print(f"fem42 packed vals, plan {fem_plan}: {T} tiles, "
          f"{fem_vals.numel() * 4 / 1e6:.1f} MB f32, S={T // fem_U} chunks of "
          f"{fem_bm * fem_U} rows")
    for row in tds.probe(fem_flat, seed0, xt, bm=fem_bm, U=fem_U, reps=8):
        kernels[names[row["variant"]]]["ms"] = row["kernel_ms"]
        print(f"fem42 {row['variant']}: kernel {row['kernel_ms']:.4f} ms "
              f"({fem_flat.numel() * 4 / row['kernel_ms'] / 1e6:.0f} GB/s, "
              f"{row['bound_share']:.0%} of its {row['bound_ms']:.4f} ms bound), "
              f"chained {row['ms']:.4f} ms; on the same plan B1 b=8 "
              f"{spmm_ms[8]:.4f} ms, B2 b=16 {spmm_ms[16]:.4f} ms (phase 3, a "
              f"single call each: {kernels['bsr_spmm_packed_resident']['ms']:.4f}, "
              f"{kernels['bsr_spmm_packed']['ms']:.4f} ms)  [{card}]")
    torch.cuda.synchronize()
    for f in probes:
        launches[f.__name__] = f.launches
        if f.launches < 1:
            raise AssertionError(f"the probe never launched {f.__name__}")
    print(f"probe launches {{{', '.join(f'{f.__name__}: {f.launches}' for f in probes)}}}"
          f", {len(rows)} sweep rows; phase 10 in {time.perf_counter() - t10:.1f} s")
    del fem_op, fem_vals, fem_flat
    torch.cuda.empty_cache()
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **kernels[name])
        for name, (src, rep) in KERNELS.items()
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
