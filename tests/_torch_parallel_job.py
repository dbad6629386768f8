"""The multi-process side of the row-mesh parity tests
(tests/test_torch_parallel_ops.py, tests/test_torch_parallel_solve.py and
tests/test_torch_parallel_scipy.py).

``run_job(suite, nranks, outdir)`` spawns ``nranks`` CPU processes of this
file, joined into one gloo process group; each rank builds the port's
sharded operators (or solves) on ``make_row_mesh(device="cpu")`` for every
case of the suite and writes its results to ``<outdir>/<suite>_r<rank>.npz``
for the tests to compare with the JAX package's in-process mesh.  The
matrices are made here from seeds with numpy and scipy, so both sides build
the same ones.  A rank that fails, or a job that outlives its timeout (a
deadlock), fails the tests at once: the whole process group is killed.

This file imports nothing of JAX: the ranks run the PyTorch package only.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# --- the cases' matrices (shared with the tests) -------------------------

OPS_N, OPS_B, OPS_RANKS = 512, 4, 4
SOLVE_RANKS = 2
# the poll race runs on a 64² Laplacian solve long enough (740 columns)
# for several non-blocking harvests
RACE_NX, RACE_K = 64, 8


def sym(M):
    return sp.csr_matrix(M + M.T)


def band_matrix(n, offsets, seed):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(o)) for o in offsets]
    return sym(sp.diags(diags, offsets))


def ops_matrices():
    """The operator-parity matrices (n = 512): a banded one (two-neighbour
    coupling), a random one and a dense-coupling one (all-gather), a band
    with long-range arcs (ghosts on far shifts), and a skewed one with a
    few dense rows."""
    n = OPS_N
    A_band = band_matrix(n, (-20, -1, 0, 1, 20), 11)
    A_rand = sym(sp.random(n, n, density=0.02, random_state=12))
    A_row = band_matrix(n, (-9, -1, 0, 1, 9), 21)
    M = A_row.tolil(copy=True)
    for i in range(0, n, 97):
        M[i, (i + 3 * 64 + 11) % n] = 1.5
        M[(i + 3 * 64 + 11) % n, i] = 1.5
    A_far = sp.csr_matrix(M)
    A_dense = sym(sp.random(n, n, density=0.15, random_state=23))
    rng = np.random.default_rng(3)
    S = sp.random(n, n, density=0.01, random_state=4).tolil()
    for r in rng.choice(n, 3, replace=False):
        S[r, rng.choice(n, n // 2, replace=False)] = 1.0
    A_skew = sym(S)
    B_rect = sp.random(320, 128, density=0.06,
                       random_state=np.random.default_rng(21)).tocsr()
    return dict(band=A_band, rand=A_rand, far=A_far, dense=A_dense,
                skew=A_skew, rect=B_rect)


def ops_block(rows, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, OPS_B))


# (operator, matrix, options): the port's class name and how it is built
OPS_CASES = {
    "ell_band": ("ShardedEllSpMM", "band", dict(exchange="auto")),
    "ell_far": ("ShardedEllSpMM", "far", dict(exchange="auto")),
    "ell_dense": ("ShardedEllSpMM", "dense", dict(exchange="auto")),
    "ell_dense_ghost": ("ShardedEllSpMM", "dense", dict(exchange="ghost")),
    "ell_allgather": ("ShardedEllSpMM", "band", dict(exchange="allgather")),
    "coo_band": ("ShardedCooSpMM", "band", dict(exchange="auto")),
    "coo_far": ("ShardedCooSpMM", "far", dict(exchange="auto")),
    "coo_skew": ("ShardedCooSpMM", "skew", dict(exchange="auto")),
    "coo_dense": ("ShardedCooSpMM", "dense", dict(exchange="auto")),
    "bsr_band": ("ShardedBlockSparseOperator", "band", dict(bm=16, bk=16)),
    "bsr_rand": ("ShardedBlockSparseOperator", "rand", dict(bm=16, bk=16)),
    "rect_fwd": ("ShardedRectCooSpMM", "rect", {}),
    "rect_bwd": ("ShardedRectCooSpMM", "rect_T", {}),
}
# sharded operators built from the JAX operator's global arrays
# (utils.convert.operator_from_arrays), compared like the cases above
ARRAY_CASES = ("bsr_band", "coo_far", "ell_band", "rect_fwd")


def lap_exact(nx, ny, k):
    ex = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    ey = 2 - 2 * np.cos(np.pi * np.arange(1, ny + 1) / (ny + 1))
    return np.sort(np.add.outer(ex, ey).ravel())[::-1][:k]


def coo256():
    """tests/fake_cluster_worker.py's symmetric 256-row COO matrix."""
    rng = np.random.default_rng(7)
    M = sp.random(256, 256, density=0.03, random_state=rng)
    return sp.csr_matrix(M + M.T)


def bsr512():
    """tests/test_distributed.py's sharded-BSR solve matrix."""
    return band_matrix(512, (-17, 0, 17), 13)


def indefinite(n=400):
    """tests/test_fuzz_spectra.py's "indefinite" spectrum."""
    return np.concatenate([-(n + 10.0 - np.arange(5.0)), np.arange(1.0, n - 4.0)])


def gap_clusters(n=400):
    """tests/test_fuzz_spectra.py's "gap_clusters" spectrum at its mesh
    case's seed (3)."""
    from _torch_gates import shape_diag

    return shape_diag("gap_clusters", 3, n)


def pencil():
    """tests/test_distributed.py's sharded pencil: A = diag(1..300) and a
    tridiagonal SPD M, n = 256, with scipy's generalized spectrum."""
    import scipy.linalg

    n = 256
    A = sp.diags(np.linspace(1.0, 300.0, n)).tocsr()
    M = sp.diags([0.3 * np.ones(n - 1), 2.0 * np.ones(n),
                  0.3 * np.ones(n - 1)], [-1, 0, 1]).tocsr()
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    return A, M, w


def pencil_sigma(w):
    """A shift between the pencil's second and third eigenvalues (an
    interior one in the middle of the spectrum takes ~20,000 MINRES
    iterations, too long for the gloo ranks here)."""
    return float(w[1] + 0.3 * (w[2] - w[1]))


def svd_sparse_sm():
    """A well-conditioned sparse 96 × 32 factor (σ in about [1.5, 3]) for
    the smallest triplets."""
    return (sp.random(96, 32, density=0.1, random_state=np.random.default_rng(5))
            + 2.0 * sp.eye(96, 32)).tocsr()


def svd_sparse():
    return sp.random(320, 128, density=0.06,
                     random_state=np.random.default_rng(21)).tocsr()


def svd_dense():
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((96, 40)))
    V, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    s = np.geomspace(10.0, 0.1, 40)
    return (U * s) @ V.T


# --- the scipy front door and the multigrid on the mesh ----------------------

SCIPY_RANKS = 2
# fem_elasticity_3d(7): n = 1,344 (a band of 672 rows holds 224 whole
# nodes), packed at bm = bk = 32; the coarsest sizes give the grid
# hierarchy 2 levels (1,344, 192) and the aggregation one 2 (1,344, 81).
# fem_elasticity_3d(15) (n = 11,520) takes the grid hierarchy's defaults
# (2 levels) and the default level-0 operator (bk = 128).
FEM_NX, FEM_BIG = 7, 15
GRID_COARSEST, SA_COARSEST = 150, 60
HIERARCHIES = ("grid_f64", "sa_f64", "grid_f32", "sa_f32")
# the pencil solve's outer tol (ν-space, ν ~ 100): loose for time, its
# eigenvalues still well within the test's 1e-9 of scipy's
PENCIL_TOL = 1e-5
# the shift-invert applies' inner MINRES target
SI_INNER_TOL = 1e-13
# the 2-D Laplacian that eigsh's auto route gives an aggregation AMG
# (a host sparse matrix of n ≥ 4,000 and a shift at the bottom)
LAP_NX = 64
LAP_SIGMA = 0.05  # an interior shift of the 64² Laplacian (FDM's cases)


def fem_dims(nx=FEM_NX):
    """The node grid of fem_elasticity_3d(nx) after clamping."""
    return (nx, nx + 1, nx + 1)


def fem_pencil(nx=FEM_NX):
    """K = fem_elasticity_3d(nx) and its lumped mass (numpy diagonal)."""
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d, lumped_mass

    return fem_elasticity_3d(nx), lumped_mass(nx)


def laplacian_2d(nx=LAP_NX):
    T = sp.diags([-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    return sp.kronsum(T, T).tocsr()


def pencil_mass(n=300):
    """An SPD diagonal M for eigsh's pencil on eig_sym."""
    return sp.diags(np.linspace(1.0, 2.0, n)).tocsr()


def vcycle_block(n, seed=5):
    return np.random.default_rng(seed).standard_normal((n, 4))


def eig_sym(n=300, seed=0):
    """tests/test_torch_compat.py's symmetric sparse matrix."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng)
    A = sp.csr_matrix(A + A.T)
    A.setdiag(rng.standard_normal(n))
    return A


def three_isolated():
    """tests/test_torch_compat.py's maxiter spectrum: three isolated values
    on top of 197 in [0, 1]."""
    d = np.concatenate([np.linspace(0.0, 1.0, 197), [1000.0, 900.0, 800.0]])
    return sp.diags(d).tocsr()


def three_isolated_sm():
    """Its shift-invert twin: three isolated values at the bottom."""
    d = 1.0 + np.arange(300.0) / 1e5
    return sp.diags(np.concatenate([[1e-3, 2e-3, 3e-3], d[:197]]))


def svd_lm():
    """A sparse 200 × 80 factor (both sides split over 2 ranks: the
    sharded COO pair)."""
    return sp.random(200, 80, density=0.1,
                     random_state=np.random.default_rng(31)).tocsr()


def svd_sm():
    """tests/test_torch_compat.py's SM factor (dense: replicated)."""
    rng = np.random.default_rng(21)
    return rng.standard_normal((70, 50)) + 5.0 * np.eye(70, 50)


def split_node_matrix():
    """An SPD matrix of 225 nodes of 6 unknowns (n = 1,350): a band of
    675 rows over 2 ranks splits a node."""
    n = 1350
    return sp.diags([-np.ones(n - 1), 4.0 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def pack_hierarchy(name, levels, transfers, coarse_inv, nu) -> dict:
    """A hierarchy in ``amg_from_arrays``'s layout as flat .npz entries."""
    out = {f"{name}__nlev": np.asarray(len(levels)),
           f"{name}__coarse_inv": np.asarray(coarse_inv),
           f"{name}__nu": np.asarray(nu)}
    for i, lv in enumerate(levels):
        p = f"{name}__L{i}"
        out[f"{p}__kind"] = np.asarray(lv["kind"])
        out[f"{p}__Winv"] = np.asarray(lv["Winv"])
        for k, v in lv["arrays"].items():
            out[f"{p}__a_{k}"] = np.asarray(v)
        for k, v in lv["static"].items():
            out[f"{p}__s_{k}"] = np.asarray(v)
    for i, t in enumerate(transfers):
        p = f"{name}__T{i}"
        for k, v in t.items():
            if k == "P1s":
                for j, P in enumerate(v):
                    out[f"{p}__P1s{j}"] = np.asarray(P)
            else:
                out[f"{p}__{k}"] = np.asarray(v)
    return out


def unpack_hierarchy(z: dict, name):
    """``pack_hierarchy``'s inverse: (levels, transfers, coarse_inv, nu)."""
    levels, transfers = [], []
    for i in range(int(z[f"{name}__nlev"])):
        p = f"{name}__L{i}"
        levels.append(dict(
            kind=str(z[f"{p}__kind"]), Winv=z[f"{p}__Winv"],
            arrays={k[len(p) + 4:]: v for k, v in z.items()
                    if k.startswith(f"{p}__a_")},
            static={k[len(p) + 4:]: v for k, v in z.items()
                    if k.startswith(f"{p}__s_")}))
        p = f"{name}__T{i}"
        t = {k[len(p) + 2:]: v for k, v in z.items()
             if k.startswith(f"{p}__") and "__P1s" not in k}
        t["type"] = str(t["type"])
        if t["type"] == "grid":
            t["P1s"] = [z[f"{p}__P1s{j}"] for j in range(3)]
        transfers.append(t)
    return levels, transfers, z[f"{name}__coarse_inv"], int(z[f"{name}__nu"])


# --- the launcher ------------------------------------------------------------


GATHER_N = 24 * 24 + 1  # uneven slabs: 289 and 288 rows


def gather_block():
    """The (GATHER_N, 3) block of the checkpoint-gather and QR cases."""
    return np.random.default_rng(9).standard_normal((GATHER_N, 3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(suite: str, nranks: int, outdir: str, timeout: float = 300.0,
            extra_env: dict | None = None) -> list[dict]:
    """Run ``suite`` on ``nranks`` gloo CPU ranks; returns each rank's
    results as a dict.  Raises (after killing every rank) when a rank
    fails or the job outlives ``timeout`` seconds."""
    port = _free_port()
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(nranks), str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True, start_new_session=True, cwd=ROOT,
        )
        for r in range(nranks)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            out, err = p.communicate(timeout=left)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        _kill(procs)
        raise AssertionError(
            f"{suite} job on {nranks} ranks outlived {timeout} s (deadlock?)")
    failed = [(r, rc, err) for r, (rc, _o, err) in enumerate(outs) if rc != 0]
    if failed:
        _kill(procs)
        raise AssertionError("\n".join(
            f"{suite} rank {r} exited {rc}:\n{err[-4000:]}"
            for r, rc, err in failed))
    results = []
    for r in range(nranks):
        with np.load(os.path.join(outdir, f"{suite}_r{r}.npz"),
                     allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
        results[-1]["_outdir"] = np.asarray(outdir)  # files the ranks left
    return results


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        p.wait()


# --- the ranks --------------------------------------------------------------


def _ops_suite(mesh, out, inputs, outdir):
    import torch

    from rbl_tpu_torch.parallel import dist_spmm as D
    from rbl_tpu_torch.utils.convert import operator_from_arrays

    mats = ops_matrices()
    mats["rect_T"] = mats["rect"].T.tocsr()

    def record(case, op, rows_in):
        X = ops_block(rows_in)
        Xl = mesh.shard_rows(torch.from_numpy(X))
        out[f"{case}__out"] = op.apply(Xl).numpy()
        for f in ("cols", "vals", "rows", "send_idx", "tile_cols", "hcount",
                  "rptr"):
            if hasattr(op, f):
                out[f"{case}__{f}"] = getattr(op, f).numpy()
        caps = getattr(op, "caps", None)
        out[f"{case}__caps"] = np.asarray(-1 if caps is None else caps)
        if hasattr(op, "diagonal"):
            out[f"{case}__diag"] = op.diagonal().numpy()
        for m in ("comm_rows_per_apply", "comm_blocks_per_apply"):
            if hasattr(op, m):
                out[f"{case}__comm"] = np.asarray(getattr(op, m)())

    lap = D.ShardedLaplacian2D(nx=32, ny=16, mesh=mesh, dtype=torch.float64)
    record("lap", lap, 32 * 16)
    for case, (kind, mat, kw) in OPS_CASES.items():
        A = mats[mat]
        op = getattr(D, kind).from_scipy(A, mesh, dtype=torch.float64, **kw)
        record(case, op, A.shape[1])
    for case in ARRAY_CASES:
        kind, mat, _kw = OPS_CASES[case]
        arrays = {k.split("__", 1)[1]: v for k, v in inputs.items()
                  if k.startswith(f"{case}__a_")}
        arrays = {k[2:]: v for k, v in arrays.items()}
        static = {k.split("__s_", 1)[1]: v.item() if v.ndim == 0 else tuple(v)
                  for k, v in inputs.items() if k.startswith(f"{case}__s_")}
        if static.get("caps") == -1:
            static["caps"] = None
        op = operator_from_arrays(kind, arrays, static, device="cpu",
                                  mesh=mesh)
        record(f"arrays_{case}", op, mats[mat].shape[1])


class _Future:
    """A poll whose task runs when it is submitted (``late=False``: done()
    is True at once) or only when its result is asked for (``late=True``:
    done() stays False until then)."""

    def __init__(self, fn, args, kwargs, late):
        self._call = (fn, args, kwargs)
        self._done = False
        if not late:
            self.result()

    def done(self):
        return self._done

    def result(self):
        if not self._done:
            fn, args, kwargs = self._call
            self._value = fn(*args, **kwargs)
            self._done = True
        return self._value


class _EagerExecutor:
    late = False

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        return _Future(fn, args, kwargs, self.late)

    def shutdown(self, wait=True):
        pass


class _LateExecutor(_EagerExecutor):
    late = True


def _solve_suite(mesh, out, inputs, outdir):
    import torch

    import rbl_tpu_torch as rtt
    from rbl_tpu_torch.parallel import dist_spmm as D
    from rbl_tpu_torch.parallel.distributed import cluster_info

    f64 = torch.float64
    info = cluster_info()
    out["info__keys"] = np.array(sorted(info), dtype="U32")
    out["info__count"] = np.asarray([info["process_index"],
                                     info["process_count"],
                                     info["global_device_count"]])

    def cfg(**kw):
        return rtt.RBLConfig(mesh=mesh, device="cpu", **kw)

    def keep(case, res, op_for_residual=None):
        out[f"{case}__w"] = np.asarray(res.eigenvalues, dtype=np.float64)
        out[f"{case}__converged"] = np.asarray(bool(res.converged))
        V = res.eigenvectors
        if V is not None:
            n = op_for_residual.n
            out[f"{case}__V"] = mesh.gather_rows(V, n).numpy()

    lap = D.ShardedLaplacian2D(nx=32, ny=32, mesh=mesh, dtype=f64)
    keep("lap", rtt.rbl(lap, 4, 4, cfg=cfg(block_size=4, max_kryl_dim=256)),
         lap)
    out["lap__stats"] = np.asarray([mesh.stats["all_reduce"],
                                    mesh.stats["exchange"],
                                    mesh.stats["agree"]])
    coo = D.ShardedCooSpMM.from_scipy(coo256(), mesh, dtype=f64)
    keep("coo", rtt.rbl(coo, 3, 4, cfg=cfg(block_size=4, max_kryl_dim=256)),
         coo)
    # the SA end (the spectral-norm bound's power method on the mesh), the
    # deflated next pairs with a global v0, and the pinned-host basis tier
    keep("coo_sa", rtt.rbl(coo, 3, 4, which="SA",
                           cfg=cfg(block_size=4, max_kryl_dim=256)), coo)
    A256 = coo256().toarray()
    lam, vec = np.linalg.eigh(A256)
    top2 = vec[:, np.argsort(-np.abs(lam))[:2]]
    keep("coo_deflated", rtt.rbl(
        coo, 3, 4, cfg=cfg(block_size=4, max_kryl_dim=256), deflate=top2,
        v0=np.linspace(1.0, 2.0, 256)), coo)
    keep("lap_host_tier", rtt.rbl(lap, 4, 4, cfg=cfg(
        block_size=4, max_kryl_dim=256, basis_device_cap_cols=64)), lap)
    bsr = D.ShardedBlockSparseOperator.from_scipy(bsr512(), mesh, dtype=f64,
                                                  bm=16, bk=16)
    keep("bsr", rtt.rbl(bsr, 5, 4, cfg=cfg(block_size=4, max_kryl_dim=256)),
         bsr)
    diag = rtt.DiagonalOperator(torch.from_numpy(indefinite()))
    keep("indefinite", rtt.rbl(diag, 5, 5, cfg=cfg(block_size=5)), diag)
    gap = rtt.DiagonalOperator(torch.from_numpy(gap_clusters()))
    keep("gap_clusters", rtt.rbl(gap, 5, 5, cfg=cfg(block_size=5)), gap)
    lap24 = D.ShardedLaplacian2D(nx=24, ny=24, mesh=mesh, dtype=f64)
    keep("polished", rtt.rbl_polished(lap24, 4, cfg=cfg(block_size=2,
                                                         tol=1e-7), b=2),
         lap24)
    keep("restarted", rtt.rbl_restarted(
        lap24, 4, cfg=cfg(tol=1e-9, restart_kryl_dim=60), b=2), lap24)
    keep("filtered", rtt.rbl_filtered(lap24, 4, 4, cfg=cfg(tol=1e-9)), lap24)
    for case, B in (("svd_sparse", svd_sparse()), ("svd_dense", svd_dense())):
        res = rtt.rbl_svd(B, 4, b=4, cfg=cfg(block_size=4))
        out[f"{case}__s"] = np.asarray(res.s, dtype=np.float64)
        m, n = B.shape
        out[f"{case}__U"] = mesh.gather_rows(res.U, m).numpy()
        out[f"{case}__V"] = mesh.gather_rows(res.V, n).numpy()

    # shift-invert and the pencils on the mesh: the sharded pencil (M
    # through its Chebyshev series) at the LA end and at an interior
    # shift, a lumped (diagonal) M applied replicated, MINRES on the
    # sharded stencil, and rbl_svd's smallest triplets (sparse: sharded
    # factors; dense: replicated)
    A_p, M_p, w_p = pencil()
    Ash = D.ShardedCooSpMM.from_scipy(A_p, mesh, dtype=f64)
    Msh = D.ShardedCooSpMM.from_scipy(M_p, mesh, dtype=f64)
    pcfg = cfg(block_size=4, tol=1e-9, max_kryl_dim=256)
    keep("pencil_la", rtt.rbl_generalized(Ash, Msh, 4, cfg=pcfg, which="LA"),
         Ash)
    keep("pencil_sigma", rtt.rbl_generalized(
        Ash, Msh, 2, cfg=pcfg, which="LM", sigma=pencil_sigma(w_p)), Ash)
    keep("pencil_lumped", rtt.rbl_generalized(
        coo, sp.diags(np.linspace(1.0, 2.0, 256)).tocsr(), 3,
        cfg=cfg(block_size=4, tol=1e-9, max_kryl_dim=256), which="LA"), coo)
    lap8 = D.ShardedLaplacian2D(nx=8, ny=8, mesh=mesh, dtype=f64)
    from rbl_tpu_torch.ops.minres import ShiftInvertOperator

    keep("si_lap", rtt.rbl(ShiftInvertOperator.shift(lap8, 0.0), 2, 2,
                           cfg=cfg(block_size=2, tol=1e-9)), lap8)
    for case, B in (("svd_sm_sparse", svd_sparse_sm()),
                    ("svd_sm_dense", svd_dense())):
        res = rtt.rbl_svd(B, 2, b=2, cfg=cfg(block_size=2, tol=1e-9),
                          which="SM")
        out[f"{case}__s"] = np.asarray(res.s, dtype=np.float64)
        m, n = B.shape
        out[f"{case}__U"] = mesh.gather_rows(res.U, m).numpy()
        out[f"{case}__V"] = mesh.gather_rows(res.V, n).numpy()

    # checkpoints on the mesh: rank 0 writes the whole blocks, a resume
    # keeps each rank's rows.  The sweep is cut after 3 chunks and resumed
    # (a copy of the cut file is kept for the JAX package to resume);
    # rbl_restarted runs one restart and resumes from load_restart_state;
    # the polish stops after one filter pass and restarts from its X
    import shutil

    from rbl_tpu_torch.solver.lanczos import SweepAborted
    from rbl_tpu_torch.utils.checkpoint import (
        load_polish_state,
        load_restart_state,
    )

    ck = os.path.join(outdir, "sweep.npz")
    ck_cfg = cfg(block_size=4, max_kryl_dim=256, sweep_checkpoint_path=ck)
    try:
        rtt.rbl(lap, 4, 4, cfg=ck_cfg.replace(
            fault_inject_abort_after_chunks=3))
        out["ck_sweep__aborted"] = np.asarray(False)
    except SweepAborted:
        out["ck_sweep__aborted"] = np.asarray(True)
    mesh.barrier()
    if mesh.rank == 0:
        shutil.copy(ck, os.path.join(outdir, "sweep_cut.npz"))
    mesh.barrier()
    keep("ck_sweep", rtt.rbl(lap, 4, 4, cfg=ck_cfg), lap)
    out["ck_sweep__left"] = np.asarray(os.path.exists(ck))
    rk = os.path.join(outdir, "restart.npz")
    rcfg = cfg(tol=1e-9, restart_kryl_dim=60)
    rtt.rbl_restarted(lap24, 4, cfg=rcfg, b=2, max_restarts=1,
                      checkpoint_path=rk)
    keep("ck_restart", rtt.rbl_restarted(
        lap24, 4, cfg=rcfg, b=2, state=load_restart_state(rk, device="cpu")),
        lap24)
    pk = os.path.join(outdir, "polish.npz")
    # two passes at a gain of 10 a pass: one filter pass (and its save),
    # far from tol
    first = rtt.rbl_polished(lap24, 4, cfg=cfg(block_size=2, tol=1e-7), b=2,
                             max_passes=2, target_gain=10.0,
                             checkpoint_path=pk)
    out["ck_polish__first_converged"] = np.asarray(bool(first.converged))
    X = load_polish_state(pk)["X"]
    out["ck_polish__rows"] = np.asarray(X.shape[0])
    keep("ck_polish", rtt.chebyshev_refine(
        lap24, X, 4, cfg=cfg(block_size=2, tol=1e-7), extra_random=0,
        checkpoint_path=pk), lap24)
    out["ck_polish__left"] = np.asarray(os.path.exists(pk))

    # a save sends every rank's rows to rank 0's host (no all-gather on any
    # rank; bf16 arrives as f32), and a write that fails on rank 0 raises
    # on every rank instead of leaving rank 1 waiting
    from rbl_tpu_torch.utils.checkpoint import save_polish_state

    Xg = torch.from_numpy(gather_block())
    for case, dt in (("f64", f64), ("bf16", torch.bfloat16)):
        before = dict(mesh.stats)
        save_polish_state(os.path.join(outdir, f"gathered_{case}.npz"),
                          mesh.shard_rows(Xg).to(dt), np.zeros(3), np.zeros(3),
                          1, mesh=mesh, n=GATHER_N)
        out[f"ck_gather_{case}__counts"] = np.asarray(
            [mesh.stats[k] - before[k] for k in ("all_gather", "gather_host")])
    try:
        save_polish_state(os.path.join(outdir, "no_such_dir", "p.npz"),
                          mesh.shard_rows(Xg), np.zeros(3), np.zeros(3), 1,
                          mesh=mesh, n=GATHER_N)
        out["ck_fail__raised"] = np.asarray("nothing")
    except Exception as e:
        out["ck_fail__raised"] = np.asarray(type(e).__name__)

    # Householder on the mesh gathers the block, so it needs the global n
    from rbl_tpu_torch.ops.qr import block_qr

    try:
        block_qr(mesh.shard_rows(Xg), "householder", mesh)
        out["qr__no_n"] = np.asarray("nothing")
    except ValueError:
        out["qr__no_n"] = np.asarray("ValueError")
    Q, R = block_qr(mesh.shard_rows(Xg), "householder", mesh, n=GATHER_N)
    out["qr__Q"] = mesh.gather_rows(Q, GATHER_N).numpy()
    out["qr__R"] = R.numpy()

    # the poll race: each eig poll is done at once on rank 0 (run when it
    # is submitted) and only when waited for on rank 1 (run by result()),
    # so at every non-blocking harvest the two ranks' done() disagree
    import concurrent.futures

    real = concurrent.futures.ThreadPoolExecutor
    concurrent.futures.ThreadPoolExecutor = (
        _EagerExecutor if mesh.rank == 0 else _LateExecutor)
    before = mesh.stats["agree"]
    before_over = mesh.stats["agree_overruled"]
    lap64 = D.ShardedLaplacian2D(nx=RACE_NX, ny=RACE_NX, mesh=mesh, dtype=f64)
    try:
        res = rtt.rbl(lap64, RACE_K, 4, cfg=cfg(block_size=4,
                                                max_kryl_dim=1000, tol=1e-10))
    finally:
        concurrent.futures.ThreadPoolExecutor = real
    keep("race", res, lap64)
    out["race__agree"] = np.asarray(mesh.stats["agree"] - before)
    out["race__overruled"] = np.asarray(
        mesh.stats["agree_overruled"] - before_over)


def _scipy_suite(mesh, out, inputs, outdir):
    import torch
    from scipy.sparse.linalg import ArpackNoConvergence

    import rbl_tpu_torch as rtt
    from rbl_tpu_torch.ops.amg import AssembledMultigrid
    from rbl_tpu_torch.parallel import dist_spmm as D
    from rbl_tpu_torch.utils.convert import amg_from_arrays

    f64 = torch.float64
    K, mass = fem_pencil()
    n = K.shape[0]

    def cfg(**kw):
        return rtt.RBLConfig(mesh=mesh, device="cpu", **kw)

    def whole(V, rows):
        return mesh.gather_rows(V, rows).numpy()

    # the mesh V-cycles: the JAX hierarchy carried across, and the port's
    # own build, both on K's bands (the packed operator, bm = bk = 32)
    K_sh = {dt: D.ShardedBlockSparseOperator.from_scipy(
        K, mesh, dtype=dt, bm=32, bk=32) for dt in (f64, torch.float32)}
    X = vcycle_block(n)
    amgs = {}
    for h in HIERARCHIES:
        build, prec = h.split("_")
        dt = f64 if prec == "f64" else torch.float32
        levels, transfers, coarse_inv, nu = unpack_hierarchy(inputs, h)
        levels[0]["A"] = K  # an aggregation level 0 assembles P from it
        kw = dict(dtype=dt, mesh=mesh, op0=K_sh[dt])
        amgs[h, "converted"] = amg_from_arrays(levels, transfers, coarse_inv,
                                               nu, **kw)
        amgs[h, "built"] = (
            AssembledMultigrid.from_grid(K, fem_dims(), dof=3,
                                         coarsest_n=GRID_COARSEST, **kw)
            if build == "grid" else
            AssembledMultigrid.smoothed_aggregation(
                K, dof=3, coarsest_n=SA_COARSEST, **kw))
        Xl = mesh.shard_rows(torch.from_numpy(X).to(dt))
        for route in ("converted", "built"):
            amg = amgs[h, route]
            before = mesh.stats["all_reduce"]
            Y = amg.psolve(Xl)
            out[f"vcycle_{h}_{route}__reduces"] = np.asarray(
                mesh.stats["all_reduce"] - before)
            out[f"vcycle_{h}_{route}__levels"] = np.asarray(len(amg.levels))
            out[f"vcycle_{h}_{route}__Y"] = whole(Y, n)

    K_big, _ = fem_pencil(FEM_BIG)
    big = AssembledMultigrid.from_grid(K_big, fem_dims(FEM_BIG), dof=3,
                                       mesh=mesh)
    out["vcycle_fem15__route"] = np.asarray(type(big.levels[0].op).__name__)
    out["vcycle_fem15__Y"] = whole(big.psolve(mesh.shard_rows(
        torch.from_numpy(vcycle_block(K_big.shape[0])))), K_big.shape[0])

    # no level on the band (n ≤ coarsest_n): the dense inverse takes the
    # gathered whole
    small = AssembledMultigrid.from_grid(K, fem_dims(), dof=3, coarsest_n=n,
                                         mesh=mesh)
    out["vcycle_nolevels__levels"] = np.asarray(len(small.levels))
    out["vcycle_nolevels__Y"] = whole(small.psolve(mesh.shard_rows(
        torch.from_numpy(X))), n)

    # the vibration pencil, M sharded (its Chebyshev roots), with the mesh
    # V-cycle as the inner psolve
    amg_mesh = amgs["grid_f64", "built"]
    M_sh = D.ShardedCooSpMM.from_scipy(sp.diags(mass).tocsr(), mesh,
                                       dtype=f64)
    before = dict(mesh.stats)
    res, info = rtt.rbl_generalized(
        K_sh[f64], M_sh, 4, cfg=cfg(block_size=4, tol=PENCIL_TOL),
        which="LM", sigma=0.0, inner_psolve=amg_mesh.psolve, return_info=True)
    out["pencil_amg__w"] = np.asarray(res.eigenvalues, dtype=np.float64)
    out["pencil_amg__converged"] = np.asarray(bool(res.converged))
    out["pencil_amg__V"] = whole(res.eigenvectors, n)
    out["pencil_amg__counts"] = np.asarray(
        [info.inner_solves, info.inner_iterations,
         mesh.stats["all_reduce"] - before["all_reduce"]])

    # one apply of each shift-invert operator over the sharded K with an
    # explicit psolve: the mesh cycle (taken as it is) and an unsharded
    # hierarchy's (gathered, cycled whole, own rows kept); the pencil's
    # with M lumped (its exact diagonal root, the rank's rows)
    from rbl_tpu_torch.ops.generalized import GeneralizedShiftInvertOperator
    from rbl_tpu_torch.ops.minres import ShiftInvertOperator

    amg_whole = AssembledMultigrid.from_grid(K, fem_dims(), dof=3,
                                             coarsest_n=GRID_COARSEST,
                                             device="cpu")
    lo, hi = mesh.row_range(n)
    zero = torch.zeros((), dtype=f64)
    ops = {
        "si_mesh_amg": ShiftInvertOperator.shift(
            K_sh[f64], 0.0, inner_tol=SI_INNER_TOL, psolve=amg_mesh.psolve),
        "si_replicated": ShiftInvertOperator.shift(
            K_sh[f64], 0.0, inner_tol=SI_INNER_TOL, psolve=amg_whole.psolve),
        "gsi_mesh_amg": GeneralizedShiftInvertOperator(
            A=K_sh[f64], M=M_sh, sigma=zero, inner_tol=SI_INNER_TOL,
            msqrt=rtt.DiagonalOperator(torch.from_numpy(np.sqrt(mass[lo:hi]))),
            psolve=amg_mesh.psolve),
    }
    Xs = mesh.shard_rows(torch.from_numpy(vcycle_block(n, seed=6)))
    for case, op in ops.items():
        before = dict(mesh.stats)
        Y = op.apply(Xs)
        out[f"{case}__counts"] = np.asarray(
            [op.counts["iterations"],
             mesh.stats["all_reduce"] - before["all_reduce"],
             mesh.stats["all_gather"] - before["all_gather"]])
        out[f"{case}__Y"] = whole(Y, n)

    # a replicated Laplacian keeps the exact FDM solve: the gathered
    # block solved whole, the own rows kept
    lap_n = LAP_NX * LAP_NX
    si_fdm = ShiftInvertOperator.shift(
        D.on_mesh(rtt.Laplacian2D(LAP_NX, LAP_NX, device="cpu"), mesh),
        LAP_SIGMA)
    before = dict(mesh.stats)
    Y = si_fdm.apply(mesh.shard_rows(torch.from_numpy(
        vcycle_block(lap_n, seed=7))))
    out["si_fdm_replicated__precond"] = np.asarray(si_fdm.precond)
    out["si_fdm_replicated__counts"] = np.asarray(
        [si_fdm.counts["iterations"],
         mesh.stats["all_reduce"] - before["all_reduce"],
         mesh.stats["all_gather"] - before["all_gather"]])
    out["si_fdm_replicated__Y"] = whole(Y, lap_n)

    # eigsh: the plain ends, BE, σ = 0 with the AMG its auto route builds
    # (replicated), an interior σ on the Laplacian operator (FDM), and a
    # pencil
    def keep_eigsh(case, got):
        w, V = got if isinstance(got, tuple) else (got, None)
        out[f"{case}__w"] = np.asarray(w)
        if V is not None:
            out[f"{case}__V"] = V

    keep_eigsh("eigsh_lm", rtt.eigsh(eig_sym(300, 0), k=6, tol=1e-9,
                                     cfg=cfg()))
    keep_eigsh("eigsh_sa", rtt.eigsh(eig_sym(300, 1), k=5, which="SA",
                                     tol=1e-9, return_eigenvectors=False,
                                     cfg=cfg()))
    keep_eigsh("eigsh_be", rtt.eigsh(eig_sym(300, 4), k=5, which="BE",
                                     tol=1e-9, cfg=cfg()))
    keep_eigsh("eigsh_sigma0_auto", rtt.eigsh(laplacian_2d(), 4, sigma=0.0,
                                              cfg=cfg()))
    keep_eigsh("eigsh_lap_fdm", rtt.eigsh(
        rtt.Laplacian2D(LAP_NX, LAP_NX, device="cpu"), 4, sigma=LAP_SIGMA,
        cfg=cfg()))
    keep_eigsh("eigsh_pencil_la", rtt.eigsh(
        eig_sym(300, 2), 4, M=pencil_mass(), which="LA", tol=1e-9, cfg=cfg()))

    # maxiter exhausted: ArpackNoConvergence on every rank, with the whole
    # partial vectors
    for case, call in (
            ("maxiter", lambda: rtt.eigsh(three_isolated(), k=8, maxiter=1,
                                          ncv=10, b=1, cfg=cfg())),
            ("maxiter_sm", lambda: rtt.eigsh(
                three_isolated_sm(), k=8, which="SM", maxiter=1, ncv=10, b=1,
                tol=1e-12, cfg=cfg()))):
        try:
            call()
            out[f"{case}__raised"] = np.asarray("nothing")
        except ArpackNoConvergence as e:
            out[f"{case}__raised"] = np.asarray(type(e).__name__)
            out[f"{case}__w"] = np.asarray(e.eigenvalues)
            out[f"{case}__V"] = np.asarray(e.eigenvectors)

    for case, B, kw in (("svds_lm", svd_lm(), dict(k=5)),
                        ("svds_sm", svd_sm(), dict(k=4, which="SM"))):
        U, sv, Vh = rtt.svds(B, cfg=cfg(), **kw)
        out[f"{case}__s"] = np.asarray(sv)
        out[f"{case}__U"] = U
        out[f"{case}__Vh"] = Vh

    try:  # a whole block, as an unsharded solve would hand it
        amg_mesh.psolve(torch.from_numpy(X))
        out["whole_block__raised"] = np.asarray("nothing")
    except ValueError:
        out["whole_block__raised"] = np.asarray("ValueError")
    try:
        AssembledMultigrid.smoothed_aggregation(split_node_matrix(), dof=6,
                                                coarsest_n=100, mesh=mesh)
        out["split_node__raised"] = np.asarray("nothing")
    except ValueError:
        out["split_node__raised"] = np.asarray("ValueError")


def _worker(suite, rank, nranks, port, outdir):
    import torch

    torch.set_num_threads(1)
    from rbl_tpu_torch.parallel.distributed import (
        initialize_cluster,
        shutdown_cluster,
    )
    from rbl_tpu_torch.parallel.mesh import make_row_mesh

    initialize_cluster(f"localhost:{port}", nranks, rank, device="cpu",
                       timeout_s=120)
    mesh = make_row_mesh(nranks, device="cpu")
    inputs = {}
    path = os.path.join(outdir, f"{suite}_inputs.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            inputs = {k: z[k] for k in z.files}
    out = {}
    {"ops": _ops_suite, "solve": _solve_suite,
     "scipy": _scipy_suite}[suite](mesh, out, inputs, outdir)
    mesh.barrier()
    shutdown_cluster()
    np.savez(os.path.join(outdir, f"{suite}_r{rank}.npz"), **out)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
