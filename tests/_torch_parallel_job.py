"""The multi-process side of the row-mesh parity tests
(tests/test_torch_parallel_ops.py and tests/test_torch_parallel_solve.py).

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

    # paths not ported to the mesh raise NotImplementedError
    checks = {
        "amg_psolve": lambda: ShiftInvertOperator.shift(
            lap8, 0.0, psolve=lambda X: X),
        "eigsh": lambda: rtt.eigsh(coo256(), k=2, cfg=cfg()),
    }
    for name, call in checks.items():
        try:
            call()
            raised = "no"
        except NotImplementedError as e:
            raised = "ROADMAP" if "ROADMAP" in str(e) else "other"
        out[f"raises__{name}"] = np.asarray(raised)


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
    {"ops": _ops_suite, "solve": _solve_suite}[suite](mesh, out, inputs,
                                                      outdir)
    mesh.barrier()
    shutdown_cluster()
    np.savez(os.path.join(outdir, f"{suite}_r{rank}.npz"), **out)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
