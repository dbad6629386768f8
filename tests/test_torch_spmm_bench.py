"""The port's spmm_bench (rbl_tpu_torch/benchmarks/spmm_bench.py) against
the JAX package's benchmarks/spmm_bench.py, on the CPU.

Fixture parity: both scripts' ``main`` run with their operator
constructors and ``time_apply`` replaced by recorders that build and apply
nothing, at ``--n 8192`` (the JAX script's fem3d-30 swapped for
fem_elasticity_3d(4) in both; blocky-64k at its full size): every row's
matrix has the same CSR arrays and every X the same values, bit for bit,
in the same order.  Then the port's operators on those fixtures against
scipy, ``time_apply``'s chain and marginal, the resident-X boundary of the
banded row, and the JSON line's keys.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as P
import rbl_tpu_torch as rtt
from rbl_tpu_torch.benchmarks import spmm_bench as tsb
from rbl_tpu_torch.ops.spmm import bsr as tbsr
from rbl_tpu_torch.ops.spmm import coo as tcoo

N, FEM = 8192, 4
ROWS = ["stencil-2d", "dia", "bsr-pallas", "ell-scan", "bsr-fem3d",
        "bsr128-fem3d", "dia-fem3d", "auto-fem3d", "bsr-blocky",
        "bsr128-blocky", "hyb(skew)", "coo-segsum(skew)"]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


class Rec:
    """What a constructor was given; builds nothing."""

    def __init__(self, kind, A=None, **kw):
        self.kind, self.A, self.kw = kind, A, kw


def _recording(monkeypatch, rt, coo_mod, script, calls):
    """Replace the constructors of package ``rt`` and the script's
    time_apply by recorders; ``calls`` gets (constructor, matrix or grid
    side, X as numpy) for each timed row."""

    def ctor(kind):
        return lambda A, *a, **kw: Rec(kind, A, **kw)

    monkeypatch.setattr(rt, "Laplacian2D",
                        lambda *a, **kw: Rec("stencil", kw.get("nx", a[0] if a else None)))
    for cls, kind in ((rt.BlockSparseOperator, "bsr"), (rt.DiaOperator, "dia"),
                      (rt.SparseEllOperator, "ell"), (coo_mod.HybOperator, "hyb"),
                      (coo_mod.CooOperator, "coo")):
        monkeypatch.setattr(cls, "from_scipy", ctor(kind))
    monkeypatch.setattr(rt, "as_operator", ctor("auto"))

    def time_apply(op, X, reps, **kw):
        calls.append((op.kind, op.kw.get("bm"), op.A, np.array(X)))
        return 1e-3

    monkeypatch.setattr(script, "time_apply", time_apply)


def _row_names(out: str):
    return [line.split("[row]")[1].split()[0] for line in out.splitlines()
            if "[row]" in line]


@pytest.fixture(scope="module")
def recorded():
    """(JAX calls, JAX row names, port calls, port row names)."""
    import rbl_tpu as rt
    import rbl_tpu.ops.spmm.coo as jcoo
    import rbl_tpu.utils.fem as jfem

    jsb = P.jax_bench("spmm_bench")
    mp = pytest.MonkeyPatch()
    try:
        jcalls, tcalls = [], []
        _recording(mp, rt, jcoo, jsb, jcalls)
        fem = jfem.fem_elasticity_3d
        mp.setattr(jfem, "fem_elasticity_3d", lambda nx: fem(FEM))
        mp.setattr(sys, "argv", ["spmm_bench.py", "--n", str(N), "--reps", "1"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jsb.main()
        jrows = _row_names(buf.getvalue())
        _recording(mp, rtt, tcoo, tsb, tcalls)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows, _ = tsb.main(["--n", str(N), "--reps", "1", "--fem", str(FEM),
                                "--device", "cpu"])
        assert _row_names(buf.getvalue()) == [r[0] for r in rows]
        return jcalls, jrows, tcalls, [r[0] for r in rows]
    finally:
        mp.undo()


def test_same_rows_in_the_same_order(recorded):
    jcalls, jrows, tcalls, trows = recorded
    assert jrows == trows == ROWS
    assert [c[:2] for c in jcalls] == [c[:2] for c in tcalls]


@pytest.mark.parametrize("row", ROWS)
def test_row_fixture_is_the_jax_scripts_bit_for_bit(row, recorded):
    """The row's matrix (CSR arrays, or the stencil's grid side) and its X
    block equal the JAX script's draws exactly."""
    jcalls, _, tcalls, _ = recorded
    i = ROWS.index(row)
    (_, _, jA, jX), (_, _, tA, tX) = jcalls[i], tcalls[i]
    if row == "stencil-2d":
        assert jA == tA == int(np.sqrt(N))
    else:
        assert P.csr_equal(tA, jA)
    assert tX.dtype == jX.dtype == np.float32
    assert np.array_equal(tX, jX)


def _fixtures(n, b, fem, blocky_n):
    """The port's fixtures by name, drawn in the script's order."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, b)).astype(np.float32)
    side, Xl = tsb.stencil(rng, n, b)
    A = tsb.banded_matrix(rng, n)
    F = tsb.fem3d(fem)
    Xf = rng.standard_normal((F.shape[0], b)).astype(np.float32)
    G = tsb.blocky_matrix(rng, blocky_n)
    Xg = rng.standard_normal((G.shape[0], b)).astype(np.float32)
    S = tsb.skew_matrix(rng, n)
    from rbl_tpu_torch.utils.suitesparse import laplacian_2d

    return {"stencil": (laplacian_2d(side, side), Xl), "banded": (A, X),
            "fem3d": (F, Xf), "blocky": (G, Xg), "skew": (S, X)}


def test_port_operators_match_scipy(monkeypatch):
    """The port's script on the CPU (n 8,192, fem3d-4, blocky 4,096): every
    operator it times, applied to the X it times, within 1e-5 of scipy's
    product (f32), on the solver's column-major block."""
    seen = []
    monkeypatch.setattr(tsb, "time_apply",
                        lambda op, X, reps, **kw: seen.append((op, X)) or 1e-3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows, best = tsb.main(["--n", str(N), "--reps", "1", "--fem", str(FEM),
                               "--blocky-n", "4096", "--device", "cpu"])
    fx = _fixtures(N, 8, FEM, 4096)
    which = ["stencil", "banded", "banded", "banded", "fem3d", "fem3d", "fem3d",
             "fem3d", "blocky", "blocky", "skew", "skew"]
    assert [r[0] for r in rows] == ROWS and len(seen) == len(which)
    for (op, X), name, row in zip(seen, which, ROWS):
        A, Xh = fx[name]
        assert np.array_equal(X.numpy(), Xh)
        assert X.stride() == (1, X.shape[0]), "not the solver's column-major block"
        ref = A.astype(np.float64) @ Xh.astype(np.float64)
        assert P.rel_err(op.apply(X).numpy(), ref) < 1e-5, row
    assert json.loads(buf.getvalue().splitlines()[-1]) == best


def test_json_line_has_the_jax_keys(monkeypatch):
    monkeypatch.setattr(tsb, "time_apply", lambda op, X, reps, **kw: 1e-3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, best = tsb.main(["--n", "4096", "--reps", "1", "--fem", "3",
                            "--blocky-n", "1024", "--device", "cpu"])
    assert {frozenset(best)} == P.json_key_sets(f"{P.ROOT}/benchmarks/spmm_bench.py")
    assert best["metric"] == "spmm_best_gnnz_per_s"


class _Doubler:
    """An operator that doubles X and records every input."""

    def __init__(self):
        self.inputs = []

    def apply(self, X):
        self.inputs.append(X.clone())
        return 2.0 * X


def test_time_apply_chains_normalized_applies():
    """The marginal per apply (runs of r applies take 0.5 + 0.25·r s) and
    the JAX step: every apply but a run's first gets z / ‖z[:1024]‖."""
    r = 2
    steps = [0.0, 1.0] + [0.0, 0.5 + 0.25 * r] * 3 + [0.0, 0.5 + 1.0 * r] * 3
    clock = iter(np.cumsum(steps))
    op = _Doubler()
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((3000, 4)))
    dt = tsb.time_apply(op, X, r, clock=lambda: next(clock))
    assert dt == pytest.approx(0.25)
    assert len(op.inputs) == 1 + 3 * r + 3 * 4 * r
    second = op.inputs[2]  # the warm-up's one apply, then a run's second
    assert float(torch.linalg.vector_norm(second[:1024])) == pytest.approx(1.0)
    assert not torch.equal(op.inputs[1], op.inputs[1 + r])  # salted runs


@pytest.mark.parametrize("n, b, entry", [
    (262_144, 8, "bsr_spmm_packed_resident"),   # the banded row: X is 8 MiB
    (262_144, 9, "bsr_spmm_packed"),
    (65_536, 32, "bsr_spmm_packed_resident"),   # bsr_lane_bench's b = 32
    (65_536, 33, "bsr_spmm_packed"),
])
def test_resident_x_boundary(n, b, entry, monkeypatch):
    """BlockSparseOperator.apply takes B1 while the padded X is at most
    8 MiB and B2 above: the banded n = 262,144 row at b = 8 and the lane
    sweep's blocky-64k at b = 32 are exactly 8 MiB, so both stay on B1."""
    taken = []
    for name in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
        monkeypatch.setattr(tbsr, name, lambda *a, _n=name, **kw: taken.append(_n)
                            or torch.zeros((a[2].shape[0] * kw["bm"], a[4].shape[1])))
    op = tbsr.BlockSparseOperator.from_scipy(sp.eye(n, format="csr"),
                                             device="cpu")
    op.apply(torch.zeros((n, b)))
    assert taken == [entry]
    assert (n * b * 4 <= tbsr._RESIDENT_X_BYTES) == (entry == "bsr_spmm_packed_resident")
