"""The port's packed-BSR sweeps (rbl_tpu_torch/benchmarks/bsr_tile_sweep.py
and bsr_lane_bench.py) against the JAX package's benchmarks/, on the CPU.

Fixture parity: both packages' ``main`` run with ``BlockSparseOperator.
from_scipy`` and ``time_apply`` replaced by recorders (the recorder's
apply is scipy's product), at the JAX sizes but fem_elasticity_3d(4) for
fem3d-30: every plan's matrix, (bm, U) and X, and every block the lane
sweep applies, are the JAX script's bit for bit.  Then the port's scripts
on small fixtures against scipy (every plan's operator; the lane sweep's
own asserts and its two panel gathers bitwise equal), and the lane
sweep's JSON keys.
"""

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

import _torch_parity as P
import rbl_tpu_torch as rtt
from rbl_tpu_torch.benchmarks import bsr_lane_bench as tlb
from rbl_tpu_torch.benchmarks import bsr_tile_sweep as tts
from rbl_tpu_torch.benchmarks import spmm_bench as tsb

FEM = 4
WIDTHS = ["8", "64"]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


@dataclasses.dataclass
class Rec:
    """A packed operator that records what it was built from and applies
    scipy's product (numpy in and out, or torch with ``torch_io``)."""

    A: object
    kw: dict
    log: list
    torch_io: bool = False
    panel_gather: str = "swap"
    H: int = 1
    nnz_blocks: int = 0

    @property
    def vals(self):
        return torch.zeros(1) if self.torch_io else np.zeros(1)

    @property
    def rptr(self):
        return np.zeros(1)

    @property
    def bm(self):
        return self.kw.get("bm") or 16

    @property
    def unroll(self):
        return self.kw.get("unroll") or 4

    def apply(self, X):
        x = np.array(X)
        self.log.append(("apply", self.panel_gather, x))
        if np.array_equal(x, np.repeat(x[:, :1], x.shape[1], axis=1)):
            y = np.repeat(self.A @ x[:, :1], x.shape[1], axis=1)
        else:
            y = self.A @ x
        return torch.from_numpy(y) if self.torch_io else y


def _record(mp, cls, script, log, torch_io):
    def from_scipy(A, *a, **kw):
        kw = {k: v for k, v in kw.items() if k in ("bm", "unroll", "panel")}
        log.append(("build", kw, A))
        return Rec(A, kw, log, torch_io)

    mp.setattr(cls, "from_scipy", from_scipy)
    mp.setattr(script, "time_apply", lambda op, X, reps, **kw: log.append(
        ("time", op.panel_gather, np.array(X))) or 1e-3)


@pytest.fixture(scope="module")
def recorded():
    """{script: (JAX log, port log)}."""
    import rbl_tpu as rt
    import rbl_tpu.utils.fem as jfem

    jsb = P.jax_bench("spmm_bench")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        fem = jfem.fem_elasticity_3d
        mp.setattr(jfem, "fem_elasticity_3d", lambda nx: fem(FEM))
        for name, tmod, jargs, targs in (
                ("bsr_tile_sweep", tts, ["--reps", "1"],
                 ["--reps", "1", "--fem", str(FEM)]),
                ("bsr_lane_bench", tlb, ["--reps", "1", "--widths", *WIDTHS],
                 ["--reps", "1", "--widths", *WIDTHS])):
            jlog, tlog = [], []
            _record(mp, rt.BlockSparseOperator, jsb, jlog, False)
            mp.setattr(sys, "argv", [f"{name}.py", *jargs])
            with contextlib.redirect_stdout(io.StringIO()):
                P.jax_bench(name).main()
            _record(mp, rtt.BlockSparseOperator, tmod, tlog, True)
            with contextlib.redirect_stdout(io.StringIO()):
                tmod.main([*targs, "--device", "cpu"])
            out[name] = (jlog, tlog)
    finally:
        mp.undo()
    return out


def _same_event(j, t):
    assert j[0] == t[0]
    if j[0] == "build":
        assert j[1] == t[1]
        assert P.csr_equal(t[2], j[2])
    else:
        assert j[1] == t[1]
        assert t[2].dtype == j[2].dtype == np.float32
        assert np.array_equal(t[2], j[2])


@pytest.mark.parametrize("plan", range(2 * len(tts.CONFIGS)))
def test_tile_sweep_plan_is_the_jax_scripts(plan, recorded):
    """Plan ``plan`` of the sweep (fem3d's 8, then blocky-64k's): the same
    matrix, (bm, U) and X as the JAX script, bit for bit."""
    jlog, tlog = recorded["bsr_tile_sweep"]
    assert len(jlog) == len(tlog) == 2 * 2 * len(tts.CONFIGS)
    for k in (2 * plan, 2 * plan + 1):  # its build, then its timed X
        _same_event(jlog[k], tlog[k])
    bm, U = tts.CONFIGS[plan % len(tts.CONFIGS)]
    assert tlog[2 * plan][1] == {"bm": bm, "unroll": U}


def test_lane_sweep_draws_are_the_jax_scripts(recorded):
    """The lane sweep's builds (auto plan, then panels), every block it
    applies for its checks and every X it times, in order, bit for bit."""
    jlog, tlog = recorded["bsr_lane_bench"]
    assert [e[0] for e in jlog] == [e[0] for e in tlog]
    assert [e[0] for e in tlog].count("time") == len(WIDTHS) + 2
    for j, t in zip(jlog, tlog):
        _same_event(j, t)


def test_tile_sweep_operators_match_scipy(monkeypatch):
    """Every plan the port's sweep builds (fem3d-4, blocky 4,096), applied
    to the X it times, within 1e-5 of scipy's product; one row a plan."""
    seen = []
    monkeypatch.setattr(tts, "time_apply",
                        lambda op, X, reps, **kw: seen.append((op, X)) or 1e-3)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = tts.main(["--reps", "1", "--fem", str(FEM), "--blocky-n", "4096",
                         "--device", "cpu"])
    rng = np.random.default_rng(0)
    mats = [tsb.fem3d(FEM), tsb.blocky_matrix(rng, 4096)]
    assert len(rows) == len(seen) == 2 * len(tts.CONFIGS)
    for i, (op, X) in enumerate(seen):
        A = mats[i // len(tts.CONFIGS)]
        bm, U = tts.CONFIGS[i % len(tts.CONFIGS)]
        assert (op.bm, op.unroll) == (bm, U) == (rows[i]["bm"], rows[i]["U"])
        assert rows[i]["tiles"] == op.nnz_blocks
        assert rows[i]["steps"] == op.rptr.shape[0] * op.H
        ref = A.astype(np.float64) @ X.numpy().astype(np.float64)
        assert P.rel_err(op.apply(X).numpy(), ref) < 1e-5


@pytest.fixture(scope="module")
def lane_run():
    """The port's lane sweep on blocky 4,096 with time_apply stubbed: its
    checks against scipy run as they are."""
    mp = pytest.MonkeyPatch()
    outs = []
    real = rtt.BlockSparseOperator.apply

    def apply(self, X):
        Y = real(self, X)
        if self.panel:
            outs.append((self.panel_gather, Y))
        return Y

    try:
        mp.setattr(tlb, "time_apply", lambda op, X, reps, **kw: 1e-3)
        mp.setattr(rtt.BlockSparseOperator, "apply", apply)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lines = tlb.main(["--reps", "1", "--blocky-n", "4096", "--device", "cpu"])
    finally:
        mp.undo()
    return lines, buf.getvalue(), outs


def test_lane_sweep_checks_pass_and_panels_agree(lane_run):
    lines, text, outs = lane_run
    assert [ln["metric"] for ln in lines] == (
        [f"bsr_blocky4k_b{b}" for b in (8, 16, 32, 64, 128)]
        + ["bsr_blocky4k_panel_concat_b8", "bsr_blocky4k_panel_swap_b8"])
    assert [json.loads(s) for s in text.splitlines()[1:]] == lines
    assert [g for g, _ in outs] == ["concat", "swap"]
    assert torch.equal(outs[0][1], outs[1][1])


def test_lane_sweep_json_keys(lane_run):
    lines, _, _ = lane_run
    assert {frozenset(ln) for ln in lines} == P.json_key_sets(
        f"{P.ROOT}/benchmarks/bsr_lane_bench.py")


def test_lane_sweep_raises_on_a_wrong_product(monkeypatch):
    """The JAX script's assert is kept: an operator off scipy by more than
    1e-5 stops the sweep."""
    real = rtt.BlockSparseOperator.apply
    monkeypatch.setattr(rtt.BlockSparseOperator, "apply",
                        lambda self, X: real(self, X) * 1.001)
    monkeypatch.setattr(tlb, "time_apply", lambda op, X, reps, **kw: 1e-3)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(AssertionError, match="against scipy"):
            tlb.main(["--reps", "1", "--blocky-n", "1024", "--widths", "8",
                      "--device", "cpu"])
