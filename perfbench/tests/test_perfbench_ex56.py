"""The ex56 configuration (``petsc_ex56_ne42``) in the harness: a tiny ex56
cell end to end through ``cell_run`` on the CPU, the truth script against
a dense eigh, the shipped truth file, the B1/B2 readers on a made-up trace
with known answers, and, on the card, the full-size matrix's route to the
packed-BSR kernel."""

import json
import time
import types

import numpy as np
import pytest
import torch

from perfbench.generators import petsc_ex56
from perfbench.harness import bsr_kernel, cell_run, problem, roofline
from perfbench.harness.spec import BENCH, Cell, load_module
from perfbench.reference import petsc_ex56_truth as truth_script

CELLS = ("petsc_ex56_ne42.polish_k20_1e-7", "petsc_ex56_ne42.k100_b8")
MIXES = {
    "pol": dict(entry="rbl_polished", k=5, b=4, which="LM", bounds=[0.0, None],
                compute_dtype="float64", basis_dtype="float64", qr_method="cholqr2",
                tol=1e-7, eig_poll_cadence=16),
    "rbl32": dict(entry="rbl", k=10, b=4, which="LM", compute_dtype="float32",
                  basis_dtype="float32", matmul_precision="high", qr_method="cholqr2",
                  tol=1e-3, max_kryl_dim=200, eig_poll_cadence=16),
}
# from these cells' readings on the CPU at -ne 6, seeds 1-3 (pol: eig_err
# 2.6e-15, resid 7.1e-15, orth 1.6e-14, rq_err 1.0e-15; rbl32, ended by
# its tolerance: 4.9e-8, 1.5e-7, 1.5e-7, 4.9e-8), with room above
LIMITS = {
    "pol": {"eig_err": 1e-12, "resid": 1e-11, "orth": 1e-12, "rq_err": 1e-12},
    "rbl32": {"eig_err": 1e-5, "resid": 1e-5, "orth": 1e-5, "rq_err": 1e-6},
}


def _bench():
    with open(BENCH.parent / "BENCHMARK.json") as f:
        return json.load(f)


def _cell(mix, truth_file):
    bench = _bench()
    return Cell(
        name=f"ex56_6.{mix}", chips=1,
        config={"generator": "petsc_ex56", "ne": 6, "truth": {"file": str(truth_file)}},
        mix=MIXES[mix],
        limits={"sample": 2, "converged": mix == "pol",
                "numbers": {k: {"limit": v} for k, v in LIMITS[mix].items()}},
        end_to_end=bench["end_to_end"],
        per_layer=[(m, load_module("metrics", m["name"])) for m in bench["per_layer"]])


@pytest.fixture(scope="module")
def truth_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ex56") / "ex56_6.npz"
    w = np.linalg.eigvalsh(petsc_ex56.assemble(6).toarray())[::-1]
    np.savez(path, eigenvalues=w)
    return path


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_ex56_cell_runs_correct(truth_file, mix, trace):
    readings = {}
    r = cell_run.run(_cell(mix, truth_file), 2**31 + 4321, 0.3, trace, "cpu",
                     time.perf_counter(), readings=readings)
    assert r["correct"] is True, (r, readings)
    names = set(r["metrics"])
    if trace:
        # the harness's own timing of as_operator; no device metric off the card
        assert "operator_build_s" in names and r["metrics"]["operator_build_s"]["value"] > 0
        assert not names & {"bsr_device_ms", "bsr_roofline"}
    else:
        assert {"setup_s", "solve_s"} <= names


def test_the_ex56_cells_are_declared_with_their_files():
    bench = _bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    for name in CELLS:
        assert cells[name]["chips"] == 1 and cells[name]["config"] == "petsc_ex56_ne42"
        assert (BENCH / "limits" / f"{name}.json").is_file()
        assert (BENCH / "traffic" / f"{cells[name]['traffic']}.json").is_file()
    for m in bench["per_layer"][-3:]:
        assert m["workloads"] == list(CELLS)
        load_module("metrics", m["name"])


@pytest.mark.parametrize("ne", [4, 6])
def test_the_truth_script_equals_a_dense_eigh(ne):
    """The four mirror blocks merged give the top of the whole spectrum,
    the double eigenvalues twice, and the paired blocks agree."""
    A = petsc_ex56.assemble(ne)
    w = np.linalg.eigvalsh(A.toarray())[::-1]
    S = petsc_ex56.mirrors(ne)
    sizes = [truth_script.block_basis(S["x"], S["z"], *s).shape[1]
             for s in truth_script.SIGNS]
    assert sum(sizes) == A.shape[0]
    kept, pair = truth_script.merge(truth_script.solve_blocks(A, ne, 20, log=lambda *_: None))
    assert pair <= 1e-12 and kept.size >= 40
    np.testing.assert_allclose(kept, w[:kept.size], rtol=1e-12)


def test_the_shipped_truth_file():
    """The frozen top of ex56 -ne 42: at least the 100 wanted eigenvalues,
    descending, positive and below the norm bound, with how they were made."""
    with np.load(BENCH / "reference" / "petsc_ex56_ne42_top.npz") as f:
        w, header = f["eigenvalues"], {k: f[k] for k in f.files if k != "eigenvalues"}
    assert w.size >= 100 and np.all(np.diff(w) <= 0) and 0 < w[-1] and w[0] < 0.16
    assert int(header["ne"]) == 42 and int(header["n"]) == 232_974
    assert float(header["paired_blocks_max_rel_diff"]) <= truth_script.PAIRED
    assert "ARPACK" in str(header["made_by"]) and float(header["seconds"]) > 0


# -- the B1/B2 readers on a made-up trace -------------------------------------

US = 1000
F32 = ("void (anonymous namespace)::bsr_spmm_kernel<float, 2, (anonymous "
       "namespace)::PackedRows>(int const*, (anonymous namespace)::PackedRows, "
       "float const*, float const*, float*, int, int, int, int, int)")
F64 = F32.replace("<float,", "<double,")
ELL = F32.replace("PackedRows", "EllRows")


class Event:
    def __init__(self, kind, name, start, end, thread=1, corr=0):
        self.kind, self._name, self.s, self.e = kind, name, start * US, end * US
        self.thread, self.corr = thread, corr

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.thread

    def correlation_id(self):
        return self.corr


PROBLEM = types.SimpleNamespace(n=1000, nonzeros=20_000, A=object())


def _trace():
    """One solve: two timed applies (widths 8, f32, and 48, f64), one
    untimed B1 launch, a blocked-ELL launch and a gemm."""
    return [
        Event("user_annotation", bsr_kernel.MARK, 0, 1000),
        Event("user_annotation", "spmm", 100, 200),
        Event("cuda_runtime", "cudaLaunchKernel", 150, 152, corr=1),
        Event("kernel", F32, 160, 260, thread=7, corr=1),
        Event("user_annotation", "spmm", 300, 400),
        Event("cuda_runtime", "cudaLaunchKernel", 350, 352, corr=2),
        Event("kernel", F64, 360, 560, thread=7, corr=2),
        Event("cuda_runtime", "cudaLaunchKernel", 600, 602, corr=3),
        Event("kernel", F32, 610, 640, thread=7, corr=3),
        Event("cuda_runtime", "cudaLaunchKernel", 700, 702, corr=4),
        Event("kernel", ELL, 710, 730, thread=7, corr=4),
        Event("cuda_runtime", "cudaLaunchKernel", 800, 802, corr=5),
        Event("kernel", "gemm", 800, 900, thread=7, corr=5),
    ]


def test_a_launch_needs_the_matrix_once_and_x_and_y_at_its_width():
    """The count each launch's bound is taken from: every nonzero's value
    and int32 index, X and Y at the launch's width and dtype."""
    assert roofline.need(PROBLEM, 8, torch.float32) == (
        20_000 * 8 + 2 * 1000 * 8 * 4, 2 * 20_000 * 8)
    assert roofline.need(PROBLEM, 48, torch.float64) == (
        20_000 * 12 + 2 * 1000 * 48 * 8, 2 * 20_000 * 48)


@pytest.mark.parametrize("name,dtype", [
    (F32, torch.float32), (F64, torch.float64), (ELL, None), ("gemm", None),
    ("void (anonymous namespace)::bsr_spmm_kernel_probe<float>()", None),
])
def test_kernel_dtype_reads_the_packed_kernels_template(name, dtype):
    assert bsr_kernel.kernel_dtype(name) == dtype


def test_summarize_counts_b1_b2_and_bounds_the_timed_launches():
    out = bsr_kernel.summarize(_trace(), [8, 48], PROBLEM)
    assert out["launches"] == 3                                  # not the ELL launch
    assert out["device_ms"] == pytest.approx((100 + 200 + 30) / 1e3)
    assert out["timed_ms"] == pytest.approx((100 + 200) / 1e3)   # not the untimed one
    want = (roofline.bound_seconds(PROBLEM, 8, torch.float32)
            + roofline.bound_seconds(PROBLEM, 48, torch.float64))
    assert out["bound_ms"] == pytest.approx(1e3 * want)
    assert out["busy_ms"] == pytest.approx((100 + 200 + 30 + 20 + 100) / 1e3)
    assert "float64 1, float32 2" in out["note"]
    assert "float32 8: 1 in 0.100 ms, float64 48: 1 in 0.200 ms" in out["note"]
    ctx = types.SimpleNamespace(device=torch.device("cuda"), bsr_trace=out)
    share = load_module("metrics", "bsr_roofline").read(ctx)
    assert share == pytest.approx(100 * want / 300e-6)
    assert load_module("metrics", "bsr_device_ms").read(ctx) == pytest.approx(0.330)


@pytest.mark.parametrize("widths", [[], [8], [8, 48, 16]])
def test_no_roofline_where_the_widths_do_not_pair(widths):
    """A program without the counter keeps no widths; one that kept more
    or fewer than the "spmm" ranges cannot be paired: the device time is
    still read, the roofline is not."""
    out = bsr_kernel.summarize(_trace(), widths, PROBLEM)
    assert out["device_ms"] == pytest.approx(0.330) and out["timed_ms"] is None
    ctx = types.SimpleNamespace(device=torch.device("cuda"), bsr_trace=out)
    assert load_module("metrics", "bsr_roofline").read(ctx) is None
    assert "no widths paired" in out["note"]


def test_nothing_to_read_without_the_mark_or_off_the_card():
    assert bsr_kernel.summarize(_trace()[1:], [8, 48], PROBLEM) is None
    no_kernel = [e for e in _trace() if e.kind != "kernel" or e.name() == "gemm"]
    out = bsr_kernel.summarize(no_kernel, [8, 48], PROBLEM)
    assert out["device_ms"] is None and out["launches"] == 0
    ctx = types.SimpleNamespace(device=torch.device("cpu"))
    for name in ("bsr_device_ms", "bsr_roofline"):
        assert load_module("metrics", name).read(ctx) is None
    built = types.SimpleNamespace(program=types.SimpleNamespace(setup_parts={}))
    assert load_module("metrics", "operator_build_s").read(built) is None


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_ex56_routes_to_the_packed_kernel_and_b1_launches(card):
    """At -ne 42, ``as_operator`` with format "auto" picks the packed-BSR
    layout at plan (64, 4) in float32 and float64, and a short solve
    launches B1."""
    import rbl_tpu_torch as rt
    from rbl_tpu_torch.ops.spmm import bsr
    from rbl_tpu_torch.ops.spmm.operator import _pick_sparse_format

    prob = problem.build(json.loads((BENCH / "configs/petsc_ex56_ne42.json").read_text()))
    for dtype in (torch.float32, torch.float64):
        assert _pick_sparse_format(prob.A, dtype, card) == ("bsr", (64, 4))
    op = rt.as_operator(prob.A, dtype=torch.float32, device=card)
    assert isinstance(op, bsr.BlockSparseOperator) and (op.bm, op.unroll) == (64, 4)
    before = bsr.bsr_spmm_packed_resident.launches + bsr.bsr_spmm_packed.launches
    res = rt.rbl(op, 5, cfg=rt.RBLConfig(block_size=8, max_kryl_dim=64, device=card))
    after = bsr.bsr_spmm_packed_resident.launches + bsr.bsr_spmm_packed.launches
    assert after - before >= 64 // 8 and res.eigenvalues.size == 5
