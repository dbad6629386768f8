"""The port's scaling_bench (rbl_tpu_torch/benchmarks/scaling_bench.py)
against the JAX package's benchmarks/scaling_bench.py, on the CPU.

The comm-growth table's counts are host plans, so they are compared here
in one process: the port's ``comm_row`` on a ``RowMesh`` of 2, 4 and 8
ranks (no process group: the plans need only the mesh's size and rank)
against the JAX package's ``ShardedCooSpMM`` and
``ShardedBlockSparseOperator`` on ``make_row_mesh`` of tier-1's virtual
devices, at the script's default size (n = 262,144, bandwidth 256) and
where the packed plan cannot band (``bsr_error``).  The sharded step and
the rank body run in the gloo job of tests/test_torch_parallel_ops.py.
"""

import numpy as np
import pytest
import torch

import _torch_parity as P  # noqa: F401 — caps torch's threads
import jax.numpy as jnp

from rbl_tpu.parallel import dist_spmm as JD
from rbl_tpu.parallel.mesh import make_row_mesh
from rbl_tpu_torch.benchmarks import scaling_bench as SB
from rbl_tpu_torch.parallel.mesh import RowMesh

B = 8


def _jax_row(A, ndev):
    """The JAX script's comm-growth counts (scaling_bench.py:172-190)."""
    mesh = make_row_mesh(ndev)
    coo = JD.ShardedCooSpMM.from_scipy(A, mesh, dtype=np.float32, exchange="ghost")
    row = {"coo_ghost_rows": int(coo.comm_rows_per_apply())}
    try:
        bsr = JD.ShardedBlockSparseOperator.from_scipy(A, mesh, dtype=jnp.float32)
        gblocks = int(sum(bsr.caps)) * ndev
        row["bsr_ghost_blocks"] = gblocks
        row["bsr_ghost_kb"] = round(gblocks * bsr.bk * B * 4 / 1024, 1)
    except ValueError as e:
        row["bsr_error"] = str(e)[:80]
    return row


@pytest.fixture(scope="module")
def fixed_matrix():
    """The table's matrix at the script's default rows per rank and 8
    ranks (n = 262,144, diagonals 0, ±1, ±256)."""
    args = SB._parser().parse_args([])
    return SB.banded(np.random.default_rng(0), args.rows_per_dev * 8, 256)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_comm_growth_counts_match_jax(ndev, fixed_matrix, eight_devices):
    _, row = SB.comm_row(fixed_matrix, RowMesh(None, ndev, 0, torch.device("cpu")), B)
    assert "bsr_error" not in row
    assert row == _jax_row(fixed_matrix, ndev)


def test_comm_growth_reports_a_plan_that_cannot_band(eight_devices):
    """n = 4,224 does not split into 8 bands of 128-row blocks: both
    packages record ``bsr_error`` beside the COO plan's ghost rows."""
    A = SB.banded(np.random.default_rng(0), 4224, 256)
    _, row = SB.comm_row(A, RowMesh(None, 8, 0, torch.device("cpu")), B)
    want = _jax_row(A, 8)
    assert set(row) == set(want) == {"coo_ghost_rows", "bsr_error"}
    assert row["coo_ghost_rows"] == want["coo_ghost_rows"]


def test_step_inputs_are_the_jax_scripts():
    """step_arrays draws as scaling_bench.py:84-91 does: Qi, Qprev from the
    QR of two normal blocks, then Bi, from one generator."""
    rng = np.random.default_rng(0)
    Qi = np.linalg.qr(rng.standard_normal((2048, B)))[0]
    Qprev = np.linalg.qr(rng.standard_normal((2048, B)))[0]
    Bi = rng.standard_normal((B, B))
    got = SB.step_arrays(np.random.default_rng(0), 2048, B)
    for a, b in zip(got, (Qi, Qprev, Bi)):
        assert np.array_equal(a, b)
