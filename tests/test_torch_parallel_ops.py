"""The port's five sharded operators on 4 gloo CPU ranks against the JAX
package's on ``make_row_mesh(4)`` (the 8-virtual-device CPU mesh of
tests/conftest.py): the same seeded matrices and blocks, built by numpy.

Per case: the output within 1e-12 relative (f64), the host plans (``caps``,
``send_idx``, the local-extended column ids, the banded tile lists and the
row remaps) EQUAL as arrays, ``diagonal()`` within 1e-14 and the
``comm_*_per_apply`` counts equal.  The ranks run as one spawned job
(tests/_torch_parallel_job.py) with a timeout; each rank's results come
back as an .npz.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rbl_tpu.parallel import dist_spmm as JD
from rbl_tpu.parallel.mesh import make_row_mesh, shard_rows

import _torch_parallel_job as J

NDEV = J.OPS_RANKS
CASES = ["lap", *J.OPS_CASES]


def _jax_op(case, mesh, mats):
    if case == "lap":
        return JD.ShardedLaplacian2D(nx=32, ny=16, mesh=mesh,
                                     _dtype=jnp.float64), 32 * 16
    kind, mat, kw = J.OPS_CASES[case]
    A = mats[mat]
    if kind == "ShardedBlockSparseOperator":
        kw = dict(kw, dtype=jnp.float64)
    elif kind != "ShardedRectCooSpMM":
        kw = dict(kw, dtype=np.float64)
    else:
        kw = dict(dtype=np.float64)
    return getattr(JD, kind).from_scipy(A, mesh, **kw), A.shape[1]


# the JAX operator's global banded fields a rank's part is sliced from
_FIELDS = {
    "ShardedEllSpMM": ("cols", "vals", "send_idx"),
    "ShardedCooSpMM": ("rows", "cols", "vals", "send_idx"),
    "ShardedBlockSparseOperator": ("tile_cols", "hcount", "rptr", "vals",
                                   "send_idx", "diag"),
    "ShardedRectCooSpMM": ("rows", "cols", "vals"),
}
_STATICS = {
    "ShardedEllSpMM": ("_n", "caps"),
    "ShardedCooSpMM": ("_n", "caps"),
    "ShardedBlockSparseOperator": ("_n", "H", "bm", "bk", "unroll", "caps"),
    "ShardedRectCooSpMM": ("_m", "_ncols"),
}


@pytest.fixture(scope="module")
def jax_side(eight_devices):
    mesh = make_row_mesh(NDEV)
    mats = J.ops_matrices()
    mats["rect_T"] = mats["rect"].T.tocsr()
    out = {}
    for case in CASES:
        op, rows_in = _jax_op(case, mesh, mats)
        X = J.ops_block(rows_in)
        Y = np.asarray(op.apply(shard_rows(jnp.asarray(X), mesh)))
        out[case] = (op, Y)
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_ops")
    inputs = {}
    for case in J.ARRAY_CASES:
        op = jax_side[case][0]
        kind = J.OPS_CASES[case][0]
        for f in _FIELDS[kind]:
            inputs[f"{case}__a_{f}"] = np.asarray(getattr(op, f))
        for f in _STATICS[kind]:
            v = getattr(op, f)
            inputs[f"{case}__s_{f}"] = np.asarray(-1 if v is None else v)
    np.savez(d / "ops_inputs.npz", **inputs)
    return J.run_job("ops", NDEV, str(d), timeout=240)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _rank_part(kind, field, arr, r, op):
    """Rank r's part of the JAX operator's global array ``field``."""
    a = np.asarray(arr)
    if kind == "ShardedEllSpMM" and field in ("cols", "vals"):
        ml = a.shape[1] // NDEV
        return a[:, r * ml : (r + 1) * ml]
    if field == "send_idx":
        return a[r]
    if field == "diag":
        ml = a.shape[0] // NDEV
        return a[r * ml : (r + 1) * ml]
    return a.reshape(NDEV, -1, *a.shape[1:])[r]


def _check(prefix, case, jax_side, ranks):
    jop, Y = jax_side[case]
    got = np.concatenate([rk[f"{prefix}__out"] for rk in ranks])
    assert got.shape == Y.shape
    assert _rel(got, Y) < 1e-12
    if case == "lap":
        d = np.concatenate([rk["lap__diag"] for rk in ranks])
        np.testing.assert_array_equal(d, np.asarray(jop.diagonal()))
        return
    kind = J.OPS_CASES[case][0]
    caps = getattr(jop, "caps", None)  # the rectangular factor has none
    for rk in ranks:
        want = np.asarray(-1 if caps is None else caps)
        np.testing.assert_array_equal(rk[f"{prefix}__caps"], want)
    for r, rk in enumerate(ranks):
        for f in _FIELDS[kind]:
            if f == "diag":
                continue
            np.testing.assert_array_equal(
                rk[f"{prefix}__{f}"], _rank_part(kind, f, getattr(jop, f), r, jop),
                err_msg=f"{case} rank {r} {f}")
    if kind != "ShardedRectCooSpMM":
        d = np.concatenate([rk[f"{prefix}__diag"] for rk in ranks])
        ref = np.asarray(jop.diagonal())
        np.testing.assert_allclose(d, ref, rtol=0, atol=1e-14 * np.abs(ref).max())
        m = ("comm_blocks_per_apply" if kind == "ShardedBlockSparseOperator"
             else "comm_rows_per_apply")
        for rk in ranks:
            assert int(rk[f"{prefix}__comm"]) == getattr(jop, m)()


@pytest.mark.parametrize("case", CASES)
def test_sharded_operator_matches_jax(case, jax_side, ranks):
    _check(case, case, jax_side, ranks)


@pytest.mark.parametrize("case", J.ARRAY_CASES)
def test_operator_from_jax_arrays_matches_jax(case, jax_side, ranks):
    """utils.convert.operator_from_arrays slices rank r's part of the JAX
    operator's global banded arrays: the same plan, the same product."""
    _check(f"arrays_{case}", case, jax_side, ranks)


def test_ghost_paths_move_boundary_blocks_only(ranks):
    """The banded matrix pays its two neighbour shifts only, each a few
    boundary blocks/rows, far below an all-gather's volume; the dense
    coupling falls back to the all-gather."""
    ml = J.OPS_N // NDEV
    caps = ranks[0]["bsr_band__caps"]
    assert caps[0] > 0 and caps[-1] > 0 and np.all(caps[1:-1] == 0)
    assert int(ranks[0]["bsr_band__comm"]) < (J.OPS_N - ml) // 16
    assert int(ranks[0]["coo_band__comm"]) <= 2 * 20
    assert int(ranks[0]["ell_dense__caps"]) == -1
    assert int(ranks[0]["ell_dense__comm"]) == J.OPS_N - ml
