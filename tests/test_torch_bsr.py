"""Parity of the port's packed block-sparse SpMM (rbl_tpu_torch/ops/spmm/bsr.py)
with the JAX package's Pallas kernels (rbl_tpu/ops/spmm/pallas_bsr.py).

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them (tests/test_sparse_formats.py); the port's
wrapper runs its plain PyTorch version on a CPU tensor.  Tolerances: 1e-5
relative in f32 (both sides accumulate in f32 in different orders), 1e-12
in f64.  The CUDA kernel itself is compared on the card in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import CPU, bsr_from_jax, duplicate_coo, messy_sym, random_sym, rel_err
from rbl_tpu.ops.spmm import pallas_bsr as jbsr
from rbl_tpu.utils.fem import fem_elasticity_3d
from rbl_tpu_torch.ops.spmm import bsr as tbsr

TOL = {np.float32: 1e-5, np.float64: 1e-12}

MATRICES = {
    "random517": lambda: random_sym(517, 0.02, seed=3),   # n % 128 != 0
    "tiny9": lambda: random_sym(9, 0.4, seed=4),          # n < bm
    "messy": lambda: messy_sym(),                          # empty block-rows
    "dupcoo": lambda: duplicate_coo(),                     # repeated entries
    "fem3": lambda: fem_elasticity_3d(3),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("bm,U", [(16, 4), (32, 8), (64, 4), (128, 8)])
def test_packed_arrays_equal_jax_converter(name, bm, U):
    A = MATRICES[name]()
    want = jbsr._packed_bsr_from_scipy(A, bm, 128, U, np.float32)
    got = tbsr._packed_bsr_from_scipy(A, bm, 128, U, np.float32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["random517", "messy", "fem3", "dupcoo"])
def test_pick_tile_plan_agrees_with_jax(name):
    """The port searches the JAX package's candidate plans over the JAX
    package's tile census; it prices them with its own model of the CUDA
    kernel (stored bytes plus a cost per stored tile, fit on the card),
    whose tile count is the JAX converter's."""
    A = MATRICES[name]()
    cands = [(bm, U) for bm in (128, 64, 32, 16) for U in (4, 8, 16, 32)
             if not (U >= 32 and bm > 16)]

    def cost(plan):
        bm, U = plan
        counts = jbsr._tile_census(A, bm, 128)[4]
        tiles = tbsr._plan_tiles(counts, U)
        assert tiles == jbsr._packed_bsr_from_scipy(A, bm, 128, U, np.float32)[3].shape[0]
        return tiles * (bm * 128 * 4 + tbsr._STEP_COST_BYTES)

    best = min(cands, key=cost)
    assert tbsr.pick_tile_plan(A) == best
    assert tbsr.modeled_bsr_apply_seconds(A) == pytest.approx(
        cost(best) / tbsr._BSR_BYTES_PER_S)


# each value of bm, U and b appears, with both dtypes and both entry points;
# b = 1, 5 and 33 are not multiples of the card kernel's 4-wide column
# vectors, and 33 spans two of its 32-column CTAs
KERNEL_CASES = [
    ("random517", 16, 4, 4), ("tiny9", 32, 8, 8),
    ("messy", 64, 4, 16), ("dupcoo", 128, 8, 16),
    ("fem3", 32, 4, 1), ("random517", 64, 8, 5), ("messy", 128, 4, 33),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("entry", ["bsr_spmm_packed_resident", "bsr_spmm_packed"])
@pytest.mark.parametrize("name,bm,U,b", KERNEL_CASES)
def test_reference_matches_jax_kernel(name, bm, U, b, entry, dtype):
    A = MATRICES[name]()
    jop = jbsr.BlockSparseOperator.from_scipy(
        A, dtype=dtype, bm=bm, unroll=U, interpret=True
    )
    ncb = -(-A.shape[0] // 128)
    X = np.random.default_rng(7).standard_normal((ncb * 128, b)).astype(dtype)
    want = getattr(jbsr, entry)(
        jop.tile_cols, jop.hcount, jop.rptr, jop.vals, jnp.asarray(X),
        bm=bm, bk=128, H=jop.H, unroll=U, interpret=True,
    )
    top = bsr_from_jax(jop)
    got = tbsr.bsr_spmm_packed_reference(
        top.tile_cols, top.hcount, top.rptr, top.vals, torch.from_numpy(X),
        bm=bm, bk=128, unroll=U,
    )
    assert got.shape == tuple(want.shape)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_operator_apply_matches_jax_operator(dtype):
    """BlockSparseOperator.apply end to end (padding, the resident/streaming
    rule, the trailing slice) against the JAX operator on the same arrays."""
    A = messy_sym()
    jop = jbsr.BlockSparseOperator.from_scipy(A, dtype=dtype, interpret=True)
    top = bsr_from_jax(jop)
    for b in (3, 8):
        X = np.random.default_rng(b).standard_normal((A.shape[0], b)).astype(dtype)
        want = np.asarray(jop.apply(jnp.asarray(X)))
        got = top.apply(torch.from_numpy(X)).numpy()
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL[dtype]
    np.testing.assert_array_equal(top.diagonal().numpy(), np.asarray(jop.diag))


def test_from_scipy_builds_the_jax_operator():
    """The port's own from_scipy (auto plan) holds the JAX operator's arrays
    for that plan."""
    A = fem_elasticity_3d(3)
    top = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, device=CPU)
    jop = jbsr.BlockSparseOperator.from_scipy(A, dtype=np.float64, bm=top.bm,
                                              unroll=top.unroll, interpret=True)
    assert (top.bm, top.unroll, top.H, top._n) == (jop.bm, jop.unroll, jop.H, jop._n)
    for f in ("tile_cols", "hcount", "rptr", "vals", "diag"):
        np.testing.assert_array_equal(getattr(top, f).numpy(), np.asarray(getattr(jop, f)))


@pytest.mark.parametrize("b", [8, 16])
def test_apply_entry_point_rule_and_cpu_launch_count(b, monkeypatch):
    """apply picks the entry point by X's padded bytes (the JAX package's
    8 MB rule); on a CPU tensor neither launches the CUDA kernel."""
    A = random_sym(300, 0.05, seed=1)
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=16, unroll=4,
                                            device=CPU)
    calls = []
    entries = (tbsr.bsr_spmm_packed_resident, tbsr.bsr_spmm_packed)
    before = [f.launches for f in entries]
    for entry in ("bsr_spmm_packed_resident", "bsr_spmm_packed"):
        real = getattr(tbsr, entry)

        def spy(*a, _real=real, _entry=entry, **kw):
            calls.append(_entry)
            return _real(*a, **kw)

        monkeypatch.setattr(tbsr, entry, spy)
    # shrink the rule so that b=16 crosses it at this size: 3 col-blocks of
    # 128 rows × b f32 columns are 3·128·b·4 bytes
    monkeypatch.setattr(tbsr, "_RESIDENT_X_BYTES", 3 * 128 * 8 * 4)
    X = np.random.default_rng(0).standard_normal((300, b)).astype(np.float32)
    Y = op.apply(torch.from_numpy(X)).numpy()
    assert calls == ["bsr_spmm_packed_resident" if b == 8 else "bsr_spmm_packed"]
    assert rel_err(Y, A @ X.astype(np.float64)) < 1e-5
    assert [f.launches for f in entries] == before


def test_wrapper_rejects_malformed_operands():
    A = random_sym(200, 0.05, seed=2)
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=16, unroll=4,
                                            device=CPU)
    X = torch.zeros((256, 4), dtype=torch.float32)
    args = (op.tile_cols, op.hcount, op.rptr, op.vals)
    kw = dict(bm=16, bk=128, H=op.H, unroll=4)
    with pytest.raises(TypeError):
        tbsr.bsr_spmm_packed(*args, X.double(), **kw)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm_packed(*args, torch.zeros((8, 256)).T, **kw)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm_packed(*args, X[:200], **kw)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm_packed(op.tile_cols.long(), op.hcount, op.rptr, op.vals, X, **kw)
    with pytest.raises(TypeError):
        tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.bfloat16, device=CPU)


# ---- blocked-ELL (B3) and panel (B4) layouts -------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("bm", [16, 128])
def test_blocked_ell_arrays_equal_jax_converter(name, bm):
    A = MATRICES[name]()
    want = jbsr._blocked_ell_from_scipy(A, bm, 128, np.float32)
    got = tbsr._blocked_ell_from_scipy(A, bm, 128, np.float32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _ell_padded(A, bm, U, dtype):
    """Blocked-ELL arrays flattened over (block-row, slot), L padded with
    zero slots to a multiple of U."""
    bc, bv, nb, ncb, L = jbsr._blocked_ell_from_scipy(A, bm, 128, dtype)
    Lp = L + (-L) % U
    bc = np.pad(bc, ((0, 0), (0, Lp - L))).reshape(-1)
    bv = np.pad(bv, ((0, 0), (0, Lp - L), (0, 0), (0, 0))).reshape(-1, bm, 128)
    return bc, bv, ncb, Lp


PANEL_CASES = [(16, 4), (32, 2), (16, 8)]  # tests/test_sparse_formats.py:421-447


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bm,U", PANEL_CASES)
def test_blocked_ell_reference_matches_jax_kernel(bm, U, dtype):
    """bsr_spmm's plain version (the CPU path of the wrapper) against the
    JAX package's blocked-ELL Pallas kernel in interpret mode."""
    A = random_sym(768, 0.03, seed=3)
    bc, bv, ncb, L = _ell_padded(A, bm, U, dtype)
    X = np.random.default_rng(5).standard_normal((ncb * 128, 8)).astype(dtype)
    want = jbsr.bsr_spmm(jnp.asarray(bc), jnp.asarray(bv), jnp.asarray(X),
                         bm=bm, bk=128, L=L, unroll=U, interpret=True)
    got = tbsr.bsr_spmm(torch.from_numpy(bc), torch.from_numpy(bv),
                        torch.from_numpy(X), bm=bm, bk=128, L=L, unroll=U)
    assert got.shape == tuple(want.shape)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL[dtype]
    assert rel_err(got.numpy()[: A.shape[0]], A @ X[: A.shape[0]].astype(np.float64)) < TOL[dtype]


def test_bsr_spmm_wrapper_checks_and_cpu_launch_count():
    A = random_sym(300, 0.05, seed=1)
    bc, bv, ncb, L = _ell_padded(A, 16, 2, np.float32)
    bc, bv = torch.from_numpy(bc), torch.from_numpy(bv)
    X = torch.zeros((ncb * 128, 4))
    n0 = tbsr.bsr_spmm.launches
    tbsr.bsr_spmm(bc, bv, X, bm=16, bk=128, L=L, unroll=2)
    assert tbsr.bsr_spmm.launches == n0
    with pytest.raises(ValueError, match="multiple of unroll"):
        tbsr.bsr_spmm(bc, bv, X, bm=16, bk=128, L=L, unroll=4 if L % 4 else 3)
    with pytest.raises(ValueError):
        tbsr.bsr_spmm(bc, bv, X, bm=32, bk=128, L=L)
    with pytest.raises(TypeError):
        tbsr.bsr_spmm(bc, bv, X.double(), bm=16, bk=128, L=L)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bm,U", PANEL_CASES)
def test_panel_reference_matches_jax_operator(bm, U, dtype):
    """BlockSparseOperator(panel=True).apply on the JAX operator's own
    arrays against the JAX operator (Pallas interpret mode), both gathers;
    the two gathers agree."""
    A = random_sym(768, 0.03, seed=3)
    jop = jbsr.BlockSparseOperator.from_scipy(
        A, dtype=dtype, bm=bm, unroll=U, panel=True, interpret=True)
    top = bsr_from_jax(jop)
    assert top.panel and tuple(top.vals.shape) == tuple(jop.vals.shape)
    X = np.random.default_rng(7).standard_normal((768, 8)).astype(dtype)
    want = np.asarray(jop.apply(jnp.asarray(X)))
    got = top.apply(torch.from_numpy(X)).numpy()
    assert rel_err(got, want) < TOL[dtype]
    concat = dataclasses.replace(top, panel_gather="concat")
    np.testing.assert_array_equal(concat.apply(torch.from_numpy(X)).numpy(), got)


def test_panel_from_scipy_builds_the_jax_operator():
    A = messy_sym()
    jop = jbsr.BlockSparseOperator.from_scipy(
        A, dtype=np.float32, bm=32, unroll=4, panel=True, interpret=True)
    top = tbsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.float32, bm=32, unroll=4, panel=True, device=CPU)
    for f in ("tile_cols", "hcount", "rptr", "vals", "diag"):
        np.testing.assert_array_equal(getattr(top, f).numpy(), np.asarray(getattr(jop, f)))
    assert top.density_report() == jop.density_report()
    packed = tbsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.float32, bm=32, unroll=4, device=CPU)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((2000, 5)).astype(np.float32))
    assert rel_err(top.apply(X).numpy(), packed.apply(X).numpy()) < TOL[np.float32]


def test_panel_keeps_the_resident_x_limit_and_cpu_launch_count(monkeypatch):
    A = random_sym(300, 0.05, seed=1)
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=16,
                                            unroll=4, panel=True, device=CPU)
    X = torch.ones((300, 8))
    n0 = tbsr.bsr_spmm_panel.launches
    op.apply(X)
    assert tbsr.bsr_spmm_panel.launches == n0
    monkeypatch.setattr(tbsr, "_RESIDENT_X_BYTES", 3 * 128 * 4 * 4)
    with pytest.raises(ValueError, match="panel=False"):
        op.apply(X)
    with pytest.raises(ValueError, match="gather"):
        tbsr.bsr_spmm_panel(op.tile_cols, op.hcount, op.rptr, op.vals,
                            torch.zeros((384, 2)), bm=16, bk=128, H=op.H,
                            unroll=4, gather="stack")


# ---- the panel layout at narrower tiles (bk 32 and 64) ---------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bm,U", PANEL_CASES)
@pytest.mark.parametrize("bk", [32, 64])
def test_panel_narrow_tiles_match_jax_operator(bk, bm, U, dtype):
    """The panel operator at bk 32 and 64, as
    test_panel_reference_matches_jax_operator holds it at bk 128: the port's
    apply on the JAX operator's own arrays (built with the same bk and
    panel=True) against the JAX operator in Pallas interpret mode, both
    gathers, and the port's own from_scipy arrays equal the JAX package's."""
    A = random_sym(600, 0.03, seed=5)
    jop = jbsr.BlockSparseOperator.from_scipy(
        A, dtype=dtype, bm=bm, bk=bk, unroll=U, panel=True, interpret=True)
    top = bsr_from_jax(jop)
    assert top.panel and top.bk == bk
    assert tuple(top.vals.shape) == (jop.vals.shape[0], U * bk, bm)
    X = np.random.default_rng(11).standard_normal((600, 8)).astype(dtype)
    want = np.asarray(jop.apply(jnp.asarray(X)))
    got = top.apply(torch.from_numpy(X)).numpy()
    assert rel_err(got, want) < TOL[dtype]
    concat = dataclasses.replace(top, panel_gather="concat")
    np.testing.assert_array_equal(concat.apply(torch.from_numpy(X)).numpy(), got)
    own = tbsr.BlockSparseOperator.from_scipy(
        A, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, bm=bm, bk=bk,
        unroll=U, panel=True, device=CPU)
    for f in ("tile_cols", "hcount", "rptr", "vals"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(jop, f)))


@pytest.mark.parametrize("bk", [32, 64, 128])
def test_panel_reference_gives_zero_rows_without_chunks(bk):
    """The panel kernel's plain version, which the card's checks hold the
    kernel to, with the chunk count of every block-row that holds no
    nonzero set to 0 (a row the kernel meets with no chunk at all): those
    rows are zero and the rest equal scipy's A @ X."""
    import scipy.sparse as sp

    keep = np.ones(900)
    keep[300:600] = 0.0  # block-rows 19-36 of 16 hold no nonzero
    A = (sp.diags(keep) @ random_sym(900, 0.02, seed=2) @ sp.diags(keep)).tocsr()
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, bm=16, bk=bk,
                                            unroll=2, panel=True, device=CPU)
    per_row = np.add.reduceat(np.diff(A.indptr), np.arange(0, 900, 16))
    assert (per_row == 0).any()
    hc = op.hcount.clone()
    hc[torch.from_numpy(per_row == 0)] = 0
    ncb = -(-900 // bk)
    X = np.random.default_rng(3).standard_normal((ncb * bk, 5))
    Y = tbsr.bsr_spmm_panel_reference(op.tile_cols, hc, op.rptr, op.vals,
                                      torch.from_numpy(X), bm=16, bk=bk,
                                      unroll=2).numpy()[:900]
    want = A @ X[:900]
    assert rel_err(Y, want) < TOL[np.float64]
    empty = np.repeat(per_row == 0, 16)[:900]
    assert not Y[empty].any()
