"""Parity of the port's packed block-sparse SpMM (rbl_tpu_torch/ops/spmm/bsr.py)
with the JAX package's Pallas kernels (rbl_tpu/ops/spmm/pallas_bsr.py).

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them (tests/test_sparse_formats.py); the port's
wrapper runs its plain PyTorch version on a CPU tensor.  Tolerances: 1e-5
relative in f32 (both sides accumulate in f32 in different orders), 1e-12
in f64.  The CUDA kernel itself is compared on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import bsr_from_jax, duplicate_coo, messy_sym, random_sym, rel_err
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
    A = MATRICES[name]()
    assert tbsr.pick_tile_plan(A) == jbsr.pick_tile_plan(A)


# each value of bm, U and b appears, with both dtypes and both entry points
KERNEL_CASES = [
    ("random517", 16, 4, 4), ("tiny9", 32, 8, 8),
    ("messy", 64, 4, 16), ("dupcoo", 128, 8, 16),
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
    """The port's own from_scipy (auto plan) holds the JAX operator's arrays."""
    A = fem_elasticity_3d(3)
    jop = jbsr.BlockSparseOperator.from_scipy(A, dtype=np.float64, interpret=True)
    top = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64)
    assert (top.bm, top.unroll, top.H, top._n) == (jop.bm, jop.unroll, jop.H, jop._n)
    for f in ("tile_cols", "hcount", "rptr", "vals", "diag"):
        np.testing.assert_array_equal(getattr(top, f).numpy(), np.asarray(getattr(jop, f)))


@pytest.mark.parametrize("b", [8, 16])
def test_apply_entry_point_rule_and_cpu_launch_count(b, monkeypatch):
    """apply picks the entry point by X's padded bytes (the JAX package's
    8 MB rule); on a CPU tensor neither launches the CUDA kernel."""
    A = random_sym(300, 0.05, seed=1)
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=16, unroll=4)
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
    op = tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=16, unroll=4)
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
        tbsr.BlockSparseOperator.from_scipy(A, dtype=torch.bfloat16)
