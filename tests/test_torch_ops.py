"""Parity of the port's dense step ops, host eig functions, operators and
config (rbl_tpu_torch) with the JAX package (rbl_tpu), at f64 on the CPU.

Inputs come from numpy with a fixed seed and go to both packages.  The f64
tolerance is 1e-12 relative: both sides run the same algorithm, and only the
order of the BLAS sums differs.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rbl_tpu
import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu.ops import band as jband, contract as jcontract, eig as jeig
from rbl_tpu.ops import qr as jqr, reorth as jreorth
from rbl_tpu.parallel import memory as jmemory
from rbl_tpu_torch import config as tconfig
from rbl_tpu_torch.ops import band as tband, contract as tcontract, eig as teig
from rbl_tpu_torch.ops import qr as tqr, reorth as treorth
from rbl_tpu_torch.ops.spmm import operator as toperator
from rbl_tpu_torch.parallel import memory as tmemory
from rbl_tpu_torch.utils.convert import config_from_fields, operator_from_arrays

TOL = 1e-12


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [500, 20_000])  # one chunk; chunks + ragged tail
def test_gram_matches_jax(n):
    X, Y = _rand((n, 7), 0), _rand((n, 5), 1)
    want = np.asarray(jcontract.gram(jnp.asarray(X), jnp.asarray(Y)))
    got = tcontract.gram(_t(X), _t(Y)).numpy()
    assert rel_err(got, want) < TOL


def test_gram_bf16_operand_accumulates_in_f32():
    """A bf16 basis against an f32 block: JAX promotes to an f32 product;
    torch would round a bf16 matmul to bf16 — the port upcasts."""
    X = _rand((20_000, 6), 2).astype(np.float32)
    Y = _rand((20_000, 3), 3).astype(np.float32)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    got = tcontract.gram(Xb, torch.from_numpy(Y))
    assert got.dtype == torch.float32
    want = np.asarray(jcontract.gram(jnp.asarray(Xb.float().numpy()).astype(jnp.bfloat16),
                                     jnp.asarray(Y)))
    assert rel_err(got.numpy(), want) < 1e-5


def _cholqr_inputs():
    base = _rand((3000, 6), 4)
    scaled = base.copy()
    scaled[:, 0] *= 1e5  # the column-scale case of rbl_tpu/ops/qr.py:88-95
    deficient = base.copy()
    deficient[:, 3] = deficient[:, 1] - 2.0 * deficient[:, 2]
    return {"plain": base, "colscale1e5": scaled, "rankdeficient": deficient}


@pytest.mark.parametrize("case", ["plain", "colscale1e5", "rankdeficient"])
@pytest.mark.parametrize("passes", [2, 3])
def test_cholqr_matches_jax(case, passes):
    X = _cholqr_inputs()[case]
    Qj, Rj = jqr.cholqr(jnp.asarray(X), passes=passes)
    Qt, Rt = tqr.cholqr(_t(X), passes=passes)
    Qt, Rt, Qj, Rj = Qt.numpy(), Rt.numpy(), np.asarray(Qj), np.asarray(Rj)
    if case != "rankdeficient":
        assert rel_err(Rt, Rj) < TOL
        assert rel_err(Qt, Qj) < TOL
        assert np.abs(Qt.T @ Qt - np.eye(6)).max() < 1e-13
    else:
        # column 3 is dependent: its direction in Q is rounding noise, and
        # so are the couplings that follow it.  The columns before it and
        # their rows of R agree; the dead pivot sits at the floor in both.
        assert rel_err(Rt[:3], Rj[:3]) < TOL
        assert rel_err(Qt[:, :3], Qj[:, :3]) < TOL
        assert abs(Rt[3, 3]) < 1e-6 * abs(Rt[0, 0])
        assert abs(Rj[3, 3]) < 1e-6 * abs(Rj[0, 0])
        assert np.all(np.isfinite(Qt))
    assert rel_err(Qt @ Rt, X) < 1e-12


def test_cholqr_zero_block_stays_finite():
    """A fully deflated residual block (X = 0): the shifted Cholesky's
    absolute floor keeps the factor finite in both packages."""
    X = np.zeros((400, 4))
    Qt, Rt = tqr.cholqr(_t(X))
    Qj, Rj = jqr.cholqr(jnp.asarray(X))
    assert np.all(np.isfinite(Qt.numpy())) and np.all(np.isfinite(Rt.numpy()))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-300)


def test_householder_invariants():
    """Householder signs may differ between packages and devices: check
    QR = X, QᵀQ = I and |diag R| against JAX."""
    X = _rand((2000, 8), 5)
    Q, R = tqr.block_qr(_t(X), method="householder")
    Q, R = Q.numpy(), R.numpy()
    _, Rj = jqr.block_qr(jnp.asarray(X), method="householder")
    assert rel_err(Q @ R, X) < 1e-13
    assert np.abs(Q.T @ Q - np.eye(8)).max() < 1e-13
    assert np.allclose(np.triu(R), R)
    assert rel_err(np.abs(np.diag(R)), np.abs(np.diag(np.asarray(Rj)))) < TOL


def test_block_qr_rejects_unknown_method():
    with pytest.raises(ValueError):
        tqr.block_qr(_t(_rand((10, 2), 0)), method="gram-schmidt")


def test_project_out_and_deflate_match_jax():
    basis = np.linalg.qr(_rand((20_000, 24), 6))[0]
    W = _rand((20_000, 5), 7)
    want = np.asarray(jreorth.project_out(jnp.asarray(basis), jnp.asarray(W)))
    got = treorth.project_out(_t(basis), _t(W)).numpy()
    assert rel_err(got, want) < TOL
    got = treorth.deflate(_t(basis), _t(W)).numpy()
    assert rel_err(got, want) < TOL


def test_project_out_zero_padding_is_inert():
    """Zero columns past the stored prefix change nothing: contracting the
    prefix (the port) equals contracting the padded buffer (JAX)."""
    basis = np.linalg.qr(_rand((3000, 12), 8))[0]
    padded = np.concatenate([basis, np.zeros((3000, 20))], axis=1)
    W = _rand((3000, 4), 9)
    want = np.asarray(jreorth.project_out(jnp.asarray(padded), jnp.asarray(W)))
    got = treorth.project_out(_t(basis), _t(W)).numpy()
    assert rel_err(got, want) < TOL


def test_partial_and_local_reorth_match_jax():
    basis = np.linalg.qr(_rand((4000, 16), 10))[0]
    Qi, Qprev = _rand((4000, 4), 11), np.linalg.qr(_rand((4000, 4), 12))[0]
    a = jreorth.partial_reorth(jnp.asarray(basis), jnp.asarray(Qi),
                               jnp.asarray(Qprev), qr_method="cholqr2", passes=2)
    b = treorth.partial_reorth(_t(basis), _t(Qi), _t(Qprev),
                               qr_method="cholqr2", passes=2)
    for x, y in zip(a, b):
        assert rel_err(y.numpy(), np.asarray(x)) < TOL
    want = jreorth.local_reorth(jnp.asarray(Qi), jnp.asarray(Qprev), qr_method="cholqr2")
    got = treorth.local_reorth(_t(Qi), _t(Qprev), qr_method="cholqr2")
    assert rel_err(got.numpy(), np.asarray(want)) < TOL


def _random_band(b=4, panels=30, seed=13):
    rng = np.random.default_rng(seed)
    Tj = jband.BlockTridiagonalT(b, max_cols=panels * b + b)
    Tt = tband.BlockTridiagonalT(b, max_cols=panels * b + b)
    for p in range(panels):
        A = rng.standard_normal((b, b))
        A = A + A.T
        B = np.triu(rng.standard_normal((b, b)))
        for T in (Tj, Tt):
            T.append_diag(A)
            T.set_subdiag(B, p)
    return Tj, Tt


def test_band_assembly_matches_jax():
    Tj, Tt = _random_band()
    np.testing.assert_array_equal(Tt.view(), Tj.view())
    np.testing.assert_array_equal(Tt.dense(), Tj.dense())
    np.testing.assert_array_equal(tband.band_to_dense(Tt.view()),
                                  jband.band_to_dense(Tj.view()))


def test_eig_host_functions_match_jax():
    _, T = _random_band(b=3, panels=40)
    band = T.view()
    k = 7
    w, V = teig.eig_banded_host(band)
    wj, Vj = jeig.eig_banded_host(band)
    assert rel_err(w, wj) < TOL and rel_err(np.abs(V), np.abs(Vj)) < 1e-10
    assert rel_err(teig.eig_banded_values_topk(band, k),
                   jeig.eig_banded_values_topk(band, k)) < TOL
    for fn in ("eig_banded_topk", "eig_banded_topk_dense"):
        (a, Va), (bb, Vb) = getattr(teig, fn)(band, k), getattr(jeig, fn)(band, k)
        assert rel_err(a, bb) < TOL
        assert rel_err(np.abs(Va), np.abs(Vb)) < 1e-10
    ws, Vs = teig.sort_eig_abs(w, V, k)
    wsj, Vsj = jeig.sort_eig_abs(wj, Vj, k)
    assert rel_err(ws, wsj) < TOL
    Bi = np.triu(np.random.default_rng(14).standard_normal((3, 3)))
    assert rel_err(teig.ritz_residual_bounds(Bi, Vs, 3),
                   jeig.ritz_residual_bounds(Bi, np.asarray(Vsj), 3)) < 1e-10
    for tol in (1e-12, 1e3):
        assert (teig.check_convergence(Bi, Vs, 3, k, tol)
                == jeig.check_convergence(Bi, Vsj, 3, k, tol))
    # the "native" and "device" backends factorize as the JAX package's do
    for backend in ("native", "device"):
        wb, Vb = teig.eig_banded_host(band, backend=backend, device="cpu")
        wbj, Vbj = jeig.eig_banded_host(band, backend=backend)
        assert rel_err(wb, wbj) < TOL and rel_err(wb, wj) < TOL
        assert rel_err(np.abs(Vb), np.abs(np.asarray(Vbj))) < 1e-10


def test_spectral_norm_bound_brackets_the_norm():
    d = np.linspace(-3.0, 2.0, 300)
    op = rtt.DiagonalOperator(torch.from_numpy(d))
    g = torch.Generator().manual_seed(0)
    s = teig.spectral_norm_bound(op, g)
    assert 3.0 <= s <= 3.0 * 1.1 * (1 + 1e-6)


def test_laplacian_operators_match_jax():
    for Jop, Top, dims in ((rbl_tpu.Laplacian2D, rtt.Laplacian2D, (13, 17)),
                           (rbl_tpu.Laplacian3D, rtt.Laplacian3D, (5, 6, 7))):
        n = int(np.prod(dims))
        X = _rand((n, 3), 15)
        kw = dict(zip(("nx", "ny", "nz"), dims))
        want = np.asarray(Jop(**kw, _dtype=jnp.float64).apply(jnp.asarray(X)))
        op = Top(*dims, dtype=torch.float64, device=CPU)
        np.testing.assert_allclose(op.apply(_t(X)).numpy(), want, rtol=0, atol=1e-13)
        assert op.shape == (n, n)
        np.testing.assert_array_equal(op.diagonal().numpy(),
                                      np.asarray(Jop(**kw).diagonal()))


def test_dense_diagonal_affine_match_jax():
    M = _rand((60, 60), 16)
    M = M + M.T
    d = _rand(60, 17)
    X = _rand((60, 4), 18)
    pairs = [
        (rbl_tpu.DenseOperator(jnp.asarray(M)), rtt.DenseOperator(_t(M))),
        (rbl_tpu.DiagonalOperator(jnp.asarray(d)), rtt.DiagonalOperator(_t(d))),
    ]
    from rbl_tpu.ops.spmm.operator import AffineOperator as JAffine

    pairs.append((JAffine.shift(pairs[0][0], -1.0, 2.5),
                  toperator.AffineOperator.shift(pairs[0][1], -1.0, 2.5)))
    for j, t in pairs:
        assert rel_err(t.apply(_t(X)).numpy(), np.asarray(j.apply(jnp.asarray(X)))) < TOL
        assert rel_err(t.diagonal().numpy(), np.asarray(j.diagonal())) < TOL


def test_as_operator_routes():
    d = np.arange(1.0, 51.0)
    assert isinstance(rtt.as_operator(sp.diags(d).tocsr(), device=CPU),
                      rtt.DiagonalOperator)
    A = sp.random(200, 200, density=0.05, random_state=0)
    A = (A + A.T).tocsr()
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="bsr")
    assert isinstance(op, rtt.BlockSparseOperator) and op.dtype == torch.float64
    assert isinstance(rtt.as_operator(np.eye(5), device=CPU), rtt.DenseOperator)
    assert isinstance(rtt.as_operator(d, device=CPU), rtt.DiagonalOperator)
    cast = rtt.as_operator(rtt.Laplacian2D(4, 4, device=CPU), dtype=torch.float32)
    assert cast.dtype == torch.float32 and cast.apply(torch.ones(16, 2)).dtype == torch.float32
    # every forced format builds its operator, which applies A (DIA takes
    # at most 256 diagonals: a band of 41 here)
    X = _rand((200, 3), 22)
    band = sp.triu(sp.tril(A, 20), -20).tocsr()
    for fmt, cls in (("dia", rtt.DiaOperator), ("ell", rtt.SparseEllOperator),
                     ("hyb", rtt.HybOperator), ("coo", rtt.CooOperator),
                     ("bsr", rtt.BlockSparseOperator)):
        M = band if fmt == "dia" else A
        op = rtt.as_operator(M, dtype=torch.float64, device=CPU, format=fmt)
        assert isinstance(op, cls) and op.device.type == "cpu", fmt
        assert rel_err(op.apply(_t(X)).numpy(), M @ X) < TOL, fmt
    # auto on the CPU: > 256 diagonals, no row-length skew → ELL
    assert isinstance(rtt.as_operator(A, device=CPU), rtt.SparseEllOperator)
    with pytest.raises(ValueError, match="format"):
        rtt.as_operator(A, device=CPU, format="csr")


def test_operator_from_arrays_kinds():
    d = _rand(30, 19)
    M = _rand((30, 30), 20)
    X = _rand((30, 2), 21)
    diag = operator_from_arrays("DiagonalOperator", {"diag": d}, {}, CPU)
    dense = operator_from_arrays("DenseOperator", {"mat": M}, {}, CPU)
    lap = operator_from_arrays("Laplacian2D", {}, {"nx": 5, "ny": 6, "_dtype": jnp.float32},
                               CPU)
    assert rel_err(diag.apply(_t(X)).numpy(), d[:, None] * X) < TOL
    assert rel_err(dense.apply(_t(X)).numpy(), M @ X) < TOL
    assert lap.dtype == torch.float32 and lap.shape == (30, 30)
    with pytest.raises(ValueError):
        operator_from_arrays("ShiftInvertOperator", {}, {}, CPU)


def test_config_defaults_and_conversion():
    jcfg = rbl_tpu.RBLConfig()
    tcfg = rtt.RBLConfig()
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name) and f.name not in ("basis_dtype", "compute_dtype"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    conv = config_from_fields(dataclasses.asdict(jcfg.replace(
        basis_dtype=jnp.bfloat16, compute_dtype=jnp.float32, block_size=16,
        chunk_growth_cap_f64=None, fault_retries=2,
    )))
    assert conv.basis_dtype == torch.bfloat16 and conv.compute_dtype == torch.float32
    assert conv.block_size == 16 and conv.resolved_qr_method() == "cholqr2"
    # the checkpoint knobs cross; the JAX default rows_axis is dropped (a
    # RowMesh has one axis) and any other name raises; a JAX mesh cannot
    # cross (the port's mesh is a RowMesh over a torch.distributed group)
    assert config_from_fields(dataclasses.asdict(
        jcfg.replace(sweep_checkpoint_path="x"))).sweep_checkpoint_path == "x"
    assert not hasattr(conv, "rows_axis")
    with pytest.raises(ValueError, match="rows_axis"):
        config_from_fields(dataclasses.asdict(jcfg.replace(rows_axis="cols")))
    from rbl_tpu.parallel.mesh import make_row_mesh

    with pytest.raises(TypeError, match="RowMesh"):
        config_from_fields(dict(mesh=make_row_mesh(2)))
    with pytest.raises(TypeError):
        rtt.RBLConfig(compute_dtype=np.float32)


def test_matmul_precision_maps_high_to_full_fp32_and_restores():
    prev = torch.get_float32_matmul_precision()
    with tconfig.matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "highest"
    with tconfig.matmul_precision("default"):
        assert torch.get_float32_matmul_precision() == "high"  # TF32 allowed
    assert torch.get_float32_matmul_precision() == prev


def test_krylov_capacity_matches_jax():
    for free in (0, 10**9, 80 * 10**9):
        want = jmemory.krylov_capacity(262_144, 16, jnp.bfloat16, jnp.float32,
                                       free_bytes=free)
        got = tmemory.krylov_capacity(262_144, 16, torch.bfloat16, torch.float32,
                                      free_bytes=free)
        assert got == want
    assert tmemory.device_free_memory("cpu") is None
    assert tmemory.clamp_kryl_dim(1400, 1000, 8, torch.float64, torch.float64,
                                  device=CPU) == 1000
