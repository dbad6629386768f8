"""Step-level parity of the port's Lanczos driver (rbl_tpu_torch/solver)
with the JAX package's (rbl_tpu/solver/lanczos.py), at f64 on the CPU.

Both packages get the same (basis, Qi, Qprev, Bi) from numpy and must
produce the same T blocks to 1e-11 relative: cholqr2's R has a positive
diagonal, so the factors are unique and only the order of sums differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rbl_tpu
import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from rbl_tpu.solver import lanczos as jl
from rbl_tpu_torch.solver import lanczos as tl
from rbl_tpu_torch.solver.basis import BasisStore

TOL = 1e-11
N, B = 600, 4


def _state(seed=0, stored=12, cap=40):
    """A symmetric operator, mutually orthonormal (basis, Qprev, Qi, lock)
    blocks and a random upper-triangular coupling block."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, N))
    M = (M + M.T) / np.sqrt(N)
    Q = np.linalg.qr(rng.standard_normal((N, stored + 2 * B + 3)))[0]
    basis = np.zeros((N, cap))
    basis[:, :stored] = Q[:, :stored]
    Qprev, Qi = Q[:, stored : stored + B], Q[:, stored + B : stored + 2 * B]
    lock = Q[:, stored + 2 * B :]
    Bi = np.triu(rng.standard_normal((B, B)))
    return M, basis, Qprev, Qi, Bi, lock


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("with_lock", [False, True])
def test_sweep_chunk_tb_parity(with_lock):
    M, basis, Qprev, Qi, Bi, lock = _state()
    pattern = (True, False, True, False)
    kw = dict(cdt=jnp.float64, qr_method="cholqr2", nsteps=4,
              reorth_pattern=pattern, loc_passes=2, reorth_passes=1)
    jout = jl._sweep_chunk(
        rbl_tpu.DenseOperator(jnp.asarray(M)), jnp.asarray(basis),
        jnp.asarray(Qi), jnp.asarray(Qprev), jnp.asarray(Bi), jnp.int32(12),
        jnp.asarray(lock) if with_lock else None, **kw,
    )
    kw["cdt"] = torch.float64
    tbuf = _t(basis)
    tout = tl._sweep_chunk(
        rtt.DenseOperator(_t(M)), tbuf, _t(Qi), _t(Qprev), _t(Bi), 12,
        _t(lock) if with_lock else None, **kw,
    )
    assert tout[0] is tbuf  # the basis is updated in place
    assert tout[4].shape == (8, B, B)
    for j, t in zip(jout, tout):
        assert rel_err(t.numpy(), np.asarray(j)) < TOL
    np.testing.assert_array_equal(tbuf.numpy()[:, 12 + 4 * B :], 0.0)


def test_first_and_recurrence_steps_match_jax():
    M, basis, Qprev, Qi, Bi, _ = _state(seed=1)
    jop, top = rbl_tpu.DenseOperator(jnp.asarray(M)), rtt.DenseOperator(_t(M))
    a = jl.first_step_fn(jop, jnp.asarray(Qi), jnp.float64, "cholqr2")
    b = tl.first_step_fn(top, _t(Qi), torch.float64, "cholqr2")
    for x, y in zip(a, b):
        assert rel_err(y.numpy(), np.asarray(x)) < TOL
    a = jl.recurrence_step_fn(jop, jnp.asarray(Qi), jnp.asarray(Qprev),
                              jnp.asarray(Bi), jnp.float64, "cholqr2")
    b = tl.recurrence_step_fn(top, _t(Qi), _t(Qprev), _t(Bi), torch.float64,
                              "cholqr2")
    for x, y in zip(a, b):
        assert rel_err(y.numpy(), np.asarray(x)) < TOL


def test_rayleigh_refine_matches_jax():
    M, _, _, _, _, _ = _state(seed=2)
    w, V = np.linalg.eigh(M)
    rng = np.random.default_rng(3)
    X = V[:, -5:] + 1e-6 * rng.standard_normal((N, 5))
    theta0 = w[-5:] + 1e-5
    tj, rj = jl._rayleigh_refine(rbl_tpu.DenseOperator(jnp.asarray(M)),
                                 jnp.asarray(X), jnp.asarray(theta0),
                                 cdt=jnp.float64)
    tt, rt_ = tl._rayleigh_refine(rtt.DenseOperator(_t(M)), _t(X), _t(theta0),
                                  cdt=torch.float64)
    assert rel_err(tt.numpy(), np.asarray(tj)) < TOL
    assert rel_err(rt_.numpy(), np.asarray(rj)) < 1e-9  # residuals ~1e-6


def test_split_coupling_matches_jax():
    rng = np.random.default_rng(4)
    Bs = np.triu(rng.standard_normal((5, 5)))
    Bs[3:] *= 1e-18
    for a, b in zip(tl._split_coupling(Bs, 3), jl._split_coupling(Bs, 3)):
        np.testing.assert_array_equal(a, b)


def test_poll_schedule_matches_jax():
    for j in (1, 7, 40, 200):
        for fine in (False, True):
            assert (tl.poll_stride_cols(j, 8, 4, fine)
                    == jl.poll_stride_cols(j, 8, 4, fine))
        assert tl.poll_panel_for(j * 8, j + 3, 8, 20) == jl.poll_panel_for(j * 8, j + 3, 8, 20)
        assert (tl.fine_poll_reset_cols(j * 16, j, 8, 4)
                == jl.fine_poll_reset_cols(j * 16, j, 8, 4))


def test_basis_store_rewind_keeps_zero_padding():
    st = BasisStore(50, 2, max_cols=10, dtype=torch.float64, device=CPU)
    for c in range(4):
        st.append(torch.full((50, 2), float(c + 1), dtype=torch.float64))
    blk = st.read_block(4, 2)
    st.rewind(2)
    assert st.ncols == 2 and st.view().shape == (50, 2)
    assert torch.all(st.buf[:, 2:] == 0)
    assert torch.all(blk == 3.0)  # a read block is a copy, not a view
    with pytest.raises(IndexError):
        st.read_block(2, 2)
    # a device cap builds the two-tier store: rounded up to 4 blocks, the
    # buffer no wider than the cap (tests/test_torch_basis_tier.py)
    capped = BasisStore(50, 2, 10, torch.float64, CPU, device_cap_cols=4)
    assert capped.device_cap_cols == 8 and capped.capacity == 8
    assert capped.host_tier() == []


def test_fresh_directions_and_start_block():
    M, basis, Qprev, _, _, lock = _state(seed=5)
    st = BasisStore(N, B, max_cols=40, dtype=torch.float64, device=CPU)
    for c in range(0, 12, B):
        st.append(_t(basis[:, c : c + B]))
    g = torch.Generator().manual_seed(0)
    Z = tl._fresh_directions(st, (_t(Qprev),), _t(lock), g, (N, B),
                             torch.float64, "cholqr2").numpy()
    assert np.abs(Z.T @ Z - np.eye(B)).max() < 1e-13
    for other in (basis[:, :12], Qprev, lock):
        assert np.abs(other.T @ Z).max() < 1e-13
    cfg = rtt.RBLConfig(block_size=B)
    v0 = np.random.default_rng(6).standard_normal(N)
    Q1 = tl.random_start_block(rtt.DenseOperator(_t(M)), g, B, cfg,
                               v0=_t(v0), raw=True).numpy()
    assert np.abs(Q1.T @ Q1 - np.eye(B)).max() < 1e-13
    # raw start: Q₁'s first column is v0's direction
    assert abs(abs(Q1[:, 0] @ v0) / np.linalg.norm(v0) - 1.0) < 1e-13


def test_recover_eigvec_bf16_basis_rounds_coefficients_like_jax():
    """V = Q·Ṽ with a bf16 basis: the coefficients are rounded to bf16 and
    the product accumulates in f32, as the JAX package's _recover does."""
    rng = np.random.default_rng(7)
    basis = rng.standard_normal((300, 16)).astype(np.float32)
    Vk = rng.standard_normal((16, 3))
    st = BasisStore(300, 4, max_cols=20, dtype=torch.bfloat16, device=CPU)
    for c in range(0, 16, 4):
        st.append(torch.from_numpy(basis[:, c : c + 4]))
    got = tl.recover_eigvec(st, Vk)
    assert got.dtype == torch.float32
    jbuf = jnp.asarray(st.buf.float().numpy()).astype(jnp.bfloat16)
    Vp = np.zeros((20, 3))
    Vp[:16] = Vk
    want = np.asarray(jl._recover(jbuf, jnp.asarray(Vp)))
    assert rel_err(got.numpy(), want) < 1e-6
