"""PETSc's ex56 (the benchmark's configuration ``petsc_ex56_ne42``) at
``-ne 4`` on the CPU: the generator's matrix (``perfbench/generators/
petsc_ex56.py``, the configuration's plain reference) against its own
mathematics and the port's element, the port's packed block-sparse
operator and solvers against that matrix, and the Timer's counter
``spmm_cols``.  The JAX package has no ex56, so nothing here is held
against it."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import rbl_tpu_torch as rtt
from _torch_parity import CPU, rel_err
from perfbench.generators import petsc_ex56
from rbl_tpu_torch.ops.spmm.bsr import BlockSparseOperator
from rbl_tpu_torch.ops.spmm.operator import LinearOperator
from rbl_tpu_torch.solver.polish import rbl_polished
from rbl_tpu_torch.utils.fem import fem_elasticity_3d, hex8_stiffness
from rbl_tpu_torch.utils.profiling import Timer, null_timer, timed_spmm

NE = 4
CONFIG = Path(__file__).resolve().parents[1] / "perfbench/configs/petsc_ex56_ne42.json"


@pytest.fixture(scope="module")
def A():
    return petsc_ex56.assemble(NE)


@pytest.fixture(scope="module")
def exact(A):
    """Every eigenvalue, descending, from a dense float64 eigh."""
    return np.linalg.eigvalsh(A.toarray())[::-1]


def test_the_matrix_is_symmetric_positive_definite(A, exact):
    assert A.shape == (3 * (NE + 1) ** 2 * NE,) * 2
    assert abs(A - A.T).max() <= 1e-16 * abs(A).max()
    assert exact[-1] > 1e-3 * exact[0] > 0


def test_the_configuration_states_the_size_the_generator_gives():
    cfg = json.loads(CONFIG.read_text())
    ne = cfg["ne"]
    assert cfg["n"] == 3 * (ne + 1) ** 2 * ne == petsc_ex56.free_dofs(ne).size == 232_974
    assert cfg["reduced"] == [] and cfg["generator"] == "petsc_ex56"


def test_the_stored_pattern_is_every_node_block():
    """Every 3×3 block of two neighbouring free nodes is stored (the
    couplings that vanish at ν = 0.25 as exact zeros): 9·(3m−2)²·(3ne−2)
    entries, m = ne + 1, 99 populated diagonals."""
    A = petsc_ex56.assemble(NE)
    m = NE + 1
    assert A.nnz == 9 * (3 * m - 2) ** 2 * (3 * NE - 2)
    coo = A.tocoo()
    assert np.unique(coo.col.astype(np.int64) - coo.row).size == 99
    assert 0 < np.count_nonzero(A.data) < A.nnz


def test_the_element_annihilates_the_six_rigid_body_modes():
    h = 1.0 / 42
    K = petsc_ex56.element(h, 1.0, 0.25)
    x = petsc_ex56.CORNERS * h / 2          # the corners about the centre
    modes = [np.tile(np.eye(3)[d], 8) for d in range(3)]      # translations
    modes += [np.cross(w, x).ravel() for w in np.eye(3)]       # rotations
    R = np.stack(modes, axis=1)
    assert np.abs(K @ R).max() <= 1e-14 * np.abs(K).max()
    assert np.linalg.matrix_rank(K) == 24 - 6
    np.testing.assert_array_equal(K, K.T)


def test_the_element_is_the_ports_hex8_and_the_spectrum_a_rotated_clamp(exact):
    """The same trilinear element as the port's ``hex8_stiffness``, and the
    same spectrum as ``fem_elasticity_3d`` with h = 1/ne, which clamps the
    face z = 0 instead of y = 0 (a rotation of the cube)."""
    np.testing.assert_allclose(petsc_ex56.element(0.25, 1.0, 0.25),
                               hex8_stiffness(0.25, 1.0, 0.25), rtol=0, atol=1e-15)
    other = np.linalg.eigvalsh(fem_elasticity_3d(NE, h=1.0 / NE, nu=0.25).toarray())
    np.testing.assert_allclose(exact[::-1], other, rtol=0, atol=1e-13 * exact[0])


@pytest.mark.parametrize("mirror", ["x", "z", "xz"])
def test_the_mirrors_are_signed_permutations_that_commute(A, mirror):
    S = petsc_ex56.mirrors(NE)[mirror]
    assert np.array_equal(np.sort(np.abs(S).sum(axis=0).A.ravel()), np.ones(A.shape[0]))
    assert abs(S @ S.T - np.eye(A.shape[0])).max() == 0
    assert abs(S @ A @ S.T - A).max() <= 1e-15 * abs(A).max()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("b", [8, 48])
def test_the_packed_operator_equals_the_csr_product(A, dtype, tol, b):
    """Relative to the largest entry of A·X: f64 sums the same terms in
    another order (1e-12), f32 rounds each of ~81 terms a row (1e-5)."""
    op = rtt.as_operator(A, dtype=dtype, device=CPU, format="bsr")
    assert isinstance(op, BlockSparseOperator)
    X = np.random.default_rng(b).standard_normal((A.shape[0], b))
    Y = op.apply(torch.as_tensor(X, dtype=dtype)).double().numpy()
    assert rel_err(Y, A @ X) <= tol


def _cfg(**kw):
    return rtt.RBLConfig(device=CPU, seed=11, **kw)


def test_rbl_agrees_with_eigh(A, exact):
    """k 10, b 4, f64 to tol 1e-8 on the packed operator: the eigenvalues
    to 1e-9 relative (a residual of 1e-8·‖A‖ moves a simple eigenvalue by
    its square over the gap and a pair, which the block holds whole, by
    no more), the vectors' residuals to the tolerance."""
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="bsr")
    res = rtt.rbl(op, 10, cfg=_cfg(block_size=4, compute_dtype=torch.float64,
                                   basis_dtype=torch.float64, tol=1e-8))
    assert res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues)[::-1], exact[:10], rtol=1e-9)
    V = res.eigenvectors.numpy()
    R = A @ V - V * res.eigenvalues[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1e-7 * exact[0]


def test_rbl_polished_agrees_with_eigh(A, exact):
    """k 5 to tol 1e-7 through the f32 coarse sweep and the f64 filter
    chains: the eigenvalues to 1e-12 relative (a residual of 1e-7 moves an
    eigenvalue by its square over the gap, ~1e-14 here), the vectors'
    absolute residuals to the tolerance."""
    op = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="bsr")
    res = rbl_polished(op, 5, cfg=_cfg(tol=1e-7, qr_method="cholqr2",
                                       eig_poll_cadence=16),
                       b=8, bounds=(0.0, None))
    assert res.converged
    np.testing.assert_allclose(np.sort(res.eigenvalues)[::-1], exact[:5], rtol=1e-12)
    V = res.eigenvectors.numpy()
    assert np.linalg.norm(A @ V - V * res.eigenvalues[None, :], axis=0).max() <= 1e-7


@dataclasses.dataclass
class Recording(LinearOperator):
    """An operator that records the width of every block it is applied to
    (kept through ``cast_operator``: the list is shared)."""

    base: LinearOperator
    widths: list

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def apply(self, X):
        self.widths.append(X.shape[1])
        return self.base.apply(X)


@pytest.mark.parametrize("entry", ["rbl", "rbl_polished"])
def test_spmm_cols_is_the_sum_of_the_widths_applied(A, exact, entry):
    """Every apply of these solves is timed (the polish is handed both
    bounds, so no untimed power iteration sizes its filter), and each adds
    its block's columns to ``spmm_cols``: the counter equals the sum of the
    widths the operator saw, and the number of "spmm" sections their count."""
    base = rtt.as_operator(A, dtype=torch.float64, device=CPU, format="bsr")
    op = Recording(base, [])
    timer = Timer()
    if entry == "rbl":
        rtt.rbl(op, 10, cfg=_cfg(block_size=4, compute_dtype=torch.float64,
                                 basis_dtype=torch.float64, tol=1e-8), timer=timer)
    else:
        rbl_polished(op, 5, cfg=_cfg(tol=1e-7, qr_method="cholqr2"), b=8,
                     bounds=(0.0, 1.01 * exact[0]), timer=timer)
    assert timer.counters["spmm_cols"] == sum(op.widths) > 0
    assert timer.counts["spmm"] == len(op.widths)


def test_spmm_cols_is_absent_with_no_timer():
    """No timer: the operator's own ``apply`` is called, nothing counts;
    a Timer counts nothing until a timed apply runs."""
    op = rtt.Laplacian2D(8, 8, device=CPU)
    assert timed_spmm(op.apply, None) == op.apply
    assert timed_spmm(op.apply, null_timer()) == op.apply
    timer = Timer()
    assert "spmm_cols" not in timer.counters
    timed_spmm(op.apply, timer)(torch.ones(64, 3, dtype=op.dtype))
    assert timer.counters["spmm_cols"] == 3 and timer.counts["spmm"] == 1
