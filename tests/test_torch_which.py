"""tests/test_which.py on the port, on the CPU: the algebraic ends through
the spectral shift (LA on a sign-mixed diagonal, SA on the 24² Laplacian
with its residuals and on a sparse matrix against ARPACK), ``which``
validation, and ``deflate=`` (the next k after known vectors, an
unnormalized, a rank-deficient and a zero span, a wrong shape), at the
JAX package's tolerances.  The cases live in tests/_torch_gates.py, which
chip_smoke.py's phase 26 runs on the card.
"""

import numpy as np
import pytest

from _torch_gates import (
    DEFLATE_CASES,
    DEFLATE_TOL,
    LA_TOL,
    SA_TOL,
    deflate_case,
    deflate_next_after_known,
    deflate_shape_raises,
    which_la,
    which_sa_laplacian,
    which_sa_sparse,
    which_validation_raises,
)
from _torch_parity import CPU


def test_la_on_sign_mixed_diagonal():
    """LM would return the -50 end; LA returns the +10 end."""
    la_rel, lm_rel = which_la(CPU)
    assert np.all(la_rel < LA_TOL), la_rel
    assert lm_rel < LA_TOL


def test_sa_laplacian_smallest_modes():
    """The smallest Dirichlet Laplacian modes, ascending, with honest
    eigenvector residuals."""
    rel, resid_share = which_sa_laplacian(CPU)
    assert np.all(rel < SA_TOL), rel
    assert resid_share < 1.0


def test_sa_matches_eigsh_sparse():
    rel = which_sa_sparse(CPU)
    assert np.all(rel < SA_TOL), rel


def test_which_validation():
    assert which_validation_raises(CPU)


class TestDeflateAPI:
    """rbl(..., deflate=X): the next k pairs orthogonal to a known span."""

    def test_next_k_after_known_eigenvectors(self):
        rel, overlap = deflate_next_after_known(CPU)
        assert np.all(rel < DEFLATE_TOL), rel
        assert overlap < 1e-8

    @pytest.mark.parametrize("case", DEFLATE_CASES)
    def test_deflate_span(self, case):
        rel = deflate_case(case, CPU)
        assert np.all(rel < DEFLATE_TOL), rel

    def test_deflate_shape_validation(self):
        assert deflate_shape_raises(CPU)
