"""The port's host C++ (``rbl_tpu_torch.native``, ``csrc/host/*.cpp``) on
the CPU: the banded eigensolver against ``scipy.linalg.eig_banded``
(eigenvalues 1e-12 relative to ‖T‖, vectors up to sign), the MatrixMarket
reader against ``scipy.io.mmread`` on files written here by
``scipy.io.mmwrite`` (every flavour the reader parses, equal entries),
its errors, two processes building at once, and a build without a
compiler.  Nothing here depends on the JAX package's ``native/`` library.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.linalg
import scipy.sparse as sp

import _torch_parity  # noqa: F401  (caps torch's threads)
from rbl_tpu_torch import native

ROOT = Path(__file__).resolve().parents[1]


def _band(m, bw, seed):
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((bw + 1, m))
    for r in range(1, bw + 1):
        band[r, m - r:] = 0.0  # band[r, c] = T[c + r, c] lies outside T
    return band


@pytest.mark.parametrize("m, bw", [(1, 0), (7, 1), (40, 4), (96, 8), (130, 16)])
def test_band_eigh_matches_scipy(m, bw):
    band = _band(m, bw, seed=m)
    w, V = native.band_eigh(band)
    w_ref, V_ref = scipy.linalg.eig_banded(band, lower=True)
    scale = max(np.abs(w_ref).max(), 1.0)
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-12 * scale)
    # vectors up to sign (the spectrum of a random band has no repeats)
    signs = np.sign(np.sum(V * V_ref, axis=0))
    np.testing.assert_allclose(V * signs, V_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V.T @ V, np.eye(m), atol=1e-12)


def _write(tmp_path, name, M, **kw):
    path = str(tmp_path / name)
    scipy.io.mmwrite(path, M, **kw)
    return path


def _matrix(symmetry: str, field: str):
    A = sp.random(9, 7, density=0.4, random_state=np.random.default_rng(1))
    S = sp.random(8, 8, density=0.4, random_state=np.random.default_rng(2))
    M = {"general": A, "skew-symmetric": S - S.T}.get(symmetry, S + S.T)
    if field == "integer":
        M = sp.csr_matrix(np.round(M.toarray() * 10).astype(np.int64))
    return M


@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
@pytest.mark.parametrize("symmetry",
                         ["general", "symmetric", "skew-symmetric", "hermitian"])
def test_read_matrix_market_matches_mmread(tmp_path, field, symmetry):
    path = _write(tmp_path, "m.mtx", _matrix(symmetry, field), field=field,
                  symmetry=symmetry)
    got = native.read_matrix_market(path)
    ref = scipy.io.mmread(path)
    assert got.shape == ref.shape
    assert abs(got.tocsr() - sp.csr_matrix(ref, dtype=np.float64)).max() == 0


def test_read_matrix_market_comments_and_signs(tmp_path):
    path = tmp_path / "hand.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "% a comment\n%\n3 4 3\n1 1 +1.5\n3 4 -2e-3\n2 2 7\n")
    got = native.read_matrix_market(str(path)).toarray()
    ref = np.zeros((3, 4))  # scipy's reader refuses the leading "+"
    ref[0, 0], ref[2, 3], ref[1, 1] = 1.5, -2e-3, 7.0
    np.testing.assert_array_equal(got, ref)


def test_read_matrix_market_errors(tmp_path):
    dense = _write(tmp_path, "dense.mtx", np.eye(3))  # "array" format
    with pytest.raises(ValueError, match="dense array format"):
        native.read_matrix_market(dense)
    cplx = _write(tmp_path, "c.mtx", sp.csr_matrix(np.eye(3) * (1 + 2j)))
    with pytest.raises(ValueError, match="complex values"):
        native.read_matrix_market(cplx)
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "3 3 2\n1 1 1.0\n")  # one entry short
    with pytest.raises(ValueError):
        native.read_matrix_market(str(bad))
    with pytest.raises(OSError):
        native.read_matrix_market(str(tmp_path / "missing.mtx"))


_BUILD_AND_SOLVE = """
import json, sys
from pathlib import Path
import numpy as np
from rbl_tpu_torch import native
native._BUILD = Path(sys.argv[1])
w, _ = native.band_eigh(np.array([[2.0, 3.0], [1.0, 0.0]]))
print(json.dumps([str(native.build()), w.tolist()]))
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Each process compiles under a name of its own and renames it into
    place, so both load a whole library from an empty build directory."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_SOLVE,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    ref = np.linalg.eigvalsh(np.array([[2.0, 1.0], [1.0, 3.0]]))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        lib, w = json.loads(out)
        assert Path(lib).is_file() and Path(lib).parent.parent == tmp_path
        np.testing.assert_allclose(w, ref, rtol=1e-14)
    assert not list(tmp_path.glob("*/*.tmp"))


def test_build_without_a_compiler_raises(tmp_path, monkeypatch):
    """A failed build raises with the reason, every time it is asked for:
    nothing is latched and nothing falls back."""
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no-such-g"):
            native.band_eigh(np.ones((1, 3)))
    assert native.available() is False
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()
    assert not list(tmp_path.glob("*/*.so"))
    monkeypatch.delenv("CXX")
    assert native.available() is True
