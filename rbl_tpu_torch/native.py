"""ctypes bindings to the port's host C++ (``csrc/host/*.cpp``).

The reference's only native touchpoints are a raw LAPACK ccall for the
banded eigensolver (Julia/common.jl:28-48) and its matrix loaders; the JAX
package answers them with ``native/band_eig.cpp`` and ``native/mmio.cpp``.
The port keeps its own copy of both sources under ``csrc/host/`` and its
own build of them: ``band_eigh`` (tred2/tql2 banded symmetric eigensolver,
``RBLConfig(eig_backend="native")``) and ``read_matrix_market`` (buffered
MatrixMarket parser; ``utils.suitesparse.load_matrix`` reads with scipy's
faster one).

The library is compiled with ``g++`` (or ``$CXX``) at first use into
``rbl_tpu_torch/build/<hash of the sources>/``, under a temporary name
that is then renamed into place, so processes that build at once each
load a whole library.  Nothing is built when the module is imported.
Unlike the JAX package, which falls back to scipy, a failed build raises
with the compiler's output, every time it is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
_HOST_SRC = _PKG / "csrc" / "host"
_BUILD = _PKG / "build"
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

# rbl_mm_open's codes for a MatrixMarket flavour the reader does not parse:
# the dense "array" format (-4) and complex values (-5)
_MM_UNSUPPORTED = {-4: "dense array format", -5: "complex values"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``csrc/host/*.cpp`` into one shared library unless this
    exact set of sources is built already; returns its path.  Raises
    RuntimeError with the compiler's output if the build fails."""
    sources = sorted(_HOST_SRC.glob("*.cpp"))
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for f in sources:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = _BUILD / h.hexdigest()[:16] / "librbl_host.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            [cxx, *_CXX_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(
            f"cannot run the C++ compiler {cxx!r} ({e}): the host library of "
            "rbl_tpu_torch is built from csrc/host/*.cpp at first use"
        ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed to build {out} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The host library, built at first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            dp = ctypes.POINTER(ctypes.c_double)
            lib.rbl_band_eigh.restype = ctypes.c_int
            lib.rbl_band_eigh.argtypes = [i64, i64, dp, dp, dp]
            lib.rbl_mm_open.restype = ctypes.c_int
            lib.rbl_mm_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
                i64p, i64p, i64p, ctypes.POINTER(ctypes.c_int),
            ]
            lib.rbl_mm_read.restype = ctypes.c_int
            lib.rbl_mm_read.argtypes = [ctypes.c_void_p, i64p, i64p, dp]
            lib.rbl_mm_close.restype = None
            lib.rbl_mm_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library builds and loads (a failed build is not
    remembered: the next call tries again)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def band_eigh(band: np.ndarray):
    """All eigenpairs of a symmetric banded matrix (LAPACK lower-band
    storage, the layout of scipy.linalg.eig_banded(lower=True)).

    Returns (w ascending, V) with V[:, j] the j-th eigenvector, by the
    C++ tred2/tql2 solver; raises RuntimeError if the library cannot be
    built or the QL iteration does not converge."""
    lib = _load()
    band = np.ascontiguousarray(band, dtype=np.float64)
    bw1, m = band.shape
    w = np.empty(m, dtype=np.float64)
    V = np.empty((m, m), dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    info = lib.rbl_band_eigh(
        m, bw1,
        band.ctypes.data_as(dp), w.ctypes.data_as(dp), V.ctypes.data_as(dp),
    )
    if info != 0:
        raise RuntimeError(f"rbl_band_eigh failed: info={info}")
    return w, V


def read_matrix_market(path: str):
    """Parse a MatrixMarket coordinate file (real, integer or pattern;
    general, symmetric, skew-symmetric or hermitian) with the native
    reader.  Returns a scipy.sparse COO matrix, symmetric and skew storage
    expanded.

    Raises ValueError for a flavour the reader does not parse (dense
    array, complex; ``scipy.io.mmread`` reads those) or a malformed file,
    OSError when the file cannot be read, and RuntimeError when the
    library cannot be built."""
    import scipy.sparse as sp

    lib = _load()
    handle = ctypes.c_void_p()
    nrows, ncols, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    symcode = ctypes.c_int()
    rc = lib.rbl_mm_open(
        os.fsencode(path), ctypes.byref(handle), ctypes.byref(nrows),
        ctypes.byref(ncols), ctypes.byref(nnz), ctypes.byref(symcode),
    )
    if rc in _MM_UNSUPPORTED:
        raise ValueError(f"{path}: {_MM_UNSUPPORTED[rc]}, which this reader "
                         "does not parse")
    if rc in (-1, -2):
        raise OSError(f"cannot read {path} (rbl_mm_open rc={rc})")
    if rc != 0:
        raise ValueError(f"{path}: malformed MatrixMarket header (rc={rc})")
    try:
        rows = np.empty(nnz.value, dtype=np.int64)
        cols = np.empty(nnz.value, dtype=np.int64)
        vals = np.empty(nnz.value, dtype=np.float64)
        lp = ctypes.POINTER(ctypes.c_int64)
        dp = ctypes.POINTER(ctypes.c_double)
        rc = lib.rbl_mm_read(
            handle, rows.ctypes.data_as(lp), cols.ctypes.data_as(lp),
            vals.ctypes.data_as(dp),
        )
    finally:
        lib.rbl_mm_close(handle)
    if rc != 0:
        raise ValueError(f"{path}: malformed MatrixMarket entries (rc={rc})")
    if symcode.value:  # expand symmetric / skew-symmetric storage
        off = rows != cols
        sign = -1.0 if symcode.value == 2 else 1.0
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sign * vals[off]]),
        )
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(nrows.value, ncols.value)
    )
