"""Build, load and launch the hand-written CUDA kernels of the port.

The sources under ``rbl_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
placed in ``rbl_tpu_torch/build/`` under a name keyed by a hash of the
source, and loaded with ``ctypes``.  Nothing is built when the module is
imported: the CPU tests import it on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
_SRC = _PKG / "csrc" / "bsr_spmm.cu"
_BUILD = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "rbl_tpu_torch are built from source at first use"
        )
    return nvcc


def build() -> Path:
    """Compile ``csrc/bsr_spmm.cu`` unless the library for this exact
    source is already built; returns the library's path.  A failed build
    raises with nvcc's output."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"libbsr_spmm_{digest}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {_SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("rbl_bsr_spmm_packed_f32", "rbl_bsr_spmm_packed_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return lib


_ENTRY = {torch.float32: "rbl_bsr_spmm_packed_f32",
          torch.float64: "rbl_bsr_spmm_packed_f64"}


def launch_bsr_spmm_packed(tile_cols, hcount, rptr, vals, X, *, bm: int,
                           bk: int, unroll: int) -> torch.Tensor:
    """Launch ``csrc/bsr_spmm.cu`` on the current CUDA stream; returns the
    (nb·bm, b) output, allocated here.  The caller has checked devices,
    dtypes, shapes and contiguity."""
    nb = rptr.shape[0]
    b = X.shape[1]
    Y = torch.empty((nb * bm, b), dtype=vals.dtype, device=vals.device)
    fn = getattr(_library(), _ENTRY[vals.dtype])
    with torch.cuda.device(vals.device):
        err = fn(tile_cols.data_ptr(), hcount.data_ptr(), rptr.data_ptr(),
                 vals.data_ptr(), X.data_ptr(), Y.data_ptr(),
                 nb, bm, bk, b, unroll,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"bsr_spmm_packed kernel launch failed: cudaError_t {err} "
            f"(nb={nb}, bm={bm}, bk={bk}, b={b}, unroll={unroll})"
        )
    return Y
