"""Build, load and launch the hand-written CUDA kernels of the port.

Every source ``rbl_tpu_torch/csrc/*.cu`` is compiled at first use with
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface — one ``nvcc`` per source, all started together — placed in
``rbl_tpu_torch/build/<hash of all sources>/`` and loaded with ``ctypes``.
Nothing is built when the module is imported: the CPU tests import it on
machines without ``nvcc``.
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
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry → (library, argtypes); every entry returns its cudaError_t
_ENTRIES = {
    **{f"rbl_bsr_spmm_packed_{s}": ("bsr_spmm", [_p] * 6 + [_i] * 5 + [_p])
       for s in ("f32", "f64")},
    **{f"rbl_bsr_spmm_ell_{s}": ("bsr_spmm", [_p] * 4 + [_i] * 5 + [_p])
       for s in ("f32", "f64")},
    **{f"rbl_bsr_spmm_panel_{s}": ("bsr_spmm_panel", [_p] * 6 + [_i] * 5 + [_p])
       for s in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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


def build() -> dict[str, Path]:
    """Compile each ``csrc/*.cu`` whose library for this exact set of
    sources is not built yet, all at once; returns {source stem: library
    path}.  A failed build raises with nvcc's output."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cu*")):  # kernels and their headers
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = _BUILD / h.hexdigest()[:16]
    libs = {src.stem: out / f"lib{src.stem}.so" for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[src.stem])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def _libraries() -> dict[str, ctypes.CDLL]:
    libs = {name: ctypes.CDLL(str(path)) for name, path in build().items()}
    for entry, (name, argtypes) in _ENTRIES.items():
        fn = getattr(libs[name], entry)
        fn.argtypes = argtypes
        fn.restype = _i
    return libs


def _call(entry: str, dev: torch.device, *args) -> None:
    """Launch C ``entry`` on ``dev``'s current stream; raises on a launch
    error."""
    fn = getattr(_libraries()[_ENTRIES[entry][0]], entry)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError_t {err} "
                           f"(arguments {args[-5:]})")


def launch_bsr_spmm_packed(tile_cols, hcount, rptr, vals, X, *, bm: int,
                           bk: int, unroll: int) -> torch.Tensor:
    """Launch the packed kernel of ``csrc/bsr_spmm.cu``; returns the
    (nb·bm, b) output, allocated here.  The caller has checked devices,
    dtypes, shapes and contiguity."""
    nb = rptr.shape[0]
    b = X.shape[1]
    Y = torch.empty((nb * bm, b), dtype=vals.dtype, device=vals.device)
    _call(f"rbl_bsr_spmm_packed_{_SUFFIX[vals.dtype]}", vals.device,
          tile_cols.data_ptr(), hcount.data_ptr(), rptr.data_ptr(),
          vals.data_ptr(), X.data_ptr(), Y.data_ptr(), nb, bm, bk, b, unroll)
    return Y


def launch_bsr_spmm_ell(block_cols, block_vals, X, *, bm: int, bk: int,
                        L: int) -> torch.Tensor:
    """Launch the blocked-ELL kernel of ``csrc/bsr_spmm.cu``; returns the
    (nb·bm, b) output.  The caller has checked the operands."""
    nb = block_cols.shape[0] // L
    b = X.shape[1]
    Y = torch.empty((nb * bm, b), dtype=block_vals.dtype,
                    device=block_vals.device)
    _call(f"rbl_bsr_spmm_ell_{_SUFFIX[block_vals.dtype]}", block_vals.device,
          block_cols.data_ptr(), block_vals.data_ptr(), X.data_ptr(),
          Y.data_ptr(), nb, L, bm, bk, b)
    return Y


def launch_bsr_spmm_panel(tile_cols, hcount, rptr, vals_t, X, *, bm: int,
                          bk: int, unroll: int) -> torch.Tensor:
    """Launch ``csrc/bsr_spmm_panel.cu``; returns the (nb·bm, b) output.
    The caller has checked the operands."""
    nb = rptr.shape[0]
    b = X.shape[1]
    Y = torch.empty((nb * bm, b), dtype=vals_t.dtype, device=vals_t.device)
    _call(f"rbl_bsr_spmm_panel_{_SUFFIX[vals_t.dtype]}", vals_t.device,
          tile_cols.data_ptr(), hcount.data_ptr(), rptr.data_ptr(),
          vals_t.data_ptr(), X.data_ptr(), Y.data_ptr(), nb, bm, bk, b,
          unroll)
    return Y
