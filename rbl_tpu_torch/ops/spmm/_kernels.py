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
    "rbl_bsr_spmm_plan": ("bsr_spmm", [_i] * 4 + [_p]),
    "rbl_bsr_spmm_packed_plan_f32": ("bsr_spmm", [_p] * 6 + [_i] * 7 + [_p]),
    **{f"rbl_bsr_spmm_panel_{s}": ("bsr_spmm_panel", [_p] * 6 + [_i] * 5 + [_p])
       for s in ("f32", "f64")},
    "rbl_dma_stream_f32": ("dma_stream", [_p] * 4 + [_i] * 2 + [_p]),
    "rbl_dma_stream_dot_f32": ("dma_stream", [_p] * 5 + [_i] * 4 + [_p]),
    "rbl_dma_stream_manual_f32": ("dma_stream", [_p] * 4 + [_i] * 2 + [_p]),
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


def spmm_plan(bm: int, b: int, dtype, bk: int = 128) -> dict:
    """The register block and ring that ``csrc/bsr_spmm.cu`` launches for
    (bm, bk) tiles, ``b`` columns and ``dtype``: rows R and columns C a
    thread, ring stages, dynamic shared bytes and threads a CTA."""
    out = (ctypes.c_int * 5)()
    err = _libraries()["bsr_spmm"].rbl_bsr_spmm_plan(
        bm, bk, b, torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise ValueError(f"no bsr_spmm plan for bm={bm}, bk={bk}, b={b}, {dtype}")
    return dict(zip(("R", "C", "stages", "smem_bytes", "threads"), out))


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


def _stream_buffers(vals, width: int, S: int):
    """The (8, 128) output and the scratch of the tile-stream probes:
    S partial rows of ``width`` floats and the second pass's ⌈S/64⌉."""
    out = torch.empty((8, 128), dtype=torch.float32, device=vals.device)
    work = torch.empty(((S + -(-S // 64)) * width,), dtype=torch.float32,
                       device=vals.device)
    return out, work


def launch_stream(vals, seed, *, S: int, CH: int) -> torch.Tensor:
    """Launch B5 of ``csrc/dma_stream.cu``; returns the (8, 128) output.
    The caller has checked the operands."""
    out, work = _stream_buffers(vals, 128, S)
    _call("rbl_dma_stream_f32", vals.device, vals.data_ptr(), seed.data_ptr(),
          out.data_ptr(), work.data_ptr(), S, CH)
    return out


def launch_stream_dot(vals, seed, xt, *, S: int, CH: int, bm: int,
                      U: int) -> torch.Tensor:
    """Launch B6 of ``csrc/dma_stream.cu``; returns the (8, 128) output."""
    out, work = _stream_buffers(vals, 1, S)
    _call("rbl_dma_stream_dot_f32", vals.device, vals.data_ptr(),
          seed.data_ptr(), xt.data_ptr(), out.data_ptr(), work.data_ptr(),
          S, CH, bm, U)
    return out


def launch_manual(vals, seed, *, S: int, CH: int) -> torch.Tensor:
    """Launch B7 of ``csrc/dma_stream.cu``; returns the (8, 128) output."""
    out, work = _stream_buffers(vals, 128, S)
    _call("rbl_dma_stream_manual_f32", vals.device, vals.data_ptr(),
          seed.data_ptr(), out.data_ptr(), work.data_ptr(), S, CH)
    return out
