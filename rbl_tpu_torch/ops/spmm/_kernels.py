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
    "rbl_bsr_spmm_panel_plan": ("bsr_spmm_panel", [_i] * 4 + [_p]),
    "rbl_dma_stream_f32": ("dma_stream", [_p] * 4 + [_i] * 2 + [_p]),
    "rbl_dma_stream_dot_f32": ("dma_stream", [_p] * 5 + [_i] * 4 + [_p]),
    "rbl_dma_stream_manual_f32": ("dma_stream", [_p] * 4 + [_i] * 2 + [_p]),
    # csrc/skinny.cu: X, Y, partials, out, tickets, plan; V, G, W, out, plan
    # (f64 accumulation only with an f64 operand: gram's own promotion and
    # cholqr's never ask for more)
    **{f"rbl_skinny_gram_{x}_{y}_{a}": ("skinny", [_p] * 7)
       for x in ("bf16", "f32", "f64") for y in ("bf16", "f32", "f64")
       for a in (("f64",) if "f64" in (x, y) else ("f32",))},
    **{f"rbl_skinny_update_{v}_{a}": ("skinny", [_p] * 6)
       for v in ("bf16", "f32", "f64") for a in ("f32", "f64")},
    # csrc/stencil.cu: Y, Z, r, sumsq_in, sumsq_out, partials, tickets, plan
    **{f"rbl_stencil_{s}": ("stencil", [_p] * 9) for s in ("bf16", "f32", "f64")},
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}
_CODE = {None: 0, torch.bfloat16: 1, torch.float32: 2, torch.float64: 3}


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


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(_libraries()[_ENTRIES[name][0]], name)


def _stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current stream (without building a
    torch.cuda.Stream: the step's launches are many and small)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _call(entry: str, dev: torch.device, *args) -> None:
    """Launch C ``entry`` on ``dev``'s current stream; raises on a launch
    error."""
    fn = _entry(entry)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    else:
        err = fn(*args, _stream(dev))
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


def panel_plan(bm: int, b: int, dtype, bk: int = 128) -> dict:
    """The plan that ``csrc/bsr_spmm_panel.cu`` launches for (bm, bk)
    tiles, ``b`` columns and ``dtype``: ring stages, panel rows a stage
    (kc), rows R and columns C a thread, K-split groups, threads a CTA and
    dynamic shared bytes.  Raises for a shape the kernel refuses."""
    out = (ctypes.c_int * 7)()
    err = _libraries()["bsr_spmm_panel"].rbl_bsr_spmm_panel_plan(
        bm, bk, b, torch.empty((), dtype=dtype).element_size(), out)
    if err != 0:
        raise ValueError(f"no bsr_spmm_panel plan for bm={bm}, bk={bk}, b={b}, "
                         f"{dtype}")
    return dict(zip(("stages", "kc", "R", "C", "ksplit", "threads",
                     "smem_bytes"), out))


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


# ------------------------------------------------------------------------
# csrc/skinny.cu: the Gram XᵀY (K1) and the update W − V·round(G) (K2)

_STAGES = 4                # tiles in K1's shared-memory ring (kStages)
_RING = 96 * 1024          # shared bytes K1's ring aims at
_SMEM_MAX = 160 * 1024     # most dynamic shared bytes a CTA (kMaxSmem)
_GRAM_CQ = 8               # columns of Y a thread (kCQ)
_GRAM_MAX_Q = 256          # columns of Y one K1 launch takes
_tickets: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded(cols: int, size: int, pad: int = 16) -> int:
    """A shared tile's row stride in elements: ``cols`` elements of
    ``size`` bytes rounded up to 16 bytes, plus ``pad`` bytes."""
    return (_cdiv(cols * size, 16) * 16 + pad) // size


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copy_mode(t: torch.Tensor, width: int) -> int:
    """How the kernels copy tiles ``width`` columns wide of the 2-D ``t``
    into shared memory: the largest asynchronous unit (16, 8 or 4 bytes)
    along a contiguous row that its alignment allows; −4 or −8, single
    elements with lanes along the rows; 0, plain loads."""
    es = t.element_size()
    rs, cs = t.stride()
    rows, cols = t.shape
    if cs == 1 or cols == 1:
        for u in (16, 8, 4):
            if (u >= es and (width * es) % u == 0 and t.data_ptr() % u == 0
                    and ((rs * es) % u == 0 or rows == 1)):
                return u
        return 0
    return -es if es >= 4 and t.data_ptr() % es == 0 else 0


@functools.lru_cache(maxsize=4096)
def gram_plan(n: int, p: int, q: int, chunk: int, x_size: int, y_size: int,
              acc_size: int, sms: int) -> dict:
    """K1's launch for X (n, p) and Y (n, q) of ``x_size``- and
    ``y_size``-byte elements and an ``acc_size``-byte accumulation: CP
    columns of X a thread, nct × nqt column groups (8 columns of Y each),
    rgn row groups of R rows a step, the column tiles (narrowed to 8 column
    groups, then the chunks split into pieces, towards two CTAs a SM, in
    one wave), the tiles' row strides and the dynamic shared bytes.  The
    plan, and so the order of the sums, follows from the shapes and dtypes
    alone, never from the operands' layouts."""
    cp = 2 if x_size == 8 else 4
    rows = 8 if x_size == 2 else 4
    nqt = _cdiv(q, _GRAM_CQ)
    ncp = _cdiv(p, cp)
    nchunks = _cdiv(n, chunk)
    nct = min(ncp, max(1, 64 // nqt))
    while nct > 8 and nchunks * _cdiv(ncp, nct) < 2 * sms:
        nct //= 2
    tiles = _cdiv(ncp, nct)
    cols = nct * nqt
    ldx = _padded(nct * cp, x_size)
    ldy = _padded(nqt * _GRAM_CQ, y_size)
    row = ldx * x_size + ldy * y_size
    rgn = max(1, min(256 // cols, 32, _RING // (_STAGES * rows * row)))
    span = min(chunk, n)
    split = 1
    while nchunks * tiles * split * 2 <= 2 * sms and span >= 4 * split * rows * rgn:
        split *= 2
    # the last pass adds every chunk's partial of a batch of elements in
    # shared memory: up to 256 elements a batch, fewer where the chunks are
    # many (the kernel takes batches of whatever its bytes hold)
    batch = max(1, min(min(nct * cp, p) * q, 256, _SMEM_MAX // (nchunks * acc_size)))
    smem = max(_STAGES * rows * rgn * row,
               (rgn // 2) * cols * cp * _GRAM_CQ * acc_size,
               nchunks * acc_size * batch)
    if smem > _SMEM_MAX:
        raise ValueError(f"gram: no plan for p={p}, q={q} in {nchunks} "
                         f"chunks of {chunk} rows")
    return dict(cp=cp, rows=rows, nqt=nqt, nct=nct, rgn=rgn, nchunks=nchunks,
                split=split, sublen=_cdiv(span, split), tiles=tiles, ldx=ldx,
                ldy=ldy, smem=smem)


def _ticket_buffer(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed counters of K1's column tiles for launches on ``stream``
    (each launch leaves them zeroed again)."""
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


def _check_skinny(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"the {name} kernel takes CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype not in _SUFFIX:
            raise ValueError(f"the {name} kernel takes bf16, f32 and f64, "
                             f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"the {name} kernel takes 2-D operands")


def launch_gram(X: torch.Tensor, Y: torch.Tensor, *, chunk: int,
                acc: torch.dtype) -> tuple:
    """K1: XᵀY (p, q) in ``acc`` for X (n, p) and Y (n, q), any strides,
    read in their own dtypes; row chunks of ``chunk`` rows reduced in
    ``ops/contract.py``'s pairwise tree.  Returns (G, launches)."""
    if acc != (torch.float64 if torch.float64 in (X.dtype, Y.dtype)
               else torch.float32):
        raise ValueError(f"no skinny gram kernel for {X.dtype} × {Y.dtype} "
                         f"accumulated in {acc}")
    _check_skinny("skinny gram", X, Y)
    n, p = X.shape
    q = Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"gram: X has {n} rows, Y {Y.shape[0]}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if n == 0 or p == 0 or q == 0:
        return torch.zeros((p, q), dtype=acc, device=X.device), 0
    if q > _GRAM_MAX_Q:
        parts = [launch_gram(X, Y[:, j:j + _GRAM_MAX_Q], chunk=chunk, acc=acc)
                 for j in range(0, q, _GRAM_MAX_Q)]
        return (torch.cat([g for g, _ in parts], dim=1),
                sum(k for _, k in parts))
    dev = X.device
    xr, xc = X.stride()
    yr, yc = Y.stride()
    plan = gram_plan(n, p, q, chunk, X.element_size(), Y.element_size(),
                     acc.itemsize, _sm_count(dev.index))
    nchunks, split = plan["nchunks"], plan["split"]
    out = torch.empty((p, q), dtype=acc, device=dev)
    # the chunks' partials (freed on return: the result holds no view of them)
    part = (out if nchunks * split == 1 else
            torch.empty((nchunks * split, p, q), dtype=acc, device=dev))
    stream = _stream(dev)
    tickets = _ticket_buffer(dev, stream, (nchunks + 1) * plan["tiles"])
    prm = (ctypes.c_longlong * 19)(
        n, xr, xc, yr, yc, chunk, plan["sublen"], p, q, nchunks, split,
        plan["nct"], plan["nqt"], plan["rgn"], copy_mode(X, plan["nct"] * plan["cp"]),
        copy_mode(Y, plan["nqt"] * _GRAM_CQ), plan["ldx"], plan["ldy"],
        plan["smem"])
    _call(f"rbl_skinny_gram_{_SUFFIX[X.dtype]}_{_SUFFIX[Y.dtype]}_"
          f"{_SUFFIX[acc]}", dev, X.data_ptr(), Y.data_ptr(), part.data_ptr(),
          out.data_ptr(), tickets.data_ptr(), ctypes.addressof(prm))
    return out, 1


_UPDATE_STAGES = 3         # tiles in K2's ring (kStages2)
_UPDATE_SMEM = 110 * 1024  # shared bytes a K2 CTA aims at: two a SM


@functools.lru_cache(maxsize=4096)
def update_plan(n: int, p: int, q: int, acc_size: int, v_size: int,
                w_size: int, sms: int) -> dict:
    """K2's launch for V (n, p) of ``v_size``-byte elements, q output
    columns and W of ``w_size``-byte elements (0: none): kg threads (a
    power of 2, ≤ 16, ≤ p / (16·ks)) split a slab of kg·ks columns of V
    (ks: 32 bytes of a row), ntq × ntm groups of them (powers of 2, at most
    256 threads)
    hold 4 × 4 outputs each, G's rows staged pg at a time, the tiles' row
    strides, the dynamic shared bytes and the resident CTAs of each of the
    ⌈q / 4·ntq⌉ column tiles (two a SM in all, at most a row tile each)."""
    ntq = 1 if q <= 4 else (2 if q <= 8 else 4)
    ks = 32 // v_size
    # k groups: a row tile's slabs hold at least 16·ks columns a group, so
    # that the butterfly and the stores at its end stay a small share
    kg = 1
    while kg < 16 and 2 * kg * 16 * ks <= p:
        kg *= 2
    # row groups: 256 threads at most, tiles of at most 256 rows and slabs
    # of at most 26 KiB (so that the ring and G leave room for two CTAs)
    cap = min(256 // (kg * ntq), 64, max(1, 26624 // (4 * (kg * 32 + 16))))
    ntm = 1 << (cap.bit_length() - 1)
    bm, bk, qt = 4 * ntm, kg * ks, 4 * ntq
    lda = _padded(bk, v_size)
    ldw = _padded(qt, w_size, 0) if w_size else 0
    slab = bm * lda * v_size + _cdiv(bm * ldw * w_size, 16) * 16
    room = _UPDATE_SMEM - _UPDATE_STAGES * slab - 16
    pg = min(_cdiv(p, bk), max(1, room // (qt * acc_size) // bk)) * bk
    ldgt = _padded(pg, acc_size)
    smem = _cdiv(qt * ldgt * acc_size, 16) * 16 + _UPDATE_STAGES * slab
    return dict(ntq=ntq, kg=kg, ntm=ntm, lda=lda, ldw=ldw, pg=pg, ldgt=ldgt,
                smem=smem, ctas=min(_cdiv(n, bm), max(1, 2 * sms // _cdiv(q, qt))))


def launch_update(V: torch.Tensor, G: torch.Tensor, W, *,
                  acc: torch.dtype) -> torch.Tensor:
    """K2: W − V·round(G) in W's dtype, or V·round(G) in ``acc`` with
    ``W`` None; G (p, q) rounded to V's dtype first, the products
    accumulated in ``acc``.  Any strides; the result is row-major."""
    _check_skinny("skinny update", V, G, *(() if W is None else (W,)))
    n, p = V.shape
    q = G.shape[1]
    if G.shape[0] != p or (W is not None and W.shape != (n, q)):
        raise ValueError(f"update: V {tuple(V.shape)}, G {tuple(G.shape)}, "
                         f"W {None if W is None else tuple(W.shape)}")
    if acc not in (torch.float32, torch.float64):
        raise ValueError(f"no skinny update kernel accumulating in {acc}")
    odt = acc if W is None else W.dtype
    dev = V.device
    if n == 0 or q == 0 or p == 0:
        return (torch.zeros((n, q), dtype=odt, device=dev) if W is None
                else W.clone(memory_format=torch.contiguous_format))
    out = torch.empty((n, q), dtype=odt, device=dev)
    ws = 0 if W is None else W.element_size()
    plan = update_plan(n, p, q, acc.itemsize, V.element_size(), ws,
                       _sm_count(dev.index))
    wr, wc = (0, 0) if W is None else W.stride()
    prm = (ctypes.c_longlong * 23)(
        n, *V.stride(), *G.stride(), wr, wc, p, q, plan["ntq"], plan["kg"],
        plan["ntm"], copy_mode(V, plan["kg"] * 32 // V.element_size()),
        0 if W is None else copy_mode(W, 4 * plan["ntq"]), _CODE[G.dtype],
        _CODE[None if W is None else W.dtype], _CODE[odt], plan["lda"],
        plan["ldw"], plan["pg"], plan["ldgt"], plan["smem"], plan["ctas"])
    _call(f"rbl_skinny_update_{_SUFFIX[V.dtype]}_{_SUFFIX[acc]}", dev,
          V.data_ptr(), G.data_ptr(), 0 if W is None else W.data_ptr(),
          out.data_ptr(), ctypes.addressof(prm))
    return out


# ------------------------------------------------------------------------
# csrc/stencil.cu: the 5-point stencil and the product filter's step (K3)

_STENCIL_CGT = 16          # column groups a CTA, where the columns need several
_STENCIL_CTAS_PER_SM = 3   # resident CTAs a SM (the kernel's launch bounds)


def stencil_vec(Y: torch.Tensor) -> int:
    """Columns a thread of K3 loads as one unit of Y (n, b): the most, up to
    16 bytes, that b, the row stride and the pointer's alignment allow."""
    es = Y.element_size()
    b = Y.shape[1]
    rs = Y.stride(0)
    v = 16 // es
    while v > 1 and (b % v or rs % v or Y.data_ptr() % (v * es)):
        v //= 2
    return v


@functools.lru_cache(maxsize=1024)
def stencil_plan(nx: int, ny: int, b: int, vec: int, sms: int) -> dict:
    """K3's launch on the nx × ny grid for b columns in units of ``vec``:
    tiles of cgt column groups (at most 16 where there are more, split
    evenly) by ty grid points along y (at most 256 threads, at least 2),
    marching over gx grid rows, so that the CTAs number three a SM where
    the grid allows.  CTA x is (march, y tile) = divmod(x, ytiles); the
    order of the column sums follows from the plan."""
    cg = b // vec
    tiles = _cdiv(cg, _STENCIL_CGT)
    cgt = _cdiv(cg, tiles)
    ty = max(2, min(256 // cgt, ny))
    ytiles = _cdiv(ny, ty)
    marches = max(1, min(nx, _STENCIL_CTAS_PER_SM * sms // (tiles * ytiles)))
    gx = _cdiv(nx, marches)
    return dict(cgt=cgt, ty=ty, tiles=tiles, ytiles=ytiles, gx=gx,
                ctas=ytiles * _cdiv(nx, gx))


def launch_stencil(Y: torch.Tensor, ny: int, r=None, sumsq_in=None,
                   sumsq: bool = False) -> tuple:
    """K3 on Y (n, b), n a multiple of ``ny``, any row stride, column stride
    1: Z = ((A − r·I)·Y)·s, row-major in Y's dtype, s_c = 1/√sumsq_in[c]
    (1 where that is not > 0, or with no ``sumsq_in``), r a 0-d tensor of
    Y's dtype (None: 0); with ``sumsq``, also Σ_rows Z² a column in the
    compute dtype (f64 for f64, else f32).  Returns (Z, sums or None)."""
    if Y.dtype not in _SUFFIX or Y.dim() != 2:
        raise ValueError(f"the stencil kernel takes a 2-D bf16, f32 or f64 "
                         f"block, got {Y.dtype} of {Y.dim()} dims")
    n, b = Y.shape
    acc = torch.float64 if Y.dtype == torch.float64 else torch.float32
    if r is not None and (r.dtype != Y.dtype or r.numel() != 1):
        raise ValueError(f"stencil: r must be one {Y.dtype} value")
    if sumsq_in is not None and (sumsq_in.dtype != acc or sumsq_in.shape != (b,)
                                 or sumsq_in.stride(0) != 1):
        raise ValueError(f"stencil: sumsq_in must be ({b},) contiguous {acc}")
    if (b > 1 and Y.stride(1) != 1) or Y.stride(0) < b:
        raise ValueError(f"stencil: the block must have column stride 1 and a "
                         f"row stride of at least b, got {Y.stride()}")
    if ny < 1 or n % ny or n >= 2 ** 31:
        raise ValueError(f"stencil: {n} rows are not a grid of rows of {ny}")
    dev = Y.device
    for t in (Y, r, sumsq_in):
        if t is not None and (t.device.type != "cuda" or t.device != dev):
            raise ValueError(f"the stencil kernel takes CUDA tensors on one "
                             f"device, got {t.device}")
    Z = torch.empty((n, b), dtype=Y.dtype, device=dev)
    if n == 0 or b == 0:
        return Z, (torch.zeros(b, dtype=acc, device=dev) if sumsq else None)
    S = torch.empty(b, dtype=acc, device=dev) if sumsq else None
    vec = stencil_vec(Y)
    plan = stencil_plan(n // ny, ny, b, vec, _sm_count(dev.index))
    part = tickets = None
    if sumsq:
        part = torch.empty((plan["ctas"], b), dtype=acc, device=dev)
        tickets = _ticket_buffer(dev, _stream(dev), plan["tiles"])
    prm = (ctypes.c_longlong * 11)(
        n // ny, ny, Y.stride(0), b, vec, plan["cgt"], plan["ty"], plan["gx"],
        plan["ytiles"], plan["ctas"], plan["tiles"])
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    _call(f"rbl_stencil_{_SUFFIX[Y.dtype]}", dev, Y.data_ptr(), Z.data_ptr(),
          ptr(r), ptr(sumsq_in), ptr(S), ptr(part), ptr(tickets),
          ctypes.addressof(prm))
    return Z, S
