#!/usr/bin/env python3
"""Time the packed (B1/B2) and blocked-ELL (B3) SpMM kernels on one CUDA
card over block widths, beside the bare tile stream and torch.sparse CSR.

    python3 tools/bench_spmm.py [--widths 4,8,16,32] [--plan 64:4] [--ell]
                                [--plans R:stages,...] [--f64] [--root DIR]
                                [--out FILE]

On fem_elasticity_3d(42) (n = 232,974) in f32, packed on ``--plan``
(bm:U), for each block width b:

  - the packed kernel (``bsr_spmm_packed``) over 20 calls launched back to
    back, median of 5, as chip_smoke.py phase 10 times it;
  - the bare stream of the same ``vals`` (B5, ``dma_stream``), timed the
    same way, and the kernel's excess over it;
  - ``torch.sparse.mm`` on the CSR matrix (median of 20 single calls);
  - the SM clock (``nvidia-smi``, median of samples taken while the kernel
    runs back to back for about a second);
  - the kernel's register-block plan (R, C, stages, shared bytes), where
    the kernel reports one.

``--plans`` also times the packed kernel with each given register block
and ring (R rows a thread, ring stages) and checks that its output
equals the default plan's bit for bit.  ``--f64`` also times the packed
kernel (back to back and single calls) and ``torch.sparse.mm`` on the CSR
matrix in f64 at every width.  With ``--ell`` the same as above for B3
(``bsr_spmm``) on fem42's blocked-ELL layout at bm = 128.  ``--root`` imports ``rbl_tpu_torch`` from another
checkout, so that two commits can be compared on one card in one call.
Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def back_to_back_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``calls`` calls
    launched back to back (CUDA events), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def single_ms(fn, reps: int = 20) -> float:
    """Median device time of ``reps`` single calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sm_clock_mhz(fn, seconds: float = 1.0) -> float:
    """Median SM clock sampled by nvidia-smi every 100 ms while ``fn`` runs
    back to back for about ``seconds``."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    mhz = [float(v) for v in out.split() if v.strip().isdigit()]
    return float(np.median(mhz)) if mhz else float("nan")


def packed_with_plan(_kernels, op, X, R: int, stages: int):
    """The packed f32 kernel on ``op`` with a given register block and
    ring (``rbl_bsr_spmm_packed_plan_f32``)."""
    import torch

    nb, b = op.rptr.shape[0], X.shape[1]
    Y = torch.empty((nb * op.bm, b), dtype=torch.float32, device=X.device)
    _kernels._call("rbl_bsr_spmm_packed_plan_f32", X.device,
                   op.tile_cols.data_ptr(), op.hcount.data_ptr(),
                   op.rptr.data_ptr(), op.vals.data_ptr(), X.data_ptr(),
                   Y.data_ptr(), nb, op.bm, op.bk, b, op.unroll, R, stages)
    return Y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="4,8,16,32")
    ap.add_argument("--plan", default="64:4", help="packed plan bm:U")
    ap.add_argument("--ell", action="store_true", help="also time B3 at bm=128")
    ap.add_argument("--plans", default="",
                    help="R:stages plans of the packed kernel to time too")
    ap.add_argument("--f64", action="store_true",
                    help="also time the packed kernel and CSR in f64")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose rbl_tpu_torch is measured")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_spmm.py needs a CUDA card", file=sys.stderr)
        return 2
    from rbl_tpu_torch.benchmarks import dma_stream_bench as tds
    from rbl_tpu_torch.ops.spmm import _kernels, bsr
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lines = []

    def emit(**rec):
        rec = dict(root=os.path.abspath(args.root), card=card, **rec)
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    plan_of = getattr(_kernels, "spmm_plan", None)
    A = fem_elasticity_3d(42)
    n = A.shape[0]
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data.astype(np.float32)), size=A.shape).to("cuda")
    bm, U = (int(v) for v in args.plan.split(":"))
    op = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float32, bm=bm,
                                            unroll=U, device="cuda")
    T = op.vals.shape[0]
    flat = op.vals.view(-1, 128)
    seed = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    stream = tds.make_stream(T // U, bm * U)
    stream_ms = back_to_back_ms(lambda: stream(flat, seed))
    emit(kernel="dma_stream", plan=[bm, U], tiles=T,
         vals_mb=op.vals.numel() * 4 / 1e6, ms=stream_ms)
    widths = [int(v) for v in args.widths.split(",")]
    g = torch.Generator(device="cuda")
    for b in widths:
        X = torch.randn((-(-n // 128) * 128, b),
                        generator=g.manual_seed(b), device="cuda")
        call = lambda: bsr.bsr_spmm_packed(op.tile_cols, op.hcount, op.rptr,
                                           op.vals, X, bm=bm, bk=128, H=op.H,
                                           unroll=U)
        ms = back_to_back_ms(call)
        Xl = X[:n]
        emit(kernel="bsr_spmm_packed", plan=[bm, U], b=b, ms=ms,
             excess_ms=ms - stream_ms, stream_ms=stream_ms,
             single_ms=single_ms(call),
             csr_ms=single_ms(lambda: torch.sparse.mm(csr, Xl)),
             sm_clock_mhz=sm_clock_mhz(call),
             register_plan=plan_of(bm, b, torch.float32) if plan_of else None)
        want = call()
        for spec in filter(None, args.plans.split(",")):
            R, stages = (int(v) for v in spec.split(":"))
            given = lambda: packed_with_plan(_kernels, op, X, R, stages)
            try:  # a plan whose CTA exceeds the kernel's limits is refused
                got = given()
            except RuntimeError as e:
                emit(kernel="bsr_spmm_packed", plan=[bm, U], b=b,
                     register_plan=dict(R=R, stages=stages), refused=str(e))
                continue
            emit(kernel="bsr_spmm_packed", plan=[bm, U], b=b,
                 register_plan=dict(R=R, stages=stages),
                 ms=back_to_back_ms(given), stream_ms=stream_ms,
                 equal_default=bool(torch.equal(got, want)))
    del op, flat
    torch.cuda.empty_cache()
    if args.f64:
        op = bsr.BlockSparseOperator.from_scipy(A, dtype=torch.float64, bm=bm,
                                                unroll=U, device="cuda")
        csr64 = torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(A.data.astype(np.float64)), size=A.shape).to("cuda")
        for b in widths:
            X = torch.randn((-(-n // 128) * 128, b), generator=g.manual_seed(b),
                            dtype=torch.float64, device="cuda")
            call = lambda: bsr.bsr_spmm_packed(op.tile_cols, op.hcount, op.rptr,
                                               op.vals, X, bm=bm, bk=128, H=op.H,
                                               unroll=U)
            Xl = X[:n]
            emit(kernel="bsr_spmm_packed", dtype="float64", plan=[bm, U], b=b,
                 ms=back_to_back_ms(call), single_ms=single_ms(call),
                 csr_ms=single_ms(lambda: torch.sparse.mm(csr64, Xl)))
        del op, csr64
        torch.cuda.empty_cache()
    if args.ell:
        bc, bv, nb, ncb, L = bsr._blocked_ell_from_scipy(A, 128, 128, np.float32)
        bc = torch.from_numpy(bc.reshape(-1)).cuda()
        bv = torch.from_numpy(bv.reshape(-1, 128, 128)).cuda()
        S = bv.shape[0]
        estream = tds.make_stream(S, 128)
        eflat = bv.view(-1, 128)
        estream_ms = back_to_back_ms(lambda: estream(eflat, seed))
        for b in widths:
            X = torch.randn((ncb * 128, b), generator=g.manual_seed(b),
                            device="cuda")
            call = lambda: bsr.bsr_spmm(bc, bv, X, bm=128, bk=128, L=L)
            ms = back_to_back_ms(call)
            Xl = X[:n]
            emit(kernel="bsr_spmm", plan=[128, L], b=b, tiles=S,
                 vals_mb=bv.numel() * 4 / 1e6, ms=ms, stream_ms=estream_ms,
                 excess_ms=ms - estream_ms, single_ms=single_ms(call),
                 csr_ms=single_ms(lambda: torch.sparse.mm(csr, Xl)),
                 register_plan=plan_of(128, b, torch.float32) if plan_of else None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
