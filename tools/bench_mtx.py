#!/usr/bin/env python3
"""The port's C++ MatrixMarket reader against ``scipy.io.mmread`` on the
host, at the size of a SuiteSparse benchmark matrix.

    python3 tools/bench_mtx.py [--fem 42] [--reps 3] [--out bench_mtx.json]
    python3 tools/bench_mtx.py --fem 8 --reps 1        # smoke run

``fem_elasticity_3d(--fem)`` is written to a temporary .mtx file in
symmetric storage (as SuiteSparse ships its structural matrices) and in
general storage.  Each reader then reads each file ``--reps`` times,
alternating (native, mmread, native, ...), after one untimed read of each
to warm the page cache and build the library; the median wall of each is
reported, and the two results must be equal.  Prints one line a file and
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fem", type=int, default=42, help="fem_elasticity_3d size")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import numpy as np
    import scipy
    import scipy.io
    import scipy.sparse as sp

    from rbl_tpu_torch.native import read_matrix_market
    from rbl_tpu_torch.utils.fem import fem_elasticity_3d

    A = fem_elasticity_3d(args.fem)
    res = dict(matrix=f"fem_elasticity_3d({args.fem})", n=A.shape[0], nnz=A.nnz,
               scipy=scipy.__version__, cpus=os.cpu_count(), files={})
    with tempfile.TemporaryDirectory() as d:
        for symmetry in ("symmetric", "general"):
            path = os.path.join(d, f"fem{args.fem}_{symmetry}.mtx")
            t0 = time.perf_counter()
            scipy.io.mmwrite(path, A, symmetry=symmetry)
            write_s = time.perf_counter() - t0
            native = lambda: read_matrix_market(path)
            mmread = lambda: scipy.io.mmread(path)
            An, As = native().tocsr(), sp.csr_matrix(mmread())
            if An.shape != As.shape or abs(An - As).max() != 0:
                raise AssertionError(f"{path}: the two readers differ")
            del An, As
            native_s, mmread_s = [], []
            for _ in range(args.reps):
                native_s.append(_wall(native))
                mmread_s.append(_wall(mmread))
            row = dict(mb=os.path.getsize(path) / 1e6, write_s=write_s,
                       native_s=float(np.median(native_s)),
                       mmread_s=float(np.median(mmread_s)),
                       native_all_s=native_s, mmread_all_s=mmread_s)
            res["files"][symmetry] = row
            print(f"{res['matrix']} {symmetry} .mtx ({row['mb']:.1f} MB, "
                  f"{A.nnz} nonzeros): native reader {row['native_s']:.3f} s, "
                  f"scipy.io.mmread {row['mmread_s']:.3f} s (scipy {scipy.__version__}, "
                  f"{res['cpus']} cores; median of {args.reps})", flush=True)
            os.remove(path)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
