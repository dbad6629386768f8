"""Run one cell of the benchmark of rbl_tpu_torch once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit) and the checks again as the last
lines of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  Exits 1
without a result when no CUDA card (or fewer than the cell asks for) is
present, when the program cannot be imported, or when JAX or the JAX
package was loaded into the process.  The host's thread pools run at the
configuration's ``host_threads``.  See perfbench/README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def _pin_caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the port builds its CUDA and host libraries into
    ``rbl_tpu_torch/build/`` beside its sources)."""
    cache = BENCH / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def _pin_threads(n: int) -> None:
    """The host's thread pools at the configuration's ``host_threads``:
    set before numpy or torch is first imported, so that OpenMP and the
    BLAS start with that many threads, and torch's own pool after."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, str(CHECKOUT))
    from perfbench.harness import spec

    threads = int(spec.config_of(args.workload)["host_threads"])
    _pin_threads(threads)

    import torch

    from perfbench.harness import cell_run

    torch.set_num_threads(threads)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    found = cell_run.banned_modules()
    if found:
        print(f"run.py: the process holds {found} after the window",
              file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
