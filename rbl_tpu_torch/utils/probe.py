"""Device health probes and a fault-tolerant solve wrapper (port of
``rbl_tpu/utils/probe.py``).

A solve can fail for a reason that is not in the matrix: the device
returns garbage for a while after an out-of-memory crash, or another
process holds the memory a solve needs.  The solvers' non-finite-T guard
(``solver/lanczos.py``, ``solver/polish.py``) turns garbage into a
``FloatingPointError``.  This module re-dispatches such a solve:

- ``backend_healthy()``: value-checked probes on the solve's device, an
  f32 and an f64 matrix product of ones and an f64 dot.  Every expected
  value is exactly representable, so the checks are equalities.
- ``wait_until_healthy()``: poll the probes until they pass.
- ``solve_with_retry()``: run a solver entry; on a retryable exception or
  a non-finite result, wait for a healthy device and re-dispatch.
- ``resolve_fault_retries()``: the solver entries' retry count
  (``RBLConfig.fault_retries``; by default 1 on the card, 0 on the CPU).

The retryable set differs from the JAX package's on purpose.  It holds
``FloatingPointError`` and ``torch.OutOfMemoryError``: an OOM leaves the
CUDA context usable, and ``torch.cuda.empty_cache()`` returns the cached
blocks before the health wait.  It does not hold a bare ``RuntimeError``
or ``torch.AcceleratorError``, where the JAX package retries every
``JaxRuntimeError``: a sticky CUDA error (an illegal address, a failed
launch) kills the context for the life of the process, so every probe
would fail and the wait would sleep 12 × 60 s before raising.  Such an
error propagates on the first attempt.

Under a row mesh (``cfg.mesh``) only ``FloatingPointError`` is retried.
T and the Rayleigh-Ritz matrix are all-reduced, so every rank raises it
at the same step and all re-dispatch together; an OOM strikes one rank
and leaves the others blocked in a collective, so it propagates.  The
verdict on a result goes through ``RowMesh.agree``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import resolve_device


def backend_healthy(n64: int = 512, device=None) -> bool:
    """Value-checked probes on ``device`` (None: the CUDA card): a 128²
    f32 product of ones, an ``n64``² f64 product of ones, and the f64 dot
    of 1..1000 with itself.  False on a wrong value or any exception."""
    try:
        dev = resolve_device(device)
        x = torch.ones((128, 128), dtype=torch.float32, device=dev)
        if abs(float((x @ x)[7, 11]) - 128.0) > 1e-3:
            return False
        y = torch.ones((n64, n64), dtype=torch.float64, device=dev)
        if float((y @ y)[3, 5]) != float(n64):
            return False
        d = torch.arange(1.0, 1001.0, dtype=torch.float64, device=dev)
        # sum i^2, i=1..1000 — exactly representable in f64
        return float(d @ d) == 333833500.0
    except Exception:
        return False


def wait_until_healthy(attempts: int = 12, sleep_s: float = 60.0,
                       n64: int = 512, device=None) -> bool:
    """Poll ``backend_healthy`` up to ``attempts`` times, ``sleep_s``
    apart.  True when healthy; False if every attempt failed."""
    for attempt in range(attempts):
        if backend_healthy(n64=n64, device=device):
            return True
        if attempt < attempts - 1:
            time.sleep(sleep_s)
    return False


def _result_finite(res: Any) -> bool:
    vals = getattr(res, "eigenvalues", None)
    if vals is None:
        return True
    return bool(np.all(np.isfinite(np.asarray(vals))))


def _retryable_exceptions(mesh=None) -> tuple:
    """FloatingPointError (the non-finite guard) and, off a mesh, CUDA's
    out-of-memory error (module docstring)."""
    if mesh is not None:
        return (FloatingPointError,)
    return (FloatingPointError, torch.OutOfMemoryError)


def solve_with_retry(
    solve_fn: Callable[..., Any],
    *args: Any,
    retries: int = 1,
    attempts: int = 12,
    sleep_s: float = 60.0,
    validate: Optional[Callable[[Any], bool]] = None,
    exceptions: Optional[tuple] = None,
    device=None,
    **kwargs: Any,
) -> Any:
    """Dispatch ``solve_fn(*args, **kwargs)``; on a retryable exception
    (``exceptions`` overrides the default FloatingPointError and
    torch.OutOfMemoryError) or a result whose eigenvalues are non-finite
    (``validate`` overrides the check), wait for a healthy ``device``
    (None: the CUDA card) and re-dispatch up to ``retries`` more times.
    After an out-of-memory error the allocator's cached blocks are
    released first.  The last attempt's error propagates and its result
    returns as it is, so a genuine numerical failure still surfaces."""
    validate = validate or _result_finite
    exceptions = exceptions if exceptions is not None else _retryable_exceptions()
    for attempt in range(retries + 1):
        if attempt > 0:
            wait_until_healthy(attempts=attempts, sleep_s=sleep_s,
                               device=device)
        try:
            res = solve_fn(*args, **kwargs)
        except exceptions as e:
            if attempt == retries:
                raise
            if isinstance(e, torch.OutOfMemoryError):
                torch.cuda.empty_cache()
            continue
        if validate(res) or attempt == retries:
            return res
    raise AssertionError("unreachable: the last attempt returns or raises")


def resolve_fault_retries(cfg, device=None) -> int:
    """The solver entries' retry count: ``cfg.fault_retries`` when set;
    otherwise 0 when the solve's ``device`` (None: ``cfg.device``
    resolved, which is the card unless it names the CPU) is the CPU,
    where a FloatingPointError is a genuine numerical failure that a retry
    would only repeat, and 1 on the card."""
    if getattr(cfg, "fault_retries", None) is not None:
        return int(cfg.fault_retries)
    dev = torch.device(device) if device is not None else resolve_device(cfg.device)
    return 0 if dev.type == "cpu" else 1


def dispatch(solve_fn: Callable[[], Any], cfg, device) -> Any:
    """Run a solver entry's ``solve_fn()`` under ``cfg``'s fault retries
    on ``device``: directly when there are none, else through
    ``solve_with_retry`` with the mesh's retryable set and, under a mesh,
    the ranks' agreed verdict on the result."""
    retries = resolve_fault_retries(cfg, device)
    if not retries:
        return solve_fn()
    mesh = cfg.mesh
    validate = None
    if mesh is not None:
        def validate(res):
            return mesh.agree(_result_finite(res))
    return solve_with_retry(
        solve_fn, retries=retries, validate=validate,
        exceptions=_retryable_exceptions(mesh), device=device,
    )
