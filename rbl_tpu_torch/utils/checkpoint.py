"""Checkpoint / resume (port of ``rbl_tpu/utils/checkpoint.py``).

The reference has no checkpointing (SURVEY §5).  Three save surfaces:

- Restart boundary (restarted solver): state compresses to (lock set,
  locked values, count, sweep length, next start block).
- Sweep-chunk boundary (main solver, ``RBLConfig.sweep_checkpoint_path``):
  the full mid-sweep state at the between-chunks invariant — basis prefix
  Q_1..Q_{i-1}, the in-flight recurrence triple (Q_{i+1}, Q_i, B_{i+1}),
  the T band, the coupling history, and the reorth-policy flags — written
  atomically (tmp + rename) every ``sweep_checkpoint_every`` clean chunks
  and deleted on completion.
- Filter-pass boundary (Chebyshev polish, ``chebyshev_refine``): the whole
  iterate is the (n, m) block + Ritz values/residuals, written atomically
  each pass.

Each is a single .npz with the JAX package's key names, so a file written
by either package is read by the other.  Tensors are copied to the host
(sub-f32 dtypes upcast to f32 — numpy has no portable bf16).  One key does
not cross: the JAX package's sweep state holds its ``jax.random`` key under
``key``.  The port writes a valid key there for that package to resume
from, and keeps its own ``torch.Generator`` state under ``gen_state`` (with
``gen_device``, the kind of device that generator lives on).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..config import resolve_device
from ..solver.basis import _to_numpy


def _np32(x):
    """Host copy, sub-f32 upcast to f32 (portable serialization)."""
    if isinstance(x, torch.Tensor):
        return _to_numpy(x)
    a = np.asarray(x)
    if a.dtype.kind == "f" and a.dtype.itemsize < 4:
        return a.astype(np.float32)
    return a


def save_restart_state(path: str, state) -> None:
    np.savez(
        path,
        lock_buf=_np32(state.lock_buf),
        locked_values=np.asarray(state.locked_values),
        count=np.int64(state.count),
        kryl_dim=np.int64(state.kryl_dim),
        Qi=_np32(state.Qi),
        restarts=np.int64(state.restarts),
        low_yield_streak=np.int64(getattr(state, "low_yield_streak", 0)),
    )


def load_restart_state(path: str, device=None):
    """A ``RestartState`` from a file of either package, with ``lock_buf``
    and ``Qi`` on ``device`` (default: the CUDA card; raises without
    one)."""
    from ..solver.restarted import RestartState

    dev = resolve_device(device)
    z = np.load(path)
    return RestartState(
        lock_buf=torch.from_numpy(z["lock_buf"]).to(dev),
        locked_values=z["locked_values"].copy(),
        count=int(z["count"]),
        kryl_dim=int(z["kryl_dim"]),
        Qi=torch.from_numpy(z["Qi"]).to(dev),
        restarts=int(z["restarts"]),
        low_yield_streak=(
            int(z["low_yield_streak"]) if "low_yield_streak" in z else 0
        ),
    )


def save_polish_state(path: str, X, theta, res, npass: int) -> None:
    """Atomic pass-boundary checkpoint for chebyshev_refine: the filtered
    block X (n, m) plus the last Rayleigh–Ritz values/residuals."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                X=np.asarray(_np32(X), dtype=np.float64),
                theta=np.asarray(theta, dtype=np.float64),
                res=np.asarray(res, dtype=np.float64),
                npass=np.int64(npass),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_polish_state(path: str) -> dict:
    z = np.load(path)
    return dict(X=z["X"], theta=z["theta"], res=z["res"],
                npass=int(z["npass"]))


def save_sweep_state(path: str, state: dict) -> None:
    """Atomically persist a mid-sweep checkpoint (lanczos_iteration).

    ``state`` carries numpy arrays, tensors and python scalars; the write
    goes through a temp file + rename so a crash mid-save can never leave
    a torn checkpoint behind."""
    payload = {}
    for k, v in state.items():
        if isinstance(v, dict):  # B_hist: {iteration: (b, b)}
            keys = np.asarray(sorted(v.keys()), dtype=np.int64)
            payload[f"{k}__keys"] = keys
            payload[f"{k}__vals"] = np.stack(
                [np.asarray(v[int(i)], dtype=np.float64) for i in keys]
            ) if keys.size else np.zeros((0,))
        elif isinstance(v, (bool, int, float, str)):
            payload[k] = np.asarray(v)
        else:
            payload[k] = _np32(v)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_sweep_state(path: str) -> dict:
    """Inverse of ``save_sweep_state`` — scalars back to python types,
    dict-valued entries reassembled.  Everything stays on the host:
    ``lanczos_iteration(resume=...)`` places it."""
    z = np.load(path)
    out: dict = {}
    dicts: dict = {}
    for k in z.files:
        if k.endswith("__keys"):
            dicts.setdefault(k[: -len("__keys")], {})["keys"] = z[k]
        elif k.endswith("__vals"):
            dicts.setdefault(k[: -len("__vals")], {})["vals"] = z[k]
        else:
            a = z[k]
            out[k] = a.item() if a.ndim == 0 else a
    for name, kv in dicts.items():
        out[name] = {
            int(i): kv["vals"][j] for j, i in enumerate(kv["keys"])
        }
    return out
