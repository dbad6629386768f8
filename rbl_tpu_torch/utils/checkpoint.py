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

Under a row mesh (``mesh=``, a ``parallel.mesh.RowMesh``) a save sends
every rank's rows of the n-row arrays to rank 0's host (all ranks call
it), rank 0 writes the same file a single device would, and the ranks
agree on the write's success: a failed write raises on every rank.  A
resume reads the whole file on every rank and keeps its rows.
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


def _whole(x, mesh, n: int):
    """The host copy of an n-row array of which this rank holds its rows:
    the whole of it without a mesh; under a mesh (a collective) the whole
    on rank 0 and None on the others."""
    if mesh is None:
        return _np32(x)
    return mesh.gather_rows_host(x, n)


def _written(mesh, write) -> None:
    """Run ``write`` on rank 0 only (every rank without a mesh).  Under a
    mesh the ranks then agree on its success, so a write that fails on
    rank 0 raises on every rank instead of leaving the others waiting."""
    if mesh is None:
        write()
        return
    err = None
    if mesh.rank == 0:
        try:
            write()
        except Exception as e:  # re-raised below, after the agreement
            err = e
    if not mesh.agree(err is None):
        if err is not None:
            raise err
        raise RuntimeError("the checkpoint write on rank 0 failed")


def remove_file(path: str, mesh=None) -> None:
    """Delete a finished solve's checkpoint: rank 0's job under a mesh,
    behind a barrier on both sides, so that no rank still reads it."""
    if mesh is not None:
        mesh.barrier()
    if (mesh is None or mesh.rank == 0) and os.path.exists(path):
        os.remove(path)
    if mesh is not None:
        mesh.barrier()


def file_exists(path: str, mesh=None) -> bool:
    """Whether the checkpoint exists, agreed by every rank under a mesh
    (a file seen by some ranks only is not resumed from)."""
    there = os.path.exists(path)
    return there if mesh is None else mesh.agree(there)


def save_restart_state(path: str, state, mesh=None, n: int | None = None
                       ) -> None:
    """The restart-boundary state; under ``mesh`` ``lock_buf`` and ``Qi``
    are the rank's rows of n."""
    lock_buf = _whole(state.lock_buf, mesh, n)
    Qi = _whole(state.Qi, mesh, n)
    _written(mesh, lambda: np.savez(
        path,
        lock_buf=lock_buf,
        locked_values=np.asarray(state.locked_values),
        count=np.int64(state.count),
        kryl_dim=np.int64(state.kryl_dim),
        Qi=Qi,
        restarts=np.int64(state.restarts),
        low_yield_streak=np.int64(getattr(state, "low_yield_streak", 0)),
    ))


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


def save_polish_state(path: str, X, theta, res, npass: int, mesh=None,
                      n: int | None = None) -> None:
    """Atomic pass-boundary checkpoint for chebyshev_refine: the filtered
    block X (n, m) plus the last Rayleigh–Ritz values/residuals (under
    ``mesh`` X is the rank's rows of n)."""
    X = _whole(X, mesh, n)
    _written(mesh, lambda: _save_polish(path, X, theta, res, npass))


def _save_polish(path, X, theta, res, npass):
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


# the n-row entries of a sweep state: a rank holds its rows of each
_SWEEP_ROWS = ("basis", "Q_ip1", "Q_i")


def save_sweep_state(path: str, state: dict, mesh=None) -> None:
    """Atomically persist a mid-sweep checkpoint (lanczos_iteration).

    ``state`` carries numpy arrays, tensors and python scalars; the write
    goes through a temp file + rename so a crash mid-save can never leave
    a torn checkpoint behind.  Under ``mesh`` the n-row entries are the
    rank's rows (of ``state["n"]``)."""
    if mesh is not None:
        state = dict(state)
        for k in _SWEEP_ROWS:
            state[k] = _whole(state[k], mesh, int(state["n"]))
    _written(mesh, lambda: _save_sweep(path, state))


def _save_sweep(path, state):
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
