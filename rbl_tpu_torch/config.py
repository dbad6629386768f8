"""Solver configuration (PyTorch port of ``rbl_tpu/config.py``).

Every knob the reference hardcodes lives in one typed config object threaded
through the solver.  Dtypes are ``torch.dtype`` values.  Knobs that exist
only for the TPU (the f64 chunk-growth clamp, the post-OOM probe retries,
the geometric basis growth) are not carried over.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RBLConfig:
    """Configuration for the randomized block Lanczos solver.

    Attributes
    ----------
    block_size:
        Block width b (number of Lanczos vectors advanced per iteration).
    max_kryl_dim:
        Hard cap on the Krylov subspace dimension (reference: 1400 CPU /
        1200 GPU).  The solve may lower it further to fit the basis in
        free device memory (``parallel.memory``).
    tol:
        Ritz-pair residual-bound convergence tolerance (reference: 1e-7).
    basis_dtype:
        Storage/reorthogonalization precision of the Krylov basis — the
        reference's ``FLOAT`` (common.jl:5).
    compute_dtype:
        Precision of the three-term recurrence, QR and projected
        eigensolve — the reference's ``DOUBLE`` (common.jl:6).
    partial_reorth_cadence:
        Full scrub of the newborn residual against the stored basis every
        this many iterations (reference: 2).
    eig_poll_cadence:
        Poll the projected eigenproblem every this many iterations
        (reference: 4).
    loc_reorth_passes:
        Passes of the local scrub of the newborn residual against its two
        parent blocks (2 == CGS2).
    qr_method:
        "householder" (``torch.linalg.qr``), "cholqr2"/"cholqr3"
        (CholeskyQR with 2/3 passes), or "auto": householder for f64
        compute, cholqr2 otherwise.
    eig_backend:
        "banded_host": LAPACK banded eigensolver (scipy) on the host, the
        reference's dsbev path (common.jl:28-48).  "native" and "device"
        are not ported yet.
    seed:
        Seed of the ``torch.Generator`` that draws the random start block
        and every breakdown re-randomization.
    device:
        Device that holds the operator and the basis when ``rbl`` builds
        the operator from host data (a scipy or numpy matrix).  None means
        the CUDA card, and raises when there is none: a solve on the CPU
        is asked for with ``device="cpu"``.  An operator passed in keeps
        its own device.
    hbm_budget_fraction:
        Fraction of free device memory the Krylov basis may use
        (reference: 0.8 of free VRAM, RBL_gpu.jl:96).
    basis_device_cap_cols:
        Optional cap on device-resident basis columns.  Beyond it the
        store moves the oldest columns to a pinned host panel and streams
        the panels back for every full scrub: the reference's hybrid
        VRAM/pinned-RAM hierarchy (RBL_gpu.jl:59-81,95-104,168-169) with
        bulk compaction instead of per-block streaming.  None (default)
        keeps the whole basis on the device.
    chunk_growth_cap:
        Cap (as a multiple of ``eig_poll_cadence``) on the geometric growth
        of the sweep-chunk length; chunks start at the poll cadence and
        double every second calm chunk.  1 disables growth.
    pipeline_depth:
        Sweep chunks kept in flight ahead of the one whose T blocks the
        host is reading, so the host's read and eig polls overlap the
        device's sweep.  Speculated chunks wasted at convergence or
        breakdown are rewound.
    adaptive_reorth_max:
        Maximum stretch factor on ``partial_reorth_cadence`` while the
        spectrum is calm.  1 (default) keeps the fixed cadence.
    matmul_precision:
        Float32 matmul precision for the whole solve.  "high" and
        "highest" both mean full FP32 on the card (torch's "highest");
        "default" allows TF32 (torch's "high", about three decimal
        digits).  The mode is set for the duration of the solve and
        restored afterwards.  No effect on f64.
    sweep_checkpoint_path / sweep_checkpoint_every:
        Mid-sweep checkpointing of ``rbl``: at every
        ``sweep_checkpoint_every``-th cleanly processed chunk boundary the
        full sweep state (basis prefix, recurrence triple, T band,
        coupling history, reorth-policy flags) is written atomically to
        ``sweep_checkpoint_path``; ``rbl`` resumes from an existing file
        and deletes it when the solve completes.  None disables.  The path
        identifies ONE logical solve: never share it across operators or
        solves.  Internal multi-solve paths (the restarted inner sweeps,
        the filtered solve) strip it.
    fault_inject_abort_after_chunks:
        Raise ``SweepAborted`` after this many processed chunks:
        deterministic preemption for testing checkpoint and resume.
    restart_kryl_dim / restart_growth:
        The restarted variant's initial sweep length (restarted.jl:103)
        and its growth per restart (restarted.jl:142).  The reference's
        deflation cadence (restarted.jl:53) has no field: the port, like
        the JAX package, deflates every step, and ``utils.convert`` drops
        the JAX package's ``restart_reorth_cadence``.
    restart_growth_policy:
        "stall" (default) grows the sweep only after a restart that locked
        nothing, or after two low-yield restarts; "always" restores the
        reference's unconditional growth.
    """

    block_size: int = 4
    max_kryl_dim: int = 1400
    tol: float = 1e-7
    basis_dtype: Any = torch.float64
    compute_dtype: Any = torch.float64
    partial_reorth_cadence: int = 2
    eig_poll_cadence: int = 4
    loc_reorth_passes: int = 2
    qr_method: str = "auto"
    eig_backend: str = "banded_host"
    seed: int = 0
    device: Optional[str] = None
    hbm_budget_fraction: float = 0.8
    basis_device_cap_cols: Optional[int] = None
    chunk_growth_cap: int = 4
    pipeline_depth: int = 2
    adaptive_reorth_max: int = 1
    matmul_precision: str = "high"
    sweep_checkpoint_path: Optional[str] = None
    sweep_checkpoint_every: int = 1
    fault_inject_abort_after_chunks: Optional[int] = None
    restart_kryl_dim: int = 100
    restart_growth: int = 10
    restart_growth_policy: str = "stall"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be ≥ 1, got {self.block_size}")
        if self.tol <= 0:
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.max_kryl_dim < self.block_size:
            raise ValueError(
                f"max_kryl_dim={self.max_kryl_dim} < block_size={self.block_size}"
            )
        for name in ("partial_reorth_cadence", "eig_poll_cadence",
                     "loc_reorth_passes",
                     "chunk_growth_cap", "pipeline_depth",
                     "adaptive_reorth_max", "sweep_checkpoint_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be ≥ 1")
        if self.qr_method not in ("auto", "householder", "cholqr2", "cholqr3"):
            raise ValueError(f"unknown qr_method: {self.qr_method!r}")
        if self.eig_backend not in ("banded_host", "native", "device"):
            raise ValueError(f"unknown eig_backend: {self.eig_backend!r}")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}"
            )
        for name in ("basis_dtype", "compute_dtype"):
            if not isinstance(getattr(self, name), torch.dtype):
                raise TypeError(
                    f"{name} must be a torch.dtype, got {getattr(self, name)!r}"
                )

    def resolved_qr_method(self) -> str:
        if self.qr_method != "auto":
            return self.qr_method
        return "householder" if self.compute_dtype.itemsize >= 8 else "cholqr2"

    def replace(self, **kw) -> "RBLConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.  Entry
    points run on the card unless the caller asks for the CPU, so a
    missing card raises instead of falling back to the host."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device: rbl_tpu_torch runs on the card by default; "
            'pass device="cpu" (or RBLConfig(device="cpu")) to run on the CPU'
        )
    return torch.device("cuda")


# RBLConfig.matmul_precision -> torch's float32 matmul precision.  torch's
# own "high" is TF32 (~3 digits), weaker than the TPU's bf16x3 "high"; the
# port therefore maps both "high" and "highest" to full FP32.
_TORCH_PRECISION = {"default": "high", "high": "highest", "highest": "highest"}


@contextlib.contextmanager
def matmul_precision(mode: str):
    """Set torch's float32 matmul precision for the ``with`` body (``mode``
    is an ``RBLConfig.matmul_precision`` value) and restore it after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[mode])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
