"""The system under test: ``rbl_tpu_torch``, driven as a traffic mix says.

``Program(problem, mix, device)`` builds the operator once and
``solve(seed, timer)`` runs one whole solve through the mix's entry, the
module ``entries/<entry>.py``.  The operator is the one ``as_operator``
builds from the handed scipy matrix (timed by the host clock, ending in a
synchronize), or, for a matrix-free problem, the program's operator class
that the problem names, built on its grid.

A mix holds the shared keys (``entry``, ``k``, ``b``, ``which``,
``format``, ``loop``), the entry's own (its ``KEYS``), and any field of
``RBLConfig`` but the ones the harness sets; any other key is an error, so
that no setting of a mix is silently dropped.  ``overrides`` replaces mix
keys (the control of ``correct`` uses it to switch on a lower precision).
Nothing is imported from the program until a ``Program`` is built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from .spec import load_module

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
SHARED = {"entry", "k", "b", "which", "format", "loop"}
HARNESS_SET = {"block_size", "seed", "device"}   # RBLConfig fields the harness sets


@dataclasses.dataclass
class Solve:
    eigenvalues: np.ndarray
    eigenvectors: Optional[torch.Tensor]
    kryl_dim: int
    converged: bool


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rbl_config(rt, mix: dict, entry, device) -> Any:
    """The ``RBLConfig`` that the mix states."""
    fields = {f.name for f in dataclasses.fields(rt.RBLConfig)} - HARNESS_SET
    unknown = set(mix) - SHARED - set(entry.KEYS) - fields
    if unknown:
        raise ValueError(f"mix keys {sorted(unknown)} are neither shared, the "
                         f"entry's own, nor RBLConfig fields the mix may set")
    cfg = {key: DTYPES[val] if key.endswith("_dtype") else val
           for key, val in mix.items() if key in fields}
    return rt.RBLConfig(block_size=int(mix["b"]), device=str(device), **cfg)


class Program:
    def __init__(self, problem, mix: dict, device, overrides: dict | None = None):
        import rbl_tpu_torch as rt

        self.rt = rt
        self.mix = {**mix, **(overrides or {})}
        self.entry = load_module("entries", self.mix["entry"])
        self.device = torch.device(device)
        self.problem = problem
        self.k, self.b = int(self.mix["k"]), int(self.mix["b"])
        self.cfg = rbl_config(rt, self.mix, self.entry, self.device)
        self.dtype = self.cfg.compute_dtype
        self.setup_parts: dict[str, float] = {}
        if problem.A is None:
            self.op = getattr(rt, problem.operator)(
                *problem.grid, dtype=self.dtype, device=self.device)
        else:
            t0 = time.perf_counter()
            self.op = rt.as_operator(problem.A, dtype=self.dtype, device=self.device,
                                     format=self.mix.get("format", "auto"))
            sync(self.device)
            self.setup_parts["operator_build_s"] = time.perf_counter() - t0

    def solve(self, seed: int, timer=None) -> Solve:
        r = self.entry.solve(self.rt, self.op, self.k,
                             self.cfg.replace(seed=int(seed)), self.mix, timer)
        sync(self.device)
        return Solve(eigenvalues=np.asarray(r.eigenvalues, dtype=np.float64),
                     eigenvectors=r.eigenvectors, kryl_dim=int(r.kryl_dim),
                     converged=bool(r.converged))
