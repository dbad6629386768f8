"""The plain reference that decides ``correct``.

It imports numpy, scipy and torch only: nothing of the program and nothing
of JAX.  It takes the benchmark's own inputs (the assembled scipy matrix,
or the matrix-free problem with its generator's float64 product) and
works everything out again: the products A·V in float64 (a plain CSR
product or the generator's ``apply64``), the norm bound of A, and the
wanted eigenvalues (the generator's closed-form ``spectrum``, or a frozen
file of a solver independent of the program).  It reads the program's
eigenvalues and eigenvectors only to judge them.

The configuration's ``"truth"`` says where the wanted eigenvalues come
from: ``"analytic"`` (the generator's spectrum), or ``{"file": path}``, a
``.npz`` with an ``eigenvalues`` array, the path relative to this folder.

The numbers it returns for one solve:

- ``eig_err``: max over the k pairs of |λ − λ*| / |λ*|, both sorted;
- ``resid``: max over the k pairs of ‖A·v − λ·v‖ / (‖A‖_G · ‖v‖), with
  ‖A‖_G the largest absolute row sum of A;
- ``orth``: max |VᵀV − I|;
- ``rq_err``: max over the k pairs of |λ − ρ(v)| / |λ|, with ρ(v) the
  Rayleigh quotient vᵀAv / vᵀv of the returned vector.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent


def _pick(w: np.ndarray, k: int, which: str) -> np.ndarray:
    """The k wanted eigenvalues of the spectrum ``w``, ascending."""
    w = np.asarray(w, dtype=np.float64)
    if which == "LM":
        key = -np.abs(w)
    elif which == "LA":
        key = -w
    elif which == "SA":
        key = w
    else:
        raise ValueError(f"which={which!r}")
    return np.sort(w[np.argsort(key, kind="stable")[:k]])


class Reference:
    """The reference side of one cell: ``problem`` is the benchmark's
    ``Problem``; ``truth`` the configuration's ``truth`` entry."""

    def __init__(self, problem, truth, mix: dict, device):
        self.problem = problem
        self.device = torch.device(device)
        self.k = int(mix["k"])
        self.which = mix.get("which", "LM").upper()
        self.truth = self._truth(truth)
        A = problem.A
        self.norm = float(np.abs(A).sum(axis=1).max()) if A is not None else problem.norm
        self._csr = None

    def _truth(self, truth):
        if truth == "analytic":
            w = self.problem.generator.spectrum(self.problem)
        elif isinstance(truth, dict) and "file" in truth:
            w = np.load(_HERE / truth["file"])["eigenvalues"]
        else:
            return None
        if w.size < self.k:
            raise ValueError(f"the truth holds {w.size} < k eigenvalues")
        return _pick(w, self.k, self.which)

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """A·X in float64 on the reference's device."""
        X = X.to(device=self.device, dtype=torch.float64)
        if self.problem.A is None:
            return self.problem.generator.apply64(self.problem, X)
        if self._csr is None:
            A = self.problem.A
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # "beta state"
                self._csr = torch.sparse_csr_tensor(
                    torch.as_tensor(A.indptr.astype(np.int64)),
                    torch.as_tensor(A.indices.astype(np.int64)),
                    torch.as_tensor(A.data, dtype=torch.float64),
                    size=A.shape).to(self.device)
        return self._csr @ X

    def eig_err(self, eigenvalues) -> float | None:
        if self.truth is None:
            return None
        w = np.sort(np.asarray(eigenvalues, dtype=np.float64))
        if w.shape != self.truth.shape or not np.all(np.isfinite(w)):
            return float("inf")
        return float(np.max(np.abs(w - self.truth) / np.abs(self.truth)))

    def vector_numbers(self, eigenvalues, V, block: int = 16) -> dict:
        """``resid``, ``orth`` and ``rq_err`` of one solve's pairs, a block
        of columns at a time."""
        lam = np.asarray(eigenvalues, dtype=np.float64)
        inf = float("inf")
        if V is None or V.shape != (self.problem.n, lam.size):
            return dict(resid=inf, orth=inf, rq_err=inf)
        V64 = V.to(device=self.device, dtype=torch.float64)
        resid = rq = 0.0
        for j in range(0, lam.size, block):
            X = V64[:, j:j + block]
            lt = torch.as_tensor(lam[j:j + block], dtype=torch.float64,
                                 device=self.device)
            AX = self.apply(X)
            xx = torch.sum(X * X, dim=0)
            r = torch.linalg.vector_norm(AX - X * lt[None, :], dim=0) / (
                self.norm * torch.sqrt(xx))
            q = (lt - torch.sum(X * AX, dim=0) / xx).abs() / lt.abs()
            resid = max(resid, float(torch.nan_to_num(r, nan=inf).max()))
            rq = max(rq, float(torch.nan_to_num(q, nan=inf).max()))
        G = V64.T @ V64
        orth = float((G - torch.eye(lam.size, dtype=torch.float64,
                                    device=self.device)).abs().max())
        out = dict(resid=resid, orth=orth, rq_err=rq)
        return {k: (v if np.isfinite(v) else inf) for k, v in out.items()}
