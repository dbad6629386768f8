"""Drive the rest of a run with the timed path broken underneath and see
``correct`` come out false, once for each fault an eigensolve can have:

- a step that returns its state unchanged: the operator's apply hands its
  input back, so every Lanczos step makes no progress;
- half of the block left out, the mean taken over the rest: the apply
  computes the first half of the block's columns and fills the others with
  their mean;
- an answer altered where it is produced: one eigenvalue, or one
  eigenvector, of each solve changed as the entry returns it;
- a solve that the Krylov cap ended reported where the mix states that
  its tolerance ends every solve.

The exchange between chips cannot be left out: every cell runs on one
chip.  The look for a card is skipped (the run goes to the CPU at the
tiny sizes of ``tiny.py``)."""

import time

import pytest
import tiny
import torch

from perfbench.harness import cell_run
from perfbench.harness.program import Program


def _unchanged(X):
    return X.clone()


def _half_block(apply):
    def run(X):
        h = max(X.shape[1] // 2, 1)
        Y = apply(X[:, :h].contiguous())
        rest = Y.mean(dim=1, keepdim=True).expand(-1, X.shape[1] - h)
        return torch.cat([Y, rest], dim=1)
    return run


def _factory(fault):
    class Broken(Program):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if fault == "unchanged":
                self.op.apply = _unchanged
            elif fault == "half_block":
                self.op.apply = _half_block(self.op.apply)

        def solve(self, seed, timer=None):
            out = super().solve(seed, timer)
            if fault == "eigenvalue":
                out.eigenvalues = out.eigenvalues.copy()
                out.eigenvalues[0] *= 1.01
            elif fault == "eigenvector":
                V = out.eigenvectors.clone()
                V[:, -1] = V[:, 0]
                out.eigenvectors = V
            elif fault == "unconverged":
                out.converged = False
            return out
    return Broken


CASES = [(config, mix, fault)
         for config, mix in [("lap64a", "rbl"), ("lap64", "rbl32"), ("lap64", "pol")]
         for fault in ["unchanged", "half_block", "eigenvalue", "eigenvector",
                       "unconverged"]
         # a mix that its cap ends has no convergence to break
         if fault != "unconverged" or tiny.CONVERGED[mix]]


@pytest.mark.parametrize("config,mix,fault", CASES)
def test_fault_makes_the_run_incorrect(config, mix, fault):
    cell = tiny.cell(config, mix)
    try:
        r = cell_run.run(cell, 4242, 0.0, False, "cpu", time.perf_counter(),
                         program_factory=_factory(fault))
    except Exception:
        # a broken program that cannot even finish its warm-up prints no
        # result at all: that run has failed too
        return
    assert r["correct"] is False, r
