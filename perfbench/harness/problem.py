"""The benchmark's inputs, built by the benchmark itself.

A configuration file names its ``"generator"``: the module
``generators/<generator>.py``, which defines ``build(config) -> Problem``
and is the configuration's plain reference too.  A matrix-free generator
also defines ``apply64(problem, X)``, its product in float64; one whose
spectrum is known in closed form defines ``spectrum(problem)``, every
eigenvalue.  A generator imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import scipy.sparse as sp

from .spec import load_module


@dataclasses.dataclass
class Problem:
    """What the benchmark hands to both the program and the reference."""

    n: int
    nonzeros: int                        # entries a product with the matrix needs
    norm: float                          # the largest absolute row sum
    A: Optional[sp.csr_matrix] = None    # assembled matrix, or None
    grid: Optional[tuple] = None         # the grid of a stencil, where there is one
    operator: Optional[str] = None       # matrix-free: the program's operator class
    generator: Any = None                # the module that built it


def build(config: dict) -> Problem:
    gen = load_module("generators", config["generator"])
    prob = gen.build(config)
    prob.generator = gen
    if "n" in config and int(config["n"]) != prob.n:
        raise ValueError(f"{config['generator']}: n {prob.n} differs from the "
                         f"configuration's {config['n']}")
    return prob
