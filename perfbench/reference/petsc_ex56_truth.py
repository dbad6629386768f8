"""The frozen top of the spectrum of PETSc's ex56 (``generators/petsc_ex56.py``).

From the root of a checkout:

    python3 -m perfbench.reference.petsc_ex56_truth

writes ``perfbench/reference/petsc_ex56_ne42_top.npz``;
``write(path, ne, per_block)`` writes another size or place and
``check(path)`` computes again and returns the largest relative
difference from the file.

The stiffness commutes with the mirrors in x = ½ and z = ½ (S_x, S_z), so
it splits into four blocks, one for each pair of signs (s_x, s_z) of a
vector under the two mirrors.  The swap of x and z maps the (−, +) block
onto the (+, −) one, so those two have the same spectrum and the matrix
has double eigenvalues, which single-vector ARPACK can miss one copy of.
Inside a block nothing forces a repeat.  So each block's largest
``per_block`` eigenvalues are computed apart, in float64, by scipy's
``eigsh`` (ARPACK) at ``tol`` 1e-14, and merged.  The merge keeps every
eigenvalue at or above the largest of the four blocks' smallest computed
ones: below it a block may hold eigenvalues that were not computed.  The
(−, +) and (+, −) blocks are solved independently and must agree to
1e-10.

The file holds ``eigenvalues`` (descending, every one kept) and, as its
header, ``made_by`` (how), ``ne``, ``n``, ``paired_blocks_max_rel_diff``,
``block_sizes`` and ``block_seconds`` (in the order of ``SIGNS``) and
``seconds`` (the whole, assembly included; whole seconds of numpy's
clock).  Imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh

from perfbench.generators import petsc_ex56

TOL = 1e-14
SIGNS = ((1, 1), (-1, 1), (1, -1), (-1, -1))
PAIRED = 1e-10            # the (−, +) and (+, −) blocks agree to this
WANTED = 100              # the cells' largest k
DEFAULT = Path(__file__).resolve().parent / "petsc_ex56_ne42_top.npz"


def _now():
    return np.datetime64("now")


def _seconds(t0) -> float:
    return float((_now() - t0) / np.timedelta64(1, "s"))


def block_basis(Sx, Sz, sx: int, sz: int) -> sp.csr_matrix:
    """Orthonormal columns spanning {v : S_x v = s_x v, S_z v = s_z v}:
    the projection (I + s_x S_x)(I + s_z S_z) of one unit vector of each
    orbit of the two mirrors, normalized; those it annihilates left out."""
    n = Sx.shape[0]
    eye = sp.identity(n, format="csr")
    P = ((eye + sx * Sx) @ (eye + sz * Sz)).tocsc()
    P.eliminate_zeros()
    px, pz = Sx.tocsc().indices, Sz.tocsc().indices   # the image of each dof
    d = np.arange(n)
    first = d[d == np.minimum.reduce([d, px, pz, px[pz]])]
    Q = P[:, first]
    norms = np.sqrt(np.asarray(Q.multiply(Q).sum(axis=0))).ravel()
    live = norms > 0
    return (Q[:, live] @ sp.diags(1.0 / norms[live])).tocsr()


def solve_blocks(A, ne: int, per_block: int, log=print) -> dict:
    """Each block's largest ``per_block`` eigenvalues, its size and seconds."""
    S = petsc_ex56.mirrors(ne)
    out = {}
    for sx, sz in SIGNS:
        t0 = _now()
        Q = block_basis(S["x"], S["z"], sx, sz)
        B = (Q.T @ A @ Q).tocsr()
        B = (B + B.T) / 2.0
        k = min(per_block, B.shape[0] - 2)
        if k < B.shape[0] // 4:
            v0 = np.random.default_rng(1234).standard_normal(B.shape[0])
            w = eigsh(B, k=k, which="LA", tol=TOL, v0=v0,
                      ncv=min(B.shape[0] - 1, max(3 * k, 2 * k + 40)),
                      return_eigenvectors=False)
        else:  # a small block: all of it
            w = np.linalg.eigvalsh(B.toarray())[-k:]
        out[(sx, sz)] = dict(values=np.sort(w)[::-1], size=B.shape[0],
                             seconds=_seconds(t0))
        log(f"block ({sx:+d}, {sz:+d}): size {B.shape[0]}, top {k} in "
            f"{out[(sx, sz)]['seconds']:.0f} s")
    return out


def merge(blocks: dict) -> tuple[np.ndarray, float]:
    """The eigenvalues every block has computed down to, descending, and
    the relative disagreement of the two paired blocks."""
    floor = max(b["values"].min() for b in blocks.values())
    every = np.concatenate([b["values"] for b in blocks.values()])
    kept = np.sort(every[every >= floor])[::-1]
    a, b = blocks[(-1, 1)]["values"], blocks[(1, -1)]["values"]
    pair = float(np.max(np.abs(a - b) / np.abs(a)))
    return kept, pair


def truth(ne: int = 42, per_block: int = 60, log=print) -> dict:
    """The kept eigenvalues and the header, as the file holds them."""
    t0 = _now()
    A = petsc_ex56.assemble(ne)
    log(f"ex56 -ne {ne}: n {A.shape[0]}, {A.nnz} stored entries")
    blocks = solve_blocks(A, ne, per_block, log)
    kept, pair = merge(blocks)
    if pair > PAIRED:
        raise ValueError(f"the paired blocks disagree by {pair:.3g}")
    if kept.size < WANTED:
        raise ValueError(f"only {kept.size} eigenvalues certified: raise per_block")
    return dict(
        eigenvalues=kept,
        made_by=("scipy.sparse.linalg.eigsh (ARPACK), float64, which LA, tol "
                 f"{TOL:g}, the largest {per_block} of each of the four blocks of "
                 "the mirrors x = 1/2 and z = 1/2 apart, merged down to the largest "
                 "of the blocks' smallest computed eigenvalues"),
        ne=ne, n=A.shape[0], paired_blocks_max_rel_diff=pair,
        block_sizes=np.array([blocks[s]["size"] for s in SIGNS]),
        block_seconds=np.array([blocks[s]["seconds"] for s in SIGNS]),
        seconds=_seconds(t0))


def write(path=DEFAULT, ne: int = 42, per_block: int = 60) -> dict:
    out = truth(ne, per_block)
    np.savez(path, **out)
    print(f"wrote {out['eigenvalues'].size} eigenvalues to {path} in "
          f"{out['seconds']:.0f} s (paired blocks apart by "
          f"{out['paired_blocks_max_rel_diff']:.3g})")
    return out


def check(path=DEFAULT, per_block: int = 60) -> float:
    """The largest relative difference between the file's eigenvalues and
    the same computed again."""
    with np.load(path) as f:
        old, ne = f["eigenvalues"], int(f["ne"])
    new = truth(ne, per_block)["eigenvalues"]
    m = min(old.size, new.size)
    diff = float(np.max(np.abs(old[:m] - new[:m]) / np.abs(new[:m])))
    print(f"{path}: {m} eigenvalues compared, largest relative difference {diff:.3g}")
    return diff


if __name__ == "__main__":
    write()
