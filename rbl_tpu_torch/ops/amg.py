"""Smoothed-aggregation algebraic multigrid for ASSEMBLED sparse SPD
matrices (port of ``rbl_tpu/ops/amg.py``) — the preconditioner tier for the
FEM vibration problem K·x = λ·M·x.

The structured-stencil tiers (ops/fdm.py exact solves, ops/multigrid.py
separable V-cycles) do not apply to assembled matrices (SuiteSparse
ldoor/hood class; in this repo ``utils.fem.fem_elasticity_3d``), and scalar
Jacobi does almost nothing for elasticity.  This module closes that gap
without ever factorizing A.

Construction (host, scipy — one-time, O(nnz)), as in the JAX package:

1. **Block compression**: nodes of ``dof`` unknowns (elasticity: 3); the
   strength graph uses Frobenius norms of the dof×dof coupling blocks,
   normalized by the diagonal blocks.
2. **Greedy aggregation** (Vanek-style): each aggregate is a seed node plus
   its strong neighbors.
3. **Tentative prolongator**: the near-nullspace restricted to each
   aggregate, orthonormalized per aggregate (translations by default; pass
   ``near_nullspace=rigid_body_modes(coords)`` for the full 6-mode
   elasticity kernel).
4. **Prolongator smoothing**: P = (I − ω D⁻¹A) P_tent with
   ω = 4/(3·λ̂max(D⁻¹A)).
5. **Galerkin RAP** per level until the coarsest fits a dense inverse.

Apply (device): a symmetric V(ν,ν) cycle — damped BLOCK-Jacobi smoothing
(the dof×dof block inverses as one batched product), level operators
through the ``as_operator`` router (on the card: the packed-BSR CUDA
kernel or DIA, whichever its models pick), transfers as a batched
aggregate contraction (``_AggTransfer``), per-axis dense products
(``_GridTransfer``) or ``RectCooOperator`` (``_CooTransfer``), dense
coarsest solve.  Equal pre/post smoothing and R = Pᵀ make the cycle SPD —
the PMINRES requirement.

Dtypes follow the JAX package: the block inverses and the aggregate
factors are held at the build dtype, the grid factors and the coarsest
inverse in f64 on the host, and all are cast to the block's dtype at apply;
so a hierarchy built at f32 and handed an f64 block runs the cycle in f64
arithmetic with f32-rounded smoother and aggregate constants and returns
f64 (each level operator applies by its own rule: the packed-BSR kernel
computes at its tiles' dtype).

Under a row mesh (``mesh=``, ``parallel/mesh.py``) level 0 lives on the
rank's band: its operator is the solve's sharded K (``op0``; the packed
kernel on the band with its ghost exchange), its smoother holds the rank's
node blocks only, and its transfer pair is the rank's rows of the assembled
prolongator P as a ``RectCooOperator`` (``_MeshTransfer``: prolong needs no
communication, restrict ends in one all-reduce of the (n₁, b) coarse
residual).  Levels ≥ 1 and the coarsest dense inverse are replicated on
every rank.  So a cycle is the JAX package's on the global block (which
GSPMD shards) with one all-reduce a cycle, and takes and returns the
rank's rows.

Used by the shift-invert operators via their ``psolve`` hook
(ops/minres.py, ops/generalized.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device

__all__ = [
    "AssembledMultigrid",
    "detect_dof_blocks",
    "rigid_body_modes",
    "block_jacobi_psolve",
]


# ---------------------------------------------------------------------------
# host-side building blocks
# ---------------------------------------------------------------------------


def detect_dof_blocks(A: sp.spmatrix, candidates=(3, 2, 6)) -> int:
    """Detect a nodal block size from the sparsity pattern: ``d`` wins if
    rows d·t … d·t+d−1 reference the same column-node set (sampled).
    Returns 1 when nothing matches."""
    A = A.tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    for d in candidates:
        if n % d:
            continue
        nodes = rng.integers(0, n // d, size=min(64, n // d))
        ok = True
        for t in nodes:
            sets = [
                np.unique(A.indices[A.indptr[d * t + r]:
                                    A.indptr[d * t + r + 1]] // d)
                for r in range(d)
            ]
            if any(len(s) != len(sets[0]) or np.any(s != sets[0])
                   for s in sets[1:]):
                ok = False
                break
        if ok:
            return d
    return 1


def rigid_body_modes(coords: np.ndarray, dof: int = 3) -> np.ndarray:
    """Near-nullspace for elasticity: 3 translations + 3 rotations from
    node coordinates (n_nodes, 3) → (n_nodes·dof, 6).  For dof=2:
    2 translations + 1 rotation."""
    coords = np.asarray(coords, dtype=np.float64)
    nn = coords.shape[0]
    if dof == 3:
        B = np.zeros((nn, 3, 6))
        B[:, 0, 0] = B[:, 1, 1] = B[:, 2, 2] = 1.0
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        # rotations about z, x, y
        B[:, 0, 3], B[:, 1, 3] = -y, x
        B[:, 1, 4], B[:, 2, 4] = -z, y
        B[:, 2, 5], B[:, 0, 5] = -x, z
        return B.reshape(nn * 3, 6)
    if dof == 2:
        B = np.zeros((nn, 2, 3))
        B[:, 0, 0] = B[:, 1, 1] = 1.0
        B[:, 0, 2], B[:, 1, 2] = -coords[:, 1], coords[:, 0]
        return B.reshape(nn * 2, 3)
    raise ValueError(f"dof={dof} not supported (2 or 3)")


def _node_strength_graph(A: sp.csr_matrix, dof: int) -> sp.csr_matrix:
    """Frobenius norms of the dof×dof coupling blocks, diagonally
    normalized: s_ij = ‖A_ij‖_F / √(‖A_ii‖_F ‖A_jj‖_F)."""
    C = A.tocoo()
    ni, nj = C.row // dof, C.col // dof
    nn = A.shape[0] // dof
    W = sp.coo_matrix((C.data ** 2, (ni, nj)), shape=(nn, nn)).tocsr()
    W.data = np.sqrt(W.data)
    d = np.sqrt(W.diagonal())
    d[d == 0] = 1.0
    Dinv = sp.diags(1.0 / d)
    S = (Dinv @ W @ Dinv).tocsr()
    S.setdiag(0.0)
    S.eliminate_zeros()
    return S


def _aggregate(S: sp.csr_matrix, theta: float) -> np.ndarray:
    """Vanek greedy aggregation on the strength graph.  Returns agg id per
    node (every node assigned)."""
    nn = S.shape[0]
    agg = np.full(nn, -1, dtype=np.int64)
    indptr, indices, data = S.indptr, S.indices, S.data
    # pass 1: seed aggregates from fully-unaggregated strong neighborhoods
    na = 0
    for i in range(nn):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl][data[sl] >= theta]
        if np.all(agg[nbr] == -1):
            agg[i] = na
            agg[nbr] = na
            na += 1
    # pass 2: attach leftovers to the strongest neighboring aggregate
    for i in range(nn):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr, w = indices[sl], data[sl]
        cand = agg[nbr] != -1
        if np.any(cand):
            agg[i] = agg[nbr[cand][np.argmax(w[cand])]]
        else:
            agg[i] = na  # isolated node: its own aggregate
            na += 1
    return agg


def _tentative_prolongator(agg: np.ndarray, B: np.ndarray, dof: int):
    """Per-aggregate orthonormalization of the near-nullspace: returns
    (P_tent sparse (n × na·nb), B_coarse (na·nb, nb), agg_meta) —
    ``agg_meta = (Qpad, perm_padded, posinv)`` is the PERMUTED-AGGREGATE
    device layout of P_tent: fine dofs grouped by aggregate and padded to
    the max aggregate size, so the device apply is ONE row gather plus a
    batched (na, s_max, nb) contraction instead of nnz-scale COO
    scatter-adds (see _AggTransfer)."""
    nn = agg.shape[0]
    n = nn * dof
    na = int(agg.max()) + 1
    nb = B.shape[1]
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(na + 1))
    Bc = np.zeros((na * nb, nb))
    s_max = int((np.diff(bounds)).max()) * dof
    Qpad = np.zeros((na, s_max, nb))
    perm_padded = np.full(na * s_max, n, dtype=np.int32)  # n → zero row
    posinv = np.zeros(n, dtype=np.int32)
    rlist, clist, vlist = [], [], []
    for a in range(na):
        nodes = order[bounds[a]:bounds[a + 1]]
        dofs = (nodes[:, None] * dof + np.arange(dof)).ravel()
        m = dofs.shape[0]
        Q, Rf = np.linalg.qr(B[dofs])  # (m, k), (k, nb); k = min(m, nb)
        if Q.shape[1] < nb:  # tiny aggregate: pad (coarse cols stay 0)
            Q = np.pad(Q, ((0, 0), (0, nb - Q.shape[1])))
            Rf = np.pad(Rf, ((0, nb - Rf.shape[0]), (0, 0)))
        rlist.append(np.repeat(dofs, nb))
        clist.append(np.tile(a * nb + np.arange(nb), m))
        vlist.append(Q.ravel())
        Bc[a * nb : (a + 1) * nb] = Rf
        Qpad[a, :m] = Q
        perm_padded[a * s_max : a * s_max + m] = dofs
        posinv[dofs] = a * s_max + np.arange(m)
    rows = np.concatenate(rlist)
    cols = np.concatenate(clist)
    vals = np.concatenate(vlist)
    P = sp.coo_matrix((vals, (rows, cols)), shape=(n, na * nb)).tocsr()
    return P, Bc, (Qpad, perm_padded, posinv)


def _lambda_max_dinv_a(A: sp.csr_matrix, it: int = 12) -> float:
    """Power estimate of λmax(D⁻¹A) (scalar diagonal)."""
    d = A.diagonal().copy()
    d[d == 0] = 1.0
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(it):
        x = (A @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam, x = nrm, x / nrm
    return float(lam)


def _block_diag_inv(A: sp.csr_matrix, dof: int, omega: float) -> np.ndarray:
    """ω · (block diag of A)⁻¹ as (n_nodes, dof, dof)."""
    nn = A.shape[0] // dof
    C = A.tocoo()
    mask = (C.row // dof) == (C.col // dof)
    r, c, v = C.row[mask], C.col[mask], C.data[mask]
    D = np.zeros((nn, dof, dof))
    D[r // dof, r % dof, c % dof] = v
    # regularize empty/singular blocks
    for i in range(dof):
        zero = D[:, i, i] == 0
        D[zero, i, i] = 1.0
    return omega * np.linalg.inv(D)


def _block_apply(Winv: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[node] = Winv[node] @ X[node rows] for (n_nodes, dof, dof) blocks,
    with the constants cast to the block's dtype."""
    nn, dof, _ = Winv.shape
    Y = torch.matmul(Winv.to(X.dtype), X.reshape(nn, dof, -1))
    return Y.reshape(X.shape)


def block_jacobi_psolve(A: sp.spmatrix, dof: Optional[int] = None,
                        dtype=torch.float64, device=None):
    """Plain damped block-Jacobi psolve (the sub-AMG tier): SPD for SPD A.
    ``dof`` defaults to pattern detection; the block inverses live on
    ``device`` (default: the CUDA card)."""
    A = sp.csr_matrix(A)
    if dof is None:
        dof = detect_dof_blocks(A)
    Winv = torch.as_tensor(_block_diag_inv(A, dof, 1.0), dtype=dtype,
                           device=resolve_device(device))

    def psolve(X):
        return _block_apply(Winv, X)

    return psolve


# ---------------------------------------------------------------------------
# the multigrid hierarchy
# ---------------------------------------------------------------------------


class _AMGLevel:
    """One level: its operator (``as_operator``'s route), the damped block
    inverses of its smoother, and what a report needs (n, nnz, route)."""

    def __init__(self, A: sp.csr_matrix, dof: int, omega: float, dtype,
                 device, op=None, Winv=None):
        from .spmm.operator import as_operator

        self.n = A.shape[0] if A is not None else op.n
        self.nnz = int(A.nnz) if A is not None else None
        self.dof = dof
        self.op = op if op is not None else as_operator(
            A, dtype=dtype, device=device)
        if Winv is None:
            Winv = _block_diag_inv(A, dof, omega)
        self.Winv = torch.as_tensor(np.array(Winv), dtype=dtype, device=device)

    @property
    def route(self) -> str:
        return type(self.op).__name__

    def smooth_apply(self, X):
        return _block_apply(self.Winv, X)


class _CooTransfer:
    """Generic sparse transfer pair via RectCooOperator — the portable
    fallback (nnz-scale scatter-adds)."""

    def __init__(self, P: sp.csr_matrix, dtype, device):
        from .spmm.coo import RectCooOperator

        self.P = RectCooOperator.from_scipy(P, dtype=dtype, device=device)
        self.R = self.P.transpose()

    def prolong(self, C):
        return self.P.apply(C)

    def restrict(self, F):
        return self.R.apply(F)


class _MeshTransfer(_CooTransfer):
    """Level 0's transfer pair under a row mesh: the rank's rows of the
    assembled prolongator P (n, n₁).  Prolong maps the replicated coarse
    block to the rank's rows with no communication; restrict sums each
    rank's Pᵀ·F over the mesh, one all-reduce of the (n₁, b) coarse
    block."""

    def __init__(self, P: sp.csr_matrix, mesh, dtype, device):
        lo, hi = mesh.row_range(P.shape[0])
        super().__init__(sp.csr_matrix(P)[lo:hi], dtype, device)
        self.mesh = mesh

    def restrict(self, F):
        return self.mesh.all_reduce_sum(self.R.apply(F))


class _AggTransfer:
    """Smoothed-aggregation transfer pair in the PERMUTED-AGGREGATE layout:
    P = (I − ω D⁻¹A) P_t applied as the tentative aggregate contraction
    (one (n, b) row gather + one batched (na, s_max, nb) product — fine
    dofs pre-sorted by aggregate and padded to the max aggregate size)
    followed by one LEVEL-OPERATOR apply for the smoothing term."""

    def __init__(self, agg_meta, level_op, dinv: np.ndarray, w: float,
                 nc: int, dtype, device):
        Qpad, perm_padded, posinv = agg_meta
        self.Qpad = torch.as_tensor(np.array(Qpad), dtype=dtype,
                                    device=device)
        # (na*s_max,) → [0..n]; index n is the appended zero row
        self.perm = torch.as_tensor(np.array(perm_padded), dtype=torch.int64,
                                    device=device)
        self.posinv = torch.as_tensor(np.array(posinv), dtype=torch.int64,
                                      device=device)  # (n,) → padded slot
        self.op = level_op
        self.dinv = torch.as_tensor(np.array(dinv), dtype=dtype,
                                    device=device)
        self.w = float(w)
        self.nc = int(nc)

    def _pt(self, C):
        na, s_max, nb = self.Qpad.shape
        Ypad = torch.matmul(self.Qpad.to(C.dtype), C.reshape(na, nb, -1))
        return Ypad.reshape(na * s_max, -1).index_select(0, self.posinv)

    def _pt_T(self, F):
        na, s_max, nb = self.Qpad.shape
        Fz = torch.cat([F, torch.zeros_like(F[:1])], dim=0)
        Xpad = Fz.index_select(0, self.perm).reshape(na, s_max, -1)
        return torch.matmul(self.Qpad.to(F.dtype).transpose(1, 2),
                            Xpad).reshape(self.nc, -1)

    def prolong(self, C):
        y = self._pt(C)
        return y - self.w * self.dinv.to(y.dtype)[:, None] * self.op.apply(y)

    def restrict(self, F):
        t = F - self.w * self.op.apply(self.dinv.to(F.dtype)[:, None] * F)
        return self._pt_T(t)


class _GridTransfer:
    """Separable per-axis transfer on a node grid: dense (m_f, m_c) factor
    products over each grid axis (no gathers).  The last array axis keeps
    dof·b folded."""

    def __init__(self, fine_dims, coarse_dims, P1s, dof):
        self.fine_dims = tuple(int(d) for d in fine_dims)
        self.coarse_dims = tuple(int(d) for d in coarse_dims)
        self.P1s = [np.asarray(P, dtype=np.float64) for P in P1s]
        self.dof = int(dof)
        self._cache = {}

    def _factors(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._cache:
            self._cache[key] = [torch.as_tensor(P, dtype=dtype, device=device)
                                for P in self.P1s]
        return self._cache[key]

    def _axes(self, X, dims, transpose: bool):
        b = X.shape[1]
        G = X.reshape(dims + (self.dof * b,))
        for a, P in enumerate(self._factors(X.dtype, X.device)):
            M = P.T if transpose else P
            G = torch.movedim(torch.tensordot(M, G, dims=([1], [a])), 0, a)
        return G.reshape(-1, b)

    def prolong(self, C):
        return self._axes(C, self.coarse_dims, transpose=False)

    def restrict(self, F):
        return self._axes(F, self.fine_dims, transpose=True)


def _grid_prolongator(P1s, dof: int) -> sp.csr_matrix:
    """The assembled node-grid prolongator: the Kronecker product of the
    three per-axis factors, each node's ``dof`` unknowns carried
    alike."""
    Pn = sp.kron(sp.kron(sp.csr_matrix(P1s[0]), sp.csr_matrix(P1s[1])),
                 sp.csr_matrix(P1s[2]))
    return sp.kron(Pn, sp.identity(dof, format="csr")).tocsr()


def _grid_prolong_1d(m: int) -> np.ndarray:
    """Node-grid coarsening keeping every other node (works for any m):
    coarse t ↔ fine 2t; odd fine nodes average their coarse neighbors (or
    inject when the right neighbor falls off the grid)."""
    mc = (m + 1) // 2
    P = np.zeros((m, mc))
    for t in range(mc):
        P[2 * t, t] = 1.0
    for f in range(1, m, 2):
        t = f // 2
        if t + 1 < mc:
            P[f, t] = P[f, t + 1] = 0.5
        else:
            P[f, t] = 1.0
    return P


def _hierarchy_device(device, mesh):
    """Where the levels live: the mesh's device under a mesh, else
    ``device`` (None: the CUDA card)."""
    return resolve_device(mesh.device if mesh is not None else device)


def _mesh_node_rows(mesh, n: int, dof: int) -> tuple[int, int]:
    """The rank's rows [lo, hi) of an n-row level 0 on ``mesh``; raises
    unless every rank's n/size rows hold whole nodes of ``dof`` unknowns
    (a node split by a band edge would couple two ranks' smoothers)."""
    if n % mesh.size or (n // mesh.size) % dof:
        raise ValueError(
            f"n={n} over {mesh.size} ranks: a rank's band of n/size rows "
            f"must hold whole nodes of dof={dof} unknowns (n divisible by "
            f"{mesh.size * dof})"
        )
    return mesh.row_range(n)


def _mesh_level0(A: sp.csr_matrix, dof: int, omega: float, dtype, mesh,
                 op0) -> _AMGLevel:
    """Level 0 of a hierarchy on ``mesh``: the sharded operator ``op0``
    (built from A when None) and the damped inverses of the rank's own
    node blocks."""
    from ..parallel.dist_spmm import (
        ShardedBlockSparseOperator,
        ShardedCooSpMM,
        op_mesh,
    )

    n = A.shape[0]
    lo, hi = _mesh_node_rows(mesh, n, dof)
    if op0 is None:
        if n % (mesh.size * 128) == 0:
            op0 = ShardedBlockSparseOperator.from_scipy(A, mesh, dtype=dtype)
        else:
            op0 = ShardedCooSpMM.from_scipy(A, mesh, dtype=dtype)
    else:
        own = op_mesh(op0)
        if op0.n != n or own is None or own.size != mesh.size:
            raise ValueError(
                f"op0 must be the level-0 matrix (n={n}) sharded over the "
                f"mesh's {mesh.size} ranks"
            )
    Winv = _block_diag_inv(A, dof, omega)[lo // dof : hi // dof]
    return _AMGLevel(A, dof, omega, dtype, mesh.device, op=op0, Winv=Winv)


class AssembledMultigrid:
    """Multigrid V-cycle for an assembled sparse SPD matrix.  See module
    docstring; construct via :meth:`smoothed_aggregation` (algebraic, any
    SPD matrix) or :meth:`from_grid` (grid-structured meshes — fast
    separable transfers), apply via :meth:`psolve` (SPD — usable as the
    ``psolve`` hook of the shift-invert operators and ``block_minres``).
    The set-up runs on the host; the levels live on ``device`` (default:
    the CUDA card).

    ``mesh`` (a ``parallel.mesh.RowMesh``, or None): the hierarchy of a
    row-sharded solve, whose :meth:`psolve` takes and returns the rank's
    rows (see the module docstring).  The shift-invert operators read it
    to tell this cycle from one that takes whole blocks."""

    def __init__(self, levels, transfers, coarse_inv, nu, dtype, device=None,
                 mesh=None):
        self.levels = levels            # list[_AMGLevel]
        self.transfers = transfers      # list[_AggTransfer|_GridTransfer|...]
        self.coarse_inv = np.asarray(coarse_inv)  # host (nc, nc)
        self.nu = int(nu)
        self.dtype = dtype
        self.mesh = mesh
        self.device = _hierarchy_device(device, mesh)
        self._ci = {}

    @classmethod
    def smoothed_aggregation(
        cls,
        A,
        dof: Optional[int] = None,
        near_nullspace: Optional[np.ndarray] = None,
        theta: float = 0.05,
        nu: int = 1,
        omega: float = 0.6,
        coarsest_n: int = 1500,
        max_levels: int = 12,
        dtype=torch.float64,
        device=None,
        mesh=None,
        op0=None,
    ) -> "AssembledMultigrid":
        """Build the hierarchy from a scipy sparse SPD matrix.

        dof: unknowns per node (default: pattern detection).
        near_nullspace: (n, nb) modes the coarse spaces must represent
            exactly (default: per-dof translations; pass
            ``rigid_body_modes(coords)`` for elasticity with rotations).
        theta: strength threshold on the normalized block graph.
        omega: block-Jacobi smoother damping.
        mesh: a ``RowMesh``: build the hierarchy of a row-sharded solve
            (level 0 on the rank's band, on the mesh's device; the levels
            below replicated).  Every rank calls this with the whole A.
        op0: under ``mesh``, A sharded over it (the solve's own operator,
            so that A is not packed twice); default: a
            ``ShardedBlockSparseOperator`` of A when n divides into
            128-row blocks on every rank, else a ``ShardedCooSpMM``.
        """
        dev = _hierarchy_device(device, mesh)
        A = sp.csr_matrix(A).astype(np.float64)
        if dof is None:
            dof = detect_dof_blocks(A)
        if near_nullspace is None:
            B = np.zeros((A.shape[0], dof))
            for c in range(dof):
                B[c::dof, c] = 1.0
        else:
            B = np.asarray(near_nullspace, dtype=np.float64)
        levels = []
        transfers = []
        Al, Bl, dofl = A, B, dof
        for _ in range(max_levels):
            if Al.shape[0] <= coarsest_n:
                break
            sharded = mesh is not None and not levels
            levels.append(
                _mesh_level0(Al, dofl, omega, dtype, mesh, op0) if sharded
                else _AMGLevel(Al, dofl, omega, dtype, dev))
            S = _node_strength_graph(Al, dofl)
            agg = _aggregate(S, theta)
            Pt, Bc, agg_meta = _tentative_prolongator(agg, Bl, dofl)
            # prolongator smoothing: P = (I − ω_P D⁻¹A) P_tent
            lam = _lambda_max_dinv_a(Al)
            w_p = 4.0 / (3.0 * lam)
            d = Al.diagonal().copy()
            d[d == 0] = 1.0
            Dinv = sp.diags(1.0 / d)
            P = (Pt - w_p * (Dinv @ (Al @ Pt))).tocsr()
            transfers.append(
                _MeshTransfer(P, mesh, dtype, dev) if sharded
                else _AggTransfer(agg_meta, levels[-1].op, 1.0 / d, w_p,
                                  Pt.shape[1], dtype, dev))
            Al = (P.T @ Al @ P).tocsr()
            Al.sum_duplicates()
            Bl, dofl = Bc, B.shape[1]  # coarse "nodes" carry nb dofs
        # pinv: a rank-deficient tentative space (tiny aggregates padded
        # with zero columns) can leave null coarse directions; the cycle
        # stays PD through the smoother term
        coarse_inv = np.linalg.pinv(Al.toarray())
        return cls(levels, transfers, coarse_inv, nu, dtype, dev, mesh)

    @classmethod
    def from_grid(
        cls,
        A,
        node_dims,
        dof: int = 3,
        nu: int = 1,
        omega: float = 0.6,
        coarsest_n: int = 1500,
        max_levels: int = 12,
        dtype=torch.float64,
        device=None,
        mesh=None,
        op0=None,
    ) -> "AssembledMultigrid":
        """Geometric hierarchy for a matrix assembled on a regular node grid
        (the FEM benchmark class — ``utils.fem.fem_elasticity_3d`` after
        clamping is a full box of nodes).

        node_dims: (d0, d1, d2) node counts with node id =
            (k0·d1 + k1)·d2 + k2 (the assembler's ordering: last axis
            fastest).
        Transfers are per-axis linear interpolation (dense axis products on
        the device, no gathers); level operators are assembled Galerkin RAP
        (scipy, at construction), applied through the sparse-operator
        router.  Trilinear P reproduces linear fields, so all 6 elasticity
        rigid-body modes transfer exactly — no near-nullspace input
        needed.  ``mesh`` and ``op0`` as in :meth:`smoothed_aggregation`:
        under a mesh level 0's transfer is the Kronecker P's rows of the
        rank."""
        dev = _hierarchy_device(device, mesh)
        A = sp.csr_matrix(A).astype(np.float64)
        dims = tuple(int(x) for x in node_dims)
        if int(np.prod(dims)) * dof != A.shape[0]:
            raise ValueError(
                f"node_dims {dims} x dof {dof} != n {A.shape[0]}"
            )
        levels = []
        transfers = []
        Al, dl = A, dims
        for _ in range(max_levels):
            if Al.shape[0] <= coarsest_n or min(dl) < 3:
                break
            sharded = mesh is not None and not levels
            levels.append(
                _mesh_level0(Al, dof, omega, dtype, mesh, op0) if sharded
                else _AMGLevel(Al, dof, omega, dtype, dev))
            P1s = [_grid_prolong_1d(m) for m in dl]
            cdl = tuple(P.shape[1] for P in P1s)
            P = _grid_prolongator(P1s, dof)
            transfers.append(_MeshTransfer(P, mesh, dtype, dev) if sharded
                             else _GridTransfer(dl, cdl, P1s, dof))
            Al = (P.T @ Al @ P).tocsr()
            Al.sum_duplicates()
            dl = cdl
        coarse_inv = np.linalg.pinv(Al.toarray())
        return cls(levels, transfers, coarse_inv, nu, dtype, dev, mesh)

    # -- device apply -------------------------------------------------

    def _vcycle(self, lvl: int, R):
        if lvl == len(self.levels):
            if R.dtype not in self._ci:
                self._ci[R.dtype] = torch.as_tensor(
                    self.coarse_inv, dtype=R.dtype, device=self.device)
            return self._ci[R.dtype] @ R
        level = self.levels[lvl]
        E = level.smooth_apply(R)
        for _ in range(self.nu - 1):
            E = E + level.smooth_apply(R - level.op.apply(E))
        resid = R - level.op.apply(E)
        rc = self.transfers[lvl].restrict(resid)
        Ec = self._vcycle(lvl + 1, rc)
        E = E + self.transfers[lvl].prolong(Ec)
        for _ in range(self.nu):
            E = E + level.smooth_apply(R - level.op.apply(E))
        return E

    def psolve(self, X):
        """One symmetric V-cycle ≈ A⁻¹ on an (n, b) block (SPD); under
        ``mesh`` on the rank's rows of it."""
        if self.mesh is None:
            return self._vcycle(0, X)
        n = self.levels[0].n if self.levels else self.coarse_inv.shape[0]
        if X.shape[0] != self.mesh.local_rows(n):
            raise ValueError(
                f"a hierarchy built on a row mesh cycles the rank's "
                f"{self.mesh.local_rows(n)} rows of n={n}, got a block of "
                f"{X.shape[0]} rows (solve on the same mesh: cfg.mesh or a "
                "sharded operator)")
        if not self.levels:
            # no level 0 on the band: the dense inverse takes the whole
            lo, hi = self.mesh.row_range(n)
            return self._vcycle(0, self.mesh.gather_rows(X, n))[lo:hi]
        return self._vcycle(0, X)

    def report(self) -> str:
        """Each level's n, nonzeros and operator route, then the coarsest
        dense inverse's size."""
        parts = [f"level {i}: n={lv.n} nnz={lv.nnz} route={lv.route}"
                 for i, lv in enumerate(self.levels)]
        parts.append(f"coarsest: dense {self.coarse_inv.shape[0]}²")
        return "; ".join(parts)
