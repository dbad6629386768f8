"""The 5-point stencil of ``Laplacian2D`` and the product filter's step on
it (``ops/spmm/stencil.py``, the kernel K3 of ``csrc/stencil.cu``).

On the CPU the plain versions: ``filter_step`` against the scaled apply and
its column sums, the fused ``ChebyshevProductFilter`` against the generic
loop and the filter's scalar oracle, the counter of fused steps, K3's
launch plan, and the launcher refusing what it does not take.  On the card
(marker ``gpu``) K3 against the plain versions at the benchmark's shapes
and a polished solve through it.  No JAX: on the card machine

    python -m pytest --noconftest -q tests/test_torch_stencil.py
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rbl_tpu_torch as rtt
from rbl_tpu_torch.ops import chebyshev
from rbl_tpu_torch.ops.spmm import _kernels, stencil
from rbl_tpu_torch.ops.spmm.operator import LinearOperator
from rbl_tpu_torch.utils.profiling import Timer

CPU = torch.device("cpu")
BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
EPS = {BF16: 2.0 ** -8, F32: 2.0 ** -24, F64: 2.0 ** -53}


@dataclasses.dataclass
class _Apply(LinearOperator):
    """An operator with its base's ``apply`` alone and LinearOperator's
    plain ``filter_step``."""

    base: LinearOperator

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def apply(self, X):
        return self.base.apply(X)


@dataclasses.dataclass
class _PlainStencil(LinearOperator):
    """The stencil's plain apply with LinearOperator's plain filter step:
    the plain version K3 is held to."""

    nx: int
    ny: int

    def apply(self, X):
        return stencil._plain_apply(X, self.nx, self.ny)


def _plain_step(Y, nx, ny, r, sumsq_in):
    return _PlainStencil(nx, ny).filter_step(Y, r, sumsq_in)[0]


def _strided(n, b, dtype, seed, pad=3, device=CPU):
    """An (n, b) block whose rows lie ``pad`` elements apart beyond b (a
    column-prefix view of a wider buffer), one column zero."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn((n, b + pad), generator=g, dtype=F64).to(dtype).to(device)
    Y = buf[:, :b]
    if b > 1:
        Y[:, b // 2] = 0
    return Y


def _scale(Y, nx, ny, r, s):
    """The size a step's rounding is measured against: (|A|·|Y| + |r||Y|)·s,
    |A|·|Y| = 4|Y| + the neighbours' |Y| = 8|Y| − A·|Y|."""
    Yd = Y.to(F64).abs()
    AY = 8 * Yd - stencil._plain_apply(Yd, nx, ny)
    return (AY + abs(float(r)) * Yd) * s.to(F64)[None, :]


def _dense(nx, ny):
    op = rtt.Laplacian2D(nx, ny, dtype=F64, device=CPU)
    return op.apply(torch.eye(nx * ny, dtype=F64)).numpy()


# ------------------------------------------------------------------ CPU ---

@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("b", [1, 8, 48])
@pytest.mark.parametrize("grid", [(64, 64), (9, 7)])
def test_filter_step_is_the_scaled_apply(grid, b, dtype):
    """filter_step(Y, r, S) = apply(Y·s) − r·(Y·s) with s = 1/√S a column
    (1 for a zero column), on a strided block, and its sums = col_sumsq
    of Z; with no S, Y as it is."""
    nx, ny = grid
    n = nx * ny
    op = rtt.Laplacian2D(nx, ny, dtype=dtype, device=CPU)
    Y = _strided(n, b, dtype, 1)
    assert Y.stride() == (b + 3, 1)
    r = torch.tensor(1.37, dtype=dtype)
    S_in = torch.sum(Y * Y, dim=0) * 3.0
    for sumsq_in in (S_in, None):
        s = (torch.ones(b, dtype=dtype) if sumsq_in is None else
             torch.where(S_in > 0, 1 / torch.sqrt(S_in), torch.ones_like(S_in)))
        Z, S = op.filter_step(Y, r, sumsq_in)
        assert Z.shape == (n, b) and Z.dtype == dtype and S.shape == (b,)
        Ys = Y * s[None, :]
        want = op.apply(Ys) - r * Ys
        err = ((Z - want).to(F64).abs() / _scale(Y, nx, ny, r, s).clamp_min(1e-300)).max()
        assert float(err) < 8 * EPS[dtype], (sumsq_in is None, float(err))
        sums = torch.sum(Z.to(F64) ** 2, dim=0)
        assert torch.allclose(S.to(F64), sums, rtol=64 * EPS[dtype], atol=0)
        if b > 1:
            assert not Z[:, b // 2].any() and S[b // 2] == 0


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("degree", [1, 2, 24])
def test_fused_filter_is_the_generic_loop(degree, dtype):
    """ChebyshevProductFilter on a Laplacian2D (its filter_step) against the
    same stencil with LinearOperator's plain filter_step: the same bits on
    the CPU, unit columns, and the subspace of the filter's scalar oracle
    p(A)·X (1e-10 in f64, as the filters' own oracle tests)."""
    nx, ny = 16, 12
    lap = rtt.Laplacian2D(nx, ny, dtype=dtype, device=CPU)
    X = torch.from_numpy(np.random.default_rng(degree).standard_normal(
        (nx * ny, 8))).to(dtype)
    fused = chebyshev.ChebyshevProductFilter.make(lap, 0.0, 5.5, degree=degree)
    loop = chebyshev.ChebyshevProductFilter.make(_Apply(lap), 0.0, 5.5,
                                                 degree=degree)
    Y = fused.apply(X)
    assert torch.equal(Y, loop.apply(X))
    Yd = Y.to(F64).numpy()
    unit = np.abs(np.linalg.norm(Yd, axis=0) - 1).max()
    assert unit < (1e-12 if dtype == F64 else 1e-5)
    w, U = np.linalg.eigh(_dense(nx, ny))
    want = (U * fused.scalar_direction(w)) @ (U.T @ X.to(F64).numpy())
    want /= np.linalg.norm(want, axis=0)
    err = np.abs(Yd - want).max()
    assert err < (1e-10 if dtype == F64 else 1e-3), err


def test_fused_steps_counter_on_the_stencil_only():
    """The Timer's filter_fused_steps adds the degree on a Laplacian2D (each
    step one "spmm" section adding its columns), and stays 0 on a
    block-sparse base and on a base with the plain filter_step."""
    lap = rtt.Laplacian2D(12, 10, dtype=F64, device=CPU)
    X = torch.randn((120, 6), dtype=F64)
    t = Timer()
    f = chebyshev.ChebyshevProductFilter.make(lap, 0.0, 5.0, degree=17)
    f.timer = t
    f.apply(X)
    assert t.counters["filter_fused_steps"] == 17
    assert t.counts["spmm"] == 17 and t.counters["spmm_cols"] == 17 * 6
    M = sp.random(120, 120, density=0.05, random_state=3)
    bsr = rtt.as_operator(sp.csr_matrix(M + M.T), dtype=F64, device=CPU,
                          format="bsr")
    for base in (bsr, _Apply(lap)):
        t = Timer()
        f = chebyshev.ChebyshevProductFilter.make(base, -1.0, 0.5, degree=9)
        f.timer = t
        f.apply(X)
        assert t.counters["filter_fused_steps"] == 0
        assert t.counts["spmm"] == 9


def _old_loop(base, X, a, b, degree):
    """The product filter's loop as written before the filter step: each
    step the apply, −r·Y, the column sums, the square root, the where and
    the divide."""
    c, e = (a + b) / 2, (b - a) / 2
    roots = c + e * torch.tensor(chebyshev._unit_roots(degree), dtype=X.dtype)
    Y = X
    for i in range(degree):
        Y = base.apply(Y) - roots[i] * Y
        nrm = torch.sqrt(torch.sum(Y * Y, dim=0))
        Y = Y / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return Y


@pytest.mark.parametrize("base", ["dense", "bsr", "diagonal", "duck"])
def test_plain_filter_step_gives_the_old_loops_bits(base):
    """On every base without a step of its own (and on one that is no
    LinearOperator at all, with an ``apply`` alone) the filter's steps give
    the bits of the loop they replaced."""
    rng = np.random.default_rng(5)
    M = sp.random(90, 90, density=0.08, random_state=5)
    M = sp.csr_matrix(M + M.T)
    op = {"dense": lambda: rtt.DenseOperator(torch.from_numpy(M.toarray())),
          "bsr": lambda: rtt.as_operator(M, dtype=F64, device=CPU, format="bsr"),
          "diagonal": lambda: rtt.DiagonalOperator(
              torch.from_numpy(rng.standard_normal(90)))}.get(base)
    if op is None:
        dense = rtt.DenseOperator(torch.from_numpy(M.toarray()))

        class Duck:
            n, dtype, device = 90, F64, CPU

            def apply(self, X):
                return dense.apply(X)

        op = Duck()
    else:
        op = op()
    X = torch.from_numpy(rng.standard_normal((90, 5)))
    X[:, 2] = 0
    a, b = float(-4.0), float(0.75)
    f = chebyshev.ChebyshevProductFilter.make(op, a, b, degree=11)
    assert torch.equal(f.apply(X), _old_loop(op, X, f.a, f.b, 11))


def test_the_kernel_step_refuses_a_cpu_block():
    """stencil.step is K3 alone: a CPU block raises, it never falls back."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        stencil.step(torch.zeros((12, 2)), 3, 4, torch.tensor(1.0), None, True)


def test_cpu_stencil_launches_nothing():
    """The CPU path is the plain version: K3's counter does not move, and
    apply on a strided block equals apply on its contiguous copy."""
    lap = rtt.Laplacian2D(20, 30, dtype=F32, device=CPU)
    Y = _strided(600, 8, F32, 4)
    n0 = stencil.step.launches
    assert torch.equal(lap.apply(Y), lap.apply(Y.contiguous()))
    lap.filter_step(Y, torch.tensor(0.5), None)
    assert stencil.step.launches == n0


@pytest.mark.parametrize("grid", [(512, 512), (8192, 8192), (96, 80), (7, 1)])
@pytest.mark.parametrize("b,vec", [(1, 1), (8, 2), (8, 4), (16, 8), (48, 4),
                                   (90, 2), (45, 1), (600, 2)])
def test_stencil_plan_fits_the_kernel(grid, b, vec):
    """K3's plan: at most 16 column groups and 256 threads a CTA, at least
    two grid points along y, the column tiles cover b and the y tiles ny,
    none empty, and the marches cover nx, as the launcher checks."""
    nx, ny = grid
    p = _kernels.stencil_plan(nx, ny, b, vec, 132)
    cg = b // vec
    assert p["cgt"] <= 16 and 2 <= p["ty"] and p["cgt"] * p["ty"] <= 256
    assert (p["tiles"] - 1) * p["cgt"] < cg <= p["tiles"] * p["cgt"]
    assert (p["ytiles"] - 1) * p["ty"] < ny <= p["ytiles"] * p["ty"]
    marches = -(-nx // p["gx"])
    assert (marches - 1) * p["gx"] < nx and p["ctas"] == p["ytiles"] * marches
    assert p["ctas"] * p["tiles"] <= max(3 * 132, p["ytiles"] * p["tiles"])


@pytest.mark.parametrize("dtype,b,stride,offset,vec", [
    (F64, 8, 8, 0, 2), (F32, 16, 16, 0, 4), (BF16, 16, 16, 0, 8),
    (F32, 90, 90, 0, 2), (F32, 45, 45, 0, 1), (F64, 8, 11, 0, 1),
    (F32, 8, 12, 0, 4), (F32, 8, 8, 1, 1), (F64, 1, 1, 0, 1)])
def test_stencil_vec_follows_the_layout(dtype, b, stride, offset, vec):
    """The unit a thread loads: up to 16 bytes, as b, the row stride and
    the first element's alignment allow."""
    buf = torch.zeros(100 * stride + offset + 16, dtype=dtype)
    Y = buf[offset:offset + 100 * stride].view(100, stride)[:, :b]
    assert _kernels.stencil_vec(Y) == vec


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("f16", "bf16, f32 or f64"), ("r_dtype", "r must"),
    ("sumsq_dtype", "sumsq_in must"), ("columns", "column stride"),
    ("grid", "grid")])
def test_stencil_launcher_refuses_what_it_does_not_take(case, match):
    """The launcher raises (never falls back) for CPU tensors, f16, an r or
    sums of another dtype than K3 reads, a column stride other than 1 and
    rows that are no grid of ny; nothing is built for them."""
    Y = torch.zeros((12, 4))
    r = sums = None
    ny = 4
    if case == "f16":
        Y = Y.half()
    elif case == "r_dtype":
        r = torch.tensor(1.0, dtype=F64)
    elif case == "sumsq_dtype":
        sums = torch.ones(4, dtype=F64)
    elif case == "columns":
        Y = Y.T.contiguous().T
    elif case == "grid":
        ny = 5
    with pytest.raises(ValueError, match=match):
        _kernels.launch_stencil(Y, ny, r, sums, True)


# ----------------------------------------------------------------- card ---

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    return torch.device("cuda")


def _card_block(n, b, dtype, seed, dev, pad=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((n, b + pad), generator=g, dtype=F64, device=dev)
    return buf.to(dtype)[:, :b]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b", [(F32, 8), (F32, 16), (F32, 48), (F32, 90),
                                     (F64, 8), (F64, 16), (F64, 48), (F64, 90),
                                     (BF16, 16)])
def test_card_k3_matches_the_plain_version(dtype, b):
    """K3 at the cells' shapes (512², the filters' 48-90 columns, the
    sweeps' 8 and 16): the plain apply's bits with no r and no sums (f32,
    f64: 4·y is exact and the subtractions run in the torch order; bf16
    within 4 ulps of |A|·|Y|, since torch rounds each of its five ops to
    bf16 and K3 once), and a filter step within 8 ulps (bf16: 2, computed
    in f32) of (|A|·|Y| + |r||Y|)·s (K3 scales after the stencil, the plain
    version before it); its sums within 64 ulps of Σ Z² in f64; two calls
    bitwise equal."""
    dev = _cuda()
    nx = ny = 512
    Y = _card_block(nx * ny, b, dtype, 10 + b, dev)
    Z = stencil.step(Y, nx, ny)[0]
    plain = stencil._plain_apply(Y, nx, ny)
    if dtype == BF16:
        scale = _scale(Y, nx, ny, 0.0, torch.ones(b, device=dev))
        err = ((Z.to(F64) - plain.to(F64)).abs() / scale.clamp_min(1e-30)).max()
        assert float(err) < 4 * EPS[BF16], float(err)
    else:
        assert torch.equal(Z, plain)
    r = torch.tensor(2.75, dtype=dtype, device=dev)
    acc = F64 if dtype == F64 else F32
    S_in = torch.sum(Y.to(acc) ** 2, dim=0) * 0.5
    S_in[3] = 0
    n0 = stencil.step.launches
    Z, S = stencil.step(Y, nx, ny, r, S_in, sumsq=True)
    Z2, S2 = stencil.step(Y, nx, ny, r, S_in, sumsq=True)
    assert stencil.step.launches == n0 + 2
    assert torch.equal(Z, Z2) and torch.equal(S, S2)
    s = torch.where(S_in > 0, 1 / torch.sqrt(S_in), torch.ones_like(S_in))
    want = _plain_step(Y.to(acc), nx, ny, r.to(acc), S_in)
    ulps = 8 if dtype != BF16 else 2
    err = ((Z.to(F64) - want.to(F64)).abs() / _scale(Y, nx, ny, r, s).clamp_min(1e-300)).max()
    assert float(err) < ulps * EPS[dtype], float(err)
    sums = torch.sum(Z.to(F64) ** 2, dim=0)
    assert S.dtype == acc
    assert torch.allclose(S.to(F64), sums, rtol=64 * EPS[acc], atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,pad", [(F32, 7, 0), (F32, 45, 0), (F64, 8, 3),
                                         (F32, 16, 5), (BF16, 9, 1), (F64, 1, 0)])
def test_card_k3_on_strided_and_ragged_blocks(dtype, b, pad):
    """A prefix view of a wider buffer (row stride b + pad) and widths that
    are not a multiple of the 16-byte unit, on a grid of 96 × 80 rows that
    no CTA range divides: K3 against the plain step as above."""
    dev = _cuda()
    nx, ny = 96, 80
    Y = _card_block(nx * ny, b, dtype, 30 + b, dev, pad)
    assert Y.stride(0) == b + pad
    acc = F64 if dtype == F64 else F32
    r = torch.tensor(-0.625, dtype=dtype, device=dev)
    S_in = torch.sum(Y.to(acc) ** 2, dim=0)
    Z, S = stencil.step(Y, nx, ny, r, S_in, sumsq=True)
    assert Z.is_contiguous()
    s = 1 / torch.sqrt(S_in)
    want = _plain_step(Y.to(acc), nx, ny, r.to(acc), S_in)
    err = ((Z.to(F64) - want.to(F64)).abs() / _scale(Y, nx, ny, r, s).clamp_min(1e-300)).max()
    assert float(err) < (2 if dtype == BF16 else 8) * EPS[dtype], float(err)
    assert torch.allclose(S.to(F64), torch.sum(Z.to(F64) ** 2, dim=0),
                          rtol=64 * EPS[acc], atol=0)
    assert torch.equal(stencil.step(Y, nx, ny, r, S_in, sumsq=True)[1], S)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(1, 9), (9, 1), (5, 3), (3, 300), (300, 2)])
def test_card_k3_on_small_and_thin_grids(grid):
    """Grids thinner than a tile or a march (one grid row or point along
    either axis, a y tile mostly idle): K3 with sums against the plain
    step, f64 b = 8."""
    dev = _cuda()
    nx, ny = grid
    Y = _card_block(nx * ny, 8, F64, nx + ny, dev)
    r = torch.tensor(1.5, dtype=F64, device=dev)
    S_in = torch.sum(Y ** 2, dim=0)
    Z, S = stencil.step(Y, nx, ny, r, S_in, sumsq=True)
    want = _plain_step(Y, nx, ny, r, S_in)
    s = 1 / torch.sqrt(S_in)
    err = ((Z - want).abs() / _scale(Y, nx, ny, r, s).clamp_min(1e-300)).max()
    assert float(err) < 8 * EPS[F64], float(err)
    assert torch.allclose(S, torch.sum(Z ** 2, dim=0), rtol=64 * EPS[F64], atol=0)
    assert torch.equal(stencil.step(Y, nx, ny)[0], stencil._plain_apply(Y, nx, ny))


@pytest.mark.gpu
def test_card_k3_past_2_31_elements():
    """A block of more than 2³¹ elements (4,100² grid points × 128 f32
    columns, 8.6 GB): the offsets are 64-bit.  The last grid rows against
    the plain apply of the last four grid rows as a grid of their own
    (exact past its first row)."""
    dev = _cuda()
    nx = ny = 4100
    b = 128
    assert nx * ny * b > 2 ** 31
    Y = torch.randn((nx * ny, b), dtype=F32, device=dev)
    Z = stencil.step(Y, nx, ny)[0]
    tail = Y[(nx - 4) * ny:]
    want = stencil._plain_apply(tail, 4, ny)[ny:]
    assert torch.equal(Z[(nx - 3) * ny:], want)
    del Y, Z


@pytest.mark.gpu
def test_card_k3_wrapper_refuses_what_it_does_not_take():
    """On the card: f16, a CPU operand beside a CUDA block and a column
    stride other than 1 raise."""
    dev = _cuda()
    Y = torch.zeros((64, 8), device=dev)
    with pytest.raises(ValueError):
        _kernels.launch_stencil(Y.half(), 8)
    with pytest.raises(ValueError):
        _kernels.launch_stencil(Y, 8, torch.tensor(1.0))
    with pytest.raises(ValueError):
        _kernels.launch_stencil(Y.T.contiguous().T, 8)


@pytest.mark.gpu
def test_card_polished_solve_runs_every_filter_step_through_k3(monkeypatch):
    """rbl_polished on the 64² Laplacian on the card: the plain apply never
    runs, K3 launched for every fused filter step, and the eigenvalues
    equal the CPU solve's to 1e-10."""
    dev = _cuda()

    def refuse(*args):
        raise AssertionError("the plain stencil ran on the card")

    def solve(device):
        cfg = rtt.RBLConfig(block_size=8, compute_dtype=F64, tol=1e-7,
                            device=device)
        op = rtt.Laplacian2D(64, 64, dtype=F64, device=device)
        timer = Timer()
        res = rtt.rbl_polished(op, 10, cfg=cfg, b=8, bounds=(0.0, None),
                               timer=timer)
        return res, timer

    cpu, _ = solve("cpu")
    monkeypatch.setattr(stencil, "_plain_apply", refuse)
    n0 = stencil.step.launches
    card, timer = solve(dev)
    torch.cuda.synchronize()
    fused = timer.counters["filter_fused_steps"]
    assert fused > 0 and stencil.step.launches - n0 >= fused
    assert card.converged and cpu.converged
    assert np.abs(card.eigenvalues - cpu.eigenvalues).max() < 1e-10
