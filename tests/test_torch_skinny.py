"""The products against the stored basis: ``ops/contract.py`` ``gram`` and
``update`` and ``ops/reorth.py`` ``project_out``.

On the CPU their plain versions, on strided column-prefix views of a
row-major basis buffer (the solver's ``basis_buf[:, :c]``), against float64
numpy references; the launch plans of ``csrc/skinny.cu``; and the wrappers
refusing what they do not take.  On the card (marker ``gpu``) the kernels
against the plain versions.  No JAX: on the card machine

    python -m pytest --noconftest -q tests/test_torch_skinny.py
"""

import numpy as np
import pytest
import torch

import rbl_tpu_torch as rtt
from rbl_tpu_torch.ops import contract, reorth
from rbl_tpu_torch.ops.spmm import _kernels
from rbl_tpu_torch.solver import lanczos
from rbl_tpu_torch.solver.basis import BasisStore

CPU = torch.device("cpu")
BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
N_RAGGED = 232_974  # petsc_ex56_ne42's n: 28 chunks of 8,192 and a tail
N_SHORT = 5_000     # under one chunk


def _np(t):
    return t.to(F64).cpu().numpy()


def _buffer(n, width, used, dtype, seed, device=CPU):
    """A row-major basis buffer whose columns past ``used`` are zero and
    whose columns have norms near 1, as a Krylov basis's."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.zeros((n, width), dtype=dtype)
    buf[:, :used] = (torch.randn((n, used), generator=g) / n ** 0.5).to(dtype)
    return buf.to(device)


def _block(n, q, dtype, seed, device=CPU):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, q), generator=g).to(dtype).to(device)


def _rounded(a, dtype):
    """float64 numpy a, rounded to ``dtype`` and back."""
    return torch.from_numpy(a).to(dtype).to(F64).numpy()


def _scale_err(got, want, X, Y):
    """Largest error relative to |X|ᵀ|Y|, the scale a contraction's
    rounding error is measured against."""
    scale = np.abs(X).T @ np.abs(Y)
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-300)))


TOL = {F32: 2e-6, F64: 1e-14}


# ------------------------------------------------------------------ CPU ---

@pytest.mark.parametrize("n", [N_RAGGED, N_SHORT])
@pytest.mark.parametrize("xdt,ydt,acc", [
    (BF16, F32, None), (F32, F32, None), (F64, F64, None), (BF16, BF16, None),
    (F32, F32, F64)])
def test_gram_on_a_prefix_view(n, xdt, ydt, acc):
    """gram(basis_buf[:, :24], W) against float64 numpy: the view's row
    stride is the buffer's, the tail chunk ragged or the whole block one
    chunk; the result in the accumulation dtype."""
    buf = _buffer(n, 40, 24, xdt, 1)
    X = buf[:, :24]
    W = _block(n, 8, ydt, 2)
    assert X.stride() == (40, 1)
    G = contract.gram(X, W, acc_dtype=acc)
    want_dt = acc or (F64 if F64 in (xdt, ydt) else F32)
    assert G.dtype == want_dt and G.shape == (24, 8)
    assert _scale_err(_np(G), _np(X).T @ _np(W), _np(X), _np(W)) < TOL[want_dt]


def test_gram_equals_the_chunked_pairwise_sum():
    """The plain version's partials: one per chunk of 8,192 rows, the tail
    the last, added pairwise (even + odd, an odd tail carried)."""
    X = _block(N_RAGGED, 5, F32, 3)
    Y = _block(N_RAGGED, 3, F32, 4)
    parts = [X[c:c + 8192].T @ Y[c:c + 8192] for c in range(0, N_RAGGED, 8192)]
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        parts = nxt + (parts[-1:] if len(parts) % 2 else [])
    assert torch.equal(contract.gram(X, Y), parts[0])


@pytest.mark.parametrize("n", [N_RAGGED, N_SHORT])
@pytest.mark.parametrize("vdt,wdt", [(BF16, F32), (F32, F32), (F64, F64)])
def test_project_out_on_a_prefix_view(n, vdt, wdt):
    """project_out(basis_buf[:, :c], W) = W − V·round_V(VᵀW) against
    float64 numpy, with the coefficients rounded to the basis dtype; the
    buffer (its zero padding included) is left as it was, and the whole
    zero-padded buffer gives the prefix's result."""
    buf = _buffer(n, 48, 32, vdt, 5)
    before = buf.clone()
    V = buf[:, :32]
    W = _block(n, 16, wdt, 6)
    out = reorth.project_out(V, W)
    assert out.dtype == wdt and out.shape == W.shape
    assert torch.equal(buf, before) and not buf[:, 32:].any()
    Vn, Wn = _np(V), _np(W)
    G = _rounded(Vn.T @ Wn, vdt)
    want = Wn - Vn @ G
    tol = 1e-4 if wdt == F32 else 1e-12
    assert np.max(np.abs(_np(out) - want)) / np.max(np.abs(Wn)) < tol
    padded = reorth.project_out(buf, W)
    assert np.max(np.abs(_np(padded) - _np(out))) / np.max(np.abs(Wn)) < tol


@pytest.mark.parametrize("vdt", [BF16, F32, F64])
def test_update_without_w_is_the_rounded_product(vdt):
    """update(V, G) = V·round_V(G) in the accumulation dtype (f32 for a
    bf16 V); with W, W − that product in W's dtype."""
    V = _buffer(3000, 20, 12, vdt, 7)[:, :12]
    G = _block(12, 5, F64, 8)
    acc = F32 if vdt == BF16 else vdt
    P = contract.update(V, G)
    assert P.dtype == acc
    want = _np(V) @ _rounded(_np(G), vdt)
    rel = 1e-5 if acc == F32 else 1e-13
    assert np.max(np.abs(_np(P) - want)) / np.max(np.abs(want)) < rel
    W = _block(3000, 5, acc, 9)
    out = contract.update(V, G, W)
    assert out.dtype == acc
    assert np.max(np.abs(_np(out) - (_np(W) - want))) / np.max(np.abs(want)) < rel


@pytest.mark.parametrize("bdt", [BF16, F32, F64])
def test_recover_eigvec_is_the_basis_times_the_ritz_vectors(bdt):
    """recover_eigvec: the stored basis times Ṽ rounded to the basis dtype,
    in the accumulation dtype."""
    st = BasisStore(2000, 4, max_cols=24, dtype=bdt, device=CPU)
    blocks = _block(2000, 16, F32, 10)
    for c in range(0, 16, 4):
        st.append(blocks[:, c:c + 4])
    Vk = np.random.default_rng(11).standard_normal((16, 3))
    got = lanczos.recover_eigvec(st, Vk)
    acc = F32 if bdt == BF16 else bdt
    assert got.dtype == acc
    want = _np(st.view()) @ _rounded(Vk, bdt)
    rel = 1e-5 if acc == F32 else 1e-13
    assert np.max(np.abs(_np(got) - want)) / np.max(np.abs(want)) < rel


def test_cpu_products_launch_nothing():
    """The CPU tensors take the plain versions: no launch is counted."""
    counts = (contract.gram.launches, contract.update.launches)
    V = _buffer(500, 8, 8, F32, 12)
    reorth.project_out(V, _block(500, 4, F32, 13))
    assert (contract.gram.launches, contract.update.launches) == counts


@pytest.mark.parametrize("n,p,q,xs,ys,accs", [
    (262_144, 768, 16, 2, 4, 4), (262_144, 16, 16, 4, 4, 4),
    (232_974, 1400, 8, 4, 4, 4), (232_974, 8, 8, 8, 8, 8),
    (262_144, 90, 90, 8, 8, 8), (262_144, 90, 90, 4, 4, 4),
    (5_000, 1, 1, 4, 4, 4), (100, 400, 48, 2, 2, 4),
    (8_192, 1400, 256, 4, 8, 8),
    # many chunks: the last pass takes fewer elements a batch
    (1_048_576, 400, 8, 8, 8, 8), (4_194_304, 400, 8, 8, 8, 8),
    (1_048_576, 1400, 8, 4, 4, 4), (4_194_304, 1400, 8, 4, 4, 4),
    (4_194_304, 768, 16, 2, 4, 4), (4_194_304, 8, 8, 8, 8, 8)])
def test_gram_plan_fits_the_kernel(n, p, q, xs, ys, accs):
    """K1's plan: at most 256 threads, the ring of 4 tiles and the last
    pass's chunks within the shared bytes allowed, 16-byte tile rows, the
    column groups covering p and q, the pieces covering a chunk, and
    chunks split towards two CTAs a SM in one wave, unless the pieces would
    get too short.  Any n up to millions of rows has a plan."""
    pl = _kernels.gram_plan(n, p, q, 8192, xs, ys, accs, 132)
    threads = pl["nct"] * pl["nqt"] * pl["rgn"]
    ring = 4 * pl["rows"] * pl["rgn"] * (pl["ldx"] * xs + pl["ldy"] * ys)
    assert 1 <= threads <= 256 and ring <= pl["smem"] <= 160 * 1024
    assert (pl["ldx"] * xs) % 16 == 0 and (pl["ldy"] * ys) % 16 == 0
    assert pl["nqt"] * 8 >= q and pl["tiles"] * pl["nct"] * pl["cp"] >= p
    assert pl["nchunks"] == -(-n // 8192)
    assert pl["split"] * pl["sublen"] >= min(n, 8192)
    assert pl["smem"] >= pl["nchunks"] * accs
    ctas = pl["nchunks"] * pl["tiles"] * pl["split"]
    assert ctas <= 264 or pl["split"] == 1
    assert ctas * 2 > 264 or pl["sublen"] < 8 * pl["rows"] * pl["rgn"]


@pytest.mark.parametrize("p", [1, 8, 16, 400, 768, 1400, 8000])
@pytest.mark.parametrize("q", [1, 8, 12, 16, 50])
@pytest.mark.parametrize("accs,vs", [(4, 2), (4, 4), (4, 8), (8, 2), (8, 4), (8, 8)])
def test_update_plan_fits_the_kernel(p, q, accs, vs):
    """K2's plan: at most 256 threads in whole warps, k groups of a power of 2
    whose slabs are whole 16-byte units of V, 16-byte tile rows, G's rows
    staged in whole slabs (all of them up to the budget), the ring and G
    within the shared bytes allowed, at most one resident CTA a row tile,
    and the CTAs of every column tile resident at once."""
    n = 262_144
    pl = _kernels.update_plan(n, p, q, accs, vs, accs, 132)
    ks = 32 // vs
    bk = pl["kg"] * ks
    threads = pl["ntm"] * pl["ntq"] * pl["kg"]
    assert threads <= 256 and threads % 32 == 0
    assert pl["kg"] & (pl["kg"] - 1) == 0 and pl["kg"] <= 16
    assert (pl["lda"] * vs) % 16 == 0 and pl["lda"] >= bk
    assert (pl["ldgt"] * accs) % 16 == 0 and pl["ldgt"] >= pl["pg"]
    assert pl["pg"] % bk == 0 and (pl["pg"] >= p or pl["smem"] > 90 * 1024)
    assert pl["smem"] <= 160 * 1024
    assert 1 <= pl["ctas"] <= min(264, -(-n // (4 * pl["ntm"])))
    assert pl["ctas"] * -(-q // (4 * pl["ntq"])) <= 264  # the column tiles at once


@pytest.mark.parametrize("shape,strides,dtype,width,mode", [
    ((1000, 24), (40, 1), torch.float32, 16, 16),   # a prefix of a buffer
    ((1000, 24), (40, 1), torch.bfloat16, 64, 16),
    ((1000, 7), (7, 1), torch.float32, 16, 4),      # rows of 28 bytes
    ((1000, 16), (1, 1000), torch.float32, 16, -4),  # column-major
    ((1000, 16), (1, 1000), torch.float64, 8, -8),
    ((1000, 16), (1, 1000), torch.bfloat16, 16, 0),
    ((1000, 9), (9, 1), torch.bfloat16, 8, 0)])     # odd bf16 rows
def test_copy_mode_follows_the_layout(shape, strides, dtype, width, mode):
    """The unit the kernels copy tiles in: the widest the alignment of the
    rows and the tile width allow along a contiguous row, single 4- or
    8-byte elements down a contiguous column, else plain loads."""
    base = torch.zeros(shape[0] * max(strides) + shape[1] + 8, dtype=dtype)
    t = base.as_strided(shape, strides)
    assert _kernels.copy_mode(t, width) == mode


@pytest.mark.parametrize("case", ["cpu", "f16", "acc_f32_of_f64",
                                  "acc_f64_of_f32", "rows"])
def test_kernel_wrappers_refuse_what_they_do_not_take(case):
    """The launchers raise (never fall back) for CPU tensors, dtypes
    without a kernel, an accumulation other than f64 of f64 operands or f32
    of the others, and mismatched rows; nothing is launched or built for
    them."""
    X = torch.zeros((10, 3))
    Y = torch.zeros((10, 2))
    acc = F64 if case == "acc_f64_of_f32" else F32
    if case == "f16":
        X, Y = X.half(), Y.half()
    elif case == "acc_f32_of_f64":
        X, Y = X.double(), Y.double()
    elif case == "rows":
        Y = torch.zeros((11, 2))
    with pytest.raises(ValueError, match="accumulated in" if "acc" in case else None):
        _kernels.launch_gram(X, Y, chunk=8192, acc=acc)
    with pytest.raises(ValueError):
        _kernels.launch_update(X, torch.zeros((3, 2), dtype=X.dtype), None,
                               acc=F32)


# ----------------------------------------------------------------- card ---

def _card_err(got, want, scale):
    """Largest error relative to ``scale``, computed on the card in f64."""
    d = (got.to(F64) - want.to(F64)).abs()
    return float((d / scale.clamp_min(1e-300)).max())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,ydt", [(BF16, F32), (F32, F32), (F64, F64),
                                     (BF16, BF16), (F32, F64)])
def test_card_gram_matches_the_plain_version(xdt, ydt):
    """K1 against the plain version at p 1-1,400 and q 1-90, on a prefix
    view of a row-major buffer and on a column-major block, ragged and
    single-chunk n; two calls agree bit for bit."""
    dev = _cuda()
    acc = F64 if F64 in (xdt, ydt) else F32
    for n in (N_RAGGED, N_SHORT):
        buf = _buffer(n, 1408, 1400, xdt, 20, dev)
        for p in (1, 8, 16, 400, 1400):
            for q in (1, 8, 16, 48, 90):
                Y = _block(n, q, ydt, 21 + q, dev)
                views = [buf[:, :p]]
                if p <= 16:
                    views.append(buf[:, :p].T.contiguous().T)  # column-major
                for X in views:
                    n0 = contract.gram.launches
                    G = contract.gram(X, Y)
                    again = contract.gram(X, Y)
                    assert contract.gram.launches == n0 + 2
                    ref = contract._plain_gram(X, Y, 8192, acc)
                    err = _card_err(G, ref, X.abs().T.to(F64) @ Y.abs().to(F64))
                    assert err < TOL[acc], (n, p, q, X.stride(), err)
                    assert torch.equal(G, again)


@pytest.mark.gpu
@pytest.mark.parametrize("vdt,wdt", [(BF16, F32), (F32, F32), (F64, F64),
                                     (BF16, BF16), (F64, F32)])
def test_card_update_matches_the_plain_version(vdt, wdt):
    """K2 against the plain version (G rounded to V's dtype, W − V·G in
    W's dtype), with W and without, on prefix views and column-major
    blocks; two calls agree bit for bit."""
    dev = _cuda()
    acc = F64 if wdt == F64 else F32
    for n in (N_RAGGED, N_SHORT):
        buf = _buffer(n, 1408, 1400, vdt, 30, dev)
        for p in (1, 8, 16, 400, 1400):
            for q in (1, 8, 16, 48, 90):
                G = (_block(p, q, acc, 31 + p, dev) / p ** 0.5)
                W = _block(n, q, wdt, 32 + q, dev)
                views = [buf[:, :p]]
                if p <= 16:
                    views.append(buf[:, :p].T.contiguous().T)
                for V in views:
                    for w in (W, None):
                        out = contract.update(V, G, w, acc)
                        again = contract.update(V, G, w, acc)
                        ref = contract._plain_update(V, G, w, acc)
                        assert out.dtype == ref.dtype
                        scale = V.abs().to(F64) @ G.to(vdt).abs().to(F64)
                        if w is not None:
                            scale += w.abs().to(F64)
                        tol = 1e-12 if acc == F64 else (
                            1e-2 if (w is not None and wdt == BF16) else 2e-6)
                        err = _card_err(out, ref, scale)
                        assert err < tol, (n, p, q, V.stride(), w is None, err)
                        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32, F64])
def test_card_products_do_not_depend_on_the_layout(dtype):
    """K1 and K2 give the same bits for one matrix held row-major, as a
    prefix view at an odd offset and column-major: the launch plan, and so
    the order of the sums, follows from shapes and dtypes alone (a row
    mesh of one rank holds the unsharded solve to that)."""
    dev = _cuda()
    acc = F64 if dtype == F64 else F32
    for p, q in ((8, 8), (16, 16), (100, 100), (400, 16)):
        M = _buffer(N_RAGGED, p, p, dtype, 40 + p, dev)
        shifted = torch.zeros((N_RAGGED, p + 9), dtype=dtype, device=dev)
        shifted[:, 1:p + 1] = M
        views = (M, shifted[:, 1:p + 1], M.T.contiguous().T)
        Y = _block(N_RAGGED, q, acc, 41, dev)
        grams = [contract.gram(X, Y) for X in views]
        G = grams[0]
        ups = [contract.update(X, G, Y[:, :q]) for X in views]
        for g in grams[1:]:
            assert torch.equal(g, grams[0]), (p, q)
        for u in ups[1:]:
            assert torch.equal(u, ups[0]), (p, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,p", [(F64, 1_052_675, 400), (F32, 1_400_000, 700)])
def test_card_products_over_many_chunks(dtype, n, p):
    """Millions of rows (129 and 171 chunks, past what one batch of the
    last pass holds): K1 and a projection through K1 + K2 against the plain
    versions on a prefix view."""
    dev = _cuda()
    buf = _buffer(n, p + 8, p, dtype, 50, dev)
    V = buf[:, :p]
    W = _block(n, 8, dtype, 51, dev)
    G = contract.gram(V, W)
    ref = contract._plain_gram(V, W, 8192, dtype)
    assert _card_err(G, ref, V.abs().T.to(F64) @ W.abs().to(F64)) < TOL[dtype]
    out = reorth.project_out(V, W)
    want = contract._plain_update(V, ref, W, dtype)
    scale = V.abs().to(F64) @ ref.to(dtype).abs().to(F64) + W.abs().to(F64)
    assert _card_err(out, want, scale) < (1e-12 if dtype == F64 else 2e-6)


@pytest.mark.gpu
def test_card_first_launch_of_a_full_ring():
    """A fresh process whose first Gram needs the full 48 KiB ring (the
    Cholesky-QR Gram of an (n, 8) f32 block, n = 232,974): the kernel opts
    into large shared memory before its first launch."""
    _cuda()
    import subprocess
    import sys

    code = ("import torch; from rbl_tpu_torch.ops import contract; "
            "X = torch.randn(232974, 8, device='cuda'); "
            "G = contract.gram(X, X); torch.cuda.synchronize(); "
            "print(float((G - X.double().T @ X.double()).abs().max() / G.abs().max()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert float(out.stdout.split()[-1]) < 1e-6


@pytest.mark.gpu
def test_card_wrappers_refuse_what_they_do_not_take():
    """On the card: f16 operands and operands on two devices raise."""
    dev = _cuda()
    X = torch.zeros((100, 4), device=dev)
    with pytest.raises(ValueError):
        contract.gram(X.half(), X.half())
    with pytest.raises(ValueError):
        contract.gram(X, X.cpu())
    with pytest.raises(ValueError):
        contract.update(X, torch.zeros((4, 4), device=dev), X.half())


@pytest.mark.gpu
def test_card_capped_solve_runs_every_product_through_the_kernels(monkeypatch):
    """A capped rbl solve on the card (the lap2d_512.k50_b16 cell's
    settings on a 128² grid): the plain versions never run, and the
    counters show every Gram, projection and the Ritz recovery launched."""
    dev = _cuda()

    def refuse(*args):
        raise AssertionError("a plain product ran on the card")

    monkeypatch.setattr(contract, "_plain_gram", refuse)
    monkeypatch.setattr(contract, "_plain_update", refuse)
    counts = (contract.gram.launches, contract.update.launches)
    cfg = rtt.RBLConfig(block_size=16, compute_dtype=F32, basis_dtype=BF16,
                        qr_method="cholqr2", tol=1e-3, max_kryl_dim=256,
                        eig_poll_cadence=16, device="cuda")
    op = rtt.Laplacian2D(128, 128, dtype=F32, device=dev)
    res = rtt.rbl(op, 10, cfg=cfg)
    torch.cuda.synchronize()
    grams = contract.gram.launches - counts[0]
    projections = contract.update.launches - counts[1] - 1  # and the Ritz recovery
    assert res.kryl_dim == 256
    assert projections > 0 and grams >= projections
    V = res.eigenvectors
    lam = torch.as_tensor(res.eigenvalues.copy(), dtype=F32, device=dev)
    resid = (op.apply(V) - V * lam).norm(dim=0) / 8.0
    assert float(resid.max()) < 2e-2
