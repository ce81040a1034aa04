"""Tests of the port that need a CUDA card: each CUDA kernel against its
plain PyTorch version, and the Cholesky, LU, QR, eig, SVD, band LU and
Aasen paths (real and complex) and the test-matrix generator on the card
against the same paths on the CPU. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: relative Frobenius 1e-5 in f32 (the kernels and the plain
versions sum in different orders on well-conditioned operands).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rel(x, ref):
    x, ref = x.double().cpu(), ref.double().cpu()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("nb", [1024, 200, 37, 1])
def test_cuda_kernels_match_plain(cuda, nb):
    gen = torch.Generator(device=cuda).manual_seed(nb)
    g = torch.randn(nb, nb, generator=gen, device=cuda)
    a = g @ g.T / nb + torch.eye(nb, device=cuda)
    before = dict(K.LAUNCHES)
    l = K.potrf_tile(a)
    assert rel(l, K.potrf_tile_plain(a)) < TOL
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    b = torch.randn(3 * nb + 5, nb, generator=gen, device=cuda)
    for unit in (False, True):
        assert rel(K.trsm_right_lower_t(l, b, unit),
                   K.trsm_right_lower_t_plain(l, b, unit)) < TOL
    bl = torch.randn(nb, 70, generator=gen, device=cuda)
    for unit in (False, True):
        assert rel(K.trsm_left_lower(l, bl, unit),
                   K.trsm_left_lower_plain(l, bl, unit)) < TOL
    torch.cuda.synchronize()
    after = {k: K.LAUNCHES[k] for k in before}
    assert after == {**before,
                     "potrf_tile": before["potrf_tile"] + 1,
                     "trsm_right_lower_t": before["trsm_right_lower_t"] + 2,
                     "trsm_left_lower": before["trsm_left_lower"] + 2}


def test_cuda_kernel_reports_a_failed_pivot(cuda):
    a = torch.eye(200, device=cuda)
    a[70, 70] = -1.0
    d = torch.diagonal(K.potrf_tile(a)).cpu()
    assert not torch.isfinite(d[70]) and torch.isfinite(d[:70]).all()


@pytest.mark.parametrize("n,m", [(1024, 8), (256, 8), (1024, 1024),
                                 (200, 37), (65, 1), (300, 130), (1024, 16),
                                 (1024, 32), (1024, 65), (1024, 128),
                                 (1024, 129)])
def test_trsm_left_kernel_matches_plain(cuda, n, m):
    """K3 at the path shapes (m = nrhs = 8 against a 1024 or 256 tile),
    thin with several 8-column blocks (m = 16 … 128), wide (m > 128:
    64-column blocks) and ragged, unit and not, twice in a row on one
    flag buffer (the second launch must wait for its own epoch, not the
    first's)."""
    gen = torch.Generator(device=cuda).manual_seed(n + m)
    l = torch.tril(torch.randn(n, n, generator=gen, device=cuda)) / n
    l += torch.eye(n, device=cuda)
    b = torch.randn(n, m, generator=gen, device=cuda)
    for unit in (False, True):
        before = K.LAUNCHES["trsm_left_lower"]
        x1 = K.trsm_left_lower(l, b, unit)
        x2 = K.trsm_left_lower(l, b, unit)
        ref = K.trsm_left_lower_plain(l, b, unit)
        torch.cuda.synchronize()
        assert K.LAUNCHES["trsm_left_lower"] == before + 2
        assert rel(x1, ref) < TOL and torch.equal(x1, x2)


@pytest.mark.parametrize("m", [1024, 15360, 4097, 300])
def test_trsm_right_kernel_matches_plain(cuda, m):
    """K2 at the smallest and largest posv panel heights (64-row and
    128-row blocks), just past the switch between them and ragged, unit
    and not, twice in a row on one flag buffer."""
    n = 1024
    gen = torch.Generator(device=cuda).manual_seed(m)
    l = torch.tril(torch.randn(n, n, generator=gen, device=cuda)) / n
    l += torch.eye(n, device=cuda)
    b = torch.randn(m, n, generator=gen, device=cuda)
    for unit in (False, True):
        before = K.LAUNCHES["trsm_right_lower_t"]
        x1 = K.trsm_right_lower_t(l, b, unit)
        x2 = K.trsm_right_lower_t(l, b, unit)
        ref = K.trsm_right_lower_t_plain(l, b, unit)
        torch.cuda.synchronize()
        assert K.LAUNCHES["trsm_right_lower_t"] == before + 2
        assert rel(x1, ref) < TOL and torch.equal(x1, x2)


def test_dataflow_kernels_refuse_graph_capture(cuda):
    """K1, K2, K3 and K7 raise under CUDA graph capture: a replay would
    repeat the captured epoch of their ready flags; so does K4, whose tags
    carry an epoch too."""
    l = torch.eye(64, device=cuda)
    b = torch.ones(64, 8, device=cuda)
    buf, act = torch.ones(1, 128, 64, device=cuda), torch.ones(64, device=cuda)
    torch.cuda.synchronize()
    for fn in (lambda: K.trsm_left_lower(l, b), lambda: K.potrf_tile(l),
               lambda: K.lu_nopiv_tile(l),
               lambda: K.trsm_right_lower_t(l, b.mT),
               lambda: K.panel_plu(buf, act, 0, name="plu_call")):
        with pytest.raises(st.SlateError, match="CUDA graph"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                fn()
    assert rel(K.trsm_left_lower(l, b), b) == 0.0


@pytest.mark.parametrize("nb", [256, 129, 65, 64])
def test_potrf_tile_kernel_ragged(cuda, nb):
    """K1 at ragged and whole widths against its plain version, upper
    triangle zero, twice in a row with equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(nb)
    g = torch.randn(nb, nb, generator=gen, device=cuda)
    a = g @ g.T / nb + torch.eye(nb, device=cuda)
    l1, l2 = K.potrf_tile(a), K.potrf_tile(a)
    assert rel(l1, K.potrf_tile_plain(a)) < TOL and torch.equal(l1, l2)
    assert float(torch.triu(l1, 1).abs().max()) == 0.0


@pytest.mark.parametrize("bad", [0, 63, 64, 199])
def test_potrf_tile_kernel_failed_pivot_positions(cuda, bad):
    """A negative pivot in the first column of a block, its last, and
    the ragged last block: non-finite there on the diagonal, finite
    before it."""
    a = torch.eye(200, device=cuda) * 2
    a[bad, bad] = -1.0
    d = torch.diagonal(K.potrf_tile(a)).cpu()
    assert not torch.isfinite(d[bad]) and torch.isfinite(d[:bad]).all()


def test_posv_launch_counts_on_card(cuda):
    """posv at n=300, nb=128: one K1 per diagonal tile, one K2 per
    panel below it, one K3 per tile of the forward solve."""
    n, nb = 300, 128
    rng = np.random.default_rng(6)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    grid = st.Grid(1, 1, device=cuda)
    K.reset_launches()
    X, _, info = st.posv(st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
                         st.Matrix.from_dense(b, nb=nb, grid=grid))
    torch.cuda.synchronize()
    assert int(info) == 0
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "potrf_tile": 3,
                          "trsm_right_lower_t": 2, "trsm_left_lower": 3}
    x = X.to_dense().double().cpu().numpy()
    r = np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))
    assert r < 10 * n * 2.0 ** -24


@pytest.mark.parametrize("upper", [False, True])
def test_posv_on_card_matches_cpu(cuda, upper):
    n, nb = 300, 128
    rng = np.random.default_rng(5)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    uplo = st.Uplo.Upper if upper else st.Uplo.Lower
    xs = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, _, info = st.posv(
            st.HermitianMatrix.from_dense(a, nb=nb, grid=grid, uplo=uplo),
            st.Matrix.from_dense(b, nb=nb, grid=grid))
        assert int(info) == 0
        xs.append(X.to_dense())
    assert rel(xs[0], xs[1]) < 1e-4


def _panel(S, nb, L, seed, device, kill=0.2, zero_col=None):
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(S, nb, L, generator=g)
    if zero_col is not None:
        buf[:, zero_col, :] = 0.0
    act = (torch.rand(S * L, generator=g) >= kill).float()
    return buf.to(device), act.to(device)


@pytest.mark.parametrize("S,nb,L,blocks,tie", [
    (8, 256, 48, (0, 1), False),     # folded, two blocks in a row (h = 384)
    (1, 128, 200, (0,), False),      # flat, h not a multiple of the CTA rows
    (1, 128, 40, (0,), False),       # fewer rows than columns
    (8, 128, 1024, (0,), False),     # h = 8192, one CTA per SM
    (8, 1024, 2048, (0, 7), False),  # gesv's folded panel, h = 16384
    (8, 256, 256, (0, 1), True),     # integer entries: ties in every column
    (1, 256, 8448, (0, 1), False),   # the flat branch's panel of gesv 8448
    (1, 256, 200, (0, 1), False),    # block 1 has fewer active rows than columns
])
def test_panel_plu_kernel_matches_plain(cuda, S, nb, L, blocks, tie):
    """K4 against its plain version on the card: pivots, mask and info
    equal, and the values bit for bit (both round each product and
    difference once, in the column loop's order)."""
    buf, act = _panel(S, nb, L, seed=L, device=cuda, zero_col=3)
    if tie:
        buf = torch.round(3 * buf).clamp_(-3, 3)
    pbuf, pact = buf.clone(), act.clone()
    before = K.LAUNCHES["plu_call_folded_block"]
    for blk in blocks:
        piv, info = K.panel_plu(buf, act, blk, name="plu_call_folded_block")
        ppiv, pinfo = K.panel_plu_plain(pbuf, pact, blk)
        torch.cuda.synchronize()
        assert torch.equal(piv.cpu(), ppiv.cpu())
        assert torch.equal(act.cpu(), pact.cpu())
        assert int(info) == int(pinfo)
        assert torch.equal(buf, pbuf)
        if not tie:
            assert int(info) == (blk == 0)        # the zero column
    assert K.LAUNCHES["plu_call_folded_block"] == before + len(blocks)


def test_panel_plu_kernel_nan_column(cuda):
    buf, act = _panel(8, 128, 48, seed=2, device=cuda)
    live = torch.nonzero(act).flatten()
    r = int(live[5])
    buf[r // 48, 9, r % 48] = float("nan")
    pbuf, pact = buf.clone(), act.clone()
    piv, info = K.panel_plu(buf, act, 0, name="plu_call_folded")
    ppiv, pinfo = K.panel_plu_plain(pbuf, pact, 0)
    torch.cuda.synchronize()
    assert torch.equal(piv.cpu(), ppiv.cpu())
    assert (piv[9:] == 384).all() and (piv[:9] < 384).all()
    assert torch.equal(act.cpu(), pact.cpu()) and int(info) == int(pinfo)
    assert torch.equal(torch.isnan(buf).cpu(), torch.isnan(pbuf).cpu())


@pytest.mark.parametrize("S,h,w,off", [
    (8, 8 * 37, 50, 17), (1, 130, 77, 17), (8, 1024, 256, 17),
    (1, 8448, 128, 0),      # transpose_tiled of the parent's subpanel
    (1, 8448, 256, 0),      # transpose_tiled of the flat branch's panel
    (8, 16384, 128, 0),     # transpose_fold, unfold_transpose
    (8, 16384, 1024, 0),    # fold_panel, unfold_panel
    (1, 8448, 256, 1), (8, 1024, 256, 4), (1, 135, 66, 2)])
def test_panel_transpose_kernel_bitwise(cuda, S, h, w, off):
    """K5 against permute().contiguous(), on a strided window of a wider
    matrix and back: bitwise equal; then back into a window of a wider
    matrix (and, for S = 1, the fold into one too), whose guard columns
    on both sides keep their bits. ``off`` is the windows' column
    offset: a multiple of 4 floats takes the 16-byte path, any other the
    masked one."""
    big = torch.randn(h + 3, w + off + 40, device=cuda)
    win = big[3:, off:off + w]
    before = K.LAUNCHES["fold_panel"], K.LAUNCHES["unfold_panel"]
    f = K.panel_fold(win, S, name="fold_panel")
    assert torch.equal(f, K.panel_fold_plain(win, S))
    u = K.panel_unfold(f, name="unfold_panel")
    assert torch.equal(u, K.panel_unfold_plain(f)) and torch.equal(u, win)
    dst = torch.randn(h, w + off + 40, device=cuda)
    keep = dst.clone()
    out = K.panel_unfold(f, name="unfold_panel", out=dst[:, off:off + w])
    assert out.data_ptr() == dst[:, off:].data_ptr()
    assert torch.equal(dst[:, off:off + w], win)
    assert torch.equal(dst[:, :off], keep[:, :off])
    assert torch.equal(dst[:, off + w:], keep[:, off + w:])
    folds = 1
    if S == 1:
        dT = torch.randn(w, h + off + 9, device=cuda)
        keepT = dT.clone()
        K.panel_fold(win, 1, name="fold_panel", out=dT[None, :, off:off + h])
        assert torch.equal(dT[:, off:off + h], f[0])
        assert torch.equal(dT[:, :off], keepT[:, :off])
        assert torch.equal(dT[:, off + h:], keepT[:, off + h:])
        folds = 2
    torch.cuda.synchronize()
    assert (K.LAUNCHES["fold_panel"], K.LAUNCHES["unfold_panel"]) == (
        before[0] + folds, before[1] + 2)


@pytest.mark.parametrize("n", [1024, 1280])
def test_gesv_on_card_matches_cpu(cuda, monkeypatch, n):
    """The LU fast path on the card (forced at a small size; n = 1024 the
    folded branch, 1280 the flat one: its windows are 1280 and 256 rows)
    against the same path on the CPU: equal pivots and info; LU within
    10·n·2⁻²⁴·max|LU| (the panel kernel matches its plain version bit
    for bit, but cuBLAS and the CPU's BLAS sum the updates in other
    orders, and an f32 LU's distance from the exact factors grows like
    n·ε·max|U| on either side)."""
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    nb = 256
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, LU, piv, info = st.gesv(st.Matrix.from_dense(a, nb=nb, grid=grid),
                                   st.Matrix.from_dense(b, nb=nb, grid=grid))
        out.append((X.to_dense().cpu(), LU.to_dense().cpu(), piv.cpu(),
                    int(info)))
    assert torch.equal(out[0][2], out[1][2]) and out[0][3] == out[1][3] == 0
    assert float((out[0][1] - out[1][1]).abs().max()) \
        <= 10 * n * 2.0 ** -24 * float(out[1][1].abs().max())
    x = out[0][0].double().numpy()
    r = np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))
    assert r <= 10 * n * 2.0 ** -24


@pytest.mark.parametrize("h,d0", [(16384, 0), (13312, 896), (384, 128),
                                  (200, 72), (1000, 37)])
def test_panel_qr_kernel_matches_plain(cuda, h, d0):
    """K6 on a column window of a wider matrix against its plain version:
    R, V and tau within TOL (f32 sums in other orders; either side is
    ~1e-7 from the f64 factors), rows above d0 and the columns outside
    the window bitwise unchanged. At (1000, 37) the 963 rows fill 30 CTAs
    of 32 and 3 rows of a 31st; at (16384, 0) 65 CTAs of 249 rows and 199
    of a 66th: the last CTA is ragged."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    big = torch.randn(h, 3 * 128, generator=gen, device=cuda)
    ref = big.clone()
    before = K.LAUNCHES["qr_call"]
    tau = K.panel_qr(big[:, 128:256], d0)
    sub_p = ref[:, 128:256].clone()
    tau_p = K.panel_qr_plain(sub_p, d0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["qr_call"] == before + 1
    assert rel(big[:, 128:256], sub_p) < TOL and rel(tau, tau_p) < TOL
    assert torch.equal(big[:d0], ref[:d0])
    assert torch.equal(big[:, :128], ref[:, :128])
    assert torch.equal(big[:, 256:], ref[:, 256:])


@pytest.mark.parametrize("h,d0", [(16384, 0), (1000, 37)])
def test_panel_qr_kernel_repeats_its_bits(cuda, h, d0):
    """K6 twice on one window: every bit of the window and tau equal (its
    sums across CTAs run in a fixed order whatever the CTAs' timing), one
    launch each."""
    gen = torch.Generator(device=cuda).manual_seed(h + d0)
    a = torch.randn(h, 128, generator=gen, device=cuda)
    before = K.LAUNCHES["qr_call"]
    x, y = a.clone(), a.clone()
    tx, ty = K.panel_qr(x, d0), K.panel_qr(y, d0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["qr_call"] == before + 2
    assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(tx.view(torch.int32), ty.view(torch.int32))


def test_panel_qr_kernel_refuses_graph_capture(cuda):
    """K6's tags carry a new epoch per launch, which a graph replay would
    repeat: under CUDA graph capture it raises, and the card is fine
    after."""
    a = torch.randn(300, 128, device=cuda)
    torch.cuda.synchronize()
    with pytest.raises(st.SlateError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            K.panel_qr(a, 0)
    tau = K.panel_qr(a, 0)
    assert bool(torch.isfinite(tau).all())


@pytest.mark.parametrize("nb", [1024, 256, 200, 65, 37, 1])
def test_lu_nopiv_tile_kernel_matches_plain(cuda, nb):
    gen = torch.Generator(device=cuda).manual_seed(nb)
    a = torch.randn(nb, nb, generator=gen, device=cuda) \
        + nb * torch.eye(nb, device=cuda)
    before = K.LAUNCHES["lu_nopiv_tile"]
    lu, info = K.lu_nopiv_tile(a)
    lu_p, info_p = K.lu_nopiv_tile_plain(a)
    torch.cuda.synchronize()
    assert K.LAUNCHES["lu_nopiv_tile"] == before + 1
    assert rel(lu, lu_p) < TOL and int(info) == int(info_p) == 0


def test_lu_nopiv_tile_kernel_zero_pivot(cuda):
    """A zero row and column give an exact zero pivot: it stays 0 on the
    diagonal, the elimination goes on past it, and both versions count
    it."""
    a = torch.randn(200, 200, device=cuda) + 200 * torch.eye(200, device=cuda)
    a[70, :] = 0.0
    a[:, 70] = 0.0
    lu, info = K.lu_nopiv_tile(a)
    lu_p, info_p = K.lu_nopiv_tile_plain(a)
    torch.cuda.synchronize()
    assert int(info) == int(info_p) == 1 and float(lu[70, 70]) == 0.0
    assert bool(torch.isfinite(lu).all()) and rel(lu, lu_p) < TOL


def test_geqrf_on_card_matches_cpu(cuda, monkeypatch):
    """The QR fast path forced at [1024, 512], nb=128: K6 on the card,
    its plain version on the CPU; R and the taus (T's diagonal) within
    TOL."""
    monkeypatch.setenv("SLATE_QR_FAST", "1")
    monkeypatch.setenv("SLATE_QR_PANEL", "1")
    a = np.random.default_rng(8).standard_normal((1024, 512)).astype(
        np.float32)
    out = []
    for dev in (cuda, "cpu"):
        before = K.LAUNCHES["qr_call"]
        QR, T = st.geqrf(st.Matrix.from_dense(a, nb=128,
                                              grid=st.Grid(1, 1, device=dev)))
        out.append((torch.triu(QR.to_dense()).cpu(),
                    torch.diagonal(T, dim1=1, dim2=2).cpu(),
                    K.LAUNCHES["qr_call"] - before))
    assert out[0][2] == 4 and out[1][2] == 0
    assert rel(out[0][0], out[1][0]) < TOL and rel(out[0][1], out[1][1]) < TOL


def test_gesv_nopiv_on_card_matches_cpu(cuda):
    n, nb = 600, 256
    rng = np.random.default_rng(6)
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    xs = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, LU, info = st.gesv_nopiv(st.Matrix.from_dense(a, nb=nb, grid=grid),
                                    st.Matrix.from_dense(b, nb=nb, grid=grid))
        assert int(info) == 0
        xs.append(X.to_dense())
    assert rel(xs[0], xs[1]) < TOL


def _rebuild_err(out, ab, upper):
    """‖band − Q·T·Qᵀ‖_F/‖band‖_F (hb2st) or ‖band − U₂·B·V₂ᵀ‖_F/‖band‖_F
    (tb2bd), rebuilt in f64 from a chase's d, e and reflectors."""
    from slate_tpu_torch.linalg.bulge import apply_bulge_reflectors
    b, n = ab.shape[0] - 1, ab.shape[1]
    o = [torch.from_numpy(np.asarray(x, np.float64)) for x in out[:6]]
    eye = torch.eye(n, dtype=torch.float64)
    mid = torch.diag(o[0]) + torch.diag(o[1], 1)
    if upper:
        rebuilt = (apply_bulge_reflectors(o[2], o[3], eye, b) @ mid
                   @ apply_bulge_reflectors(o[4], o[5], eye, b).T)
    else:
        q = apply_bulge_reflectors(o[2], o[3], eye, b)
        rebuilt = q @ (mid + torch.diag(o[1], -1)) @ q.T
    dense = _dense_band(ab.astype(np.float64), upper)
    return float(np.linalg.norm(rebuilt.numpy() - dense)
                 / np.linalg.norm(dense))


def _dense_band(ab, upper):
    b, n = ab.shape[0] - 1, ab.shape[1]
    a = np.zeros((n, n))
    for d in range(min(b, n - 1) + 1):  # diagonals past the corner are empty
        j = np.arange(n - d)
        a[j, j + d] = ab[d, :n - d]
        if not upper:
            a[j + d, j] = ab[d, :n - d]
    return a


@pytest.mark.parametrize("n,b", [(12, 1), (50, 8), (100, 16), (300, 160),
                                 (40, 64), (120, 256)])
def test_chase_kernels_match_plain(cuda, n, b):
    """K8/K9 (hb2st/tb2bd) against their plain versions on the card:
    d and |e| within 2e-2·‖A‖₂ (f32, a long chain of reflections summed
    in other orders: the reduction is backward, not forward, stable, and
    e's sign may flip at a near-zero pivot; 8.5e-3 absolute measured at
    (300, 160)), the spectrum within 2e-3·max|λ| of the dense f64 band's,
    one launch each. b = 160 and 256 run the blocks in global scratch
    instead of shared memory; at b ≥ n every sweep is one task.

    Where the chain is short (n ≤ 50), V and τ within max(5e-3, 3·drift)
    of the f64 plain version, drift the larger distance of the two f32
    plain versions (on the card and on the CPU: the same code summed in
    other orders) from it; and the band rebuilt in f64 from the kernel's
    d, e and reflectors within 1.5× the f32 plain version's backward
    error. Measured on an H100 (tools/tile_kernel_times.py --only
    chase_drift): the kernel's distance over drift is at most 1.16 for
    K8 and 2.09 for K9 (τ of the U side at (40, 64): 1.86e-2 against
    8.90e-3 on the CPU and 3.65e-3 on the card); its backward error over
    the plain version's at most 1.05 (2.7e-7 at (40, 64)). The last
    U-side reflectors of a full band are ill-conditioned: over eight
    seeds the CPU's f32 distance is up to 16× the card's, while the
    kernel's backward error stays within 1.20× the plain version's."""
    ab = np.random.default_rng(n * b).standard_normal((b + 1, n)).astype(
        np.float32)
    g = torch.from_numpy(ab).to(cuda)
    before = K.LAUNCHES["hb2st_vmem"], K.LAUNCHES["tb2bd_vmem"]
    for fn, plain, upper in ((K.hb2st_chase, st.internal.band_bulge.hb2st,
                              False),
                             (K.tb2bd_chase, st.internal.band_bulge.tb2bd,
                              True)):
        out = [x.cpu().numpy() for x in fn(g)]
        ref = [x.cpu().numpy() for x in plain(g)]
        torch.cuda.synchronize()
        d, e = out[0].astype(np.float64), out[1].astype(np.float64)
        dense = _dense_band(ab.astype(np.float64), upper)
        if upper:
            got = np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)
            want = np.linalg.svd(dense, compute_uv=False)
        else:
            got = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1)
                                     + np.diag(e, -1))
            want = np.linalg.eigvalsh(dense)
        norm2 = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-3 * norm2
        assert np.abs(np.abs(out[0]) - np.abs(ref[0])).max() <= 2e-2 * norm2
        assert np.abs(np.abs(out[1]) - np.abs(ref[1])).max() <= 2e-2 * norm2
        if n <= 50:
            ref64 = [x.cpu().numpy() for x in plain(g.double())]
            cpu = [x.numpy() for x in plain(g.cpu())]
            for x, y, c, z in zip(out[2:6], ref[2:6], cpu[2:6], ref64[2:6]):
                drift = max(np.abs(y - z).max(), np.abs(c - z).max())
                assert np.abs(x - z).max() <= max(5e-3, 3 * drift)
            assert _rebuild_err(out, ab, upper) <= 1.5 * _rebuild_err(
                ref, ab, upper)
    assert (K.LAUNCHES["hb2st_vmem"], K.LAUNCHES["tb2bd_vmem"]) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n,b", [(300, 16), (1024, 128), (300, 160)])
def test_hb2st_kernel_repeats_its_bits(cuda, n, b):
    """K8 twice on one band: every output bit for bit equal (its
    reductions run in a fixed order and its waits order every task
    before what reads it, whatever the CTAs' timing), one launch each."""
    ab = torch.from_numpy(np.random.default_rng(n + b).standard_normal(
        (b + 1, n)).astype(np.float32)).to(cuda)
    before = K.LAUNCHES["hb2st_vmem"]
    first = K.hb2st_chase(ab)
    second = K.hb2st_chase(ab)
    torch.cuda.synchronize()
    assert K.LAUNCHES["hb2st_vmem"] == before + 2
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_hb2st_kernel_refuses_graph_capture(cuda):
    """K8's wrapper builds its ribbon by boolean indexing, which waits for
    the host: under CUDA graph capture it raises, and the card is fine
    after."""
    ab = torch.randn(17, 200, device=cuda)
    torch.cuda.synchronize()
    with pytest.raises(st.SlateError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            K.hb2st_chase(ab)
    d, e, V, tau = K.hb2st_chase(ab)
    assert bool(torch.isfinite(d).all())


# sha256 (first 16 hex digits) of K9's (d, e, Vu, tauu, Vv, tauv) at
# n = 300, band = 16 on the band below, fixed from the one-launch kernel
# (csrc/band_chase.cu on chase_flow.cuh); the kernel it replaced summed in
# other orders and gave other bits
TB2BD_300_16_SHA = "813ee1a7126fa50c"


def test_tb2bd_kernel_keeps_its_bits(cuda):
    """K9 twice on one band: both runs bit for bit equal and equal to the
    pinned digest."""
    import hashlib
    ab = torch.from_numpy(np.random.default_rng(916).standard_normal(
        (17, 300)).astype(np.float32)).to(cuda)
    first = K.tb2bd_chase(ab)[:6]
    second = K.tb2bd_chase(ab)[:6]
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    sha = hashlib.sha256(b"".join(x.cpu().numpy().tobytes()
                                  for x in first)).hexdigest()[:16]
    assert sha == TB2BD_300_16_SHA, sha


@pytest.mark.parametrize("n,b", [(1024, 128), (300, 160)])
def test_tb2bd_kernel_repeats_its_bits(cuda, n, b):
    """K9 twice on one band: every output bit for bit equal, one launch
    each."""
    ab = torch.from_numpy(np.random.default_rng(n + b).standard_normal(
        (b + 1, n)).astype(np.float32)).to(cuda)
    before = K.LAUNCHES["tb2bd_vmem"]
    first = K.tb2bd_chase(ab)
    second = K.tb2bd_chase(ab)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tb2bd_vmem"] == before + 2
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_tb2bd_kernel_refuses_graph_capture(cuda):
    """K9's wrapper builds its ribbon by boolean indexing, which waits for
    the host: under CUDA graph capture it raises, and the card is fine
    after."""
    ab = torch.randn(17, 200, device=cuda)
    torch.cuda.synchronize()
    with pytest.raises(st.SlateError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            K.tb2bd_chase(ab)
    d = K.tb2bd_chase(ab)[0]
    assert bool(torch.isfinite(d).all())


def test_chase_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(st.SlateError, match="band 300"):
        K.hb2st_chase(torch.randn(301, 400, device=cuda))
    with pytest.raises(st.SlateError, match="non-finite"):
        st.linalg.he2hb.hb2st(torch.full((9, 40), float("nan"), device=cuda))


CHASE_TYPES = {"f64": torch.float64, "c64": torch.complex64,
               "c128": torch.complex128}


@pytest.mark.parametrize("kind", ["f64", "c64", "c128"])
@pytest.mark.parametrize("n,b", [(256, 64), (600, 32)])
def test_chase_kernels_typed_match_plain(cuda, kind, n, b):
    """K8 and K9 in float64, complex64 and complex128 against their plain
    versions on the card (:func:`_chase_matches_plain`)."""
    _chase_matches_plain(cuda, CHASE_TYPES[kind], n, b)


@pytest.mark.parametrize("kind", ["f32", "f64", "c64", "c128"])
def test_chase_kernels_match_plain_where_blocks_leave_shared_memory(cuda,
                                                                    kind):
    """K8 and K9 on both sides of the band where a type's two task blocks
    leave shared memory for scratch, as the kernels' own
    ``slate_*_scratch`` queries place it (float32 143, which takes the
    8-column register tiles, and 144; float64 and complex64 101 and 102;
    complex128 71 and 72), against their plain versions."""
    dt = {"f32": torch.float32, **CHASE_TYPES}[kind]
    item = torch.empty((), dtype=dt).element_size()
    edge = {}
    for chase in ("hb2st", "tb2bd"):
        need = K._entry(f"slate_{chase}_scratch")
        edge[chase] = max(b for b in range(1, 257) if need(b, item) == 0)
        assert need(edge[chase] + 1, item) == 2 * (edge[chase] + 1) * (
            (edge[chase] + 1) | 1)
    assert edge["hb2st"] == edge["tb2bd"] == {
        torch.float32: 143, torch.float64: 101, torch.complex64: 101,
        torch.complex128: 71}[dt]
    for b in (edge["hb2st"], edge["hb2st"] + 1):
        _chase_matches_plain(cuda, dt, 300, b)


def _chase_matches_plain(cuda, dt, n, b):
    """K8 and K9 in ``dt`` on a random (n, b) band against their plain
    versions on the card: d and |e| within 5e-2·‖A‖·u/2⁻²⁴ (the chain
    drifts single entries, not the spectrum), sweep 0's reflectors within
    1e-4·u/2⁻²⁴, the tridiagonal's spectrum the plain one's within
    10·n·u·‖A‖; d and e real, phase0 equal, two runs bit for bit equal,
    one launch each."""
    u = 2.0 ** -24 if dt in (torch.float32, torch.complex64) else 2.0 ** -53
    scale = u / 2.0 ** -24
    ab = torch.randn(b + 1, n, generator=torch.Generator(device=cuda)
                     .manual_seed(n + b), device=cuda, dtype=dt)
    rdt = dt.to_real() if dt.is_complex else dt
    from slate_tpu_torch.internal import band_bulge as bb
    for name, fn, plain in (("hb2st_vmem", K.hb2st_chase, bb.hb2st),
                            ("tb2bd_vmem", K.tb2bd_chase, bb.tb2bd)):
        before = K.LAUNCHES[name]
        out, again = fn(ab), fn(ab)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 2
        for x, y in zip(out, again):
            assert torch.equal(x, y)
        ref = plain(ab)
        assert out[0].dtype == out[1].dtype == rdt
        norm = float(ab.abs().max()) * b
        for x, y in zip(out[:2], ref[:2]):
            assert float((x.abs() - y.abs()).abs().max()) \
                <= 5e-2 * scale * norm
        for x, y in zip(out[2:-1 if name == "tb2bd_vmem" else 4],
                        ref[2:-1 if name == "tb2bd_vmem" else 4]):
            assert float((x[0] - y[0]).abs().max()) <= 1e-4 * scale
        if name == "tb2bd_vmem":
            assert torch.equal(out[6], ref[6])
        upper = name == "tb2bd_vmem"

        def spec(d, e):
            t = torch.diag(d.double()) + torch.diag(e.double(), 1)
            if upper:
                return torch.linalg.svdvals(t)
            return torch.linalg.eigvalsh(t + torch.diag(e.double(), -1))
        gap = float((spec(*out[:2]) - spec(*ref[:2])).abs().max())
        assert gap <= 10 * n * u * float(spec(*ref[:2]).abs().max())


@pytest.mark.parametrize("kind", ["f64", "c64", "c128"])
def test_two_stage_typed_on_card_match_cpu(cuda, kind):
    """heev (DC) and gesvd by the two-stage pipelines at n = 256, nb = 32
    in float64, complex64 and complex128 on the card (K8, K9 of the type)
    and on the CPU: λ and σ of the real dtype within 10·n·u of each other
    relative to the largest, the card's vectors by residual."""
    dt = CHASE_TYPES[kind]
    n, nb = 256, 32
    u = 2.0 ** -24 if dt == torch.complex64 else 2.0 ** -53
    rdt = torch.float32 if dt == torch.complex64 else torch.float64
    rng = np.random.default_rng(12)
    g = rng.standard_normal((n, n))
    if dt.is_complex:
        g = g + 1j * rng.standard_normal((n, n))
    g = g.astype({torch.float64: np.float64, torch.complex64: np.complex64,
                  torch.complex128: np.complex128}[dt])
    a = (g + g.conj().T) / 2
    bound = 10 * n * u
    lam, sv = {}, {}
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        before = dict(K.LAUNCHES)
        l, Z = st.heev(st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
                       {st.Option.MethodEig: st.MethodEig.DC})
        s, U, VT = st.svd(st.Matrix.from_dense(g, nb=nb, grid=grid),
                          {st.Option.MethodSVD: st.MethodSVD.TwoStage})
        assert l.dtype == s.dtype == rdt
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        assert launched == {**dict.fromkeys(before, 0),
                            **({"hb2st_vmem": 1, "tb2bd_vmem": 1}
                               if dev != "cpu" else {})}
        lam[str(dev)] = l.double().cpu().numpy()
        sv[str(dev)] = s.double().cpu().numpy()
        z = Z.to_dense().cpu().numpy().astype(np.complex128)
        assert np.linalg.norm(a @ z - z * lam[str(dev)]) \
            <= bound * np.linalg.norm(a)
        uu, vt = (M.to_dense().cpu().numpy().astype(np.complex128)
                  for M in (U, VT))
        assert np.linalg.norm(uu * sv[str(dev)] @ vt - g) \
            <= bound * np.linalg.norm(g)
    assert np.abs(lam["cuda"] - lam["cpu"]).max() \
        <= bound * np.abs(lam["cpu"]).max()
    assert np.abs(sv["cuda"] - sv["cpu"]).max() <= bound * sv["cpu"][0]


@pytest.mark.parametrize("kind", ["f32", "c64", "c128"])
@pytest.mark.parametrize("m,n", [(160, 96), (96, 160)])
def test_gesvd_dense_route_on_card_matches_cpu(cuda, kind, m, n):
    """gesvd's dense route (cuSOLVER's gesvd driver on the card, LAPACK
    on the CPU), tall and wide, with and without vectors: σ of the real
    dtype, the card's within 10·max(m, n)·u·σ_max of the CPU's, U·Σ·Vᴴ
    rebuilding A within the same bound."""
    dt = {"f32": torch.float32, **CHASE_TYPES}[kind]
    u = 2.0 ** -24 if dt in (torch.float32, torch.complex64) else 2.0 ** -53
    rdt = dt.to_real() if dt.is_complex else dt
    g = torch.randn(m, n, generator=torch.Generator().manual_seed(m + n),
                    dtype=dt)
    bound = 10 * max(m, n) * u
    dense = {st.Option.MethodSVD: st.MethodSVD.Dense}
    sv = {}
    for dev in (cuda, "cpu"):
        A = st.Matrix.from_dense(g.to(dev), nb=32,
                                 grid=st.Grid(1, 1, device=dev))
        s0 = st.gesvd(A, dense)[0]
        s, U, VT = st.gesvd(A, dense, True, True)
        assert s.dtype == s0.dtype == rdt
        assert float((s - s0).abs().max()) <= bound * float(s[0])
        rec = (U.to_dense() * s.to(dt)) @ VT.to_dense()
        assert float(torch.linalg.norm(rec.cpu() - g)) \
            <= bound * float(torch.linalg.norm(g))
        sv[str(dev)] = s.double().cpu()
    assert float((sv["cuda"] - sv["cpu"]).abs().max()) \
        <= bound * float(sv["cpu"][0])


def test_heev_gesvd_on_card_match_cpu(cuda):
    """The two-stage heev (DC) and gesvd at n=256, nb=32 on the card
    (both chase kernels) and on the CPU: λ and σ within 10·n·2⁻²⁴ of
    each other relative to the largest, vectors by residual."""
    n, nb = 256, 32
    rng = np.random.default_rng(11)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = (g + g.T) / 2
    bound = 10 * n * 2.0 ** -24
    lam, sv = {}, {}
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        l, Z = st.heev(st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
                       {st.Option.MethodEig: st.MethodEig.DC})
        z = Z.to_dense().double().cpu().numpy()
        lam[str(dev)] = l.double().cpu().numpy()
        assert np.linalg.norm(a @ z - z * lam[str(dev)]) \
            <= bound * np.linalg.norm(a)
        s, U, VT = st.svd(st.Matrix.from_dense(g, nb=nb, grid=grid),
                          {st.Option.MethodSVD: st.MethodSVD.TwoStage})
        sv[str(dev)] = s.double().cpu().numpy()
        u, vt = (U.to_dense().double().cpu().numpy(),
                 VT.to_dense().double().cpu().numpy())
        assert np.linalg.norm(u * sv[str(dev)] @ vt - g) \
            <= bound * np.linalg.norm(g)
    assert np.abs(lam["cuda"] - lam["cpu"]).max() \
        <= bound * np.abs(lam["cpu"]).max()
    assert np.abs(sv["cuda"] - sv["cpu"]).max() <= bound * sv["cpu"][0]


def tie_panel(h=128, w=128, seed=0):
    """A panel whose column 1 ties, after step 0's swap of rows 0 and 3,
    between position 1 and position 3 (where row 0 went): the
    current-position rule (LAPACK's, and B6's) takes 1, a tie broken on
    the original row index would take 3. Integer entries keep the tie
    exact."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((h, w)).astype(np.float32)
    a[:, 0] = 0.0
    a[0, 0], a[3, 0] = 1.0, 4.0
    a[:, 1] = rng.integers(-1, 2, h)
    a[0, 1], a[1, 1], a[3, 1] = 3.0, 2.0, 4.0
    return a


@pytest.mark.parametrize("h,w,case", [(K.SWAP_H_MAX, 256, "random"),
                                      (16128, 256, "random"),
                                      (8192, 256, "random"),
                                      (2048, 256, "random"),
                                      (256, 256, "random"),
                                      (300, 128, "random"),
                                      (130, 128, "random"),
                                      (70, 128, "random"),
                                      (128, 128, "tie"),
                                      (256, 128, "nan"),
                                      (256, 128, "zero")])
def test_panel_plu_swap_kernel_matches_plain(cuda, h, w, case):
    """K10 against its plain version on the card: pivots and info equal,
    the NaN pattern equal, values within atol 1e-4; at the random shapes
    (hesv's panel heights among them) bit for bit (both divide, multiply
    and subtract with one rounding each, in the same order); the tie goes
    to position 1."""
    rng = np.random.default_rng(h)
    a = (tie_panel(h, w) if case == "tie"
         else rng.standard_normal((h, w)).astype(np.float32))
    if case == "nan":
        a[40, 7] = np.nan
    if case == "zero":
        a[:, 0] = 0.0
    g = torch.from_numpy(a).to(cuda)
    before = K.LAUNCHES["panel_plu_pallas"]
    lu, piv, info = K.panel_plu_swap(g)
    lu_p, piv_p, info_p = K.panel_plu_swap_plain(g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["panel_plu_pallas"] == before + 1
    assert torch.equal(piv.cpu(), piv_p.cpu()) and int(info) == int(info_p)
    assert torch.equal(torch.isnan(lu).cpu(), torch.isnan(lu_p).cpu())
    fin = ~torch.isnan(lu_p)
    assert float((lu[fin] - lu_p[fin]).abs().max()) <= 1e-4
    if case == "random":
        assert torch.equal(lu.view(torch.int32), lu_p.view(torch.int32))
    if case == "tie":
        assert piv[:2].tolist() == [3, 1]
    if case == "nan":
        assert int(piv[7]) == h and int(info) >= 1
    if case == "zero":
        assert int(info) >= 1


@pytest.mark.parametrize("m,n,k", [
    (32, 96, 96), (4096, 4096, 64), (70, 130, 1), (5, 300, 127),
    (32, 96, 1), (32, 96, 127), (1, 96, 96), (32, 1, 96), (33, 130, 96),
    (130, 33, 127), (1, 130, 1), (130, 1, 1), (33, 33, 33),
    (1024, 1024, 127), (4096, 4096, 96)])
def test_rank_k_tail_kernel_matches_plain(cuda, m, n, k):
    """K11 against its plain version on the card (FMA accumulation
    against cuBLAS's FP32 product: rounding only), at α = −1, β = 1 and
    α = 0.5, β = −2, on strided windows of wider tensors (leading
    dimensions above the widths and not multiples of 4, as the band LU's
    slices may have): the 16×32 tile (fewer than 128 tiles of 64×64)
    and the 64×64 one (k = 64 in one round of strips; 96 and 127 in two,
    with shared memory above the 48 KB default), k = 1 and 127, m or n
    of 1, 33 and 130."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    c = torch.randn(m, n + 3, generator=gen, device=cuda)[:, :n]
    a = torch.randn(m, k + 5, generator=gen, device=cuda)[:, 2:2 + k]
    b = torch.randn(k, n, generator=gen, device=cuda)
    for alpha, beta in ((-1.0, 1.0), (0.5, -2.0)):
        before = K.LAUNCHES["rank_k_tail_pallas"]
        out = K.rank_k_tail(c, a, b, alpha, beta)
        ref = K.rank_k_tail_plain(c, a, b, alpha, beta)
        torch.cuda.synchronize()
        assert K.LAUNCHES["rank_k_tail_pallas"] == before + 1
        assert rel(out, ref) < TOL


@pytest.mark.parametrize("m,n,k", [(32, 96, 96), (4096, 4096, 64),
                                   (100, 4000, 127), (1024, 1024, 127)])
def test_rank_k_tail_kernel_contiguous_and_strided_agree(cuda, m, n, k):
    """K11 reads aligned operands as float4 and others as scalars, in
    either tile size (16×32 at the first and third shapes, 64×64 at
    the second and fourth): both give the same bits (one accumulator
    per output, k ascending, then α·acc + β·c)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    c = torch.randn(m, n, generator=gen, device=cuda)
    a = torch.randn(m, k, generator=gen, device=cuda)
    b = torch.randn(k, n, generator=gen, device=cuda)
    wide = [torch.zeros(x.shape[0], x.shape[1] + 3, device=cuda)
            for x in (c, a, b)]
    for w, x in zip(wide, (c, a, b)):
        w[:, 1:1 + x.shape[1]] = x
    out = K.rank_k_tail(c, a, b, -1.0, 1.0)
    out_s = K.rank_k_tail(*(w[:, 1:1 + x.shape[1]]
                            for w, x in zip(wide, (c, a, b))), -1.0, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), out_s.view(torch.int32))


def test_gbsv_on_card_matches_cpu(cuda):
    """gbsv at n=512, kl = ku = 32, a Gaussian band with no diagonal
    boost: the band block is 96, so K11 takes every trailing update;
    equal pivots and info, X within 1e-4 of the CPU's."""
    n, kl, ku = 512, 32, 32
    rng = np.random.default_rng(12)
    a = rng.standard_normal((n, n)).astype(np.float32)
    i, j = np.indices((n, n))
    a[(j - i > ku) | (i - j > kl)] = 0.0
    b = rng.standard_normal((n, 3)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        before = K.LAUNCHES["rank_k_tail_pallas"]
        X, F, piv, info = st.gbsv(
            st.BandMatrix.from_dense(a, nb=128, grid=grid, kl=kl, ku=ku),
            st.Matrix.from_dense(b, nb=128, grid=grid))
        out.append((X.to_dense().cpu(), piv.cpu(), int(info),
                    K.LAUNCHES["rank_k_tail_pallas"] - before))
    assert out[0][3] == -(-n // 96) and out[1][3] == 0
    assert torch.equal(out[0][1], out[1][1]) and out[0][2] == out[1][2] == 0
    assert rel(out[0][0], out[1][0]) < 1e-4


def test_hesv_on_card_matches_cpu(cuda):
    """hesv at n=600, nb=128 (ragged): K10 on every live panel on the
    card, its plain version on the CPU; equal pivots, both residuals
    within 10·n·2⁻²⁴, and X within the forward error bound n·2⁻²⁴·κ(A)
    of the CPU's (1.1e-3 apart measured on an H100: a random symmetric
    A has eigenvalues near zero)."""
    n, nb = 600, 128
    rng = np.random.default_rng(13)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = (g + g.T) / 2
    b = rng.standard_normal((n, 3)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        before = K.LAUNCHES["panel_plu_pallas"]
        X, (L, FT, piv), info = st.hesv(
            st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
            st.Matrix.from_dense(b, nb=nb, grid=grid))
        x = X.to_dense().cpu()
        xd = x.double().numpy()
        r = np.linalg.norm(a @ xd - b) / (np.linalg.norm(a)
                                          * np.linalg.norm(xd))
        assert r <= 10 * n * 2.0 ** -24, r
        out.append((x, piv.cpu(), int(info),
                    K.LAUNCHES["panel_plu_pallas"] - before))
    assert out[0][3] == -(-n // nb) - 1 and out[1][3] == 0
    assert torch.equal(out[0][1], out[1][1]) and out[0][2] == out[1][2] == 0
    assert rel(out[0][0], out[1][0]) < n * 2.0 ** -24 * np.linalg.cond(a)


# ---------------------------------------------------------------------------
# precision tiers and mixed-precision solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["mxu_bf16", "bf16_3x", "bf16_6x"])
@pytest.mark.parametrize("m,n,k", [(32, 96, 96), (4096, 4096, 64),
                                   (70, 130, 1)])
def test_rank_k_tail_kernel_at_tier(cuda, tier, m, n, k):
    """K11 at each tier against its plain version (the same rounding of
    the operands at mxu_bf16) and, at β = 0, against the f64 product
    within the tier's product bound (TIER_EPS-based, plus k·2⁻²⁴)."""
    from slate_tpu_torch.internal.precision import product_bound
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    c = torch.randn(m, n, generator=gen, device=cuda)
    a = torch.randn(m, k, generator=gen, device=cuda)
    b = torch.randn(k, n, generator=gen, device=cuda)
    before = K.LAUNCHES["rank_k_tail_pallas"]
    out = K.rank_k_tail(c, a, b, -1.0, 1.0, tier)
    assert rel(out, K.rank_k_tail_plain(c, a, b, -1.0, 1.0, tier)) < TOL
    prod = K.rank_k_tail(c, a, b, 1.0, 0.0, tier)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rank_k_tail_pallas"] == before + 2
    ref = a.double() @ b.double()
    err = ((prod.double() - ref).abs() / (a.double().abs()
                                          @ b.double().abs())).max()
    assert float(err) <= product_bound(tier, k)


@pytest.mark.parametrize("tier", ["mxu_bf16", "bf16_3x", "bf16_6x"])
def test_tier_product_bound_on_card(cuda, tier):
    """Each tier's product on the card against the f64 one, at k = 1 and
    k = 512, out of place and in place into a view (TF32 left as the
    caller had it)."""
    from slate_tpu_torch.internal import precision as P
    gen = torch.Generator(device=cuda).manual_seed(5)
    prev = torch.backends.cuda.matmul.allow_tf32
    for k in (1, 512):
        a = torch.randn(1024, k, generator=gen, device=cuda)
        b = torch.randn(k, 768, generator=gen, device=cuda)
        ref = a.double() @ b.double()
        den = a.double().abs() @ b.double().abs()
        out = torch.zeros(1024, 800, device=cuda)
        P.tier_addmm_(out[:, 16:784], a, b, beta=0.0, tier=tier)
        for x in (P.tier_mm(a, b, tier), out[:, 16:784]):
            err = float(((x.double() - ref).abs() / den).max())
            assert err <= P.product_bound(tier, k), (k, err)
        assert not out[:, :16].any() and not out[:, 784:].any()
    assert torch.backends.cuda.matmul.allow_tf32 == prev


@pytest.mark.parametrize("solver", ["gesv_mixed", "posv_mixed"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_mixed_solve_on_card(cuda, solver, dt):
    """gesv_mixed / posv_mixed at n = 512 on the card: info 0, no
    fallback, iters below MaxIterations, the backward error at the
    working precision (f32: 100·ε; f64: residual/‖b‖ ≤ 1e-12)."""
    from slate_tpu_torch.linalg import mixed
    n, nb = 512, 128
    gen = torch.Generator(device=cuda).manual_seed(7)
    g = torch.randn(n, n, generator=gen, device=cuda, dtype=torch.float64)
    a = (g @ g.T / n + torch.eye(n, device=cuda, dtype=torch.float64)
         if solver == "posv_mixed" else 0.01 * g
         + n ** 0.5 * torch.eye(n, device=cuda, dtype=torch.float64)).to(dt)
    b = torch.randn(n, 4, generator=gen, device=cuda,
                    dtype=torch.float64).to(dt)
    grid = st.Grid(1, 1, device=cuda)
    cls = st.HermitianMatrix if solver == "posv_mixed" else st.Matrix
    X, iters, info = getattr(st, solver)(
        cls.from_dense(a, nb=nb, grid=grid),
        st.Matrix.from_dense(b, nb=nb, grid=grid))
    assert int(info) == 0 and not mixed.used_fallback() and iters < 30
    x = X.to_dense().double()
    a64, b64 = a.double(), b.double()
    r = torch.linalg.norm(a64 @ x - b64)
    if dt == torch.float64:
        assert float(r / torch.linalg.norm(b64)) < 1e-12
    else:
        err = r / (torch.linalg.norm(a64) * torch.linalg.norm(x) * n)
        assert float(err) < 100 * 2.0 ** -23


# ---------------------------------------------------------------------------
# Level-3 and band BLAS, band Cholesky, hegv
# ---------------------------------------------------------------------------

def _launch_delta(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_pbsv_on_card_matches_cpu(cuda, uplo):
    """pbsv at n = 1000, kd = 32 (band block 32, 32 block columns): K1
    and K2 once a block column, K3 once a block of the forward solve on
    the card and none on the CPU; equal info, X within 1e-5 of the
    CPU's, the residual within 10·n·2⁻²⁴."""
    n, kd = 1000, 32
    rng = np.random.default_rng(21)
    g = rng.standard_normal((n, n))
    i, j = np.indices((n, n))
    band = np.where(np.abs(i - j) <= kd, g @ g.T / n, 0) + 3 * np.eye(n)
    stored = (np.tril(band) if uplo == "Lower" else np.triu(band))
    b = rng.standard_normal((n, 8)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        before = dict(K.LAUNCHES)
        X, L, info = st.pbsv(st.HermitianBandMatrix.from_dense(
            stored.astype(np.float32), nb=256, grid=grid, kl=kd, ku=kd,
            uplo=st.Uplo[uplo]), st.Matrix.from_dense(b, nb=256, grid=grid))
        out.append((X.to_dense().cpu(), int(info), _launch_delta(before)))
    nt = -(-n // 32)
    assert out[0][2] == {"potrf_tile": nt, "trsm_right_lower_t": nt,
                         "trsm_left_lower": nt} and out[1][2] == {}
    assert out[0][1] == out[1][1] == 0
    assert rel(out[0][0], out[1][0]) < TOL
    x = out[0][0].double().numpy()
    assert (np.linalg.norm(band @ x - b) / (np.linalg.norm(band)
                                           * np.linalg.norm(x))
            <= 10 * n * 2.0 ** -24)


def test_band_blas_on_card_matches_cpu(cuda):
    """gbmm, hbmm on both sides and tbsm on both sides (lower, upper and
    with pivots) at n = 700, kl = ku = 16, storage nb = 128: card and CPU
    within 1e-5; the lower left tbsm takes K3 once a band block."""
    n, kd, nrhs, nb = 700, 16, 8, 128
    rng = np.random.default_rng(22)
    i, j = np.indices((n, n))
    a = np.where(np.abs(i - j) <= kd, rng.standard_normal((n, n)), 0)
    h = (a + a.T) / 2
    t = np.where((i - j >= 0) & (i - j <= kd), a, 0) + n * np.eye(n)
    b = rng.standard_normal((n, nrhs))
    piv = np.minimum(np.arange(n) + rng.integers(0, 3, n), n - 1)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)

        def M(x, cls=st.Matrix, **kw):
            return cls.from_dense(x.astype(np.float32), nb=nb, grid=grid,
                                  **kw)

        A = M(a, st.BandMatrix, kl=kd, ku=kd)
        H = M(np.tril(h), st.HermitianBandMatrix, kl=kd, ku=kd)
        T = M(t, st.TriangularBandMatrix, kl=kd, ku=0)
        U = M(t.T.copy(), st.TriangularBandMatrix, kl=0, ku=kd,
              uplo=st.Uplo.Upper)
        B, Bt = M(b), M(b.T.copy())
        p = torch.from_numpy(piv.astype(np.int32)).reshape(-1, 1).to(dev)
        C, Ct = (st.Matrix.zeros(n, nrhs, nb, grid),
                 st.Matrix.zeros(nrhs, n, nb, grid))
        before = dict(K.LAUNCHES)
        res = [st.gbmm(1.0, A, B, 0.0, C),
               st.hbmm(st.Side.Left, 1.0, H, B, 0.0, C),
               st.hbmm(st.Side.Right, 1.0, H, Bt, 0.0, Ct),
               st.tbsm(st.Side.Left, 1.0, T, B),
               st.tbsm(st.Side.Left, 1.0, U, B),
               st.tbsm(st.Side.Right, 1.0, T, Bt),
               st.tbsm(st.Side.Left, 1.0, T, B, pivots=p)]
        out.append(([r.to_dense().cpu() for r in res], _launch_delta(before)))
    assert out[0][1] == {"trsm_left_lower": 2 * -(-n // 16)}
    assert out[1][1] == {}
    for x, y in zip(out[0][0], out[1][0]):
        assert rel(x, y) < TOL


def test_blas3_on_card_matches_cpu(cuda):
    """hemm, symm, her2k, syr2k and trmm at n = 600, nb = 256 on the card
    against the CPU within 1e-5; no kernel of the port runs (one gemm
    each)."""
    n, k, nb = 600, 40, 256
    rng = np.random.default_rng(23)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        B = st.Matrix.from_dense(b, nb=nb, grid=grid)
        Bt = st.Matrix.from_dense(b.T.copy(), nb=nb, grid=grid)
        C = st.Matrix.zeros(n, k, nb, grid)
        Ct = st.Matrix.zeros(k, n, nb, grid)
        H = st.HermitianMatrix.from_dense(a, nb=nb, grid=grid,
                                          uplo=st.Uplo.Upper)
        S = st.SymmetricMatrix.from_dense(a, nb=nb, grid=grid)
        T = st.TriangularMatrix.from_dense(a, nb=nb, grid=grid,
                                           diag=st.Diag.Unit)
        G = st.HermitianMatrix.zeros(n, n, nb, grid)
        before = dict(K.LAUNCHES)
        res = [st.hemm(st.Side.Left, 1.0, H, B, 0.0, C),
               st.symm(st.Side.Right, 1.0, S, Bt, 0.0, Ct),
               st.her2k(1.0, B, B, 0.0, G),
               st.syr2k(1.0, B, B, 0.0, G),
               st.trmm(st.Side.Left, 1.0, T, B),
               st.trmm(st.Side.Right, 1.0, st.transpose(T), Bt)]
        out.append(([r.to_dense().cpu() for r in res], _launch_delta(before)))
    assert out[0][1] == out[1][1] == {}
    for x, y in zip(out[0][0], out[1][0]):
        assert rel(x, y) < TOL


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_on_card_matches_cpu(cuda, itype):
    """hegv at n = 384, nb = 128 by the two-stage DC heev (EigBand 32) on
    the card against the CPU: λ within 10·n·2⁻²⁴·‖A‖₂·κ(B), equal info;
    K1 3 and K2 2 (potrf of B), K3 3 for itype 1 (hegst's left solve),
    K8 once."""
    n, nb = 384, 128
    rng = np.random.default_rng(24 + itype)
    g = rng.standard_normal((n, n))
    a = ((g + g.T) / 2).astype(np.float32)
    g2 = rng.standard_normal((n, n))
    bm = (g2 @ g2.T / n + np.eye(n)).astype(np.float32)
    opts = {st.Option.MethodEig: st.MethodEig.DC, st.Option.EigBand: 32}
    out = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        before = dict(K.LAUNCHES)
        lam, Z, info = st.hegv(itype, st.HermitianMatrix.from_dense(
            a, nb=nb, grid=grid), st.HermitianMatrix.from_dense(
            bm, nb=nb, grid=grid), opts)
        out.append((lam.cpu().double(), int(info), _launch_delta(before)))
    expect = {"potrf_tile": 3, "trsm_right_lower_t": 2, "hb2st_vmem": 1}
    if itype == 1:
        expect["trsm_left_lower"] = 3
    assert out[0][2] == expect and out[1][2] == {}
    assert out[0][1] == out[1][1] == 0
    a64, b64 = a.astype(np.float64), bm.astype(np.float64)
    bound = (10 * n * 2.0 ** -24 * np.linalg.norm(a64, 2)
             * np.linalg.cond(b64))
    assert float((out[0][0] - out[1][0]).abs().max()) <= bound


def _tridiag(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    d = np.floor(np.arange(n) / 16.0) + 1e-7 * rng.standard_normal(n)
    return d, 1e-5 * rng.standard_normal(n - 1)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,n", [("random", 300), ("clustered", 256),
                                    ("random", 1)])
def test_stein_kernel_matches_plain(cuda, dt, kind, n):
    """K12 against its plain version on the card: equal bits up to the
    final 2-norm (summed in double by the kernel, in the working type by
    torch), so within 16 units of the last place after it; one launch a
    call; the overflow rescue (an exact eigenvalue as a shift, rows of
    100s) gives the plain version's finite column."""
    from slate_tpu_torch.linalg import stein as S
    from slate_tpu_torch.linalg.eig import sterf
    d, e = _tridiag(max(n, 2), kind, n)
    d, e = d[:n], e[:n - 1]
    lam = sterf(d, e) if n > 1 else d.copy()
    lam_p, _, _ = S.shifts(d, e, lam, dt)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x0 = torch.empty((n, n), dtype=dt, device=cuda).uniform_(
        0.5, 1.0, generator=gen)
    args = [torch.tensor(v, dtype=dt, device=cuda) for v in (d, e, lam_p)]
    before = dict(K.LAUNCHES)
    out = K.stein_iter(*args, x0, 2)
    torch.cuda.synchronize()
    assert _launch_delta(before) == {"stein": 1}
    ref = K.stein_iter_plain(*args, x0, 2)
    eps = torch.finfo(dt).eps
    assert float((out - ref).abs().max()) <= 16 * eps
    t = [torch.tensor(v, dtype=dt, device=cuda) for v in ([2.0, 2.0], [1.0],
                                                           [1.0, 3.0])]
    xb = torch.tensor([[100.0, 0.75], [300.0, 0.5]], dtype=dt, device=cuda)
    kb, pb = K.stein_iter(*t, xb, 2), K.stein_iter_plain(*t, xb, 2)
    assert bool(torch.isfinite(kb).all())
    assert float((kb - pb).abs().max()) <= 16 * eps


def test_heev_qr_stein_on_card_matches_cpu(cuda):
    """heev(MethodEig.QR) at n = 640, EigBand 64 on the card: K8 and K12
    once each; λ within 10·n·2⁻²⁴·‖A‖₂ of the CPU's, Z's residual and
    orthogonality within 10·n·2⁻²⁴."""
    n = 640
    rng = np.random.default_rng(31)
    g = rng.standard_normal((n, n))
    a = ((g + g.T) / 2).astype(np.float32)
    opts = {st.Option.MethodEig: st.MethodEig.QR, st.Option.EigBand: 64}
    out = []
    for dev in (cuda, "cpu"):
        before = dict(K.LAUNCHES)
        lam, Z = st.heev(st.HermitianMatrix.from_dense(
            a, nb=64, grid=st.Grid(1, 1, device=dev)), opts)
        out.append((lam.cpu().double().numpy(),
                    Z.to_dense().cpu().double().numpy(),
                    _launch_delta(before)))
    assert out[0][2] == {"hb2st_vmem": 1, "stein": 1} and out[1][2] == {}
    bound = 10 * n * 2.0 ** -24
    a64 = a.astype(np.float64)
    assert np.abs(out[0][0] - out[1][0]).max() <= bound * np.linalg.norm(
        a64, 2)
    lam, z = out[0][:2]
    assert np.linalg.norm(a64 @ z - z * lam) / np.linalg.norm(a64) <= bound
    assert np.linalg.norm(z.T @ z - np.eye(n)) / n <= bound


def test_plu_panel_tournament_on_card_matches_cpu(cuda, monkeypatch):
    """plu_panel above H_MAX (shrunk to 1024) on the card: K4 on each
    1024-row chunk and on the final round, against the CPU's plain
    versions: equal pivots, mask and info, values within 1e-4; a zero
    column gives the same info and zero multipliers."""
    from slate_tpu_torch.internal import panel_plu as pp
    monkeypatch.setattr(pp, "H_MAX", 1024)
    rng = np.random.default_rng(32)
    h = 2560
    sub = rng.standard_normal((h, pp.W)).astype(np.float32)
    sub[:, 9] = 0.0
    act = np.ones(h, np.float32)
    act[rng.choice(h, 300, replace=False)] = 0.0
    out = []
    for dev in (cuda, "cpu"):
        before = dict(K.LAUNCHES)
        res = pp.plu_panel(torch.tensor(sub, device=dev),
                           torch.tensor(act, device=dev))
        out.append([r.cpu() for r in res] + [_launch_delta(before)])
    assert out[0][4] == {"plu_call_folded": 3, "transpose_fold": 3,
                         "unfold_transpose": 3, "plu_call": 1,
                         "transpose_tiled": 2}
    assert out[1][4] == {}
    for i in (1, 2, 3):
        assert torch.equal(out[0][i], out[1][i])
    assert int(out[0][3]) == 1
    assert float((out[0][0] - out[1][0]).abs().max()) < 1e-4
    lu_rows = out[0][0][out[0][1].long()]
    zcol = (torch.diagonal(lu_rows.triu()) == 0).nonzero().flatten()
    rows = out[0][2] > 0
    assert zcol.numel() == 1 and bool((out[0][0][rows][:, zcol] == 0).all())


def test_dense_inplace_on_card_matches_cpu(cuda):
    """getrf_dense_inplace and potrf_dense_inplace at n = 1024, nb = 256 on
    the card against the CPU: the same storage back, equal pivots and
    info, factors within 1e-4 relative."""
    n, nb = 1024, 256
    rng = np.random.default_rng(33)
    a = rng.standard_normal((n, n)).astype(np.float32)
    s = (a @ a.T / n + np.eye(n)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        t = torch.tensor(a, device=dev)
        lu, piv, info = st.getrf_dense_inplace(t, nb=nb)
        c = torch.tensor(s, device=dev)
        l, cinfo = st.potrf_dense_inplace(c, nb=nb)
        assert lu is t and l is c
        out.append((lu.cpu(), piv.cpu(), int(info), l.tril().cpu(),
                    int(cinfo)))
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] == 0 and out[0][4] == out[1][4] == 0
    assert rel(out[0][0], out[1][0]) < 1e-4 and rel(out[0][3], out[1][3]) < TOL


def test_lapack_shims_on_card_match_cpu(cuda):
    """One shim a family on the card (``default_grid()``) against the
    same shim on the CPU: equal info and pivots, results within 1e-4
    relative (float32) or 1e-10 (float64)."""
    from slate_tpu_torch import lapack_api as la
    cpu = st.Grid(1, 1, device="cpu")
    n, nb = 256, 64
    rng = np.random.default_rng(34)
    a = rng.standard_normal((n, n))
    s = a @ a.T / n + np.eye(n)
    b = rng.standard_normal((n, 4))
    tall = rng.standard_normal((2 * n, n // 2))
    calls = {
        "sgesv": lambda **k: la.slate_sgesv(a, b, nb, **k),
        "dposv": lambda **k: la.slate_dposv("L", s, b, nb, **k),
        "sgetrf": lambda **k: la.slate_sgetrf(a, nb, **k),
        "sgels": lambda **k: la.slate_sgels(tall, tall[:, :3], nb, **k),
        "dgemm": lambda **k: la.slate_dgemm("n", "t", 1.0, a, a, 0.5, s, nb,
                                            **k),
        "slange": lambda **k: la.slate_slange("F", a, nb, **k),
        "ssyev": lambda **k: la.slate_ssyev("N", "L", s, nb, **k),
        "sgesvd": lambda **k: la.slate_sgesvd("N", "N", tall, nb, **k),
        "dgesv_mixed": lambda **k: la.slate_dgesv_mixed(s, b, nb, **k),
    }
    for name, call in calls.items():
        got, want = call(), call(grid=cpu)
        tol = 1e-10 if name[0] == "d" else 1e-4
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            if isinstance(x, np.ndarray) and x.dtype.kind == "f":
                assert rel(torch.from_numpy(x),
                           torch.from_numpy(y)) < tol, name
            elif isinstance(x, float):
                assert abs(x - y) <= tol * abs(y), name
            else:
                assert np.array_equal(x, y), name


@pytest.mark.parametrize("zero_cols", [(100,), (100, 101), (0, 300)],
                         ids=lambda c: "-".join(map(str, c)))
def test_singular_dense_getrf_on_card_matches_cpu(cuda, zero_cols):
    """The dense path (n = 512, nb = 64, the shim's default) on a matrix
    with zero columns: the same info, one a zero column, and the same
    pivots on the card and the CPU (a panel with an exact zero pivot is
    factored again by dgetf2, whatever the solver did after it)."""
    from slate_tpu_torch import lapack_api as la
    rng = np.random.default_rng(35)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    a[:, list(zero_cols)] = 0.0
    b = rng.standard_normal((512, 2)).astype(np.float32)
    cpu = st.Grid(1, 1, device="cpu")
    assert la.slate_sgesv(a, b)[1] == la.slate_sgesv(a, b, grid=cpu)[1] \
        == len(zero_cols)
    lu, piv, info = la.slate_sgetrf(a)
    lu_c, piv_c, info_c = la.slate_sgetrf(a, grid=cpu)
    assert info == info_c == len(zero_cols)
    assert np.array_equal(piv, piv_c)
    assert rel(torch.from_numpy(lu), torch.from_numpy(lu_c)) < 1e-4


def crel(x, ref):
    x, ref = (torch.as_tensor(t).to(torch.complex128).cpu() for t in (x, ref))
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def cbackward(a, x, b):
    """‖A·X − B‖_F/(‖A‖_F·‖X‖_F) in complex128 on the operands' device."""
    a, x, b = (t.to(torch.complex128) for t in (a, x, b))
    return float(torch.linalg.norm(a @ x - b)
                 / (torch.linalg.norm(a) * torch.linalg.norm(x)))


def complex_solves(dev, dt, n=192, nb=32):
    """posv, gesv, gesv_nopiv, gels (B = A·X₀), hesv, gbsv, pbsv and hegst
    itype 1 in ``dt`` on ``dev``: their backward errors (hegst's
    ‖L·C·Lᴴ − A‖_F/(‖L‖²_F·‖C‖_F)), their infos and their pivots. The
    inputs come from one CPU seed, so both devices solve the same
    systems."""
    gen = torch.Generator().manual_seed(93)
    g = torch.randn(n, n, generator=gen, dtype=dt)
    h = (g + g.mH) / 2
    hpd = h + 4 * n ** 0.5 * torch.eye(n, dtype=dt)
    b = torch.randn(n, 3, generator=gen, dtype=dt)
    x0 = torch.randn(n // 2, 3, generator=gen, dtype=dt)
    i = torch.arange(n)
    band = torch.where((i[None] - i[:, None]).abs() <= 5, g, 0)
    hband = torch.where((i[None] - i[:, None]).abs() <= 5, hpd, 0)
    dom = g + n * torch.eye(n, dtype=dt)
    tall = g[:, :n // 2]
    b4 = (tall.to(torch.complex128) @ x0.to(torch.complex128)).to(dt)
    g, h, hpd, b, band, hband, dom, tall, b4 = (
        t.to(dev) for t in (g, h, hpd, b, band, hband, dom, tall, b4))
    grid = st.Grid(1, 1, device=dev)
    M = lambda t, cls=st.Matrix, **kw: cls.from_dense(t, nb=nb, grid=grid,
                                                      **kw)
    B = M(b)
    X1, _, i1 = st.posv(M(hpd, st.HermitianMatrix), B)
    X2, _, piv, i2 = st.gesv(M(g), B)
    X3, _, i3 = st.gesv_nopiv(M(dom), B)
    X4 = st.gels(M(tall), M(b4))
    X5, (_, _, hp), i5 = st.hesv(M(h.tril(), st.HermitianMatrix), B)
    X6, _, bp, i6 = st.gbsv(M(band, st.BandMatrix, kl=5, ku=5), B)
    X7, _, i7 = st.pbsv(M(hband.tril(), st.HermitianBandMatrix, kl=5,
                          ku=5), B)
    L, _ = st.potrf(M(hpd, st.HermitianMatrix))
    c = st.hegst(1, M(h, st.HermitianMatrix), L).to_dense()
    l = L.to_dense().tril().to(torch.complex128)
    res = [cbackward(a, X.to_dense(), r) for a, X, r in (
        (hpd, X1, b), (g, X2, b), (dom, X3, b), (tall, X4, b4), (h, X5, b),
        (band, X6, b), (hband, X7, b))]
    res.append(float(torch.linalg.norm(l @ c.to(torch.complex128) @ l.mH - h)
                     / (torch.linalg.norm(l) ** 2 * torch.linalg.norm(c))))
    assert all(X.dtype == dt for X in (X1, X2, X3, X4, X5, X6, X7)) and \
        c.dtype == dt
    ints = [int(v) for v in (i1, i2, i3, i5, i6, i7)]
    return res, ints, [p.cpu() for p in (piv, hp, bp)]


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
def test_complex_solvers_on_card_match_cpu(cuda, dt):
    """posv, gesv (pivots), gesv_nopiv, gels, hesv, gbsv, pbsv and hegst
    in complex on the card with the caller's TF32 on, against the same
    solves on the CPU: no kernel launched, equal info and pivots, and on
    each device every backward error within n·u (n = 192; u = 2⁻²⁴
    complex64, 2⁻⁵³ complex128)."""
    from slate_tpu_torch.internal.precision import tf32_matmul
    n = 192
    u = 2.0 ** -24 if dt == torch.complex64 else 2.0 ** -53
    before = dict(K.LAUNCHES)
    with tf32_matmul():
        res, ints, pivs = complex_solves(cuda, dt, n)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before
    res_c, ints_c, pivs_c = complex_solves("cpu", dt, n)
    assert ints == ints_c == [0] * 6
    for p, q in zip(pivs, pivs_c):
        assert torch.equal(p, q)
    assert max(res) <= n * u and max(res_c) <= n * u, (res, res_c)


def test_complex64_gemm_pins_fp32_on_card(cuda):
    """The port's complex64 gemm with the caller's TF32 on stays within
    16·√k·2⁻²⁴ of the complex128 product (a TF32 product does not)."""
    from slate_tpu_torch.internal.precision import tf32_matmul
    grid = st.Grid(1, 1)
    gen = torch.Generator(device=cuda).manual_seed(94)
    a = torch.randn(2048, 2048, generator=gen, device=cuda,
                    dtype=torch.complex64)
    b = torch.randn(2048, 256, generator=gen, device=cuda,
                    dtype=torch.complex64)
    ref = a.to(torch.complex128) @ b.to(torch.complex128)
    C = st.Matrix.zeros(2048, 256, 256, grid, dtype=torch.complex64)
    with tf32_matmul():
        out = st.gemm(1.0, st.Matrix.from_dense(a, nb=256, grid=grid),
                      st.Matrix.from_dense(b, nb=256, grid=grid), 0.0,
                      C).to_dense()
    assert crel(out, ref) <= 16 * 2048 ** 0.5 * 2.0 ** -24


def test_generator_on_card_matches_cpu(cuda):
    """The uniform and binary random kinds are the same bits on the card
    and the CPU; randn and the formula kinds agree within 8·2⁻²⁴ of the
    largest entry."""
    from slate_tpu_torch.utils.generator import FORMULA_KINDS
    cpu = st.Grid(1, 1, device="cpu")
    for kind in FORMULA_KINDS + ("rand", "rands", "randn", "randb",
                                 "randr"):
        x = st.generate_matrix(kind, 300, 200, nb=64, grid=st.Grid(1, 1),
                               seed=9).to_dense().cpu()
        y = st.generate_matrix(kind, 300, 200, nb=64, grid=cpu,
                               seed=9).to_dense()
        if kind in ("rand", "rands", "randb", "randr"):
            assert torch.equal(x, y), kind
        else:
            assert float((x - y).abs().max()) <= 8 * 2.0 ** -24 * max(
                float(y.abs().max()), 1e-30), kind


@pytest.mark.parametrize("p,q", [(2, 2), (2, 4)])
def test_pq_posv_gesv_on_card_match_cpu(cuda, p, q):
    """posv and gesv on a p×q grid of virtual ranks: the card (K1, K2,
    K3, K10) against the CPU (their plain versions), pivots equal, the
    factors and posv's X within 10·n·2⁻²⁴, gesv's residual on the card
    within 10·n·2⁻²⁴ (its X is as far apart as κ(A) makes it)."""
    n, nb = 512, 128
    gen = torch.Generator().manual_seed(p * 10 + q)
    a = torch.randn(n, n, generator=gen)
    s = a @ a.T / n + torch.eye(n)
    b = torch.randn(n, 3, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        g = st.Grid(p, q, device=dev)
        X, L, info = st.posv(st.HermitianMatrix.from_dense(s, nb=nb, grid=g),
                             st.Matrix.from_dense(b, nb=nb, grid=g))
        Y, LU, piv, linfo = st.gesv(st.Matrix.from_dense(a, nb=nb, grid=g),
                                    st.Matrix.from_dense(b, nb=nb, grid=g))
        out[dev] = (X.to_dense(), torch.tril(L.to_dense()), int(info),
                    Y.to_dense(), LU.to_dense(), piv.cpu(), int(linfo))
    c, h = out["cuda"], out["cpu"]
    bound = 10 * n * 2.0 ** -24
    assert c[2] == h[2] == 0 and c[6] == h[6] == 0
    assert torch.equal(c[5], h[5])
    for i in (0, 1, 4):
        assert rel(c[i], h[i]) < bound, i
    y = c[3].cpu().double()
    r = torch.linalg.norm(a.double() @ y - b.double()) / (
        torch.linalg.norm(a.double()) * torch.linalg.norm(y))
    assert float(r) < bound


@pytest.mark.parametrize("kind", ["posv", "gesv", "gesv_nopiv"])
def test_pq_depths_bitwise_on_card(cuda, kind):
    """``Option.PipelineDepth`` 0, 1 and 2 give the same bits on the card
    (factors, pivots, X): the port runs one schedule at every depth, and
    its kernels and cuBLAS products repeat their bits run to run."""
    n, nb = 1024, 128
    gen = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(n, n, generator=gen, device=cuda)
    if kind == "posv":
        a = a @ a.T / n + torch.eye(n, device=cuda)
    elif kind == "gesv_nopiv":
        a = a + n * torch.eye(n, device=cuda)
    b = torch.randn(n, 4, generator=gen, device=cuda)
    g = st.Grid(2, 4)
    cls = st.HermitianMatrix if kind == "posv" else st.Matrix
    outs = []
    for depth in (0, 1, 2):
        out = getattr(st, kind)(cls.from_dense(a, nb=nb, grid=g),
                                st.Matrix.from_dense(b, nb=nb, grid=g),
                                {st.Option.PipelineDepth: depth})
        outs.append([getattr(o, "data", o) for o in out])
    for other in outs[1:]:
        for u, v in zip(outs[0], other):
            assert torch.equal(u, v)


def _normal_residual(a, x, b):
    """‖Aᴴ(A·X − B)‖_F / (‖A‖_F·(‖A‖_F·‖X‖_F + ‖B‖_F)) in f64."""
    a, x, b = a.double().cpu(), x.double().cpu(), b.double().cpu()
    an = torch.linalg.norm(a)
    return float(torch.linalg.norm(a.mT @ (a @ x - b))
                 / (an * (an * torch.linalg.norm(x) + torch.linalg.norm(b))))


def test_pq_gels_heev_gesvd_on_card_match_cpu(cuda):
    """gels by each branch, heev with vectors and gesvd with U and Vᴴ on
    a 2×4 grid at n = 512, nb = 64 on the card and on the CPU: the normal
    residuals, λ and σ within 10·m·2⁻²⁴ of each other relative to the
    largest, the vectors by their residuals on the card."""
    m, n, nb = 1024, 512, 64
    gen = torch.Generator().manual_seed(24)
    a = torch.randn(m, n, generator=gen)
    b = torch.randn(m, 3, generator=gen)
    s = torch.randn(n, n, generator=gen)
    s = (s + s.T) / 2
    bound = 10 * m * 2.0 ** -24
    Gels = st.MethodGels
    out = {}
    for dev in ("cuda", "cpu"):
        g = st.Grid(2, 4, device=dev)
        mk = lambda x: st.Matrix.from_dense(x, nb=nb, grid=g)  # noqa: E731
        xs = [st.gels(mk(a), mk(b), {st.Option.MethodGels: r}).to_dense()
              for r in (Gels.Geqrf, Gels.Cholqr)]
        xs.append(st.gels(mk(a.T.contiguous()), mk(b[:n])).to_dense())
        opts = {st.Option.EigBand: nb}
        lam, Z = st.heev(st.HermitianMatrix.from_dense(s, nb=nb, grid=g),
                         opts)
        sv, U, VT = st.gesvd(mk(a), opts, True, True)
        out[dev] = (xs, lam.double().cpu(), Z.to_dense().double().cpu(),
                    sv.double().cpu(), U.to_dense().double().cpu(),
                    VT.to_dense().double().cpu())
    c, h = out["cuda"], out["cpu"]
    for i in range(2):
        assert _normal_residual(a, c[0][i], b) <= bound, i
        assert rel(c[0][i], h[0][i]) <= 1e-3, i
    at, x = a.T.double(), c[0][2].double().cpu()
    r = torch.linalg.norm(at @ x - b[:n].double()) / (
        torch.linalg.norm(at) * torch.linalg.norm(x)
        + torch.linalg.norm(b[:n].double()))
    assert float(r) <= bound
    lam, z, sv, u, vt = c[1:]
    assert (lam - h[1]).abs().max() <= bound * h[1].abs().max()
    assert (sv - h[3]).abs().max() <= bound * h[3][0]
    s64, a64 = s.double(), a.double()
    assert torch.linalg.norm(s64 @ z - z * lam) <= bound * torch.linalg.norm(
        s64)
    assert torch.linalg.norm(a64 - (u * sv) @ vt) <= bound * \
        torch.linalg.norm(a64)


def test_pq_chase_launches_per_call(cuda):
    """One K8 launch per p×q heev (values, vectors) and hegv, one K9 per
    p×q gesvd, on 2×4 at n = 512, nb = 64; hegv itype 1 also runs K1 and
    K2 once a step (B's factor) and K3 once a step in each grid column
    (hegst's left solve of A's columns)."""
    n, nb, q = 512, 64, 4
    nt = n // nb
    gen = torch.Generator(device=cuda).manual_seed(25)
    s = torch.randn(n, n, generator=gen, device=cuda)
    s = (s + s.T) / 2
    w = torch.randn(n, n, generator=gen, device=cuda)
    spd = w @ w.T / n + torch.eye(n, device=cuda)
    g = st.Grid(2, q)
    H = st.HermitianMatrix.from_dense(s, nb=nb, grid=g)
    opts = {st.Option.EigBand: nb}
    one = {"hb2st_vmem": 1}
    for label, fn, want in (
            ("values", lambda: st.eig_vals(H, opts), one),
            ("vectors", lambda: st.heev(H, opts), one),
            ("hegv", lambda: st.hegv(1, H, st.HermitianMatrix.from_dense(
                spd, nb=nb, grid=g), opts),
             {"hb2st_vmem": 1, "potrf_tile": nt,
              "trsm_right_lower_t": nt - 1, "trsm_left_lower": nt * q}),
            ("gesvd", lambda: st.svd_vals(st.Matrix.from_dense(
                w, nb=nb, grid=g), opts), {"tb2bd_vmem": 1})):
        torch.cuda.synchronize()
        K.reset_launches()
        fn()
        torch.cuda.synchronize()
        expect = {**dict.fromkeys(K.LAUNCHES, 0), **want}
        assert dict(K.LAUNCHES) == expect, (label, dict(K.LAUNCHES))


@pytest.mark.parametrize("dt", [torch.float32, torch.complex64],
                         ids=["f32", "c64"])
def test_pq_hesv_getri_mixed_on_card_match_cpu(cuda, dt):
    """hesv, getri and gesv_mixed on a 2×4 grid at n = 512, nb = 128 on
    the card (K10, K3 in float32) and on the CPU (their plain versions;
    complex64 runs the torch ops on both): pivots and ``info`` equal, no
    fallback; A⁻¹ and gesv_mixed's X within 10·n·2⁻²⁴ of each other
    (A = G + 2√n·I, κ ≈ 3); hesv of a random Hermitian H, both
    residuals within 10·n·2⁻²⁴ and X within n·2⁻²⁴·κ(H), the bound of
    ``test_hesv_on_card_matches_cpu`` (Aasen's L and T are far worse
    conditioned than H, in the JAX package as here)."""
    from slate_tpu_torch.linalg import mixed
    n, nb = 512, 128
    gen = torch.Generator().manual_seed(26)

    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, dtype=torch.float64)
        if dt.is_complex:
            x = x + 1j * torch.randn(*shape, generator=gen,
                                     dtype=torch.float64)
        return x

    g0 = rnd(n, n)
    h = ((g0 + g0.mH) / 2).to(dt)
    a = (rnd(n, n) + 2 * n ** 0.5 * torch.eye(n)).to(dt)
    b = rnd(n, 3).to(dt)
    out = {}
    for dev in ("cuda", "cpu"):
        g = st.Grid(2, 4, device=dev)
        mk = lambda x: st.Matrix.from_dense(x, nb=nb, grid=g)  # noqa: E731
        X, (_, _, piv), info = st.hesv(
            st.HermitianMatrix.from_dense(torch.tril(h), nb=nb, grid=g),
            mk(b))
        LU, lpiv, linfo = st.getrf(mk(a))
        inv = st.getri(LU, lpiv)
        Y, iters, minfo = st.gesv_mixed(mk(a), mk(b))
        out[dev] = (X.to_dense(), piv.cpu(), int(info), inv.to_dense(),
                    lpiv.cpu(), int(linfo), Y.to_dense(), int(minfo), iters,
                    mixed.used_fallback())
    c, h_ = out["cuda"], out["cpu"]
    bound = 10 * n * 2.0 ** -24
    assert c[2] == h_[2] == 0 and c[5] == h_[5] == 0 and c[7] == h_[7] == 0
    assert torch.equal(c[1], h_[1]) and torch.equal(c[4], h_[4])
    assert not c[9] and not h_[9] and c[8] < 30 and h_[8] < 30
    z = torch.complex128
    hz, bz = h.to(z), b.to(z)

    def crel(x, ref):
        x, ref = x.cpu().to(z), ref.cpu().to(z)
        return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))

    for x in (c[0], h_[0]):
        x = x.cpu().to(z)
        assert float(torch.linalg.norm(hz @ x - bz) / (
            torch.linalg.norm(hz) * torch.linalg.norm(x))) <= bound
    kappa = float(torch.linalg.cond(hz))
    assert crel(c[0], h_[0]) <= n * 2.0 ** -24 * kappa
    assert crel(c[3], h_[3]) <= bound and crel(c[6], h_[6]) <= bound


@pytest.mark.parametrize("nb", [1024, 256, 200, 65, 1])
def test_potrf_tile_stack_matches_plain(cuda, nb):
    """K1 over a [5, nb, nb] stack in one launch against its plain version
    over the same stack; each member's bits equal its own single-tile
    launch."""
    gen = torch.Generator(device=cuda).manual_seed(nb + 5)
    g = torch.randn(5, nb, nb, generator=gen, device=cuda)
    a = g @ g.mT / nb + torch.eye(nb, device=cuda)
    before = K.LAUNCHES["potrf_tile"]
    l = K.potrf_tile(a)
    torch.cuda.synchronize()
    assert K.LAUNCHES["potrf_tile"] == before + 1
    assert rel(l, K.potrf_tile_plain(a)) < TOL
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    for i in range(5):
        assert torch.equal(l[i], K.potrf_tile(a[i]))


def test_potrf_tile_stack_failed_members_leave_batchmates(cuda):
    """A member with a NaN and a member that is not positive definite come
    out with NaN on their own diagonals only; the other members' bits
    equal their single-tile launches; a batch of one equals the 2-D
    call bit for bit."""
    nb = 256
    gen = torch.Generator(device=cuda).manual_seed(17)
    g = torch.randn(6, nb, nb, generator=gen, device=cuda)
    a = g @ g.mT / nb + torch.eye(nb, device=cuda)
    a[1, 100, 100] = float("nan")
    a[4] = -torch.eye(nb, device=cuda)
    l = K.potrf_tile(a)
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    assert not torch.isfinite(d[1]).all() and not torch.isfinite(d[4]).all()
    for i in (0, 2, 3, 5):
        assert torch.equal(l[i], K.potrf_tile(a[i]))
    assert torch.equal(K.potrf_tile(a[2:3])[0], K.potrf_tile(a[2]))


def zrel(x, ref):
    """rel in complex128, for real and complex tensors alike."""
    z = torch.complex128
    x, ref = x.cpu().to(z), ref.cpu().to(z)
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("dt", [torch.float32, torch.complex64],
                         ids=["f32", "c64"])
def test_batched_drivers_on_card_match_cpu(cuda, dt):
    """posv_batched, gesv_batched, batched_potrf/getrf/trsm on a
    [6, 256, 256] stack (nb 128) on the card (K1 over the stack in
    float32, one launch a block column) and on the CPU: ``info`` and
    ``perm`` equal, X and the factors within 10·n·2⁻²⁴ of each other,
    the backward error within 10·n·2⁻²⁴."""
    from slate_tpu_torch.serve import batched
    B, n, nb = 6, 256, 128
    gen = torch.Generator().manual_seed(41)

    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, dtype=torch.float64)
        if dt.is_complex:
            x = x + 1j * torch.randn(*shape, generator=gen,
                                     dtype=torch.float64)
        return x

    g = rnd(B, n, n)
    spd = (g @ g.mH / n + torch.eye(n)).to(dt)
    gen_a = (rnd(B, n, n) + 2 * n ** 0.5 * torch.eye(n)).to(dt)
    b = rnd(B, n, 3).to(dt)
    out = {}
    for dev in ("cuda", "cpu"):
        before = K.LAUNCHES["potrf_tile"]
        x, l, info = st.posv_batched(spd.to(dev), b.to(dev), nb=nb)
        launches = K.LAUNCHES["potrf_tile"] - before
        y, lu, perm, linfo = st.gesv_batched(gen_a.to(dev), b.to(dev), nb=nb)
        t = batched.batched_trsm(l, b.to(dev))
        out[dev] = (x, l, info, y, lu, perm, linfo, t, launches)
    c, h = out["cuda"], out["cpu"]
    assert c[8] == (n // nb if dt == torch.float32 else 0) and h[8] == 0
    assert torch.equal(c[2].cpu(), h[2]) and not h[2].any()
    assert torch.equal(c[5].cpu(), h[5]) and torch.equal(c[6].cpu(), h[6])
    bound = 10 * n * 2.0 ** -24
    for k in (0, 1, 3, 4, 7):
        assert zrel(c[k], h[k]) <= bound, k
    for a, x in ((spd, c[0]), (gen_a, c[3])):
        a, x = a.to(torch.complex128), x.cpu().to(torch.complex128)
        r = a @ x - b.to(torch.complex128)
        err = torch.linalg.norm(r, dim=(1, 2)) / (
            torch.linalg.norm(a, dim=(1, 2)) * torch.linalg.norm(x, dim=(1, 2)))
        assert float(err.max()) <= bound


@pytest.mark.parametrize("dt", [torch.float32, torch.complex64],
                         ids=["f32", "c64"])
def test_pq_band_on_card_match_cpu(cuda, dt):
    """gbsv (kl = ku = 32) and pbsv (kd = 32) at n = 1024, storage nb 256,
    on 2×4 on the card: bit for bit the 1×1 card call, and within the
    CPU's: pivots and ``info`` equal, X within n·2⁻²⁴·κ(A)."""
    n, nb, kd = 1024, 256, 32
    gen = torch.Generator().manual_seed(43)

    def rnd(*shape):
        x = torch.randn(*shape, generator=gen, dtype=torch.float64)
        if dt.is_complex:
            x = x + 1j * torch.randn(*shape, generator=gen,
                                     dtype=torch.float64)
        return x

    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    inband = (i - j).abs() <= kd
    a = torch.where(inband, rnd(n, n), 0).to(dt)
    h = torch.where(inband, rnd(n, n), 0)
    h = ((h + h.mH) / 2 + 2 * kd * torch.eye(n)).to(dt)
    b = rnd(n, 8).to(dt)
    out = {}
    for dev, (p, q) in (("cuda", (2, 4)), ("cuda", (1, 1)), ("cpu", (2, 4))):
        g = st.Grid(p, q, device=dev)
        B = st.Matrix.from_dense(b, nb=nb, grid=g)
        X, _, piv, info = st.gbsv(st.BandMatrix.from_dense(
            a, nb=nb, grid=g, kl=kd, ku=kd), B)
        Y, _, pinfo = st.pbsv(st.HermitianBandMatrix.from_dense(
            torch.tril(h), nb=nb, grid=g, kl=kd, ku=kd), B)
        out[(dev, p)] = (X.to_dense(), piv.cpu(), int(info), Y.to_dense(),
                         int(pinfo))
    c, one, h_ = out[("cuda", 2)], out[("cuda", 1)], out[("cpu", 2)]
    for k in range(5):
        assert torch.equal(torch.as_tensor(c[k]).cpu(),
                           torch.as_tensor(one[k]).cpu()), k
    assert torch.equal(c[1], h_[1]) and c[2] == h_[2] == 0 \
        and c[4] == h_[4] == 0
    z = torch.complex128
    for mat, k in ((a, 0), (h, 3)):
        kappa = float(torch.linalg.cond(mat.to(z)))
        assert zrel(c[k], h_[k]) <= n * 2.0 ** -24 * kappa
