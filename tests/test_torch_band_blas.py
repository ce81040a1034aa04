"""The port's band BLAS (gbmm, hbmm, tbsm), band Cholesky (pbtrf, pbtrs,
pbsv) and the packed band kernels under them against the JAX package on
a 1×1 grid, on the CPU, with the cases of tests/test_band.py and
tests/test_blas.py::test_gbmm.

Inputs are made with numpy from a seed and go into both packages; band
Cholesky factors cross between them as numpy arrays
(``band_chol_from_reference``/``band_chol_to_reference``). Tolerances:
products and packed storage within 1e-12 relative of the JAX package's
(f64, the same windows summed in other orders); factors, solves and
residuals within 1e-10 (the reference's own residual bounds are 1e-10
and 1e-11); f32 residuals within 10·n·2⁻²⁴. ``info`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import band as jband  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import band_packed as pband  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
NB = 8


def dense(M):
    d = M.to_dense()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def rel(x, ref):
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


def band_dense(n, kl, ku, seed, dtype=np.float64, diag_boost=None):
    """tests/test_band.py's band: Gaussian inside (kl, ku), plus
    ``diag_boost`` on the diagonal."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n)).astype(dtype)
    i, j = np.indices((n, n))
    a = np.where((j - i <= ku) & (i - j <= kl), a, 0)
    if diag_boost:
        a = a + diag_boost * np.eye(n, dtype=dtype)
    return a


def spd_band(n, kd, seed):
    """tests/test_band.py's SPD band: G·Gᵀ/n + 3I cut to |i − j| ≤ kd,
    plus 2n on the diagonal, and its right-hand sides."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    s = g @ g.T / n + 3 * np.eye(n)
    band = np.where(np.abs(np.subtract.outer(range(n), range(n))) <= kd, s, 0)
    return band + 2 * n * np.eye(n), rng.standard_normal((n, 2))


@pytest.fixture(autouse=True)
def no_launches():
    """On the CPU the kernels' plain versions run and nothing launches."""
    before = dict(K.LAUNCHES)
    yield
    assert K.LAUNCHES == before


def run_pbsv(pkg, grid, band, b, kd, uplo="Lower", view=False):
    stored = np.tril(band) if uplo == "Lower" else np.triu(band)
    A = pkg.HermitianBandMatrix.from_dense(stored, nb=NB, grid=grid, kl=kd,
                                           ku=kd, uplo=pkg.Uplo[uplo])
    if view:
        A = pkg.transpose(A)
    X, L, info = pkg.pbsv(A, pkg.Matrix.from_dense(b, nb=NB, grid=grid))
    return dense(X), L, int(info)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_pbsv_uplo(grid11, uplo):
    """X, the packed factor and info against the JAX pbsv; the residual
    within the reference's bound."""
    band, b = spd_band(45, 4, 9)
    xj, Lj, ij = run_pbsv(jst, grid11, band, b, 4, uplo)
    x, L, info = run_pbsv(pst, CPU, band, b, 4, uplo)
    assert info == ij == 0 and (L.n, L.kd) == (Lj.n, Lj.kd) == (45, 4)
    assert tuple(L.ab.shape) == tuple(Lj.ab.shape)
    assert rel(L.ab.numpy(), np.asarray(Lj.ab)) < 1e-10
    assert rel(x, xj) < 1e-10
    assert np.linalg.norm(band @ x - b) / np.linalg.norm(b) < 1e-10


def test_pbtrf_factor_dense(grid11):
    band, _ = spd_band(28, 3, 11)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        L, info = pkg.pbtrf(pkg.HermitianBandMatrix.from_dense(
            np.tril(band), nb=NB, grid=grid, kl=3, ku=3))
        assert int(info) == 0
        out.append(dense(L))
    l = out[1]
    assert rel(l, out[0]) < 1e-10
    assert not np.triu(l, 1).any() and not np.tril(l, -4).any()
    np.testing.assert_allclose(l @ l.T, band, rtol=1e-10, atol=1e-8)


def test_pbsv_transposed_view(grid11):
    """A = Aᵀ for a real symmetric band: the transposed view (Upper after
    materialize) solves the same system."""
    band, b = spd_band(30, 3, 23)
    xj, _, _ = run_pbsv(jst, grid11, band, b, 3, view=True)
    x, _, info = run_pbsv(pst, CPU, band, b, 3, view=True)
    assert info == 0 and rel(x, xj) < 1e-10
    assert np.linalg.norm(band @ x - b) / np.linalg.norm(b) < 1e-10


def test_pbtrs_on_carried_factors(grid11):
    """The port's pbtrs on the JAX factor gives the JAX X, and the JAX
    pbtrs on the port's factor the port's."""
    band, b = spd_band(45, 5, 31)
    JF, _ = jst.pbtrf(jst.HermitianBandMatrix.from_dense(
        np.tril(band), nb=NB, grid=grid11, kl=5, ku=5))
    JB = jst.Matrix.from_dense(b, nb=NB, grid=grid11)
    xj = dense(jst.pbtrs(JF, JB))
    F = pst.band_chol_from_reference(np.asarray(JF.ab), n=JF.n, kd=JF.kd,
                                     uplo=JF.uplo.name, device="cpu")
    x = dense(pst.pbtrs(F, pst.Matrix.from_dense(b, nb=NB, grid=CPU)))
    assert rel(x, xj) < 1e-12
    P, _ = pst.pbtrf(pst.HermitianBandMatrix.from_dense(
        np.tril(band), nb=NB, grid=CPU, kl=5, ku=5))
    back = pst.band_chol_to_reference(P)
    assert (back["n"], back["kd"], back["uplo"]) == (45, 5, "Lower")
    JP = jband.BandCholFactor(jnp.asarray(back["ab"]), back["n"],
                              back["kd"], jst.Uplo[back["uplo"]])
    assert rel(dense(jst.pbtrs(JP, JB)), x) < 1e-12
    with pytest.raises(pst.SlateError, match="kd"):
        pst.band_chol_from_reference(np.asarray(JF.ab)[:2], n=45, kd=5)


def test_pbtrf_not_spd_info_and_health(grid11):
    """A band whose block column 2 (1-based) is not positive definite:
    the JAX package's info, and with ``health=True`` a report that names
    the first bad block; the factorization runs to its end."""
    band, _ = spd_band(40, 4, 12)
    band[12, 12] = -500.0
    infos = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.HermitianBandMatrix.from_dense(np.tril(band), nb=NB,
                                               grid=grid, kl=4, ku=4)
        L, info = pkg.pbtrf(A)
        _, rep = pkg.pbtrf(A, health=True)
        infos.append((int(info), rep.info, rep.first_bad_tile))
        assert np.isfinite(dense(L)).all()
    assert infos[1] == infos[0] == (2, 2, (1, 1))
    # complex: the same report, as the JAX package gives it
    bandc = band + 1j * np.tril(band_dense(40, 4, 0, 14), -1)
    cinfo = [int(pkg.pbtrf(pkg.HermitianBandMatrix.from_dense(
        np.tril(bandc), nb=NB, grid=grid, kl=4, ku=4))[1])
        for pkg, grid in ((jst, grid11), (pst, CPU))]
    assert cinfo == [2, 2]


def test_pbsv_float32():
    """f32 (the card's type) to the f32 residual bound at kd = 32 (band
    block 32, the card's)."""
    n, kd = 300, 32
    band, b = spd_band(n, kd, 13)
    x, L, info = run_pbsv(pst, CPU, band.astype(np.float32),
                          b.astype(np.float32), kd)
    x = x.astype(np.float64)
    assert info == 0 and L.ab.dtype == torch.float32
    assert (np.linalg.norm(band @ x - b)
            / (np.linalg.norm(band) * np.linalg.norm(x))) < 10 * n * 2.0 ** -24


# ---------------------------------------------------------------------------
# tbsm
# ---------------------------------------------------------------------------

def run_tbsm(pkg, grid, t, b, side, kl, ku, uplo, diag="NonUnit",
             pivots=None, nb=NB):
    T = pkg.TriangularBandMatrix.from_dense(t, nb=nb, grid=grid, kl=kl,
                                            ku=ku, uplo=pkg.Uplo[uplo],
                                            diag=pkg.Diag[diag])
    B = pkg.Matrix.from_dense(b, nb=nb, grid=grid)
    alpha = 2.0 if side == "Left" else 1.0
    return dense(pkg.tbsm(pkg.Side[side], alpha, T, B, pivots))


@pytest.mark.parametrize("uplo,diag", [("Lower", "NonUnit"),
                                       ("Upper", "NonUnit"),
                                       ("Lower", "Unit")])
def test_tbsm_left(grid11, uplo, diag):
    n, kd = 40, 3
    kl, ku = (kd, 0) if uplo == "Lower" else (0, kd)
    t = band_dense(n, kl, ku, seed=12, diag_boost=n)
    if diag == "Unit":
        t[np.arange(n), np.arange(n)] = 1.0
    b = np.random.default_rng(13).standard_normal((n, 3))
    xj = run_tbsm(jst, grid11, t, b, "Left", kl, ku, uplo, diag)
    x = run_tbsm(pst, CPU, t, b, "Left", kl, ku, uplo, diag)
    assert rel(x, xj) < 1e-10
    assert np.linalg.norm(t @ x - 2.0 * b) / np.linalg.norm(b) < 1e-11


def test_tbsm_right(grid11):
    n, m, kd = 24, 16, 2
    t = band_dense(n, kd, 0, seed=14, diag_boost=n)
    b = np.random.default_rng(15).standard_normal((m, n))
    xj = run_tbsm(jst, grid11, t, b, "Right", kd, 0, "Lower")
    x = run_tbsm(pst, CPU, t, b, "Right", kd, 0, "Lower")
    assert rel(x, xj) < 1e-10
    assert np.linalg.norm(x @ t - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_tbsm_right_ragged(grid11, uplo):
    """n = 20 is not a multiple of the band block (8): the partial last
    block keeps a unit diagonal on its padding columns."""
    n, m, kd = 20, 12, 3
    t = rand(n, n, np.float64, 71) + n * np.eye(n)
    i, j = np.indices((n, n))
    if uplo == "Lower":
        tb, kl, ku = np.where((i - j <= kd) & (i >= j), t, 0.0), kd, 0
    else:
        tb, kl, ku = np.where((j - i <= kd) & (j >= i), t, 0.0), 0, kd
    b = rand(m, n, np.float64, 72)
    xj = run_tbsm(jst, grid11, tb, b, "Right", kl, ku, uplo)
    x = run_tbsm(pst, CPU, tb, b, "Right", kl, ku, uplo)
    assert np.isfinite(x).all() and rel(x, xj) < 1e-10
    assert np.linalg.norm(x @ tb - b) / np.linalg.norm(b) < 1e-11


@pytest.mark.parametrize("side", ["Left", "Right"])
def test_tbsm_with_pivots(grid11, side):
    """Pivots from gbtrf applied to B's rows first, as the JAX tbsm
    applies them (tbsmPivots)."""
    n, kd = 32, 3
    a = band_dense(n, 2, 2, seed=33, diag_boost=None)
    _, piv, _ = pst.gbtrf(pst.BandMatrix.from_dense(a, nb=NB, grid=CPU, kl=2,
                                                    ku=2))
    t = band_dense(n, kd, 0, seed=34, diag_boost=n)
    b = rand(n, n, np.float64, 35)
    jpiv = jnp.asarray(pst.pivots_to_reference(piv))
    xj = run_tbsm(jst, grid11, t, b, side, kd, 0, "Lower", pivots=jpiv)
    x = run_tbsm(pst, CPU, t, b, side, kd, 0, "Lower", pivots=piv)
    assert rel(x, xj) < 1e-10
    perm = np.arange(n)
    for r, p in enumerate(piv.numpy().reshape(-1)[:n]):
        perm[[r, p]] = perm[[p, r]]
    pb = b[perm]
    r = t @ x - 2.0 * pb if side == "Left" else x @ t - pb
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-11


def test_tbsm_dim_mismatch_raises():
    t = band_dense(40, 3, 0, seed=24, diag_boost=40)
    T = pst.TriangularBandMatrix.from_dense(t, nb=NB, grid=CPU, kl=3, ku=0)
    Bm = pst.Matrix.from_dense(np.ones((24, 2)), nb=NB, grid=CPU)
    with pytest.raises(pst.SlateError, match="tbsm dims"):
        pst.tbsm(pst.Side.Left, 1.0, T, Bm)
    with pytest.raises(pst.SlateError, match="tbsm dims"):
        pst.tbsm(pst.Side.Right, 1.0, T, Bm)


@pytest.mark.parametrize("mode", ["full", "tril", "triu", "mirror_upper"])
def test_pack_tiled_modes(grid11, mode):
    n, kl, ku = 27, 3, 3
    a = rand(n, n, np.float64, 38)
    J = jst.BandMatrix.from_dense(a, nb=NB, grid=grid11, kl=kl, ku=ku)
    P = pst.BandMatrix.from_dense(a, nb=NB, grid=CPU, kl=kl, ku=ku)
    ncols = 40
    mine = pband.pack_tiled(P, kl, ku, ncols, mode=mode, band=(kl, ku))
    theirs = jband.pack_tiled(J, kl, ku, ncols, mode=mode, band=(kl, ku))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


# ---------------------------------------------------------------------------
# gbmm / hbmm
# ---------------------------------------------------------------------------

def test_gbmm(grid11):
    """tests/test_blas.py::test_gbmm: a rectangular band times a dense B."""
    m, n, k, kl, ku = 16, 12, 16, 2, 3
    a = rand(m, k, seed=14)
    i, j = np.indices((m, k))
    band = np.where((j - i >= -kl) & (j - i <= ku), a, 0)
    b = rand(k, n, seed=15)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        C = pkg.Matrix.zeros(m, n, NB, grid, dtype=np.float64
                             if pkg is jst else torch.float64)
        out.append(dense(pkg.gbmm(1.0, pkg.BandMatrix.from_dense(
            a, nb=NB, grid=grid, kl=kl, ku=ku), pkg.Matrix.from_dense(
            b, nb=NB, grid=grid), 0.0, C)))
    assert rel(out[1], out[0]) < 1e-12
    assert rel(out[1], band @ b) < 1e-12


@pytest.mark.parametrize("route", ["packed", "dense"])
def test_gbmm_packed_vs_dense(grid11, route):
    """gbmm's one route, the packed windows, on A stored as its band only
    ("packed") and as a dense matrix whose out-of-band storage gbmm must
    ignore ("dense"), against the JAX package and the band product."""
    m, n, nB, kl, ku = 52, 37, 21, 4, 2
    rng = np.random.default_rng(41)
    full = rng.standard_normal((m, n))
    i, j = np.indices((m, n))
    a = np.where((j - i >= -kl) & (j - i <= ku), full, 0)
    bmat = rng.standard_normal((n, nB))
    cmat = rng.standard_normal((m, nB))
    stored = a if route == "packed" else full
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.BandMatrix.from_dense(stored, nb=NB, grid=grid, kl=kl, ku=ku)
        out.append(dense(pkg.gbmm(1.5, A, pkg.Matrix.from_dense(
            bmat, nb=NB, grid=grid), -0.5, pkg.Matrix.from_dense(
            cmat, nb=NB, grid=grid))))
    ref = 1.5 * a @ bmat - 0.5 * cmat
    assert rel(out[1], out[0]) < 1e-12
    assert rel(out[1], ref) < 1e-12


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_hbmm_left_right(grid11, dt):
    n, nB, kd = 32, 9, 3
    rng = np.random.default_rng(42)
    h = rng.standard_normal((n, n)).astype(dt)
    if dt == np.complex128:
        h = h + 1j * rng.standard_normal((n, n))
    h = (h + np.conj(h.T)) / 2
    band = np.where(np.abs(np.subtract.outer(range(n), range(n))) <= kd,
                    h, 0)
    bmat = rng.standard_normal((n, nB)).astype(dt)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        tdt = dt if pkg is jst else {np.float64: torch.float64,
                                     np.complex128: torch.complex128}[dt]
        A = pkg.HermitianBandMatrix.from_dense(np.tril(band), nb=NB,
                                               grid=grid, kl=kd, ku=kd)
        R = pkg.hbmm(pkg.Side.Left, 1.0, A, pkg.Matrix.from_dense(
            bmat, nb=NB, grid=grid), 0.0, pkg.Matrix.zeros(n, nB, NB, grid,
                                                           dtype=tdt))
        R2 = pkg.hbmm(pkg.Side.Right, 1.0, A, pkg.Matrix.from_dense(
            bmat.T.copy(), nb=NB, grid=grid), 0.0, pkg.Matrix.zeros(
            nB, n, NB, grid, dtype=tdt))
        out.append((dense(R), dense(R2)))
    for got, jref, ref in zip(out[1], out[0], (band @ bmat, bmat.T @ band)):
        assert rel(got, jref) < 1e-12
        assert rel(got, ref) < 1e-12
