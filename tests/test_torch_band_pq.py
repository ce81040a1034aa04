"""The band factorizations and the band BLAS of the port on p×q grids of
virtual ranks (2×2 and 2×4) against the JAX package on its 2×4 mesh, on
the CPU: ``gbtrf``, ``gbsv``, ``pbtrf`` (with ``health=True``),
``pbtrs``, ``pbsv``, ``gbmm``, ``hbmm`` (both sides) and ``tbsm`` (Left
Lower with and without gbtrf's pivots, Right Upper).

Inputs are made with numpy from a seed: n 60 and 77, nb 8,
(kl, ku) = (2, 3) and (5, 1), nrhs 3, float64 and complex128; the
general band's diagonal is scaled by 1e-8 so that gbtrf must pivot.
Tolerances are those of ``tests/test_torch_band.py`` and
``test_torch_band_blas.py`` on one rank: pivots and ``info`` equal; in
float64 the band LU, its solve and the products within 1e-12 relative,
the band Cholesky and the triangular band solves within 1e-10; in
complex128 everything within 1e-10. Every output on 2×2 and 2×4 is the
port's Grid(1, 1) output bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

NB, NRHS = 8, 3
CASES = [(np.float64, 60, 2, 3), (np.float64, 77, 5, 1),
         (np.complex128, 60, 2, 3), (np.complex128, 77, 5, 1)]
CASE_IDS = [f"{dt.__name__}-n{n}-kl{kl}-ku{ku}" for dt, n, kl, ku in CASES]
ROUTINES = ["gbtrf", "gbsv", "pbtrf", "pbtrs", "pbsv", "gbmm", "hbmm",
            "tbsm"]
GRIDS = [(2, 2), (2, 4)]
TIGHT = {"gbtrf", "gbsv", "gbmm", "hbmm"}     # 1e-12 in float64


def tol(routine, dt):
    return 1e-12 if dt == np.float64 and routine in TIGHT else 1e-10


def rel(x, ref):
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


def _gauss(rng, shape, dt):
    x = rng.standard_normal(shape)
    if dt == np.complex128:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dt)


def inputs(dt, n, kl, ku):
    """A general band that must pivot, an HPD band of half-width
    max(kl, ku), and the dense operands."""
    rng = np.random.default_rng(n + kl)
    i, j = np.indices((n, n))
    a = np.where((j - i <= ku) & (i - j <= kl), _gauss(rng, (n, n), dt), 0)
    a[np.arange(n), np.arange(n)] *= 1e-8
    kd = max(kl, ku)
    h = _gauss(rng, (n, n), dt)
    h = np.where(np.abs(i - j) <= kd, (h + h.conj().T) / 2, 0)
    h = h + 2 * n * np.eye(n)
    return dict(a=a, h=h, kd=kd, b=_gauss(rng, (n, NRHS), dt),
                c=_gauss(rng, (n, NRHS), dt), bw=_gauss(rng, (NRHS, n), dt),
                cw=_gauss(rng, (NRHS, n), dt))


def dense(M):
    return np.asarray(M.to_dense().numpy() if hasattr(M.to_dense(), "numpy")
                      else M.to_dense())


def arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run(pkg, grid, routine, x, kl, ku):
    """One routine's outputs, as numpy arrays, on ``grid``."""
    n, kd = x["a"].shape[0], x["kd"]

    def M(v):
        return pkg.Matrix.from_dense(v, nb=NB, grid=grid)

    A = pkg.BandMatrix.from_dense(x["a"], nb=NB, grid=grid, kl=kl, ku=ku)
    H = pkg.HermitianBandMatrix.from_dense(np.tril(x["h"]), nb=NB,
                                           grid=grid, kl=kd, ku=kd)
    if routine == "gbtrf":
        F, piv, info = pkg.gbtrf(A)
        return [arr(F.ab), arr(F.lpan), arr(piv), int(info)]
    if routine == "gbsv":
        return [dense(pkg.gbsv(A, M(x["b"]))[0])]
    if routine == "pbtrf":
        F, rep = pkg.pbtrf(H, health=True)
        return [arr(F.ab), rep.info]
    if routine == "pbtrs":
        return [dense(pkg.pbtrs(pkg.pbtrf(H)[0], M(x["b"])))]
    if routine == "pbsv":
        X, L, info = pkg.pbsv(H, M(x["b"]))
        return [dense(X), arr(L.ab), int(info)]
    if routine == "gbmm":
        return [dense(pkg.gbmm(1.5, A, M(x["b"]), -0.5, M(x["c"])))]
    if routine == "hbmm":
        return [dense(pkg.hbmm(pkg.Side.Left, 1.5, H, M(x["b"]), -0.5,
                               M(x["c"]))),
                dense(pkg.hbmm(pkg.Side.Right, 1.5, H, M(x["bw"]), -0.5,
                               M(x["cw"])))]
    T = pkg.TriangularBandMatrix.from_dense(np.tril(x["h"]), nb=NB,
                                            grid=grid, kl=kd, ku=0)
    TU = pkg.TriangularBandMatrix.from_dense(np.triu(x["h"]), nb=NB,
                                             grid=grid, kl=0, ku=kd,
                                             uplo=pkg.Uplo.Upper)
    piv = pkg.gbtrf(A)[1]
    return [dense(pkg.tbsm(pkg.Side.Left, 2.0, T, M(x["b"]))),
            dense(pkg.tbsm(pkg.Side.Left, 2.0, T, M(x["b"]), piv)),
            dense(pkg.tbsm(pkg.Side.Right, 1.0, TU, M(x["bw"])))]


@pytest.fixture(scope="module")
def jax_refs():
    """Every routine of every case through the JAX package on its 2×4
    mesh, once for the module."""
    g = jst.Grid(2, 4, devices=jax.devices()[:8])
    return {(ci, r): run(jst, g, r, inputs(*CASES[ci]), *CASES[ci][2:])
            for ci in range(len(CASES)) for r in ROUTINES}


@pytest.fixture(autouse=True)
def no_launches():
    """On the CPU the kernels' plain versions run and nothing launches."""
    before = dict(K.LAUNCHES)
    yield
    assert K.LAUNCHES == before


@pytest.mark.parametrize("ci", range(len(CASES)), ids=CASE_IDS)
@pytest.mark.parametrize("routine", ROUTINES)
def test_band_pq_matches_jax_and_one_rank(jax_refs, routine, ci):
    dt, n, kl, ku = CASES[ci]
    x = inputs(dt, n, kl, ku)
    one = run(pst, pst.Grid(1, 1, device="cpu"), routine, x, kl, ku)
    for mine, theirs in zip(one, jax_refs[(ci, routine)]):
        if isinstance(mine, int) or mine.dtype.kind == "i":
            assert np.array_equal(mine, np.asarray(theirs)), routine
        else:
            assert rel(mine, np.asarray(theirs)) < tol(routine, dt), routine
    for p, q in GRIDS:
        got = run(pst, pst.Grid(p, q, device="cpu"), routine, x, kl, ku)
        for mine, ref in zip(got, one):
            assert np.array_equal(np.asarray(mine), np.asarray(ref)), (p, q)


def test_band_pq_residuals():
    """The p×q solves solve: the backward error ‖A·X − B‖/(‖A‖·‖X‖) of
    gbsv, pbsv and tbsm (T·X = 2B) within 10·n·2⁻⁵³ on 2×4 in float64."""
    dt, n, kl, ku = CASES[1]
    x = inputs(dt, n, kl, ku)
    g = pst.Grid(2, 4, device="cpu")
    xg = run(pst, g, "gbsv", x, kl, ku)[0]
    xp = run(pst, g, "pbsv", x, kl, ku)[0]
    xt = run(pst, g, "tbsm", x, kl, ku)[0]
    bound = 10 * n * 2.0 ** -53
    for a, xx, b in ((x["a"], xg, x["b"]), (x["h"], xp, x["b"]),
                     (np.tril(x["h"]), xt, 2 * x["b"])):
        err = np.linalg.norm(a @ xx - b) / (np.linalg.norm(a)
                                             * np.linalg.norm(xx))
        assert err < bound


def test_pbtrf_pq_health_names_the_block():
    """A band that stops being positive definite at block column 3: the
    same info and report on 2×2, 2×4 and 1×1, and the JAX package's."""
    dt, n, kl, ku = CASES[0]
    h = inputs(dt, n, kl, ku)["h"]
    h[20, 20] = -1e4
    reps = []
    for pkg, g in ((jst, jst.Grid(2, 4, devices=jax.devices()[:8])),
                   (pst, pst.Grid(1, 1, device="cpu")),
                   (pst, pst.Grid(2, 2, device="cpu")),
                   (pst, pst.Grid(2, 4, device="cpu"))):
        A = pkg.HermitianBandMatrix.from_dense(np.tril(h), nb=NB, grid=g,
                                               kl=3, ku=3)
        F, rep = pkg.pbtrf(A, health=True)
        assert np.isfinite(arr(F.ab)).all()
        reps.append((rep.info, rep.first_bad_tile, rep.ok))
    assert reps == [reps[0]] * 4 and reps[0][0] > 0


def test_band_matrix_from_a_jax_2x4_mesh():
    """A JAX BandMatrix on 2×4 crosses through ``interop`` with its
    storage bit for bit, both ways, and gbsv on it gives the JAX X."""
    dt, n, kl, ku = CASES[3]
    x = inputs(dt, n, kl, ku)
    g = jst.Grid(2, 4, devices=jax.devices()[:8])
    JA = jst.BandMatrix.from_dense(x["a"], nb=NB, grid=g, kl=kl, ku=ku)
    A = pst.from_reference(np.asarray(JA.data), kind="BandMatrix", m=JA.m,
                           n=JA.n, nb=JA.nb, kl=JA.kl, ku=JA.ku,
                           device="cpu")
    assert (A.grid.p, A.grid.q, A.kl, A.ku) == (2, 4, kl, ku)
    back = pst.to_reference(A)
    assert np.array_equal(back["data"], np.asarray(JA.data))
    assert (back["kind"], back["kl"], back["ku"]) == ("BandMatrix", kl, ku)
    JB = jst.Matrix.from_dense(x["b"], nb=NB, grid=g)
    B = pst.from_reference(np.asarray(JB.data), kind="Matrix", m=n,
                           n=NRHS, nb=NB, device="cpu")
    X = pst.gbsv(A, B)[0]
    assert X.grid == A.grid
    assert rel(dense(X), np.asarray(jst.gbsv(JA, JB)[0].to_dense())) < 1e-10


def test_band_factor_and_rhs_on_two_devices_raise():
    """A factor whose packed band lies on another device than B's grid
    is refused, not moved (a "meta" tensor stands for the card here)."""
    dt, n, kl, ku = CASES[0]
    x = inputs(dt, n, kl, ku)
    g = pst.Grid(2, 2, device="cpu")
    B = pst.Matrix.from_dense(x["b"], nb=NB, grid=g)
    H = pst.HermitianBandMatrix.from_dense(np.tril(x["h"]), nb=NB, grid=g,
                                           kl=3, ku=3)
    F = pst.pbtrf(H)[0]
    with pytest.raises(pst.SlateError, match="device"):
        pst.pbtrs(F._replace(ab=F.ab.to("meta")), B)
    LU, piv, _ = pst.gbtrf(pst.BandMatrix.from_dense(x["a"], nb=NB, grid=g,
                                                     kl=kl, ku=ku))
    with pytest.raises(pst.SlateError, match="device"):
        pst.gbtrs(LU._replace(ab=LU.ab.to("meta")), piv, B)
