"""The port's inverses, condition estimates and health reports on p×q
grids of virtual ranks against the JAX package's on meshes of virtual
CPU devices: ``trtri`` (both uplos, unit and non-unit), ``trtrm``,
``potri``, ``getri``, ``gecondest``/``pocondest``/``trcondest`` and
``health=True`` on ``potrf``/``getrf``, whose p×q reports now carry the
growth (rcond) estimate.

The same numpy inputs go into both packages: n = 70 with nb = 8 (9
tiles, both edges ragged), float64 on 2×4 and complex128 on 2×2; the
factors of the estimates and inverses are each package's own p×q
``getrf``/``potrf`` of one matrix. Tolerances: the inverses within 1e-10
relative to the JAX package's (and to ``numpy.linalg.inv``), the rcond
estimates within 1e-10 relative (one estimator on the host, each step's
solve on the package's own factors; both pick the same unit vectors).
The upper ``trtrm`` is U·Uᴴ, the reference's lauum, held to numpy alone:
the JAX package forms Aᴴ·A for either triangle (ROADMAP §C). Each JAX
reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

N, NB = 70, 8
CASES = [((2, 4), np.float64), ((2, 2), np.complex128)]
IDS = ["2x4-f64", "2x2-c128"]
TRI = [(u, d) for u in ("Lower", "Upper") for d in ("NonUnit", "Unit")]


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def inputs(dt):
    """A general matrix (well conditioned), an SPD one and a triangle
    source with small off-diagonal entries, so that its unit triangles
    are well conditioned too."""
    a = rand(N, N, dt, seed=11) + 6 * np.eye(N)
    return dict(a=a, s=spd(N, dt, seed=12),
                t=0.1 * rand(N, N, dt, seed=13) + 2 * np.eye(N))


def run(pkg, grid, dt):
    """Every output of the module's routines in ``pkg`` on ``grid``."""
    x = inputs(dt)
    mk = lambda a, cls="Matrix", **kw: getattr(pkg, cls).from_dense(  # noqa
        a, nb=NB, grid=grid, **kw)
    out = {}
    for uplo, diag in TRI:
        T = mk(x["t"], "TriangularMatrix", uplo=getattr(pkg.Uplo, uplo),
               diag=getattr(pkg.Diag, diag))
        out["trtri", uplo, diag] = np.asarray(pkg.trtri(T).to_dense())
        if diag == "NonUnit":
            out["trtrm", uplo] = np.asarray(pkg.trtrm(T).to_dense())
            out["trcondest", uplo] = float(pkg.trcondest(pkg.Norm.One, T))
    A = mk(x["a"])
    S = mk(x["s"], "HermitianMatrix")
    LU, piv, _ = pkg.getrf(A)
    L, _ = pkg.potrf(S)
    out["getri"] = np.asarray(pkg.getri(LU, piv).to_dense())
    out["potri"] = np.asarray(pkg.potri(L).to_dense())
    anorm = float(np.abs(x["a"]).sum(0).max())
    snorm = float(np.abs(x["s"]).sum(0).max())
    out["gecondest"] = float(pkg.gecondest(pkg.Norm.One, LU, piv, anorm))
    out["pocondest"] = float(pkg.pocondest(pkg.Norm.One, L, snorm))
    out["health", "potrf"] = pkg.potrf(S, health=True)[1]
    out["health", "getrf"] = pkg.getrf(A, health=True)[2]
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return {(p, q): run(jst, jgrid(p, q), dt) for (p, q), dt in CASES}


@pytest.fixture(scope="module")
def port():
    return {(p, q): run(pst, pgrid(p, q), dt) for (p, q), dt in CASES}


def close(got, want, tol=1e-10):
    return np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("uplo,diag", TRI)
def test_trtri_pq_matches_jax(jax_ref, port, case, uplo, diag):
    (p, q), dt = case
    key = ("trtri", uplo, diag)
    got, want = port[p, q][key], jax_ref[p, q][key]
    t = inputs(dt)["t"]
    t = np.tril(t) if uplo == "Lower" else np.triu(t)
    if diag == "Unit":
        np.fill_diagonal(t, 1.0)
    tri = np.tril if uplo == "Lower" else np.triu
    assert close(tri(got), tri(want))
    assert close(tri(got), np.linalg.inv(t))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_trtrm_pq(jax_ref, port, case, uplo):
    (p, q), dt = case
    got = port[p, q]["trtrm", uplo]
    t = inputs(dt)["t"]
    if uplo == "Lower":
        t = np.tril(t)
        assert close(got, jax_ref[p, q]["trtrm", uplo])
        assert close(got, t.conj().T @ t)
    else:
        t = np.triu(t)
        assert close(got, t @ t.conj().T)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("which", ["getri", "potri"])
def test_inverse_pq_matches_jax(jax_ref, port, case, which):
    (p, q), dt = case
    x = inputs(dt)
    got = port[p, q][which]
    assert close(got, jax_ref[p, q][which])
    m = x["a"] if which == "getri" else x["s"]
    assert close(got, np.linalg.inv(m))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("which", ["gecondest", "pocondest",
                                   "trcondest-Lower", "trcondest-Upper"])
def test_condest_pq_matches_jax(jax_ref, port, case, which):
    (p, q), dt = case
    key = tuple(which.split("-")) if "-" in which else which
    got, want = port[p, q][key], jax_ref[p, q][key]
    assert 0.0 < got <= 1.0 and abs(got - want) <= 1e-10 * want


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("routine", ["potrf", "getrf"])
def test_health_pq_carries_growth(jax_ref, port, case, routine):
    """A p×q report carries the rcond estimate, equal to the JAX
    package's and to condest on the factor (with ‖A‖₁ by the package's
    own ``norm`` there); info 0, no bad tile."""
    (p, q), dt = case
    rep = port[p, q]["health", routine]
    jrep = jax_ref[p, q]["health", routine]
    assert isinstance(rep, pst.HealthReport) and rep.ok and rep.info == 0
    assert rep.first_bad_tile is None and rep.growth is not None
    assert abs(rep.growth - jrep.growth) <= 1e-10 * jrep.growth
    own = port[p, q]["gecondest" if routine == "getrf" else "pocondest"]
    assert abs(rep.growth - own) <= 1e-10 * own
