"""Aasen's symmetric-indefinite solve in the port (``hetrf`` → ``hetrs``
→ ``hesv``) on the CPU against the JAX package's on a 1×1 grid, with the
cases of tests/test_hetrf.py: sizes at nb = 8 and 16 (the panel goes to
``torch.linalg.lu_factor_ex``, the counterpart of ``lax.linalg.lu``), a
zero diagonal that needs pivoting, and n = 384 and 300 (ragged) at
nb = 128, where the port's panel goes to the physical-swap kernel's
plain version and the JAX side runs ``panel_plu_pallas`` in interpret
mode under ``forced_rung("panel_plu")``.

Tolerances: pivots (the panels' and T's band LU's) equal; L and the
factored T within 1e-10 relative in f64 (one algorithm, products summed
in other orders); in f32 X within 1.5× the JAX package's own residual
‖A·X − B‖/(‖A‖·‖X‖); P·A·Pᵀ = L·T·Lᵀ within 1e-9 relative (f64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu.internal import pallas_kernels as pk  # noqa: E402
from slate_tpu_torch import runtime  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

# (n, nb, dtype, zero diagonal); nb = 128 runs the JAX Pallas panel
CASES = [(61, 8, np.float64, False), (96, 16, np.float64, False),
         (32, 8, np.float64, True), (384, 128, np.float64, False),
         (300, 128, np.float64, False), (300, 128, np.float32, False)]


def indef_sym(n, seed, dtype, zero_diag):
    a = np.random.default_rng(seed).standard_normal((n, n))
    a = (a + a.T) / 2
    if zero_diag:
        a[np.arange(n), np.arange(n)] = 0.0
    return a.astype(dtype)


def rhs(n, dtype):
    return np.random.default_rng(1).standard_normal((n, 3)).astype(dtype)


def residual(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))


def rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def jax_hetrf(n, nb, dt, zero_diag, solve):
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    a = indef_sym(n, n, dt, zero_diag)
    A = sj.HermitianMatrix.from_dense(np.tril(a), nb=nb, grid=g)
    (L, FT, piv), info = sj.hetrf(A)
    out = dict(L=L, FT=FT, piv=np.asarray(piv), info=int(info))
    if solve:
        B = sj.Matrix.from_dense(rhs(n, dt), nb=nb, grid=g)
        out["x"] = np.asarray(sj.hetrs((L, FT, piv), B).to_dense())
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """One JAX hetrf per case (hetrs for the f32 case), shared by the
    tests of this module; at nb = 128 the Pallas panel kernel runs."""
    out = {}
    for n, nb, dt, zd in CASES:
        solve = dt == np.float32
        if nb == 128:
            with pk.forced_rung("panel_plu"):
                out[n, dt] = jax_hetrf(n, nb, dt, zd, solve)
        else:
            out[n, dt] = jax_hetrf(n, nb, dt, zd, solve)
    return out


def port_hesv(n, nb, dt, zero_diag, uplo=st.Uplo.Lower):
    g = st.Grid(1, 1, device="cpu")
    a = indef_sym(n, n, dt, zero_diag)
    stored = np.tril(a) if uplo == st.Uplo.Lower else np.triu(a)
    A = st.HermitianMatrix.from_dense(stored, nb=nb, grid=g, uplo=uplo)
    B = st.Matrix.from_dense(rhs(n, dt), nb=nb, grid=g)
    return a, B, st.hesv(A, B)


def t_dense(FT, n):
    """T rebuilt from its band LU by solving against the identity."""
    g = st.Grid(1, 1, device="cpu")
    eye = st.Matrix.from_dense(np.eye(n), nb=FT.nb, grid=g)
    tinv = st.gbtrs(FT, None, eye).to_dense().numpy()
    return np.linalg.inv(tinv)


@pytest.mark.parametrize("n,nb,dt,zero_diag", CASES)
def test_hesv_matches_jax(jax_refs, n, nb, dt, zero_diag):
    ref = jax_refs[n, dt]
    before = dict(K.LAUNCHES)
    a, B, (X, (L, FT, piv), info) = port_hesv(n, nb, dt, zero_diag)
    assert K.LAUNCHES == before                  # plain versions only
    x = X.to_dense().numpy()
    assert int(info) == ref["info"] == 0
    assert np.array_equal(piv.numpy(), ref["piv"])
    assert np.array_equal(FT.piv.numpy(), np.asarray(ref["FT"].piv))
    if zero_diag:                    # the pivots really pivot
        assert (piv.numpy().reshape(-1)[:n] != np.arange(n)).any()
    if dt == np.float64:
        assert rel(L.to_dense().numpy(), np.asarray(ref["L"].to_dense())) \
            < 1e-10
        for mine, theirs in ((FT.ab, ref["FT"].ab),
                             (FT.lpan, ref["FT"].lpan)):
            assert rel(mine.numpy(), np.asarray(theirs)) < 1e-10
        assert residual(a, x, rhs(n, dt)) < 1e-13
    else:
        assert residual(a, x, rhs(n, dt)) \
            <= 1.5 * residual(a, ref["x"], rhs(n, dt))


@pytest.mark.parametrize("n,nb", [(40, 8), (300, 128)])
def test_hetrf_factor_identity(n, nb):
    """P·A·Pᵀ = L·T·Lᵀ, with T block tridiagonal (bandwidth 2nb − 1)."""
    a, _, (_, (L, FT, piv), info) = port_hesv(n, nb, np.float64, False)
    assert int(info) == 0
    ld = L.to_dense().numpy()
    T = t_dense(FT, n)
    perm = runtime.resolve_pivots(piv.numpy(), n)
    pa = a[perm][:, perm]
    assert np.linalg.norm(ld @ T @ ld.T - pa) / np.linalg.norm(a) < 1e-9
    far = np.abs(np.subtract.outer(range(n), range(n))) > 2 * nb - 1
    assert np.abs(T[far]).max() < 1e-8 * np.abs(T).max()
    assert np.allclose(np.diag(ld), 1.0) and not np.triu(ld, 1).any()


def test_hetrs_on_carried_factors(jax_refs):
    """The port's hetrs on the JAX factors gives the JAX X; the factors
    round-trip through the port's interop bit for bit."""
    n, dt = 300, np.float32
    ref = jax_refs[n, dt]
    L, FT = ref["L"], ref["FT"]
    factors = st.hetrf_from_reference(
        dict(data=np.asarray(L.data), kind="TriangularMatrix", m=L.m, n=L.n,
             nb=L.nb, uplo=L.uplo.name, diag=L.diag.name),
        dict(ab=np.asarray(FT.ab), lpan=np.asarray(FT.lpan),
             piv=np.asarray(FT.piv), m=FT.m, n=FT.n, kl=FT.kl, ku=FT.ku,
             nb=FT.nb),
        ref["piv"], device="cpu")
    B = st.Matrix.from_dense(rhs(n, dt), nb=128, grid=st.Grid(1, 1,
                                                               device="cpu"))
    x = st.hetrs(factors, B).to_dense().numpy()
    assert rel(x, ref["x"]) < 1e-4
    back = st.hetrf_to_reference(factors)
    assert np.array_equal(back["L"]["data"], np.asarray(L.data))
    assert np.array_equal(back["T"]["ab"], np.asarray(FT.ab))
    assert np.array_equal(back["piv"], ref["piv"])


def test_hesv_upper_mirror_verbs_and_refusals(grid11):
    """Upper storage through the mirror gives the Lower result; the verbs
    wrap hetrf/hesv/hetrs; complex input gives the JAX package's pivots,
    info and solution; health=True reports."""
    n, nb = 61, 8
    _, _, (X, factors, _) = port_hesv(n, nb, np.float64, False)
    a, B, (Xu, _, info) = port_hesv(n, nb, np.float64, False, st.Uplo.Upper)
    assert int(info) == 0
    np.testing.assert_array_equal(Xu.to_dense().numpy(),
                                  X.to_dense().numpy())
    g = st.Grid(1, 1, device="cpu")
    A = st.HermitianMatrix.from_dense(np.tril(a), nb=nb, grid=g)
    np.testing.assert_array_equal(st.indefinite_solve(A, B).to_dense(),
                                  X.to_dense())
    f2, _ = st.indefinite_factor(A)
    np.testing.assert_array_equal(
        st.indefinite_solve_using_factor(f2, B).to_dense(), X.to_dense())
    h = a + 1j * np.tril(indef_sym(n, n + 1, np.float64, False), -1)
    h = np.tril(h) + np.tril(h, -1).conj().T
    bc = B.to_dense().numpy() * (1 - 2j)
    Xc, (_, _, pivc), infoc = st.hesv(
        st.HermitianMatrix.from_dense(np.tril(h), nb=nb, grid=g),
        st.Matrix.from_dense(bc, nb=nb, grid=g))
    JX, (_, _, jpiv), jinfo = sj.hesv(
        sj.HermitianMatrix.from_dense(np.tril(h), nb=nb, grid=grid11),
        sj.Matrix.from_dense(bc, nb=nb, grid=grid11))
    assert int(infoc) == int(jinfo) == 0
    assert np.array_equal(pivc.numpy(), np.asarray(jpiv))
    assert np.abs(Xc.to_dense().numpy() - np.asarray(JX.to_dense())).max() \
        < 1e-10 * np.abs(np.asarray(JX.to_dense())).max()
    _, rep = st.hetrf(A, health=True)
    assert isinstance(rep, st.HealthReport) and rep.info == 0 and rep.ok
