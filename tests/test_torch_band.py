"""The band LU solve of the port (``gbtrf`` → ``gbtrs`` → ``gbsv``) on
the CPU against the JAX package's on a 1×1 grid, with the cases of
tests/test_band.py plus a band of kl = ku = 16, whose band block (48) is
below 128, so every trailing update goes through ``tile_gemm`` to the
rank-k tail K11 (its plain version here).

Tolerances: pivots and ``info`` equal; the packed U, the panel
multipliers and X within 1e-12 relative (f64: both run LAPACK's getrf on
the same windows, the products in other orders); residuals below 1e-11
as in tests/test_band.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu.linalg import band as jband  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CASES = [(60, 4, 6, 3, True), (33, 1, 1, 1, True), (50, 7, 2, 2, True),
         (30, 2, 2, 1, False), (100, 16, 16, 2, False)]
NB = 8


def band_dense(n, kl, ku, seed, boost):
    """tests/test_band.py's band: Gaussian inside (kl, ku), with the
    diagonal boosted by 2n, or (no boost) the diagonal scaled by 1e-8 so
    the factorization must pivot."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    i, j = np.indices((n, n))
    a = np.where((j - i <= ku) & (i - j <= kl), a, 0.0)
    if boost:
        return a + 2 * n * np.eye(n)
    a[np.arange(n), np.arange(n)] *= 1e-8
    return a


def rhs(n, nrhs):
    return np.random.default_rng(1).standard_normal((n, nrhs))


def rel(x, ref):
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


@pytest.fixture(scope="module")
def jax_refs():
    """One JAX gbsv per case (and a Trans solve for the first), shared by
    the tests of this module."""
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    out = {}
    for n, kl, ku, nrhs, boost in CASES:
        a = band_dense(n, kl, ku, n, boost)
        A = sj.BandMatrix.from_dense(a, nb=NB, grid=g, kl=kl, ku=ku)
        B = sj.Matrix.from_dense(rhs(n, nrhs), nb=NB, grid=g)
        X, F, piv, info = sj.gbsv(A, B)
        trans = (np.asarray(sj.gbtrs(F, piv, B, trans=sj.Op.Trans).to_dense())
                 if n == 60 else None)
        out[n] = dict(x=np.asarray(X.to_dense()), F=F, piv=np.asarray(piv),
                      info=int(info), trans=trans)
    return out


def port_gbsv(n, kl, ku, nrhs, boost):
    g = st.Grid(1, 1, device="cpu")
    a = band_dense(n, kl, ku, n, boost)
    A = st.BandMatrix.from_dense(a, nb=NB, grid=g, kl=kl, ku=ku)
    B = st.Matrix.from_dense(rhs(n, nrhs), nb=NB, grid=g)
    return a, B, st.gbsv(A, B)


@pytest.mark.parametrize("n,kl,ku,nrhs,boost", CASES)
def test_gbsv_matches_jax(jax_refs, n, kl, ku, nrhs, boost):
    ref = jax_refs[n]
    before = dict(K.LAUNCHES)
    a, B, (X, F, piv, info) = port_gbsv(n, kl, ku, nrhs, boost)
    assert K.LAUNCHES == before                  # plain versions only
    x = X.to_dense().numpy()
    assert int(info) == ref["info"] == 0
    assert np.array_equal(piv.numpy(), ref["piv"])
    assert F.nb == ref["F"].nb == jband._band_block(n, 2 * kl + ku)
    for mine, theirs in ((F.ab, ref["F"].ab), (F.lpan, ref["F"].lpan)):
        assert rel(mine.numpy(), np.asarray(theirs)) < 1e-12
    assert rel(x, ref["x"]) < 1e-12
    assert rel(a @ x, rhs(n, nrhs)) < 1e-11
    u = F.to_dense().numpy()                     # U: upper, band kl + ku
    i, j = np.indices(u.shape)
    assert not u[(i > j) | (j - i > kl + ku)].any()
    if not boost:                    # the pivots really pivot
        assert (piv.numpy().reshape(-1)[:n] != np.arange(n)).any()


def test_gbtrs_trans_and_carried_factors(jax_refs):
    """Aᵀ·X = B matches the JAX Trans solve; the port's gbtrs on the JAX
    factor (carried across as numpy arrays) gives the JAX X, and the JAX
    gbtrs on the port's factor the port's."""
    n, kl, ku, nrhs, boost = CASES[0]
    ref = jax_refs[n]
    a, B, (X, F, piv, info) = port_gbsv(n, kl, ku, nrhs, boost)
    xt = st.gbtrs(F, piv, B, trans=st.Op.Trans).to_dense().numpy()
    assert rel(xt, ref["trans"]) < 1e-12
    assert rel(a.T @ xt, rhs(n, nrhs)) < 1e-11
    assert rel(st.gbtrs(F, piv, B, trans=st.Op.ConjTrans).to_dense().numpy(),
               xt) == 0.0
    JF = ref["F"]
    carried = st.band_lu_from_reference(
        np.asarray(JF.ab), np.asarray(JF.lpan), np.asarray(JF.piv), m=JF.m,
        n=JF.n, kl=JF.kl, ku=JF.ku, nb=JF.nb, device="cpu")
    x = st.gbtrs(carried, None, B).to_dense().numpy()
    assert rel(x, ref["x"]) < 1e-13
    back = st.band_lu_to_reference(F)
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    JB = sj.Matrix.from_dense(rhs(n, nrhs), nb=NB, grid=g)
    JF2 = jband.BandLUFactor(jnp.asarray(back["ab"]),
                             jnp.asarray(back["lpan"]),
                             jnp.asarray(back["piv"]), back["m"], back["n"],
                             back["kl"], back["ku"], back["nb"])
    xj = np.asarray(sj.gbtrs(JF2, None, JB).to_dense())
    assert rel(xj, X.to_dense().numpy()) < 1e-13


def test_band_matrix_transpose_swaps_widths():
    """A transposed BandMatrix view materializes with kl and ku swapped,
    as the JAX package's does, and gbsv on it solves Aᵀ·X = B."""
    n, kl, ku = 40, 3, 2
    a = band_dense(n, kl, ku, 3, True)
    g = st.Grid(1, 1, device="cpu")
    At = st.transpose(st.BandMatrix.from_dense(a, nb=NB, grid=g, kl=kl,
                                               ku=ku))
    m = At.materialize()
    assert (m.kl, m.ku) == (ku, kl)
    X, _, _, info = st.gbsv(At, st.Matrix.from_dense(rhs(n, 2), nb=NB,
                                                     grid=g))
    assert int(info) == 0
    assert rel(a.T @ X.to_dense().numpy(), rhs(n, 2)) < 1e-11


def test_gbsv_float32_and_complex(grid11):
    """f32 runs (the card's type) to an f32 residual; complex64 gives the
    JAX package's pivots and info and its solution within 1e-4."""
    n, kl, ku = 200, 32, 32
    a = band_dense(n, kl, ku, 5, False).astype(np.float32)
    g = st.Grid(1, 1, device="cpu")
    b = rhs(n, 2).astype(np.float32)
    X, F, piv, info = st.gbsv(
        st.BandMatrix.from_dense(a, nb=64, grid=g, kl=kl, ku=ku),
        st.Matrix.from_dense(b, nb=64, grid=g))
    x = X.to_dense().double().numpy()
    assert int(info) == 0 and F.nb == 96
    assert (np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))
            < 10 * n * 2.0 ** -24)
    ac = (a + 1j * band_dense(n, kl, ku, 6, False)).astype(np.complex64)
    bc = (b + 1j * rhs(n, 2)[::-1]).astype(np.complex64)
    X, F, piv, info = st.gbsv(
        st.BandMatrix.from_dense(ac, nb=64, grid=g, kl=kl, ku=ku),
        st.Matrix.from_dense(bc, nb=64, grid=g))
    JX, _, jpiv, jinfo = sj.gbsv(
        sj.BandMatrix.from_dense(ac, nb=64, grid=grid11, kl=kl, ku=ku),
        sj.Matrix.from_dense(bc, nb=64, grid=grid11))
    assert int(info) == int(jinfo) == 0
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert rel(X.to_dense().numpy(), np.asarray(JX.to_dense())) < 1e-4


def test_gbtrf_zero_column_counts_info():
    n, kl, ku = 48, 3, 3
    a = band_dense(n, kl, ku, 6, True)
    a[:, 20] = 0.0
    g = st.Grid(1, 1, device="cpu")
    _, _, info = st.gbtrf(st.BandMatrix.from_dense(a, nb=NB, grid=g, kl=kl,
                                                   ku=ku))
    assert int(info) == 1
    with pytest.raises(st.InfoError):
        st.raise_if_info(info, "gbtrf")
