"""Complex dtypes through the port's band LU (gbtrf/gbtrs/gbsv), band
Cholesky (pbtrf/pbtrs/pbsv), Aasen's hetrf/hetrs/hesv and hegst against
the JAX package on a 1×1 grid, on the CPU, at complex64 and complex128.

Inputs come from a numpy seed with O(1) imaginary parts, n = 40, nb = 8
(band blocks of 8). complex128 runs every variant (gbtrs with Trans and
ConjTrans, an Upper pbsv, hegst itype 1–3, the JAX hetrf factors solved
by the port's hetrs); complex64 the main one of each family. Each JAX
reference is computed once per module. Tolerances: pivots and ``info``
equal; factors and solutions within 1e-4 (complex64) and 1e-10
(complex128) relative in the Frobenius norm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = st.Grid(1, 1, device="cpu")
N, NB, KL, KU, KD = 40, 8, 3, 2, 4
DTS = [np.complex64, np.complex128]
TOL = {np.complex64: 1e-4, np.complex128: 1e-10}
IDS = ["c64", "c128"]


def dense(M):
    d = M.to_dense()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def rel(x, ref):
    x, ref = np.asarray(x, np.complex128), np.asarray(ref, np.complex128)
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


def inputs(dt):
    i, j = np.indices((N, N))
    a = rand(N, N, dt, 1)
    s = spd(N, dt, 2)
    h = rand(N, N, dt, 4)
    h = ((h + h.conj().T) / 2).astype(dt)
    return dict(band=np.where((j - i <= KU) & (i - j <= KL), a, 0).astype(dt),
                hband=np.where(np.abs(i - j) <= KD, s, 0).astype(dt),
                h=h, s=s, b=rand(N, 3, dt, 3))


def run(pkg, grid, dt):
    full = dt == np.complex128
    x = inputs(dt)
    M = lambda v, cls=pkg.Matrix, **kw: cls.from_dense(v, nb=NB, grid=grid,
                                                       **kw)
    B = M(x["b"])
    out = {}
    X, F, piv, info = pkg.gbsv(M(x["band"], pkg.BandMatrix, kl=KL, ku=KU), B)
    out["gbsv"], out["gbsv_piv"], out["gbsv_info"] = (dense(X),
                                                     np.asarray(piv),
                                                     int(info))
    uplos = ("Lower", "Upper") if full else ("Lower",)
    for u in uplos:
        stored = np.tril(x["hband"]) if u == "Lower" else np.triu(x["hband"])
        X, L, info = pkg.pbsv(M(stored, pkg.HermitianBandMatrix, kl=KD,
                                ku=KD, uplo=pkg.Uplo[u]), B)
        out["pbsv_" + u], out["pbsv_info_" + u] = dense(X), int(info)
        out["pbtrf_" + u] = np.asarray(L.ab)[:, :N]
    bad = np.tril(x["hband"]).copy()
    bad[20, 20] = -5.0
    out["pbtrf_bad"] = int(pkg.pbtrf(M(bad, pkg.HermitianBandMatrix, kl=KD,
                                       ku=KD))[1])
    X, (_, _, hpiv), info = pkg.hesv(M(np.tril(x["h"]), pkg.HermitianMatrix),
                                     B)
    out["hesv"], out["hesv_piv"], out["hesv_info"] = (dense(X),
                                                     np.asarray(hpiv),
                                                     int(info))
    Lc, _ = pkg.potrf(M(x["s"], pkg.HermitianMatrix))
    for itype in (1, 2, 3)[:3 if full else 1]:
        out[f"hegst{itype}"] = dense(pkg.hegst(
            itype, M(x["h"], pkg.HermitianMatrix), Lc))
    if full:
        for tr in ("Trans", "ConjTrans"):
            out["gbtrs_" + tr] = dense(pkg.gbtrs(F, piv, B, pkg.Op[tr]))
    return out


@pytest.fixture(scope="module")
def refs():
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    jax_out = {dt: run(sj, g, dt) for dt in DTS}
    before = dict(K.LAUNCHES)
    port_out = {dt: run(st, CPU, dt) for dt in DTS}
    assert K.LAUNCHES == before
    return jax_out, port_out


def check(j, p, keys, tol, dt):
    for k in keys:
        if k in j:
            assert p[k].dtype == dt and rel(p[k], j[k]) < tol, k


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_band_lu_matches_jax(refs, dt):
    """gbsv's pivots, info and solution; gbtrs with Trans and ConjTrans
    (the factors conjugated for ConjTrans)."""
    j, p = refs[0][dt], refs[1][dt]
    assert np.array_equal(p["gbsv_piv"], j["gbsv_piv"])
    assert p["gbsv_info"] == j["gbsv_info"] == 0
    check(j, p, ("gbsv", "gbtrs_Trans", "gbtrs_ConjTrans"), TOL[dt], dt)
    if "gbtrs_ConjTrans" in p:
        x = inputs(dt)
        assert rel(x["band"].conj().T @ p["gbtrs_ConjTrans"],
                   x["b"]) < TOL[dt]


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_band_cholesky_matches_jax(refs, dt):
    """pbsv both uplos (the packed factor and the solution) and a non-HPD
    band's info."""
    j, p = refs[0][dt], refs[1][dt]
    assert p["pbtrf_bad"] == j["pbtrf_bad"] == 3
    for u in ("Lower", "Upper"):
        if "pbsv_" + u in j:
            assert p["pbsv_info_" + u] == j["pbsv_info_" + u] == 0
    check(j, p, ("pbsv_Lower", "pbsv_Upper", "pbtrf_Lower", "pbtrf_Upper"),
          TOL[dt], dt)


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_aasen_and_hegst_match_jax(refs, dt):
    """hesv's panel pivots, info and solution; hegst itype 1–3."""
    j, p = refs[0][dt], refs[1][dt]
    assert np.array_equal(p["hesv_piv"], j["hesv_piv"])
    assert p["hesv_info"] == j["hesv_info"] == 0
    check(j, p, ("hesv", "hegst1", "hegst2", "hegst3"), TOL[dt], dt)
    x = inputs(dt)
    assert rel(x["h"] @ p["hesv"], x["b"]) < TOL[dt] * 10


def test_jax_hetrf_factors_solve_in_the_port():
    """The JAX package's complex hetrf factors (L, T's band LU, pivots)
    cross into the port by ``interop`` and its hetrs solves with them."""
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    x = inputs(np.complex128)
    (JL, JF, jpiv), _ = sj.hetrf(sj.HermitianMatrix.from_dense(
        np.tril(x["h"]), nb=NB, grid=g))
    L = {"data": np.asarray(JL.data), "kind": "TriangularMatrix", "m": N,
         "n": N, "nb": NB, "uplo": JL.uplo.name, "diag": JL.diag.name}
    T = {"ab": np.asarray(JF.ab), "lpan": np.asarray(JF.lpan),
         "piv": np.asarray(JF.piv), "m": JF.m, "n": JF.n, "kl": JF.kl,
         "ku": JF.ku, "nb": JF.nb}
    factors = st.hetrf_from_reference(L, T, np.asarray(jpiv), device="cpu")
    assert factors[0].dtype == factors[1].ab.dtype == torch.complex128
    X = st.hetrs(factors, st.Matrix.from_dense(x["b"], nb=NB, grid=CPU))
    assert rel(x["h"] @ dense(X), x["b"]) < 1e-10
