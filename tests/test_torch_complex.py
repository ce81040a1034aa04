"""Complex dtypes through the port's one-device dense solvers against the
JAX package on a 1×1 grid, on the CPU: Cholesky (potrf/potrs/posv, both
uplos), the inverses (trtri, trtrm, potri, getri), LU (getrf/getrs with
NoTrans, Trans and ConjTrans, gesv, a singular gesv), the unpivoted LU,
QR/LQ (geqrf, unmqr on both sides, gelqf/unmlq, cholqr, gels tall and
wide), the condition estimates and the mixed-precision solves, each at
complex64 and complex128; the |Re| + |Im| pivot choice; the factors
carried across by ``interop``. The band, Aasen and hegst families are in
tests/test_torch_complex_band.py.

Inputs come from a numpy seed with O(1) imaginary parts, n = 32,
nb = 16. complex128 runs every variant of a family and complex64 the
main ones (``run``). Each JAX reference is computed once per module. Tolerances:
pivots, ``info`` and ``iters`` equal; factors and solutions within 1e-4
(complex64) and 1e-10 (complex128) relative in the Frobenius norm (the
two packages sum in other orders; κ ≤ 1e3 here); rcond estimates within
the same bounds. No kernel of the port takes complex, so no launch is
counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.linalg import getrf as pgetrf  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = st.Grid(1, 1, device="cpu")
N, NB = 32, 16
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
    a = rand(N, N, dt, 1)
    wide = rand(N // 2, N, dt, 6)
    return dict(a=a, s=spd(N, dt, 2), b=rand(N, 3, dt, 3),
                t=(np.tril(rand(N, N, dt, 4)) + N * np.eye(N)).astype(dt),
                tall=rand(2 * N, N // 2, dt, 5), wide=wide,
                bw=rand(N // 2, 2, dt, 7), bt=rand(2 * N, 2, dt, 8),
                dom=(a + N * np.eye(N)).astype(dt))


def mats(pkg, grid, x, dt):
    """The inputs as each package's matrices."""
    M = lambda v, cls=pkg.Matrix, **kw: cls.from_dense(v, nb=NB, grid=grid,
                                                       **kw)
    return dict(A=M(x["a"]), S=M(x["s"], pkg.HermitianMatrix),
                Su=M(np.triu(x["s"]), pkg.HermitianMatrix,
                     uplo=pkg.Uplo.Upper),
                B=M(x["b"]), T=M(x["t"], pkg.TriangularMatrix),
                Tall=M(x["tall"]), Wide=M(x["wide"]), Bw=M(x["bw"]),
                Bt=M(x["bt"]), Dom=M(x["dom"]))


def run(pkg, grid, dt):
    """Every dense family at ``dt`` through ``pkg`` (either package):
    numpy results by name. complex128 runs every variant; complex64 one
    or two of each family, which keeps the JAX side's compiles within
    the test budget."""
    full = dt == np.complex128
    x = inputs(dt)
    m = mats(pkg, grid, x, dt)
    out = {}
    L, info = pkg.potrf(m["S"])
    out["potrf"], out["potrf_info"] = dense(L), int(info)
    X, _, info = pkg.posv(m["S"], m["B"])
    out["posv"], out["posv_info"] = dense(X), int(info)
    bad = x["s"].copy()
    bad[20, 20] = -5.0
    out["potrf_bad"] = int(pkg.potrf(pkg.HermitianMatrix.from_dense(
        bad, nb=NB, grid=grid))[1])
    out["trtri"] = np.tril(dense(pkg.trtri(m["T"])))
    out["potri"] = np.tril(dense(pkg.potri(L)))
    LU, piv, info = pkg.getrf(m["A"])
    out["getrf"], out["piv"], out["getrf_info"] = (dense(LU),
                                                  np.asarray(piv), int(info))
    for tr in ("NoTrans", "Trans", "ConjTrans")[2 - 2 * full:]:
        out["getrs_" + tr] = dense(pkg.getrs(LU, piv, m["B"], pkg.Op[tr]))
    sing = x["a"].copy()
    sing[:, 9] = 0.0
    _, _, spiv, sinfo = pkg.gesv(pkg.Matrix.from_dense(sing, nb=NB,
                                                       grid=grid), m["B"])
    out["sing_piv"], out["sing_info"] = np.asarray(spiv), int(sinfo)
    X, LU0, info = pkg.gesv_nopiv(m["Dom"], m["B"])
    out["nopiv"], out["nopiv_lu"], out["nopiv_info"] = (dense(X), dense(LU0),
                                                       int(info))
    QR, T = pkg.geqrf(m["Tall"])
    out["geqrf"], out["geqrf_T"] = dense(QR), np.asarray(T)
    out["gels"] = dense(pkg.gels(m["Tall"], m["Bt"]))
    out["trcondest"] = float(pkg.trcondest(pkg.Norm.One, m["T"]))
    mixed = [("gesv_mixed", "A"), ("posv_mixed", "S")]
    if full:
        out["gels_wide"] = dense(pkg.gels(m["Wide"], m["Bw"]))
        sn = float(np.abs(x["s"]).sum(0).max())
        out["pocondest"] = float(pkg.pocondest(pkg.Norm.One, L, sn))
        U, _ = pkg.potrf(m["Su"])
        out["potrf_u"] = dense(U)
        out["getri"] = dense(pkg.getri(LU, piv))
        C = pkg.Matrix.from_dense(x["bt"], nb=NB, grid=grid)
        Cr = pkg.Matrix.from_dense(x["bt"].T.copy(), nb=NB, grid=grid)
        for side, CC in (("Left", C), ("Right", Cr)):
            for tr in ("NoTrans", "ConjTrans"):
                out[f"unmqr_{side}_{tr}"] = dense(pkg.unmqr(
                    pkg.Side[side], pkg.Op[tr], QR, T, CC))
        LQ, TL = pkg.gelqf(m["Wide"])
        out["gelqf"] = dense(LQ)
        Cw = pkg.Matrix.from_dense(rand(N, 2, dt, 9), nb=NB, grid=grid)
        out["unmlq"] = dense(pkg.unmlq(pkg.Side.Left, pkg.Op.ConjTrans, LQ,
                                       TL, Cw))
        Q, R, info = pkg.cholqr(m["Tall"])
        out["cholqr_q"], out["cholqr_r"] = dense(Q), np.triu(dense(R))
        an = float(np.abs(x["a"]).sum(0).max())
        out["gecondest"] = float(pkg.gecondest(pkg.Norm.One, LU, piv, an))
        mixed += [("gesv_mixed_gmres", "A"), ("posv_mixed_gmres", "S")]
    for name, key in mixed:
        X, iters, info = getattr(pkg, name)(m[key], m["B"])
        out[name] = (dense(X), int(iters), int(info))
    return out


@pytest.fixture(scope="module")
def refs():
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    jax_out = {dt: run(sj, g, dt) for dt in DTS}
    before = dict(K.LAUNCHES)
    port_out = {dt: run(st, CPU, dt) for dt in DTS}
    assert K.LAUNCHES == before
    return jax_out, port_out


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_cholesky_and_inverses_match_jax(refs, dt):
    """potrf both uplos, posv, a non-HPD info, trtri and potri; the real
    part of the diagonal only is read, as LAPACK's potrf reads it."""
    j, p = refs[0][dt], refs[1][dt]
    tol = TOL[dt]
    assert p["potrf_info"] == j["potrf_info"] == 0
    assert p["potrf_bad"] == j["potrf_bad"] == 2
    for k in ("potrf", "potrf_u", "posv", "trtri", "potri"):
        if k in j:
            assert p[k].dtype == dt and rel(p[k], j[k]) < tol, k
    x = inputs(dt)
    assert rel(x["s"] @ p["posv"], x["b"]) < tol


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_lu_families_match_jax(refs, dt):
    """getrf pivots and info equal, getrs with each op, getri, a
    singular gesv's pivots and info, the unpivoted LU."""
    j, p = refs[0][dt], refs[1][dt]
    tol = TOL[dt]
    assert np.array_equal(p["piv"], j["piv"])
    assert p["getrf_info"] == j["getrf_info"] == 0
    assert np.array_equal(p["sing_piv"], j["sing_piv"])
    assert p["sing_info"] == j["sing_info"] > 0
    assert p["nopiv_info"] == j["nopiv_info"] == 0
    for k in ("getrf", "getrs_NoTrans", "getrs_Trans", "getrs_ConjTrans",
              "getri", "nopiv", "nopiv_lu"):
        if k in j:
            assert p[k].dtype == dt and rel(p[k], j[k]) < tol, k
    x = inputs(dt)
    assert rel(x["a"].conj().T @ p["getrs_ConjTrans"], x["b"]) < tol


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_qr_families_match_jax(refs, dt):
    """geqrf's factors and T, unmqr on both sides with NoTrans and
    ConjTrans, gelqf/unmlq, cholqr and gels (tall and wide)."""
    j, p = refs[0][dt], refs[1][dt]
    tol = TOL[dt]
    for k in ("geqrf", "geqrf_T", "unmqr_Left_NoTrans",
              "unmqr_Left_ConjTrans", "unmqr_Right_NoTrans",
              "unmqr_Right_ConjTrans", "gelqf", "unmlq", "cholqr_q",
              "cholqr_r", "gels", "gels_wide"):
        if k in j:
            assert p[k].dtype == dt and rel(p[k], j[k]) < tol, k
    if "gels_wide" in p:
        # the minimum-norm solution of the wide system solves it
        x = inputs(dt)
        assert rel(x["wide"] @ p["gels_wide"], x["bw"]) < tol


@pytest.mark.parametrize("dt", DTS, ids=IDS)
def test_condest_and_mixed_match_jax(refs, dt):
    """gecondest/pocondest/trcondest; the mixed solves: complex128 factors
    in complex64, complex64 keeps its storage (only f32 takes a tier)."""
    j, p = refs[0][dt], refs[1][dt]
    tol = TOL[dt]
    for k in ("gecondest", "pocondest", "trcondest"):
        if k in j:
            assert abs(p[k] - j[k]) <= tol * j[k], k
    for name in ("gesv_mixed", "posv_mixed", "gesv_mixed_gmres",
                 "posv_mixed_gmres"):
        if name not in j:
            continue
        (px, pit, pinfo), (jx, jit, jinfo) = p[name], j[name]
        assert (pit, pinfo) == (jit, jinfo), name
        assert px.dtype == dt and rel(px, jx) < tol, name


def test_pivot_is_the_largest_abs_re_plus_abs_im():
    """LAPACK's i?amax (and so cuSOLVER and the JAX package's CPU lu)
    picks the pivot by |Re| + |Im|, not by the modulus: on a column where
    the two differ, the panel LU that the port runs past an exact zero
    pivot picks LAPACK's row, and a getrf routed through it gives the JAX
    package's pivots."""
    col = np.array([0.0, 3 + 3j, 5.0 + 0j, 1j])  # |.|: row 2; |Re|+|Im|: 1
    assert np.argmax(np.abs(col)) == 2
    p = torch.from_numpy(np.stack([col, np.zeros(4), np.ones(4),
                                   np.arange(4.0)], 1).astype(np.complex128))
    _, ipiv = pgetrf._panel_getf2(p.clone())
    _, lpiv, _ = torch.linalg.lu_factor_ex(p)
    assert int(ipiv[0]) == 1 == int(lpiv[0]) - 1
    a = rand(16, 16, np.complex128, 11)
    a[:4, 0] = col
    a[4:, 0] = 0.0
    a[:, 5] = 0.0                 # an exact zero pivot in the first panel
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    _, jpiv, jinfo = sj.getrf(sj.Matrix.from_dense(a, nb=8, grid=g))
    _, piv, info = st.getrf(st.Matrix.from_dense(a, nb=8, grid=CPU))
    assert int(info) == int(jinfo) == 1
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert int(piv[0, 0]) == 1


def test_interop_carries_complex_factors():
    """A JAX complex matrix, its LU pivots and its QR T factors cross
    into the port unchanged, and the port solves with them."""
    g = sj.Grid(1, 1, devices=jax.devices()[:1])
    x = inputs(np.complex128)
    JLU, jpiv, _ = sj.getrf(sj.Matrix.from_dense(x["a"], nb=NB, grid=g))
    LU = st.from_reference(np.asarray(JLU.data), kind="Matrix", m=N, n=N,
                           nb=NB, device="cpu")
    f = st.to_reference(LU)
    assert f["data"].dtype == np.complex128
    assert np.array_equal(f["data"], np.asarray(JLU.data))
    piv = st.pivots_from_reference(np.asarray(jpiv), device="cpu")
    X = st.getrs(LU, piv, st.Matrix.from_dense(x["b"], nb=NB, grid=CPU))
    assert rel(x["a"] @ dense(X), x["b"]) < 1e-10
    JQR, JT = sj.geqrf(sj.Matrix.from_dense(x["tall"], nb=NB, grid=g))
    T = st.t_factors_from_reference(np.asarray(JT), device="cpu")
    assert T.dtype == torch.complex128
    assert np.array_equal(st.t_factors_to_reference(T), np.asarray(JT))


@pytest.mark.parametrize("solve", ["trsm", "unmqr", "gbtrs", "pbtrs"])
def test_real_rhs_of_complex_factors_raises(solve):
    """A real right-hand side of complex factors is refused with a
    SlateError, as the JAX package refuses it (a TypeError there),
    instead of losing the solution's imaginary part."""
    x = inputs(np.complex128)
    M = lambda v, cls=st.Matrix, **kw: cls.from_dense(v, nb=NB, grid=CPU,
                                                      **kw)
    b = M(x["b"].real.copy())
    if solve == "trsm":
        call = lambda: st.trsm(st.Side.Left, 1.0,
                               M(x["t"], st.TriangularMatrix), b)
    elif solve == "unmqr":
        QR, T = st.geqrf(M(x["a"]))
        call = lambda: st.unmqr(st.Side.Left, st.Op.ConjTrans, QR, T, b)
    elif solve == "gbtrs":
        F, piv, _ = st.gbtrf(M(x["dom"], st.BandMatrix, kl=3, ku=3))
        call = lambda: st.gbtrs(F, piv, b)
    else:
        L, _ = st.pbtrf(M(np.tril(x["s"]), st.HermitianBandMatrix, kl=3,
                          ku=3))
        call = lambda: st.pbtrs(L, b)
    with pytest.raises(st.SlateError, match="real right-hand side"):
        call()
