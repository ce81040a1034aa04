"""The port's norms, elementwise ops, condition estimates, health reports
and inverses on the CPU against the JAX package on a 1×1 grid.

Tolerances: norms within 1e-6 relative in f32 and 1e-12 in f64 (both
sides sum the same masked elements in other orders); elementwise ops
equal to 1e-6 relative in f32 (a rounding each) with the padding exactly
zero; rcond estimates within 1e-6 relative (f64 factors carried across
with ``interop``, the same estimator iterates); ``HealthReport`` fields
equal, growth within 1e-6; inverses within 1e-10 relative (f64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu.ops import elementwise as jel  # noqa: E402
from slate_tpu_torch.ops import elementwise as pel  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = st.Grid(1, 1, device="cpu")
NORM_TOL = {np.float32: 1e-6, np.float64: 1e-12}
KINDS = ("Max", "One", "Inf", "Fro")


def jgrid():
    return sj.Grid(1, 1, devices=jax.devices()[:1])


def carry(A):
    """A JAX matrix → the port's matrix on the CPU."""
    return st.from_reference(np.asarray(A.data), kind=type(A).__name__,
                             m=A.m, n=A.n, nb=A.nb, op=A.op.name,
                             uplo=A.uplo.name, diag=A.diag.name,
                             device="cpu")


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


# (label, m, n, nb, class, fields): ragged sizes; the stored junk half of
# the Hermitian and triangular matrices is random, so reading it shows
SHAPES = [
    ("general", 70, 45, 16, "Matrix", {}),
    ("herm_lower", 61, 61, 16, "HermitianMatrix", {"uplo": "Lower"}),
    ("herm_upper", 61, 61, 16, "HermitianMatrix", {"uplo": "Upper"}),
    ("tri_lower", 50, 50, 16, "TriangularMatrix", {"uplo": "Lower"}),
    ("tri_upper_unit", 50, 50, 16, "TriangularMatrix",
     {"uplo": "Upper", "diag": "Unit"}),
    ("band", 70, 70, 16, "BandMatrix", {"kl": 3, "ku": 5}),
]


def both(label, dt):
    """The same matrix in both packages."""
    _, m, n, nb, cls, f = next(s for s in SHAPES if s[0] == label)
    a = rand(m, n, dt, m + n)
    jkw = {k: (getattr(sj, k.capitalize())[v] if isinstance(v, str) else v)
           for k, v in f.items()}
    pkw = {k: (getattr(st, k.capitalize())[v] if isinstance(v, str) else v)
           for k, v in f.items()}
    return (getattr(sj, cls).from_dense(a, nb=nb, grid=jgrid(), **jkw),
            getattr(st, cls).from_dense(a, nb=nb, grid=CPU, **pkw))


@pytest.mark.parametrize("label", [s[0] for s in SHAPES])
def test_norm_matches_jax(label):
    for dt in (np.float32, np.float64):
        J, A = both(label, dt)
        for kind in KINDS:
            ref = float(sj.norm(getattr(sj.Norm, kind), J))
            out = st.norm(getattr(st.Norm, kind), A)
            assert out.dim() == 0 and out.device == torch.device("cpu")
            assert abs(float(out) - ref) <= NORM_TOL[dt] * ref, (kind, dt)


def test_col_norms_and_scope():
    J, A = both("general", np.float64)
    ref = np.asarray(sj.col_norms(sj.Norm.Max, J))
    out = st.col_norms(st.Norm.Max, A)
    assert out.shape == (45,)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        st.norm(st.Norm.Max, A, st.NormScope.Columns).numpy(), ref)
    with pytest.raises(st.SlateError):
        st.col_norms(st.Norm.One, A)


def test_elementwise_matches_jax():
    J, A = both("general", np.float32)
    J2, A2 = both("general", np.float32)
    J2, A2 = (M._replace(data=M.data * 0.5) for M in (J2, A2))
    r, c = rand(1, 70, np.float32, 1)[0], rand(1, 45, np.float32, 2)[0]
    cases = [
        (jel.add(2.0, J, -0.5, J2), pel.add(2.0, A, -0.5, A2)),
        (jel.copy(J, J2.astype(np.float64)),
         pel.copy(A, A2.astype(torch.float64))),
        (jel.scale(3.0, 7.0, J), pel.scale(3.0, 7.0, A)),
        (jel.scale_row_col(r, c, J), pel.scale_row_col(r, c, A)),
        (jel.set_matrix(0.25, 2.0, J), pel.set_matrix(0.25, 2.0, A)),
        (jel._add_scaled_identity(J, 1.5), pel._add_scaled_identity(A, 1.5)),
    ]
    JL, AL = both("tri_lower", np.float32)
    cases.append((jel.set_matrix(0.25, 2.0, JL),
                  pel.set_matrix(0.25, 2.0, AL)))
    for Jo, Ao in cases:
        jd, pd = np.asarray(Jo.to_dense()), Ao.to_dense().numpy()
        assert pd.dtype == jd.dtype and pd.shape == jd.shape == Ao.shape
        np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=0)
        # the padding (rows ≥ m, cols ≥ n) stays exactly zero; the JAX
        # package's _add_scaled_identity writes (45, 45) … (47, 47) here
        tiles = st.tiles_to_dense(st.bc_to_tiles(Ao.data),
                                  Ao.mtl * Ao.nb, Ao.ntl * Ao.nb)
        assert not tiles[Ao.m:].any() and not tiles[:, Ao.n:].any()
    # set_matrix writes nothing outside the triangle
    assert not torch.triu(cases[-1][1].to_dense(), 1).any()


# ---------------------------------------------------------------------------
# condest, health reports, inverses (f64, factors carried across)
# ---------------------------------------------------------------------------

_F = {}


def factors():
    """JAX getrf and potrf factors of one matrix each (n = 61, nb = 16),
    and their carried copies."""
    if not _F:
        n, nb = 61, 16
        a = rand(n, n, np.float64, 31) + 4 * np.eye(n)
        s = spd(n, np.float64, 32)
        LUj, pivj, _ = sj.getrf(sj.Matrix.from_dense(a, nb=nb, grid=jgrid()))
        Lj, _ = sj.potrf(sj.HermitianMatrix.from_dense(s, nb=nb,
                                                       grid=jgrid()))
        _F.update(a=a, s=s, LUj=LUj, pivj=pivj, Lj=Lj, LU=carry(LUj),
                  piv=st.pivots_from_reference(np.asarray(pivj),
                                               device="cpu"),
                  L=carry(Lj))
    return _F


@pytest.mark.parametrize("which", ["gecondest", "pocondest", "trcondest"])
def test_condest_matches_jax(which):
    f = factors()
    if which == "gecondest":
        an = float(np.abs(f["a"]).sum(axis=0).max())
        ref = sj.gecondest(sj.Norm.One, f["LUj"], f["pivj"], an)
        out = st.gecondest(st.Norm.One, f["LU"], f["piv"], an)
        true = 1 / (an * np.abs(np.linalg.inv(f["a"])).sum(axis=0).max())
    elif which == "pocondest":
        an = float(np.abs(f["s"]).sum(axis=0).max())
        ref = sj.pocondest(sj.Norm.One, f["Lj"], an)
        out = st.pocondest(st.Norm.One, f["L"], an)
        true = 1 / (an * np.abs(np.linalg.inv(f["s"])).sum(axis=0).max())
    else:
        ref = sj.trcondest(sj.Norm.One, f["Lj"])
        out = st.trcondest(st.Norm.One, f["L"])
        l = np.tril(np.asarray(f["Lj"].to_dense()))
        true = 1 / (np.abs(l).sum(axis=0).max()
                    * np.abs(np.linalg.inv(l)).sum(axis=0).max())
    assert abs(out - float(ref)) <= 1e-6 * float(ref)
    # an estimate of ‖A⁻¹‖₁ from below: rcond from above, within 10×
    assert true * (1 - 1e-9) <= out <= 10 * true


def health_pair(routine, ok):
    n, nb = 61, 16
    if routine == "potrf":
        a = spd(n, np.float64, 33)
        if not ok:
            a[40, 40] = -5.0
        return (sj.potrf(sj.HermitianMatrix.from_dense(a, nb=nb, grid=jgrid()),
                         health=True)[-1],
                st.potrf(st.HermitianMatrix.from_dense(a, nb=nb, grid=CPU),
                         health=True)[-1])
    if routine == "getrf":
        a = rand(n, n, np.float64, 34) + 4 * np.eye(n)
        if not ok:
            a[:, 7] = 0.0
        return (sj.getrf(sj.Matrix.from_dense(a, nb=nb, grid=jgrid()),
                         health=True)[-1],
                st.getrf(st.Matrix.from_dense(a, nb=nb, grid=CPU),
                         health=True)[-1])
    g = rand(n, n, np.float64, 35)
    a = (g + g.T) / 2
    if not ok:
        a[9, :] = a[:, 9] = 0.0
    return (sj.hetrf(sj.HermitianMatrix.from_dense(np.tril(a), nb=nb,
                                                   grid=jgrid()),
                     health=True)[-1],
            st.hetrf(st.HermitianMatrix.from_dense(np.tril(a), nb=nb,
                                                   grid=CPU),
                     health=True)[-1])


@pytest.mark.parametrize("routine", ["potrf", "getrf", "hetrf"])
def test_health_report_matches_jax(routine):
    st.recent_reports()
    for ok in (True, False):
        ref, out = health_pair(routine, ok)
        assert isinstance(out, st.HealthReport) and out.ok == ok
        d, dr = out.as_dict(), ref.as_dict()
        g, gr = d.pop("growth"), dr.pop("growth")
        assert d == dr, (d, dr)
        assert (g is None) == (gr is None)
        if gr is not None:
            assert abs(g - gr) <= 1e-6 * gr
        assert st.recent_reports()[-1] is out
    if routine == "potrf":
        assert out.first_bad_tile == (out.info - 1, out.info - 1)
        assert out.growth is None
        from slate_tpu.robust.guards import host_info_from_diag as jinfo
        from slate_tpu_torch.robust.guards import host_info_from_diag
        d = np.ones(61)
        for bad in (None, 0, 40, 60):
            if bad is not None:
                d[bad] = np.nan
            assert host_info_from_diag(d, 16) == jinfo(d, 16)
        assert host_info_from_diag(d, 16) == 1
    with pytest.raises(Exception):
        out.info = 0                             # frozen


@pytest.mark.parametrize("which", ["trtri", "potri", "getri"])
def test_inverse_matches_jax(which):
    f = factors()
    if which == "trtri":
        ref, out = sj.trtri(f["Lj"]), st.trtri(f["L"])
        assert out.uplo == st.Uplo.Lower
        ref_d = np.tril(np.asarray(ref.to_dense()))
        assert rel(np.tril(out.to_dense().numpy()), ref_d) <= 1e-10
        return
    if which == "potri":
        ref, out = sj.potri(f["Lj"]), st.potri(f["L"])
        inv = np.linalg.inv(f["s"])
        st_out = st.chol_inverse_using_factor(f["L"])
    else:
        ref, out = sj.getri(f["LUj"], f["pivj"]), st.getri(f["LU"], f["piv"])
        inv = np.linalg.inv(f["a"])
        st_out = st.lu_inverse_using_factor(f["LU"], f["piv"])
        np.testing.assert_array_equal(
            st.lu_inverse_using_factor_out_of_place(
                f["LU"], f["piv"]).to_dense().numpy(),
            st_out.to_dense().numpy())
    o = out.to_dense().numpy()
    assert rel(o, np.asarray(ref.to_dense())) <= 1e-10
    assert rel(o, inv) <= 1e-10
    np.testing.assert_array_equal(st_out.to_dense().numpy(), o)
