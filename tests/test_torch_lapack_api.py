"""The port's LAPACK-compatibility shims (``slate_tpu_torch.lapack_api``)
against the JAX package's (``slate_tpu.lapack_api``) on the same numpy
inputs, on the CPU. The JAX shims take ``default_grid()``, the tests' 2×4
mesh; a module fixture points them at a 1×1 grid instead (the JAX package
is not edited). The port's shims are given ``Grid(1, 1, device="cpu")``.
Each JAX reference is computed once per module.

Tolerances: ``info``, pivots and ``iters`` equal; results within 1e-10
relative in float64 and 1e-4 in float32 (the two packages sum in other
orders). Eigen- and singular vectors are unique up to sign, so they are
held to their residuals at the same bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu.lapack_api as jla  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch import lapack_api as pla  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
N, NB = 64, 16
TOL = {"s": 1e-4, "d": 1e-10}
DT = {"s": np.float32, "d": np.float64}


def rel(x, ref):
    x, ref = np.asarray(x, np.complex128), np.asarray(ref, np.complex128)
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


@pytest.fixture(scope="module")
def jgrid(grid11):
    """The JAX shims on a 1×1 grid for this module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jla, "default_grid", lambda: grid11)
    yield grid11
    mp.undo()


def inputs(pre):
    dt = DT[pre]
    return dict(a=rand(N, N, dt, 1), s=spd(N, dt, 2), b=rand(N, 3, dt, 3),
                t=(np.tril(rand(N, N, dt, 4)) + N * np.eye(N)).astype(dt),
                c=rand(N, N, dt, 5), tall=rand(2 * N, N // 2, dt, 6),
                btall=rand(2 * N, 2, dt, 7))


@pytest.fixture(scope="module")
def jax_lu(jgrid):
    out = {}
    for pre in "sd":
        x = inputs(pre)
        lu, piv, info = getattr(jla, f"slate_{pre}getrf")(x["a"], nb=NB)
        out[pre] = dict(
            gesv=getattr(jla, f"slate_{pre}gesv")(x["a"], x["b"], nb=NB),
            getrf=(np.asarray(lu), np.asarray(piv), info),
            getrs_n=getattr(jla, f"slate_{pre}getrs")(
                "n", lu, np.asarray(piv).reshape(-1), x["b"], nb=NB),
            getrs_t=getattr(jla, f"slate_{pre}getrs")("t", lu, piv, x["b"],
                                                     nb=NB),
            getri=getattr(jla, f"slate_{pre}getri")(lu, piv, nb=NB))
    return out


@pytest.mark.parametrize("pre", ["s", "d"])
def test_lu_family_matches_jax(jax_lu, pre):
    ref, x, tol = jax_lu[pre], inputs(pre), TOL[pre]
    X, info = getattr(pla, f"slate_{pre}gesv")(x["a"], x["b"], nb=NB,
                                               grid=CPU)
    assert info == ref["gesv"][1] == 0
    assert X.dtype == DT[pre] and rel(X, ref["gesv"][0]) < tol
    lu, piv, info = getattr(pla, f"slate_{pre}getrf")(x["a"], nb=NB, grid=CPU)
    assert info == ref["getrf"][2] and piv.shape == (N // NB, NB)
    assert piv.dtype == np.int32 and np.array_equal(piv, ref["getrf"][1])
    assert rel(lu, ref["getrf"][0]) < tol
    Xn = getattr(pla, f"slate_{pre}getrs")("n", lu, piv.reshape(-1), x["b"],
                                          nb=NB, grid=CPU)
    Xt = getattr(pla, f"slate_{pre}getrs")("t", lu, piv, x["b"], nb=NB,
                                          grid=CPU)
    assert rel(Xn, ref["getrs_n"]) < tol and rel(Xt, ref["getrs_t"]) < tol
    inv = getattr(pla, f"slate_{pre}getri")(lu, piv, nb=NB, grid=CPU)
    assert rel(inv, ref["getri"]) < tol


@pytest.fixture(scope="module")
def jax_chol(jgrid):
    out = {}
    for pre in "sd":
        x = inputs(pre)
        r = {}
        for u in "LU":
            r["posv" + u] = getattr(jla, f"slate_{pre}posv")(u, x["s"], x["b"],
                                                            nb=NB)
            f, info = getattr(jla, f"slate_{pre}potrf")(u, x["s"], nb=NB)
            r["potrf" + u] = (f, info)
            r["potrs" + u] = getattr(jla, f"slate_{pre}potrs")(u, f, x["b"],
                                                              nb=NB)
            r["potri" + u] = getattr(jla, f"slate_{pre}potri")(u, f, nb=NB)
        out[pre] = r
    return out


@pytest.mark.parametrize("pre", ["s", "d"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_family_matches_jax(jax_chol, pre, uplo):
    """Lower: against the JAX shims. Upper: the factor against JAX's;
    posv, potrs and potri against the exact solution and inverse, since
    the JAX package's potrs and trtrm treat an upper factor as a lower
    one (ROADMAP §C) and its results there are off by O(1)."""
    ref, x, tol = jax_chol[pre], inputs(pre), TOL[pre]
    s64 = x["s"].astype(np.float64)
    want_x = np.linalg.solve(s64, x["b"])
    X, info = getattr(pla, f"slate_{pre}posv")(uplo, x["s"], x["b"], nb=NB,
                                               grid=CPU)
    assert info == ref["posv" + uplo][1] == 0
    f, info = getattr(pla, f"slate_{pre}potrf")(uplo, x["s"], nb=NB, grid=CPU)
    assert info == ref["potrf" + uplo][1] == 0
    assert rel(f, ref["potrf" + uplo][0]) < tol
    assert not (np.triu(f, 1) if uplo == "L" else np.tril(f, -1)).any()
    Xs = getattr(pla, f"slate_{pre}potrs")(uplo, f, x["b"], nb=NB, grid=CPU)
    inv = getattr(pla, f"slate_{pre}potri")(uplo, f, nb=NB, grid=CPU)
    assert np.array_equal(inv, inv.T)
    if uplo == "L":
        assert rel(X, ref["posvL"][0]) < tol and rel(Xs, ref["potrsL"]) < tol
        assert rel(inv, ref["potriL"]) < tol
    else:
        assert rel(ref["posvU"][0], want_x) > 0.01       # the JAX fault
        assert rel(ref["potriU"], np.linalg.inv(s64)) > 0.01
    assert rel(X, want_x) < tol and rel(Xs, want_x) < tol
    assert rel(inv, np.linalg.inv(s64)) < tol


@pytest.fixture(scope="module")
def jax_qr_mixed(jgrid):
    out = {}
    for pre in "sd":
        x = inputs(pre)
        qr, T = getattr(jla, f"slate_{pre}geqrf")(x["tall"], nb=NB)
        out[pre] = dict(
            geqrf=(np.asarray(qr), np.asarray(T)),
            gels=getattr(jla, f"slate_{pre}gels")(x["tall"], x["btall"],
                                                  nb=NB),
            mixed=getattr(jla, f"slate_{pre}gesv_mixed")(
                x["s"], x["b"], nb=NB))
    return out


@pytest.mark.parametrize("pre", ["s", "d"])
def test_qr_and_mixed_families_match_jax(jax_qr_mixed, pre):
    ref, x, tol = jax_qr_mixed[pre], inputs(pre), TOL[pre]
    qr, T = getattr(pla, f"slate_{pre}geqrf")(x["tall"], nb=NB, grid=CPU)
    assert T.shape == ref["geqrf"][1].shape
    assert rel(qr, ref["geqrf"][0]) < tol and rel(T, ref["geqrf"][1]) < tol
    X = getattr(pla, f"slate_{pre}gels")(x["tall"], x["btall"], nb=NB,
                                         grid=CPU)
    assert X.shape == (N // 2, 2) and rel(X, ref["gels"]) < tol
    X, iters, info = getattr(pla, f"slate_{pre}gesv_mixed")(
        x["s"], x["b"], nb=NB, grid=CPU)
    assert (iters, info) == tuple(ref["mixed"][1:])
    assert rel(X, ref["mixed"][0]) < tol


@pytest.fixture(scope="module")
def jax_blas(jgrid):
    out = {}
    for pre in "sd":
        x = inputs(pre)
        a, s, c, t, b = x["a"], x["s"], x["c"], x["t"], x["c"][:, :8]
        out[pre] = dict(
            gemm=getattr(jla, f"slate_{pre}gemm")("t", "n", 1.5, a, c, 0.5, s,
                                                  nb=NB),
            symm=getattr(jla, f"slate_{pre}symm")("R", "U", 2.0, s, c, 0.5, a,
                                                  nb=NB),
            syrk=getattr(jla, f"slate_{pre}syrk")("L", "t", 1.0, a, 0.5, s,
                                                  nb=NB),
            syr2k=getattr(jla, f"slate_{pre}syr2k")("U", "n", 1.0, a, c, 2.0,
                                                    s, nb=NB),
            trmm=getattr(jla, f"slate_{pre}trmm")("L", "L", "T", "N", 2.0, t,
                                                  b, nb=NB),
            trsm=getattr(jla, f"slate_{pre}trsm")("R", "L", "N", "U", 1.0, t,
                                                  c, nb=NB))
    return out


@pytest.mark.parametrize("pre", ["s", "d"])
@pytest.mark.parametrize("name", ["gemm", "symm", "syrk", "syr2k", "trmm",
                                  "trsm"])
def test_blas3_family_matches_jax(jax_blas, pre, name):
    x = inputs(pre)
    a, s, c, t, b = x["a"], x["s"], x["c"], x["t"], x["c"][:, :8]
    args = dict(gemm=("t", "n", 1.5, a, c, 0.5, s),
                symm=("R", "U", 2.0, s, c, 0.5, a),
                syrk=("L", "t", 1.0, a, 0.5, s),
                syr2k=("U", "n", 1.0, a, c, 2.0, s),
                trmm=("L", "L", "T", "N", 2.0, t, b),
                trsm=("R", "L", "N", "U", 1.0, t, c))[name]
    out = getattr(pla, f"slate_{pre}{name}")(*args, nb=NB, grid=CPU)
    assert out.dtype == DT[pre]
    assert rel(out, jax_blas[pre][name]) < TOL[pre]


@pytest.mark.parametrize("pre", ["s", "d"])
def test_norm_family_matches_jax(jgrid, pre):
    x = inputs(pre)
    for k in "M1OIFE":
        for shim, args in (("lange", (x["a"],)), ("lansy", ("L", x["a"])),
                           ("lantr", ("U", "U", x["a"]))):
            want = getattr(jla, f"slate_{pre}{shim}")(k, *args, nb=NB)
            got = getattr(pla, f"slate_{pre}{shim}")(k, *args, nb=NB,
                                                     grid=CPU)
            assert isinstance(got, float)
            assert abs(got - want) <= TOL[pre] * abs(want), (shim, k)


@pytest.mark.parametrize("pre", ["s", "d"])
def test_eig_and_svd_families_match_jax(jgrid, pre):
    x, tol = inputs(pre), TOL[pre]
    a = x["s"] - 2 * np.eye(N, dtype=DT[pre])
    jw, _, jinfo = getattr(jla, f"slate_{pre}syev")("N", "L", a, nb=NB)
    w, z, info = getattr(pla, f"slate_{pre}syev")("N", "L", a, nb=NB,
                                                  grid=CPU)
    assert z is None and info == jinfo == 0 and rel(w, jw) < tol
    w, z, info = getattr(pla, f"slate_{pre}syev")("V", "L", a, nb=NB,
                                                  grid=CPU)
    assert rel(w, jw) < tol
    assert rel(a @ z, z * w[None, :]) < tol
    assert rel(z.T @ z, np.eye(N)) < tol
    g = x["tall"]
    js, _, _, jinfo = getattr(jla, f"slate_{pre}gesvd")("N", "N", g, nb=NB)
    s, u, vt, info = getattr(pla, f"slate_{pre}gesvd")("N", "N", g, nb=NB,
                                                       grid=CPU)
    assert u is None and vt is None and info == jinfo == 0
    assert rel(s, js) < tol
    s, u, vt, info = getattr(pla, f"slate_{pre}gesvd")("V", "V", g, nb=NB,
                                                       grid=CPU)
    assert rel(s, js) < tol and rel((u[:, :N // 2] * s) @ vt[:N // 2], g) < tol


def test_singular_gesv_info_matches_jax(jgrid):
    a = rand(N, N, np.float64, 8)
    a[:, 7] = 0.0
    b = rand(N, 1, np.float64, 9)
    _, jinfo = jla.slate_dgesv(a, b, nb=NB)
    _, info = pla.slate_dgesv(a, b, nb=NB, grid=CPU)
    assert info == jinfo > 0


def test_names_match_jax():
    assert set(pla.__all__) == set(jla.__all__)
    for name in pla.__all__:
        assert getattr(pla, name).__name__ == name


def complex_calls(pre):
    """Each complex shim family that runs, with its arguments: inputs
    with O(1) imaginary parts, a Hermitian h for the he* families."""
    dt = {"c": np.complex64, "z": np.complex128}[pre]
    a, s, b, t, c = (rand(N // 2, N // 2, dt, 1), spd(N // 2, dt, 2),
                     rand(N // 2, 3, dt, 3),
                     (np.tril(rand(N // 2, N // 2, dt, 4))
                      + N * np.eye(N // 2)).astype(dt),
                     rand(N // 2, N // 2, dt, 5))
    h = rand(N // 2, N // 2, dt, 8)
    h = ((h + h.conj().T) / 2).astype(dt)
    tall, bt = rand(N, N // 4, dt, 6), rand(N, 2, dt, 7)
    calls = dict(
        gesv=(a, b), posv=("L", s, b), potrf=("U", s), getrf=(a,),
        geqrf=(tall,), gels=(tall, bt), gesv_mixed=(a, b),
        gemm=("c", "n", 1.5 + 0.5j, a, c, 0.5, s), lange=("F", a),
        lantr=("1", "U", "N", a), lansy=("I", "L", h), lanhe=("1", "U", h),
        trmm=("L", "L", "C", "N", 2.0, t, c[:, :8]),
        trsm=("R", "U", "C", "U", 1.0, t, c),
        symm=("R", "U", 2.0, s, c, 0.5, a), syrk=("L", "t", 1.0, a, 0.5, s),
        syr2k=("U", "n", 1.0, a, c, 2.0, s),
        hemm=("L", "L", 1.0 - 1j, h, c, 0.5, a),
        herk=("U", "c", 1.0, a, 0.5, h), her2k=("L", "n", 1.0 + 1j, a, c,
                                                2.0, h))
    return calls, a, s, b, h


@pytest.mark.parametrize("pre", ["c", "z"])
def test_complex_shims_raise(jgrid, pre):
    """All 26 complex families give the JAX shims' results (``info``,
    pivots and ``iters`` equal, the rest within TOL), heev and gesvd
    included: their λ and σ in the real dtype, and slate_?heev('V')'s
    vectors by residual."""
    names = [n for n in pla.__all__ if n.startswith(f"slate_{pre}")]
    assert len(names) == 26
    tol = {"c": 1e-4, "z": 1e-10}[pre]
    calls, a, s, b, h = complex_calls(pre)
    lu, piv, _ = getattr(jla, f"slate_{pre}getrf")(a, nb=NB)
    f, _ = getattr(jla, f"slate_{pre}potrf")("L", s, nb=NB)
    calls.update({"getrs": ("c", lu, piv, b), "getri": (lu, piv),
                  "potrs": ("L", f, b), "potri": ("L", f)})
    assert len(calls) == 24
    for name, args in calls.items():
        want = getattr(jla, f"slate_{pre}{name}")(*args, nb=NB)
        got = getattr(pla, f"slate_{pre}{name}")(*args, nb=NB, grid=CPU)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for x, ref in zip(got, want):
            if np.ndim(ref) == 0 or np.asarray(ref).dtype.kind == "i":
                if isinstance(ref, float):
                    assert abs(x - ref) <= tol * abs(ref), name
                else:
                    assert np.array_equal(x, ref), name
            else:
                assert x.dtype == np.asarray(ref).dtype, name
                assert rel(x, ref) < tol, name
    # an Upper posv against the exact solution: the JAX package's potrs
    # treats an upper factor as a lower one (ROADMAP §C)
    X, info = getattr(pla, f"slate_{pre}posv")("U", s, b, nb=NB, grid=CPU)
    assert info == 0 and rel(X, np.linalg.solve(s.astype(np.complex128),
                                                b)) < tol
    rdt = {"c": np.float32, "z": np.float64}[pre]
    for name, args in (("heev", ("N", "L", h)), ("gesvd", ("N", "N", a))):
        want = getattr(jla, f"slate_{pre}{name}")(*args, nb=NB)
        got = getattr(pla, f"slate_{pre}{name}")(*args, nb=NB, grid=CPU)
        assert got[0].dtype == np.asarray(want[0]).dtype == rdt, name
        assert rel(got[0], want[0]) < tol and got[-1] == want[-1] == 0
        assert all(x is None for x in got[1:-1]), name
    w, z, info = getattr(pla, f"slate_{pre}heev")("V", "L", h, nb=NB,
                                                   grid=CPU)
    z = z.astype(np.complex128)
    assert info == 0 and np.linalg.norm(h @ z - z * w) \
        < tol * np.linalg.norm(h) * N


def test_lapack_api_family_count():
    """Routine-family parity with reference lapack_api/lapack_*.cc, as
    tests/test_compat_api.py holds the JAX package to it."""
    fams = {"gels", "gemm", "gesv", "gesv_mixed", "getrf", "getri",
            "getrs", "hemm", "her2k", "herk", "lange", "lanhe",
            "lansy", "lantr", "posv", "potrf", "potri", "symm",
            "syr2k", "syrk", "trmm", "trsm",
            "geqrf", "potrs", "gesvd"}
    have = set()
    for name in pla.__all__:
        base = name.split("_", 1)[1][1:]        # strip slate_<pre>
        if name.endswith("gesv_mixed"):
            base = "gesv_mixed"
        have.add(base)
    assert not fams - have, f"lapack_api families missing: {fams - have}"


def test_getrs_rejects_mismatched_ipiv_nb():
    """Pivots regrouped under a different nb must raise, not silently
    produce a wrong solve (tests/test_compat_api.py:256)."""
    rng = np.random.default_rng(3)
    n = 64
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    lu, piv, info = pla.slate_dgetrf(a, nb=16, grid=CPU)
    assert info == 0
    b = rng.standard_normal((n, 1))
    x = pla.slate_dgetrs("n", lu, piv, b, nb=16, grid=CPU)
    assert np.linalg.norm(a @ x - b) < 1e-8 * np.linalg.norm(b) * n
    for bad_nb in (32, 8):
        with pytest.raises(pst.SlateError, match="pivot blocking"):
            pla.slate_dgetrs("n", lu, piv, b, nb=bad_nb, grid=CPU)
        with pytest.raises(pst.SlateError, match="pivot blocking"):
            pla.slate_dgetri(lu, piv, nb=bad_nb, grid=CPU)
    with pytest.raises(pst.SlateError, match="ipiv length"):
        pla.slate_dgetrs("n", lu, piv.reshape(-1)[:48], b, nb=16, grid=CPU)


def test_shims_default_to_the_card():
    """Without ``grid`` a shim takes ``default_grid()``: the CUDA card, or
    a SlateError where there is none; it never falls back to the CPU."""
    a = np.eye(4)
    if torch.cuda.is_available():
        assert pst.default_grid().device.type == "cuda"
        x, info = pla.slate_dgesv(a, np.ones(4))
        assert info == 0 and np.allclose(x[:, 0], 1.0)
    else:
        for fn in (pst.default_grid, lambda: pla.slate_dgesv(a, a),
                   lambda: pla.slate_slange("F", a)):
            with pytest.raises(pst.SlateError, match="CUDA"):
                fn()
