"""The port's ``utils/`` (test-matrix generator, printing, debug aids)
and ``version.py`` against the JAX package's, on the CPU.

* Formula kinds (complex128, float32) and structured kinds (svd, heev,
  poev, spd, float64) against ``slate_tpu``'s ``generate_matrix``
  elementwise: the arithmetic is the JAX package's, in its precision;
  the transcendental terms of orthog and chebspec are rounded from f64
  in the port (the card and the CPU then agree to rounding) where JAX's
  f32 sin and cos may be an ulp off, and chebspec's xi − xj cancels,
  so those two are held to 2⁻¹⁶ of the matrix's largest entry in f32
  (1e-12 in f64), every other kind to exact equality. The class
  (Matrix or HermitianMatrix) and dtype are the JAX package's.
* Random kinds: the two RNGs differ, so their values are held to their
  distributions (mean, variance, range, the binary kinds' two values)
  over 96×80 draws, and to depending on the seed and (i, j) (with the
  tile size) only: the same seed gives the same bits, another seed other
  values. A complex random kind has a zero imaginary part, as in the JAX
  package.
* ``print_matrix`` text equals the JAX package's character for
  character at verbose 0–4, for f32, f64 and complex64 matrices and
  triangular and Hermitian shapes.
* ``debug``: ``debug_mode``, ``dump_layout``, ``check_finite``,
  ``diff_matrices``, ``tile_norms``; ``version``.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu.utils import debug as jdebug  # noqa: E402
from slate_tpu.utils import generator as jgen  # noqa: E402
from slate_tpu_torch.utils import debug as pdebug  # noqa: E402
from slate_tpu_torch.utils import generator as pgen  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = st.Grid(1, 1, device="cpu")
M, N, NB = 40, 28, 16


def jgrid():
    return sj.Grid(1, 1, devices=jax.devices()[:1])


def dense(A):
    d = A.to_dense()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.fixture(scope="module")
def jax_kinds():
    g = jgrid()
    out = {}
    for dt in (np.complex128, np.float32):
        for kind in jgen.FORMULA_KINDS:
            A = sj.generate_matrix(kind, M, M if kind != "ij" else N, nb=NB,
                                   grid=g, dtype=dt, dist="geo")
            out[kind, dt] = (type(A).__name__, dense(A))
    for kind in ("svd", "heev", "poev", "spd"):
        A = sj.generate_matrix(kind, M, N if kind == "svd" else M, nb=NB,
                               grid=g, dtype=np.float64, seed=7,
                               dist="arith", cond=1e3)
        out[kind, np.float64] = (type(A).__name__, dense(A))
    return out


def test_formula_and_structured_kinds_match_jax(jax_kinds):
    assert pgen.FORMULA_KINDS == jgen.FORMULA_KINDS
    for (kind, dt), (cls, want) in jax_kinds.items():
        n = {"ij": N, "svd": N}.get(kind, M)
        kw = (dict(seed=7, dist="arith", cond=1e3) if dt == np.float64
              else dict(dist="geo"))
        A = st.generate_matrix(kind, M, n, nb=NB, grid=CPU, dtype=dt, **kw)
        got = dense(A)
        assert type(A).__name__ == cls and got.dtype == want.dtype, kind
        if kind in ("orthog", "chebspec"):
            # one rounding of cos amplified by chebspec's xi − xj
            u = 1e-12 if dt == np.complex128 else 2.0 ** -16
            assert np.abs(got - want).max() <= u * np.abs(want).max(), kind
        else:
            assert np.array_equal(got, want), (kind, dt)
    with pytest.raises(NotImplementedError):
        st.generate_matrix("geev", 8, grid=CPU)
    with pytest.raises(st.SlateError, match="unknown"):
        st.generate_matrix("nonsense", 8, grid=CPU)


@pytest.mark.parametrize("kind,mean,var,lo,hi", [
    ("rand", 0.5, 1 / 12, 0.0, 1.0), ("rands", 0.0, 1 / 3, -1.0, 1.0),
    ("randn", 0.0, 1.0, -6.0, 6.0), ("randb", 0.5, 0.25, 0.0, 1.0),
    ("randr", 0.0, 1.0, -1.0, 1.0)])
def test_random_kinds_by_moments_and_range(kind, mean, var, lo, hi):
    m, n = 96, 80
    x = dense(st.generate_matrix(kind, m, n, nb=32, grid=CPU, seed=11))
    assert x.dtype == np.float32 and x.shape == (m, n)
    # mean and variance within 5 standard errors of m·n draws
    se = (var / (m * n)) ** 0.5
    assert abs(x.mean() - mean) < 5 * se
    assert abs(x.var() - var) < 5 * var * (2 / (m * n)) ** 0.5 * \
        (3 if kind == "randn" else 1)
    assert lo <= x.min() and x.max() <= hi
    if kind in ("randb", "randr"):
        assert set(np.unique(x)) == {lo, hi}
    # the same seed and nb give the same bits, another seed other values
    y = dense(st.generate_matrix(kind, m, n, nb=32, grid=CPU, seed=11))
    z = dense(st.generate_matrix(kind, m, n, nb=32, grid=CPU, seed=12))
    assert np.array_equal(x, y) and not np.array_equal(x, z)


def test_random_kinds_complex_dominant_and_spd():
    """A complex random kind has a zero imaginary part (JAX draws real and
    casts); ``dominant`` adds n on the diagonal; ``random_spd`` is
    G·Gᵀ/n + I for the randn G of the same seed."""
    c = dense(st.generate_matrix("randn", 20, nb=8, grid=CPU,
                                 dtype=np.complex64, seed=3))
    r = dense(st.generate_matrix("randn", 20, nb=8, grid=CPU, seed=3))
    assert c.dtype == np.complex64 and not c.imag.any()
    assert np.array_equal(c.real, r)
    d = dense(st.generate_matrix("randn", 20, nb=8, grid=CPU, seed=3,
                                 dominant=True))
    assert np.allclose(d - r, 20 * np.eye(20))
    S = st.random_spd(24, nb=8, grid=CPU, dtype=torch.float64, seed=5)
    g = dense(st.random_matrix(24, 24, nb=8, grid=CPU, dtype=torch.float64,
                               seed=5)).astype(np.float64)
    s = dense(S)
    assert isinstance(S, st.HermitianMatrix)
    assert np.abs(np.tril(s) - np.tril(g @ g.T / 24 + np.eye(24))).max() \
        < 1e-12
    # nb defaults as the JAX package's: min(256, max(8, m))
    assert st.random_matrix(12, 5, grid=CPU).nb == 12


def test_print_matrix_text_equals_jax():
    g = jgrid()
    cases = [("hilb", 6, 6, np.float32, {}), ("ij", 50, 40, np.complex64,
                                             {"PrintEdgeItems": 4}),
             ("minij", 40, 40, np.float64, {"PrintEdgeItems": 3}),
             ("kms", 10, 10, np.float64, {"PrintPrecision": 6,
                                          "PrintWidth": 12})]
    for kind, m, n, dt, extra in cases:
        J = sj.generate_matrix(kind, m, n, nb=8, grid=g, dtype=dt)
        P = st.generate_matrix(kind, m, n, nb=8, grid=CPU, dtype=dt)
        shaped = [(J, P)]
        if m == n:
            shaped.append((sj.TriangularMatrix(data=J.data, m=m, n=n, nb=8,
                                               grid=g, uplo=sj.Uplo.Upper),
                           st.TriangularMatrix(data=P.data, m=m, n=n, nb=8,
                                               grid=CPU,
                                               uplo=st.Uplo.Upper)))
        for JA, PA in shaped:
            for v in range(5):
                jo = {sj.Option.PrintVerbose: v,
                      **{sj.Option[k]: x for k, x in extra.items()}}
                po = {st.Option.PrintVerbose: v,
                      **{st.Option[k]: x for k, x in extra.items()}}
                want = sj.print_matrix("A", JA, jo, file=io.StringIO())
                got = st.print_matrix("A", PA, po, file=io.StringIO())
                assert got == want, (kind, type(PA).__name__, v)


def test_debug_aids_and_version(monkeypatch):
    g = jgrid()
    a = np.arange(30.0).reshape(6, 5)
    J = sj.Matrix.from_dense(a, nb=4, grid=g)
    P = st.Matrix.from_dense(a, nb=4, grid=CPU)
    monkeypatch.setenv("SLATE_TPU_DEBUG", "1")
    assert pdebug.debug_mode() and jdebug.debug_mode()
    monkeypatch.setenv("SLATE_TPU_DEBUG", "0")
    assert not pdebug.debug_mode()
    text = pdebug.dump_layout(P, out=io.StringIO())
    jtext = jdebug.dump_layout(J, out=io.StringIO())
    assert text.splitlines()[:2] == jtext.splitlines()[:2]
    assert text.splitlines()[2] == "  (0,0)->cpu (0,1)->cpu"
    pdebug.check_finite(P)
    bad = a.copy()
    bad[5, 1] = np.nan
    with pytest.raises(FloatingPointError, match=r"A\[5,1\].*tile \(1,0\)"):
        pdebug.check_finite(st.Matrix.from_dense(bad, nb=4, grid=CPU))
    b = a.copy()
    b[0, 4] += 1.0
    Q = st.Matrix.from_dense(b, nb=4, grid=CPU)
    out, jout = io.StringIO(), io.StringIO()
    assert pdebug.diff_matrices(P, Q, out=out) == 1 == jdebug.diff_matrices(
        J, sj.Matrix.from_dense(b, nb=4, grid=g), out=jout)
    assert out.getvalue() == jout.getvalue() == ".*\n..\n"
    assert np.array_equal(pdebug.tile_norms(P), jdebug.tile_norms(J))
    assert st.__version__ == sj.__version__ and st.version() == sj.version()
    assert st.id() == "slate_tpu_torch-" + sj.__version__
