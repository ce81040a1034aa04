"""The port's p×q BLAS (gemm by SUMMA, the Cannon ring and stationary-A;
herk and syrk; trsm on both sides, both triangles, unit and non-unit,
with transposed views) against the JAX package's SPMD bodies on meshes
of virtual CPU devices, and the p×q norms against the JAX package's.

Ragged shapes with nb = 8, float64 and complex128; held to 1e-12
relative to the largest entry (the two packages sum in other orders),
the norms to n·2⁻⁵³ relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.types import MethodGemm as JMethodGemm  # noqa: E402
from slate_tpu.types import Option as JOption  # noqa: E402
from slate_tpu_torch.types import MethodGemm, Option  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

NB = 8


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def close(x, ref, tol=1e-12):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    assert np.abs(x - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def both(cls_name, a, p, q, **kw):
    return (getattr(pst, cls_name).from_dense(
                a, nb=NB, grid=pst.Grid(p, q, device="cpu"), **kw),
            getattr(jst, cls_name).from_dense(a, nb=NB, grid=jgrid(p, q),
                                              **kw))


@pytest.mark.parametrize("p,q", [(2, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("method", ["GemmC", "Ring", "GemmA"])
def test_gemm_pq_methods_match_jax(p, q, method):
    m, k, n = 70, 50, 40
    dt = np.complex128 if method == "Ring" else np.float64
    a, b, c = rand(m, k, dt, seed=1), rand(k, n, dt, seed=2), \
        rand(m, n, dt, seed=3)
    (A, JA), (B, JB), (C, JC) = (both("Matrix", a, p, q),
                                 both("Matrix", b, p, q),
                                 both("Matrix", c, p, q))
    got = pst.gemm(0.5, A, B, 2.0, C,
                   {Option.MethodGemm: getattr(MethodGemm, method)})
    want = jst.gemm(0.5, JA, JB, 2.0, JC,
                    {JOption.MethodGemm: getattr(JMethodGemm, method)})
    close(got.to_dense().numpy(), want.to_dense())
    close(got.to_dense().numpy(), 0.5 * a @ b + 2.0 * c)


@pytest.mark.parametrize("p,q", [(2, 4), (1, 4)])
def test_gemm_transposed_views_pq(p, q):
    """op(A)·op(B) with views resolved by the block-cyclic transpose."""
    a, b = rand(50, 70, seed=4), rand(40, 50, np.float64, seed=5)
    A, _ = both("Matrix", a, p, q)
    B, _ = both("Matrix", b, p, q)
    C = pst.Matrix.zeros(70, 40, NB, pst.Grid(p, q, device="cpu"),
                         dtype=torch.float64)
    got = pst.gemm(1.0, pst.transpose(A), pst.conj_transpose(B), 0.0, C)
    close(got.to_dense().numpy(), a.T @ b.T)


@pytest.mark.parametrize("p,q", [(2, 4), (2, 2)])
def test_herk_syrk_pq_match_jax(p, q):
    n, k = 70, 50
    a = rand(n, k, np.complex128, seed=6)
    c = rand(n, n, np.complex128, seed=7)
    c = c + c.conj().T
    (A, JA), (C, JC) = both("Matrix", a, p, q), both("HermitianMatrix", c,
                                                      p, q)
    got = pst.herk(0.5, A, 2.0, C)
    want = jst.herk(0.5, JA, 2.0, JC)
    close(got.to_dense().numpy(), want.to_dense())
    close(got.to_dense().numpy(), 0.5 * a @ a.conj().T + 2.0 * c)
    ar = rand(n, k, seed=8)
    (A, JA), (C, JC) = both("Matrix", ar, p, q), both(
        "SymmetricMatrix", c.real.copy(), p, q)
    got = pst.syrk(1.0, A, 0.5, C)
    close(got.to_dense().numpy(), jst.syrk(1.0, JA, 0.5, JC).to_dense())


TRSM = [(side, uplo, unit, op)
        for side in ("Left", "Right") for uplo in ("Lower", "Upper")
        for unit in (False, True) for op in ("n", "c")]


@pytest.mark.parametrize("side,uplo,unit,op", TRSM)
def test_trsm_pq_matches_jax(side, uplo, unit, op):
    p, q = 2, 4
    n, nrhs = 70, 21
    t = rand(n, n, seed=9) / n + 2 * np.eye(n)   # well conditioned
    t = np.tril(t) if uplo == "Lower" else np.triu(t)
    shape = (n, nrhs) if side == "Left" else (nrhs, n)
    b = rand(*shape, seed=10)
    kw = dict(uplo=getattr(pst.Uplo, uplo),
              diag=pst.Diag.Unit if unit else pst.Diag.NonUnit)
    jkw = dict(uplo=getattr(jst.Uplo, uplo),
               diag=jst.Diag.Unit if unit else jst.Diag.NonUnit)
    T = pst.TriangularMatrix.from_dense(t, nb=NB, grid=pst.Grid(
        p, q, device="cpu"), **kw)
    JT = jst.TriangularMatrix.from_dense(t, nb=NB, grid=jgrid(p, q), **jkw)
    B, JB = both("Matrix", b, p, q)
    if op == "c":
        T, JT = pst.conj_transpose(T), jst.conj_transpose(JT)
    sd, jsd = getattr(pst.Side, side), getattr(jst.Side, side)
    got = pst.trsm(sd, 2.0, T, B).to_dense().numpy()
    want = np.asarray(jst.trsm(jsd, 2.0, JT, JB).to_dense())
    close(got, want)
    tt = t.copy()
    if unit:
        np.fill_diagonal(tt, 1.0)
    if op == "c":
        tt = tt.T
    ref = (np.linalg.solve(tt, 2.0 * b) if side == "Left"
           else np.linalg.solve(tt.T, 2.0 * b.T).T)
    close(got, ref, 1e-10)


def test_norms_pq_match_jax():
    p, q = 2, 4
    n = 70
    a = rand(n, 60, seed=11)
    h = rand(n, n, np.complex128, seed=12)
    cases = [("Matrix", a, {}), ("HermitianMatrix", h, {}),
             ("TriangularMatrix", h.real.copy(), dict(uplo="Upper"))]
    for cls, x, kw in cases:
        pk = {k: getattr(pst.Uplo, v) for k, v in kw.items()}
        jk = {k: getattr(jst.Uplo, v) for k, v in kw.items()}
        P = getattr(pst, cls).from_dense(x, nb=NB, grid=pst.Grid(
            p, q, device="cpu"), **pk)
        J = getattr(jst, cls).from_dense(x, nb=NB, grid=jgrid(p, q), **jk)
        for kind in ("Max", "One", "Inf", "Fro"):
            got = float(pst.norm(getattr(pst.Norm, kind), P))
            want = float(jst.norm(getattr(jst.Norm, kind), J))
            assert abs(got - want) <= n * 2.0 ** -53 * want, (cls, kind)
    got = pst.col_norms(pst.Norm.Max, pst.Matrix.from_dense(
        a, nb=NB, grid=pst.Grid(p, q, device="cpu"))).numpy()
    np.testing.assert_array_equal(got, np.abs(a).max(axis=0))


@pytest.mark.parametrize("p,q", [(2, 3), (3, 2)])
def test_verbs_pq(p, q):
    """chol_solve, lu_solve and multiply on p×q grids whose lcm is not a
    divisor of either side (the super-step chunks of 6 block columns)."""
    n = 70
    a, b = rand(n, n, seed=13), rand(n, 3, seed=14)
    s = a @ a.T + n * np.eye(n)
    g = pst.Grid(p, q, device="cpu")
    A, B = (pst.Matrix.from_dense(x, nb=NB, grid=g) for x in (a, b))
    S = pst.HermitianMatrix.from_dense(s, nb=NB, grid=g)
    close(s @ pst.chol_solve(S, B).to_dense().numpy(), b, 1e-12)
    close(a @ pst.lu_solve(A, B).to_dense().numpy(), b, 1e-10)
    C = pst.Matrix.zeros(n, 3, NB, g, dtype=torch.float64)
    close(pst.multiply(1.0, A, B, 0.0, C).to_dense().numpy(), a @ b)
