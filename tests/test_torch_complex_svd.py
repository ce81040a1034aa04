"""The complex two-stage SVD against the JAX package on a 1×1 grid, on
the CPU, at complex64 and complex128: ge2tb and its back-transforms
``unmbr_ge2tb_u``/``unmbr_ge2tb_v`` (on factors carried across with
``interop``), tb2bd's column-0 phase through ``interop``, and gesvd
two-stage on a tall and a wide matrix. Inputs are made with numpy (O(1)
imaginary parts); each JAX reference is computed once per module.

Tolerances as in ``test_torch_complex_eig.py``: U = 1e-12 at complex128
and 10·n·2⁻²⁴ at complex64. ge2tb's storage and T stacks and the
back-transforms within U relative; σ within U·σ_max of the JAX package's
and of the real dtype; ‖A − U·Σ·Vᴴ‖/‖A‖ and the orthogonality of U and V
within U; a complex singular vector is fixed only up to a unit phase, so
the pairs are held to |Uᴴ·U_jax| and |Vᴴ·V_jax| within √U of the
identity (the singular values are separated).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import ge2tb as jge  # noqa: E402
from slate_tpu_torch.linalg import ge2tb as pge  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
M, N, NB = 80, 64, 16
DTYPES = [np.complex64, np.complex128]
IDS = ["c64", "c128"]


def tol(dt, n=M):
    return 1e-12 if dt == np.complex128 else 10 * n * 2.0 ** -24


def rel(x, ref):
    x, ref = np.asarray(x, np.complex128), np.asarray(ref, np.complex128)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def phase_gap(z, zref):
    g = np.abs(np.asarray(z, np.complex128).conj().T @ zref)
    return np.abs(g - np.eye(g.shape[0])).max()


@pytest.fixture(scope="module")
def jax_svd(grid11):
    """Per dtype: the JAX ge2tb (storage, Tq, Tl, band), its back-
    transforms of a block C (U side [M, NB], V side [N, NB]), its tb2bd
    phase0, and gesvd two-stage with U, Vᴴ of a tall and a wide matrix."""
    out = {}
    so = {jst.Option.MethodSVD: jst.MethodSVD.TwoStage}
    for dt in DTYPES:
        a = rand(M, N, dt, 1)
        A = jst.Matrix.from_dense(a, nb=NB, grid=grid11)
        Aout, Tq, Tl = jge.ge2tb(A)
        ub = np.asarray(jge.ge2tb_gather(Aout))
        cu, cv = rand(M, NB, dt, 2), rand(N, NB, dt, 3)
        QU = jge.unmbr_ge2tb_u(jst.Op.NoTrans, Aout, Tq, jst.Matrix.from_dense(
            cu, nb=NB, grid=grid11))
        QV = jge.unmbr_ge2tb_v(jst.Op.NoTrans, Aout, Tl, jst.Matrix.from_dense(
            cv, nb=NB, grid=grid11))
        svd = {}
        for shape, seed in (((M, N), 4), ((N, M), 5)):
            g = rand(*shape, dt, seed)
            s, U, VT = jst.gesvd(jst.Matrix.from_dense(g, nb=NB, grid=grid11),
                                 so, True, True)
            svd[shape] = (g, np.asarray(s), np.asarray(U.to_dense()),
                          np.asarray(VT.to_dense()))
        out[dt] = dict(a=a, cu=cu, cv=cv, data=np.asarray(Aout.data),
                       Tq=np.asarray(Tq), Tl=np.asarray(Tl), ub=ub,
                       QU=np.asarray(QU.to_dense()),
                       QV=np.asarray(QV.to_dense()),
                       phase0=jge.tb2bd(ub)[6], svd=svd)
    return out


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_ge2tb_and_unmbr_match_jax(jax_svd, dt):
    """The port's ge2tb storage, Tq, Tl and band against the JAX
    package's; unmbr_ge2tb_u/v (NoTrans, then ConjTrans back) on the JAX
    factors carried across against the JAX back-transforms; tb2bd's
    column-0 phase carried both ways."""
    ref = jax_svd[dt]
    t = tol(dt)
    Aout, Tq, Tl = pst.ge2tb(pst.Matrix.from_dense(ref["a"], nb=NB,
                                                   grid=CPU))
    assert rel(Aout.data.numpy(), ref["data"]) <= t
    assert rel(Tq.numpy(), ref["Tq"]) <= t and rel(Tl.numpy(), ref["Tl"]) <= t
    ub = pge.ge2tb_gather(Aout)
    assert rel(ub.numpy(), ref["ub"]) <= t
    JA = pst.from_reference(ref["data"], kind="Matrix", m=M, n=N, nb=NB,
                            device="cpu")
    JTq = pst.t_factors_from_reference(ref["Tq"], device="cpu")
    JTl = pst.t_factors_from_reference(ref["Tl"], device="cpu")
    for side, fn, T, c, want in (
            ("u", pge.unmbr_ge2tb_u, JTq, ref["cu"], ref["QU"]),
            ("v", pge.unmbr_ge2tb_v, JTl, ref["cv"], ref["QV"])):
        C = pst.Matrix.from_dense(c, nb=NB, grid=CPU)
        QC = fn(pst.Op.NoTrans, JA, T, C)
        assert rel(QC.to_dense().numpy(), want) <= t, side
        back = fn(pst.Op.ConjTrans, JA, T, QC)
        assert rel(back.to_dense().numpy(), c) <= t, side
    ph = pge.tb2bd(pst.band_from_reference(ref["ub"], device="cpu"))[6]
    jph = pst.phase_from_reference(ref["phase0"], device="cpu")
    assert abs(complex(ph) - complex(jph)) <= t
    assert pst.phase_to_reference(ph).dtype == np.dtype(dt)


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", [(M, N), (N, M)], ids=["tall", "wide"])
def test_gesvd_two_stage_matches_jax(jax_svd, dt, shape):
    g, js, jU, jVT = jax_svd[dt]["svd"][shape]
    s, U, VT = pst.gesvd(pst.Matrix.from_dense(g, nb=NB, grid=CPU),
                         {pst.Option.MethodSVD: pst.MethodSVD.TwoStage},
                         True, True)
    assert s.dtype == (torch.float32 if dt == np.complex64
                       else torch.float64)
    k = min(shape)
    t = tol(dt)
    assert np.abs(s.numpy() - js).max() <= t * js[0]
    u = U.to_dense().numpy().astype(np.complex128)
    vt = VT.to_dense().numpy().astype(np.complex128)
    assert u.shape == (shape[0], k) and vt.shape == (k, shape[1])
    g64 = g.astype(np.complex128)
    assert rel(u * s.double().numpy() @ vt, g64) <= t
    assert np.linalg.norm(u.conj().T @ u - np.eye(k)) / k <= t
    assert np.linalg.norm(vt @ vt.conj().T - np.eye(k)) / k <= t
    assert phase_gap(u, jU) <= np.sqrt(t)
    assert phase_gap(vt.conj().T, jVT.conj().T) <= np.sqrt(t)
