"""The port's two-stage SVD on p×q grids of virtual ranks against the JAX
package's SPMD programs on meshes of virtual CPU devices: ge2tb (the
band, both reflector sets, Tq and Tl), unmbr_ge2tb_u and unmbr_ge2tb_v
with both ``trans``, and gesvd's values and U/Vᴴ, tall and wide, by the
Auto dispatch and TwoStage.

Inputs are made with numpy: A = U₀·diag(σ)·V₀ᴴ with σ = 1 … k spaced by
one (singular vectors determined up to a phase per pair), 110×80 with
nb = 16 in float64 on 2×4 and 90×70 with nb = 8 in complex128 on 2×2
(ragged last tiles), ``Option.EigBand`` set to nb in both packages.
Tolerances: ge2tb's storage within 1e-10·‖A‖ and the T stacks within
1e-10 of the JAX package's (the same panels, products summed in other
orders); the back-transforms within 1e-10·‖C‖; σ within 1e-10·σ_max;
U and Vᴴ by ‖A − U·Σ·Vᴴ‖/‖A‖ and orthogonality within 1e-10 and
|Uᴴ·U_jax|, |Vᴴ_jax·V| within 1e-8 of I (phases differ; 1e-8 covers
u·‖A‖/gap with room). Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import ge2tb as jge  # noqa: E402
from slate_tpu_torch.linalg import ge2tb as pge  # noqa: E402
from slate_tpu_torch.types import MethodSVD, Option  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CASES = [((2, 4), np.float64, 110, 80, 16),
         ((2, 2), np.complex128, 90, 70, 8)]
IDS = ["2x4-f64", "2x2-c128"]
NRHS = 3


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def spaced(m, n, dt, seed):
    """An m×n matrix whose singular values are 1 … min(m, n)."""
    k = min(m, n)
    U, _ = np.linalg.qr(rand(m, k, dt, seed))
    V, _ = np.linalg.qr(rand(n, k, dt, seed + 1))
    return ((U * np.arange(1, k + 1)) @ V.conj().T).astype(dt)


def dense(X):
    return np.asarray(X.to_dense())


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (p, q), dt, m, n, nb in CASES:
        g = jgrid(p, q)
        a = spaced(m, n, dt, seed=p + q)
        A = jst.Matrix.from_dense(a, nb=nb, grid=g)
        Aout, Tq, Tl = jge.ge2tb(A)
        r = dict(out=dense(Aout), Tq=np.asarray(Tq), Tl=np.asarray(Tl))
        for t in ("NoTrans", "ConjTrans"):
            op = getattr(jst.Op, t)
            r["u", t] = dense(jge.unmbr_ge2tb_u(
                op, Aout, Tq, jst.Matrix.from_dense(
                    rand(m, NRHS, dt, seed=5), nb=nb, grid=g)))
            r["v", t] = dense(jge.unmbr_ge2tb_v(
                op, Aout, Tl, jst.Matrix.from_dense(
                    rand(n, NRHS, dt, seed=6), nb=nb, grid=g)))
        opts = {jst.Option.EigBand: nb}
        for shape, x in (("tall", a), ("wide", a.conj().T.copy())):
            s, U, VT = jst.gesvd(jst.Matrix.from_dense(x, nb=nb, grid=g),
                                 opts, True, True)
            r[shape] = (np.asarray(s), dense(U), dense(VT))
        out[(p, q)] = r
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ge2tb_and_back_transforms_pq_match_jax(jax_ref, case):
    (p, q), dt, m, n, nb = case
    ref = jax_ref[(p, q)]
    a = spaced(m, n, dt, seed=p + q)
    Aout, Tq, Tl = pst.ge2tb(pst.Matrix.from_dense(a, nb=nb,
                                                   grid=pgrid(p, q)))
    assert Aout.grid == pgrid(p, q)
    assert Tq.shape == ref["Tq"].shape and Tl.shape == ref["Tl"].shape
    assert np.abs(dense(Aout) - ref["out"]).max() <= 1e-10 * np.abs(a).max()
    assert np.abs(Tq.numpy() - ref["Tq"]).max() <= 1e-10
    assert np.abs(Tl.numpy() - ref["Tl"]).max() <= 1e-10
    # the band gather fetches the band tiles from their owners
    ub = pge.ge2tb_gather(Aout).numpy()
    d = dense(Aout)
    for k in range(nb + 1):
        assert np.array_equal(ub[k, :n - k], np.diagonal(d, k)[:n - k])
    for t in ("NoTrans", "ConjTrans"):
        op = getattr(pst.Op, t)
        cu, cv = rand(m, NRHS, dt, seed=5), rand(n, NRHS, dt, seed=6)
        u = pge.unmbr_ge2tb_u(op, Aout, Tq, pst.Matrix.from_dense(
            cu, nb=nb, grid=pgrid(p, q)))
        v = pge.unmbr_ge2tb_v(op, Aout, Tl, pst.Matrix.from_dense(
            cv, nb=nb, grid=pgrid(p, q)))
        assert np.abs(dense(u) - ref["u", t]).max() <= 1e-10 * np.abs(
            cu).max()
        assert np.abs(dense(v) - ref["v", t]).max() <= 1e-10 * np.abs(
            cv).max()


def phase_gap(x, ref):
    """max | |xᴴ·ref| − I |: columns equal up to a phase each."""
    return np.abs(np.abs(x.conj().T @ ref) - np.eye(x.shape[1])).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("shape", ["tall", "wide"])
@pytest.mark.parametrize("method", ["Auto", "TwoStage"])
def test_gesvd_pq_values_and_vectors(jax_ref, case, shape, method):
    (p, q), dt, m, n, nb = case
    js, ju, jvt = jax_ref[(p, q)][shape]
    a = spaced(m, n, dt, seed=p + q)
    if shape == "wide":
        a = a.conj().T.copy()
    A = pst.Matrix.from_dense(a, nb=nb, grid=pgrid(p, q))
    opts = {Option.EigBand: nb, Option.MethodSVD: getattr(MethodSVD, method)}
    s, U, VT = pst.gesvd(A, opts, True, True)
    k = min(a.shape)
    assert s.dtype == torch.float64 and tuple(s.shape) == (k,)
    assert U.grid == VT.grid == pgrid(p, q)
    assert np.abs(s.numpy() - js).max() <= 1e-10 * js[0]
    u, vt, s = dense(U), dense(VT), s.numpy()
    assert u.shape == (a.shape[0], k) and vt.shape == (k, a.shape[1])
    assert np.linalg.norm(a - (u * s) @ vt) <= 1e-10 * np.linalg.norm(a)
    assert np.abs(u.conj().T @ u - np.eye(k)).max() <= 1e-10
    assert np.abs(vt @ vt.conj().T - np.eye(k)).max() <= 1e-10
    assert phase_gap(u, ju) <= 1e-8
    assert phase_gap(vt.conj().T, jvt.conj().T) <= 1e-8
    vals = pst.svd_vals(A, opts)
    assert np.abs(vals.numpy() - js).max() <= 1e-10 * js[0]


def test_gesvd_auto_dispatch_on_pq(monkeypatch):
    """Auto takes the two-stage pipeline on a p×q grid from 4 block rows
    and columns (svd.py:43-44), the dense route below."""
    calls = []
    real = pge.gesvd_two_stage

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(pge, "gesvd_two_stage", spy)
    for (m, n), want in (((80, 40), []), ((80, 64), [(80, 64)])):
        calls.clear()
        a = spaced(m, n, np.float64, seed=m + n)
        s = pst.svd_vals(pst.Matrix.from_dense(a, nb=16, grid=pgrid(2, 4)),
                         {Option.EigBand: 16})
        assert calls == want
        assert np.abs(s.numpy() - np.arange(n, 0, -1)).max() < 1e-10 * n
