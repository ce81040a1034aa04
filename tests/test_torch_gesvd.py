"""The port's two-stage SVD (ge2tb, the back-transforms, bdsqr, gesvd by
TwoStage and Dense, the SVD verbs) against the JAX package on a 1×1
grid, on the CPU. Inputs are made with numpy and go into both packages;
each JAX reference is computed once per module.

Tolerances (float64): ge2tb's band, reflectors and T factors within
1e-12 relative (the same panels and products in another summation
order); singular values within 1e-12·σ_max of the JAX package's; vectors,
unique only up to sign, by ‖A − U·Σ·Vᵀ‖/‖A‖ and the orthogonality of U
and V within 1e-12. float32 runs are held to 10·max(m, n)·2⁻²⁴ in the
same measures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import bulge as jbulge  # noqa: E402
from slate_tpu.linalg import ge2tb as jge  # noqa: E402
from slate_tpu_torch.linalg import bulge as pbulge  # noqa: E402
from slate_tpu_torch.linalg import ge2tb as pge  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
NB = 16
SHAPES = {"tall": (90, 60), "square": (64, 64), "wide": (50, 75)}


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def jax_ref(grid11):
    """JAX ge2tb of the tall matrix and JAX two-stage σ of each shape."""
    out = {}
    for k, (m, n) in SHAPES.items():
        a = rand(m, n, seed=m + n)
        s, _, _ = jst.gesvd(jst.Matrix.from_dense(a, nb=NB, grid=grid11),
                            {jst.Option.MethodSVD: jst.MethodSVD.TwoStage})
        out[k] = (a, np.asarray(s))
    a = out["tall"][0]
    Aout, Tq, Tl = jge.ge2tb(jst.Matrix.from_dense(a, nb=NB, grid=grid11))
    out["ge2tb"] = (np.asarray(Aout.to_dense()), np.asarray(Tq),
                    np.asarray(Tl), np.asarray(jge.ge2tb_gather(Aout)))
    return out


def test_ge2tb_matches_jax(jax_ref):
    a = jax_ref["tall"][0]
    ja, jTq, jTl, jub = jax_ref["ge2tb"]
    Aout, Tq, Tl = pst.ge2tb(pst.Matrix.from_dense(a, nb=NB, grid=CPU))
    assert Tq.shape == jTq.shape and Tl.shape == jTl.shape
    assert rel(Aout.to_dense().numpy(), ja) < 1e-12
    assert rel(Tq.numpy(), jTq) < 1e-12 and rel(Tl.numpy(), jTl) < 1e-12
    ub = pge.ge2tb_gather(Aout)
    assert ub.shape == (NB + 1, 60) and rel(ub.numpy(), jub) < 1e-12


def test_ge2tb_back_transforms_rebuild_a(jax_ref):
    """U₁·B_band·V₁ᵀ = A with U₁, V₁ applied by unmbr_ge2tb_u/v (the
    U side through the port's unmqr)."""
    a = jax_ref["tall"][0]
    m, n = a.shape
    Aout, Tq, Tl = pst.ge2tb(pst.Matrix.from_dense(a, nb=NB, grid=CPU))
    ub = pge.ge2tb_gather(Aout).numpy()
    B = np.zeros((m, n))
    for d in range(NB + 1):
        j = np.arange(n - d)
        B[j, j + d] = ub[d, :n - d]
    # A = U₁·B·V₁ᵀ ⇒ A = U₁·(V₁·Bᵀ)ᵀ
    VBt = pge.unmbr_ge2tb_v(pst.Op.NoTrans, Aout, Tl,
                            pst.Matrix.from_dense(B.T.copy(), nb=NB, grid=CPU))
    rec = pge.unmbr_ge2tb_u(pst.Op.NoTrans, Aout, Tq,
                            pst.Matrix.from_dense(VBt.to_dense().numpy().T
                                                  .copy(), nb=NB, grid=CPU))
    assert rel(rec.to_dense().numpy(), a) < 1e-12
    back = pge.unmbr_ge2tb_v(pst.Op.Trans, Aout, Tl, VBt).to_dense().numpy()
    assert rel(back, B.T) < 1e-12


@pytest.mark.parametrize("method", ["TwoStage", "Dense"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gesvd_matches_jax(jax_ref, shape, method):
    a, js = jax_ref[shape]
    m, n = a.shape
    k = min(m, n)
    A = pst.Matrix.from_dense(a, nb=NB, grid=CPU)
    opts = {pst.Option.MethodSVD: pst.MethodSVD[method]}
    s, U, VT = pst.gesvd(A, opts, want_u=True, want_vt=True)
    s_only, nu, nv = pst.gesvd(A, opts)
    assert nu is None and nv is None and s.dtype == torch.float64
    assert np.abs(s.numpy() - js).max() < 1e-12 * js[0]
    assert np.abs(s_only.numpy() - js).max() < 1e-12 * js[0]
    u, vt = U.to_dense().numpy(), VT.to_dense().numpy()
    assert u.shape == (m, k) and vt.shape == (k, n)
    assert rel(u * s.numpy() @ vt, a) < 1e-12
    assert np.linalg.norm(u.T @ u - np.eye(k)) < 1e-12
    assert np.linalg.norm(vt @ vt.T - np.eye(k)) < 1e-12
    u_only = pst.gesvd(A, opts, want_u=True)
    assert u_only[2] is None and rel(u_only[1].to_dense().numpy(), u) < 1e-12


@pytest.mark.parametrize("m,n,nb,band", [(200, 144, 48, 16), (96, 96, 32, None)])
def test_gesvd_two_stage_f32(m, n, nb, band):
    """f32 two-stage with vectors, re-blocked to the band by retile or
    chased at nb: σ against numpy's f64 SVD, reconstruction and
    orthogonality within 10·max(m, n)·2⁻²⁴."""
    a = rand(m, n, np.float32, seed=m)
    opts = {pst.Option.MethodSVD: pst.MethodSVD.TwoStage}
    if band:
        opts[pst.Option.EigBand] = band
    s, U, VT = pst.svd(pst.Matrix.from_dense(a, nb=nb, grid=CPU), opts)
    bound = 10 * max(m, n) * 2.0 ** -24
    ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert s.dtype == torch.float32
    assert np.abs(s.numpy() - ref).max() <= bound * ref[0]
    u = U.to_dense().numpy().astype(np.float64)
    vt = VT.to_dense().numpy().astype(np.float64)
    assert rel(u * s.numpy() @ vt, a) <= bound
    assert np.linalg.norm(u.T @ u - np.eye(n)) / n <= bound
    assert np.linalg.norm(vt @ vt.T - np.eye(n)) / n <= bound


def test_bdsqr_rank_deficient_matches_jax():
    """A bidiagonal with two zero diagonal entries (singular): σ as the
    JAX package's bdsqr, as many zero σ as B's rank deficiency,
    B = U·Σ·Vᵀ and both factors orthogonal."""
    rng = np.random.default_rng(12)
    n = 30
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    d[[4, 17]] = 0.0
    B = np.diag(d) + np.diag(e, 1)
    s, U, VT = pbulge.bdsqr(torch.from_numpy(d), torch.from_numpy(e),
                            want_uv=True)
    js = jbulge.bdsqr(d, e)
    deficiency = n - np.linalg.matrix_rank(B)
    assert deficiency >= 1 and np.sum(s < 1e-10) == deficiency
    assert np.abs(s - js).max() < 1e-12
    assert np.abs(pbulge.bdsqr(d, e) - js).max() < 1e-12
    assert np.linalg.norm(U * s @ VT - B) < 1e-12 * np.linalg.norm(B)
    assert np.linalg.norm(U.T @ U - np.eye(n)) < 1e-12
    assert np.linalg.norm(VT @ VT.T - np.eye(n)) < 1e-12
    one = pbulge.bdsqr(np.array([-2.0]), np.zeros(0), want_uv=True)
    assert one[0][0] == 2.0 and one[1][0, 0] == -1.0


def test_svd_verbs_and_contracts():
    a = rand(40, 24, seed=3)
    A = pst.Matrix.from_dense(a, nb=8, grid=CPU)
    o = {pst.Option.MethodSVD: pst.MethodSVD.TwoStage}
    assert torch.equal(pst.svd_vals(A, o), pst.gesvd(A, o)[0])
    s, U, VT = pst.svd(A, o)
    s2, U2, VT2 = pst.gesvd(A, o, want_u=True, want_vt=True)
    assert torch.equal(s, s2) and torch.equal(U.data, U2.data)
    assert torch.equal(VT.data, VT2.data)
    s_auto = pst.svd_vals(A)
    assert np.abs(s_auto.numpy() - np.linalg.svd(a, compute_uv=False)).max() \
        < 1e-12
    # complex runs the two-stage pipeline too (raised before it was
    # ported): a real A as complex has A's σ, in float64
    sc = pst.gesvd(A.astype(torch.complex128), o)[0]
    assert sc.dtype == torch.float64
    assert np.abs(sc.numpy() - s.numpy()).max() < 1e-12
    with pytest.raises(pst.SlateError, match="m >= n"):
        pst.ge2tb(pst.Matrix.from_dense(a.T.copy(), nb=8, grid=CPU))
    # a method with no pipeline of its own raises (the JAX package sends
    # it to its dense SVD; ROADMAP §C)
    for m in ("Jacobi", "QRIteration", "DC"):
        with pytest.raises(pst.SlateError, match="no pipeline"):
            pst.gesvd(A, {pst.Option.MethodSVD: pst.MethodSVD[m]})
    times = {}
    pst.gesvd(A, o, True, True, times)
    assert set(times) == {"ge2tb", "gather", "tb2bd", "bdsqr",
                          "unmbr_tb2bd", "unmbr_ge2tb"}
