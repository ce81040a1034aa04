"""The port's two-stage eigensolver (he2hb, its back-transforms, stedc,
heev by every method, retile and the eig verbs) against the JAX package
on a 1×1 grid, on the CPU. Inputs are made with numpy and go into both
packages; each JAX reference is computed once per module.

Tolerances (float64): he2hb's band and T within 1e-12 relative (the
same panels and products summed in other orders); back-transforms on
carried-over reflectors within 1e-12 relative; eigenvalues within
1e-12·‖A‖ of the JAX package's. Eigenvectors are unique only up to sign,
so they are held to the residual ‖A·Z − Z·Λ‖/‖A‖ and ‖ZᵀZ − I‖ within
1e-12 and to |diag(Zᵀ·Z_ref)| within 1e-10 of 1 (the spectrum is well
separated). float32 runs are held to 10·n·2⁻²⁴ in the same measures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import he2hb as jhe  # noqa: E402
from slate_tpu.linalg import stedc as jstedc  # noqa: E402
from slate_tpu_torch.linalg import he2hb as phe  # noqa: E402
from slate_tpu_torch.linalg import stedc as pstedc  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
N, NB = 100, 16


def sym(n, dt=np.float64, seed=0):
    g = rand(n, n, dt, seed)
    return ((g + g.T) / 2).astype(dt)


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.fixture(scope="module")
def jax_two_stage(grid11):
    """The JAX he2hb, band, hb2st and two-stage heev of one matrix."""
    a = sym(N)
    A = jst.HermitianMatrix.from_dense(a, nb=NB, grid=grid11)
    Aband, T = jhe.he2hb(A)
    band = np.asarray(jhe.he2hb_gather(Aband))
    lam, Z = jst.heev(A, {jst.Option.MethodEig: jst.MethodEig.TwoStage})
    return dict(a=a, Aband=Aband, T=np.asarray(T), band=band,
                hb2st=[np.asarray(x) for x in jhe.hb2st(band)],
                lam=np.asarray(lam), Z=np.asarray(Z.to_dense()))


def test_he2hb_matches_jax(jax_two_stage):
    ref = jax_two_stage
    Ab, T = pst.he2hb(pst.HermitianMatrix.from_dense(ref["a"], nb=NB,
                                                     grid=CPU))
    assert T.shape == ref["T"].shape == (N // NB, NB, NB)
    assert rel(T.numpy(), ref["T"]) < 1e-12
    band = phe.he2hb_gather(Ab)
    assert band.shape == (NB + 1, N)
    assert rel(band.numpy(), ref["band"]) < 1e-12
    assert rel(Ab.to_dense().numpy(), np.asarray(ref["Aband"].to_dense())) \
        < 1e-12


def test_he2hb_f32_band_keeps_spectrum():
    a = sym(64, np.float32, seed=3)
    Ab, T = pst.he2hb(pst.HermitianMatrix.from_dense(a, nb=8, grid=CPU))
    band = phe.he2hb_gather(Ab).numpy().astype(np.float64)
    dense = np.zeros((64, 64))
    for d in range(9):
        j = np.arange(64 - d)
        dense[j + d, j] = dense[j, j + d] = band[d, :64 - d]
    lam = np.linalg.eigvalsh(a.astype(np.float64))
    assert np.abs(np.linalg.eigvalsh(dense) - lam).max() \
        <= 10 * 64 * 2.0 ** -24 * np.abs(lam).max()


@pytest.fixture(scope="module")
def carried(jax_two_stage):
    """The JAX he2hb output and hb2st pack, carried into the port."""
    ref = jax_two_stage
    Ab = ref["Aband"]
    PAb = pst.from_reference(np.asarray(Ab.data), kind="HermitianMatrix",
                             m=Ab.m, n=Ab.n, nb=Ab.nb, uplo="Lower",
                             device="cpu")
    T = pst.t_factors_from_reference(ref["T"], device="cpu")
    V, tau = pst.reflectors_from_reference(ref["hb2st"][2], ref["hb2st"][3],
                                           device="cpu")
    return PAb, T, V, tau


@pytest.mark.parametrize("trans", ["NoTrans", "Trans"])
def test_unmtr_he2hb_on_carried_reflectors(jax_two_stage, carried, trans):
    ref = jax_two_stage
    PAb, T, _, _ = carried
    c = rand(N, 5, seed=21)
    jc = jhe.unmtr_he2hb(jst.Op[trans], ref["Aband"], jnp_array(ref["T"]),
                         jst.Matrix.from_dense(c, nb=NB,
                                               grid=ref["Aband"].grid))
    pc = phe.unmtr_he2hb(pst.Op[trans], PAb, T,
                         pst.Matrix.from_dense(c, nb=NB, grid=CPU))
    assert rel(pc.to_dense().numpy(), np.asarray(jc.to_dense())) < 1e-12


def jnp_array(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


@pytest.mark.parametrize("trans", ["NoTrans", "Trans"])
def test_unmtr_hb2st_on_carried_reflectors(jax_two_stage, carried, trans):
    ref = jax_two_stage
    _, _, V, tau = carried
    c = rand(N, 6, seed=22)
    jc = np.asarray(jhe.unmtr_hb2st(ref["hb2st"][2], ref["hb2st"][3], c, NB,
                                    jst.Op[trans]))
    pc = phe.unmtr_hb2st(V, tau, torch.from_numpy(c), NB, pst.Op[trans])
    assert rel(pc.numpy(), jc) < 1e-12


def test_hb2st_dispatch_matches_jax(jax_two_stage):
    """The port's chase against the JAX dispatch (its C++ chase on the
    CPU): within 1e-10·max|band|, the bound of test_torch_band_bulge.py
    scaled to this band."""
    ref = jax_two_stage
    d, e, V, tau = phe.hb2st(torch.from_numpy(ref["band"]))
    jd, je, jV, jtau = ref["hb2st"]
    tol = 1e-10 * np.abs(ref["band"]).max()
    for x, y in ((d, jd), (e, je), (V, jV), (tau, jtau)):
        assert np.abs(x.numpy() - y).max() < tol


@pytest.mark.parametrize("n", [40, 200])
def test_stedc_matches_jax_host(n):
    """The port's stedc against the JAX package's host stedc (no grid):
    the same merge tree, so λ and Z agree to rounding; the device path
    (here the CPU as the device) gives the same Z."""
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    e[n // 3] = 0.0                       # one split: the rho == 0 merge
    jl, jZ = jstedc.stedc(d, e)
    pl, pZ = pstedc.stedc(d, e)
    assert np.abs(pl - jl).max() < 1e-12
    assert np.abs(pZ - jZ).max() < 1e-10
    dl, dZ = pst.stedc(torch.from_numpy(d), torch.from_numpy(e),
                       device="cpu", dtype=torch.float64)
    assert isinstance(dZ, torch.Tensor) and np.abs(dZ.numpy() - jZ).max() \
        < 1e-10
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.linalg.norm(T @ pZ - pZ * pl) < 1e-12 * np.linalg.norm(T)
    vals, none = pst.stedc(d, e, want_vectors=False)
    assert none is None and np.abs(vals - jl).max() < 1e-12


def test_sterf_steqr():
    rng = np.random.default_rng(4)
    d, e = rng.standard_normal(30), rng.standard_normal(29)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    lam = np.linalg.eigvalsh(T)
    assert np.abs(pst.sterf(d, e) - lam).max() < 1e-12
    l2, Z = pst.steqr(torch.from_numpy(d), torch.from_numpy(e))
    assert np.abs(l2 - lam).max() < 1e-12
    assert np.linalg.norm(T @ Z - Z * l2) < 1e-12 * np.linalg.norm(T)


METHODS = ["Dense", "TwoStage", "DC", "QR"]


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("method", METHODS)
def test_heev_matches_jax(jax_two_stage, method, uplo):
    ref = jax_two_stage
    a = ref["a"]
    opts = {pst.Option.MethodEig: pst.MethodEig[method]}
    A = pst.HermitianMatrix.from_dense(a, nb=NB, grid=CPU,
                                       uplo=pst.Uplo[uplo])
    lam, Z = pst.heev(A, opts)
    lam_v, none = pst.heev(A, opts, want_vectors=False)
    assert none is None and lam.dtype == torch.float64
    na = np.linalg.norm(a, 2)
    assert np.abs(lam.numpy() - ref["lam"]).max() < 1e-12 * na
    assert np.abs(lam_v.numpy() - ref["lam"]).max() < 1e-12 * na
    z = Z.to_dense().numpy()
    assert np.linalg.norm(a @ z - z * lam.numpy()) < 1e-12 * np.linalg.norm(a)
    assert np.linalg.norm(z.T @ z - np.eye(N)) < 1e-12
    assert np.abs(np.abs(np.diag(z.T @ ref["Z"])) - 1).max() < 1e-10


@pytest.mark.parametrize("n,nb,opts", [
    (256, 32, {}),                        # DC merges above nmin, band 32
    (200, 64, {"EigBand": 16}),           # re-blocked by retile to 16
    (90, 40, {"EigBand": 16}),            # 40 % 16 != 0: re-blocked dense
])
def test_heev_two_stage_f32(n, nb, opts):
    """f32 two-stage with vectors (DC): residual and orthogonality
    within 10·n·2⁻²⁴, λ against numpy's f64 eigvalsh likewise."""
    a = sym(n, np.float32, seed=n)
    o = {pst.Option.MethodEig: pst.MethodEig.DC}
    o.update({pst.Option[k]: v for k, v in opts.items()})
    lam, Z = pst.heev(pst.HermitianMatrix.from_dense(a, nb=nb, grid=CPU), o)
    assert lam.dtype == torch.float32
    assert Z.nb == opts.get("EigBand", nb)
    bound = 10 * n * 2.0 ** -24
    ref = np.linalg.eigvalsh(a.astype(np.float64))
    assert np.abs(lam.numpy() - ref).max() <= bound * np.abs(ref).max()
    z = Z.to_dense().numpy().astype(np.float64)
    assert np.linalg.norm(a @ z - z * lam.numpy()) <= bound * np.linalg.norm(a)
    assert np.linalg.norm(z.T @ z - np.eye(n)) / n <= bound


def test_heev_auto_dense_below_threshold_and_qr_gate(grid11):
    a = sym(40, seed=2)
    A = pst.HermitianMatrix.from_dense(a, nb=8, grid=CPU)
    lam, _ = pst.heev(A)
    assert np.abs(lam.numpy() - np.linalg.eigvalsh(a)).max() < 1e-12
    # QR above n = 512 takes the device inverse iteration (stein), as the
    # JAX package does: on the zero matrix λ = 0 and Z is orthonormal
    qr = {pst.Option.MethodEig: pst.MethodEig.QR}
    big = pst.HermitianMatrix.zeros(600, 600, 64, CPU, dtype=torch.float64)
    jlam, JZ = jst.heev(jst.HermitianMatrix.from_dense(
        np.zeros((600, 600)), nb=64, grid=grid11),
        {jst.Option.MethodEig: jst.MethodEig.QR})
    blam, BZ = pst.heev(big, qr)
    np.testing.assert_array_equal(blam.numpy(), np.asarray(jlam))
    for z in (BZ.to_dense().numpy(), np.asarray(JZ.to_dense())):
        assert np.linalg.norm(z.T @ z - np.eye(600)) < 1e-12
    # complex runs the two-stage pipeline too (raised before it was
    # ported): a real A as complex has A's λ, in float64
    lc, _ = pst.heev(A.astype(torch.complex128),
                     {pst.Option.MethodEig: pst.MethodEig.TwoStage},
                     want_vectors=False)
    assert lc.dtype == torch.float64
    assert np.abs(lc.numpy() - np.linalg.eigvalsh(a)).max() < 1e-12
    # hegv runs; this A is indefinite, so B = A fails potrf at block
    # column 1 and λ and Z come out NaN, as the JAX package's do
    lam, Z, info = pst.linalg.eig.hegv(1, A, A)
    JA = jst.HermitianMatrix.from_dense(a, nb=8, grid=grid11)
    jlam, JZ, jinfo = jst.hegv(1, JA, JA)
    assert int(info) == int(jinfo) == 1
    assert np.isnan(lam.numpy()).all() and np.isnan(np.asarray(jlam)).all()
    assert np.isnan(Z.to_dense().numpy()).all()
    assert np.isnan(np.asarray(JZ.to_dense())).all()


@pytest.mark.parametrize("nb,new", [(32, 8), (48, 16), (16, 16)])
def test_retile_matches_jax(grid11, nb, new):
    a = rand(70, 50, seed=nb)
    J = jst.Matrix.from_dense(a, nb=nb, grid=grid11).retile(new)
    P = pst.Matrix.from_dense(a, nb=nb, grid=CPU).retile(new)
    assert P.nb == J.nb == new and P.data.shape == tuple(J.data.shape)
    np.testing.assert_array_equal(P.data.numpy(), np.asarray(J.data))
    with pytest.raises(pst.SlateError, match="divide"):
        pst.Matrix.from_dense(a, nb=nb, grid=CPU).retile(7)


def test_eig_verbs_match_heev():
    a = sym(48, seed=6)
    A = pst.HermitianMatrix.from_dense(a, nb=8, grid=CPU)
    o = {pst.Option.MethodEig: pst.MethodEig.TwoStage}
    assert torch.equal(pst.eig_vals(A, o), pst.heev(A, o, False)[0])
    lam, Z = pst.eig(A, o)
    times = {}
    lam2, Z2 = pst.heev(A, o, times=times)
    assert torch.equal(lam, lam2) and torch.equal(Z.data, Z2.data)
    assert set(times) == {"he2hb", "gather", "hb2st", "steqr",
                          "unmtr_hb2st", "unmtr_he2hb"}
    for m in ("MRRR", "Bisection"):
        with pytest.raises(pst.SlateError, match="no pipeline"):
            pst.heev(A, {pst.Option.MethodEig: pst.MethodEig[m]})
    assert pst.linalg.he2hb.two_stage_chase_band(8192, 512, 128) == 128
    assert pst.linalg.he2hb.two_stage_chase_band(200, 512, 128) == 512
