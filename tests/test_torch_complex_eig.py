"""The complex two-stage eigensolver against the JAX package on a 1×1
grid, on the CPU, at complex64 and complex128: the plain chases (hb2st,
tb2bd with its column-0 phase) against the JAX package's numpy twin, the
packed back-transform with ``conj_tau`` both ways, he2hb and unmtr_he2hb
on factors carried across with ``interop``, heev two-stage (DC and QR,
Lower and Upper) and hegv itype 1–3. Inputs are made with numpy (O(1)
imaginary parts) and go into both packages; each JAX reference is
computed once per module.

Tolerances: U = 1e-12 at complex128 and 10·n·2⁻²⁴ at complex64 (the same
algorithm, sums in other orders). The chases' d, |e| and sweep 0's
reflectors within U; their spectra within U·‖A‖₂. he2hb's band and T, the
back-transforms within U relative; eigenvalues within U·‖A‖ of the JAX
package's and λ of the real dtype. A complex eigenvector is fixed only up
to a unit phase, so Z is held to ‖A·Z − Z·Λ‖/‖A‖ and ‖ZᴴZ − I‖/n within
U and to |Zᴴ·Z_jax| within √U of the identity (the spectrum is
separated).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.internal import band_bulge as jbb  # noqa: E402
from slate_tpu.linalg import he2hb as jhe  # noqa: E402
from slate_tpu_torch.internal import band_bulge as pbb  # noqa: E402
from slate_tpu_torch.linalg import bulge as pbulge  # noqa: E402
from slate_tpu_torch.linalg import he2hb as phe  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
N, NB = 64, 16
DTYPES = [np.complex64, np.complex128]
IDS = ["c64", "c128"]


def tol(dt, n=N):
    return 1e-12 if dt == np.complex128 else 10 * n * 2.0 ** -24


def herm(n, dt, seed):
    g = rand(n, n, dt, seed)
    return ((g + g.conj().T) / 2).astype(dt)


def rel(x, ref):
    x, ref = np.asarray(x, np.complex128), np.asarray(ref, np.complex128)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def phase_gap(z, zref):
    """max | |Zᴴ·Z_ref| − I |: 0 when the columns agree up to unit
    phases."""
    g = np.abs(z.conj().T.astype(np.complex128) @ zref)
    return np.abs(g - np.eye(g.shape[0])).max()


def band(n, b, dt, seed, a00=None):
    ab = rand(b + 1, n, dt, seed)
    if a00 is not None:
        ab[0, 0] = a00
    return ab


# ---------------------------------------------------------------------------
# the plain chases against the twin
# ---------------------------------------------------------------------------

CHASES = [("hb2st", 40, 6, None), ("hb2st", 33, 16, None),
          ("tb2bd", 40, 6, -1.5), ("tb2bd", 33, 16, 0.7 - 1.2j),
          ("tb2bd", 20, 3, 0.0)]


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("which,n,b,a00", CHASES,
                         ids=["hb", "hb16", "tb_neg_real", "tb_cplx",
                              "tb_zero"])
def test_plain_chase_matches_twin(dt, which, n, b, a00):
    """d, e, every pack and the column-0 phase against the numpy twin: a
    negative real a₀₀ keeps phase 1, a complex one gives conj(a₀₀)/|a₀₀|,
    and d, e come out in the real dtype."""
    ab = band(n, b, dt, 5, a00)
    if which == "hb2st":
        ab[0] = ab[0].real
    got = getattr(pbb, which)(torch.from_numpy(ab))
    want = getattr(jbb, which)(ab.copy())
    rdt = torch.float32 if dt == np.complex64 else torch.float64
    assert got[0].dtype == got[1].dtype == rdt
    t = tol(dt, n)
    for x, ref in zip(got[:2], want[:2]):
        assert np.abs(x.numpy() - ref).max() <= t * np.abs(ab).max() * b
    for x, ref in zip(got[2:6], want[2:6]):
        assert x.dtype == {np.complex64: torch.complex64,
                           np.complex128: torch.complex128}[dt]
        assert np.abs(x.numpy()[0] - ref[0]).max() <= t      # sweep 0
        assert np.abs(x.numpy() - ref).max() <= 1e3 * t
    if which == "tb2bd":
        ph = complex(got[6])
        assert abs(ph - complex(want[6])) <= t
        if a00 is None or np.imag(a00) == 0:
            assert ph == 1.0
        else:
            assert abs(ph - np.conj(a00) / abs(a00)) <= t
    # the spectrum of the chased (real) band is the band's own
    upper = which == "tb2bd"
    dense = np.zeros((n, n), np.complex128)
    for d in range(b + 1):
        j = np.arange(n - d)
        if upper:
            dense[j, j + d] = ab[d, :n - d]
        else:
            dense[j + d, j] = ab[d, :n - d]
            if d:
                dense[j, j + d] = np.conj(ab[d, :n - d])
    dd, ee = got[0].double().numpy(), got[1].double().numpy()
    tri = np.diag(dd) + np.diag(ee, 1) + (0 if upper else np.diag(ee, -1))
    if upper:
        s, sref = (np.linalg.svd(x, compute_uv=False) for x in (tri, dense))
    else:
        s, sref = np.linalg.eigvalsh(tri), np.linalg.eigvalsh(dense)
    assert np.abs(s - sref).max() <= t * np.abs(sref).max()


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_complex_larfg_tiny_alpha(dt):
    """A tiny complex α alone (a phase rotation) and a tiny x, whose
    squares underflow (the twin's β is 0 and τ infinite there): β real
    with |β| = ‖x‖, τ finite, H·x = β·e₀ with H = I − τ·v·vᴴ unitary;
    a subnormal α still gives a finite reflector."""
    tiny = 1e-26 if dt == np.complex64 else 1e-170
    t = 10 * 2.0 ** -24 if dt == np.complex64 else 1e-14
    for x in (np.array([tiny * (1 - 10j)]),
              np.array([tiny * (2 + 1j), tiny * (1 - 1j), -tiny * 0.5j])):
        v, tau, beta = pbb.larfg(torch.from_numpy(x.astype(dt)))
        v, tau = v.numpy().astype(np.complex128), complex(tau)
        x64 = x.astype(dt).astype(np.complex128)
        h = np.eye(len(x)) - tau * np.outer(v, v.conj())
        big = np.abs(x64).max()
        nrm = big * np.linalg.norm(x64 / big)      # numpy's own underflows
        assert np.isfinite(tau) and np.isfinite(v).all()
        assert abs(abs(float(beta)) - nrm) <= t * nrm
        assert np.abs(h @ x64 - float(beta) * np.eye(len(x))[0]).max() \
            <= t * nrm
        assert np.abs(h.conj().T @ h - np.eye(len(x))).max() <= t
    sub = np.array([(1e-41 if dt == np.complex64 else 1e-310) * (1 - 10j)])
    v, tau, beta = pbb.larfg(torch.from_numpy(sub.astype(dt)))
    assert np.isfinite(complex(tau)) and float(beta) != 0.0


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("forward,conj_tau", [(False, True), (True, False),
                                              (False, False), (True, True)])
def test_apply_bulge_reflectors_conj_tau(dt, forward, conj_tau):
    """The batched back-transform, the port's own ``apply_packed`` and the
    twin's ``apply_packed`` agree with ``conj_tau`` either way, on the
    twin's complex reflectors carried across."""
    ab = band(50, 8, dt, 9)
    ab[0] = ab[0].real
    _, _, jV, jtau = jbb.hb2st(ab)
    V, tau = pst.reflectors_from_reference(jV, jtau, device="cpu")
    back = pst.reflectors_to_reference(V, tau)
    assert np.array_equal(back[0], jV) and np.array_equal(back[1], jtau)
    Z = rand(50, 5, dt, 11)
    ref = jbb.apply_packed(jV, jtau, Z.copy(), 8, forward=forward,
                           conj_tau=conj_tau)
    out = pbulge.apply_bulge_reflectors(V, tau, torch.from_numpy(Z), 8,
                                        forward=forward, conj_tau=conj_tau)
    own = pbb.apply_packed(V, tau, torch.from_numpy(Z.copy()), 8, forward,
                           conj_tau=conj_tau)
    t = tol(dt, 50)
    assert rel(out.numpy(), ref) <= t and rel(own.numpy(), ref) <= t


# ---------------------------------------------------------------------------
# he2hb, heev, hegv against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_eig(grid11):
    """Per dtype: the JAX he2hb (band, T), its unmtr_he2hb of a block C,
    two-stage heev (DC) and hegv itype 1–3 (DC, Lower B)."""
    out = {}
    for dt in DTYPES:
        a = herm(N, dt, 1)
        A = jst.HermitianMatrix.from_dense(a, nb=NB, grid=grid11)
        Aband, T = jhe.he2hb(A)
        c = rand(N, NB, dt, 2)
        QC = jhe.unmtr_he2hb(jst.Op.NoTrans, Aband, T,
                             jst.Matrix.from_dense(c, nb=NB, grid=grid11))
        lam, Z = jst.heev(A, {jst.Option.MethodEig: jst.MethodEig.DC})
        bm = rand(N, N, dt, 3)
        b = (bm @ bm.conj().T / N + np.eye(N)).astype(dt)
        B = jst.HermitianMatrix.from_dense(b, nb=NB, grid=grid11)
        gv = {}
        for itype in (1, 2, 3):
            glam, _, ginfo = jst.hegv(itype, A, B, {
                jst.Option.MethodEig: jst.MethodEig.DC})
            gv[itype] = (np.asarray(glam), int(ginfo))
        out[dt] = dict(a=a, c=c, b=b, Adata=np.asarray(Aband.data),
                       T=np.asarray(T),
                       band=np.asarray(jhe.he2hb_gather(Aband)),
                       QC=np.asarray(QC.to_dense()), lam=np.asarray(lam),
                       Z=np.asarray(Z.to_dense()), hegv=gv)
    return out


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_he2hb_and_unmtr_match_jax(jax_eig, dt):
    """The port's he2hb band and T against the JAX package's; the port's
    unmtr_he2hb (NoTrans and ConjTrans) on the JAX factors carried across
    against the JAX back-transform and its inverse."""
    ref = jax_eig[dt]
    t = tol(dt)
    Ab, T = pst.he2hb(pst.HermitianMatrix.from_dense(ref["a"], nb=NB,
                                                     grid=CPU))
    assert rel(T.numpy(), ref["T"]) <= t
    band = phe.he2hb_gather(Ab).numpy()
    assert rel(band, ref["band"]) <= t
    assert np.abs(band[0].imag).max() == 0      # the diagonal kept real
    JAb = pst.from_reference(ref["Adata"], kind="HermitianMatrix", m=N, n=N,
                             nb=NB, uplo="Lower", device="cpu")
    JT = pst.t_factors_from_reference(ref["T"], device="cpu")
    C = pst.Matrix.from_dense(ref["c"], nb=NB, grid=CPU)
    QC = phe.unmtr_he2hb(pst.Op.NoTrans, JAb, JT, C)
    assert rel(QC.to_dense().numpy(), ref["QC"]) <= t
    back = phe.unmtr_he2hb(pst.Op.ConjTrans, JAb, JT, QC)
    assert rel(back.to_dense().numpy(), ref["c"]) <= t


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("method", ["DC", "QR"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_heev_two_stage_matches_jax(jax_eig, dt, method, uplo):
    ref = jax_eig[dt]
    a = ref["a"]
    keep = np.tril if uplo == "Lower" else np.triu
    A = pst.HermitianMatrix.from_dense(keep(a), nb=NB, grid=CPU,
                                       uplo=pst.Uplo[uplo])
    lam, Z = pst.heev(A, {pst.Option.MethodEig: pst.MethodEig[method]})
    assert lam.dtype == (torch.float32 if dt == np.complex64
                         else torch.float64)
    t = tol(dt)
    norm = np.linalg.norm(a)
    assert np.abs(lam.numpy() - ref["lam"]).max() <= t * norm
    z = Z.to_dense().numpy().astype(np.complex128)
    l64 = lam.double().numpy()
    assert np.linalg.norm(a @ z - z * l64) <= t * norm
    assert np.linalg.norm(z.conj().T @ z - np.eye(N)) / N <= t
    assert phase_gap(z, ref["Z"]) <= np.sqrt(t)


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches_jax(jax_eig, dt, itype):
    """Complex hegv, the two-stage heev inside, against the JAX package's
    λ and ``info``, and the residual of its problem type; an Upper-stored
    B (B = Uᴴ·U) gives the Lower one's λ."""
    ref = jax_eig[dt]
    a, b = ref["a"], ref["b"]
    opts = {pst.Option.MethodEig: pst.MethodEig.DC}
    A = pst.HermitianMatrix.from_dense(a, nb=NB, grid=CPU)
    lam, Z, info = pst.hegv(itype, A, pst.HermitianMatrix.from_dense(
        b, nb=NB, grid=CPU), opts)
    jlam, jinfo = ref["hegv"][itype]
    assert int(info) == jinfo == 0
    t = tol(dt)
    scale = np.abs(jlam).max()
    assert lam.dtype == (torch.float32 if dt == np.complex64
                         else torch.float64)
    assert np.abs(lam.numpy() - jlam).max() <= 10 * t * scale
    z = Z.to_dense().numpy().astype(np.complex128)
    l64 = lam.double().numpy()
    a64, b64 = a.astype(np.complex128), b.astype(np.complex128)
    lhs, rhs = {1: (a64 @ z, b64 @ z * l64),
                2: (a64 @ (b64 @ z), z * l64),
                3: (b64 @ (a64 @ z), z * l64)}[itype]
    assert np.linalg.norm(lhs - rhs) <= 10 * t * scale * np.linalg.norm(z) \
        * np.linalg.norm(b64)
    Bu = pst.HermitianMatrix.from_dense(np.triu(b), nb=NB, grid=CPU,
                                        uplo=pst.Uplo.Upper)
    lam_u, _, info_u = pst.hegv(itype, A, Bu, opts)
    assert int(info_u) == 0
    assert np.abs(lam_u.numpy() - lam.numpy()).max() <= 10 * t * scale
