"""The port's device inverse iteration (``linalg/stein.py``, kernel K12's
plain version ``kernels.stein_iter_plain``) and ``heev`` with
``MethodEig.QR`` above n = 512 against the JAX package, on the CPU.
Inputs are made with numpy and go into both packages; the JAX references
are computed once per module.

Tolerances: the sweeps from one start X0, max |X − X_ref| within 1e-12 in
float64 and 1e-4 in float32 on a separated spectrum (the same operations;
XLA may fuse a product into its difference); on a clustered one the
vectors of a cluster turn with the rounding, so they are held to their
residual ‖T·x − λ·x‖ ≤ 1e-8 (float64) / 1e-3 (float32). heev: λ within
1e-12·‖A‖ of the JAX package's; Z column by column up to sign,
|zᵀz_ref| within 1e-8 of 1, where λ is 1e-3·‖T‖ from its neighbours
(stein's cluster rule; elsewhere the cluster QR mixes the columns);
‖A·Z − Z·Λ‖_F/‖A‖_F and ‖ZᵀZ − I‖_F/n within 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import stein as jstein  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.linalg import eig as peig  # noqa: E402
from slate_tpu_torch.linalg import stein as pstein  # noqa: E402
from tests.conftest import spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
TDT = {np.float32: torch.float32, np.float64: torch.float64}
N = 48


def tridiag(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "separated":
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    # four eigenvalues within ~1e-5 of each integer 0 … n/4 − 1
    d = np.repeat(np.arange(n // 4, dtype=np.float64), 4)
    return d + 1e-9 * rng.standard_normal(n), 1e-6 * rng.standard_normal(n - 1)


def dense(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def core_inputs(kind, dt):
    d, e = tridiag(kind)
    lam = peig.sterf(d, e)
    lam_p, _, _ = pstein.shifts(d, e, lam, TDT[dt])
    x0 = np.random.default_rng(9).uniform(0.5, 1.0, (N, N))
    return [np.asarray(v, dt) for v in (d, e, lam_p, x0)], lam


@pytest.fixture(scope="module")
def jax_cores():
    return {(kind, dt): np.asarray(jstein._stein_iter_core(
                *(jnp.asarray(v) for v in core_inputs(kind, dt)[0]), iters=2))
            for kind in ("separated", "clustered")
            for dt in (np.float32, np.float64)}


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["separated", "clustered"])
def test_stein_core_matches_jax(jax_cores, kind, dt):
    (d, e, lam_p, x0), lam = core_inputs(kind, dt)
    ref = jax_cores[(kind, dt)]
    args = [torch.from_numpy(v) for v in (d, e, lam_p, x0)]
    plain = K.stein_iter_plain(*args, iters=2)
    core = pstein._stein_iter_core(*args, iters=2)
    assert torch.equal(plain, core)                    # the CPU's route
    out = plain.numpy()
    assert out.dtype == dt and out.shape == (N, N)
    np.testing.assert_allclose(np.linalg.norm(out, axis=0), 1.0, atol=1e-6)
    big = np.abs(out).argmax(axis=0)
    assert (out[big, np.arange(N)] > 0).all()          # the sign rule
    tol = 1e-12 if dt == np.float64 else 1e-4
    if kind == "separated":
        assert np.abs(out - ref).max() < tol
    else:
        # every eigenvalue lies in a cluster of four within 1e-5
        t = dense(d.astype(np.float64), e.astype(np.float64))
        res = np.linalg.norm(t @ out - out * lam[None, :], axis=0)
        assert res.max() < (1e-8 if dt == np.float64 else 1e-3)
        assert np.isfinite(ref).all()


def test_stein_plain_rescues_an_overflowing_column():
    """A shift at an exact eigenvalue gives an exact zero pivot, replaced
    by 4·FLT_MIN; with |r| > 16 the JAX package's float32 back-
    substitution overflows and its column turns to NaN. The port solves
    it again from R·2⁻⁶⁴, which after the renormalisation is the result
    of the same input scaled by a power of two, bit for bit."""
    d = np.array([2.0, 2.0], np.float32)
    e = np.array([1.0], np.float32)
    lam = np.array([1.0, 3.0], np.float32)
    x0 = np.array([[100.0, 0.75], [300.0, 0.5]], np.float32)
    ref = np.asarray(jstein._stein_iter_core(
        *(jnp.asarray(v) for v in (d, e, lam, x0)), iters=2))
    assert np.isnan(ref[:, 0]).all()
    t = [torch.from_numpy(v) for v in (d, e, lam)]
    out = K.stein_iter_plain(*t, torch.from_numpy(x0), iters=2)
    small = K.stein_iter_plain(*t, torch.from_numpy(x0 / 128), iters=2)
    assert torch.isfinite(out).all() and torch.equal(out, small)
    np.testing.assert_allclose(np.abs(out[:, 0].numpy()), 2 ** -0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(out[:, 1].numpy(), ref[:, 1], atol=1e-6)


def test_steqr_device_branch():
    """``steqr(..., device=)`` keeps λ on the host's QR iteration and
    computes Z by stein there; it agrees with the host branch up to sign
    and records its two stages."""
    d, e = tridiag("separated", 200, seed=3)
    lam, z = peig.steqr(d, e)
    times = {}
    lam2, Z = peig.steqr(d, e, True, "cpu", torch.float64, times)
    assert isinstance(Z, torch.Tensor) and Z.dtype == torch.float64
    assert set(times) == {"sterf", "stein"}
    assert np.abs(lam2 - lam).max() < 1e-12
    dots = np.abs(np.sum(Z.numpy() * z, axis=0))
    assert np.abs(dots - 1).max() < 1e-8
    lam3, none = peig.steqr(d, e, False, "cpu")
    assert none is None and np.abs(lam3 - lam).max() < 1e-12


def test_stein_vectors_small_and_degenerate():
    z = pstein.stein_vectors(np.array([3.0]), np.zeros(0), np.array([3.0]),
                             "cpu", torch.float64)
    assert z.shape == (1, 1) and float(z[0, 0]) == 1.0
    n = 40                                      # T = 0: one cluster of n
    z = pstein.stein_vectors(np.zeros(n), np.zeros(n - 1), np.zeros(n), "cpu",
                             torch.float64).numpy()
    assert np.linalg.norm(z.T @ z - np.eye(n)) < 1e-12


@pytest.fixture(scope="module")
def jax_heev_qr(grid11):
    a = spd(640, seed=33)
    A = jst.HermitianMatrix.from_dense(a, nb=64, grid=grid11)
    lam, Z = jst.heev(A, {jst.Option.MethodEig: jst.MethodEig.QR,
                          jst.Option.EigBand: 64})
    return a, np.asarray(lam), np.asarray(Z.to_dense())


def test_heev_qr_above_512_matches_jax(jax_heev_qr, monkeypatch):
    """tests/test_eig_svd.py:198-223's run: n = 640, EigBand 64; the
    tridiagonal stage never forms Z on the host (a poisoned host
    eigh_tridiagonal with vectors)."""
    import scipy.linalg as sla
    orig = sla.eigh_tridiagonal

    def poisoned(*a, **kw):
        if not kw.get("eigvals_only", False):
            raise AssertionError("dense host Z materialized")
        return orig(*a, **kw)

    monkeypatch.setattr("scipy.linalg.eigh_tridiagonal", poisoned)
    a, jlam, jz = jax_heev_qr
    n = a.shape[0]
    A = pst.HermitianMatrix.from_dense(a, nb=64, grid=CPU)
    times = {}
    lam, Z = pst.heev(A, {pst.Option.MethodEig: pst.MethodEig.QR,
                          pst.Option.EigBand: 64}, times=times)
    assert {"sterf", "stein", "steqr"} <= set(times)
    lam, z = lam.numpy(), Z.to_dense().numpy()
    norm_a = np.abs(np.linalg.eigvalsh(a)).max()
    assert np.abs(lam - jlam).max() < 1e-12 * norm_a
    assert np.linalg.norm(a @ z - z * lam) / np.linalg.norm(a) < 1e-10
    assert np.linalg.norm(z.T @ z - np.eye(n)) / n < 1e-10
    gaps = np.minimum(np.diff(lam, prepend=-np.inf),
                      np.diff(lam, append=np.inf))
    alone = gaps > 1e-3 * np.abs(lam).max()
    assert alone.sum() >= 10
    dots = np.abs(np.sum(z * jz, axis=0))[alone]
    assert np.abs(dots - 1).max() < 1e-8


def test_heev_qr_float32_bounds():
    """float32 at n = 600: λ within 10·n·2⁻²⁴·‖A‖₂ of eigvalsh, residual
    and orthogonality within 10·n·2⁻²⁴ (chip_smoke.py 3s's bounds)."""
    n = 600
    rng = np.random.default_rng(4)
    g = rng.standard_normal((n, n))
    a = (g + g.T) / 2
    A = pst.HermitianMatrix.from_dense(a.astype(np.float32), nb=64, grid=CPU)
    lam, Z = pst.heev(A, {pst.Option.MethodEig: pst.MethodEig.QR})
    lam, z = lam.double().numpy(), Z.to_dense().double().numpy()
    ref = np.linalg.eigvalsh(a)
    bound = 10 * n * 2.0 ** -24
    assert np.abs(lam - ref).max() <= bound * np.abs(ref).max()
    assert np.linalg.norm(a @ z - z * lam) / np.linalg.norm(a) <= bound
    assert np.linalg.norm(z.T @ z - np.eye(n)) / n <= bound
