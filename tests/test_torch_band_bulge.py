"""The port's plain bulge chasers (``internal/band_bulge.py``, the plain
versions of the hb2st and tb2bd kernels) and the packed-reflector
back-transform against the JAX package's numpy twin and its Pallas
kernels in interpret mode, on the CPU.

Tolerances, absolute, on N(0, 1) bands (measured distances in brackets):

* float64: d, e, V, τ within 1e-10 [≤ 3e-11], the same algorithm in
  another summation order. tb2bd's reflectors at (300, 128) are held to
  1e-3 only [4.5e-5]: they are ill-conditioned functions of the input
  there (the twin's own V moves by 4e-5 when the band is perturbed by
  1e-15 relative), while d and e stay at 1e-10.
* float32: a long sequential recurrence of reflections, rounded in
  another order on each side. d and |e| within 5e-3 for n ≤ 100 [8e-4],
  2e-2 at (300, 128) [6e-3]; |e| because a near-zero pivot may take
  the other sign on one side, which flips e's sign (the tridiagonal is
  unique up to D·T·D, D = diag(±1)). V and τ within 5e-3 (the JAX
  package's own f32 bound, ``tests/test_band_wave.py``) where the chain is
  short enough to keep them comparable: hb2st at every case [5e-4],
  tb2bd for n ≤ 50 [4e-4]. The spectrum of every result is held to the
  dense f64 eigenvalues within 2e-3·max|λ| in f32 (the JAX package's
  bound) and 1e-10 in f64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.internal import band_bulge as jbb  # noqa: E402
from slate_tpu.linalg import he2hb as jhe  # noqa: E402
from slate_tpu_torch.internal import band_bulge as pbb  # noqa: E402
from slate_tpu_torch.linalg import bulge as pbulge  # noqa: E402
from slate_tpu_torch.linalg import ge2tb as pge  # noqa: E402
from slate_tpu_torch.linalg import he2hb as phe  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

SHAPES = [(37, 3), (50, 8), (100, 16), (300, 128)]
DTYPES = [np.float32, np.float64]
CASES = [(s, dt) for s in SHAPES for dt in DTYPES]


def case_id(c):
    (n, b), dt = c
    return f"n{n}-b{b}-{np.dtype(dt).name}"


def band(n, b, dt, seed=None):
    rng = np.random.default_rng(n * b if seed is None else seed)
    return rng.standard_normal((b + 1, n)).astype(dt)


def dense_lower(ab):
    b, n = ab.shape[0] - 1, ab.shape[1]
    a = np.zeros((n, n))
    for d in range(min(b, n - 1) + 1):
        j = np.arange(n - d)
        a[j + d, j] = ab[d, :n - d]
        a[j, j + d] = ab[d, :n - d]
    return a


def dense_upper(ab):
    b, n = ab.shape[0] - 1, ab.shape[1]
    a = np.zeros((n, n))
    for d in range(min(b, n - 1) + 1):
        j = np.arange(n - d)
        a[j, j + d] = ab[d, :n - d]
    return a


def tridiag_eigs(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


def bidiag_svals(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


def npy(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


@pytest.fixture(scope="module")
def twin():
    """The JAX numpy twin's hb2st and tb2bd for every case."""
    return {c: (jbb.hb2st(band(*c[0], c[1])), jbb.tb2bd(band(*c[0], c[1])))
            for c in CASES}


def tols(case):
    (n, b), dt = case
    if dt == np.float64:
        return 1e-10, 1e-10, (1e-3 if n >= 300 else 1e-10)
    return (5e-3 if n <= 100 else 2e-2), 5e-3, (5e-3 if n <= 50 else None)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_hb2st_plain_matches_twin(twin, case):
    (n, b), dt = case
    ab = band(n, b, dt)
    d, e, V, tau = npy(pbb.hb2st(torch.from_numpy(ab)))
    jd, je, jV, jtau = twin[case][0]
    t_de, t_v, _ = tols(case)
    assert V.shape == jV.shape == (n - 1, jbb.max_chase(n, b), b)
    assert tau.shape == jtau.shape and d.dtype == ab.dtype
    assert np.abs(d - jd).max() <= t_de
    assert np.abs(np.abs(e) - np.abs(je)).max() <= t_de
    if dt == np.float64:
        assert np.abs(e - je).max() <= t_de
    assert np.abs(V - jV).max() <= t_v and np.abs(tau - jtau).max() <= t_v
    ref = np.linalg.eigvalsh(dense_lower(ab.astype(np.float64)))
    spec = 1e-10 if dt == np.float64 else 2e-3
    assert np.abs(tridiag_eigs(d, e) - ref).max() <= spec * np.abs(ref).max()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_tb2bd_plain_matches_twin(twin, case):
    (n, b), dt = case
    ab = band(n, b, dt)
    out = npy(pbb.tb2bd(torch.from_numpy(ab)))
    jout = twin[case][1]
    t_de, _, t_v = tols(case)
    for x, y in zip(out[2:6], jout[2:6]):
        assert x.shape == y.shape
    assert np.abs(np.abs(out[0]) - np.abs(jout[0])).max() <= t_de
    assert np.abs(np.abs(out[1]) - np.abs(jout[1])).max() <= t_de
    if t_v is not None:
        for x, y in zip(out[2:6], jout[2:6]):
            assert np.abs(x - y).max() <= t_v
    assert float(out[6]) == float(jout[6]) == 1.0
    ref = np.linalg.svd(dense_upper(ab.astype(np.float64)), compute_uv=False)
    spec = 1e-10 if dt == np.float64 else 2e-3
    assert np.abs(bidiag_svals(out[0], out[1]) - ref).max() <= spec * ref.max()


@pytest.fixture(scope="module")
def pallas():
    """The JAX Pallas chasers in interpret mode at (50, 8), run as
    tests/test_band_wave.py runs them."""
    from slate_tpu.internal.band_wave_vmem import hb2st_wave_vmem
    from slate_tpu.internal.band_wave_vmem_bd import tb2bd_wave_vmem
    ab = band(50, 8, np.float32, seed=400)
    return (ab, npy(hb2st_wave_vmem(ab.copy(), interpret=True)),
            npy(tb2bd_wave_vmem(ab.copy(), interpret=True)))


@pytest.mark.parametrize("which", ["hb2st", "tb2bd"])
def test_plain_matches_pallas_interpret(pallas, which):
    """The Pallas kernels in interpret mode against the port's plain
    versions at (50, 8), f32: 5e-3, the bound the JAX package holds its
    kernels to against the twin."""
    ab, jh, jb = pallas
    if which == "hb2st":
        out, ref = npy(pbb.hb2st(torch.from_numpy(ab))), jh
    else:
        out, ref = npy(pbb.tb2bd(torch.from_numpy(ab)))[:6], jb[:6]
    for x, y in zip(out, ref):
        assert x.shape == y.shape
        assert np.abs(np.abs(x) - np.abs(y)).max() <= 5e-3


@pytest.mark.parametrize("n,b", [(2, 1), (12, 1), (2, 2), (9, 1)])
def test_band1_and_n2(n, b):
    """Band 1 and n = 2: the chase generates only length-1 (identity)
    reflectors, as in the twin; results equal the twin's exactly."""
    ab = band(n, b, np.float64)
    for fn in ("hb2st", "tb2bd"):
        out = npy(getattr(pbb, fn)(torch.from_numpy(ab)))
        ref = npy(getattr(jbb, fn)(ab.copy()))
        for x, y in zip(out, ref):
            assert x.shape == np.shape(y)
            np.testing.assert_array_equal(x, y)


def test_trivial_cases():
    for ab in (np.ones((1, 5)), np.ones((3, 1))):
        for fn in ("hb2st", "tb2bd"):
            out = npy(getattr(pbb, fn)(torch.from_numpy(ab)))
            ref = npy(getattr(jbb, fn)(ab.copy()))
            for x, y in zip(out, ref):
                assert x.shape == np.shape(y)
                np.testing.assert_array_equal(x, y)


def test_nan_band_raises():
    """A NaN in the band raises SlateError from the port's hb2st and
    tb2bd dispatch, and from the JAX hb2st ladder once every rung has
    failed. The JAX tb2bd has no validator: it returns a non-finite
    bidiagonal (ROADMAP §C)."""
    ab = band(50, 8, np.float32)
    ab[3, 10] = np.nan
    t = torch.from_numpy(ab)
    with pytest.raises(pst.SlateError, match="non-finite"):
        phe.hb2st(t)
    with pytest.raises(pst.SlateError, match="non-finite"):
        pge.tb2bd(t)
    import slate_tpu as jst
    with pytest.raises(jst.SlateError):
        jhe.hb2st(ab.copy())
    from slate_tpu.linalg import ge2tb as jge
    assert not np.isfinite(np.asarray(jge.tb2bd(ab.copy())[0])).all()


def test_complex_band_raises():
    """A complex band, refused before the complex chases were ported,
    gives the twin's result: d and e real, the packs and tb2bd's phase0
    (here 1: a₀₀ = 1 is real) within 1e-6."""
    ab = np.ones((3, 5), np.complex64)
    ab[1:] += 0.5j
    for name in ("hb2st", "tb2bd"):
        got = getattr(pbb, name)(torch.from_numpy(ab))
        want = getattr(jbb, name)(ab.copy())
        assert got[0].dtype == got[1].dtype == torch.float32
        for x, ref in zip(got, want):
            assert np.abs(np.asarray(x) - np.asarray(ref)).max() < 1e-6


@pytest.mark.parametrize("forward", [False, True])
def test_apply_bulge_reflectors_matches_twin(twin, forward):
    """The batched back-transform on the twin's f64 reflectors, carried
    across with ``interop``, against the twin's one-by-one
    ``apply_packed`` and the port's own: within 1e-12."""
    case = ((100, 16), np.float64)
    jd, je, jV, jtau = twin[case][0]
    V, tau = pst.reflectors_from_reference(jV, jtau, device="cpu")
    back = pst.reflectors_to_reference(V, tau)
    assert np.array_equal(back[0], jV) and np.array_equal(back[1], jtau)
    Z = np.random.default_rng(3).standard_normal((100, 7))
    out = pbulge.apply_bulge_reflectors(V, tau, torch.from_numpy(Z), 16,
                                        forward=forward).numpy()
    ref = jbb.apply_packed(jV, jtau, Z.copy(), 16, forward=forward,
                           conj_tau=not forward)
    assert np.abs(out - ref).max() < 1e-12
    own = pbb.apply_packed(V, tau, torch.from_numpy(Z.copy()), 16, forward)
    assert np.abs(own.numpy() - ref).max() < 1e-12
    # unmtr_hb2st is the NoTrans/Trans pair of the same application
    op = pst.Op.Trans if forward else pst.Op.NoTrans
    u = phe.unmtr_hb2st(V, tau, torch.from_numpy(Z), 16, op).numpy()
    assert np.abs(u - ref).max() < 1e-12


def test_band_reconstructs_from_its_reflectors():
    """A_band = Q·T·Qᵀ with Q from hb2st's pack and A_band = U₂·B·V₂ᵀ
    from tb2bd's, f64 within 1e-12 relative."""
    n, b = 60, 8
    ab = band(n, b, np.float64, seed=5)
    d, e, V, tau = pbb.hb2st(torch.from_numpy(ab))
    Q = pbulge.apply_bulge_reflectors(V, tau, torch.eye(n, dtype=torch.float64),
                                      b).numpy()
    T = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    a = dense_lower(ab)
    assert np.linalg.norm(Q @ T @ Q.T - a) <= 1e-12 * np.linalg.norm(a)
    d, e, Vu, tu, Vv, tv, _ = pbb.tb2bd(torch.from_numpy(ab))
    I = torch.eye(n, dtype=torch.float64)
    U2 = pbulge.apply_bulge_reflectors(Vu, tu, I, b).numpy()
    V2 = pbulge.apply_bulge_reflectors(Vv, tv, I, b).numpy()
    B = np.diag(d.numpy()) + np.diag(e.numpy(), 1)
    a = dense_upper(ab)
    assert np.linalg.norm(U2 @ B @ V2.T - a) <= 1e-12 * np.linalg.norm(a)


def test_band_interop_round_trip():
    ab = band(20, 4, np.float32)
    t = pst.band_from_reference(ab, device="cpu")
    assert t.dtype == torch.float32 and np.array_equal(
        pst.band_to_reference(t), ab)
    with pytest.raises(pst.SlateError):
        pst.band_from_reference(ab[0], device="cpu")
    with pytest.raises(pst.SlateError):
        pst.reflectors_from_reference(np.zeros((2, 3, 4)), np.zeros((2, 4)),
                                      device="cpu")


def test_chase_wrappers_route_by_device():
    """A CPU band runs the plain version and counts no launch; a device
    with no kernel raises; the gates follow the kernel's own limits
    (float32, float64, complex64, complex128, band 1..256) on the card
    only, where the wider types chase at band 64."""
    from slate_tpu_torch.internal import band_wave, kernels as K
    K.reset_launches()
    ab = torch.from_numpy(band(30, 4, np.float32))
    for got, ref in zip(K.hb2st_chase(ab), pbb.hb2st(ab)):
        assert torch.equal(got, ref)
    for got, ref in zip(K.tb2bd_chase(ab), pbb.tb2bd(ab)):
        assert torch.equal(got, ref)
    assert K.LAUNCHES["hb2st_vmem"] == K.LAUNCHES["tb2bd_vmem"] == 0
    with pytest.raises(pst.SlateError, match="no kernel"):
        K.hb2st_chase(torch.zeros((3, 8), device="meta"))
    for name in ("hb2st_vmem", "tb2bd_vmem"):
        for dt in (torch.float32, torch.float64, torch.complex64,
                   torch.complex128):
            assert K.supported(name, dt, 128, "cuda")
            assert K.supported(name, dt, 256, "cuda")
            assert not K.supported(name, dt, 257, "cuda")
            assert K.supported(name, dt, 512, "cpu")
        assert not K.supported(name, torch.float16, 128, "cuda")
    assert band_wave.preferred_eig_band(8192, torch.float32, "cuda") == 128
    assert band_wave.preferred_eig_band(1, torch.float32, "cuda") == 256
    assert band_wave.preferred_eig_band(8192, torch.float32, "cpu") == 256
    for dt in (torch.float64, torch.complex64, torch.complex128):
        assert band_wave.preferred_eig_band(8192, dt, "cuda") == 64
        assert band_wave.preferred_eig_band(8192, dt, "cpu") == 256


@pytest.mark.parametrize("n,b", [(5, 8), (3, 6)])
def test_band_wider_than_the_matrix(n, b):
    """A band array with more diagonals than the matrix has (b ≥ n, as
    a he2hb gather gives when nb > n): the port chases it, with the
    spectrum of the dense matrix; the JAX numpy twin's ribbon fill fails
    on it with a shape mismatch (ROADMAP §C)."""
    ab = band(n, b, np.float64)
    d, e, V, tau = npy(pbb.hb2st(torch.from_numpy(ab)))
    ref = np.linalg.eigvalsh(dense_lower(ab))
    assert np.abs(tridiag_eigs(d, e) - ref).max() < 1e-12 * np.abs(ref).max()
    out = npy(pbb.tb2bd(torch.from_numpy(ab)))
    ref = np.linalg.svd(dense_upper(ab), compute_uv=False)
    assert np.abs(bidiag_svals(out[0], out[1]) - ref).max() < 1e-12 * ref.max()
    with pytest.raises(ValueError):
        jbb.hb2st(ab.copy())
