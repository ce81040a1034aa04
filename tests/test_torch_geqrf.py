"""The port's QR slice (geqrf, unmqr, gelqf/unmlq, cholqr, gels and the
QR verbs) against the JAX package on a 1×1 grid, on the CPU.

Inputs are made with numpy and go into both packages. The fast path is
forced with SLATE_QR_FAST=1 and SLATE_QR_PANEL=1 on both sides (the JAX
package then runs its Pallas panel kernel in interpret mode, the port
its kernel's plain version); SLATE_QR_FAST=0 takes the dense path. Each
JAX reference is computed once per module.

Tolerances: QR (R and V together) and T within relative Frobenius 1e-12
in f64 and 1e-5 in f32 — the panels, the Gram matrices and the trailing
products sum in other orders on the two sides, and either side is ~1e-7
from the f64 factors on these Gaussian inputs. The port's own factors
meet tests/test_geqrf.py's orthogonality and reconstruction bounds,
scaled to the working precision. Applications of Q and solves from the
same factors, carried across with ``interop``, agree within 1e-10 in
f64; least-squares solutions within 1e-8 of ``numpy.linalg.lstsq``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import geqrf as jgq  # noqa: E402
from slate_tpu_torch.linalg import geqrf as pgq  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
SHAPES = [(384, 256, 128), (512, 512, 128), (29, 13, 8), (80, 48, 16)]
DTYPES = [np.float32, np.float64]
PATHS = {"dense": {"SLATE_QR_FAST": "0"},
         "fast": {"SLATE_QR_FAST": "1", "SLATE_QR_PANEL": "1"}}
CASES = [(s, dt, p) for s in SHAPES for dt in DTYPES for p in PATHS]
TOL = {np.float32: 1e-5, np.float64: 1e-12}
EPS = {np.float32: 2.0 ** -24, np.float64: 2.0 ** -53}


def case_id(c):
    (m, n, nb), dt, path = c
    return f"{m}x{n}x{nb}-{np.dtype(dt).name}-{path}"


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def qr_input(m, n, dt):
    return rand(m, n, dt, seed=m + n)


@pytest.fixture(scope="module")
def jax_geqrf(grid11):
    """JAX geqrf for every case: (QR dense, T). A shape that is not a
    whole number of tiles takes the dense path either way: one run."""
    out = {}
    for case in CASES:
        (m, n, nb), dt, path = case
        if path == "fast" and (m % nb or n % nb):
            out[case] = out[((m, n, nb), dt, "dense")]
            continue
        with pytest.MonkeyPatch.context() as mp:
            for k, v in PATHS[path].items():
                mp.setenv(k, v)
            QR, T = jst.geqrf(jst.Matrix.from_dense(qr_input(m, n, dt), nb=nb,
                                                    grid=grid11))
        out[case] = (np.asarray(QR.to_dense()), np.asarray(T), QR, T)
    return out


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_geqrf_matches_jax(jax_geqrf, monkeypatch, case):
    (m, n, nb), dt, path = case
    for k, v in PATHS[path].items():
        monkeypatch.setenv(k, v)
    a = qr_input(m, n, dt)
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    fast = path == "fast" and m % nb == 0 and n % nb == 0
    assert pgq._qr_fast_applies(A) == fast
    QR, T = pst.geqrf(A)
    jqr, jT, _, _ = jax_geqrf[case]
    assert T.shape == jT.shape == (min(A.mt, A.nt), nb, nb)
    assert rel(QR.to_dense().numpy(), jqr) < TOL[dt]
    assert rel(T.numpy(), jT) < TOL[dt]
    # tests/test_geqrf.py's checks on the port's own factors
    I = pst.Matrix.from_dense(np.eye(m, dtype=dt), nb=nb, grid=CPU)
    q = pst.unmqr(pst.Side.Left, pst.Op.NoTrans, QR, T, I).to_dense().numpy()
    k = min(m, n)
    r = np.triu(QR.to_dense().numpy())[:k]
    bound = 10 * max(m, n) * EPS[dt]
    assert np.abs(q.T @ q - np.eye(m)).max() < bound
    assert np.abs(q[:, :k] @ r - a).max() < bound * np.abs(a).max()


@pytest.fixture(scope="module")
def carried(jax_geqrf):
    """The JAX f64 fast-path factors at 384×256, carried into the port."""
    case = (SHAPES[0], np.float64, "fast")
    _, jT, JQR, JT = jax_geqrf[case]
    QR = pst.from_reference(np.asarray(JQR.data), kind="Matrix", m=JQR.m,
                            n=JQR.n, nb=JQR.nb, device="cpu")
    T = pst.t_factors_from_reference(jT, device="cpu")
    assert np.array_equal(pst.t_factors_to_reference(T), jT)
    return JQR, JT, QR, T


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("trans", ["NoTrans", "ConjTrans", "Trans"])
def test_unmqr_matches_jax(carried, side, trans):
    JQR, JT, QR, T = carried
    m, nb = JQR.m, JQR.nb
    c = rand(m, 7, seed=9) if side == "Left" else rand(5, m, seed=9)
    jc = jgq.unmqr(jst.Side[side], jst.Op[trans], JQR, JT,
                   jst.Matrix.from_dense(c, nb=nb, grid=JQR.grid))
    pc = pst.unmqr(pst.Side[side], pst.Op[trans], QR, T,
                   pst.Matrix.from_dense(c, nb=nb, grid=CPU))
    assert rel(pc.to_dense().numpy(), np.asarray(jc.to_dense())) < 1e-10


@pytest.mark.parametrize("route,m,n", [("qr", 40, 12), ("cholqr", 40, 12),
                                       ("auto", 64, 16), ("lq", 24, 40),
                                       ("lq", 17, 33)])
def test_gels_matches_jax_and_lstsq(grid11, route, m, n):
    nb = 8
    a = rand(m, n, seed=m)
    b = rand(m, 3, seed=n)
    method = {"qr": "Geqrf", "cholqr": "Cholqr"}.get(route, "Auto")
    jx = np.asarray(jst.gels(
        jst.Matrix.from_dense(a, nb=nb, grid=grid11),
        jst.Matrix.from_dense(b, nb=nb, grid=grid11),
        {jst.Option.MethodGels: jst.MethodGels[method]}).to_dense())
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    X = pst.gels(A, pst.Matrix.from_dense(b, nb=nb, grid=CPU),
                 {pst.Option.MethodGels: pst.MethodGels[method]})
    x = X.to_dense().numpy()
    assert x.shape == (n, 3)
    assert rel(x, jx[:n]) < 1e-10
    np.testing.assert_allclose(x, np.linalg.lstsq(a, b, rcond=None)[0],
                               rtol=1e-8, atol=1e-8)
    if route == "auto":
        assert pst.MethodGels.select_algo(A, X) == pst.MethodGels.Cholqr


def test_gels_fast_path_f32(monkeypatch):
    """gels through the forced fast path with the plain K6 in f32: the
    normal-equations residual ‖Aᵀ(A·X − B)‖ is at the rounding level."""
    monkeypatch.setenv("SLATE_QR_FAST", "1")
    monkeypatch.setenv("SLATE_QR_PANEL", "1")
    m, n, nb = 512, 128, 128
    a = rand(m, n, np.float32, seed=2)
    b = rand(m, 4, np.float32, seed=3)
    x = pst.gels(pst.Matrix.from_dense(a, nb=nb, grid=CPU),
                 pst.Matrix.from_dense(b, nb=nb, grid=CPU),
                 {pst.Option.MethodGels: pst.MethodGels.Geqrf}
                 ).to_dense().numpy().astype(np.float64)
    an = np.linalg.norm(a)
    r = np.linalg.norm(a.T @ (a @ x - b)) \
        / (an * (an * np.linalg.norm(x) + np.linalg.norm(b)))
    assert r <= 10 * m * 2.0 ** -24


def test_gelqf_unmlq_match_jax(grid11):
    m, n, nb = 16, 32, 8
    a = rand(m, n, seed=7)
    JLQ, JT = jst.gelqf(jst.Matrix.from_dense(a, nb=nb, grid=grid11))
    LQ, T = pst.gelqf(pst.Matrix.from_dense(a, nb=nb, grid=CPU))
    assert rel(LQ.to_dense().numpy(), np.asarray(JLQ.to_dense())) < 1e-12
    assert rel(T.numpy(), np.asarray(JT)) < 1e-12
    c = rand(n, 3, seed=8)
    for trans in ("NoTrans", "ConjTrans"):
        jc = jgq.unmlq(jst.Side.Left, jst.Op[trans], JLQ, JT,
                       jst.Matrix.from_dense(c, nb=nb, grid=grid11))
        pc = pst.unmlq(pst.Side.Left, pst.Op[trans], LQ, T,
                       pst.Matrix.from_dense(c, nb=nb, grid=CPU))
        assert rel(pc.to_dense().numpy(), np.asarray(jc.to_dense())) < 1e-12


def test_cholqr_and_herk_match_jax(grid11):
    """cholqr's Q and R, and herk/syrk, which write both triangles of C
    as the JAX package does."""
    m, n, nb = 40, 12, 8
    a = rand(m, n, seed=4)
    JQ, JR, jinfo = jgq.cholqr(jst.Matrix.from_dense(a, nb=nb, grid=grid11))
    Q, R, info = pst.cholqr(pst.Matrix.from_dense(a, nb=nb, grid=CPU))
    assert int(info) == int(jinfo) == 0
    assert R.uplo == pst.Uplo.Upper
    assert rel(Q.to_dense().numpy(), np.asarray(JQ.to_dense())) < 1e-12
    r, jr = (np.triu(R.to_dense().numpy()),
             np.triu(np.asarray(JR.to_dense())))
    assert rel(r, jr) < 1e-12
    from slate_tpu.ops import blas as jblas
    c = rand(n, n, seed=5)
    for name in ("herk", "syrk"):
        jc = getattr(jblas, name)(
            2.0, jst.conj_transpose(jst.Matrix.from_dense(a, nb=nb,
                                                          grid=grid11)),
            0.5, jst.HermitianMatrix.from_dense(c, nb=nb, grid=grid11))
        pc = getattr(pst, name)(
            2.0, pst.conj_transpose(pst.Matrix.from_dense(a, nb=nb,
                                                          grid=CPU)),
            0.5, pst.HermitianMatrix.from_dense(c, nb=nb, grid=CPU))
        full = 2.0 * a.T @ a + 0.5 * c
        assert rel(pc.to_dense().numpy(), np.asarray(jc.to_dense())) < 1e-12
        assert rel(pc.to_dense().numpy(), full) < 1e-12


def test_qr_verbs_match_drivers():
    m, n, nb = 48, 24, 8
    a = rand(m, n, seed=11)
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(rand(m, 2, seed=12), nb=nb, grid=CPU)
    C = pst.Matrix.from_dense(rand(m, 3, seed=13), nb=nb, grid=CPU)
    assert torch.equal(pst.least_squares_solve(A, B).to_dense(),
                       pst.gels(A, B).to_dense())
    QR, T = pst.qr_factor(A)
    QR2, T2 = pst.geqrf(A)
    assert torch.equal(QR.data, QR2.data) and torch.equal(T, T2)
    assert torch.equal(
        pst.qr_multiply_by_q(pst.Side.Left, pst.Op.ConjTrans, QR, T,
                             C).to_dense(),
        pst.unmqr(pst.Side.Left, pst.Op.ConjTrans, QR, T, C).to_dense())
    At = pst.Matrix.from_dense(a.T.copy(), nb=nb, grid=CPU)
    LQ, TL = pst.lq_factor(At)
    LQ2, TL2 = pst.gelqf(At)
    assert torch.equal(LQ.data, LQ2.data) and torch.equal(TL, TL2)
    assert torch.equal(
        pst.lq_multiply_by_q(pst.Side.Left, pst.Op.NoTrans, LQ, TL,
                             C).to_dense(),
        pst.unmlq(pst.Side.Left, pst.Op.NoTrans, LQ, TL, C).to_dense())


def test_qr_gates_and_contracts(monkeypatch, grid11):
    """Auto-on only on a CUDA card for n ≥ 2048; forced anywhere by
    SLATE_QR_FAST=1 for whole-tile m ≥ n; off with =0. The panel mode is
    the card's kernel, or with SLATE_QR_PANEL=1 its plain version."""
    A = pst.Matrix.zeros(256, 128, 128, CPU)
    monkeypatch.delenv("SLATE_QR_FAST", raising=False)
    monkeypatch.delenv("SLATE_QR_PANEL", raising=False)
    assert not pgq._qr_fast_applies(A) and pgq._qr_panel_mode(A) is None
    monkeypatch.setenv("SLATE_QR_FAST", "1")
    monkeypatch.setenv("SLATE_QR_PANEL", "1")
    assert pgq._qr_fast_applies(A) and pgq._qr_panel_mode(A) == "plain"
    assert not pgq._qr_fast_applies(pst.Matrix.zeros(128, 256, 128, CPU))
    assert not pgq._qr_fast_applies(pst.Matrix.zeros(300, 128, 128, CPU))
    monkeypatch.setenv("SLATE_QR_FAST", "0")
    monkeypatch.setenv("SLATE_QR_PANEL", "0")
    assert not pgq._qr_fast_applies(A) and pgq._qr_panel_mode(A) is None
    # complex runs and gives the JAX package's factors; unmqr takes
    # NoTrans and ConjTrans only, as cunmqr does
    ac = rand(256, 128, np.complex128, 4)
    QR, T = pst.geqrf(pst.Matrix.from_dense(ac, nb=128, grid=CPU))
    JQR, JT = jst.geqrf(jst.Matrix.from_dense(ac, nb=128, grid=grid11))
    assert np.abs(QR.to_dense().numpy() - np.asarray(JQR.to_dense())).max() \
        < 1e-12 and np.abs(T.numpy() - np.asarray(JT)).max() < 1e-12
    with pytest.raises(pst.SlateError, match="ConjTrans"):
        pst.unmqr(pst.Side.Left, pst.Op.Trans, QR, T,
                  pst.Matrix.zeros(256, 4, 128, CPU, dtype=torch.complex128))
    with pytest.raises(pst.SlateError, match="dims"):
        QR, T = pst.geqrf(A)
        pst.unmqr(pst.Side.Left, pst.Op.NoTrans, QR, T,
                  pst.Matrix.zeros(128, 4, 128, CPU))


def test_blocked_T_matches_larft():
    """_blocked_T (base-8 recurrence, pairwise combines) against the
    sequential larft, for a width with an odd factor (48 = 6·8) and a
    power of two; the fast-path T of test_geqrf_matches_jax holds it to
    the JAX package's."""
    for nb in (48, 64):
        v = np.tril(rand(200, nb, seed=nb), -1) + np.eye(200, nb)
        taus = 2.0 / (v * v).sum(axis=0)
        out = pgq._blocked_T(torch.from_numpy(v.T @ v),
                             torch.from_numpy(taus), nb)
        seq = pst.internal.tile_kernels.larft(torch.from_numpy(v),
                                              torch.from_numpy(taus))
        assert rel(out.numpy(), seq.numpy()) < 1e-12


def test_sub_keeps_zero_padding():
    a = rand(20, 20, seed=1)
    S = pst.Matrix.from_dense(a, nb=8, grid=CPU).sub(0, 1, 1, 2)
    assert (S.m, S.n) == (16, 12)
    assert np.array_equal(S.to_dense().numpy(), a[:16, 8:20])
    assert float(S.data[0, 0, :, 1, :, 4:].abs().max()) == 0.0
