"""The port's Cholesky slice (potrf / potrs / posv, gemm, trsm) against
the JAX package on a 1×1 grid, on the CPU.

Inputs are made with numpy and carried into both packages; the JAX
factors cross over through ``interop.from_reference``. Tolerances: L and
X within 1e-10·max|A| in f64 and 2e-4·max|A| in f32 — the two sides
block and sum in different orders, on matrices with κ ≤ 5. ``info`` must
be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.types import Uplo as JUplo  # noqa: E402
from slate_tpu_torch.internal.precision import full_f32_matmul  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

TOL = {np.float64: 1e-10, np.float32: 2e-4}
CPU = pst.Grid(1, 1, device="cpu")


def carry(A):
    """A JAX matrix's fields → the port's matrix on the CPU."""
    return pst.from_reference(np.asarray(A.data), kind=type(A).__name__,
                              m=A.m, n=A.n, nb=A.nb, op=A.op.name,
                              uplo=A.uplo.name, diag=A.diag.name,
                              device="cpu")


def tri(M, upper):
    d = M.to_dense()
    d = np.asarray(d.numpy() if isinstance(d, torch.Tensor) else d)
    return np.triu(d) if upper else np.tril(d)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [512, 300])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_posv_matches_jax(grid11, dt, n, upper, nrhs):
    nb = 128
    a = spd(n, dt, seed=n)
    b = rand(n, nrhs, dt, seed=nrhs)
    tol = TOL[dt] * np.abs(a).max()
    uplo = JUplo.Upper if upper else JUplo.Lower
    JA = jst.HermitianMatrix.from_dense(a, nb=nb, grid=grid11, uplo=uplo)
    JAlow = jst.HermitianMatrix.from_dense(a, nb=nb, grid=grid11)
    JB = jst.Matrix.from_dense(b, nb=nb, grid=grid11)
    JL, jinfo = jst.potrf(JA)
    # the JAX package's Upper potrs solves U·Uᴴ instead of Uᴴ·U; its
    # Lower solve of the same A is the reference for both
    JX, _, _ = jst.posv(JAlow, JB)

    A, B = carry(JA), carry(JB)
    L, info = pst.potrf(A)
    assert int(info) == int(jinfo) == 0
    assert np.abs(tri(L, upper) - tri(JL, upper)).max() < tol
    X, L2, info2 = pst.posv(A, B)
    x, jx = X.to_dense().numpy(), np.asarray(JX.to_dense())
    assert int(info2) == 0 and x.shape == (n, nrhs)
    assert np.abs(x - jx).max() < tol
    # potrs from the JAX factor carried across gives the same solve
    Xf = pst.potrs(carry(JL), B)
    assert np.abs(Xf.to_dense().numpy() - jx).max() < tol
    assert torch.equal(A.data, carry(JA).data)       # A is not modified


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("bad,expect", [(5, 1), (200, 2), (290, 3)])
def test_info_matches_jax_on_non_spd(grid11, dt, bad, expect):
    n, nb = 300, 128
    a = spd(n, dt, seed=1)
    a[bad, bad] = -100.0
    _, jinfo = jst.potrf(jst.HermitianMatrix.from_dense(a, nb=nb, grid=grid11))
    _, info = pst.potrf(pst.HermitianMatrix.from_dense(a, nb=nb, grid=CPU))
    assert int(info) == int(jinfo) == expect
    with pytest.raises(pst.InfoError) as e:
        pst.chol_solve(pst.HermitianMatrix.from_dense(a, nb=nb, grid=CPU),
                       pst.Matrix.from_dense(a[:, :2], nb=nb, grid=CPU))
    assert e.value.info == expect


def test_upper_half_is_ignored():
    # the junk half of a Hermitian matrix must not reach the factor
    n, nb = 200, 64
    a = spd(n, np.float64, seed=4)
    junk = a + np.triu(rand(n, n, np.float64, seed=5), 1) * 1e3
    L1, _ = pst.potrf(pst.HermitianMatrix.from_dense(a, nb=nb, grid=CPU))
    L2, _ = pst.potrf(pst.HermitianMatrix.from_dense(junk, nb=nb, grid=CPU))
    assert np.abs(tri(L1, False) - tri(L2, False)).max() < 1e-12


@pytest.mark.parametrize("upper", [False, True])
def test_interop_round_trip_is_bitwise(grid11, upper):
    n, nb = 300, 128
    a = rand(n, n, np.float32, seed=9)
    JA = jst.HermitianMatrix.from_dense(
        a, nb=nb, grid=grid11, uplo=JUplo.Upper if upper else JUplo.Lower)
    A = carry(JA)
    assert isinstance(A, pst.HermitianMatrix)
    assert A.data.dtype == torch.float32
    assert np.array_equal(A.data.numpy(), np.asarray(JA.data))
    assert np.array_equal(A.to_dense().numpy(), np.asarray(JA.to_dense()))
    back = pst.to_reference(A)
    assert back["data"].tobytes() == np.asarray(JA.data).tobytes()
    assert (back["kind"], back["m"], back["n"], back["nb"], back["op"],
            back["uplo"], back["diag"]) == (
        "HermitianMatrix", n, n, nb, "NoTrans", JA.uplo.name, "NonUnit")
    # and back into the JAX package, bit for bit
    J2 = jst.HermitianMatrix(data=jnp_put(back["data"], grid11), m=n, n=n,
                             nb=nb, grid=grid11, uplo=JA.uplo)
    assert np.array_equal(np.asarray(J2.data), np.asarray(JA.data))


def jnp_put(data, grid):
    import jax
    return jax.device_put(data, grid.sharding())


@pytest.mark.parametrize("transa,transb", [(False, False), (True, False),
                                           (False, True)])
def test_gemm_matches_jax(grid11, transa, transb):
    m, k, n, nb = 200, 150, 90, 64
    a = rand(k if transa else m, m if transa else k, np.float64, seed=1)
    b = rand(n if transb else k, k if transb else n, np.float64, seed=2)
    c = rand(m, n, np.float64, seed=3)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.Matrix.from_dense(a, nb=nb, grid=grid)
        B = pkg.Matrix.from_dense(b, nb=nb, grid=grid)
        A = pkg.transpose(A) if transa else A
        B = pkg.transpose(B) if transb else B
        C = pkg.gemm(0.5, A, B, 2.0, pkg.Matrix.from_dense(c, nb=nb,
                                                           grid=grid))
        out.append(np.asarray(C.to_dense()))
    assert np.abs(out[0] - out[1]).max() < 1e-12
    ref = 0.5 * (a.T if transa else a) @ (b.T if transb else b) + 2.0 * c
    assert np.abs(out[1] - ref).max() < 1e-12


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_matches_jax(grid11, side, lower, unit):
    n, nb, k = 300, 128, 70
    t = np.tril(rand(n, n, np.float64, seed=1)) / n + np.eye(n)
    t = t if lower else t.T.copy()
    b = rand(n, k, np.float64, seed=2) if side == "Left" \
        else rand(k, n, np.float64, seed=2)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        T = pkg.TriangularMatrix.from_dense(
            t, nb=nb, grid=grid, uplo=pkg.Uplo.Lower if lower
            else pkg.Uplo.Upper,
            diag=pkg.Diag.Unit if unit else pkg.Diag.NonUnit)
        X = pkg.trsm(pkg.Side[side], 2.0, T,
                     pkg.Matrix.from_dense(b, nb=nb, grid=grid))
        out.append(np.asarray(X.to_dense()))
    assert np.abs(out[0] - out[1]).max() < 1e-10
    tt = (np.tril(t, -1) + np.eye(n) if lower else np.triu(t, 1) + np.eye(n)) \
        if unit else t
    ref = (np.linalg.solve(tt, 2 * b) if side == "Left"
           else np.linalg.solve(tt.T, 2 * b.T).T)
    assert np.abs(out[1] - ref).max() < 1e-10


def test_simplified_verbs():
    n, nb = 130, 64
    a = spd(n, np.float64, seed=2)
    b = rand(n, 2, np.float64, seed=3)
    A = pst.HermitianMatrix.from_dense(a, nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(b, nb=nb, grid=CPU)
    x = pst.chol_solve(A, B).to_dense().numpy()
    assert np.abs(a @ x - b).max() < 1e-12
    L, info = pst.chol_factor(A)
    x2 = pst.chol_solve_using_factor(L, B).to_dense().numpy()
    assert np.abs(x2 - x).max() < 1e-12
    G = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    C = pst.multiply(1.0, G, B, 0.0, pst.Matrix.zeros(n, 2, nb, CPU,
                                                      dtype=torch.float64))
    assert np.abs(C.to_dense().numpy() - a @ b).max() < 1e-12
    # a Hermitian A goes to hemm, as the JAX package's multiply sends it
    H = pst.multiply(1.0, A, B, 0.0, C)
    assert torch.equal(H.data, pst.hemm(pst.Side.Left, 1.0, A, B, 0.0,
                                        C).data)
    assert np.abs(H.to_dense().numpy() - a @ b).max() < 1e-12


def test_unported_options_raise(grid11):
    A = pst.HermitianMatrix.from_dense(spd(8), nb=4, grid=CPU)
    # every tier of the JAX package resolves; an unknown one raises
    for tier in ("bf16_3x", "mxu_bf16"):
        L, info = pst.potrf(A, {pst.Option.TrailingPrecision: tier})
        assert int(info) == 0
    with pytest.raises(pst.SlateError):
        pst.potrf(A, {pst.Option.TrailingPrecision: "nonsense"})
    # every driver runs on a p×q grid (the band Cholesky gives the
    # Grid(1, 1) factor bit for bit); a grid over distinct devices raises
    g22 = pst.Grid(2, 2, device="cpu")
    band = np.tril(np.triu(spd(8), -2))
    F22, info22 = pst.pbtrf(pst.HermitianBandMatrix.from_dense(
        band, nb=4, grid=g22, kl=2, ku=2))
    F11, info11 = pst.pbtrf(pst.HermitianBandMatrix.from_dense(
        band, nb=4, grid=CPU, kl=2, ku=2))
    assert torch.equal(F22.ab, F11.ab) and int(info22) == int(info11) == 0
    with pytest.raises(pst.SlateError, match="multi-device"):
        pst.Grid(1, 2, devices=["cpu", "meta"])
    # complex runs, through torch.linalg, and gives the JAX package's
    # factor and info
    ac = spd(8, np.complex128)
    L, info = pst.potrf(pst.HermitianMatrix.from_dense(ac, nb=4, grid=CPU))
    JL, jinfo = jst.potrf(jst.HermitianMatrix.from_dense(ac, nb=4,
                                                         grid=grid11))
    assert int(info) == int(jinfo) == 0
    assert np.abs(tri(L, False) - tri(JL, False)).max() < 1e-12


def test_tf32_choice_is_pinned_off_and_restored(monkeypatch):
    from slate_tpu_torch.linalg import potrf as potrf_mod
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    seen = []
    real = potrf_mod._syrk_update_inplace

    def spy(*a, **kw):
        seen.append(mm.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(potrf_mod, "_syrk_update_inplace", spy)
    try:
        mm.allow_tf32 = True
        with full_f32_matmul():
            assert mm.allow_tf32 is False
        assert mm.allow_tf32 is True
        A = pst.HermitianMatrix.from_dense(spd(200), nb=64, grid=CPU)
        pst.potrf(A)
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32 = prev
    assert seen and not any(seen)


def test_tf32_pin_with_the_newer_api():
    # a process that set the newer per-backend flag must not be mixed
    # with the legacy one (PyTorch raises on a mix): run it apart
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from slate_tpu_torch.internal.precision import full_f32_matmul\n"
        "mm = torch.backends.cuda.matmul\n"
        "if not hasattr(torch._C, '_get_fp32_precision_getter'):\n"
        "    raise SystemExit(0)\n"
        "mm.fp32_precision = 'tf32'\n"
        "with full_f32_matmul():\n"
        "    assert mm.fp32_precision == 'ieee'\n"
        "assert mm.fp32_precision == 'tf32'\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
