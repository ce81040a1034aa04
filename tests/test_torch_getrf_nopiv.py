"""The port's unpivoted LU (the tile kernel K7 ``lu_nopiv_tile`` through
its plain version, ``lu_nopiv_block``, getrf_nopiv / getrs_nopiv /
gesv_nopiv, ``gesv`` under ``MethodLU.NoPiv`` and the nopiv verbs)
against the JAX package on a 1×1 grid, on the CPU. The CUDA kernel
itself is held to its plain version on the card by
tests/test_torch_gpu.py.

Inputs are diagonally dominant (G + n·I from a numpy seed), so no pivot
is needed, except where a zero row and column make one exact zero pivot.
Tolerances: ``info`` must be equal. The tile LU against the Pallas
kernel in interpret mode (and at the ragged nb = 200, which the Pallas
kernel does not factor, against the textbook LU in f64) within relative
Frobenius 1e-5 in f32 (the
Pallas kernel blocks by 128 columns right-looking, the port's by 64
left-looking); the plain version's doubling inverse of a safe upper
block against ``solve_triangular`` within 1e-13 in f64; the drivers and
solves within 1e-5 in f32 and 1e-12 in f64 (the tile factorizations and
trailing products sum in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.internal import pallas_kernels as pk  # noqa: E402
from slate_tpu.internal import tile_kernels as jtk  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import tile_kernels as tk  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
TOL = {np.float32: 1e-5, np.float64: 1e-12}
ZERO = 37             # the row and column zeroed for an exact zero pivot


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def dominant(n, dt, seed, zero=None):
    a = rand(n, n, np.float64, seed) + n * np.eye(n)
    if zero is not None:
        a[zero, :] = 0.0
        a[:, zero] = 0.0
    return a.astype(dt)


@pytest.mark.parametrize("nb", [64, 256, 100])
def test_lu_nopiv_tile_plain_matches_pallas(nb):
    a = dominant(nb, np.float32, nb, zero=ZERO)
    ref, rinfo = pk.lu_nopiv_tile_pallas(jnp.asarray(a), interpret=True)
    before = dict(K.LAUNCHES)
    lu, info = K.lu_nopiv_tile(torch.from_numpy(a))
    assert K.LAUNCHES == before               # the plain version ran
    assert int(info) == int(rinfo) == 1 and lu[ZERO, ZERO] == 0.0
    assert rel(lu.numpy(), np.asarray(ref)) < TOL[np.float32]


def test_lu_nopiv_tile_plain_ragged_matches_textbook_lu():
    """nb = 200 is ragged against the port's 64-column blocks; the Pallas
    kernel factors only nb // 128 of its 128-column blocks (its
    capability row is 128 … 1024 by 128), so the reference here is the
    textbook right-looking LU in f64 with the same safe pivot."""
    nb = 200
    a = dominant(nb, np.float32, nb, zero=ZERO)
    ref = a.astype(np.float64)
    for j in range(nb):
        p = ref[j, j]
        ref[j + 1:, j] /= 1.0 if p == 0 else p
        ref[j + 1:, j + 1:] -= np.outer(ref[j + 1:, j], ref[j, j + 1:])
    lu, info = K.lu_nopiv_tile(torch.from_numpy(a))
    assert int(info) == 1 and lu[ZERO, ZERO] == 0.0
    assert rel(lu.numpy(), ref) < TOL[np.float32]


@pytest.mark.parametrize("w", [64, 37])
def test_inv_upper_safe_doubling_matches_solve_triangular(w):
    """The plain version's U⁻¹ (the doubling inverse of Uᵀ, as the kernel
    forms it) against a triangular solve with the safe diagonal, one
    diagonal entry exactly zero."""
    rng = np.random.default_rng(w)
    u = np.triu(rng.standard_normal((w, w)) / w) + np.eye(w)
    u[w // 2, w // 2] = 0.0
    safe = u.copy()
    safe[w // 2, w // 2] = 1.0
    ut = torch.from_numpy(u)
    ref = torch.linalg.solve_triangular(torch.from_numpy(safe),
                                        torch.eye(w, dtype=ut.dtype),
                                        upper=True)
    inv = K._inv_upper_safe_doubling(ut)
    assert torch.equal(inv, inv.triu())
    assert rel(inv.numpy(), ref.numpy()) < 1e-13


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_lu_nopiv_block_strip_path_matches_jax(monkeypatch, dt):
    """Outside the capability table the block takes the ib=32 strip
    algorithm, as in the JAX package (whose tile rung is off)."""
    monkeypatch.setitem(K.CAPABILITY, "cpu", {})
    n = 96
    a = dominant(n, dt, 5, zero=ZERO)
    ref, rinfo = jtk.lu_nopiv_block(jnp.asarray(a))
    lu, info = tk.lu_nopiv_block(torch.from_numpy(a))
    assert int(info) == int(rinfo) == 1
    assert rel(lu.numpy(), np.asarray(ref)) < TOL[dt]


CASES = [(256, 64, np.float32), (300, 64, np.float32), (300, 64, np.float64)]


@pytest.fixture(scope="module")
def jax_gesv_nopiv(grid11):
    out = {}
    for n, nb, dt in CASES:
        a, b = dominant(n, dt, n), rand(n, 3, dt, seed=n + 1)
        X, LU, info = jst.linalg.getrf.gesv_nopiv(
            jst.Matrix.from_dense(a, nb=nb, grid=grid11),
            jst.Matrix.from_dense(b, nb=nb, grid=grid11))
        out[(n, nb, dt)] = (np.asarray(X.to_dense()),
                            np.asarray(LU.to_dense()), int(info), LU)
    return out


@pytest.mark.parametrize("n,nb,dt", CASES,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_nopiv_drivers_match_jax(jax_gesv_nopiv, n, nb, dt):
    a, b = dominant(n, dt, n), rand(n, 3, dt, seed=n + 1)
    jx, jlu, jinfo, JLU = jax_gesv_nopiv[(n, nb, dt)]
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(b, nb=nb, grid=CPU)
    LU, info = pst.getrf_nopiv(A)
    X, LU2, info2 = pst.gesv_nopiv(A, B)
    assert int(info) == int(info2) == jinfo == 0
    assert rel(LU.to_dense().numpy(), jlu) < TOL[dt]
    assert torch.equal(LU.data, LU2.data)
    assert rel(X.to_dense().numpy(), jx) < TOL[dt]
    # getrs_nopiv from the JAX factors carried across
    carried = pst.from_reference(np.asarray(JLU.data), kind="Matrix", m=n,
                                 n=n, nb=nb, device="cpu")
    x = pst.getrs_nopiv(carried, B).to_dense().numpy()
    assert rel(x, jx) < TOL[dt]
    # the backward error of an unpivoted LU of a dominant matrix
    lu = LU.to_dense().numpy().astype(np.float64)
    l, u = np.tril(lu, -1) + np.eye(n), np.triu(lu)
    assert np.linalg.norm(a - l @ u) / (n * np.linalg.norm(a)) < 1e-6
    # the tile padding stays zero
    full = pst.tiles_to_dense(pst.bc_to_tiles(LU.data), LU.mtl * nb,
                              LU.ntl * nb)
    assert not full[n:].any() and not full[:, n:].any()


def test_gesv_nopiv_zero_pivot_matches_jax(grid11):
    n, nb = 256, 64
    a = dominant(n, np.float32, 3, zero=100)
    b = rand(n, 2, np.float32, seed=4)
    _, _, jinfo = jst.linalg.getrf.gesv_nopiv(
        jst.Matrix.from_dense(a, nb=nb, grid=grid11),
        jst.Matrix.from_dense(b, nb=nb, grid=grid11))
    _, LU, info = pst.gesv_nopiv(pst.Matrix.from_dense(a, nb=nb, grid=CPU),
                                 pst.Matrix.from_dense(b, nb=nb, grid=CPU))
    assert int(info) == int(jinfo) == 1
    assert float(LU.to_dense()[100, 100]) == 0.0


def test_nopiv_verbs_and_method():
    n, nb = 192, 64
    a, b = dominant(n, np.float64, 8), rand(n, 2, seed=9)
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(b, nb=nb, grid=CPU)
    LU, info = pst.lu_factor_nopiv(A)
    x = pst.lu_solve_using_factor_nopiv(LU, B).to_dense()
    assert torch.equal(x, pst.lu_solve_nopiv(A, B).to_dense())
    assert rel(x.numpy(), np.linalg.solve(a, b)) < 1e-12
    opts = {pst.Option.MethodLU: pst.MethodLU.NoPiv}
    assert pst.MethodLU.select_algo(A, opts) == pst.MethodLU.NoPiv
    X, LU2, piv, info2 = pst.gesv(A, B, opts)
    assert piv is None and int(info2) == 0
    assert torch.equal(X.to_dense(), x) and torch.equal(LU2.data, LU.data)
    with pytest.raises(pst.InfoError, match="zero pivot"):
        pst.lu_solve_nopiv(pst.Matrix.from_dense(dominant(n, np.float64, 8,
                                                          zero=70),
                                                 nb=nb, grid=CPU), B)


def test_lu_nopiv_tile_contracts():
    assert K.supported("lu_nopiv_tile", torch.float32, 1024, "cuda")
    assert not K.supported("lu_nopiv_tile", torch.float32, 1025, "cuda")
    assert not K.supported("lu_nopiv_tile", torch.float64, 64, "cuda")
    assert K.supported("lu_nopiv_tile", torch.float64, 64, "cpu")
    with pytest.raises(pst.SlateError):
        K.lu_nopiv_tile(torch.empty(8, 8, device="meta"))
    assert "lu_nopiv_tile" in K.LAUNCHES
