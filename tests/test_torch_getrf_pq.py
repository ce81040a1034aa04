"""The port's LU (partial pivoting and none) on p×q grids of virtual
ranks against the JAX package's SPMD programs on meshes of virtual CPU
devices.

The same numpy inputs go into both packages, n = 150 with nb = 16 (a
ragged last tile, several lcm(p, q)-aligned super-step chunks on every
grid). Held to: the factors within 1e-12·‖A‖ of the JAX factors in
float64 and the pivots exactly equal on every grid, the 2×2 and 4×1
meshes at n = 70 (each JAX chunk program compiles anew, and the budget
of this module holds two meshes at 150); in float32 the factors
within 1.5× the JAX package's own max-norm distance from the float64 LU
of P·A with the same pivots (ROADMAP §C: the packages round the trailing products in
other orders); ``info`` equal on a singular input whose zero column lies
in a later chunk; ``Option.PipelineDepth`` 1 and 2 and every
``Option.ChunkSize`` bit for bit equal to the defaults, pivots included;
complex128 as float64 (at n = 70). No p×q solve passes through a dense global
matrix: with ``tiles_to_dense`` and ``bc_to_tiles`` raising, posv, gesv
and gesv_nopiv still run. Each JAX reference is computed once per
module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch import runtime as prt  # noqa: E402
from slate_tpu_torch.types import Option  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

GRIDS = [(2, 4), (2, 2), (1, 4), (4, 1)]
N, NB = 150, 16
N_ONE = 70                     # one chunk on every grid: one JAX compile
SIZE = {(2, 4): N, (1, 4): N, (2, 2): N_ONE, (4, 1): N_ONE}  # JAX n
ZERO_COL = 130           # a zero column in block column 8


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def a_singular():
    a = rand(N, N, seed=21)
    a[:, ZERO_COL] = 0.0
    return a


@pytest.fixture(scope="module")
def jax_ref():
    a = rand(N, N, seed=21)
    out = {}
    for (p, q), n in SIZE.items():
        LU, piv, info = jst.getrf(jst.Matrix.from_dense(
            rand(n, n, seed=21), nb=NB, grid=jgrid(p, q)))
        out[(p, q)] = (np.asarray(LU.to_dense()), np.asarray(piv),
                       int(info))
    LU, piv, info = jst.getrf(jst.Matrix.from_dense(a.astype(np.float32),
                                                    nb=NB, grid=jgrid(2, 4)))
    out["f32"] = (np.asarray(LU.to_dense()), np.asarray(piv))
    _, _, info = jst.getrf(jst.Matrix.from_dense(a_singular(), nb=NB,
                                                 grid=jgrid(2, 4)))
    out["singular"] = int(info)
    s = spd(N, seed=22)
    LU, info = jst.getrf_nopiv(jst.Matrix.from_dense(s, nb=NB,
                                                     grid=jgrid(2, 2)))
    out["nopiv"] = (np.asarray(LU.to_dense()), int(info))
    return out


def port_getrf(a, p, q, opts=None):
    return pst.getrf(pst.Matrix.from_dense(a, nb=NB, grid=pgrid(p, q)), opts)


def lu_nopiv64(a):
    """Doolittle LU without pivoting in float64: (L, U)."""
    a = a.astype(np.float64).copy()
    n = a.shape[0]
    for k in range(n - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    return np.tril(a, -1) + np.eye(n), np.triu(a)


@pytest.mark.parametrize("p,q", GRIDS)
def test_getrf_pq_matches_jax_and_depths_bitwise(jax_ref, p, q):
    a = rand(SIZE[(p, q)], SIZE[(p, q)], seed=21)
    LU0, piv0, info = port_getrf(a, p, q)
    jlu, jpiv, jinfo = jax_ref[(p, q)]
    assert int(info) == jinfo == 0
    np.testing.assert_array_equal(piv0.numpy(), jpiv)
    assert np.abs(LU0.to_dense().numpy() - jlu).max() <= \
        1e-12 * np.abs(a).max()
    for depth in (1, 2):
        LU, piv, info = port_getrf(a, p, q, {Option.PipelineDepth: depth})
        assert int(info) == 0
        assert torch.equal(LU.data, LU0.data) and torch.equal(piv, piv0)


@pytest.mark.parametrize("p,q", [(2, 4), (4, 1)])
def test_getrf_chunk_sizes_give_the_same_bits(p, q):
    a = rand(N, N, seed=21)
    LU0, piv0, _ = port_getrf(a, p, q)
    for cs in (1, 9, 64):
        for depth in (0, 2):
            LU, piv, _ = port_getrf(a, p, q, {Option.ChunkSize: cs,
                                              Option.PipelineDepth: depth})
            assert torch.equal(LU.data, LU0.data), (cs, depth)
            assert torch.equal(piv, piv0)


def test_getrf_f32_within_jax_distance(jax_ref):
    a = rand(N, N, np.float32, seed=21)
    LU, piv, info = port_getrf(a, 2, 4)
    jlu, jpiv = jax_ref["f32"]
    assert int(info) == 0
    np.testing.assert_array_equal(piv.numpy(), jpiv)
    perm = prt.resolve_pivots(jpiv, N)
    L64, U64 = lu_nopiv64(a.astype(np.float64)[perm])
    ref = np.tril(L64, -1) + U64
    d_port = np.abs(LU.to_dense().numpy() - ref).max()
    d_jax = np.abs(jlu - ref).max()
    assert d_port <= 1.5 * d_jax
    lu = LU.to_dense().numpy().astype(np.float64)
    L, U = np.tril(lu, -1) + np.eye(N), np.triu(lu)
    assert np.abs(a.astype(np.float64)[perm] - L @ U).max() / (
        N * np.abs(a).max()) <= 1e-5


@pytest.mark.parametrize("p,q", GRIDS)
def test_gesv_pq_and_singular_info(jax_ref, p, q):
    a = rand(N, N, seed=21)
    b = rand(N, 3, seed=23)
    g = pgrid(p, q)
    X, LU, piv, info = pst.gesv(pst.Matrix.from_dense(a, nb=NB, grid=g),
                                pst.Matrix.from_dense(b, nb=NB, grid=g))
    assert int(info) == 0
    x = X.to_dense().numpy()
    assert np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max()) \
        < 1e-13
    for depth in (0, 1):
        _, _, info = port_getrf(a_singular(), p, q,
                                {Option.PipelineDepth: depth})
        assert int(info) == jax_ref["singular"] >= 1


@pytest.mark.parametrize("p,q", GRIDS)
def test_gesv_nopiv_pq(jax_ref, p, q):
    s = spd(N, seed=22)
    b = rand(N, 2, seed=24)
    g = pgrid(p, q)
    X, LU, info = pst.gesv_nopiv(pst.Matrix.from_dense(s, nb=NB, grid=g),
                                 pst.Matrix.from_dense(b, nb=NB, grid=g))
    jlu, jinfo = jax_ref["nopiv"]
    assert int(info) == jinfo == 0
    assert np.abs(LU.to_dense().numpy() - jlu).max() <= \
        1e-12 * np.abs(s).max()
    assert np.abs(X.to_dense().numpy() - np.linalg.solve(s, b)).max() < 1e-10
    for depth in (1, 2):
        LUd, _ = pst.getrf_nopiv(pst.Matrix.from_dense(s, nb=NB, grid=g),
                                 {Option.PipelineDepth: depth})
        assert torch.equal(LUd.data, LU.data)


def test_complex128_gesv_pq_as_float64():
    a = rand(N_ONE, N_ONE, np.complex128, seed=25)
    b = rand(N_ONE, 2, np.complex128, seed=26)
    g, jg = pgrid(2, 4), jgrid(2, 4)
    X, LU, piv, info = pst.gesv(pst.Matrix.from_dense(a, nb=NB, grid=g),
                                pst.Matrix.from_dense(b, nb=NB, grid=g))
    JX, JLU, jpiv, jinfo = jst.gesv(jst.Matrix.from_dense(a, nb=NB, grid=jg),
                                    jst.Matrix.from_dense(b, nb=NB, grid=jg))
    assert int(info) == int(jinfo) == 0
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    assert np.abs(LU.to_dense().numpy() - np.asarray(JLU.to_dense())).max() \
        <= 1e-12 * np.abs(a).max()
    assert np.abs(X.to_dense().numpy() - np.asarray(JX.to_dense())).max() \
        < 1e-10
    LU1, piv1, _ = pst.getrf(pst.Matrix.from_dense(a, nb=NB, grid=g),
                             {Option.PipelineDepth: 1})
    assert torch.equal(LU1.data, LU.data) and torch.equal(piv1, piv)


def test_no_dense_global_route(monkeypatch):
    """With the port's tile ⇄ dense conversions raising, the p×q solves
    still run: no driver gathers the matrix and takes the 1×1 path."""
    g = pgrid(2, 2)
    a, s, b = rand(N, N, seed=21), spd(N, seed=22), rand(N, 2, seed=24)
    A = pst.Matrix.from_dense(a, nb=NB, grid=g)
    S = pst.HermitianMatrix.from_dense(s, nb=NB, grid=g)
    SG = pst.Matrix.from_dense(s, nb=NB, grid=g)
    B = pst.Matrix.from_dense(b, nb=NB, grid=g)

    def refuse(*a, **k):
        raise AssertionError("a p×q driver gathered the dense matrix")

    import sys
    for name, mod in list(sys.modules.items()):
        if name.startswith("slate_tpu_torch"):
            for fn in ("tiles_to_dense", "bc_to_tiles"):
                if hasattr(mod, fn):
                    monkeypatch.setattr(mod, fn, refuse)
    X1, _, info1 = pst.posv(S, B, {Option.PipelineDepth: 1})
    X2, _, _, info2 = pst.gesv(A, B)
    X3, _, info3 = pst.gesv_nopiv(SG, B)
    monkeypatch.undo()
    assert int(info1) == int(info2) == int(info3) == 0
    assert np.abs(X1.to_dense().numpy() - np.linalg.solve(s, b)).max() < 1e-10
    assert np.abs(X2.to_dense().numpy() - np.linalg.solve(a, b)).max() < 1e-9
    assert np.abs(X3.to_dense().numpy() - np.linalg.solve(s, b)).max() < 1e-10
