"""The port's Cholesky on p×q grids of virtual ranks against the JAX
package's SPMD programs on meshes of virtual CPU devices.

The same numpy inputs go into both packages, n = 150 with nb = 16 (a
ragged last tile; 10 block columns, so every grid below runs several
lcm(p, q)-aligned super-step chunks). Held to: the factor within
1e-12·‖A‖ of the JAX factor in float64 (the two sum the trailing
products in other orders) on every grid, the 1×4 and 4×1 meshes at
n = 70 (one chunk: each JAX chunk program compiles anew, and the budget
of this module holds two meshes at 150); ``info`` equal on an input that
fails in a later chunk; ``Option.PipelineDepth`` 1 and 2 and every
``Option.ChunkSize`` bit for bit equal to the defaults; complex128 as
float64 (at n = 70). Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.types import Option  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

GRIDS = [(2, 4), (2, 2), (1, 4), (4, 1)]
N, NB = 150, 16
N_ONE = 70              # one chunk on every grid: one JAX compile
SIZE = {(2, 4): N, (2, 2): N, (1, 4): N_ONE, (4, 1): N_ONE}  # JAX n
BAD_COL = 120            # a negative pivot in block column 8 (1-based 8)


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def a_bad():
    a = spd(N, seed=3)
    a[BAD_COL, BAD_COL] = -5.0
    return a


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (p, q), n in SIZE.items():
        L, info = jst.potrf(jst.HermitianMatrix.from_dense(
            spd(n, seed=3), nb=NB, grid=jgrid(p, q)))
        out[(p, q)] = (np.tril(np.asarray(L.to_dense())), int(info))
    _, info = jst.potrf(jst.HermitianMatrix.from_dense(a_bad(), nb=NB,
                                                       grid=jgrid(2, 4)))
    out["bad"] = int(info)
    return out


def port_potrf(a, p, q, opts=None, uplo=pst.Uplo.Lower):
    A = pst.HermitianMatrix.from_dense(a, nb=NB, grid=pgrid(p, q), uplo=uplo)
    return pst.potrf(A, opts)


@pytest.mark.parametrize("p,q", GRIDS)
def test_potrf_pq_matches_jax_and_depths_bitwise(jax_ref, p, q):
    a = spd(SIZE[(p, q)], seed=3)
    L0, info = port_potrf(a, p, q)
    jl, jinfo = jax_ref[(p, q)]
    assert int(info) == jinfo == 0
    l0 = np.tril(L0.to_dense().numpy())
    assert np.abs(l0 - jl).max() <= 1e-12 * np.abs(a).max()
    for depth in (1, 2):
        Ld, info_d = port_potrf(a, p, q, {Option.PipelineDepth: depth})
        assert int(info_d) == 0
        assert torch.equal(Ld.data, L0.data), depth


@pytest.mark.parametrize("p,q", [(2, 4), (2, 2)])
def test_potrf_chunk_sizes_give_the_same_bits(p, q):
    a = spd(N, seed=3)
    L0, _ = port_potrf(a, p, q)
    for cs in (1, 5, 64):
        for depth in (0, 1):
            L, info = port_potrf(a, p, q, {Option.ChunkSize: cs,
                                           Option.PipelineDepth: depth})
            assert int(info) == 0
            assert torch.equal(L.data, L0.data), (cs, depth)
    L, _ = port_potrf(a, p, q, {Option.Lookahead: 4})
    assert torch.equal(L.data, L0.data)


@pytest.mark.parametrize("p,q", GRIDS)
def test_posv_pq_and_info_of_a_later_chunk(jax_ref, p, q):
    a = spd(N, seed=3)
    b = rand(N, 3, seed=4)
    X, L, info = pst.posv(
        pst.HermitianMatrix.from_dense(a, nb=NB, grid=pgrid(p, q)),
        pst.Matrix.from_dense(b, nb=NB, grid=pgrid(p, q)))
    assert int(info) == 0
    assert np.abs(X.to_dense().numpy() - np.linalg.solve(a, b)).max() < 1e-10
    for depth in (0, 1):
        _, info = port_potrf(a_bad(), p, q, {Option.PipelineDepth: depth})
        assert int(info) == jax_ref["bad"] == BAD_COL // NB + 1


def test_upper_and_health():
    """An Upper operand through the block-cyclic transpose, and
    health=True on a p×q grid."""
    a = spd(N, seed=3)
    U, info = port_potrf(a, 2, 2, uplo=pst.Uplo.Upper)
    U1, _ = pst.potrf(pst.HermitianMatrix.from_dense(
        a, nb=NB, grid=pst.Grid(1, 1, device="cpu"), uplo=pst.Uplo.Upper))
    u, u1 = np.triu(U.to_dense().numpy()), np.triu(U1.to_dense().numpy())
    assert int(info) == 0 and np.abs(u - u1).max() < 1e-12
    A = pst.HermitianMatrix.from_dense(a, nb=NB, grid=pgrid(2, 4))
    L, rep = pst.potrf(A, health=True)
    assert rep.info == 0 and rep.routine == "potrf"


def test_complex128_posv_pq_as_float64():
    a = spd(N_ONE, np.complex128, seed=5)
    b = rand(N_ONE, 2, np.complex128, seed=6)
    g, jg = pgrid(2, 4), jgrid(2, 4)
    X, L, info = pst.posv(pst.HermitianMatrix.from_dense(a, nb=NB, grid=g),
                          pst.Matrix.from_dense(b, nb=NB, grid=g))
    JX, JL, jinfo = jst.posv(jst.HermitianMatrix.from_dense(a, nb=NB,
                                                            grid=jg),
                             jst.Matrix.from_dense(b, nb=NB, grid=jg))
    assert int(info) == int(jinfo) == 0
    l, jl = np.tril(L.to_dense().numpy()), np.tril(np.asarray(JL.to_dense()))
    assert np.abs(l - jl).max() <= 1e-12 * np.abs(a).max()
    assert np.abs(X.to_dense().numpy() - np.asarray(JX.to_dense())).max() \
        < 1e-10
    for depth in (1, 2):
        Ld, _ = pst.potrf(pst.HermitianMatrix.from_dense(a, nb=NB, grid=g),
                          {Option.PipelineDepth: depth})
        assert torch.equal(Ld.data, L.data)
