"""The port's hemm, symm, trmm, her2k and syr2k on p×q grids of virtual
ranks against the JAX package's on meshes of virtual CPU devices: both
sides, both uplos, unit and non-unit triangles, a transposed triangular
view, and ``multiply`` with a Hermitian operand.

n = 45 with nb = 8: on 2×4 the row tiles pad to 6 and the column tiles
to 8, so the mirror's block-cyclic transpose crosses differently padded
tile counts (``mt_p ≠ nt_p``); float64 on 2×4 and complex128 on 2×2.
Held to 1e-12 relative to the largest entry of the JAX result (the two
packages sum the same products in other orders) and to the numpy
product. Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.ops import blas as pblas  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

N, K, NB = 45, 13, 8
CASES = [((2, 4), np.float64), ((2, 2), np.complex128)]
IDS = ["2x4-f64", "2x2-c128"]
SIDES = ("Left", "Right")
UPLOS = ("Lower", "Upper")


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def operands(dt):
    """A [N, N] (its halves significant), B [N, K], Bt [K, N], and the
    rank-2k operands X, Y [N, K]."""
    return dict(a=rand(N, N, dt, seed=1), b=rand(N, K, dt, seed=2),
                bt=rand(K, N, dt, seed=3), x=rand(N, K, dt, seed=4),
                y=rand(N, K, dt, seed=5))


def make(pkg, grid, cls, a, **kw):
    return getattr(pkg, cls).from_dense(a, nb=NB, grid=grid, **kw)


def run(pkg, grid, dt, what):
    """One product of ``what`` in package ``pkg``, as a dense array."""
    o = operands(dt)
    kind = what[0]
    if kind in ("hemm", "symm"):
        _, side, uplo = what
        cls = "HermitianMatrix" if kind == "hemm" else "SymmetricMatrix"
        A = make(pkg, grid, cls, o["a"], uplo=getattr(pkg.Uplo, uplo))
        B = make(pkg, grid, "Matrix", o["b"] if side == "Left" else o["bt"])
        C = make(pkg, grid, "Matrix", np.zeros(B.shape, dt))
        out = getattr(pkg, kind)(getattr(pkg.Side, side), 0.5, A, B, 0.0, C)
    elif kind == "trmm":
        _, side, uplo, diag, view = what
        T = make(pkg, grid, "TriangularMatrix", o["a"],
                 uplo=getattr(pkg.Uplo, uplo), diag=getattr(pkg.Diag, diag))
        if view:
            T = pkg.conj_transpose(T)
        B = make(pkg, grid, "Matrix", o["b"] if side == "Left" else o["bt"])
        out = pkg.trmm(getattr(pkg.Side, side), 0.5, T, B)
    else:                                            # her2k / syr2k
        cls = "HermitianMatrix" if kind == "her2k" else "SymmetricMatrix"
        C = make(pkg, grid, cls, o["a"] + o["a"].conj().T)
        out = getattr(pkg, kind)(0.5, make(pkg, grid, "Matrix", o["x"]),
                                 make(pkg, grid, "Matrix", o["y"]), 2.0, C)
    return np.asarray(out.to_dense())


WHATS = ([(k, s, u) for k in ("hemm", "symm") for s in SIDES for u in UPLOS]
         + [("trmm", s, u, d, False) for s in SIDES for u in UPLOS
            for d in ("NonUnit", "Unit")]
         + [("trmm", s, "Lower", "NonUnit", True) for s in SIDES]
         + [("her2k",), ("syr2k",)])


@pytest.fixture(scope="module")
def jax_ref():
    return {((p, q), w): run(jst, jgrid(p, q), dt, w)
            for (p, q), dt in CASES for w in WHATS}


def numpy_ref(dt, what):
    o = operands(dt)
    a, kind = o["a"], what[0]
    if kind in ("hemm", "symm"):
        _, side, uplo = what
        h = np.tril(a) if uplo == "Lower" else np.triu(a)
        strict = np.tril(h, -1) if uplo == "Lower" else np.triu(h, 1)
        d = np.diag(np.diag(a))
        if kind == "hemm":
            full = strict + strict.conj().T + d.real
        else:
            full = strict + strict.T + d
        return 0.5 * (full @ o["b"] if side == "Left" else o["bt"] @ full)
    if kind == "trmm":
        _, side, uplo, diag, view = what
        t = np.tril(a) if uplo == "Lower" else np.triu(a)
        if diag == "Unit":
            np.fill_diagonal(t, 1.0)
        if view:
            t = t.conj().T
        return 0.5 * (t @ o["b"] if side == "Left" else o["bt"] @ t)
    c = a + a.conj().T
    x, y = o["x"], o["y"]
    if kind == "her2k":
        return 0.5 * x @ y.conj().T + 0.5 * y @ x.conj().T + 2.0 * c
    return 0.5 * x @ y.T + 0.5 * y @ x.T + 2.0 * c


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("what", WHATS, ids=["-".join(map(str, w))
                                             for w in WHATS])
def test_blas3_pq_matches_jax(jax_ref, case, what):
    (p, q), dt = case
    got = run(pst, pgrid(p, q), dt, what)
    want = jax_ref[((p, q), what)]
    scale = max(np.abs(want).max(), 1.0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(got - numpy_ref(dt, what)).max() <= 1e-12 * scale


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mirror_across_padded_tile_counts(case):
    """The p×q mirror is the full matrix whatever the grid pads; its
    padding stays zero, and Grid(1, 1) keeps its one-rank mirror."""
    (p, q), dt = case
    a = operands(dt)["a"]
    H = pst.HermitianMatrix.from_dense(a, nb=NB, grid=pgrid(p, q))
    F = pblas._mirror_full(H, conj=True)
    low = np.tril(a, -1)
    want = low + low.conj().T + np.diag(np.diag(a).real)
    assert np.array_equal(F.to_dense().numpy(), want)
    ref = pst.Matrix.from_dense(want, nb=NB, grid=pgrid(p, q))
    assert torch.equal(F.data, ref.data)
    one = pblas._mirror_full(pst.HermitianMatrix.from_dense(
        a, nb=NB, grid=pgrid(1, 1)), conj=True)
    assert np.array_equal(one.to_dense().numpy(), want)


def test_multiply_hermitian_operand_pq():
    """``multiply`` with a Hermitian operand on either side runs hemm on
    the grid."""
    o = operands(np.complex128)
    g = pgrid(2, 4)
    H = pst.HermitianMatrix.from_dense(o["a"], nb=NB, grid=g)
    low = np.tril(o["a"], -1)
    full = low + low.conj().T + np.diag(np.diag(o["a"]).real)
    B = pst.Matrix.from_dense(o["b"], nb=NB, grid=g)
    C = pst.Matrix.from_dense(np.zeros((N, K), complex), nb=NB, grid=g)
    got = pst.multiply(1.0, H, B, 0.0, C).to_dense().numpy()
    assert np.abs(got - full @ o["b"]).max() <= 1e-12 * np.abs(got).max()
    Bt = pst.Matrix.from_dense(o["bt"], nb=NB, grid=g)
    Ct = pst.Matrix.from_dense(np.zeros((K, N), complex), nb=NB, grid=g)
    got = pst.multiply(1.0, Bt, H, 0.0, Ct).to_dense().numpy()
    assert np.abs(got - o["bt"] @ full).max() <= 1e-12 * np.abs(got).max()
