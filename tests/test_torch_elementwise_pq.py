"""The port's elementwise ops and test-matrix generator on p×q grids of
virtual ranks, on the CPU.

* ``add``, ``copy``, ``scale``, ``scale_row_col``, ``set_matrix`` (a
  general, a lower and an upper triangular and a band shape) and
  ``_add_scaled_identity`` against the JAX package's ``shard_map``
  bodies on meshes of virtual CPU devices, within 1e-10 relative to the
  largest entry of the JAX result (both packages compute each entry by
  the same few operations; XLA may fuse them), and bit for bit against
  the port's own Grid(1, 1) result; the padding stays zero on every rank.
* The generator: every kind on a p×q grid is the Grid(1, 1) matrix of
  the port bit for bit (each slot draws the tile at its global index, by
  the counter hash for the random kinds), the formula kinds also against
  the JAX package's p×q generator (exact, or within 2⁻¹⁶ / 1e-12 of the
  largest entry for orthog and chebspec, as in
  ``tests/test_torch_utils.py``), ``random_spd`` SPD and within 1e-12 of
  its Grid(1, 1) matrix (the p×q ``syrk`` sums in another order), and the
  default tile size by the JAX package's rule.

A 70×45 matrix with nb = 8 (9×6 tiles, both edges ragged), float64 on
2×4 and complex128 on 2×2. Each JAX reference is computed once per
module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
from slate_tpu.ops import elementwise as jel  # noqa: E402
from slate_tpu.utils import generator as jgen  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.ops import elementwise as pel  # noqa: E402
from slate_tpu_torch.utils import generator as pgen  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

M, N, NB = 70, 45, 8
CASES = [((2, 4), np.float64), ((2, 2), np.complex128)]
IDS = ["2x4-f64", "2x2-c128"]
OPS = ("add", "copy", "scale", "scale_row_col", "set_general", "set_lower",
       "set_upper", "set_band", "add_scaled_identity")


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def run(pkg, el, grid, dt, op):
    """One elementwise op in package ``pkg`` (module ``el``) on ``grid``;
    the result matrix."""
    a, b = rand(M, N, dt, seed=1), rand(M, N, dt, seed=2)
    mk = lambda x, cls="Matrix", **kw: getattr(pkg, cls).from_dense(  # noqa
        x, nb=NB, grid=grid, **kw)
    A, B = mk(a), mk(b)
    if op == "add":
        return el.add(2.0, A, -0.5, B)
    if op == "copy":
        return el.copy(A, B)
    if op == "scale":
        return el.scale(3.0, 7.0, A)
    if op == "scale_row_col":
        r, c = rand(1, M, dt, seed=3)[0], rand(1, N, dt, seed=4)[0]
        return el.scale_row_col(r, c, A)
    if op == "set_general":
        return el.set_matrix(0.25, 2.0, A)
    if op in ("set_lower", "set_upper"):
        uplo = getattr(pkg.Uplo, op[4:].capitalize())
        return el.set_matrix(0.25, 2.0, mk(a, "TrapezoidMatrix", uplo=uplo))
    if op == "set_band":
        return el.set_matrix(0.25, 2.0, mk(a, "BandMatrix", kl=9, ku=4))
    # square: the JAX package's diagonal runs past column n when m > n
    return el._add_scaled_identity(mk(a[:N]), 1.5)


@pytest.fixture(scope="module")
def jax_ref():
    return {((p, q), op): np.asarray(run(jst, jel, jgrid(p, q), dt,
                                         op).to_dense())
            for (p, q), dt in CASES for op in OPS}


def padding_is_zero(X):
    """Every rank's slots outside the true m×n matrix hold zeros."""
    tiles = pst.tiles_to_dense(pst.bc_to_tiles(X.data), X.mtl * X.grid.p
                               * X.nb, X.ntl * X.grid.q * X.nb)
    return not tiles[X.m:].any() and not tiles[:, X.n:].any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("op", OPS)
def test_elementwise_pq_matches_jax_and_one_rank(jax_ref, case, op):
    (p, q), dt = case
    X = run(pst, pel, pgrid(p, q), dt, op)
    got = X.to_dense().numpy()
    want = jax_ref[((p, q), op)]
    assert X.grid == pgrid(p, q) and got.shape == want.shape
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    one = run(pst, pel, pgrid(1, 1), dt, op)
    assert torch.equal(X.to_dense(), one.to_dense())
    assert padding_is_zero(X)


def test_elementwise_pq_refuses_mixed_layouts():
    A = pst.Matrix.from_dense(rand(M, N, seed=1), nb=NB, grid=pgrid(2, 4))
    B = pst.Matrix.from_dense(rand(M, N, seed=2), nb=NB, grid=pgrid(2, 2))
    with pytest.raises(pst.SlateError, match="grid"):
        pst.add(1.0, A, 1.0, B)
    with pytest.raises(pst.SlateError, match="grid"):
        pst.copy(A, B)


def generate(kind, grid, dt, **kw):
    if kind in ("heev", "poev", "spd"):
        return pst.generate_matrix(kind, M, nb=NB, grid=grid, dtype=dt,
                                   seed=7, **kw)
    return pst.generate_matrix(kind, M, N, nb=NB, grid=grid, dtype=dt,
                               seed=7, **kw)


FAMILIES = {
    "random": [(k, {}) for k in ("rand", "randu", "randn", "rands", "randb",
                                 "randr")] + [("randn", {"dominant": True})],
    "formula": [(k, {"dist": "geo"}) for k in pgen.FORMULA_KINDS],
    "structured": [(k, {"dist": "arith", "cond": 1e3})
                   for k in ("svd", "heev", "poev", "spd")],
}


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generator_pq_is_the_one_rank_matrix(case, family):
    """Every kind on the p×q grid: the Grid(1, 1) matrix bit for bit, on
    the grid, of the same class and dtype, its padding zero."""
    (p, q), dt = case
    for kind, kw in FAMILIES[family]:
        X = generate(kind, pgrid(p, q), dt, **kw)
        one = generate(kind, pgrid(1, 1), dt, **kw)
        assert X.grid == pgrid(p, q) and type(X) is type(one), kind
        assert X.dtype == one.dtype and X.nb == one.nb, kind
        assert torch.equal(X.to_dense(), one.to_dense()), (kind, kw)
        assert padding_is_zero(X), kind


@pytest.fixture(scope="module")
def jax_formulas():
    out = {}
    for (p, q), dt in CASES:
        for kind in jgen.FORMULA_KINDS:
            A = jst.generate_matrix(kind, M, N, nb=NB, grid=jgrid(p, q),
                                    dtype=dt, dist="geo")
            out[(p, q), kind] = (type(A).__name__, np.asarray(A.to_dense()))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_generator_pq_formula_kinds_match_jax(jax_formulas, case):
    (p, q), dt = case
    for kind in pgen.FORMULA_KINDS:
        cls, want = jax_formulas[(p, q), kind]
        A = pst.generate_matrix(kind, M, N, nb=NB, grid=pgrid(p, q),
                                dtype=dt, dist="geo")
        got = A.to_dense().numpy()
        assert type(A).__name__ == cls and got.dtype == want.dtype, kind
        if kind in ("orthog", "chebspec"):
            u = 1e-12 if dt == np.complex128 else 2.0 ** -16
            assert np.abs(got - want).max() <= u * np.abs(want).max(), kind
        else:
            assert np.array_equal(got, want), kind


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_random_spd_pq(case):
    (p, q), dt = case
    S = pst.random_spd(M, NB, pgrid(p, q), dtype=dt, seed=3)
    one = pst.random_spd(M, NB, pgrid(1, 1), dtype=dt, seed=3)
    s = S.to_dense().numpy()
    assert isinstance(S, pst.HermitianMatrix) and S.grid == pgrid(p, q)
    assert np.abs(s - one.to_dense().numpy()).max() <= 1e-12 * np.abs(s).max()
    assert np.abs(s - s.conj().T).max() <= 1e-12 * np.abs(s).max()
    assert np.linalg.eigvalsh(s).min() >= 1.0 - 1e-10
    assert padding_is_zero(S)


def test_generator_default_nb_follows_jax():
    """With no nb the generator takes the JAX package's tile size,
    min(256, max(8, m // max(p, q))), on every grid and entry point."""
    for m, (p, q) in ((70, (2, 4)), (70, (2, 2)), (2048, (2, 4)),
                      (40, (1, 4)), (600, (4, 1)), (5, (2, 2))):
        jg = jgrid(p, q)
        g = pgrid(p, q)
        want = jst.random_matrix(m, 9, grid=jg).nb
        assert want == min(256, max(8, m // max(p, q)))
        assert pst.random_matrix(m, 9, grid=g).nb == want
        assert pst.generate_matrix("ones", m, 9, grid=g).nb == want
        assert pst.random_spd(m, grid=g).nb == want
