"""The port's p×q grid of virtual ranks, its block-cyclic storage and its
masks against the JAX package's, and every entry point that once refused
a p×q grid running on one, on the CPU.

Storage after ``from_dense``, ``redistribute``, ``from_tile_map`` and a
resolved transpose is held bit for bit to the JAX package's
``[p, q, mtl, ntl, nb, nb]`` stack on the grids of the JAX fixtures (2×4
and 2×2) and on 1×4 and 4×1, with ragged sizes. Every entry point of
the p×q slices runs on a 2×2 grid.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import slate_tpu as jst  # noqa: E402
from slate_tpu.grid import AXIS_P, AXIS_Q  # noqa: E402
from slate_tpu.internal import masks as jmasks  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.internal import masks  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

GRIDS = [(2, 4), (2, 2), (1, 4), (4, 1)]
NB = 8


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def test_grid_construction_and_maps():
    g = pgrid(2, 4)
    j = jgrid(2, 4)
    assert g.size == 8 and g.device == torch.device("cpu")
    assert len(g.devices) == 8 and set(g.devices) == {g.device}
    for i, jj in [(0, 0), (5, 3), (7, 10)]:
        assert g.tile_owner(i, jj) == j.tile_owner(i, jj)
        assert g.tile_slot(i, jj) == j.tile_slot(i, jj)
        assert g.global_tile(*g.tile_owner(i, jj), *g.tile_slot(i, jj)) \
            == (i, jj) == j.global_tile(*j.tile_owner(i, jj),
                                        *j.tile_slot(i, jj))
        assert g.tile_device(i, jj) == g.device
    for rank in range(8):
        assert g.rank_coords(rank) == (rank % 2, rank // 2)
    row = pst.Grid(2, 4, device="cpu", order=pst.types.GridOrder.Row)
    assert row.rank_coords(5) == (1, 1)
    from slate_tpu.grid import _default_pq as jpq
    from slate_tpu_torch.grid import _default_pq
    for nd in (1, 2, 4, 6, 8, 12):
        assert _default_pq(nd) == jpq(nd)
    g6 = pst.Grid(devices=["cpu"] * 6)
    assert (g6.p, g6.q) == jpq(6)
    with pytest.raises(pst.SlateError, match="multi-device"):
        pst.Grid(1, 2, devices=["cpu", "meta"])
    with pytest.raises(pst.SlateError, match="device count"):
        pst.Grid(2, 2, devices=["cpu"] * 3)
    with pytest.raises(pst.SlateError):
        pst.Grid(0, 2, device="cpu")
    assert pgrid(2, 2) == pgrid(2, 2) and pgrid(2, 2) != pgrid(2, 1)


def test_default_grid_is_one_rank_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pst.SlateError, match="device='cpu'"):
        pst.default_grid()
    with pytest.raises(pst.SlateError, match="device='cpu'"):
        pst.Grid(2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    g = pst.default_grid()
    assert (g.p, g.q, g.device.type) == (1, 1, "cuda")


@pytest.mark.parametrize("p,q", GRIDS)
def test_storage_bit_for_bit(p, q):
    a = rand(45, 37, np.complex128, seed=p + 10 * q)
    A = pst.Matrix.from_dense(a, nb=NB, grid=pgrid(p, q))
    J = jst.Matrix.from_dense(a, nb=NB, grid=jgrid(p, q))
    np.testing.assert_array_equal(A.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(A.to_dense().numpy(), a)
    np.testing.assert_array_equal(A.tile(4, 3).numpy(),
                                  np.asarray(J.tile(4, 3)))
    # a resolved transposed view: the block-cyclic transpose
    for view, jview in [(pst.transpose, jst.transpose),
                        (pst.conj_transpose, jst.conj_transpose)]:
        np.testing.assert_array_equal(
            view(A).materialize().data.numpy(),
            np.asarray(jview(J).materialize().data))
    # redistribute onto every other grid
    for p2, q2 in GRIDS + [(1, 1)]:
        R = A.redistribute(pgrid(p2, q2))
        JR = J.redistribute(jgrid(p2, q2) if p2 * q2 > 1
                            else jst.Grid(1, 1, devices=jax.devices()[:1]))
        assert (R.grid.p, R.grid.q) == (p2, q2)
        np.testing.assert_array_equal(R.data.numpy(), np.asarray(JR.data))
    # from_tile_map: tiles from a provider, cropped at the ragged edge
    def provider(i, j):
        return np.full((NB, NB), 100.0 * i + j)
    T = pst.Matrix.from_tile_map(45, 37, NB, provider, grid=pgrid(p, q))
    JT = jst.Matrix.from_tile_map(45, 37, NB, provider, grid=jgrid(p, q))
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(JT.data))
    Z = pst.Matrix.zeros(45, 37, NB, pgrid(p, q), dtype=torch.float64)
    assert Z.data.shape == J.data.shape and not Z.data.any()
    # a JAX matrix on the mesh crosses to the port's p×q grid and back
    X = pst.from_reference(np.asarray(J.data), kind="Matrix", m=45, n=37,
                           nb=NB, device="cpu")
    assert (X.grid.p, X.grid.q) == (p, q) and torch.equal(X.data, A.data)
    np.testing.assert_array_equal(pst.to_reference(X)["data"],
                                  np.asarray(J.data))
    S = A.sub(1, 3, 0, 2)
    np.testing.assert_array_equal(S.data.numpy(),
                                  np.asarray(J.sub(1, 3, 0, 2).data))


@pytest.mark.parametrize("p,q", [(2, 4), (4, 1)])
def test_masks_match_jax(p, q):
    mtl, ntl, nb, m, n = 3, 2, 4, 21, 25
    g = jgrid(p, q)

    def body(x):
        return tuple(y[None, None] for y in (
            jmasks.local_tile_rows(mtl, p),
            jmasks.local_tile_cols(ntl, q),
            jmasks.local_elem_rows(mtl, nb, p),
            jmasks.valid_mask(mtl, ntl, nb, p, q, m, n),
            jmasks.uplo_mask(mtl, ntl, nb, p, q, lower=True, strict=True),
            jmasks.uplo_mask(mtl, ntl, nb, p, q, lower=False),
            jmasks.band_mask(mtl, ntl, nb, p, q, 3, 5)))

    want = jax.jit(jax.shard_map(
        body, mesh=g.mesh, in_specs=(P(AXIS_P, AXIS_Q),),
        out_specs=tuple(P(AXIS_P, AXIS_Q) for _ in range(7)),
        check_vma=False))(jnp.zeros((p, q)))
    want = [np.asarray(w) for w in want]
    got = [masks.local_tile_rows(mtl, p)[:, None].expand(p, q, mtl),
           masks.local_tile_cols(ntl, q)[None].expand(p, q, ntl),
           masks.local_elem_rows(mtl, nb, p)[:, None].expand(p, q, mtl, nb),
           masks.valid_mask(mtl, ntl, nb, m, n, p=p, q=q),
           masks.uplo_mask(mtl, ntl, nb, True, strict=True, p=p, q=q),
           masks.uplo_mask(mtl, ntl, nb, False, p=p, q=q),
           masks.band_mask(mtl, ntl, nb, 3, 5, p=p, q=q)]
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(np.broadcast_to(g_.numpy(), w_.shape),
                                      w_)
    # one rank: the rank-stacked form is the local form
    assert torch.equal(masks.valid_mask(mtl, ntl, nb, m, n, p=1, q=1)[0, 0],
                       masks.valid_mask(mtl, ntl, nb, m, n))


def _now_run():
    """The entry points that once refused a p×q grid and now run on it
    (the least-squares, two-stage and Level-3 BLAS slice; the elementwise
    ops, the generator, the inverses, condition estimates, mixed solves,
    Aasen and ``gbtrs`` with a p×q B; the band factorizations and the
    band BLAS), each on 2×2 with the expected shape of its first output
    (() for a condition estimate, ``piv`` [kt, band block] for gbtrf)."""
    g = pgrid(2, 2)
    n = 16
    a, s = rand(n, n, seed=1), spd(n, seed=2)
    A = pst.Matrix.from_dense(a, nb=4, grid=g)
    H = pst.HermitianMatrix.from_dense(s, nb=4, grid=g)
    T = pst.TriangularMatrix.from_dense(np.tril(s), nb=4, grid=g)
    B = pst.Matrix.from_dense(rand(n, 2, seed=3), nb=4, grid=g)
    C = pst.Matrix.zeros(n, 2, 4, g, dtype=torch.float64)
    L, R, O = pst.Side.Left, pst.Side.Right, pst.Op.NoTrans
    from slate_tpu_torch.linalg import ge2tb as ge2tb_mod
    from slate_tpu_torch.linalg import he2hb as he2hb_mod

    def qr():
        return pst.geqrf(A)

    def lq():
        return pst.gelqf(A)

    def band():
        return pst.he2hb(H)

    def bidiag():
        return pst.ge2tb(A)

    Lf = pst.potrf(H)[0]
    N_ = pst.Norm.One

    def lu():
        return pst.getrf(A)[:2]

    def aasen():
        return pst.hetrf(H)[0]

    def band_lu():
        one = pst.Grid(1, 1, device="cpu")
        return pst.gbtrf(pst.BandMatrix.from_dense(
            np.triu(np.tril(a, 2), -2), nb=4, grid=one, kl=2, ku=2))[:2]

    BA = pst.BandMatrix.from_dense(np.triu(np.tril(a, 2), -2), nb=4, grid=g,
                                   kl=2, ku=2)
    HB = pst.HermitianBandMatrix.from_dense(np.tril(np.triu(s, -2)), nb=4,
                                            grid=g, kl=2, ku=2)
    TB = pst.TriangularBandMatrix.from_dense(np.tril(np.triu(s, -2)), nb=4,
                                             grid=g, kl=2, ku=0)

    return {
        "add": (lambda: pst.add(1.0, A, 1.0, A), (n, n)),
        "copy": (lambda: pst.copy(A, A), (n, n)),
        "scale": (lambda: pst.scale(1.0, 2.0, A), (n, n)),
        "scale_row_col": (lambda: pst.scale_row_col(
            np.ones(n), np.full(n, 2.0), A), (n, n)),
        "set_matrix": (lambda: pst.set_matrix(0.0, 1.0, A), (n, n)),
        "generate_matrix": (lambda: pst.generate_matrix("identity", 8,
                                                         grid=g), (8, 8)),
        "random_matrix": (lambda: pst.random_matrix(8, 8, 4, g), (8, 8)),
        "random_spd": (lambda: pst.random_spd(8, 4, g), (8, 8)),
        "trtri": (lambda: pst.trtri(T), (n, n)),
        "trtrm": (lambda: pst.trtrm(T), (n, n)),
        "potri": (lambda: pst.potri(T), (n, n)),
        "getri": (lambda: pst.getri(*lu()), (n, n)),
        "gecondest": (lambda: pst.gecondest(N_, *lu(), 1.0), ()),
        "pocondest": (lambda: pst.pocondest(N_, T, 1.0), ()),
        "trcondest": (lambda: pst.trcondest(N_, T), ()),
        "gesv_mixed": (lambda: pst.gesv_mixed(A, B), (n, 2)),
        "posv_mixed": (lambda: pst.posv_mixed(H, B), (n, 2)),
        "gesv_mixed_gmres": (lambda: pst.gesv_mixed_gmres(A, B), (n, 2)),
        "posv_mixed_gmres": (lambda: pst.posv_mixed_gmres(H, B), (n, 2)),
        "hetrf": (lambda: aasen()[::2], (n, n)),
        "hesv": (lambda: pst.hesv(H, B)[0], (n, 2)),
        "hetrs": (lambda: pst.hetrs(aasen(), B), (n, 2)),
        "gbtrs": (lambda: pst.gbtrs(*band_lu(), B), (n, 2)),
        "geqrf": (qr, (n, n)), "gelqf": (lq, (n, n)),
        "unmqr": (lambda: pst.unmqr(L, O, *qr(), B), (n, 2)),
        "unmlq": (lambda: pst.unmlq(L, O, *lq(), B), (n, 2)),
        "cholqr": (lambda: pst.cholqr(A), (n, n)),
        "gels": (lambda: pst.gels(A, B), (n, 2)),
        "least_squares_solve": (lambda: pst.least_squares_solve(A, B),
                                (n, 2)),
        "heev": (lambda: pst.heev(H), (n,)),
        "eig_vals": (lambda: pst.eig_vals(H), (n,)),
        "hegst": (lambda: pst.hegst(1, H, Lf), (n, n)),
        "hegv": (lambda: pst.hegv(1, H, H), (n,)),
        "gesvd": (lambda: pst.gesvd(A, None, True, True), (n,)),
        "svd_vals": (lambda: pst.svd_vals(A), (n,)),
        "he2hb": (band, (n, n)),
        "heev_two_stage": (lambda: he2hb_mod.heev_two_stage(H), (n,)),
        "unmtr_he2hb": (lambda: he2hb_mod.unmtr_he2hb(O, *band(), B),
                        (n, 2)),
        "ge2tb": (bidiag, (n, n)),
        "unmbr_ge2tb_u": (lambda: ge2tb_mod.unmbr_ge2tb_u(
            O, bidiag()[0], bidiag()[1], B), (n, 2)),
        "unmbr_ge2tb_v": (lambda: ge2tb_mod.unmbr_ge2tb_v(
            O, bidiag()[0], bidiag()[2], B), (n, 2)),
        "hemm": (lambda: pst.hemm(L, 1.0, H, B, 0.0, C), (n, 2)),
        "symm": (lambda: pst.symm(R, 1.0, H, A, 0.0, A), (n, n)),
        "her2k": (lambda: pst.her2k(1.0, A, A, 0.0, H), (n, n)),
        "syr2k": (lambda: pst.syr2k(1.0, A, A, 0.0, H), (n, n)),
        "trmm": (lambda: pst.trmm(L, 1.0, T, B), (n, 2)),
        "multiply_hermitian": (lambda: pst.multiply(1.0, H, B, 0.0, C),
                               (n, 2)),
        "gbtrf": (lambda: pst.gbtrf(BA)[1:], (2, 8)),
        "gbsv": (lambda: pst.gbsv(BA, B)[0], (n, 2)),
        "pbtrf": (lambda: (pst.pbtrf(HB)[0].to_dense(),), (n, n)),
        "pbsv": (lambda: pst.pbsv(HB, B)[0], (n, 2)),
        "pbtrs": (lambda: pst.pbtrs(pst.pbtrf(HB)[0], B), (n, 2)),
        "gbmm": (lambda: pst.gbmm(1.0, BA, B, 0.0, C), (n, 2)),
        "hbmm": (lambda: pst.hbmm(L, 1.0, HB, B, 0.0, C), (n, 2)),
        "tbsm": (lambda: pst.tbsm(L, 1.0, TB, B), (n, 2)),
    }


NOW_RUN = sorted(_now_run())


@pytest.mark.parametrize("name", NOW_RUN)
def test_entry_points_of_the_slice_run_pq(name):
    """Each entry point ported to p×q grids runs on 2×2 and gives finite
    outputs, its first of the expected shape and on the grid."""
    fn, shape = _now_run()[name]
    out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    first = outs[0]
    if isinstance(first, float):                     # a condition estimate
        first = torch.tensor(first)
    assert tuple(first.shape) == shape
    for x in outs:
        if x is None:
            continue
        if hasattr(x, "grid"):
            assert x.grid == pgrid(2, 2)
            x = x.to_dense()
        assert bool(torch.isfinite(torch.as_tensor(x)).all()), name


def test_the_two_lists_cover_every_former_refusal():
    """The 56 entry points that once refused a p×q grid all run on it:
    the 8 band entry points of the last slice among them."""
    assert len(NOW_RUN) == 56
    assert {"gbtrf", "gbsv", "pbtrf", "pbtrs", "pbsv", "gbmm", "hbmm",
            "tbsm"} <= set(NOW_RUN)
