"""The port's QR/LQ and least squares on p×q grids of virtual ranks
against the JAX package's SPMD programs on meshes of virtual CPU
devices: geqrf, unmqr on both sides with every ``trans``, gelqf/unmlq,
cholqr and the three gels branches.

The same numpy inputs go into both packages: A 130×70 with nb = 16
(9×5 tiles, both edges ragged), in float64 on 2×4 and in complex128 on
2×2. Tolerances: the factors (R and V) within 1e-10·‖A‖ and T within
1e-10 of the JAX package's, the applied Q within 1e-10·‖C‖, and the
least-squares X within 1e-10 relative; both packages factor the same
gathered panels by LAPACK's geqrf and sum the trailing products in other
orders, so they agree to a few hundred ulps, and 1e-10 leaves room for
the conditioning of the solves. ``Option.PipelineDepth`` 1 gives the
bits of depth 0, and Grid(1, 1) keeps its one-rank path bit for bit.
Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.linalg import geqrf as pqr  # noqa: E402
from slate_tpu_torch.types import MethodGels, Option  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

M, N, NB, NRHS = 130, 70, 16, 3
CASES = [((2, 4), np.float64), ((2, 2), np.complex128)]
IDS = ["2x4-f64", "2x2-c128"]
SIDES = ("Left", "Right")


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def inputs(dt):
    """A [M, N], B [M, NRHS], the wide A [N, M] and its B [N, NRHS], and
    the right-side operand C [NRHS, M]."""
    return dict(a=rand(M, N, dt, seed=1), b=rand(M, NRHS, dt, seed=2),
                aw=rand(N, M, dt, seed=3), bw=rand(N, NRHS, dt, seed=4),
                cr=rand(NRHS, M, dt, seed=5))


def dense(X):
    return np.asarray(X.to_dense())


def trans_ops(dt, pkg):
    ops = ["NoTrans", "ConjTrans"]
    if not np.issubdtype(dt, np.complexfloating):
        ops.append("Trans")
    return [(t, getattr(pkg.Op, t)) for t in ops]


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (p, q), dt in CASES:
        x = inputs(dt)
        g = jgrid(p, q)
        mk = lambda a: jst.Matrix.from_dense(a, nb=NB, grid=g)  # noqa: E731
        QR, T = jst.geqrf(mk(x["a"]))
        r = {"QR": dense(QR), "T": np.asarray(T)}
        for side in SIDES:
            C = x["b"] if side == "Left" else x["cr"]
            for t, op in trans_ops(dt, jst):
                r[side, t] = dense(jst.unmqr(getattr(jst.Side, side), op, QR,
                                             T, mk(C)))
        LQ, TL = jst.gelqf(mk(x["aw"]))
        r["LQ"], r["TL"] = dense(LQ), np.asarray(TL)
        for t in ("NoTrans", "ConjTrans"):
            r["unmlq", t] = dense(jst.unmlq(jst.Side.Left,
                                            getattr(jst.Op, t), LQ, TL,
                                            mk(x["b"])))
        Q, R, info = jst.cholqr(mk(x["a"]))
        r["cholqr"] = (dense(Q), dense(R), int(info))
        for route in ("Geqrf", "Cholqr"):
            r["gels", route] = dense(jst.gels(
                mk(x["a"]), mk(x["b"]),
                {jst.Option.MethodGels: getattr(jst.MethodGels, route)}))
        r["gels", "LQ"] = dense(jst.gels(mk(x["aw"]), mk(x["bw"])))
        out[(p, q)] = r
    return out


def close(x, ref, scale, tol=1e-10):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    err = np.abs(x - ref).max()
    assert err <= tol * scale, (err, tol * scale)


def port(a, p, q):
    return pst.Matrix.from_dense(a, nb=NB, grid=pgrid(p, q))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_geqrf_pq_matches_jax_and_depth_bitwise(jax_ref, case):
    (p, q), dt = case
    x = inputs(dt)
    ref = jax_ref[(p, q)]
    QR, T = pst.geqrf(port(x["a"], p, q))
    assert QR.data.shape == (p, q, -(-9 // p), -(-5 // q), NB, NB)
    assert tuple(T.shape) == ref["T"].shape == (5, NB, NB)
    na = np.abs(x["a"]).max()
    close(QR.to_dense().numpy(), ref["QR"], na)
    close(T.numpy(), ref["T"], 1.0)
    # the factorization itself: Q·R = A
    r = np.triu(QR.to_dense().numpy())
    qr_ = pst.unmqr(pst.Side.Left, pst.Op.NoTrans, QR, T, port(r, p, q))
    close(qr_.to_dense().numpy(), x["a"], na)
    for depth in (1, 2):
        QRd, Td = pst.geqrf(port(x["a"], p, q),
                            {Option.PipelineDepth: depth})
        assert torch.equal(QRd.data, QR.data) and torch.equal(Td, T)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("side", SIDES)
def test_unmqr_pq_both_sides_every_trans(jax_ref, case, side):
    (p, q), dt = case
    x = inputs(dt)
    ref = jax_ref[(p, q)]
    QR, T = pst.geqrf(port(x["a"], p, q))
    C = x["b"] if side == "Left" else x["cr"]
    for t, op in trans_ops(dt, pst):
        got = pst.unmqr(getattr(pst.Side, side), op, QR, T, port(C, p, q))
        close(got.to_dense().numpy(), ref[side, t], np.abs(C).max())
    if np.issubdtype(dt, np.complexfloating):
        with pytest.raises(pst.SlateError, match="ConjTrans"):
            pst.unmqr(getattr(pst.Side, side), pst.Op.Trans, QR, T,
                      port(C, p, q))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gelqf_unmlq_pq_match_jax(jax_ref, case):
    (p, q), dt = case
    x = inputs(dt)
    ref = jax_ref[(p, q)]
    LQ, TL = pst.gelqf(port(x["aw"], p, q))
    close(LQ.to_dense().numpy(), ref["LQ"], np.abs(x["aw"]).max())
    close(TL.numpy(), ref["TL"], 1.0)
    for t in ("NoTrans", "ConjTrans"):
        got = pst.unmlq(pst.Side.Left, getattr(pst.Op, t), LQ, TL,
                        port(x["b"], p, q))
        close(got.to_dense().numpy(), ref["unmlq", t], np.abs(x["b"]).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cholqr_pq_matches_jax(jax_ref, case):
    (p, q), dt = case
    x = inputs(dt)
    jq, jr, jinfo = jax_ref[(p, q)]["cholqr"]
    Q, R, info = pst.cholqr(port(x["a"], p, q))
    assert int(info) == jinfo == 0
    assert R.uplo == pst.Uplo.Upper and R.grid == pgrid(p, q)
    close(Q.to_dense().numpy(), jq, 1.0)
    close(np.triu(R.to_dense().numpy()), np.triu(jr), np.abs(x["a"]).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("route", ["Geqrf", "Cholqr", "LQ"])
def test_gels_pq_three_branches(jax_ref, case, route):
    (p, q), dt = case
    x = inputs(dt)
    if route == "LQ":
        a, b, opts = x["aw"], x["bw"], None
    else:
        a, b = x["a"], x["b"]
        opts = {Option.MethodGels: getattr(MethodGels, route)}
    X = pst.gels(port(a, p, q), port(b, p, q), opts)
    assert X.grid == pgrid(p, q) and X.shape == (a.shape[1], NRHS)
    want = jax_ref[(p, q)]["gels", route]
    close(X.to_dense().numpy(), want, np.abs(want).max())
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    close(X.to_dense().numpy(), ref, np.abs(ref).max())
    if route == "Geqrf":
        Y = pst.least_squares_solve(port(a, p, q), port(b, p, q), opts)
        assert torch.equal(Y.data, X.data)


def test_pad_rows_rounds_to_the_grid():
    """The LQ branch's zero rows: tile rows a multiple of p, the storage
    the block-cyclic layout of the padded matrix."""
    y = rand(20, NRHS, seed=6)
    Y = pqr._pad_rows(port(y, 4, 1), 70)
    full = np.zeros((70, NRHS))
    full[:20] = y
    want = pst.Matrix.from_dense(full, nb=NB, grid=pgrid(4, 1))
    assert torch.equal(Y.data, want.data) and Y.shape == (70, NRHS)


def test_one_rank_keeps_its_path():
    """Grid(1, 1) still runs the one-rank factorization, bit for bit."""
    a = rand(M, N, seed=1)
    A = pst.Matrix.from_dense(a, nb=NB, grid=pgrid(1, 1))
    QR, T = pst.geqrf(A)
    data, T1 = pqr._geqrf_dense_1dev(A, "bf16_6x")
    assert torch.equal(QR.data, data) and torch.equal(T, T1)
