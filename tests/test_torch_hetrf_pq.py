"""The port's Aasen solve (``hetrf`` → ``hetrs`` → ``hesv``), its
cross-rank column swap and ``gbtrs`` with a p×q right-hand side on p×q
grids of virtual ranks against the JAX package's SPMD programs on meshes
of virtual CPU devices.

The same numpy inputs go into both packages: a Hermitian indefinite
A with n = 70 and nb = 8 (9 tiles, both edges ragged), float64 on 2×4,
1×4 and 4×1 and complex128 on 2×2. Held: the panel pivots, T's band-LU
pivots and ``info`` equal; L (built on the grid, its tile columns
shifted across the ranks), T's blocks Td/Ts and the band factor within
1e-10 relative to the JAX package's (one algorithm, the products summed
in other orders); X of ``hesv``/``hetrs`` within 1e-10 relative; a
singular A's ``info`` equal. ``_swap_cols_local`` alone equals the JAX
package's bit for bit (it moves values). ``gbtrs`` with a p×q B equals
the Grid(1, 1) solve bit for bit and the JAX package's within 1e-10.
At nb = 128 the p×q panels go to the physical-swap kernel's plain
version (K10), held to the port's one-rank hesv (the one-rank path is
held to the JAX Pallas panel in ``tests/test_torch_hetrf.py``).

Complex ``hesv``'s backward error (ROADMAP §C): at n = 512, nb = 64 the
port's complex64 and complex128 solves read within 1.25× of the JAX
package's on the same inputs, so the error of order n·u of a complex
Aasen solve is the algorithm's, not the port's. Each JAX reference is
computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import slate_tpu as jst  # noqa: E402
from slate_tpu.grid import AXIS_P, AXIS_Q  # noqa: E402
from slate_tpu.linalg import getrf as jgetrf  # noqa: E402
from slate_tpu.linalg import hetrf as jhetrf  # noqa: E402
from slate_tpu.ops import blas as jblas  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.linalg import getrf as pgetrf  # noqa: E402
from slate_tpu_torch.linalg import hetrf as phetrf  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

N, NB, NRHS = 70, 8, 3
CASES = [((2, 4), np.float64), ((2, 2), np.complex128), ((1, 4), np.float64),
         ((4, 1), np.float64)]
IDS = ["2x4-f64", "2x2-c128", "1x4-f64", "4x1-f64"]


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def herm(n, dt, seed, singular=False):
    a = rand(n, n, dt, seed)
    a = (a + a.conj().T) / 2
    if singular:
        a[:, 5] = 0.0
        a[5, :] = 0.0
    return a.astype(dt)


def rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def residual(a, x, b):
    a, x, b = (np.asarray(v, np.complex128) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))


def factor(pkg, grid, dt, singular=False, nb=NB, n=N):
    """hesv of one Hermitian A and a second solve by hetrs: dense
    outputs and the stage-1 blocks Td, Ts."""
    a = herm(n, dt, 21, singular)
    b, b2 = rand(n, NRHS, dt, 22), rand(n, NRHS, dt, 23)
    mk = lambda x, cls="Matrix": getattr(pkg, cls).from_dense(  # noqa
        x, nb=nb, grid=grid)
    A = mk(np.tril(a), "HermitianMatrix")
    X, (L, FT, piv), info = pkg.hesv(A, mk(b))
    out = dict(x=np.asarray(X.to_dense()), L=np.asarray(L.to_dense()),
               piv=np.asarray(piv), info=int(info),
               Tpiv=np.asarray(FT.piv), Tab=np.asarray(FT.ab),
               x2=np.asarray(pkg.hetrs((L, FT, piv), mk(b2)).to_dense()))
    if pkg is jst:
        Af = jblas._mirror_full(A, conj=np.iscomplexobj(a))
        _, Td, Ts, _, _ = jhetrf._hetrf_aasen_jit(Af)
    else:
        _, Td, Ts, _, _ = phetrf._stage1(A)
    out["Td"], out["Ts"] = np.asarray(Td), np.asarray(Ts)
    out["grid"] = L.grid
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return {(p, q): factor(jst, jgrid(p, q), dt) for (p, q), dt in CASES}


@pytest.fixture(scope="module")
def port():
    return {(p, q): factor(pst, pgrid(p, q), dt) for (p, q), dt in CASES}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hetrf_pq_matches_jax(jax_ref, port, case):
    (p, q), dt = case
    got, want = port[p, q], jax_ref[p, q]
    assert got["grid"] == pgrid(p, q)
    assert got["info"] == want["info"] == 0
    assert np.array_equal(got["piv"], want["piv"])
    assert np.array_equal(got["Tpiv"], want["Tpiv"])
    for key in ("L", "Td", "Ts", "Tab"):
        assert got[key].dtype == want[key].dtype, key
        assert rel(got[key], want[key]) < 1e-10, key
    ld = got["L"]
    assert np.allclose(np.diag(ld), 1.0) and not np.triu(ld, 1).any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hesv_hetrs_pq_match_jax(jax_ref, port, case):
    (p, q), dt = case
    got, want = port[p, q], jax_ref[p, q]
    a = herm(N, dt, 21)
    for key, b in (("x", rand(N, NRHS, dt, 22)), ("x2", rand(N, NRHS, dt,
                                                             23))):
        assert rel(got[key], want[key]) < 1e-10, key
        assert residual(a, got[key], b) < 1e-13, key


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_hetrf_pq_singular_info(case):
    (p, q), dt = case
    got = factor(pst, pgrid(p, q), dt, singular=True)
    want = factor(jst, jgrid(p, q), dt, singular=True)
    assert got["info"] == want["info"] >= 1
    assert np.array_equal(got["piv"], want["piv"])


@pytest.mark.parametrize("p,q", [(2, 4), (2, 2)])
def test_swap_cols_local_matches_jax(p, q):
    """One panel's column swaps, some rows crossing ranks, restricted to
    the tile columns from min_col, bit for bit against the JAX body."""
    a = rand(N, N, np.float64, 31)
    start, min_col = 2 * NB, 3
    pivs = [start + 3, 47, start + 2, 69, 40, start + 5, 62, start + 7]
    J = jst.Matrix.from_dense(a, nb=NB, grid=jgrid(p, q))

    def body(x, pv):
        return jgetrf._swap_cols_local(x[0, 0], pv, start, NB, p, q,
                                       min_col=min_col)[None, None]

    want = jax.jit(jax.shard_map(
        body, mesh=J.grid.mesh, in_specs=(P(AXIS_P, AXIS_Q), P()),
        out_specs=P(AXIS_P, AXIS_Q), check_vma=False))(
            J.data, jax.numpy.asarray(pivs, jax.numpy.int32))
    d = pst.Matrix.from_dense(a, nb=NB, grid=pgrid(p, q)).data.clone()
    pgetrf._swap_cols_local(d, pivs, start, min_col=min_col)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_gbtrs_pq_right_hand_side(case):
    """A band factor (replicated) solves a p×q B: gathered, solved and
    scattered back, equal to the Grid(1, 1) solve bit for bit and to the
    JAX package's gbtrs on its mesh, for each op."""
    (p, q), dt = case
    kl, ku = 3, 2
    a = np.triu(np.tril(rand(N, N, dt, 41) + 4 * np.eye(N), ku), -kl)
    b = rand(N, NRHS, dt, 42)
    ops = ["NoTrans", "ConjTrans"] + (["Trans"] if dt == np.float64 else [])
    LU, piv, _ = pst.gbtrf(pst.BandMatrix.from_dense(a, nb=NB,
                                                     grid=pgrid(1, 1),
                                                     kl=kl, ku=ku))
    JLU, jpiv, _ = jst.gbtrf(jst.BandMatrix.from_dense(a, nb=NB,
                                                       grid=jgrid(p, q),
                                                       kl=kl, ku=ku))
    for op in ops:
        X = pst.gbtrs(LU, piv, pst.Matrix.from_dense(b, nb=NB,
                                                     grid=pgrid(p, q)),
                      pst.Op[op])
        one = pst.gbtrs(LU, piv, pst.Matrix.from_dense(b, nb=NB,
                                                       grid=pgrid(1, 1)),
                        pst.Op[op])
        JX = jst.gbtrs(JLU, jpiv, jst.Matrix.from_dense(b, nb=NB,
                                                        grid=jgrid(p, q)),
                       jst.Op[op])
        assert X.grid == pgrid(p, q)
        assert torch.equal(X.to_dense(), one.to_dense()), op
        assert rel(X.to_dense().numpy(), np.asarray(JX.to_dense())) < 1e-10
        opa = {"NoTrans": a, "Trans": a.T, "ConjTrans": a.conj().T}[op]
        assert residual(opa, X.to_dense().numpy(), b) < 1e-13, op


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_hesv_pq_panel_kernel_plain(dt):
    """nb = 128 on 2×2 (n = 300, ragged): the panels go to K10's plain
    version, as on the one-rank path; pivots and info equal the one-rank
    hesv's, L and X close to it."""
    n, nb = 300, 128
    got = factor(pst, pgrid(2, 2), dt, nb=nb, n=n)
    one = factor(pst, pgrid(1, 1), dt, nb=nb, n=n)
    tol = 1e-10 if dt == np.float64 else 1e-4
    assert got["info"] == one["info"] == 0
    assert np.array_equal(got["piv"], one["piv"])
    assert np.array_equal(got["Tpiv"], one["Tpiv"])
    assert rel(got["L"], one["L"]) < tol and rel(got["x"], one["x"]) < tol


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
def test_complex_hesv_backward_error_is_jax(dt):
    """ROADMAP §C's complex hesv: the port's backward error within 1.25×
    of the JAX package's on the same inputs (both read a few hundred u
    here: Aasen's, not the port's)."""
    n, nb = 512, 64
    a = herm(n, dt, 51)
    b = rand(n, 8, dt, 52)
    errs = []
    for pkg, g in ((pst, pgrid(1, 1)), (jst, jgrid(1, 1))):
        X = pkg.hesv(pkg.HermitianMatrix.from_dense(np.tril(a), nb=nb,
                                                    grid=g),
                     pkg.Matrix.from_dense(b, nb=nb, grid=g))[0]
        errs.append(residual(a, np.asarray(X.to_dense()), b))
    u = np.finfo(dt).eps / 2
    assert errs[0] <= 1.25 * errs[1] and errs[0] <= 10 * n * u, errs
