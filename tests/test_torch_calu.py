"""The port's CALU pieces and donated dense entries against the JAX package
on the CPU: ``plu_panel``'s tournament above ``H_MAX`` (shrunk in both
packages, as tests/test_getrf.py:481-540 does), ``_panel_lu_tournament``
with ``max_rows``, the fast path's column-chunked compaction, the tall
panels of ``getrf_dense_inplace`` and ``potrf_dense_inplace``. The kernels
run their plain versions; the JAX package's run in interpret mode. Each
JAX reference is computed once per module.

Tolerances: pivots, masks and ``info`` equal; factored values within atol
1e-4 in float32 (the JAX kernel updates in strips, the port column by
column: the bound of tests/test_torch_panel_plu.py) and 1e-12 in float64;
a tournament's factor L·U = P·A within 1e-5·n·‖A‖ (CALU's |L| may exceed
1, tests/test_getrf.py:225). Two legs of the port's own code that do the
same arithmetic (chunked and one-shot compaction, group sizes) are equal
bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.internal import panel_plu as jpp  # noqa: E402
from slate_tpu.internal import tile_kernels as jtk  # noqa: E402
from slate_tpu.linalg import getrf as jgetrf  # noqa: E402
from slate_tpu_torch.internal import panel_plu as ppp  # noqa: E402
from slate_tpu_torch.internal import tile_kernels as ptk  # noqa: E402
from slate_tpu_torch.linalg import getrf as pgetrf  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
ATOL = 1e-4
# (H_MAX, h, kind): two chunks, the second padded in the last case
PANELS = [(256, 512, "zero_column"), (384, 600, "random")]


def tall_panel(h, kind, seed):
    rng = np.random.default_rng(seed)
    sub = rng.standard_normal((h, ppp.W)).astype(np.float32)
    act = np.ones(h, np.float32)
    act[rng.choice(h, h // 6, replace=False)] = 0.0
    if kind == "zero_column":
        sub[:, 5] = 0.0
    return sub, act


@pytest.fixture(scope="module")
def jax_panels():
    out = {}
    mp = pytest.MonkeyPatch()
    for hmax, h, kind in PANELS:
        mp.setattr(jpp, "H_MAX", hmax)
        sub, act = tall_panel(h, kind, h)
        r = jpp.plu_panel(jnp.asarray(sub), jnp.asarray(act), interpret=True)
        out[(hmax, h, kind)] = [np.asarray(x) for x in r]
    mp.undo()
    return out


@pytest.mark.parametrize("hmax,h,kind", PANELS)
def test_plu_panel_tournament_matches_jax(jax_panels, monkeypatch, hmax, h,
                                          kind):
    monkeypatch.setattr(ppp, "H_MAX", hmax)
    sub, act = tall_panel(h, kind, h)
    jout, jpiv, jact, jinfo = jax_panels[(hmax, h, kind)]
    out, piv, act_new, info = ppp.plu_panel(torch.from_numpy(sub),
                                            torch.from_numpy(act))
    assert np.array_equal(piv.numpy(), jpiv)
    assert np.array_equal(act_new.numpy(), jact)
    assert int(info) == int(jinfo) == (1 if kind == "zero_column" else 0)
    assert np.abs(out.numpy() - jout).max() < ATOL
    out = out.numpy()
    assert len(np.unique(piv.numpy())) == ppp.W
    lu_rows = out[piv.numpy()]
    u11 = np.triu(lu_rows)
    rows = act_new.numpy() > 0
    if kind == "zero_column":
        # a zero pivot: its column of multipliers is zero (ADVICE r3)
        zcol = np.where(np.diag(u11) == 0.0)[0]
        assert zcol.size == 1 and np.all(out[rows][:, zcol] == 0.0)
    else:
        # every still-active row holds multipliers: out[r]·U11 = A[r]
        err = np.linalg.norm(out[rows] @ u11 - sub[rows])
        assert err < 1e-5 * ppp.W * np.linalg.norm(sub[rows])
    inactive = act == 0
    assert np.array_equal(out[inactive], sub[inactive])


TOURNAMENTS = [(24, 0, 96), (40, 0, 96), (24, 16, 90), (40, 8, 96)]


@pytest.fixture(scope="module")
def jax_tournaments():
    a = rand(96, 8, np.float64, 3)
    return a, {t: [np.asarray(x) for x in
                   jtk._panel_lu_tournament(jnp.asarray(a), t[1], t[2], t[0])]
               for t in TOURNAMENTS}


@pytest.mark.parametrize("case", TOURNAMENTS)
def test_panel_lu_tournament_matches_jax(jax_tournaments, case):
    max_rows, start, m = case
    a, refs = jax_tournaments
    jout, jpiv, jinfo = refs[case]
    out, piv, info = ptk.panel_lu_factor(torch.from_numpy(a), start, m,
                                         max_rows=max_rows)
    assert piv.dtype == torch.int32 and np.array_equal(piv.numpy(), jpiv)
    assert int(info) == int(jinfo) == 0
    assert np.abs(out.numpy() - jout).max() < 1e-12
    # the rows outside the window are as they were; the window is P·A = L·U
    out, nb = out.numpy(), a.shape[1]
    assert np.array_equal(out[:start], a[:start])
    assert np.array_equal(out[m:], a[m:])
    win = a[start:m].copy()
    for j, p in enumerate(piv.numpy() - start):
        win[[j, p]] = win[[p, j]]
    lw = np.tril(out[start:m], -1)[:, :nb] + np.eye(m - start, nb)
    err = np.linalg.norm(win - lw @ np.triu(out[start:start + nb]))
    assert err < 1e-12 * np.linalg.norm(win)
    # without max_rows (or above the panel's height) no tournament runs
    same = ptk.panel_lu_factor(torch.from_numpy(a), start, m, max_rows=96)
    plain = ptk.panel_lu_factor(torch.from_numpy(a), start, m)
    assert all(torch.equal(x, y) for x, y in zip(same, plain))


def test_fast_path_compaction_chunked(monkeypatch):
    """The column-chunked in-place compaction (the n > _COMPACT_TAKE_MAX_N
    leg) gives the one-shot gather's factorization bit for bit
    (tests/test_getrf.py:412)."""
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    n, nb = 1024, 256
    A = pst.Matrix.from_dense(rand(n, n, np.float32, 36), nb=nb, grid=CPU)
    LU0, piv0, info0 = pst.getrf(A)
    monkeypatch.setattr(pgetrf, "_COMPACT_TAKE_MAX_N", 0)
    monkeypatch.setattr(pgetrf, "_COMPACT_CB", 256)
    LU1, piv1, info1 = pst.getrf(A)
    assert torch.equal(piv0, piv1) and int(info0) == int(info1) == 0
    assert torch.equal(LU0.data, LU1.data)


@pytest.fixture(scope="module")
def jax_dense_lu():
    """The JAX getrf_dense_inplace at n = 512, nb = 128 with H_MAX = 256:
    every subpanel of its one group is 512 rows, a two-chunk tournament
    (its donated group programs run in interpret mode, as
    tests/test_getrf.py:541 runs them)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpp, "H_MAX", 256)
    mp.setattr(jgetrf, "_getrf_fast_group_jit",
               lambda a, c, i, g0, gsz, nb, interpret, fold=True, tier=None:
               jgetrf._getrf_fast_group_core(a, c, i, g0, gsz, nb, True,
                                             fold, tier))
    a = rand(512, 512, np.float32, 51)
    lu, piv, info = jst.getrf_dense_inplace(jnp.asarray(a), nb=128)
    out = (a, np.asarray(lu), np.asarray(piv), int(info))
    mp.undo()
    return out


def lu_error(a, lu, piv):
    n = a.shape[0]
    perm = np.arange(n)
    for j, p in enumerate(np.asarray(piv).reshape(-1)):
        perm[[j, p]] = perm[[p, j]]
    l = np.tril(lu, -1) + np.eye(n)
    return (np.linalg.norm(a[perm] - l @ np.triu(lu))
            / (n * np.linalg.norm(a)))


def test_getrf_dense_inplace_matches_jax(jax_dense_lu, monkeypatch):
    """Pivots and factor equal to the JAX package's while every chunk of a
    subpanel still holds W active rows (panels 0 and 1 here); after that
    the JAX tournament lets a chunk's inactive rows back into its final
    round and its factor is wrong (‖P·A − L·U‖/(n‖A‖) ≈ 0.03, ROADMAP §C),
    where the port's stays within 1e-5."""
    monkeypatch.setattr(ppp, "H_MAX", 256)
    a, jlu, jpiv, jinfo = jax_dense_lu
    t = torch.from_numpy(a.copy())
    ptr = t.data_ptr()
    lu, piv, info = pst.getrf_dense_inplace(t, nb=128)
    assert lu.data_ptr() == ptr and lu is t             # in place
    assert piv.shape == (4, 128) and piv.dtype == torch.int32
    assert int(info) == jinfo == 0
    assert np.array_equal(piv.numpy()[:2], jpiv[:2])
    assert np.abs(lu.numpy()[:256] - jlu[:256]).max() < ATOL * np.abs(
        jlu).max()
    assert lu_error(a, jlu, jpiv) > 1e-3
    assert lu_error(a, lu.numpy(), piv) < 1e-5


def test_getrf_dense_inplace_tall_and_flat_groups(monkeypatch):
    """n = 512, nb = 128, H_MAX = 256, groups of two panels: the first
    group's subpanels (512 rows) take the tournament, the second group's
    (256 rows) one kernel call each; the tiled fast path, on the same
    code, gives the same bits, and so does getrf_tntpiv."""
    monkeypatch.setattr(ppp, "H_MAX", 256)
    monkeypatch.setattr(pgetrf, "_FAST_GROUP", 2)
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    n, nb = 512, 128
    a = rand(n, n, np.float32, 52)
    lu, piv, info = pst.getrf_dense_inplace(torch.from_numpy(a.copy()), nb=nb)
    assert int(info) == 0 and lu_error(a, lu.numpy(), piv) < 1e-5
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    LU, piv2, info2 = pst.getrf(A)
    assert torch.equal(LU.to_dense(), lu) and torch.equal(piv2, piv)
    LU3, piv3, _ = pst.getrf_tntpiv(A)
    assert torch.equal(LU3.data, LU.data) and torch.equal(piv3, piv)
    # a singular column: info counts it, as the tiled path does
    a[:, 300] = 0.0
    _, _, info = pst.getrf_dense_inplace(torch.from_numpy(a), nb=nb)
    assert int(info) == int(pst.getrf(pst.Matrix.from_dense(
        a, nb=nb, grid=CPU))[2]) == 1


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_potrf_dense_inplace_matches_jax(dt):
    n, nb = 192, 32
    a = spd(n, dt, 61) + 2 * np.eye(n, dtype=dt)
    L, info = jst.potrf_dense_inplace(jnp.asarray(a), nb=nb)
    jl = np.tril(np.asarray(L))
    t = torch.from_numpy(a.copy())
    out, pinfo = pst.potrf_dense_inplace(t, nb=nb)
    assert out is t and int(pinfo) == int(info) == 0
    pl = np.tril(out.numpy())
    assert np.abs(pl - jl).max() < (ATOL if dt == np.float32 else 1e-12)
    assert np.linalg.norm(pl @ pl.T - a) / np.linalg.norm(a) < (
        1e-5 if dt == np.float32 else 1e-13)
    # group is kept for the JAX signature and has no effect: the same bits
    for group in (1, 5):
        g, _ = pst.potrf_dense_inplace(torch.from_numpy(a.copy()), nb=nb,
                                       group=group)
        assert torch.equal(g.tril(), out.tril())
    # a matrix that is not positive definite at block column 3
    bad = a.copy()
    bad[70, 70] = -1.0
    _, jinfo = jst.potrf_dense_inplace(jnp.asarray(bad), nb=nb)
    _, pinfo = pst.potrf_dense_inplace(torch.from_numpy(bad), nb=nb)
    assert int(pinfo) == int(jinfo) == 3


def test_dense_inplace_contracts():
    with pytest.raises(pst.SlateError, match="square"):
        pst.getrf_dense_inplace(torch.zeros(256, 128))
    with pytest.raises(pst.SlateError, match="float32"):
        pst.getrf_dense_inplace(torch.zeros(256, 256, dtype=torch.float64),
                                nb=128)
    with pytest.raises(pst.SlateError, match="float32"):
        pst.getrf_dense_inplace(torch.zeros(256, 512)[:, :256],
                                nb=128)
    with pytest.raises(pst.SlateError, match="multiple of nb"):
        pst.getrf_dense_inplace(torch.zeros(384, 384), nb=256)
    with pytest.raises(pst.SlateError, match="multiple of 128"):
        pst.getrf_dense_inplace(torch.zeros(192, 192), nb=64)
    with pytest.raises(pst.SlateError, match="multiple of nb"):
        pst.potrf_dense_inplace(torch.eye(100), nb=32)
    with pytest.raises(pst.SlateError, match="square"):
        pst.potrf_dense_inplace(np.eye(64), nb=32)
