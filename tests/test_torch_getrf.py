"""The port's LU slice (getrf / getrs / gesv, the pivoting-by-index fast
path and the dense path) against the JAX package on a 1×1 grid, on the
CPU.

Inputs are made with numpy and go into both packages. The fast path is
forced with SLATE_LU_FAST=1 on both sides (the JAX package then runs its
Pallas kernels in interpret mode, the port its kernels' plain versions).
Each JAX reference is computed once per module.

Tolerances: ipiv and ``info`` must be equal. In f32 the two packages
round differently (the JAX panel kernel updates in IB=8 strips, the
port's eagerly; the trailing products sum in other orders), and either
factor's distance from the exact one grows like n·ε·max|U|: 1.2e-3 at
n=384 and 1e-2 at n=1536 for the JAX package itself. So the port's LU is
held to within 1.5× the JAX package's own max-norm distance from the
f64 LU of P·A with the same pivots, and to the backward error
‖P·A − L·U‖ / (n·‖A‖) ≤ 1e-5 of tests/test_getrf.py. In f64 the LU is
within atol 1e-10. X is held to the normwise backward error
‖A·X − B‖ / (‖A‖·‖X‖) ≤ 10·n·2⁻²⁴ and to a forward error from the f64
solve within 3× the JAX package's own: κ of a Gaussian matrix at
n ≤ 2048 reaches 1e4 and amplifies each side's rounding differently
(ratios up to 2.4 seen), so in f32 neither side is within 1e-4 of the
other. In f64 X is within 1e-12 of the JAX solve.
"""

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import getrf as jgetrf  # noqa: E402
from slate_tpu_torch.linalg import getrf as pgetrf  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
# (n, nb, zero column): flat branch at 384/128; the folded branch at
# 2048/1024 (hw = 2048 and 1024); two groups of flat panels at 1536/256;
# the flat branch's per-panel form (one transpose a panel, K4 on its two
# 128-row blocks in place) at 768/256 and 1280/256, every window ≢ 0 mod
# 1024 (768; 1280 and 256)
FAST = [(384, 128, None), (2048, 1024, None), (1536, 256, None),
        (384, 128, 200), (768, 256, None), (1280, 256, None)]


def fast_inputs(n, nb, zero_col):
    a = rand(n, n, np.float32, seed=n + nb)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    return a, rand(n, 3, np.float32, seed=n)


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def perm_of(piv, n):
    """Row permutation of a LAPACK ipiv (padded slots self-swap)."""
    piv = np.asarray(piv).reshape(-1)
    p = np.arange(max(n, piv.size))
    for j, v in enumerate(piv):
        p[j], p[v] = p[v], p[j]
    return p[:n]


def exact_lu(a, piv):
    """The f64 LU of P·A for the given pivots (checks that f64 partial
    pivoting keeps them)."""
    lu, p64 = sla.lu_factor(a[perm_of(piv, a.shape[0])].astype(np.float64))
    assert np.array_equal(p64, np.arange(a.shape[0]))
    return lu


def check_lu(lu, ref_lu, exact, a, piv):
    """``lu`` as close to the exact factors as ``ref_lu`` is (within
    1.5×), with the backward error and growth of partial pivoting."""
    n = a.shape[0]
    assert np.abs(lu - exact).max() <= 1.5 * np.abs(ref_lu - exact).max() \
        + 1e-6
    l = np.tril(lu, -1) + np.eye(n)
    err = np.linalg.norm(a[perm_of(piv, n)] - l @ np.triu(lu)) \
        / (n * np.linalg.norm(a))
    assert err < 1e-5 and np.abs(l).max() <= 1.0 + 1e-5


def check_x(x, ref_x, a, b, trans=False):
    """``x`` within 3× ``ref_x``'s distance from the f64 solve of
    op(A)·X = B, with a backward-stable residual."""
    op = a.T if trans else a
    exact = np.linalg.solve(op.astype(np.float64), b.astype(np.float64))
    assert rel(x, exact) <= 3 * rel(ref_x, exact) + 1e-7
    n = a.shape[0]
    r = np.linalg.norm(op.astype(np.float64) @ x - b) \
        / (np.linalg.norm(a) * np.linalg.norm(x))
    assert r <= 10 * n * 2.0 ** -24


@pytest.fixture(scope="module")
def jax_gesv(grid11):
    """JAX gesv on the fast path for every case of FAST."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLATE_LU_FAST", "1")
        for case in FAST:
            a, b = fast_inputs(*case)
            nb = case[1]
            X, LU, piv, info = jst.gesv(
                jst.Matrix.from_dense(a, nb=nb, grid=grid11),
                jst.Matrix.from_dense(b, nb=nb, grid=grid11))
            out[case] = (np.asarray(X.to_dense()), np.asarray(LU.to_dense()),
                         np.asarray(piv), int(info), LU, piv,
                         exact_lu(a, np.asarray(piv)))
    return out


@pytest.mark.parametrize("case", FAST, ids=lambda c: "-".join(map(str, c)))
def test_fast_path_matches_jax(jax_gesv, monkeypatch, case):
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    a, b = fast_inputs(*case)
    n, nb, zero_col = case
    jx, jlu, jpiv, jinfo, _, _, exact = jax_gesv[case]
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    assert pgetrf._fast_path_mode(A, "partial") == "cpu"
    LU, piv, info = pst.getrf(A)
    X, LU2, piv2, info2 = pst.gesv(A, pst.Matrix.from_dense(b, nb=nb,
                                                            grid=CPU))
    assert piv.dtype == torch.int32 and tuple(piv.shape) == (n // nb, nb)
    assert np.array_equal(piv.numpy(), jpiv)
    assert np.array_equal(piv2.numpy(), jpiv)
    assert int(info) == int(info2) == jinfo == (zero_col is not None)
    check_lu(LU.to_dense().numpy(), jlu, exact, a, jpiv)
    assert np.array_equal(LU.to_dense().numpy(), LU2.to_dense().numpy())
    if zero_col is None:
        check_x(X.to_dense().numpy(), jx, a, b)


@pytest.mark.parametrize("trans", ["Trans", "ConjTrans"])
def test_getrs_trans_matches_jax(jax_gesv, trans):
    """getrs with Aᵀ (Aᴴ = Aᵀ in f32) from each package's own 384/128
    fast-path factors, and from the JAX factors carried into the port."""
    case = FAST[0]
    n, nb, _ = case
    a, _ = fast_inputs(*case)
    b = rand(n, 2, np.float32, seed=5)
    _, _, jpiv_np, _, JLU, jpiv, _ = jax_gesv[case]
    jx = np.asarray(jst.getrs(JLU, jpiv,
                              jst.Matrix.from_dense(b, nb=nb, grid=JLU.grid),
                              jst.Op[trans]).to_dense())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLATE_LU_FAST", "1")
        LU, piv, _ = pst.getrf(pst.Matrix.from_dense(a, nb=nb, grid=CPU))
    B = pst.Matrix.from_dense(b, nb=nb, grid=CPU)
    carried = pst.from_reference(np.asarray(JLU.data), kind="Matrix", m=n,
                                 n=n, nb=nb, device="cpu")
    for lu, p in ((LU, piv),
                  (carried, pst.pivots_from_reference(jpiv_np,
                                                      device="cpu"))):
        x = pst.getrs(lu, p, B, pst.Op[trans]).to_dense().numpy()
        check_x(x, jx, a, b, trans=True)


def test_pivot_order_to_ipiv_matches_jax():
    kt, nb = 6, 64
    order = np.random.default_rng(4).permutation(kt * nb).astype(
        np.int32).reshape(kt, nb)
    ref = np.asarray(jgetrf.pivot_order_to_ipiv(order))
    out = pst.pivot_order_to_ipiv(pst.PivotOrder(torch.from_numpy(order)))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), ref)
    # the order and its ipiv permute a right-hand side the same way
    b = pst.Matrix.from_dense(rand(kt * nb, 2, seed=1), nb=nb, grid=CPU)
    for fwd in (True, False):
        x1 = pgetrf._apply_pivots_matrix(b, pst.PivotOrder(
            torch.from_numpy(order)), fwd).to_dense()
        x2 = pgetrf._apply_pivots_matrix(b, out, fwd).to_dense()
        assert torch.equal(x1, x2)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_dense_path_matches_jax(grid11, monkeypatch, dt):
    """SLATE_LU_FAST=0: ``torch.linalg.lu_factor`` per panel against the
    JAX package's ``lax.linalg.lu`` per panel, n=300 (ragged), nb=128."""
    monkeypatch.setenv("SLATE_LU_FAST", "0")
    n, nb = 300, 128
    a = rand(n, n, dt, seed=3)           # Gaussian: well-separated pivots
    b = rand(n, 2, dt, seed=4)
    JLU, jpiv, jinfo = jst.getrf(jst.Matrix.from_dense(a, nb=nb, grid=grid11))
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    assert pgetrf._fast_path_mode(A, "partial") is None
    LU, piv, info = pst.getrf(A)
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert int(info) == int(jinfo) == 0
    lu, jlu = LU.to_dense().numpy(), np.asarray(JLU.to_dense())
    if dt == np.float64:
        np.testing.assert_allclose(lu, jlu, rtol=0, atol=1e-10)
    else:
        check_lu(lu, jlu, exact_lu(a, piv.numpy()), a, piv.numpy())
    X = pst.lu_solve(A, pst.Matrix.from_dense(b, nb=nb, grid=CPU))
    JA = jst.Matrix.from_dense(a, nb=nb, grid=grid11)
    jx = np.asarray(jst.lu_solve(JA, jst.Matrix.from_dense(
        b, nb=nb, grid=grid11)).to_dense())
    if dt == np.float64:
        assert rel(X.to_dense().numpy(), jx) < 1e-12
    else:
        check_x(X.to_dense().numpy(), jx, a, b)


@pytest.mark.parametrize("zero_cols", [(11,), (11, 12), (0, 40)],
                         ids=lambda c: "-".join(map(str, c)))
def test_dense_path_after_a_zero_pivot(grid11, monkeypatch, zero_cols):
    """A panel in which the solver meets an exact zero pivot is factored
    again by dgetf2 (``_panel_getf2``): LAPACK's pivots, its factor within
    atol 1e-5, one zero pivot per zero column; the dense path's getrf then
    gives the JAX package's pivots and info (n=256 ragged by nb=96)."""
    h, w = 160, 48
    p = rand(h, w, np.float32, seed=21)
    p[:, list(zero_cols)] = 0.0
    ref, ipiv, _ = torch.linalg.lu_factor_ex(torch.from_numpy(p))
    lu, piv = pgetrf._panel_getf2(torch.from_numpy(p.copy()))
    assert torch.equal(piv, ipiv.long() - 1)
    assert float((lu - ref).abs().max()) < 1e-5
    assert int((torch.diagonal(lu) == 0).sum()) == len(zero_cols)
    monkeypatch.setenv("SLATE_LU_FAST", "0")
    n, nb = 256, 96
    a = rand(n, n, np.float32, seed=22)
    a[:, [c + 90 for c in zero_cols]] = 0.0     # in the first two panels
    JLU, jpiv, jinfo = jst.getrf(jst.Matrix.from_dense(a, nb=nb, grid=grid11))
    LU, piv, info = pst.getrf(pst.Matrix.from_dense(a, nb=nb, grid=CPU))
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert int(info) == int(jinfo) == len(zero_cols)


def test_gesv_nan_input_runs_to_its_end(monkeypatch):
    """A NaN in A on the fast path: the port finishes with non-finite X,
    ``info`` 0 and in-range pivots, and reads no index out of range (a
    column that selects no row is clamped to the last row). The JAX
    package is no reference here: its order for such a column is out of
    range and its host ipiv conversion crashes on it (ROADMAP.md §C)."""
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    n, nb = 384, 128
    a, b = fast_inputs(n, nb, None)
    a[7, 3] = np.nan
    X, LU, piv, info = pst.gesv(pst.Matrix.from_dense(a, nb=nb, grid=CPU),
                                pst.Matrix.from_dense(b, nb=nb, grid=CPU))
    assert not np.isfinite(X.to_dense().numpy()).any()
    assert int(info) == 0
    p = piv.numpy()
    assert ((p >= 0) & (p < n)).all()


def test_lu_verbs_and_method(monkeypatch):
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    n, nb = 384, 128
    a, b = fast_inputs(n, nb, None)
    A = pst.Matrix.from_dense(a, nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(b, nb=nb, grid=CPU)
    LU, piv, info = pst.lu_factor(A)
    x = pst.lu_solve_using_factor(LU, piv, B).to_dense()
    assert torch.equal(x, pst.lu_solve(A, B).to_dense())
    check_x(x.numpy(), x.numpy(), a, b)
    # MethodLU.NoPiv takes gesv_nopiv and returns no pivots
    X, LU_n, piv_n, info_n = pst.gesv(
        A, B, {pst.Option.MethodLU: pst.MethodLU.NoPiv})
    Xn, LUn, infon = pst.gesv_nopiv(A, B)
    assert piv_n is None and int(info_n) == int(infon)
    assert torch.equal(X.to_dense(), Xn.to_dense())
    assert torch.equal(LU_n.data, LUn.data)
    assert pst.MethodLU.select_algo(A) == pst.MethodLU.PartialPiv
    assert pst.MethodLU.select_algo(
        A, {pst.Option.MethodLU: pst.MethodLU.CALU}) == pst.MethodLU.CALU
    singular = a.copy()
    singular[:, 11] = 0.0
    with pytest.raises(pst.InfoError, match="zero pivot") as e:
        pst.lu_solve(pst.Matrix.from_dense(singular, nb=nb, grid=CPU), B)
    assert e.value.info == 1
    # pivots carry across both ways as numpy int32 [kt, nb]
    ref = pst.pivots_to_reference(piv)
    assert ref.dtype == np.int32 and ref.shape == (n // nb, nb)
    back = pst.pivots_from_reference(ref, order=True, device="cpu")
    assert isinstance(back, pst.PivotOrder)
    assert np.array_equal(pst.pivots_to_reference(back), ref)


def test_fast_path_gate(monkeypatch):
    """Auto-on only on a CUDA card for 8192 ≤ n ≤ 32768, the JAX
    package's range (above H_MAX rows the subpanels take plu_panel's CALU
    tournament); forced anywhere by SLATE_LU_FAST=1 for exact f32 shapes;
    off with =0."""
    A = pst.Matrix.zeros(256, 256, 128, CPU)
    monkeypatch.delenv("SLATE_LU_FAST", raising=False)
    assert pgetrf._fast_path_mode(A, "partial") is None      # CPU
    monkeypatch.setenv("SLATE_LU_FAST", "1")
    assert pgetrf._fast_path_mode(A, "partial") == "cpu"
    assert pgetrf._fast_path_mode(A.astype(torch.float64), "partial") is None
    assert pgetrf._fast_path_mode(pst.Matrix.zeros(300, 300, 128, CPU),
                                  "partial") is None
    assert pgetrf._fast_path_mode(pst.Matrix.zeros(192, 192, 64, CPU),
                                  "partial") is None
    monkeypatch.setenv("SLATE_LU_FAST", "0")
    assert pgetrf._fast_path_mode(A, "partial") is None
