"""The rest of the port's Level-3 BLAS (her2k, syr2k, hemm, symm, trmm),
the four shape classes, the verbs and the generalised eigensolver
(hegst, hegv) against the JAX package on a 1×1 grid, on the CPU.

Inputs are made with numpy from a seed and go into both packages; the
cases are those of tests/test_blas.py and tests/test_eig_svd.py.
Tolerances: products within 1e-12 relative of the JAX package's (f64:
the same products summed in other orders); λ and the hegv residuals
within 1e-10; f32 products within 10·n·2⁻²⁴ of the f64 product. The
port's results are compared on the true m×n: its padding may differ
(ROADMAP §C, "Padding after sub").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")
SIDES = ["Left", "Right"]
UPLOS = ["Lower", "Upper"]


def dense(M):
    d = M.to_dense()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def rel(x, ref):
    return np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300)


def both(grid11, cls, a, nb, **kw):
    """The same numpy matrix as a JAX and a port matrix of class ``cls``
    (enum fields by name)."""
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        fields = {k: getattr(pkg, k.capitalize())[v] if isinstance(v, str)
                  else v for k, v in kw.items()}
        out.append(getattr(pkg, cls).from_dense(a, nb=nb, grid=grid,
                                                **fields))
    return out


@pytest.fixture(autouse=True)
def no_launches():
    """On the CPU the kernels' plain versions run and nothing launches."""
    before = dict(K.LAUNCHES)
    yield
    assert K.LAUNCHES == before


@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_her2k_syr2k(grid11, dt):
    n, k, nb = 16, 8, 8
    a, b = rand(n, k, dt, 4), rand(n, k, dt, 5)
    alpha = 1.5 if dt == np.float64 else 1.5 + 0.5j
    c0 = rand(n, n, dt, 6)
    c0 = (c0 + np.conj(c0.T)) / 2
    out = {}
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.Matrix.from_dense(a, nb=nb, grid=grid)
        B = pkg.Matrix.from_dense(b, nb=nb, grid=grid)
        C = pkg.HermitianMatrix.from_dense(c0, nb=nb, grid=grid)
        S = pkg.SymmetricMatrix.from_dense(c0, nb=nb, grid=grid)
        H2 = pkg.her2k(alpha, A, B, 0.5, C)
        S2 = pkg.syr2k(2.0, A, B, -1.0, S)
        assert isinstance(H2, pkg.HermitianMatrix)
        assert isinstance(S2, pkg.SymmetricMatrix)
        out[pkg] = dense(H2), dense(S2)
    ref_h = alpha * a @ np.conj(b.T) + np.conj(alpha) * b @ np.conj(a.T) \
        + 0.5 * c0
    ref_s = 2.0 * (a @ b.T + b @ a.T) - c0
    for got, jref, ref in zip(out[pst], out[jst], (ref_h, ref_s)):
        assert rel(got, jref) < 1e-12
        assert rel(np.tril(got), np.tril(ref)) < 1e-12


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("uplo", UPLOS)
@pytest.mark.parametrize("dt", [np.float64, np.complex128])
def test_hemm_symm(grid11, side, uplo, dt):
    """hemm and symm of the same stored half against the JAX package's;
    hemm against the Hermitian matrix, symm against the symmetric one
    that the half stands for."""
    n, nrhs, nb = 16, 24, 8
    afull = rand(n, n, dt, 6)
    afull = (afull + np.conj(afull.T)) / 2
    bdim = (n, nrhs) if side == "Left" else (nrhs, n)
    b, c = rand(*bdim, dtype=dt, seed=7), rand(*bdim, dtype=dt, seed=8)
    half = np.tril(afull) if uplo == "Lower" else np.triu(afull)
    asym = half + half.T - np.diag(np.diag(half))
    out = {}
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        B = pkg.Matrix.from_dense(b, nb=nb, grid=grid)
        C = pkg.Matrix.from_dense(c, nb=nb, grid=grid)
        H = pkg.HermitianMatrix.from_dense(afull, nb=nb, grid=grid,
                                           uplo=pkg.Uplo[uplo])
        S = pkg.SymmetricMatrix.from_dense(afull, nb=nb, grid=grid,
                                           uplo=pkg.Uplo[uplo])
        out[pkg] = (dense(pkg.hemm(pkg.Side[side], 1.0, H, B, 0.0, C)),
                    dense(pkg.symm(pkg.Side[side], 2.0, S, B, 0.5, C)))
    for got, jref in zip(out[pst], out[jst]):
        assert rel(got, jref) < 1e-12
    prod = (lambda m: m @ b) if side == "Left" else (lambda m: b @ m)
    assert rel(out[pst][0], prod(afull)) < 1e-12
    assert rel(out[pst][1], 2.0 * prod(asym) + 0.5 * c) < 1e-12


def tri(a, lower, unit=False):
    t = np.tril(a) if lower else np.triu(a)
    if unit:
        np.fill_diagonal(t, 1.0)
    return t


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("uplo", UPLOS)
@pytest.mark.parametrize("diag", ["NonUnit", "Unit"])
def test_trmm(grid11, side, uplo, diag):
    n, nrhs, nb = 16, 12, 8
    a = rand(n, n, np.float64, 8)
    t = tri(a, uplo == "Lower", diag == "Unit")
    bdim = (n, nrhs) if side == "Left" else (nrhs, n)
    b = rand(*bdim, seed=9)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.TriangularMatrix.from_dense(a, nb=nb, grid=grid,
                                            uplo=pkg.Uplo[uplo],
                                            diag=pkg.Diag[diag])
        out.append(dense(pkg.trmm(pkg.Side[side], 2.0, A,
                                  pkg.Matrix.from_dense(b, nb=nb,
                                                        grid=grid))))
    ref = 2.0 * (t @ b) if side == "Left" else 2.0 * (b @ t)
    assert rel(out[1], out[0]) < 1e-12
    assert rel(out[1], ref) < 1e-12


@pytest.mark.parametrize("side", SIDES)
def test_trmm_transposed_view(grid11, side):
    """trmm of a transposed unit-lower view multiplies by the unit-upper
    Tᵀ: the view is resolved before the triangle is extracted."""
    n, nrhs, nb = 20, 6, 8
    a = rand(n, n, np.float64, 10)
    bdim = (n, nrhs) if side == "Left" else (nrhs, n)
    b = rand(*bdim, seed=11)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        A = pkg.TriangularMatrix.from_dense(a, nb=nb, grid=grid,
                                            uplo=pkg.Uplo.Lower,
                                            diag=pkg.Diag.Unit)
        out.append(dense(pkg.trmm(pkg.Side[side], 1.0, pkg.transpose(A),
                                  pkg.Matrix.from_dense(b, nb=nb,
                                                        grid=grid))))
    t = tri(a, True, True).T
    assert rel(out[1], out[0]) < 1e-12
    assert rel(out[1], t @ b if side == "Left" else b @ t) < 1e-12


@pytest.mark.parametrize("cls,kw", [
    ("TrapezoidMatrix", {}),
    ("SymmetricMatrix", {}),
    ("TriangularBandMatrix", {"kl": 3, "ku": 0, "diag": "Unit"}),
    ("HermitianBandMatrix", {"kl": 2, "ku": 2, "uplo": "Upper"}),
])
def test_shape_classes_match_jax(grid11, cls, kw):
    """Each new class: its uplo default, its views (transpose and
    conj_transpose flip uplo and swap kl/ku on materialize) and its
    storage, equal to the JAX class's, and carried across both ways bit
    for bit."""
    a = rand(21, 21, np.float64, 12)
    J, P = both(grid11, cls, a, 8, **kw)
    assert P.uplo.name == J.uplo.name == kw.get("uplo", "Lower")
    for view in ("transpose", "conj_transpose"):
        jm = getattr(jst, view)(J).materialize()
        pm = getattr(pst, view)(P).materialize()
        assert type(pm).__name__ == type(jm).__name__ == cls
        assert (pm.uplo.name, pm.kl, pm.ku, pm.diag.name) == (
            jm.uplo.name, jm.kl, jm.ku, jm.diag.name)
        np.testing.assert_array_equal(pm.data.numpy(), np.asarray(jm.data))
    fields = {"data": np.asarray(J.data), "kind": type(J).__name__,
              "m": J.m, "n": J.n, "nb": J.nb, "op": J.op.name,
              "uplo": J.uplo.name, "diag": J.diag.name, "kl": J.kl,
              "ku": J.ku}
    carried = pst.from_reference(**fields, device="cpu")
    assert type(carried) is type(P)
    back = pst.to_reference(carried)
    assert {k: v for k, v in back.items() if k != "data"} == {
        k: v for k, v in fields.items() if k != "data"}
    np.testing.assert_array_equal(back["data"], fields["data"])
    np.testing.assert_array_equal(P.astype(torch.float32).data.numpy(),
                                  np.asarray(J.astype(np.float32).data))


@pytest.mark.parametrize("verb", ["multiply_hermitian_a",
                                  "multiply_symmetric_a",
                                  "multiply_hermitian_b",
                                  "multiply_symmetric_b", "multiply_general",
                                  "triangular_multiply", "triangular_solve",
                                  "rank_k_update", "rank_2k_update"])
def test_verbs_match_jax(grid11, verb):
    """Each verb dispatches as the JAX package's does and gives its
    result."""
    n, nb = 18, 8
    s = spd(n, np.float64, seed=13)
    g = rand(n, n, np.float64, 14)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        G = pkg.Matrix.from_dense(g, nb=nb, grid=grid)
        C = pkg.Matrix.from_dense(g.T.copy(), nb=nb, grid=grid)
        H = pkg.HermitianMatrix.from_dense(s, nb=nb, grid=grid,
                                           uplo=pkg.Uplo.Upper)
        S = pkg.SymmetricMatrix.from_dense(s, nb=nb, grid=grid)
        T = pkg.TriangularMatrix.from_dense(s, nb=nb, grid=grid)
        r = {"multiply_hermitian_a": lambda: pkg.multiply(2.0, H, G, 0.5, C),
             "multiply_symmetric_a": lambda: pkg.multiply(2.0, S, G, 0.5, C),
             "multiply_hermitian_b": lambda: pkg.multiply(2.0, G, H, 0.5, C),
             "multiply_symmetric_b": lambda: pkg.multiply(2.0, G, S, 0.5, C),
             "multiply_general": lambda: pkg.multiply(2.0, G, C, 0.5, G),
             "triangular_multiply": lambda: pkg.triangular_multiply(
                 1.5, T, G, side=pkg.Side.Right),
             "triangular_solve": lambda: pkg.triangular_solve(1.5, T, G),
             "rank_k_update": lambda: pkg.rank_k_update(1.0, G, 0.5, H),
             "rank_2k_update": lambda: pkg.rank_2k_update(1.0, G, C, 0.5,
                                                          S)}[verb]()
        out.append(dense(r))
    assert rel(out[1], out[0]) < 1e-12
    if verb == "multiply_hermitian_a":
        assert rel(out[1], 2.0 * s @ g + 0.5 * g.T) < 1e-12


def test_f32_products_within_bound():
    """f32 hemm, her2k and trmm against the f64 product, within
    10·n·2⁻²⁴ relative."""
    n, nb, k = 96, 32, 40
    s = spd(n, np.float64, seed=15)
    b = rand(n, k, np.float64, 16)
    bound = 10 * n * 2.0 ** -24
    H = pst.HermitianMatrix.from_dense(s.astype(np.float32), nb=nb, grid=CPU)
    B = pst.Matrix.from_dense(b.astype(np.float32), nb=nb, grid=CPU)
    C = pst.Matrix.zeros(n, k, nb, CPU)
    assert rel(dense(pst.hemm(pst.Side.Left, 1.0, H, B, 0.0, C)), s @ b) \
        <= bound
    H2 = pst.her2k(1.0, B, B, 0.0, H)
    assert rel(np.tril(dense(H2)), np.tril(2 * b @ b.T)) <= bound
    T = pst.TriangularMatrix.from_dense(s.astype(np.float32), nb=nb,
                                        grid=CPU)
    assert rel(dense(pst.trmm(pst.Side.Left, 1.0, T, B)), np.tril(s) @ b) \
        <= bound


# ---------------------------------------------------------------------------
# hegst / hegv
# ---------------------------------------------------------------------------

def sym(n, seed):
    a = rand(n, n, seed=seed)
    return (a + a.T) / 2


@pytest.fixture(scope="module")
def jax_hegv(grid11):
    """The JAX hegv and hegst of the reference's matrices at each itype
    (n = 16, nb = 8, tests/test_eig_svd.py::test_hegv)."""
    a, b = sym(16, 3), spd(16, np.float64, seed=4)
    A = jst.HermitianMatrix.from_dense(a, nb=8, grid=grid11)
    B = jst.HermitianMatrix.from_dense(b, nb=8, grid=grid11)
    L, _ = jst.potrf(B)
    out = {"a": a, "b": b}
    for itype in (1, 2, 3):
        lam, Z, info = jst.hegv(itype, A, B)
        out[itype] = dict(lam=np.asarray(lam), z=dense(Z), info=int(info),
                          c=dense(jst.hegst(itype, A, L)))
    return out


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegst(jax_hegv, itype):
    ref = jax_hegv
    L, info = pst.potrf(pst.HermitianMatrix.from_dense(ref["b"], nb=8,
                                                       grid=CPU))
    C = pst.hegst(itype, pst.HermitianMatrix.from_dense(ref["a"], nb=8,
                                                        grid=CPU), L)
    assert int(info) == 0 and isinstance(C, pst.HermitianMatrix)
    assert rel(dense(C), ref[itype]["c"]) < 1e-12


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv(jax_hegv, itype):
    """λ against the JAX package's and scipy's, Z by its residual and its
    B-orthonormality (Zᵀ·B·Z = I for itype 1 and 2, Zᵀ·B⁻¹·Z = I for 3)."""
    from scipy.linalg import eigh
    ref = jax_hegv
    a, b = ref["a"], ref["b"]
    lam, Z, info = pst.hegv(itype, pst.HermitianMatrix.from_dense(
        a, nb=8, grid=CPU), pst.HermitianMatrix.from_dense(b, nb=8, grid=CPU))
    lam, z = lam.numpy(), dense(Z)
    assert int(info) == ref[itype]["info"] == 0
    assert np.abs(lam - ref[itype]["lam"]).max() < 1e-10
    assert np.abs(lam - eigh(a, b, type=itype, eigvals_only=True)).max() \
        < 1e-10
    if itype == 1:
        r = a @ z - b @ z * lam
    else:
        r = (a @ b @ z if itype == 2 else b @ a @ z) - z * lam
    assert np.linalg.norm(r) < 1e-10 * np.linalg.norm(a) * max(
        np.linalg.norm(b), 1.0)
    gram = z.T @ (np.linalg.solve(b, z) if itype == 3 else b @ z)
    assert np.abs(gram - np.eye(16)).max() < 1e-10


def test_hegv_itype2(grid11):
    """tests/test_eig_svd.py::test_hegv_itype2: the itype 2 back-transform
    is L⁻ᴴ·y, so A·B·z = λ·z."""
    a, b = sym(16, 40), spd(16, np.float64, seed=41)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        lam, Z, info = pkg.hegv(2, pkg.HermitianMatrix.from_dense(
            a, nb=8, grid=grid), pkg.HermitianMatrix.from_dense(
            b, nb=8, grid=grid))
        assert int(info) == 0
        out.append((np.asarray(lam), dense(Z)))
    (jlam, _), (lam, z) = out
    assert np.abs(lam - jlam).max() < 1e-10
    err = np.linalg.norm(a @ (b @ z) - z * lam[None, :])
    assert err < 1e-10 * np.linalg.norm(a) * np.linalg.norm(b)


def test_hegv_upper_b_and_failures(grid11):
    """An Upper-stored B (B = Uᴴ·U) reduces with L = Uᴴ, so λ matches the
    Lower-stored B's; a B that is not positive definite gives the JAX
    package's info and NaN λ and Z, and heev is not run; complex hegst
    and complex hegv give the JAX package's results (λ real), an Upper
    complex B the Lower one's λ."""
    from scipy.linalg import eigh
    a, b = sym(24, 17), spd(24, np.float64, seed=18)
    A = pst.HermitianMatrix.from_dense(a, nb=8, grid=CPU)
    Bu = pst.HermitianMatrix.from_dense(np.triu(b), nb=8, grid=CPU,
                                        uplo=pst.Uplo.Upper)
    lam, Z, info = pst.hegv(1, A, Bu)
    assert int(info) == 0
    assert np.abs(lam.numpy() - eigh(a, b, eigvals_only=True)).max() < 1e-10
    bad = b.copy()
    bad[10, 10] = -50.0
    JA = jst.HermitianMatrix.from_dense(a, nb=8, grid=grid11)
    jlam, _, jinfo = jst.hegv(1, JA, jst.HermitianMatrix.from_dense(
        bad, nb=8, grid=grid11))
    lam, Z, info = pst.hegv(1, A, pst.HermitianMatrix.from_dense(
        bad, nb=8, grid=CPU))
    assert int(info) == int(jinfo) == 2
    assert np.isnan(lam.numpy()).all() and np.isnan(np.asarray(jlam)).all()
    assert np.isnan(dense(Z)).all() and Z.shape == (24, 24)
    ac = (a + 1j * np.tril(sym(24, 19), -1)).astype(np.complex128)
    ac = np.tril(ac) + np.tril(ac, -1).conj().T
    L = pst.potrf(Bu)[0]
    Lc = pst.TriangularMatrix.from_dense(
        L.to_dense().numpy().conj().T.astype(np.complex128), nb=8, grid=CPU)
    C = pst.hegst(1, pst.HermitianMatrix.from_dense(ac, nb=8, grid=CPU), Lc)
    JC = jst.hegst(1, jst.HermitianMatrix.from_dense(ac, nb=8, grid=grid11),
                   jst.TriangularMatrix.from_dense(dense(Lc), nb=8,
                                                   grid=grid11))
    assert np.abs(dense(C) - dense(JC)).max() < 1e-12
    bc = spd(24, np.complex128, seed=20)
    jlam_c, _, jinfo_c = jst.hegv(
        1, jst.HermitianMatrix.from_dense(ac, nb=8, grid=grid11),
        jst.HermitianMatrix.from_dense(bc, nb=8, grid=grid11))
    Ac = pst.HermitianMatrix.from_dense(ac, nb=8, grid=CPU)
    lam_c, Zc, info_c = pst.hegv(1, Ac, pst.HermitianMatrix.from_dense(
        bc, nb=8, grid=CPU))
    assert int(info_c) == int(jinfo_c) == 0 and lam_c.dtype == torch.float64
    assert np.abs(lam_c.numpy() - np.asarray(jlam_c)).max() < 1e-10
    zc = dense(Zc)
    assert np.linalg.norm(ac @ zc - bc @ zc * lam_c.numpy()) < 1e-10 * 24
    lam_u, _, info_u = pst.hegv(1, Ac, pst.HermitianMatrix.from_dense(
        np.triu(bc), nb=8, grid=CPU, uplo=pst.Uplo.Upper))
    assert int(info_u) == 0
    assert np.abs(lam_u.numpy() - lam_c.numpy()).max() < 1e-10
