"""The port's two-stage Hermitian eigensolver on p×q grids of virtual ranks
against the JAX package's SPMD programs on meshes of virtual CPU
devices: he2hb (band and T), unmtr_he2hb, heev by every method with and
without vectors from Lower and Upper storage, the Auto dispatch, hegst
and hegv at itype 1–3 and a B that is not positive definite.

Inputs are made with numpy: A = Q·diag(λ)·Qᴴ with λ one apart (every
eigenvector is then determined up to its phase to about u·‖A‖/gap),
n = 100 with nb = 16 in float64 on 2×4 and n = 70 with nb = 8 in
complex128 on 2×2 (ragged last tiles), ``Option.EigBand`` set to nb in
both packages (their CPU defaults may differ). Tolerances: the band and
T within 1e-10 relative to ‖A‖ and 1 (the same panels, products summed
in other orders); λ within 1e-10·‖A‖ of the JAX package's; Z by
‖A·Z − Z·Λ‖/‖A‖ and ‖ZᴴZ − I‖ within 1e-10 and |Zᴴ·Z_jax| within 1e-8
of I (the phases differ; 1e-8 covers u·‖A‖/gap with room); the
generalised λ within 1e-10·‖A‖·κ(B). Each JAX reference is computed once
per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu.linalg import he2hb as jhe  # noqa: E402
from slate_tpu_torch.linalg import he2hb as phe  # noqa: E402
from slate_tpu_torch.types import MethodEig, Option  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CASES = [((2, 4), np.float64, 100, 16), ((2, 2), np.complex128, 70, 8)]
IDS = ["2x4-f64", "2x2-c128"]
NRHS = 3


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def gapped(n, dt, seed):
    """A Hermitian matrix whose eigenvalues are −n/2 … n/2 − 1."""
    Q, _ = np.linalg.qr(rand(n, n, dt, seed))
    lam = np.arange(n) - n / 2
    a = (Q * lam) @ Q.conj().T
    return ((a + a.conj().T) / 2).astype(dt)


def dense(X):
    return np.asarray(X.to_dense())


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (p, q), dt, n, nb in CASES:
        g = jgrid(p, q)
        a = gapped(n, dt, seed=p + q)
        b = spd(n, dt, seed=7)
        c = rand(n, NRHS, dt, seed=8)
        opts = {jst.Option.EigBand: nb}
        A = jst.HermitianMatrix.from_dense(a, nb=nb, grid=g)
        Aband, T = jhe.he2hb(A)
        r = dict(band=dense(Aband), T=np.asarray(T))
        for t in ("NoTrans", "ConjTrans"):
            r["unmtr", t] = dense(jhe.unmtr_he2hb(
                getattr(jst.Op, t), Aband, T,
                jst.Matrix.from_dense(c, nb=nb, grid=g)))
        lam, Z = jst.heev(A, opts)
        r["lam"], r["Z"] = np.asarray(lam), dense(Z)
        B = jst.HermitianMatrix.from_dense(b, nb=nb, grid=g)
        L, _ = jst.potrf(B)
        for itype in (1, 2, 3):
            r["hegst", itype] = dense(jst.hegst(itype, A, L))
            lam_g, _, info = jst.hegv(itype, A, B, opts)
            r["hegv", itype] = (np.asarray(lam_g), int(info))
        bad = b.copy()
        bad[n // 2, n // 2] = -50.0
        r["bad_info"] = int(jst.potrf(jst.HermitianMatrix.from_dense(
            bad, nb=nb, grid=g))[1])
        out[(p, q)] = r
    return out


def setup(case, uplo=pst.Uplo.Lower):
    (p, q), dt, n, nb = case
    a = gapped(n, dt, seed=p + q)
    stored = np.tril(a) if uplo == pst.Uplo.Lower else np.triu(a)
    A = pst.HermitianMatrix.from_dense(stored, nb=nb, grid=pgrid(p, q),
                                       uplo=uplo)
    return a, A, {Option.EigBand: nb}


def check_vectors(a, lam, z, jz):
    n = a.shape[0]
    na = np.linalg.norm(a, 2)
    assert np.linalg.norm(a @ z - z * lam) <= 1e-10 * na
    assert np.abs(z.conj().T @ z - np.eye(n)).max() <= 1e-10
    assert np.abs(np.abs(z.conj().T @ jz) - np.eye(n)).max() <= 1e-8


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_he2hb_and_back_transform_pq_match_jax(jax_ref, case):
    (p, q), dt, n, nb = case
    ref = jax_ref[(p, q)]
    a, A, _ = setup(case)
    Aband, T = pst.he2hb(A)
    assert Aband.grid == pgrid(p, q) and tuple(T.shape) == ref["T"].shape
    na = np.abs(a).max()
    # the lower storage: the band and the reflectors below it (the
    # upper half is junk by contract, and the JAX input held both)
    assert np.abs(np.tril(dense(Aband)) - np.tril(ref["band"])).max() \
        <= 1e-10 * na
    assert np.abs(T.numpy() - ref["T"]).max() <= 1e-10
    # the band gather fetches the band tiles from their owners
    band = phe.he2hb_gather(Aband).numpy()
    d = dense(Aband)
    for k in range(nb + 1):
        want = np.diagonal(d, -k)
        if k == 0 and np.iscomplexobj(want):
            want = want.real
        assert np.array_equal(band[k, :n - k], want)
    c = rand(n, NRHS, dt, seed=8)
    for t in ("NoTrans", "ConjTrans"):
        got = phe.unmtr_he2hb(getattr(pst.Op, t), Aband, T,
                              pst.Matrix.from_dense(c, nb=nb,
                                                    grid=pgrid(p, q)))
        assert np.abs(dense(got) - ref["unmtr", t]).max() \
            <= 1e-10 * np.abs(c).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("method", ["Auto", "TwoStage", "DC", "QR"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_heev_pq_every_method_and_uplo(jax_ref, case, method, uplo):
    ref = jax_ref[case[0]]
    a, A, opts = setup(case, getattr(pst.Uplo, uplo))
    opts[Option.MethodEig] = getattr(MethodEig, method)
    lam, Z = pst.heev(A, opts)
    na = np.abs(ref["lam"]).max()
    assert lam.dtype == (torch.float64)
    assert np.abs(lam.numpy() - ref["lam"]).max() <= 1e-10 * na
    assert Z.grid == pgrid(*case[0])
    check_vectors(a, lam.numpy(), dense(Z), ref["Z"])
    vals, none = pst.heev(A, opts, want_vectors=False)
    assert none is None
    assert np.abs(vals.numpy() - ref["lam"]).max() <= 1e-10 * na


def test_heev_auto_dispatch_on_pq(monkeypatch):
    """Auto takes the two-stage pipeline on a p×q grid from 4 block
    columns, and the dense route below (eig.py:99)."""
    calls = []
    real = phe.heev_two_stage

    def spy(*a, **k):
        calls.append(a[0].n)
        return real(*a, **k)

    monkeypatch.setattr(phe, "heev_two_stage", spy)
    for n, want in ((40, []), (64, [64])):       # nt 3 and 4 at nb 16
        calls.clear()
        a = gapped(n, np.float64, seed=n)
        A = pst.HermitianMatrix.from_dense(a, nb=16, grid=pgrid(2, 4))
        lam = pst.eig_vals(A, {Option.EigBand: 16})
        assert calls == want
        assert np.abs(lam.numpy() - np.linalg.eigvalsh(a)).max() < 1e-10 * n
        lam, Z = pst.heev(A, {Option.EigBand: 16})
        check_vectors(a, lam.numpy(), dense(Z), np.linalg.eigh(a)[1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegst_hegv_pq_match_jax(jax_ref, case, itype):
    (p, q), dt, n, nb = case
    ref = jax_ref[(p, q)]
    a, A, opts = setup(case)
    b = spd(n, dt, seed=7)
    B = pst.HermitianMatrix.from_dense(b, nb=nb, grid=pgrid(p, q))
    L, info = pst.potrf(B)
    assert int(info) == 0
    C = pst.hegst(itype, A, L)
    assert isinstance(C, pst.HermitianMatrix) and C.grid == pgrid(p, q)
    assert np.abs(dense(C) - ref["hegst", itype]).max() \
        <= 1e-10 * np.abs(a).max() * np.linalg.cond(b)
    lam, Z, info = pst.hegv(itype, A, B, opts)
    jlam, jinfo = ref["hegv", itype]
    assert int(info) == jinfo == 0
    scale = np.abs(jlam).max() * np.linalg.cond(b)
    assert np.abs(lam.numpy() - jlam).max() <= 1e-10 * scale
    z, lam = dense(Z), lam.numpy()
    if itype == 1:
        r = a @ z - b @ z * lam
    else:
        r = (a @ b @ z if itype == 2 else b @ a @ z) - z * lam
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(a) \
        * np.linalg.norm(b) * np.linalg.norm(z)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hegv_pq_not_positive_definite(jax_ref, case):
    """B not positive definite: potrf's info, as the JAX package's potrf
    on the mesh gives it, and NaN λ and Z; heev is not run."""
    (p, q), dt, n, nb = case
    _, A, opts = setup(case)
    bad = spd(n, dt, seed=7)
    bad[n // 2, n // 2] = -50.0
    lam, Z, info = pst.hegv(1, A, pst.HermitianMatrix.from_dense(
        bad, nb=nb, grid=pgrid(p, q)), opts)
    assert int(info) == jax_ref[(p, q)]["bad_info"] == n // 2 // nb + 1
    assert np.isnan(lam.numpy()).all() and np.isnan(dense(Z)).all()
    assert Z.shape == (n, n) and Z.grid == pgrid(p, q)
