"""The port's batched drivers (``serve/batched.py``), their driver
siblings ``posv_batched``/``gesv_batched`` and the shape buckets
(``cache/buckets.py``) against the JAX package, on the CPU.

The stacks and shapes are those of ``tests/test_serve.py``'s batched
tests; inputs are made with numpy from a seed and go into both packages.
Tolerance: 50·n·max(tier_eps, 1e-14), the JAX suite's own, on X, the
factors and each member against its batch-of-1 call; pivot orders and
``info`` equal. The buckets' table, choice, tile size and embeddings are
held equal to the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slate_tpu.cache import buckets as jbuckets  # noqa: E402
from slate_tpu.internal.precision import resolve_tier, tier_eps  # noqa: E402
from slate_tpu.serve import batched as jbatched  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.cache import buckets  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.robust.guards import finite_guard  # noqa: E402
from slate_tpu_torch.serve import batched  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = "cpu"


def tol(n, tier=None):
    return 50 * n * max(tier_eps(tier or resolve_tier(None)), 1e-14)


def spd_stack(B, n, seed=0, dtype=np.float64):
    return np.stack([spd(n, dtype=dtype, seed=seed + i) for i in range(B)])


def rhs_stack(B, n, k=2, seed=100, dtype=np.float64):
    return np.stack([rand(n, k, dtype=dtype, seed=seed + i)
                     for i in range(B)])


def dd_stack(B, n, seed=0, dtype=np.float64):
    """Diagonally dominant: well-separated pivots, so the pivot order is
    the same in both packages."""
    return np.stack([rand(n, n, dtype=dtype, seed=seed + i)
                     + n * np.eye(n, dtype=dtype) for i in range(B)])


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


POSV = {"batched_posv": batched.batched_posv,
        "posv_batched": pst.posv_batched}
GESV = {"batched_gesv": batched.batched_gesv,
        "gesv_batched": pst.gesv_batched}


@pytest.mark.parametrize("name", sorted(POSV))
def test_posv_stack_matches_jax_and_singles(name):
    B, n, k = 5, 96, 2
    A, Bb = spd_stack(B, n), rhs_stack(B, n, k)
    x, l, info = POSV[name](A, Bb, nb=32, device=CPU)
    xj, lj, ij = jbatched.batched_posv(A, Bb, nb=32)
    assert x.device.type == "cpu" and info.dtype == torch.int32
    assert np.array_equal(np_(info), np_(ij)) and not np_(info).any()
    assert np.abs(np_(x) - np_(xj)).max() < tol(n)
    assert np.abs(np_(l) - np_(lj)).max() < tol(n)
    for i in range(B):
        xs, _, is_ = POSV[name](A[i:i + 1], Bb[i:i + 1], nb=32, device=CPU)
        assert int(is_[0]) == 0
        assert np.abs(np_(x)[i] - np_(xs)[0]).max() < tol(n)
        li = np_(l)[i]
        assert np.abs(li @ li.T - A[i]).max() < tol(n)


@pytest.mark.parametrize("name", sorted(GESV))
def test_gesv_stack_matches_jax_with_its_pivots(name):
    B, n, k = 4, 64, 3
    A, Bb = dd_stack(B, n), rhs_stack(B, n, k)
    x, lu, perm, info = GESV[name](A, Bb, nb=32, device=CPU)
    xj, luj, pj, ij = jbatched.batched_gesv(A, Bb, nb=32)
    assert np.array_equal(np_(perm), np_(pj))
    assert np.array_equal(np_(info), np_(ij)) and not np_(info).any()
    assert np.abs(np_(x) - np_(xj)).max() < tol(n)
    assert np.abs(np_(lu) - np_(luj)).max() < tol(n)
    for i in range(B):
        xs, _, ps, _ = GESV[name](A[i:i + 1], Bb[i:i + 1], nb=32, device=CPU)
        assert np.array_equal(np_(perm)[i], np_(ps)[0])
        assert np.abs(np_(x)[i] - np_(xs)[0]).max() < tol(n)
        lo = np.tril(np_(lu)[i], -1) + np.eye(n)
        assert np.abs(lo @ np.triu(np_(lu)[i]) - A[i][np_(perm)[i]]).max() \
            < tol(n)


def test_potrf_and_getrf_stacks_match_jax():
    A = spd_stack(3, 64, seed=4)
    l, info = batched.batched_potrf(A, nb=32, device=CPU)
    lj, ij = jbatched.batched_potrf(A, nb=32)
    assert np.array_equal(np_(info), np_(ij))
    assert np.abs(np_(l) - np_(lj)).max() < tol(64)
    G = dd_stack(3, 64, seed=5)
    lu, perm, info = batched.batched_getrf(G, nb=16, device=CPU)
    luj, pj, ij = jbatched.batched_getrf(G, nb=16)
    assert np.array_equal(np_(perm), np_(pj))
    assert np.array_equal(np_(info), np_(ij))
    assert np.abs(np_(lu) - np_(luj)).max() < tol(64)


@pytest.mark.parametrize("side,lower,trans,unit", [
    ("left", True, False, False), ("left", False, True, False),
    ("right", True, True, False), ("right", False, False, True)])
def test_trsm_stack_matches_jax(side, lower, trans, unit):
    B, n, k = 3, 48, 2
    T = np.stack([rand(n, n, seed=i) + 2 * n * np.eye(n) for i in range(B)])
    T = np.tril(T) if lower else np.triu(T)
    b = rhs_stack(B, n, k) if side == "left" else rhs_stack(B, k, n)
    x = np_(batched.batched_trsm(T, b, side=side, lower=lower, trans=trans,
                                 unit=unit, device=CPU))
    xj = np_(jbatched.batched_trsm(T, b, side=side, lower=lower,
                                   trans=trans, unit=unit))
    scale = np.abs(xj).max()
    assert np.abs(x - xj).max() < 1e-12 * scale
    for i in range(B):
        t = np.tril(T[i]) if lower else np.triu(T[i])
        if unit:
            t = t - np.diag(np.diag(t)) + np.eye(n)
        t = t.T if trans else t
        r = t @ x[i] - b[i] if side == "left" else x[i] @ t - b[i]
        assert np.abs(r).max() < 1e-12 * np.abs(t).max() * scale * n


@pytest.mark.parametrize("dt,tier", [(np.float32, "bf16_6x"),
                                     (np.float32, "bf16_3x"),
                                     (np.float32, "mxu_bf16"),
                                     (np.complex128, "bf16_6x")])
def test_stacks_by_type_and_tier_match_jax(dt, tier):
    """float32 (K1's plain version over the stack on the CPU) at each
    trailing-update tier, and complex128 (``cholesky_ex`` over the
    stack), posv and gesv against the JAX package."""
    B, n = 3, 64
    opts = {pst.Option.TrailingPrecision: tier}
    jopts = {__import__("slate_tpu").Option.TrailingPrecision: tier}
    A, G, b = spd_stack(B, n, 7, dt), dd_stack(B, n, 8, dt), \
        rhs_stack(B, n, 2, 9, dt)
    t = tol(n, tier) * (1 if dt == np.complex128 else 4)
    x, _, info = batched.batched_posv(A, b, opts, nb=16, device=CPU)
    xj, _, ij = jbatched.batched_posv(A, b, jopts, nb=16)
    assert x.dtype == {np.float32: torch.float32,
                       np.complex128: torch.complex128}[dt]
    assert np.array_equal(np_(info), np_(ij))
    assert np.abs(np_(x) - np_(xj)).max() < t
    x, _, perm, info = batched.batched_gesv(G, b, opts, nb=16, device=CPU)
    xj, _, pj, ij = jbatched.batched_gesv(G, b, jopts, nb=16)
    assert np.array_equal(np_(perm), np_(pj))
    assert np.array_equal(np_(info), np_(ij))
    assert np.abs(np_(x) - np_(xj)).max() < t


def test_gesv_pivot_orders_differ_across_members():
    n = 32
    a0 = rand(n, n, seed=1) + n * np.eye(n)
    _, _, perm, info = batched.batched_gesv(
        np.stack([a0, a0[::-1].copy()]), rhs_stack(2, n, 1), nb=16,
        device=CPU)
    _, _, pj, _ = jbatched.batched_gesv(np.stack([a0, a0[::-1].copy()]),
                                        rhs_stack(2, n, 1), nb=16)
    assert not np_(info).any()
    assert not np.array_equal(np_(perm)[0], np_(perm)[1])
    assert np.array_equal(np_(perm), np_(pj))


def test_gesv_singular_member_fails_alone():
    B, n = 4, 64
    A, Bb = dd_stack(B, n, seed=7), rhs_stack(B, n, 2, seed=70)
    A[2, :, 11] = 0.0
    A[2, 11, :] = 0.0
    x, _, _, info = batched.batched_gesv(A, Bb, nb=32, device=CPU)
    _, _, _, ij = jbatched.batched_gesv(A, Bb, nb=32)
    x, info = np_(x), np_(info)
    assert info[2] > 0 and list(info) == list(np_(ij))
    assert np.isfinite(x).all()
    for i in (0, 1, 3):
        assert info[i] == 0
        assert np.abs(x[i] - np.linalg.solve(A[i], Bb[i])).max() < 1e-8
        xs = np_(batched.batched_gesv(A[i:i + 1], Bb[i:i + 1], nb=32,
                                      device=CPU)[0])[0]
        assert np.array_equal(x[i], xs)


def test_potrf_non_spd_member_fails_alone():
    B, n = 3, 64
    A = spd_stack(B, n, seed=3)
    A[1] = -np.eye(n)
    l, info = batched.batched_potrf(A, nb=32, device=CPU)
    _, ij = jbatched.batched_potrf(A, nb=32)
    l, info = np_(l), np_(info)
    assert list(info) == list(np_(ij)) == [0, 1, 0]
    assert np.isfinite(l).all()
    for i in (0, 2):
        assert np.abs(l[i] @ l[i].T - A[i]).max() < 1e-10


def test_posv_nan_member_fails_alone():
    B, n = 3, 64
    A, Bb = spd_stack(B, n, seed=9), rhs_stack(B, n, 1, seed=90)
    A[0, 5, 5] = np.nan
    x, _, info = batched.batched_posv(A, Bb, nb=32, device=CPU)
    _, _, ij = jbatched.batched_posv(A, Bb, nb=32)
    x, info = np_(x), np_(info)
    assert list(info) == list(np_(ij)) and info[0] > 0
    assert info[1] == info[2] == 0
    assert np.isfinite(x).all()
    for i in (1, 2):
        assert np.abs(x[i] - np.linalg.solve(A[i], Bb[i])).max() < 1e-10
    # the LU: the NaN member takes LAPACK's unblocked loop; its info
    # counts its zero-filled pivots and poisoned panels
    x, _, _, info = batched.batched_gesv(A, Bb, nb=32, device=CPU)
    info = np_(info)
    assert np.isfinite(np_(x)).all() and info[0] > 0
    assert info[1] == info[2] == 0
    for i in (1, 2):
        xs = batched.batched_gesv(A[i:i + 1], Bb[i:i + 1], nb=32,
                                  device=CPU)[0]
        assert np.array_equal(np_(x)[i], np_(xs)[0])


def test_stacked_finite_guard_is_per_member_and_scalar_keeps_its_form():
    x = torch.ones(3, 4, 4, dtype=torch.float64)
    x[1, 2, 2] = float("nan")
    x[2, 0, 3] = float("inf")
    clean, info = finite_guard(x, torch.zeros(3, dtype=torch.int32), 5)
    assert info.tolist() == [0, 5, 5] and torch.isfinite(clean).all()
    _, info = finite_guard(x, torch.zeros(3, dtype=torch.int32), 5,
                           diag=True)
    assert info.tolist() == [0, 5, 0]
    clean, info = finite_guard(x[1], torch.zeros((), dtype=torch.int32), 2)
    assert info.dim() == 0 and int(info) == 2
    assert torch.equal(clean, torch.where(torch.isfinite(x[1]), x[1], 0.0))


@pytest.mark.parametrize("call", ["no_batch_axis", "rhs_mismatch",
                                  "nb_not_dividing", "bad_side"])
def test_bad_shapes_raise_as_in_jax(call):
    calls = {
        "no_batch_axis": lambda m, **kw: m.batched_potrf(np.eye(4), **kw),
        "rhs_mismatch": lambda m, **kw: m.batched_posv(
            spd_stack(2, 32), np.ones((3, 32, 1)), **kw),
        "nb_not_dividing": lambda m, **kw: m.batched_potrf(
            spd_stack(1, 30), nb=16, **kw),
        "bad_side": lambda m, **kw: m.batched_trsm(
            spd_stack(1, 8), np.ones((1, 8, 1)), side="up", **kw),
    }
    with pytest.raises(ValueError):
        calls[call](jbatched)
    with pytest.raises(ValueError):
        calls[call](batched, device=CPU)


def test_numpy_stack_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pst.SlateError, match="device='cpu'"):
        batched.batched_potrf(spd_stack(1, 8))
    t = torch.from_numpy(spd_stack(2, 8))
    l, info = batched.batched_potrf(t)
    assert l.device == t.device and not info.any()
    with pytest.raises(pst.SlateError):
        batched.batched_potrf(t, device="meta")


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,table,nb,policy", [
    (100, (64, 128), None, "grow"), (128, (64, 128), None, "grow"),
    (200, (64, 128), 32, "grow"), (200, (64, 128), None, "grow"),
    (3000, None, None, "grow"), (40000, None, None, "grow"),
    (5, (256, 64, 128), None, "grow"), (200, (64, 128), None, "reject"),
    (100, (64, 128), None, "nonsense"), (0, None, None, "grow")])
def test_bucket_for_matches_jax(n, table, nb, policy):
    try:
        want = jbuckets.bucket_for(n, table, nb, policy=policy)
    except ValueError:
        with pytest.raises(ValueError):
            buckets.bucket_for(n, table, nb, policy=policy)
        return
    assert buckets.bucket_for(n, table, nb, policy=policy) == want


def test_default_nb_and_embeddings_match_jax():
    for N in (1, 64, 128, 200, 256, 512, 513, 1024, 32768):
        assert buckets.default_nb(N) == jbuckets.default_nb(N)
    a = spd(23, seed=3)
    for N in (23, 32, 64):
        np.testing.assert_array_equal(buckets.pad_embed(a, N),
                                      jbuckets.pad_embed(a, N))
    for b in (rand(23, 2, seed=4), rand(23, 1, seed=5)[:, 0]):
        np.testing.assert_array_equal(buckets.pad_rhs(b, 64),
                                      jbuckets.pad_rhs(b, 64))
    with pytest.raises(ValueError):
        buckets.pad_embed(a, 16)


@pytest.mark.parametrize("env", ["", "512,256", "64; 128;2048", "x,1",
                                 "0,64", " "])
def test_bucket_table_env_override_matches_jax(monkeypatch, env):
    monkeypatch.setenv(buckets.ENV_BUCKETS, env)
    assert buckets.ENV_BUCKETS == jbuckets.ENV_BUCKETS
    assert buckets.bucket_table() == jbuckets.bucket_table()


@pytest.mark.parametrize("routine", ["posv", "gesv"])
def test_bucketed_solves_match_jax(routine, grid11):
    n = 37
    a = spd(n, seed=6) if routine == "posv" else rand(n, n, seed=6) \
        + n * np.eye(n)
    b = rand(n, 1, seed=7)[:, 0]
    mine = getattr(buckets, f"bucketed_{routine}")
    theirs = getattr(jbuckets, f"bucketed_{routine}")
    x, info = mine(a, b, table=(64,), nb=16,
                   grid=pst.Grid(1, 1, device=CPU))
    xj, ij = theirs(a, b, table=(64,), nb=16, grid=grid11)
    assert info == ij == 0 and tuple(x.shape) == b.shape
    assert np.abs(np_(x) - np.asarray(xj)).max() < 1e-12
    assert np.abs(a @ np_(x) - b).max() < 1e-10


def test_no_kernel_launches_on_the_cpu():
    before = dict(K.LAUNCHES)
    batched.batched_posv(spd_stack(2, 64, dtype=np.float32),
                         rhs_stack(2, 64, dtype=np.float32), nb=32,
                         device=CPU)
    assert K.LAUNCHES == before
