"""The port's precision tiers and mixed-precision solves on the CPU
against the JAX package on a 1×1 grid.

* Tiers: the registry and ``resolve_tier``; each tier's product against
  the f64 one at k = 1 and k = 256, within ``product_bound`` (the tier's
  per-product error plus k·2⁻²⁴ of FP32 accumulation, relative to
  |A|·|B| elementwise), out of place, in place into a view and through
  ``gemm``; K11's plain version at each tier; getrf and posv backward
  error per tier within the JAX package's own bound max(100·n·TIER_EPS,
  1e-4) (tests/test_precision.py); the ``_lo_plan`` contract.
* Mixed solves: ``gesv_mixed``, ``posv_mixed`` and both GMRES-IR forms at
  f32 and f64, n = 96, nb = 32. X agrees with the JAX package's within
  the IR stop bound (‖A·(X − X_jax)‖_max ≤ 2·‖A‖_∞·ε·√n·max(‖X‖_max, 1)),
  ``iters`` within ±1 (the JAX package computes every tier as true f32
  on the CPU, the port really splits), ``info`` equal, and the residual
  bounds of tests/test_mixed_simplified.py and test_precision.py.
* Failures: a non-SPD ``posv_mixed`` and a singular ``gesv_mixed`` give
  the JAX package's ``info``, and the fallback is reported.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as sj  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu.internal import precision as jprec  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import precision as P  # noqa: E402
from slate_tpu_torch.linalg import mixed  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = st.Grid(1, 1, device="cpu")
N, NB = 96, 32


def jgrid():
    return sj.Grid(1, 1, devices=jax.devices()[:1])


def rel_elementwise(out, a, b):
    """max |out − a·b| / (|a|·|b|) against the f64 product."""
    a64, b64 = a.double(), b.double()
    den = a64.abs() @ b64.abs()
    return float(((out.double() - a64 @ b64).abs() / den).max())


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------

def test_tier_registry_and_resolve():
    assert P.TIERS == jprec.TIERS and P.DEFAULT_TIER == jprec.DEFAULT_TIER
    assert P.TIER_EPS == jprec.TIER_EPS
    assert P.resolve_tier(None) == "bf16_6x"
    for t in P.TIERS:
        assert P.resolve_tier({st.Option.TrailingPrecision: t}) == t
    with pytest.raises(st.SlateError):
        P.resolve_tier({st.Option.TrailingPrecision: "fp8"})
    # the rounding is round-to-nearest-even on the bits: bf16 as torch
    # converts, TF32 keeps 11 significant bits; Inf and NaN pass
    x = torch.from_numpy(rand(1, 4096, np.float32, 1)[0] * 1e3)
    x[:3] = torch.tensor([float("inf"), float("nan"), -float("inf")])
    assert torch.equal(P.round_bf16(x)[3:], x[3:].to(torch.bfloat16).float())
    assert torch.isnan(P.round_bf16(x)[1]) and P.round_tf32(x)[0] == x[0]
    assert bool(((P.round_tf32(x)[3:].view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((P.round_tf32(x) - x)[3:] / x[3:]).abs().max()) <= 2 ** -11
    # f64 keeps one plain product whatever the tier
    a = torch.from_numpy(rand(8, 5, np.float64, 2))
    assert torch.equal(P.tier_lhs(a, "bf16_3x"), a)


@pytest.mark.parametrize("tier", P.TIERS)
def test_tier_product_bound(tier):
    for k, seed in ((1, 3), (256, 4)):
        a = torch.from_numpy(rand(64, k, np.float32, seed))
        b = torch.from_numpy(rand(k, 80, np.float32, seed + 10))
        bound = P.product_bound(tier, k)
        # at k = 1 a product alone: within the tier's per-product error
        assert rel_elementwise(P.tier_mm(a, b, tier), a, b) <= (
            P.product_bound(tier, 0) if k == 1 else bound)
        # in place into a view of a wider tensor: the rest is untouched
        wide = torch.zeros(64, 90)
        P.tier_addmm_(wide[:, 5:85], a, b, beta=0.0, tier=tier)
        assert rel_elementwise(wide[:, 5:85], a, b) <= bound
        assert not wide[:, :5].any() and not wide[:, 85:].any()
        c = torch.from_numpy(rand(64, 80, np.float32, seed + 20))
        out = P.tier_addmm(c, a, b, beta=1.0, alpha=-1.0, tier=tier)
        ref = c.double() - a.double() @ b.double()
        den = a.double().abs() @ b.double().abs() + c.double().abs()
        assert float(((out.double() - ref).abs() / den).max()) <= bound
    if tier == "bf16_6x":
        return
    # the tier is really applied: the split and rounded products are not
    # the FP32 one (k = 256 of the last round)
    assert not torch.equal(P.tier_mm(a, b, tier), P.tier_mm(a, b, "bf16_6x"))
    G = st.Matrix.from_dense(a.numpy(), nb=NB, grid=CPU)
    H = st.Matrix.from_dense(b.numpy(), nb=NB, grid=CPU)
    C = st.gemm(1.0, G, H, 0.0, st.Matrix.zeros(64, 80, NB, CPU),
                {st.Option.TrailingPrecision: tier})
    assert torch.equal(C.to_dense(), P.tier_mm(a, b, tier))


@pytest.mark.parametrize("tier", P.TIERS)
def test_rank_k_tail_plain_at_tier(tier):
    for (m, n, k) in ((32, 96, 96), (70, 130, 1)):
        c = torch.from_numpy(rand(m, n, np.float32, m))
        a = torch.from_numpy(rand(m, k, np.float32, k))
        b = torch.from_numpy(rand(k, n, np.float32, n))
        out = K.rank_k_tail(torch.zeros_like(c), a, b, 1.0, 0.0, tier)
        assert rel_elementwise(out, a, b) <= P.product_bound(tier, k)
        full = K.rank_k_tail(c, a, b, -1.0, 1.0, tier)
        ref = c - P.tier_mm(a, b, "mxu_bf16" if tier == "mxu_bf16"
                            else "bf16_6x")
        torch.testing.assert_close(full, ref, rtol=1e-6, atol=1e-5)
    # tile_gemm passes the tier to the kernel
    from slate_tpu_torch.internal.tile_kernels import tile_gemm
    assert torch.equal(tile_gemm(-1.0, a, b, 1.0, c, tier), full)


@pytest.mark.parametrize("tier", P.TIERS)
def test_getrf_posv_tier_backward_error(tier):
    opts = {st.Option.TrailingPrecision: tier}
    bound = max(100.0 * N * P.TIER_EPS[tier], 1e-4)
    a = (rand(N, N, np.float32, 3) + N * np.eye(N)).astype(np.float32)
    s = spd(N, np.float32, 5)
    b = rand(N, 4, np.float32, 4)
    B = st.Matrix.from_dense(b, nb=NB, grid=CPU)
    X, _, _, info = st.gesv(st.Matrix.from_dense(a, nb=NB, grid=CPU), B, opts)
    Y, _, info2 = st.posv(st.HermitianMatrix.from_dense(s, nb=NB, grid=CPU),
                          B, opts)
    assert int(info) == int(info2) == 0
    for m, Z in ((a, X), (s, Y)):
        z = Z.to_dense().numpy().astype(np.float64)
        err = (np.linalg.norm(m @ z - b)
               / (np.linalg.norm(m) * max(np.linalg.norm(z), 1.0) * N))
        assert err < bound, (tier, err)


def test_lo_plan_contract():
    lo, lo_opts = mixed._lo_plan(torch.float32, None)
    assert lo == torch.float32
    assert lo_opts[st.Option.TrailingPrecision] == "bf16_3x"
    _, pinned = mixed._lo_plan(torch.float32,
                               {st.Option.TrailingPrecision: "bf16_6x"})
    assert pinned[st.Option.TrailingPrecision] == "bf16_6x"
    lo64, opts64 = mixed._lo_plan(torch.float64, None)
    assert lo64 == torch.float32 and opts64 is None


# ---------------------------------------------------------------------------
# mixed solves against the JAX package
# ---------------------------------------------------------------------------

SOLVERS = ("gesv_mixed", "posv_mixed", "gesv_mixed_gmres",
           "posv_mixed_gmres")


def problem(solver, dt):
    seed = SOLVERS.index(solver) + (10 if dt == np.float64 else 0)
    if solver.startswith("posv"):
        a = spd(N, dt, seed)
    else:
        a = (rand(N, N, dt, seed) + N * np.eye(N)).astype(dt)
    b = rand(N, 1 if "gmres" in solver else 2, dt, seed + 1)
    return a, b


_JAX = {}


def jax_solve(solver, dt):
    key = (solver, dt)
    if key not in _JAX:
        a, b = problem(solver, dt)
        cls = sj.HermitianMatrix if solver.startswith("posv") else sj.Matrix
        X, iters, info = getattr(sj, solver)(
            cls.from_dense(a, nb=NB, grid=jgrid()),
            sj.Matrix.from_dense(b, nb=NB, grid=jgrid()))
        _JAX[key] = (np.asarray(X.to_dense()), int(iters), int(info))
    return _JAX[key]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("solver", SOLVERS)
def test_mixed_solve_matches_jax(solver, dt):
    a, b = problem(solver, dt)
    cls = st.HermitianMatrix if solver.startswith("posv") else st.Matrix
    X, iters, info = getattr(st, solver)(
        cls.from_dense(a, nb=NB, grid=CPU),
        st.Matrix.from_dense(b, nb=NB, grid=CPU))
    assert not mixed.used_fallback()
    x = X.to_dense().numpy()
    assert x.dtype == dt and x.shape == b.shape
    xj, iters_j, info_j = jax_solve(solver, dt)
    assert int(info) == info_j == 0
    assert abs(iters - iters_j) <= 1 and iters < 30
    a64 = a.astype(np.float64)
    eps = np.finfo(dt).eps
    stop = np.abs(a64).sum(axis=1).max() * eps * np.sqrt(N)
    # both satisfy the stop test, so they agree within twice its bound
    diff = np.abs(a64 @ (x.astype(np.float64) - xj)).max()
    assert diff <= 2 * stop * max(np.abs(x).max(), 1.0), diff
    res = np.linalg.norm(a64 @ x - b) / np.linalg.norm(b)
    if dt == np.float64:
        assert res < 1e-12, res
    else:
        err = (np.linalg.norm(a64 @ x - b)
               / (np.linalg.norm(a64) * max(np.linalg.norm(x), 1.0) * N))
        assert err < 100 * eps, err


def test_mixed_failures_report_info_and_fallback():
    n, nb = 64, 32
    s = spd(n, np.float32, 7)
    s[40, 40] = -50.0                          # not positive definite
    b = rand(n, 2, np.float32, 8)
    out = st.posv_mixed(st.HermitianMatrix.from_dense(s, nb=nb, grid=CPU),
                        st.Matrix.from_dense(b, nb=nb, grid=CPU),
                        {st.Option.MaxIterations: 3})
    assert mixed.used_fallback()
    _, _, info_j = sj.posv_mixed(
        sj.HermitianMatrix.from_dense(s, nb=nb, grid=jgrid()),
        sj.Matrix.from_dense(b, nb=nb, grid=jgrid()),
        {sj.Option.MaxIterations: 3})
    assert int(out[2]) == int(info_j) == 2 and out[1] == 3
    a = (rand(n, n, np.float32, 9) + n * np.eye(n)).astype(np.float32)
    a[:, 5] = 0.0                              # singular
    X, iters, info = st.gesv_mixed(
        st.Matrix.from_dense(a, nb=nb, grid=CPU),
        st.Matrix.from_dense(b, nb=nb, grid=CPU),
        {st.Option.MaxIterations: 3, st.Option.UseFallbackSolver: False})
    assert not mixed.used_fallback() and iters == 3
    _, _, info_j = sj.gesv_mixed(
        sj.Matrix.from_dense(a, nb=nb, grid=jgrid()),
        sj.Matrix.from_dense(b, nb=nb, grid=jgrid()),
        {sj.Option.MaxIterations: 3, sj.Option.UseFallbackSolver: False})
    assert int(info) == int(info_j) > 0
