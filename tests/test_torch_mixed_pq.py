"""The port's mixed-precision solves on p×q grids of virtual ranks
against the JAX package's on meshes of virtual CPU devices:
``gesv_mixed``, ``posv_mixed`` and both GMRES-IR forms.

The same numpy inputs go into both packages: n = 70 with nb = 8 (9
tiles, both edges ragged), float64 on 2×4 and complex128 on 2×2, so the
low leg factors in float32 / complex64 on the p×q ``getrf``/``potrf``
at full FP32 in both. ``iters`` and ``info`` equal the JAX package's, no
fallback is taken, and X is within 1e-10 relative of the JAX package's
(both stop at the IR bound ‖A‖_∞·ε·√n·max(‖X‖_max, 1); the low leg's
rounding differs by the products' summation orders only) and of the
numpy solve. A non-SPD ``posv_mixed`` on 2×4 stalls, reports the
fallback and ``info``, as the JAX package does on a 1×1 grid; on its
2×4 mesh the JAX package returns a NaN X after 0 iterations without the
fallback (a NaN factor passes its stop test there), which the port does
not copy (ROADMAP §C). Each JAX reference is computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.linalg import mixed  # noqa: E402
from tests.conftest import rand, spd  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

N, NB = 70, 8
CASES = [((2, 4), np.float64), ((2, 2), np.complex128)]
IDS = ["2x4-f64", "2x2-c128"]
SOLVERS = ("gesv_mixed", "posv_mixed", "gesv_mixed_gmres",
           "posv_mixed_gmres")


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def pgrid(p, q):
    return pst.Grid(p, q, device="cpu")


def problem(solver, dt):
    seed = SOLVERS.index(solver)
    if solver.startswith("posv"):
        a = spd(N, dt, seed)
    else:
        a = (rand(N, N, dt, seed) + N * np.eye(N)).astype(dt)
    return a, rand(N, 1 if "gmres" in solver else 3, dt, seed + 1)


def solve(pkg, grid, solver, dt, opts=None, a=None):
    a0, b = problem(solver, dt)
    a = a0 if a is None else a
    cls = pkg.HermitianMatrix if solver.startswith("posv") else pkg.Matrix
    X, iters, info = getattr(pkg, solver)(
        cls.from_dense(a, nb=NB, grid=grid),
        pkg.Matrix.from_dense(b, nb=NB, grid=grid), opts)
    return X, int(iters), int(info)


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (p, q), dt in CASES:
        for s in SOLVERS:
            X, iters, info = solve(jst, jgrid(p, q), s, dt)
            out[(p, q), s] = (np.asarray(X.to_dense()), iters, info)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_mixed_pq_matches_jax(jax_ref, case, solver):
    (p, q), dt = case
    X, iters, info = solve(pst, pgrid(p, q), solver, dt)
    assert not mixed.used_fallback()
    assert X.grid == pgrid(p, q)
    x = X.to_dense().numpy()
    xj, iters_j, info_j = jax_ref[(p, q), solver]
    assert x.dtype == dt and x.shape == xj.shape
    assert info == info_j == 0 and iters == iters_j and iters < 30
    assert np.linalg.norm(x - xj) <= 1e-10 * np.linalg.norm(xj)
    a, b = problem(solver, dt)
    assert np.linalg.norm(x - np.linalg.solve(a, b)) <= 1e-10 * \
        np.linalg.norm(xj)


def test_mixed_pq_fallback_reports_info():
    """A non-SPD matrix: IR stalls, the full-precision fallback runs and
    ``info`` is the low leg's, as in the JAX package on one rank."""
    a, _ = problem("posv_mixed", np.float64)
    a = a.copy()
    a[40, 40] = -50.0
    opts = {pst.Option.MaxIterations: 3}
    _, iters, info = solve(pst, pgrid(2, 4), "posv_mixed", np.float64, opts,
                           a)
    assert mixed.used_fallback() and iters == 3
    _, iters_j, info_j = solve(jst, jgrid(1, 1), "posv_mixed", np.float64,
                               {jst.Option.MaxIterations: 3}, a)
    assert info == info_j == 40 // NB + 1 and iters == iters_j
