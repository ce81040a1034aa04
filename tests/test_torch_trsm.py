"""The port's left triangular solve (``trsm(Side.Left, …)``) against the
JAX package on a 1×1 grid, on the CPU, with B.n not a multiple of nb:
only B's real columns are solved, so the tile kernel K3 (its plain
version here) sees each block row as [nb, B.n], and the column padding
of the result stays zero.

Tolerance: X within 1e-4·max|X| in f32 — the two sides block and sum in
different orders, on a triangle with κ ≤ 5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu as jst  # noqa: E402
import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.ops import blas  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

CPU = pst.Grid(1, 1, device="cpu")


@pytest.mark.parametrize("lower,unit", [(True, False), (True, True),
                                        (False, False)])
def test_trsm_left_solves_only_the_real_columns(grid11, monkeypatch, lower,
                                                unit):
    n, nb, k = 300, 128, 70
    t = (np.tril(rand(n, n, np.float64, seed=1)) / n + np.eye(n)).astype(
        np.float32)
    t = t if lower else t.T.copy()
    b = rand(n, k, np.float32, seed=2)
    shapes = []
    real = blas.tile_trsm_left_lower

    def spy(l, x, **kw):
        shapes.append(tuple(x.shape))
        return real(l, x, **kw)

    monkeypatch.setattr(blas, "tile_trsm_left_lower", spy)
    out = []
    for pkg, grid in ((jst, grid11), (pst, CPU)):
        T = pkg.TriangularMatrix.from_dense(
            t, nb=nb, grid=grid,
            uplo=pkg.Uplo.Lower if lower else pkg.Uplo.Upper,
            diag=pkg.Diag.Unit if unit else pkg.Diag.NonUnit)
        out.append(pkg.trsm(pkg.Side.Left, 2.0, T,
                            pkg.Matrix.from_dense(b, nb=nb, grid=grid)))
    x_jax = np.asarray(out[0].to_dense())
    X = out[1]
    x = X.to_dense().numpy()
    assert x.shape == (n, k)
    assert np.abs(x - x_jax).max() < 1e-4 * np.abs(x_jax).max()
    # the padding of the tiles beyond B.n (and beyond B.m) is exactly zero
    full = X.data[0, 0].permute(0, 2, 1, 3).reshape(X.mtl * nb, X.ntl * nb)
    assert float(full[:, k:].abs().max()) == 0.0
    assert float(full[n:, :].abs().max()) == 0.0
    assert shapes == ([(nb, k)] * -(-n // nb) if lower else [])
