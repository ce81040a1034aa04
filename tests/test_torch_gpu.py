"""Tests of the port that need a CUDA card: each CUDA kernel against its
plain PyTorch version, and the Cholesky solve on the card against the
same solve on the CPU. They skip without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: relative Frobenius 1e-5 in f32 (the kernels and the plain
versions sum in different orders on well-conditioned operands).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rel(x, ref):
    x, ref = x.double().cpu(), ref.double().cpu()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("nb", [1024, 200, 37, 1])
def test_cuda_kernels_match_plain(cuda, nb):
    gen = torch.Generator(device=cuda).manual_seed(nb)
    g = torch.randn(nb, nb, generator=gen, device=cuda)
    a = g @ g.T / nb + torch.eye(nb, device=cuda)
    before = dict(K.LAUNCHES)
    l = K.potrf_tile(a)
    assert rel(l, K.potrf_tile_plain(a)) < TOL
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    b = torch.randn(3 * nb + 5, nb, generator=gen, device=cuda)
    for unit in (False, True):
        assert rel(K.trsm_right_lower_t(l, b, unit),
                   K.trsm_right_lower_t_plain(l, b, unit)) < TOL
    bl = torch.randn(nb, 70, generator=gen, device=cuda)
    for unit in (False, True):
        assert rel(K.trsm_left_lower(l, bl, unit),
                   K.trsm_left_lower_plain(l, bl, unit)) < TOL
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"potrf_tile": before["potrf_tile"] + 1,
                          "trsm_right_lower_t":
                              before["trsm_right_lower_t"] + 2,
                          "trsm_left_lower": before["trsm_left_lower"] + 2}


def test_cuda_kernel_reports_a_failed_pivot(cuda):
    a = torch.eye(200, device=cuda)
    a[70, 70] = -1.0
    d = torch.diagonal(K.potrf_tile(a)).cpu()
    assert not torch.isfinite(d[70]) and torch.isfinite(d[:70]).all()


@pytest.mark.parametrize("upper", [False, True])
def test_posv_on_card_matches_cpu(cuda, upper):
    n, nb = 300, 128
    rng = np.random.default_rng(5)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    uplo = st.Uplo.Upper if upper else st.Uplo.Lower
    xs = []
    for dev in (cuda, "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, _, info = st.posv(
            st.HermitianMatrix.from_dense(a, nb=nb, grid=grid, uplo=uplo),
            st.Matrix.from_dense(b, nb=nb, grid=grid))
        assert int(info) == 0
        xs.append(X.to_dense())
    assert rel(xs[0], xs[1]) < 1e-4
