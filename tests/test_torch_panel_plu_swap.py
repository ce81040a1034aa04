"""The physical-swap panel LU (K10 ``panel_plu_swap``) and the rank-k
tail (K11 ``rank_k_tail``) of the port on the CPU, i.e. their plain
versions, against the JAX package's Pallas kernels ``panel_plu_pallas``
and ``rank_k_tail_pallas`` in interpret mode. The CUDA kernels
themselves are held to their plain versions on the card by
tests/test_torch_gpu.py.

Tolerances: pivots and ``info`` must be equal, bit for bit, and so must
the NaN pattern. Factored values within a relative Frobenius distance of
1e-5 (f32) or 1e-12 (f64): both sides run the same eager column loop,
but XLA's CPU code fuses the rank-1 update's product and difference
where the port rounds each (3.2e-6 measured at [300, 256] in f32). The
rank-k tail computes one product: 1e-6 (f32) and 1e-13 (f64) relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slate_tpu.internal import pallas_kernels as pk  # noqa: E402
from slate_tpu_torch import SlateError  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import tile_kernels as tk  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def tie_panel(h=128, w=128, seed=0):
    """Column 1 ties, after step 0 swaps rows 0 and 3, between position 1
    and position 3 (where row 0 went): the current-position rule takes
    1, a tie broken on the original row index would take 3."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((h, w)).astype(np.float32)
    a[:, 0] = 0.0
    a[0, 0], a[3, 0] = 1.0, 4.0
    a[:, 1] = rng.integers(-1, 2, h)
    a[0, 1], a[1, 1], a[3, 1] = 3.0, 2.0, 4.0
    return a


def both(a):
    """(JAX, port) results of one panel, as numpy arrays and ints."""
    lu, piv, info = pk.panel_plu_pallas(jnp.asarray(a), interpret=True)
    before = dict(K.LAUNCHES)
    lu2, piv2, info2 = K.panel_plu_swap(torch.from_numpy(a))
    assert K.LAUNCHES == before              # the plain version ran
    return ((np.asarray(lu), np.asarray(piv), int(info)),
            (lu2.numpy(), piv2.numpy(), int(info2)))


def assert_same(a, tol):
    (lu, piv, info), (lu2, piv2, info2) = both(a)
    assert np.array_equal(piv, piv2) and info == info2
    nan = np.isnan(lu)
    assert np.array_equal(nan, np.isnan(lu2))
    d = np.where(nan, 0.0, lu - lu2)
    assert np.linalg.norm(d) <= tol * np.linalg.norm(np.where(nan, 0, lu))
    return piv2, info2


@pytest.mark.parametrize("h,w,dt", [(256, 128, np.float32),
                                    (300, 256, np.float32),
                                    (128, 128, np.float32),
                                    (256, 128, np.float64),
                                    (300, 256, np.float64)])
def test_panel_plu_swap_matches_pallas(h, w, dt):
    a = np.random.default_rng(h + w).standard_normal((h, w)).astype(dt)
    piv, info = assert_same(a, TOL[dt])
    assert info == 0 and (piv >= np.arange(w)).all() and (piv < h).all()


def test_panel_plu_swap_tie_goes_to_current_position():
    piv, info = assert_same(tie_panel(), TOL[np.float32])
    assert piv[:2].tolist() == [3, 1] and info == 0


def test_panel_plu_swap_zero_and_nan_columns():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    a[:, 0] = 0.0
    _, info = assert_same(a, TOL[np.float32])
    assert info >= 1
    b = rng.standard_normal((256, 128)).astype(np.float32)
    b[40, 7] = np.nan
    piv, info = assert_same(b, TOL[np.float32])
    # the NaN selects no pivot (piv = h) until the step that reaches its
    # row's position zeroes that row, as the row exchange of a step
    # without a pivot zeroes row j
    assert piv[7] == 256 and (piv[:7] < 256).all() and info >= 1


@pytest.mark.parametrize("m,n,k", [(64, 192, 48), (32, 96, 16)])
@pytest.mark.parametrize("alpha,beta", [(-1.0, 1.0), (0.5, -2.0)])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_rank_k_tail_matches_pallas(m, n, k, alpha, beta, dt):
    rng = np.random.default_rng(m + k)
    c, a, b = (rng.standard_normal(s).astype(dt)
               for s in ((m, n), (m, k), (k, n)))
    ref = np.asarray(pk.rank_k_tail_pallas(
        jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), alpha=alpha,
        beta=beta, interpret=True))
    out = K.rank_k_tail(*(torch.from_numpy(x) for x in (c, a, b)), alpha,
                        beta).numpy()
    tol = 1e-6 if dt == np.float32 else 1e-13
    assert np.linalg.norm(out - ref) <= tol * np.linalg.norm(ref)


def test_dispatch_sites_route_by_capability():
    """tile_gemm takes the rank-k tail for k < 128 (the plain version on
    the CPU) and addmm otherwise; panel_lu_factor takes K10 for widths
    128 and 256, lu_factor_ex for others, and both give the same pivots
    and factors on a window below a stored block."""
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.standard_normal((40, 50)))
    for k in (96, 128):
        a = torch.from_numpy(rng.standard_normal((40, k)))
        b = torch.from_numpy(rng.standard_normal((k, 50)))
        np.testing.assert_allclose(tk.tile_gemm(-1.0, a, b, 1.0, c).numpy(),
                                   (c - a @ b).numpy(), rtol=1e-12,
                                   atol=1e-12)
    assert K.supported("rank_k_tail", torch.float64, 127, "cpu")
    assert not K.supported("rank_k_tail", torch.float64, 128, "cpu")
    assert not K.supported("panel_plu_swap", torch.float32, 64, "cpu")
    assert K.supported("panel_plu_swap", torch.float32, 256, "cuda")
    panel = torch.from_numpy(rng.standard_normal((640, 128)))
    out, piv, info = tk.panel_lu_factor(panel, 256, 600)
    lu, ipiv, _ = torch.linalg.lu_factor_ex(panel[256:600])
    assert torch.equal(piv.long(), ipiv.long() - 1 + 256) and int(info) == 0
    torch.testing.assert_close(out[256:600], lu, rtol=0, atol=1e-12)
    assert torch.equal(out[:256], panel[:256])
    assert torch.equal(out[600:], panel[600:])


def test_panel_lu_factor_nan_column_self_swaps():
    """A pivot past the window (a NaN column) becomes a self-swap, as in
    the JAX package."""
    panel = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (384, 128)).astype(np.float32))
    panel[200, 9] = float("nan")
    _, piv, info = tk.panel_lu_factor(panel, 128, 384)
    _, piv_r, _ = K.panel_plu_swap(panel[128:384])
    none = piv_r == 256
    assert bool(none[9]) and not bool(none[:9].any())
    assert torch.equal(piv[none], 128 + torch.arange(128)[none].int())
    assert torch.equal(piv[~none], piv_r[~none] + 128) and int(info) >= 1


def test_wrappers_refuse_other_devices():
    meta = torch.empty((256, 128), device="meta")
    with pytest.raises(SlateError, match="no kernel for device"):
        K.panel_plu_swap(meta)
    with pytest.raises(SlateError, match="no kernel for device"):
        K.rank_k_tail(meta[:, :96], meta[:, :16], meta[:16, :96])
    with pytest.raises(SlateError, match="dims"):
        K.rank_k_tail(torch.zeros(4, 5), torch.zeros(4, 3),
                      torch.zeros(2, 5))
