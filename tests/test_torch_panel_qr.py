"""The QR panel kernel of the port (K6 ``panel_qr``) through the wrappers
of ``slate_tpu_torch.internal.panel_qr``, on the CPU (its plain
version), against the JAX package's Pallas kernel in interpret mode. The
CUDA kernel itself is held to its plain version on the card by
tests/test_torch_gpu.py.

Tolerance: relative Frobenius 1e-5 on the factored subpanel (R and V
together) and on tau, in f32. The JAX kernel applies its reflectors in
IB=8 strips through a compact-WY update and the port's eagerly, one at a
time, so the two round differently; either is ~1e-7 from the f64
factors on these Gaussian inputs. Rows above d0 must be bitwise
unchanged, and the exact zero columns give τ = 0 on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slate_tpu.internal import panel_qr as jpq  # noqa: E402
from slate_tpu_torch import SlateError  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import panel_qr as pq  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

TOL = 1e-5
CASES = [(h, d0) for h in (384, 1024) for d0 in (0, 128)]
ZERO_COL = 5          # zero throughout: τ = 0, β = 0
NEG_COL = 0           # zero below the diagonal, α < 0: τ = 0, β = α
# the JAX functions under jit: one trace per shape, d0 a traced scalar
JAX_SUBPANEL = jax.jit(jpq.qr_subpanel, static_argnames="interpret")
JAX_BLOCKED = jax.jit(jpq.qr_panel_blocked, static_argnames="interpret")


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def subpanel(h, d0, seed):
    rng = np.random.default_rng(seed)
    sub = rng.standard_normal((h, pq.W)).astype(np.float32)
    sub[:, ZERO_COL] = 0.0
    sub[d0 + NEG_COL + 1:, NEG_COL] = 0.0
    sub[d0 + NEG_COL, NEG_COL] = -2.5
    return sub


@pytest.fixture(scope="module")
def jax_refs():
    """One JAX run per case, shared by the tests of this module."""
    out = {}
    for h, d0 in CASES:
        f, tau = JAX_SUBPANEL(jnp.asarray(subpanel(h, d0, h + d0)), d0,
                              interpret=True)
        out[(h, d0)] = (np.asarray(f), np.asarray(tau))
    return out


@pytest.mark.parametrize("h,d0", CASES)
def test_qr_subpanel_matches_jax(jax_refs, h, d0):
    sub = subpanel(h, d0, h + d0)
    before = dict(K.LAUNCHES)
    t = torch.from_numpy(sub.copy())
    out, tau = pq.qr_subpanel(t, d0)
    assert out.data_ptr() == t.data_ptr()           # in place
    jf, jtau = jax_refs[(h, d0)]
    out, tau = out.numpy(), tau.numpy()
    assert rel(out, jf) < TOL and rel(tau, jtau) < TOL
    assert np.array_equal(out[:d0], sub[:d0])
    assert tau[ZERO_COL] == jtau[ZERO_COL] == 0.0
    assert out[d0 + ZERO_COL, ZERO_COL] == 0.0
    assert tau[NEG_COL] == jtau[NEG_COL] == 0.0
    assert out[d0 + NEG_COL, NEG_COL] == jf[d0 + NEG_COL, NEG_COL] == -2.5
    # the plain version ran: no card launch was counted
    assert K.LAUNCHES == before


def test_qr_subpanel_f64_is_householder_qr():
    """In f64 the plain version is LAPACK's Householder QR: R equals
    numpy's up to the sign of each row, and Q·R rebuilds the rows from
    d0."""
    h, d0 = 300, 40
    x = np.random.default_rng(1).standard_normal((h, pq.W))
    t = torch.from_numpy(x.copy())
    _, tau = pq.qr_subpanel(t, d0)
    f = t.numpy()
    r = np.triu(f[d0:d0 + pq.W])
    assert np.allclose(np.abs(r), np.abs(np.linalg.qr(x[d0:], mode="r")),
                       atol=1e-12)
    q = np.eye(h - d0)
    for j in reversed(range(pq.W)):
        v = np.zeros(h - d0)
        v[j], v[j + 1:] = 1.0, f[d0 + j + 1:, j]
        q -= tau[j].item() * np.outer(v, v @ q)
    assert np.abs(q[:, :pq.W] @ r - x[d0:]).max() < 1e-12


def test_qr_panel_blocked_matches_jax():
    """Two subpanels of a [640, 256] panel with the compact-WY update
    between them, in place."""
    pan = np.random.default_rng(3).standard_normal((640, 256)).astype(
        np.float32)
    jf, jtau = JAX_BLOCKED(jnp.asarray(pan), interpret=True)
    t = torch.from_numpy(pan.copy())
    out, taus = pq.qr_panel_blocked(t)
    assert out.data_ptr() == t.data_ptr() and taus.shape == (256,)
    assert rel(out.numpy(), np.asarray(jf)) < TOL
    assert rel(taus.numpy(), np.asarray(jtau)) < TOL


def test_panel_qr_contracts():
    with pytest.raises(SlateError):
        pq.qr_subpanel(torch.zeros(256, 64), 0)             # width
    with pytest.raises(SlateError):
        pq.qr_subpanel(torch.zeros(pq.H_MAX + 8, pq.W), 0)  # height
    with pytest.raises(SlateError):
        K.panel_qr(torch.zeros(256, pq.W), 256)             # no diagonal
    with pytest.raises(SlateError):
        K.panel_qr(torch.zeros(256, pq.W, device="meta"), 0)
    assert K.supported("panel_qr", torch.float32, 16384, "cuda")
    assert not K.supported("panel_qr", torch.float32, 16385, "cuda")
    assert not K.supported("panel_qr", torch.float64, 1024, "cuda")
    assert K.supported("panel_qr", torch.float64, 1024, "cpu")
    assert "qr_call" in K.LAUNCHES
