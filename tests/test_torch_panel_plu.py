"""The LU panel kernels of the port (K4 ``panel_plu``, K5 ``panel_fold`` /
``panel_unfold``) through the wrappers of
``slate_tpu_torch.internal.panel_plu``, on the CPU (their plain
versions), against the JAX package's Pallas kernels in interpret mode.
The CUDA kernels themselves are held to their plain versions on the card
by tests/test_torch_gpu.py.

Tolerances: pivots, mask and ``info`` must be equal; factored values
within atol 1e-4, the bound tests/test_getrf.py::test_plu_subpanel_folded_twin
holds the JAX package's flat and folded kernels to — the JAX kernel
updates in IB=8 strips with an inverse, the port eagerly column by
column, so values differ by rounding only. The transposes move bits and
must be bitwise equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slate_tpu.internal import panel_plu as jpp  # noqa: E402
from slate_tpu_torch import SlateError  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import panel_plu as pp  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

ATOL = 1e-4
CASES = [(h, fold) for h in (384, 1024, 2048) for fold in (False, True)]
ZERO_COL = 5


def subpanel(h, seed):
    """A random [h, W] subpanel with one zero column and a mask with a
    scattered fifth of the rows already eliminated."""
    rng = np.random.default_rng(seed)
    sub = rng.standard_normal((h, pp.W)).astype(np.float32)
    sub[:, ZERO_COL] = 0.0
    act = np.ones(h, np.float32)
    act[rng.choice(h, h // 5, replace=False)] = 0.0
    return sub, act


def jax_subpanel(sub, act, fold):
    out, piv, a, info = jpp.plu_subpanel(jnp.asarray(sub), jnp.asarray(act),
                                         interpret=True, fold=fold)
    return (np.asarray(out), np.asarray(piv), np.asarray(a),
            int(np.asarray(info)))


@pytest.fixture(scope="module")
def jax_refs():
    """One JAX run per case, shared by the tests of this module."""
    return {(h, fold): jax_subpanel(*subpanel(h, h), fold)
            for h, fold in CASES}


def port_subpanel(sub, act, fold):
    out, piv, a, info = pp.plu_subpanel(torch.from_numpy(sub),
                                        torch.from_numpy(act), fold=fold)
    return out.numpy(), piv.numpy(), a.numpy(), int(info)


@pytest.mark.parametrize("h,fold", CASES)
def test_plu_subpanel_matches_jax(jax_refs, h, fold):
    sub, act = subpanel(h, h)
    before = dict(K.LAUNCHES)
    out, piv, a, info = port_subpanel(sub, act, fold)
    jout, jpiv, ja, jinfo = jax_refs[(h, fold)]
    assert np.array_equal(piv, jpiv)
    assert np.array_equal(a, ja)
    assert info == jinfo == 1                 # the zero column
    np.testing.assert_allclose(out, jout, rtol=0, atol=ATOL)
    # rows inactive on entry are untouched
    assert np.array_equal(out[act == 0], sub[act == 0])
    # the plain versions ran: no card launch was counted
    assert K.LAUNCHES == before


def test_plu_call_folded_block_in_place_matches_jax():
    """Two consecutive blocks of one folded [8, 256, 128] panel, the
    second factored against the mask the first left, in place."""
    h, nb = 1024, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((h, nb)).astype(np.float32)
    act = np.ones(h, np.float32)
    act[rng.choice(h, 100, replace=False)] = 0.0
    jf = jpp.fold_panel(jnp.asarray(x), interpret=True)
    ja = jnp.asarray(act).reshape(8, h // 8)
    pf = pp.fold_panel(torch.from_numpy(x))
    pa = torch.from_numpy(act.copy()).view(8, h // 8)
    for s in (0, 1):
        jf, ja, jpiv, jinfo = jpp.plu_call_folded_block(jf, ja, s,
                                                        interpret=True)
        piv, info = pp.plu_call_folded_block(pf, pa, s)
        assert np.array_equal(piv.numpy(), np.asarray(jpiv)[0])
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        assert int(info) == int(np.asarray(jinfo)[0, 0])
        np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=0,
                                   atol=ATOL)


def test_plu_subpanel_nan_column():
    """A NaN in an active row: JAX's max is NaN, ``score >= mx`` holds
    nowhere, and every column from there on selects no row (piv = h),
    keeps the mask and counts no zero pivot. The port does the same,
    turns the active rows NaN from that column on, and, unlike the JAX
    kernel, writes nothing into the inactive rows."""
    h = 384
    sub, act = subpanel(h, 11)
    j0 = 9
    live = np.flatnonzero(act)
    sub[live[7], j0] = np.nan
    out, piv, a, info = port_subpanel(sub, act, False)
    jout, jpiv, ja, jinfo = jax_subpanel(sub, act, False)
    assert np.array_equal(piv, jpiv)
    assert (piv[j0:] == h).all() and (piv[:j0] < h).all()
    assert np.array_equal(a, ja) and info == jinfo
    nan = np.isnan(out)
    assert nan[a > 0][:, j0:].all() and not nan[:, :j0].any()
    assert (np.isnan(jout) | ~nan).all()      # NaN in the port ⇒ in JAX
    assert np.array_equal(out[act == 0], sub[act == 0])


def _window(h, w, seed):
    """A [h, w] column window of a wider matrix (row stride > w)."""
    big = np.random.default_rng(seed).standard_normal(
        (h + 64, w + 200)).astype(np.float32)
    return big, big[64:, 128:128 + w]


@pytest.mark.parametrize("kernel,shape", [
    ("fold_panel", (1024, 256)),
    ("transpose_fold", (2048, 128)),
    ("transpose_tiled", (384, 128)),
    ("transpose_tiled", (128, 384)),
])
def test_fold_kernels_bitwise(kernel, shape):
    big, win = _window(*shape, seed=len(kernel))
    ref = np.asarray(getattr(jpp, kernel)(jnp.asarray(win), interpret=True))
    # the port reads the strided window of the wider matrix in place
    twin = torch.from_numpy(big)[64:, 128:128 + shape[1]]
    out = getattr(pp, kernel)(twin).numpy()
    assert out.shape == ref.shape and np.array_equal(out, ref)


@pytest.mark.parametrize("kernel,shape", [
    ("unfold_panel", (8, 256, 128)),
    ("unfold_transpose", (8, 128, 256)),
])
def test_unfold_kernels_bitwise(kernel, shape):
    xf = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ref = np.asarray(getattr(jpp, kernel)(jnp.asarray(xf), interpret=True))
    out = getattr(pp, kernel)(torch.from_numpy(xf)).numpy()
    assert out.shape == ref.shape and np.array_equal(out, ref)
    # and the round trip through the fold is the identity
    back = pp.fold_panel(torch.from_numpy(out)) if kernel == "unfold_panel" \
        else pp.transpose_fold(torch.from_numpy(out))
    assert np.array_equal(back.numpy(), xf)


@pytest.mark.parametrize("kernel,shape", [
    ("fold_panel", (1024, 256)),
    ("unfold_panel", (8, 256, 128)),
    ("transpose_tiled", (256, 384)),
])
def test_transposes_into_a_window_match_jax(kernel, shape):
    """K5's destination form (``panel_fold``/``panel_unfold`` with
    ``out``), which the LU driver writes panels back with: the
    result lands in a window of a wider tensor (guard entries on both
    sides of it), equals the JAX kernel in interpret mode bit for bit,
    and every entry outside the window keeps its bits."""
    x = np.random.default_rng(len(shape) + shape[-1]).standard_normal(
        shape).astype(np.float32)
    ref = np.asarray(getattr(jpp, kernel)(jnp.asarray(x), interpret=True))
    if ref.ndim == 3:                        # [8, nb, L]: a middle window
        big = torch.randn(8, ref.shape[1] + 24, ref.shape[2])
        sl = (slice(None), slice(16, 16 + ref.shape[1]), slice(None))
    else:                                    # [h, w]: a column window
        big = torch.randn(ref.shape[0] + 5, ref.shape[1] + 200)
        sl = (slice(5, None), slice(128, 128 + ref.shape[1]))
    keep = big.clone()
    win = big[sl]
    if kernel == "fold_panel":
        out = K.panel_fold(torch.from_numpy(x), 8, name=kernel, out=win)
    else:
        out = getattr(pp, kernel)(torch.from_numpy(x), out=win)
    assert out.data_ptr() == win.data_ptr()
    assert np.array_equal(big[sl].numpy(), ref)
    big[sl] = keep[sl]
    assert torch.equal(big, keep)


def test_transpose_destination_is_checked():
    """A destination that overlaps the source, has a column stride other
    than 1, rows that share memory, another shape, dtype or device
    raises; the source is left as it was."""
    buf = torch.randn(8, 128, 64)
    flat = torch.randn(512, 300)
    keep = buf.clone()
    bad = [
        buf.view(-1)[:512 * 128].view(512, 128),          # overlaps xf
        flat[:, :256:2],                                  # column stride 2
        torch.randn(512 * 128).as_strided((512, 128), (64, 1)),  # rows share
        flat[:, :127],                                    # shape
        torch.zeros(512, 128, dtype=torch.float64),       # dtype
        torch.zeros(512, 128, device="meta"),             # device
    ]
    for out in bad:
        with pytest.raises(SlateError):
            K.panel_unfold(buf, name="unfold_panel", out=out)
    assert torch.equal(buf, keep)
    big = torch.randn(600, 700)
    x = big[:512, :128]
    with pytest.raises(SlateError, match="overlaps"):
        K.panel_fold(x, 1, name="transpose_tiled",
                     out=big[None, :128, 64:576])   # shares x[:128, 64:]
    with pytest.raises(SlateError):
        pp.transpose_tiled(x, out=torch.zeros(512, 128).mT)  # column stride
    assert torch.equal(big[:512, :128], x)


def test_plu_panel_above_h_max_needs_the_tournament(monkeypatch):
    """Above H_MAX (shrunk to 256 in both packages) plu_panel runs the
    CALU tournament: the JAX package's pivots, mask and info, its values
    within ATOL."""
    monkeypatch.setattr(pp, "H_MAX", 256)
    monkeypatch.setattr(jpp, "H_MAX", 256)
    sub, act = subpanel(512, 1)
    jout, jpiv, jact, jinfo = (np.asarray(x) for x in jpp.plu_panel(
        jnp.asarray(sub), jnp.asarray(act), interpret=True))
    out, piv, a, info = pp.plu_panel(torch.from_numpy(sub),
                                     torch.from_numpy(act))
    assert np.array_equal(piv.numpy(), jpiv)
    assert np.array_equal(a.numpy(), jact)
    assert int(info) == int(jinfo) == 1               # the zero column
    assert np.abs(out.numpy() - jout).max() < ATOL


def test_panel_kernel_contracts():
    t = torch.zeros(256, 128)
    with pytest.raises(SlateError):
        pp.plu_subpanel(torch.zeros(256, 64), torch.ones(256))
    with pytest.raises(SlateError):
        K.panel_plu(torch.zeros(8, 128, 32), torch.ones(8, 32), 1,
                    name="plu_call_folded_block")      # no block 1
    with pytest.raises(SlateError):
        K.panel_fold(t, 8, name="not_a_kernel")
    with pytest.raises(SlateError):
        K.panel_fold(t.to("meta"), 8, name="fold_panel")
    assert K.supported("panel_plu", torch.float32, 16384, "cuda")
    assert not K.supported("panel_plu", torch.float32, 16385, "cuda")
    assert not K.supported("panel_plu", torch.float64, 1024, "cuda")
    assert K.supported("panel_transpose", torch.float64, 1024, "cpu")
    assert set(K.PLU_NAMES + K.TRANSPOSE_NAMES) <= set(K.LAUNCHES)
