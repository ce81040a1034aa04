"""The port's tile kernels (slate_tpu_torch.internal.kernels): their plain
PyTorch versions against the JAX package's Pallas kernels in interpret
mode, the capability table and dispatch. The CUDA kernels themselves are
held to their plain versions on the card by tests/test_torch_gpu.py.

Tolerances: relative Frobenius 1e-5 in f32 and 1e-12 in f64, the bounds
tests/test_panel_kernels.py holds the Pallas kernels to; the two sides
block and sum in different orders on well-conditioned operands.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slate_tpu.internal import pallas_kernels as pk  # noqa: E402
from slate_tpu_torch import SlateError  # noqa: E402
from slate_tpu_torch.internal import kernels as K  # noqa: E402
from slate_tpu_torch.internal import tile_kernels as tk  # noqa: E402
from tests.conftest import rand  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def well_conditioned_lower(n, dtype=np.float64, seed=0, unit=False):
    l = np.tril(rand(n, n, dtype, seed)) / n + np.eye(n, dtype=dtype)
    if unit:
        np.fill_diagonal(l, 1.0)
    return l.astype(dtype)


def spd_tile(nb, dtype=np.float32, seed=0):
    g = np.random.default_rng(seed).standard_normal((nb, nb))
    return (g @ g.T / nb + 2 * np.eye(nb)).astype(dtype)


def rel(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("nb", [128, 256])
def test_potrf_tile_plain_matches_pallas(nb):
    a = spd_tile(nb, seed=nb)
    ref = np.asarray(pk.potrf_tile_pallas(jnp.asarray(a), interpret=True))
    out = K.potrf_tile_plain(torch.from_numpy(a)).numpy()
    assert np.abs(np.triu(out, 1)).max() == 0.0
    assert rel(out, ref) < TOL[np.float32]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_left_lower_plain_matches_pallas(dt, unit):
    n, m = 256, 384
    l = well_conditioned_lower(n, dt, seed=1, unit=unit)
    b = rand(n, m, dt, seed=2)
    ref = np.asarray(pk.trsm_left_lower_pallas(
        jnp.asarray(l), jnp.asarray(b), unit=unit, interpret=True))
    out = K.trsm_left_lower_plain(torch.from_numpy(l), torch.from_numpy(b),
                                  unit).numpy()
    assert rel(out, ref) < TOL[dt]


@pytest.mark.parametrize("m", [8, 1])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_left_lower_plain_matches_pallas_thin(m, dt, unit):
    # the right-hand sides the solves really give K3: nrhs = 8 (and 1)
    # against a 256 tile, as in hesv's L solve
    n = 256
    l = well_conditioned_lower(n, dt, seed=3, unit=unit)
    b = rand(n, m, dt, seed=m)
    ref = np.asarray(pk.trsm_left_lower_pallas(
        jnp.asarray(l), jnp.asarray(b), unit=unit, interpret=True))
    out = K.trsm_left_lower_plain(torch.from_numpy(l), torch.from_numpy(b),
                                  unit).numpy()
    assert rel(out, ref) < TOL[dt]


@pytest.mark.parametrize("m,n", [
    (192, 256),
    (1536, 128),    # a tall panel, as potrf gives it
    (200, 100),     # a width that is not a multiple of K2's 64 (one
                    # Pallas block of 100)
])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_right_lower_t_plain_matches_pallas(m, n, dt, unit):
    # the plain version is K2's algorithm (64-column blocks, each times
    # its doubling inverse's transpose); B2 solves 128-wide blocks by
    # substitution: the same solve, summed in another order (TOL)
    l = well_conditioned_lower(n, dt, seed=4, unit=unit)
    b = rand(m, n, dt, seed=5)
    ref = np.asarray(pk.trsm_right_lower_t_pallas(
        jnp.asarray(l), jnp.asarray(b), unit=unit, interpret=True))
    out = K.trsm_right_lower_t_plain(torch.from_numpy(l), torch.from_numpy(b),
                                     unit).numpy()
    assert rel(out, ref) < TOL[dt]


@pytest.mark.parametrize("n", [1, 37, 200])
def test_plain_versions_ragged_widths(n):
    # widths the Pallas gate refuses (not multiples of 128) but the CUDA
    # kernels take: hold the plain versions to numpy in f64
    a = spd_tile(n, np.float64, seed=n)
    l = K.potrf_tile_plain(torch.from_numpy(a)).numpy()
    assert np.abs(l - np.linalg.cholesky(a)).max() < 1e-12
    b = rand(3 * n + 1, n, np.float64, seed=1)
    x = K.trsm_right_lower_t_plain(torch.from_numpy(l), torch.from_numpy(b))
    assert rel(x.numpy(), np.linalg.solve(l, b.T).T) < 1e-12
    bl = rand(n, 5, np.float64, seed=2)
    y = K.trsm_left_lower_plain(torch.from_numpy(l), torch.from_numpy(bl))
    assert rel(y.numpy(), np.linalg.solve(l, bl)) < 1e-12


@pytest.mark.parametrize("bad", [0, 70, 199])
def test_potrf_tile_failure_reaches_diagonal(bad):
    # a non-positive pivot must show as a non-finite diagonal entry (the
    # finite guard reads only the diagonal) — in its own 64-column block
    # or a later one
    a = spd_tile(200, np.float64, seed=3)
    a[bad, bad] = -50.0
    for fn in (K.potrf_tile_plain, tk.tile_potrf):
        d = torch.diagonal(fn(torch.from_numpy(a))).numpy()
        assert not np.isfinite(d[bad])
        assert np.isfinite(d[:bad]).all()


def test_capability_table():
    f32, f64 = torch.float32, torch.float64
    for kern in ("potrf_tile", "trsm_right_lower_t", "trsm_left_lower"):
        assert K.supported(kern, f32, 1024, "cuda")
        assert K.supported(kern, f32, 200, "cuda")
        assert not K.supported(kern, f32, 1025, "cuda")
        assert not K.supported(kern, f64, 128, "cuda")
        assert not K.supported(kern, torch.bfloat16, 128, "cuda")
        assert K.supported(kern, f64, 128, "cpu")
        assert not K.supported(kern, torch.complex128, 128, "cpu")
        assert not K.supported(kern, f32, 128, "meta")


def test_dispatch_outside_table_goes_to_torch_linalg():
    # complex is outside the table: tile_potrf takes torch.linalg and
    # still reports a failed factor as NaN rather than raising
    a = torch.eye(4, dtype=torch.complex128)
    assert torch.allclose(tk.tile_potrf(a), a)
    a[2, 2] = -1
    assert not torch.isfinite(torch.diagonal(tk.tile_potrf(a))).all()
    # bf16 tiles factor in f32 through the plain version and cast back
    s = torch.from_numpy(spd_tile(64, np.float32)).to(torch.bfloat16)
    assert tk.tile_potrf(s).dtype == torch.bfloat16
    l = well_conditioned_lower(64, np.float64, seed=7)
    b = rand(64, 9, np.float64, seed=8)
    y = tk.tile_trsm_left_lower(torch.from_numpy(l), torch.from_numpy(b),
                                trans=True)
    assert rel(y.numpy(), np.linalg.solve(l.T, b)) < 1e-12


def test_wrappers_raise_on_a_device_without_kernels():
    a = torch.empty(8, 8, device="meta")
    with pytest.raises(SlateError):
        K.potrf_tile(a)
    with pytest.raises(SlateError):
        K.trsm_right_lower_t(a, a)
    with pytest.raises(SlateError):
        K.trsm_left_lower(a, a)


def test_launch_counters_stay_zero_on_cpu():
    K.reset_launches()
    a = torch.from_numpy(spd_tile(128))
    K.potrf_tile(a)
    K.trsm_right_lower_t(a, a)
    K.trsm_left_lower(a, a)
    buf = torch.randn(8, 128, 16)
    K.panel_plu(buf, torch.ones(128), 0, name="plu_call_folded_block")
    K.panel_unfold(K.panel_fold(a, 8, name="fold_panel"),
                   name="unfold_panel")
    K.panel_qr(a.clone(), 0)
    K.lu_nopiv_tile(a)
    assert {"potrf_tile", "trsm_right_lower_t", "trsm_left_lower",
            "qr_call", "lu_nopiv_tile"} <= set(K.LAUNCHES)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


def test_ready_flags_restart_before_the_epoch_wraps(monkeypatch):
    """The flag buffer of the dataflow kernels (K1, K3): one epoch more
    per launch; at EPOCH_RESTART the buffer is zeroed and the epochs start
    again at 1, so every flag stays behind the next epoch in the kernels'
    signed 32-bit order; under CUDA graph capture the call raises."""
    class Stream:
        cuda_stream = 7

    def behind(flags, epoch):
        return bool((((flags.long() - epoch) & 0xFFFFFFFF) >= 1 << 31).all())

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(K, "_READY", {})
    cpu = torch.device("cpu")
    f1, e1 = K._ready_flags(cpu, 10)
    f2, e2 = K._ready_flags(cpu, 10)
    assert f1 is f2 and f1.numel() >= 10 and (e1, e2) == (1, 2)
    # a wide launch long ago left its epoch in slots the thin ones skip
    f1[-1] = 5
    K._READY[(None, 7)][1] = K.EPOCH_RESTART - 1
    _, e = K._ready_flags(cpu, 10)
    assert e == K.EPOCH_RESTART and int(f1[-1]) == 5
    f3, e = K._ready_flags(cpu, 10)
    assert f3 is f1 and e == 1 and int(f3.abs().max()) == 0
    assert behind(f3, e)
    # a launch with more tasks gets a new buffer, zeroed, from epoch 1
    f4, e = K._ready_flags(cpu, 5000)
    assert f4.numel() >= 5000 and e == 1 and behind(f4, e)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(SlateError, match="CUDA graph"):
        K._ready_flags(cpu, 10)


@pytest.mark.parametrize("scratch,table", [("_plu_scratch", "_PLU_SCRATCH"),
                                           ("_qr_scratch", "_QR_SCRATCH")])
def test_tagged_scratch_zeroed_before_the_epoch_wraps(monkeypatch, scratch,
                                                      table):
    """The scratch of the tagged-word kernels (K4, K6): one buffer per
    stream sized for one CTA per SM, one epoch more per launch; at the
    last epoch the next launch finds the buffer zeroed and epoch 1, so no
    word of an earlier launch carries its tag; under CUDA graph capture
    the call raises."""
    class Stream:
        cuda_stream = 7

    class Props:
        multi_processor_count = 3

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(K, table, {})
    get = getattr(K, scratch)
    cpu = torch.device("cpu")
    w1, ctas, e1 = get(cpu)
    w2, _, e2 = get(cpu)
    assert w1 is w2 and ctas == 3 and (e1, e2) == (1, 2)
    assert w1.dtype == torch.int64 and w1.numel() >= 2 * ctas * K.W
    w1.fill_(9)
    getattr(K, table)[(None, 7)][2] = (K._QR_EPOCHS if scratch == "_qr_scratch"
                                       else K._PLU_EPOCHS)
    w3, _, e3 = get(cpu)
    assert w3 is w1 and e3 == 1 and int(w3.abs().max()) == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(SlateError, match="CUDA graph"):
        get(cpu)
