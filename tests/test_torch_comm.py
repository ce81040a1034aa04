"""The port's collectives (``slate_tpu_torch/internal/comm.py``) against
the JAX package's inside ``jax.shard_map``, on the CPU.

The same numpy array [p, q, ...] goes to both: the JAX side shards it
over the grid's mesh (each device gets its [1, 1, ...] block), the port
takes it whole, ``x[r, c]`` being rank (r, c)'s. Data movement
(broadcasts, shifts, gathers) must be equal; sums within 1e-12 in
float64, as XLA and torch sum in their own orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import slate_tpu as jst  # noqa: E402
from slate_tpu.grid import AXIS_P, AXIS_Q  # noqa: E402
from slate_tpu.internal import comm as jcomm  # noqa: E402
from slate_tpu_torch.internal import comm  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

GRIDS = [(2, 4), (2, 2), (1, 4), (4, 1)]


def jgrid(p, q):
    return jst.Grid(p, q, devices=jax.devices()[:p * q])


def jrun(p, q, body, x, n_out=1):
    """``body`` on each device's [...] block of x [p, q, ...]; its
    result (an array, or a tuple of ``n_out`` of them) comes back
    rank-stacked. One compile per call, so a test puts its collectives
    into one body."""
    g = jgrid(p, q)

    def wrapped(a):
        out = body(a[0, 0])
        if n_out > 1:
            return tuple(o[None, None] for o in out)
        return out[None, None]

    spec = (tuple(P(AXIS_P, AXIS_Q) for _ in range(n_out)) if n_out > 1
            else P(AXIS_P, AXIS_Q))
    out = jax.jit(jax.shard_map(
        wrapped, mesh=g.mesh, in_specs=(P(AXIS_P, AXIS_Q),),
        out_specs=spec, check_vma=False))(jnp.asarray(x))
    if n_out > 1:
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def x_of(p, q, *shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (p, q) + shape).astype(np.float64)


def port(fn, x, *a):
    return fn(torch.from_numpy(x), *a).numpy()


@pytest.mark.parametrize("p,q", GRIDS)
def test_broadcasts_and_shifts_equal(p, q):
    x = x_of(p, q, 3, 2, seed=p * 10 + q)
    oc, orow = q - 1, p - 1
    want = jrun(p, q, lambda a: (
        jcomm.bcast_from_col(a, oc), jcomm.bcast_from_row(a, orow),
        jcomm.bcast_from_owner(a, orow, oc),
        jcomm.rotate_from_next(a, AXIS_Q, q),
        jcomm.rotate_from_next(a, AXIS_P, p),
        jnp.stack(jcomm.coords()).astype(a.dtype) + 0 * a[:2, 0]), x,
        n_out=6)
    got = (port(comm.bcast_from_col, x, oc),
           port(comm.bcast_from_row, x, orow),
           port(comm.bcast_from_owner, x, orow, oc),
           port(comm.rotate_from_next, x, "q", q),
           port(comm.rotate_from_next, x, "p", p))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    r, c = comm.coords(p, q)
    jr = want[-1]
    assert (jr[:, :, 0] == r.numpy()).all()
    assert (jr[:, :, 1] == c.numpy()).all()


@pytest.mark.parametrize("p,q", GRIDS)
def test_reductions_within_1e12(p, q):
    x = x_of(p, q, 4 * p * q, 3, seed=7 + p)
    pairs = [(comm.psum_rows, jcomm.psum_rows),
             (comm.psum_cols, jcomm.psum_cols),
             (comm.psum_all, jcomm.psum_all),
             (comm.psum_scatter_cols, jcomm.psum_scatter_cols)]
    # and the maximum down the rows
    want = jrun(p, q, lambda a: tuple(j(a) for _, j in pairs) + (
        jax.lax.pmax(a, AXIS_P),), x, n_out=len(pairs) + 1)
    got = [port(f, x) for f, _ in pairs]
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert np.abs(g_ - w_).max() < 1e-12
    np.testing.assert_array_equal(port(comm.pmax_rows, x), want[-1])


@pytest.mark.parametrize("p,q", GRIDS)
def test_gathers_equal(p, q):
    x = x_of(p, q, 3, 2, 2, seed=3)
    oc = q // 2
    want = jrun(p, q, lambda a: (
        jcomm.allgather_cyclic(a, p, AXIS_P),
        jcomm.allgather_cyclic(a, q, AXIS_Q),
        jcomm.allgather_panel_rows(a, p, oc)), x, n_out=3)
    got = (port(comm.allgather_cyclic, x, p, "p"),
           port(comm.allgather_cyclic, x, q, "q"),
           port(comm.allgather_panel_rows, x, p, oc))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_systolic_ring_equal(double_buffer):
    """The port's ring (one schedule) against the JAX engine with and
    without its double buffering."""
    p, q = 2, 4
    x = x_of(p, q, 3, seed=5)
    y = x_of(p, q, 3, seed=6)

    def consume(s, bufs, acc):
        a, b = bufs
        return acc + (s + 1) * a * b

    got = comm.systolic_ring(4, (torch.from_numpy(x), torch.from_numpy(y)),
                             (("q", q), ("p", p)), consume,
                             torch.zeros(p, q, 3, dtype=torch.float64)
                             ).numpy()
    xy = np.concatenate([x, y], axis=2)

    def jbody(ab):
        return jcomm.systolic_ring(4, (ab[:3], ab[3:]),
                                   ((AXIS_Q, q), (AXIS_P, p)), consume,
                                   jnp.zeros(3), double_buffer=double_buffer)

    assert np.abs(got - jrun(p, q, jbody, xy)).max() < 1e-12


@pytest.mark.parametrize("p,q", GRIDS)
def test_gather_rows(p, q):
    """gather_rows gives every rank of a grid column the rows of the
    global matrix."""
    nb, mtl, ntl = 3, 2, 2
    x = torch.from_numpy(x_of(p, q, mtl, ntl, nb, nb, seed=9))
    dense = x.permute(2, 0, 4, 3, 1, 5).reshape(mtl * p * nb,
                                                 ntl * q * nb)
    rows = torch.tensor([5, 0, mtl * p * nb - 1, 4])
    got = comm.gather_rows(x, rows)                  # [p, q, R, ntl, nb]
    for c in range(q):
        cols = torch.cat([torch.arange(b * q * nb + c * nb,
                                       b * q * nb + c * nb + nb)
                          for b in range(ntl)])
        want = dense[rows][:, cols].reshape(len(rows), ntl, nb)
        for r in range(p):
            assert torch.equal(got[r, c], want)


def test_row_swaps_equal():
    """The LU's row swaps, whose moved rows cross ranks through
    ``gather_rows``, against the JAX body's ``_swap_rows_local``."""
    from slate_tpu.internal import masks as jmasks
    from slate_tpu.linalg import getrf as jgetrf
    from slate_tpu_torch.internal import masks
    from slate_tpu_torch.linalg import getrf as pgetrf
    p, q, mtl, ntl, nb = 2, 4, 3, 2, 4
    x = x_of(p, q, mtl, ntl, nb, nb, seed=13)
    M, start = mtl * p * nb, 5
    rng = np.random.default_rng(3)
    prow = [int(start + j + rng.integers(0, M - start - j)) for j in range(nb)]

    def body(a):
        gi = jmasks.local_tile_rows(mtl, p)
        t_local = gi[:, None] * nb + jnp.arange(nb)[None, :]
        return jgetrf._swap_rows_local(
            a, jnp.asarray(prow, jnp.int32), start, t_local, nb, p, q,
            exclude_col=1)

    want = jrun(p, q, body, x)
    d = torch.from_numpy(x.copy())
    pgetrf._swap_rows_local(d, prow, start,
                            keep=masks.local_tile_cols(ntl, q) != 1)
    np.testing.assert_array_equal(d.numpy(), want)
