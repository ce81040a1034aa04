"""Collectives over the ranks of a p×q grid (counterpart of
``slate_tpu/internal/comm.py:58-288``).

The JAX package writes each p×q driver as one ``shard_map`` body whose
collectives are XLA's (``psum``, ``all_gather``, ``ppermute``); the
reference uses MPI (BaseMatrix.hh:1769-2485 tileBcast/listBcast/
listReduce, internal_comm.cc). The port's ranks are virtual and share
one device (``grid.py``): a value that the JAX body holds per device is
here one tensor whose two leading axes are the rank axes, ``x[r, c]``
being rank (r, c)'s. Each collective below is an operation across those
axes, written as what the JAX body computes rather than as its masked
``psum`` idiom:

=========================  ============================================
JAX body (XLA)             here
=========================  ============================================
masked psum broadcast      an index of the owner and an ``expand``
``lax.psum``               a sum over the rank axis
``lax.ppermute`` ring      a ``roll`` of the rank axis
``lax.all_gather``         a reordering of the rank axis into the slots
``lax.psum_scatter``       a sum, then each rank's slice
=========================  ============================================

A broadcast returns an expanded view: every rank sees the owner's value
and nothing is copied, so work that every rank of the JAX body repeats
on the same broadcast value may run once on ``[0, 0]`` of it.

This module is the only one that reads across ranks: no driver indexes
another rank's slots. A transport across real devices (peer copies,
NCCL) replaces these bodies and nothing else.
"""

from __future__ import annotations

import math
import torch

AXIS_P = 0   # grid rows (the JAX mesh axis 'p')
AXIS_Q = 1   # grid columns (the JAX mesh axis 'q')


def _ax(axis) -> int:
    """Rank axis index from 0/1 or the JAX axis names 'p'/'q'."""
    return {"p": AXIS_P, "q": AXIS_Q}.get(axis, axis)


def _expand(x: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[*, *, ...] with size-1 rank axes → [p, q, ...] without a copy."""
    return x.expand((p, q) + tuple(x.shape[2:]))


def coords(p: int, q: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, col) of every rank, broadcastable to the rank axes:
    ``r`` is [p, 1], ``c`` is [1, q]."""
    r = torch.arange(p, device=device).view(p, 1)
    c = torch.arange(q, device=device).view(1, q)
    return r, c


# ---------------------------------------------------------------------------
# broadcasts
# ---------------------------------------------------------------------------

def bcast_from_col(x: torch.Tensor, owner_col: int) -> torch.Tensor:
    """Every rank gets the value of the rank in its grid row that sits in
    column ``owner_col`` (reference per-tile-row listBcast,
    src/gemmC.cc:84-116)."""
    return x[:, owner_col:owner_col + 1].expand_as(x)


def bcast_from_row(x: torch.Tensor, owner_row: int) -> torch.Tensor:
    """Every rank gets the value of the rank in its grid column that sits
    in row ``owner_row``."""
    return x[owner_row:owner_row + 1].expand_as(x)


def bcast_from_owner(x: torch.Tensor, owner_row: int,
                     owner_col: int) -> torch.Tensor:
    """One rank's value to every rank (reference ``tileBcast``)."""
    return x[owner_row:owner_row + 1, owner_col:owner_col + 1].expand_as(x)


# ---------------------------------------------------------------------------
# ring shifts
# ---------------------------------------------------------------------------

def rotate_from_next(x: torch.Tensor, axis_name, n: int) -> torch.Tensor:
    """Ring shift along a rank axis: index i receives index (i+1) % n's
    value (one nearest-neighbour hop, the systolic primitive of
    Cannon/ring SUMMA)."""
    ax = _ax(axis_name)
    assert x.shape[ax] == n
    return torch.roll(x, shifts=-1, dims=ax)


def systolic_ring(n_steps: int, bufs, shifts, consume, acc):
    """The systolic ring engine: ``n_steps`` steps, each ``consume(s,
    bufs, acc) -> acc`` on the current buffers, then one
    :func:`rotate_from_next` of every buffer along its ``(axis, size)``
    in ``shifts``."""
    bufs = tuple(bufs)
    for s in range(n_steps):
        acc = consume(s, bufs, acc)
        bufs = tuple(rotate_from_next(b, ax, n)
                     for b, (ax, n) in zip(bufs, shifts))
    return acc


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def psum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the grid rows (axis p), every rank of a column getting
    the column's sum (reference listReduce down a tile column,
    BaseMatrix.hh:2173-2209)."""
    return x.sum(dim=AXIS_P, keepdim=True).expand_as(x)


def psum_cols(x: torch.Tensor) -> torch.Tensor:
    """Sum over the grid columns (axis q)."""
    return x.sum(dim=AXIS_Q, keepdim=True).expand_as(x)


def psum_all(x: torch.Tensor) -> torch.Tensor:
    """Sum over every rank."""
    return x.sum(dim=AXIS_P, keepdim=True).sum(
        dim=AXIS_Q, keepdim=True).expand_as(x)


def psum_scatter_cols(x: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter along axis q: rank column c keeps slice c of the
    sum over the grid columns."""
    q = x.shape[AXIS_Q]
    d0 = x.shape[2]
    assert d0 % q == 0, "psum_scatter_cols: dim 0 must divide by q"
    s = x.sum(dim=AXIS_Q)                            # [p, d0, ...]
    return s.reshape((s.shape[0], q, d0 // q) + tuple(s.shape[2:]))


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def allgather_cyclic(x: torch.Tensor, n: int,
                     axis_name=AXIS_P) -> torch.Tensor:
    """All-gather local cyclic slices into global order along one rank
    axis: ``x[.., .., a]`` on rank index i is global index ``a·n + i``;
    the result, ``[p, q, L·n, ...]``, holds every global index in order
    on every rank of the axis (the panel-column gather of reference
    internal_getrf.cc:56-67)."""
    ax = _ax(axis_name)
    p, q = x.shape[0], x.shape[1]
    L = x.shape[2]
    rest = tuple(x.shape[3:])
    if ax == AXIS_P:
        g = x.permute((1, 2, 0) + tuple(range(3, x.dim())))  # [q, L, p, ..]
        g = g.reshape((1, q, L * p) + rest)
    else:
        g = x.permute((0, 2, 1) + tuple(range(3, x.dim())))  # [p, L, q, ..]
        g = g.reshape((p, 1, L * q) + rest)
    return _expand(g, p, q)


def allgather_panel_rows(panel_local: torch.Tensor, p: int,
                         owner_col: int) -> torch.Tensor:
    """Gather a tile-column panel to every rank: ``panel_local`` is
    ``[p, q, mtl, ...]``, each rank's slots of the panel column, valid
    on grid column ``owner_col`` only (the others are not read). Returns
    ``[p, q, mtl·p, ...]``, the panel in global tile-row order on every
    rank: a broadcast across the columns, then a cyclic gather down the
    rows."""
    p_, q_ = panel_local.shape[0], panel_local.shape[1]
    col = panel_local[:, owner_col:owner_col + 1]    # the owner column
    g = allgather_cyclic(col, p, AXIS_P)             # [p, 1, mtl·p, ...]
    return g.expand((p_, q_) + tuple(g.shape[2:]))


def gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Element rows of a rank-stacked tile array to every rank of each
    grid column: ``x`` is ``[p, q, mtl, ntl, nb, nb]``, ``rows`` a 1-D
    tensor of global element rows; returns ``[p, q, len(rows), ntl, nb]``,
    row t's local-column data of grid column c on every rank of that
    column (the JAX package's masked ``psum_rows`` of candidate rows,
    getrf.py:1515-1588, and the reference's MPI_Sendrecv row swaps,
    internal_swap.cc)."""
    p, q, mtl, ntl, nb, _ = x.shape
    rows = rows.to(device=x.device, dtype=torch.long)
    tile = rows // nb
    got = x[tile % p, :, tile // p, :, rows % nb, :]   # [R, q, ntl, nb]
    return _expand(got.transpose(0, 1).unsqueeze(0), p, q)


def gather_cols(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Element columns of a rank-stacked tile array to every rank of each
    grid row, the column analog of :func:`gather_rows`: ``cols`` a 1-D
    tensor of global element columns; returns ``[p, q, len(cols), mtl,
    nb]``, column t's local-row data of grid row r on every rank of that
    row (the JAX package's masked ``psum_cols`` of candidate columns,
    getrf.py:1590-1640)."""
    p, q, mtl, ntl, nb, _ = x.shape
    cols = cols.to(device=x.device, dtype=torch.long)
    tile = cols // nb
    got = x[:, tile % q, :, tile // q, :, cols % nb]   # [C, p, mtl, nb]
    return _expand(got.transpose(0, 1).unsqueeze(1), p, q)


def shift_tile_cols(x: torch.Tensor) -> torch.Tensor:
    """The tile columns of a rank-stacked tile array moved right by one
    global tile column: tile (i, j) of the result is tile (i, j − 1) of
    ``x``, tile column 0 is zero and the last is dropped. Each tile moves
    from grid column (j − 1) % q to j % q (a ring shift of the tile
    columns; the JAX package's eager ``concatenate`` of the global tile
    array, hetrf.py:282-306)."""
    p, q, mtl, ntl, nb, _ = x.shape
    dev = x.device
    j = (torch.arange(ntl, device=dev).view(1, ntl) * q
         + torch.arange(q, device=dev).view(q, 1))      # [q, ntl] global
    src = (j - 1).clamp(min=0)
    out = x[:, src % q, :, src // q]                    # [q, ntl, p, mtl, ..]
    out = out.permute(2, 0, 3, 1, 4, 5)
    keep = (j >= 1).view(1, q, 1, ntl, 1, 1)
    return torch.where(keep, out, torch.zeros_like(out))


def gather_tiles(x: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Global tiles (rows[t], cols[t]) of a rank-stacked tile array from
    their owners to every rank: ``[p, q, len(rows), nb, nb]``, the same
    on every rank (the band gather of reference he2hbGather, each owner
    sending its band tiles; only these tiles move)."""
    p, q = x.shape[0], x.shape[1]
    got = x[rows % p, cols % q, rows // p, cols // q]   # [T, nb, nb]
    return _expand(got[None, None], p, q)


def transpose_tiles(x: torch.Tensor, mt: int, nt: int,
                    conj: bool = False) -> torch.Tensor:
    """The block-cyclic transpose of a rank-stacked tile array: global
    tile (i, j) of the result is tile (j, i) of ``x`` transposed (and
    conjugated with ``conj``), for the result's true tile counts ``mt`` ×
    ``nt``, re-laid out on the same p×q grid; other slots are zero. An
    all-to-all: each tile moves to the rank that owns its transposed
    position (reference ``Matrix::redistribute`` of a transposed view)."""
    p, q, mtl, ntl, nb, _ = x.shape
    mtl2, ntl2 = -(-mt // p), -(-nt // q)
    dev = x.device
    r = torch.arange(p, device=dev).view(p, 1, 1, 1)
    c = torch.arange(q, device=dev).view(1, q, 1, 1)
    a = torch.arange(mtl2, device=dev).view(1, 1, mtl2, 1)
    b = torch.arange(ntl2, device=dev).view(1, 1, 1, ntl2)
    i = a * p + r                           # result's global tile (i, j)
    j = b * q + c
    valid = (i < mt) & (j < nt)
    # source tile (j, i) of x: owner (j % p, i % q), slot (j // p, i // q)
    src = (((j % p) * q + (i % q)) * mtl + (j // p)) * ntl + (i // q)
    src = torch.where(valid, src, torch.zeros_like(src))
    flat = x.reshape(p * q * mtl * ntl, nb, nb)
    out = flat[src.reshape(-1)].transpose(-1, -2)
    if conj and x.is_complex():
        out = out.conj()
    out = out.reshape(p, q, mtl2, ntl2, nb, nb)
    return torch.where(valid[..., None, None], out, torch.zeros_like(out))


def relayout(x: torch.Tensor, p2: int, q2: int, mt: int,
             nt: int) -> torch.Tensor:
    """The tiles of a rank-stacked array on one grid re-laid out on a
    p2×q2 grid: global tile (i, j) moves from rank (i % p, j % q) slot
    (i // p, j // q) to rank (i % p2, j % q2) slot (i // p2, j // q2), for
    the true tile counts ``mt`` × ``nt``; padding slots are zero. An
    all-to-all (reference ``Matrix::redistribute``, Matrix.hh:831-862)."""
    p, q, mtl, ntl, nb, _ = x.shape
    mtl2, ntl2 = -(-mt // p2), -(-nt // q2)
    dev = x.device
    r = torch.arange(p2, device=dev).view(p2, 1, 1, 1)
    c = torch.arange(q2, device=dev).view(1, q2, 1, 1)
    a = torch.arange(mtl2, device=dev).view(1, 1, mtl2, 1)
    b = torch.arange(ntl2, device=dev).view(1, 1, 1, ntl2)
    i = a * p2 + r
    j = b * q2 + c
    valid = (i < mt) & (j < nt)
    src = (((i % p) * q + (j % q)) * mtl + (i // p)) * ntl + (j // q)
    src = torch.where(valid, src, torch.zeros_like(src))
    out = x.reshape(p * q * mtl * ntl, nb, nb)[src.reshape(-1)]
    out = out.reshape(p2, q2, mtl2, ntl2, nb, nb)
    return torch.where(valid[..., None, None], out, torch.zeros_like(out))


def pmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the grid rows (``lax.pmax`` over axis p)."""
    return x.amax(dim=AXIS_P, keepdim=True).expand_as(x)


def pmax_cols(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the grid columns."""
    return x.amax(dim=AXIS_Q, keepdim=True).expand_as(x)


def lcm(p: int, q: int) -> int:
    return p * q // math.gcd(p, q)
