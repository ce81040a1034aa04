"""Global-index masks over a matrix's tile stack, and padding masks for
diagonal tiles (counterpart of ``slate_tpu/internal/masks.py:22-87``).

The matrix is zero-padded to whole tiles. On the 1×1 grid the local tile
stack ``data[0, 0]`` is ``[mtl, ntl, nb, nb]`` with local slot = global
tile, so element (a, b, i, j) is global row ``a·nb + i`` and column
``b·nb + j``; the masks say which elements are inside the true m×n
matrix, a triangle or a band. On a p×q grid rank (r, c)'s slot (a, b) is
global tile (a·p + r, b·q + c): the ``local_*`` helpers give those
indices per rank, and the masks, given ``p`` and ``q``, come back
rank-stacked, ``[p, q, mtl, ntl, nb, nb]``. A factorization or solve of
the padded matrix stays nonsingular when the padded part of each
diagonal tile carries an identity.
"""

from __future__ import annotations

import torch

from ..types import Uplo


def local_tile_rows(mtl: int, p: int, device=None) -> torch.Tensor:
    """Global tile row of each rank row's local slot a, ``a·p + r``:
    ``[p, mtl]``."""
    return (torch.arange(mtl, device=device)[None, :] * p
            + torch.arange(p, device=device)[:, None])


def local_tile_cols(ntl: int, q: int, device=None) -> torch.Tensor:
    """Global tile column of each rank column's local slot b,
    ``b·q + c``: ``[q, ntl]``."""
    return local_tile_rows(ntl, q, device)


def local_elem_rows(mtl: int, nb: int, p: int, device=None) -> torch.Tensor:
    """Global row of every element of each rank row: ``[p, mtl, nb]``."""
    return (local_tile_rows(mtl, p, device)[:, :, None] * nb
            + torch.arange(nb, device=device))


def local_elem_cols(ntl: int, nb: int, q: int, device=None) -> torch.Tensor:
    """Global column of every element of each rank column:
    ``[q, ntl, nb]``."""
    return local_elem_rows(ntl, nb, q, device)


def grid_elem_index(p: int, q: int, mtl: int, ntl: int, nb: int,
                    device=None):
    """Global row and column of every element of the rank-stacked tile
    array, broadcastable to ``[p, q, mtl, ntl, nb, nb]``."""
    er = local_elem_rows(mtl, nb, p, device).view(p, 1, mtl, 1, nb, 1)
    ec = local_elem_cols(ntl, nb, q, device).view(1, q, 1, ntl, 1, nb)
    return er, ec


def _index(mtl, ntl, nb, device, p, q):
    if p is None and q is None:
        return elem_index(mtl, ntl, nb, device)
    return grid_elem_index(p or 1, q or 1, mtl, ntl, nb, device)


def elem_index(mtl: int, ntl: int, nb: int, device=None):
    """Global row and column index of every element, broadcastable to
    the tile stack's [mtl, ntl, nb, nb]."""
    er = torch.arange(mtl * nb, device=device).view(mtl, 1, nb, 1)
    ec = torch.arange(ntl * nb, device=device).view(1, ntl, 1, nb)
    return er, ec


def valid_mask(mtl: int, ntl: int, nb: int, m: int, n: int,
               device=None, *, p=None, q=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb] (rank-stacked ``[p, q, ...]`` given p, q): True
    on elements inside the true m×n matrix."""
    er, ec = _index(mtl, ntl, nb, device, p, q)
    return (er < m) & (ec < n)


def uplo_mask(mtl: int, ntl: int, nb: int, lower: bool,
              strict: bool = False, device=None, *, p=None,
              q=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb] (rank-stacked given p, q): True on the lower
    (or upper) triangle by global element index; ``strict`` excludes the
    diagonal."""
    er, ec = _index(mtl, ntl, nb, device, p, q)
    if lower:
        return er > ec if strict else er >= ec
    return er < ec if strict else er <= ec


def band_mask(mtl: int, ntl: int, nb: int, kl: int, ku: int,
              device=None, *, p=None, q=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb] (rank-stacked given p, q): True where
    ``-kl <= col - row <= ku``."""
    er, ec = _index(mtl, ntl, nb, device, p, q)
    d = ec - er
    return (d >= -kl) & (d <= ku)


def shape_mask(A, stacked: bool = False) -> torch.Tensor:
    """[mtl, ntl, nb, nb]: the elements of A's shape, inside the true
    m×n matrix and, by ``uplo``, its triangle and, by kl/ku, its band.
    ``stacked`` gives the rank-stacked ``[p, q, mtl, ntl, nb, nb]`` mask
    of A's grid."""
    mtl, ntl, nb, dev = A.mtl, A.ntl, A.nb, A.data.device
    pq = dict(p=A.grid.p, q=A.grid.q) if stacked else {}
    valid = valid_mask(mtl, ntl, nb, A.m, A.n, dev, **pq)
    if A.uplo in (Uplo.Lower, Uplo.Upper):
        valid = valid & uplo_mask(mtl, ntl, nb, A.uplo == Uplo.Lower,
                                  device=dev, **pq)
    if A.kl or A.ku:
        valid = valid & band_mask(mtl, ntl, nb, A.kl, A.ku, dev, **pq)
    return valid


def tile_diag_pad_identity(tile: torch.Tensor, k: int, m: int, nb: int,
                           n: int | None = None) -> torch.Tensor:
    """Place 1s on the padded part of diagonal tile ``k``'s diagonal and
    zero its padded entries, so factorizations of the zero-padded matrix
    stay nonsingular and leave the padding invariant.

    ``m``/``n`` are the true global rows/cols (n defaults to m). An
    element is padding when its row >= m or col >= n; a diagonal 1 is
    placed whenever either holds."""
    if n is None:
        n = m
    idx = k * nb + torch.arange(nb, device=tile.device)
    pad_r = idx >= m
    pad_c = idx >= n
    keep = (~pad_r[:, None]) & (~pad_c[None, :])
    return (torch.where(keep, tile, torch.zeros_like(tile))
            + torch.diag(pad_r | pad_c).to(tile.dtype))
