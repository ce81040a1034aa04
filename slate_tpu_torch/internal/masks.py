"""Global-index masks over a matrix's tile stack, and padding masks for
diagonal tiles (counterpart of ``slate_tpu/internal/masks.py``).

The matrix is zero-padded to whole tiles. On the 1×1 grid the local tile
stack ``data[0, 0]`` is ``[mtl, ntl, nb, nb]`` with local slot = global
tile, so element (a, b, i, j) is global row ``a·nb + i`` and column
``b·nb + j``; the masks say which elements are inside the true m×n
matrix, a triangle or a band. A factorization or solve of the padded
matrix stays nonsingular when the padded part of each diagonal tile
carries an identity.
"""

from __future__ import annotations

import torch

from ..types import Uplo


def elem_index(mtl: int, ntl: int, nb: int, device=None):
    """Global row and column index of every element, broadcastable to
    the tile stack's [mtl, ntl, nb, nb]."""
    er = torch.arange(mtl * nb, device=device).view(mtl, 1, nb, 1)
    ec = torch.arange(ntl * nb, device=device).view(1, ntl, 1, nb)
    return er, ec


def valid_mask(mtl: int, ntl: int, nb: int, m: int, n: int,
               device=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb]: True on elements inside the true m×n matrix."""
    er, ec = elem_index(mtl, ntl, nb, device)
    return (er < m) & (ec < n)


def uplo_mask(mtl: int, ntl: int, nb: int, lower: bool,
              strict: bool = False, device=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb]: True on the lower (or upper) triangle by
    global element index; ``strict`` excludes the diagonal."""
    er, ec = elem_index(mtl, ntl, nb, device)
    if lower:
        return er > ec if strict else er >= ec
    return er < ec if strict else er <= ec


def band_mask(mtl: int, ntl: int, nb: int, kl: int, ku: int,
              device=None) -> torch.Tensor:
    """[mtl, ntl, nb, nb]: True where ``-kl <= col - row <= ku``."""
    er, ec = elem_index(mtl, ntl, nb, device)
    d = ec - er
    return (d >= -kl) & (d <= ku)


def shape_mask(A) -> torch.Tensor:
    """[mtl, ntl, nb, nb]: the elements of A's shape, inside the true
    m×n matrix and, by ``uplo``, its triangle and, by kl/ku, its band."""
    mtl, ntl, nb, dev = A.mtl, A.ntl, A.nb, A.data.device
    valid = valid_mask(mtl, ntl, nb, A.m, A.n, dev)
    if A.uplo in (Uplo.Lower, Uplo.Upper):
        valid &= uplo_mask(mtl, ntl, nb, A.uplo == Uplo.Lower, device=dev)
    if A.kl or A.ku:
        valid &= band_mask(mtl, ntl, nb, A.kl, A.ku, dev)
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
