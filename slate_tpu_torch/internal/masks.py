"""Padding masks for diagonal tiles.

The matrix is zero-padded to whole tiles; a factorization or solve of
the padded matrix stays nonsingular when the padded part of each
diagonal tile carries an identity.
"""

from __future__ import annotations

import torch


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
