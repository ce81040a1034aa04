"""Process grid on one ``torch.device``.

The reference distributes tiles over a p×q MPI process grid in 2-D
block-cyclic fashion (include/slate/BaseMatrix.hh:879-905). This slice
of the port runs on one device, so the only grid is 1×1; the
block-cyclic map (``tile_owner`` / ``tile_slot``) is kept so that the
layout code in :mod:`slate_tpu_torch.matrix` stays general for the
multi-device work that comes later.
"""

from __future__ import annotations

import torch

from .errors import SlateError, slate_error_if


class Grid:
    """A p×q grid backing one or more tiled matrices.

    ``device=None`` means the CUDA card; without one the constructor
    raises :class:`SlateError` instead of quietly picking the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    """

    def __init__(self, p: int = 1, q: int = 1, device=None):
        slate_error_if(p * q != 1,
                       f"grid {p}x{q}: multi-device grids are not ported "
                       "yet; only Grid(1, 1) on one device runs")
        if device is None:
            if not torch.cuda.is_available():
                raise SlateError(
                    "Grid(1, 1) with no device needs a CUDA card and none "
                    "is available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.p = p
        self.q = q
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return self.p * self.q

    # -- 2-D block-cyclic tile map: global tile (i, j) lives on grid
    # coordinate (i % p, j % q) at local slot (i // p, j // q)
    def tile_owner(self, i, j):
        """Grid coordinate (r, c) owning global tile (i, j)."""
        return i % self.p, j % self.q

    def tile_slot(self, i, j):
        """Local slot (si, sj) of global tile (i, j) on its owner."""
        return i // self.p, j // self.q

    def __repr__(self):
        return f"Grid(p={self.p}, q={self.q}, device={self.device})"

    def __eq__(self, other):
        return (isinstance(other, Grid) and self.p == other.p
                and self.q == other.q and self.device == other.device)

    def __hash__(self):
        return hash((self.p, self.q, str(self.device)))


def default_grid() -> Grid:
    """The grid an entry point uses when its caller names none (the
    counterpart of ``slate_tpu/grid.py:198``): ``Grid(1, 1)`` on the CUDA
    card, which raises :class:`SlateError` when there is no card, as
    ``Grid()`` does."""
    return Grid(1, 1)
