"""Process grid of p×q virtual ranks on one ``torch.device``
(counterpart of ``slate_tpu/grid.py:56-204``).

The reference distributes tiles over a p×q MPI process grid in 2-D
block-cyclic fashion (include/slate/BaseMatrix.hh:879-905). The JAX
package's grid is single-controller: one process holding a mesh of p·q
devices. The port's grid is single-controller too, and its p·q ranks are
virtual: they all live on one device, and a matrix is one tensor
``data[p, q, mtl, ntl, nb, nb]`` whose ``data[r, c]`` is rank (r, c)'s
local tile stack. The drivers of a p×q grid are SPMD programs over those
stacks; only :mod:`slate_tpu_torch.internal.comm` reads across ranks, so
a transport across real devices replaces that module's bodies and
nothing else.
"""

from __future__ import annotations

import math

import torch

from .errors import SlateError, slate_error_if
from .types import GridOrder


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise SlateError(
                "a Grid with no device needs a CUDA card and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class Grid:
    """A p×q grid of virtual ranks backing one or more tiled matrices.

    ``device=None`` means the CUDA card; without one the constructor
    raises :class:`SlateError` instead of quietly picking the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.

    ``devices`` names the device of each rank, in BLACS rank order (the
    JAX package's argument). The port holds every rank on one device, so
    a list whose entries are not all the same device raises: ranks on
    distinct devices need a transport in ``internal/comm.py`` that the
    port does not have yet.
    """

    def __init__(self, p: int | None = None, q: int | None = None,
                 device=None, order: GridOrder = GridOrder.Col,
                 devices=None):
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            slate_error_if(not devs, "Grid: an empty devices list")
            slate_error_if(
                any(d != devs[0] for d in devs),
                f"Grid over distinct devices {sorted(set(map(str, devs)))}:"
                " multi-device grids across devices need a transport "
                "between them (peer copies or NCCL in internal/comm.py),"
                " which is not ported; the ranks of a grid share one "
                "device")
            slate_error_if(device is not None
                           and torch.device(device) != devs[0],
                           "Grid: device and devices disagree")
            device = devs[0]
            nd = len(devs)
            if p is None and q is None:
                p, q = _default_pq(nd)
            elif p is None:
                p = nd // q
            elif q is None:
                q = nd // p
            slate_error_if(p * q != nd, f"grid {p}x{q} != device count {nd}")
        p = 1 if p is None else p
        q = 1 if q is None else q
        slate_error_if(p < 1 or q < 1, f"grid {p}x{q}: p and q must be >= 1")
        self.p = p
        self.q = q
        self.order = order
        self.device = _resolve_device(device)

    @property
    def size(self) -> int:
        return self.p * self.q

    @property
    def devices(self) -> list:
        """The device of each rank in BLACS rank order: one device,
        repeated p·q times."""
        return [self.device] * self.size

    def rank_coords(self, rank: int) -> tuple[int, int]:
        """Grid coordinate (r, c) of BLACS rank ``rank``: (rank % p,
        rank // p) for GridOrder.Col, (rank // q, rank % q) for Row."""
        if self.order == GridOrder.Col:
            return rank % self.p, rank // self.p
        return rank // self.q, rank % self.q

    # -- 2-D block-cyclic tile map: global tile (i, j) lives on grid
    # coordinate (i % p, j % q) at local slot (i // p, j // q)
    def tile_owner(self, i, j):
        """Grid coordinate (r, c) owning global tile (i, j)."""
        return i % self.p, j % self.q

    def tile_slot(self, i, j):
        """Local slot (si, sj) of global tile (i, j) on its owner."""
        return i // self.p, j // self.q

    def tile_device(self, i: int, j: int) -> torch.device:
        """Device holding global tile (i, j): the grid's one device."""
        return self.device

    def global_tile(self, r: int, c: int, si, sj):
        """Inverse map: (grid coordinate, local slot) → global tile."""
        return si * self.p + r, sj * self.q + c

    def __repr__(self):
        return f"Grid(p={self.p}, q={self.q}, device={self.device})"

    def __eq__(self, other):
        return (isinstance(other, Grid) and self.p == other.p
                and self.q == other.q and self.device == other.device)

    def __hash__(self):
        return hash((self.p, self.q, str(self.device)))


def _default_pq(nd: int) -> tuple[int, int]:
    """Most-square factorization, p <= q (common BLACS practice)."""
    p = int(math.isqrt(nd))
    while nd % p != 0:
        p -= 1
    return p, nd // p


def default_grid() -> Grid:
    """The grid an entry point uses when its caller names none (the
    counterpart of ``slate_tpu/grid.py:198``): ``Grid(1, 1)`` on the CUDA
    card, which raises :class:`SlateError` when there is no card, as
    ``Grid()`` does. The JAX package's default spans every visible
    device; the card's host has one."""
    return Grid(1, 1)
