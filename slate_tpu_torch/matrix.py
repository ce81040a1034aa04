"""Tiled matrices in the 2-D block-cyclic layout.

A matrix is one tensor ``data[p, q, mtl, ntl, nb, nb]``: global tile
``(i, j)`` lives at ``data[i % p, j % q, i // p, j // q]``, the
reference's ``tileRank`` map (BaseMatrix.hh:879-905). The layout is the
one the JAX package uses, so a matrix carries across bit for bit
(:mod:`slate_tpu_torch.interop`). On a p×q grid ``data[r, c]`` is rank
(r, c)'s local stack (``grid.py``); the layout changes that move tiles
between ranks (a transposed view resolved, a new grid) go through the
collectives of :mod:`slate_tpu_torch.internal.comm`.

The matrix is padded to whole tiles and the padding is kept zero;
factorizations place an identity on the padded diagonal while they run.
Shape metadata (``m``, ``n``, ``nb``, ``op``, ``uplo``, ``diag``) is
plain Python; ``data`` is the only tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import slate_error_if
from .grid import Grid
from .internal import comm
from .types import Diag, Op, Uplo


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Layout conversion helpers
# ---------------------------------------------------------------------------

def bc_from_tiles(tiles: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[mt_p, nt_p, nb, nb] global tile array → [p, q, mtl, ntl, nb, nb]."""
    mt_p, nt_p, nb, _ = tiles.shape
    mtl, ntl = mt_p // p, nt_p // q
    return (tiles.reshape(mtl, p, ntl, q, nb, nb)
                 .permute(1, 3, 0, 2, 4, 5).contiguous())


def bc_to_tiles(data: torch.Tensor) -> torch.Tensor:
    """[p, q, mtl, ntl, nb, nb] → global tile array [mt_p, nt_p, nb, nb]."""
    p, q, mtl, ntl, nb, _ = data.shape
    return (data.permute(2, 0, 3, 1, 4, 5)
                .reshape(mtl * p, ntl * q, nb, nb))


def dense_to_tiles(a: torch.Tensor, nb: int, mt_p: int,
                   nt_p: int) -> torch.Tensor:
    """Dense [m, n] → zero-padded tile array [mt_p, nt_p, nb, nb], always
    a new tensor."""
    m, n = a.shape
    t = a.new_zeros((mt_p * nb, nt_p * nb))
    t[:m, :n] = a
    return t.view(mt_p, nb, nt_p, nb).permute(0, 2, 1, 3).contiguous()


def tiles_to_dense(tiles: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Tile array [mt_p, nt_p, nb, nb] → dense [m, n]. Always a new
    tensor, never a view of ``tiles``: the factorizations update the
    dense copy in place."""
    mt_p, nt_p, nb, _ = tiles.shape
    full = tiles.new_empty((mt_p * nb, nt_p * nb))
    full.view(mt_p, nb, nt_p, nb).copy_(tiles.permute(0, 2, 1, 3))
    return full[:m, :n]


def check_rhs_dtype(B: "BaseTiledMatrix",
                    dtype: torch.dtype) -> "BaseTiledMatrix":
    """``B`` itself, after refusing a real right-hand side of complex
    factors: the solution is complex and a real B cannot hold it (the
    JAX package raises a ``TypeError`` there)."""
    slate_error_if(dtype.is_complex and not B.dtype.is_complex,
                   f"a real right-hand side ({B.dtype}) of {dtype} factors:"
                   f" pass B as {dtype}")
    return B


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.as_tensor(a, device=device)


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BaseTiledMatrix:
    """Common storage and indexing for all matrix shapes (reference
    ``BaseMatrix``, BaseMatrix.hh)."""
    data: torch.Tensor       # [p, q, mtl, ntl, nb, nb]
    m: int                   # true global rows
    n: int                   # true global cols
    nb: int                  # tile size
    grid: Grid
    op: Op = Op.NoTrans      # shallow transpose flag (Tile.hh:40-113)
    uplo: Uplo = Uplo.General
    diag: Diag = Diag.NonUnit
    kl: int = 0              # band lower bandwidth (BandMatrix)
    ku: int = 0              # band upper bandwidth

    # -- geometry -----------------------------------------------------------
    @property
    def mt(self) -> int:
        """Block rows (reference BaseMatrix::mt), after op."""
        return cdiv(self.m, self.nb)

    @property
    def nt(self) -> int:
        return cdiv(self.n, self.nb)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    # storage-side geometry (ignores op flag)
    @property
    def mtl(self) -> int:
        return self.data.shape[2]

    @property
    def ntl(self) -> int:
        return self.data.shape[3]

    def _replace(self, **kw) -> "BaseTiledMatrix":
        return dataclasses.replace(self, **kw)

    # -- conversion ---------------------------------------------------------
    @classmethod
    def from_dense(cls, a, nb: int | None = None, grid: Grid | None = None,
                   **kw) -> "BaseTiledMatrix":
        """Build from a global dense array, a numpy array or a tensor
        (analog of ``fromLAPACK``, reference Matrix.hh:291). The array is
        tiled, padded with zeros and laid out block-cyclically on the
        grid's device."""
        grid = grid or Grid(1, 1)
        slate_error_if(np.ndim(a) != 2, "from_dense expects a 2-D array")
        a = _as_tensor(a, grid.device)
        m, n = a.shape
        if nb is None:
            nb = _default_nb(m, n)
        mtl = cdiv(cdiv(m, nb), grid.p)
        ntl = cdiv(cdiv(n, nb), grid.q)
        tiles = dense_to_tiles(a, nb, mtl * grid.p, ntl * grid.q)
        data = bc_from_tiles(tiles, grid.p, grid.q)
        return cls(data=data, m=m, n=n, nb=nb, grid=grid, **kw)

    @classmethod
    def zeros(cls, m: int, n: int, nb: int, grid: Grid | None = None,
              dtype=torch.float32, **kw) -> "BaseTiledMatrix":
        grid = grid or Grid(1, 1)
        mtl = cdiv(cdiv(m, nb), grid.p)
        ntl = cdiv(cdiv(n, nb), grid.q)
        data = torch.zeros((grid.p, grid.q, mtl, ntl, nb, nb), dtype=dtype,
                           device=grid.device)
        return cls(data=data, m=m, n=n, nb=nb, grid=grid, **kw)

    def to_dense(self) -> torch.Tensor:
        """Gather to a global dense [m, n] tensor (respecting op/uplo is
        the caller's concern for shaped matrices)."""
        sm, sn = (self.m, self.n) if self.op == Op.NoTrans else (self.n, self.m)
        tiles = bc_to_tiles(self.data)
        d = tiles_to_dense(tiles, sm, sn)
        if self.op == Op.Trans:
            d = d.mT
        elif self.op == Op.ConjTrans:
            d = d.mH
        return d

    def tile(self, i: int, j: int) -> torch.Tensor:
        """Global tile (i, j) fetched through the grid's block-cyclic map
        — ``data[i%p, j%q, i//p, j//q]``."""
        r, c = self.grid.tile_owner(i, j)
        si, sj = self.grid.tile_slot(i, j)
        return self.data[r, c, si, sj]

    def sub(self, i1: int, i2: int, j1: int, j2: int) -> "BaseTiledMatrix":
        """Tile-index submatrix [i1..i2] × [j1..j2] inclusive (reference
        ``BaseMatrix::sub``), as a copy. Its true size is cut at the
        parent's; entries past it are zeroed, so the copy keeps the
        zero padding (the JAX package's ``sub`` copies whole tiles)."""
        slate_error_if(self.op != Op.NoTrans, "sub() before materialize()")
        nb = self.nb
        m = min(self.m - i1 * nb, (i2 - i1 + 1) * nb)
        n = min(self.n - j1 * nb, (j2 - j1 + 1) * nb)
        tiles = bc_to_tiles(self.data)[i1:i2 + 1, j1:j2 + 1]
        g = self.grid
        mt_p = cdiv(i2 - i1 + 1, g.p) * g.p
        nt_p = cdiv(j2 - j1 + 1, g.q) * g.q
        dense = tiles_to_dense(tiles, m, n)
        data = bc_from_tiles(dense_to_tiles(dense, nb, mt_p, nt_p), g.p, g.q)
        return dataclasses.replace(self, data=data, m=m, n=n)

    def materialize(self) -> "BaseTiledMatrix":
        """Resolve a shallow transpose flag into storage; a triangular or
        Hermitian ``uplo`` flips with it, and so do a band's kl and ku."""
        if self.op == Op.NoTrans:
            return self
        uplo = self.uplo
        if uplo in (Uplo.Lower, Uplo.Upper):
            uplo = Uplo.Upper if uplo == Uplo.Lower else Uplo.Lower
        if self.grid.size > 1:
            # the block-cyclic transpose is an all-to-all between ranks
            data = comm.transpose_tiles(self.data, self.mt, self.nt,
                                        conj=self.op == Op.ConjTrans)
            return dataclasses.replace(self, data=data, op=Op.NoTrans,
                                       uplo=uplo, kl=self.ku, ku=self.kl)
        tiles = bc_to_tiles(self.data).permute(1, 0, 3, 2)
        if self.op == Op.ConjTrans:
            tiles = tiles.conj()
        g = self.grid
        # crop to the true (after-op) tile counts, then re-pad for the grid
        tiles = tiles[: self.mt, : self.nt]
        mt_p = cdiv(tiles.shape[0], g.p) * g.p
        nt_p = cdiv(tiles.shape[1], g.q) * g.q
        padded = tiles.new_zeros((mt_p, nt_p) + tuple(tiles.shape[2:]))
        padded[: tiles.shape[0], : tiles.shape[1]] = tiles
        return dataclasses.replace(self, data=bc_from_tiles(padded, g.p, g.q),
                                   op=Op.NoTrans, uplo=uplo, kl=self.ku,
                                   ku=self.kl)

    def redistribute(self, grid: Grid) -> "BaseTiledMatrix":
        """Re-lay the matrix out on another grid (reference
        ``Matrix::redistribute``, Matrix.hh:831-862; ``matrix.py:264``):
        each tile moves from its owner on this grid to its owner on
        ``grid`` (:func:`~.internal.comm.relayout`, an all-to-all)."""
        A = self.materialize()
        data = comm.relayout(A.data, grid.p, grid.q, A.mt, A.nt)
        return dataclasses.replace(A, data=data.to(grid.device), grid=grid)

    @classmethod
    def from_tile_map(cls, m: int, n: int, nb: int, provider,
                      grid: Grid | None = None, dtype=None, **kw):
        """Build from a per-tile provider ``provider(i, j) -> [nb, nb]``
        (reference lambda-distribution constructors, BaseMatrix.hh:
        793-843; ``matrix.py:310``). The tiles land in the canonical
        block-cyclic placement whatever produced them; each is cropped
        to the true edge size, so the padding stays zero."""
        grid = grid or Grid(1, 1)
        mt, nt = cdiv(m, nb), cdiv(n, nb)
        first = np.asarray(provider(0, 0))
        dtype = dtype or first.dtype
        tiles = np.zeros((mt, nt, nb, nb), dtype)
        for i in range(mt):
            for j in range(nt):
                t = np.asarray(first if (i, j) == (0, 0)
                               else provider(i, j), dtype)
                rr, cc = min(nb, m - i * nb), min(nb, n - j * nb)
                tiles[i, j, :rr, :cc] = t[:rr, :cc]
        data = _relayout(torch.from_numpy(tiles), grid)
        return cls(data=data, m=m, n=n, nb=nb, grid=grid, **kw)

    def retile(self, new_nb: int) -> "BaseTiledMatrix":
        """Change the tile size to a divisor of ``nb`` (the two-stage
        eig/SVD re-block to ``Option.EigBand``; reference redistribute
        with a finer blocking, Matrix.hh:831). Tile-level: each
        [nb, nb] tile splits into f×f [new_nb, new_nb] subtiles on the
        device; the dense matrix is never formed."""
        A = self.materialize()
        if new_nb == A.nb:
            return A
        slate_error_if(
            A.nb % new_nb != 0,
            f"retile: new nb {new_nb} must divide the current nb {A.nb}")
        f = A.nb // new_nb
        g = A.grid
        tiles = bc_to_tiles(A.data)                # [mt_p, nt_p, nb, nb]
        mtp, ntp = tiles.shape[0], tiles.shape[1]
        sub = (tiles.reshape(mtp, ntp, f, new_nb, f, new_nb)
                    .permute(0, 2, 1, 4, 3, 5)
                    .reshape(mtp * f, ntp * f, new_nb, new_nb))
        mt2, nt2 = cdiv(A.m, new_nb), cdiv(A.n, new_nb)
        out = sub.new_zeros((cdiv(mt2, g.p) * g.p, cdiv(nt2, g.q) * g.q,
                             new_nb, new_nb))
        out[:mt2, :nt2] = sub[:mt2, :nt2]
        return dataclasses.replace(A, data=bc_from_tiles(out, g.p, g.q),
                                   nb=new_nb)

    def astype(self, dtype) -> "BaseTiledMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def __repr__(self):
        return (f"{type(self).__name__}({self.m}x{self.n}, nb={self.nb}, "
                f"{self.grid}, dtype={self.data.dtype}, op={self.op.name})")


def _relayout(tiles: torch.Tensor, grid: Grid) -> torch.Tensor:
    """[mt, nt, nb, nb] logical tiles → the block-cyclic stacked layout on
    ``grid``, tile counts padded to grid multiples with zero tiles
    (``matrix.py:345``)."""
    mt, nt = tiles.shape[0], tiles.shape[1]
    mt_p, nt_p = cdiv(mt, grid.p) * grid.p, cdiv(nt, grid.q) * grid.q
    padded = tiles.new_zeros((mt_p, nt_p) + tuple(tiles.shape[2:]))
    padded[:mt, :nt] = tiles
    return bc_from_tiles(padded, grid.p, grid.q).to(grid.device)


def _default_nb(m: int, n: int) -> int:
    return min(256, max(32, 1 << (max(m, n) // 8).bit_length()))


# ---------------------------------------------------------------------------
# Shape hierarchy (reference include/slate/{Matrix,…}.hh)
# ---------------------------------------------------------------------------

class Matrix(BaseTiledMatrix):
    """General m×n matrix (reference Matrix.hh:26)."""


class TrapezoidMatrix(BaseTiledMatrix):
    """Upper or lower trapezoid (reference TrapezoidMatrix.hh): the full
    tile stack is stored; only the ``uplo`` triangle is significant."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


class TriangularMatrix(BaseTiledMatrix):
    """Square triangular matrix (reference TriangularMatrix.hh)."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


class SymmetricMatrix(BaseTiledMatrix):
    """Symmetric: only the ``uplo`` half is significant
    (SymmetricMatrix.hh); the other half is junk by contract."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


class HermitianMatrix(BaseTiledMatrix):
    """Hermitian: only the ``uplo`` half is significant
    (HermitianMatrix.hh); the other half is junk by contract."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


class BandMatrix(BaseTiledMatrix):
    """General band matrix with bandwidths (kl, ku) (reference
    BandMatrix.hh). As in the JAX package's v1, the band is stored in the
    dense tile stack; the band drivers pack it."""


class TriangularBandMatrix(BandMatrix):
    """Triangular band matrix (reference TriangularBandMatrix.hh): the
    ``uplo`` triangle of the (kl, ku) band is significant."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


class HermitianBandMatrix(BandMatrix):
    """Hermitian band matrix (reference HermitianBandMatrix.hh): the
    ``uplo`` half of the band is significant."""
    def __init__(self, *a, **kw):
        kw.setdefault("uplo", Uplo.Lower)
        super().__init__(*a, **kw)


# ---------------------------------------------------------------------------
# Shallow transpose ops (reference Tile.hh:40-113)
# ---------------------------------------------------------------------------

def transpose(A: BaseTiledMatrix) -> BaseTiledMatrix:
    """Logical transpose: flips the op flag and swaps m/n; transpose of a
    ConjTrans view is conj(storage), with no dimension swap relative to
    storage."""
    if A.op == Op.ConjTrans:
        return dataclasses.replace(A, data=A.data.conj(), m=A.n, n=A.m,
                                   op=Op.NoTrans)
    new_op = Op.Trans if A.op == Op.NoTrans else Op.NoTrans
    return dataclasses.replace(A, m=A.n, n=A.m, op=new_op)


def conj_transpose(A: BaseTiledMatrix) -> BaseTiledMatrix:
    if A.op == Op.Trans:
        return dataclasses.replace(A, data=A.data.conj(), m=A.n, n=A.m,
                                   op=Op.NoTrans)
    new_op = Op.ConjTrans if A.op == Op.NoTrans else Op.NoTrans
    return dataclasses.replace(A, m=A.n, n=A.m, op=new_op)
