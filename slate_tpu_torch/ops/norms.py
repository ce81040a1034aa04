"""Matrix norms (reference src/norm.cc, colNorms.cc; counterpart of
``slate_tpu/ops/norms.py``).

Max/One/Inf/Fro for general, triangular, Hermitian and band shapes, and
``NormScope.Columns`` (colNorms): masked reductions over the tile stack.
A Hermitian or symmetric matrix is reduced over its stored triangle, and
the mirrored off-diagonal contribution is added, so the junk half is never read (the
reference's henorm/synorm semantics).
"""

from __future__ import annotations

import torch

from ..errors import SlateError, slate_error_if
from ..internal import comm, masks
from ..matrix import BaseTiledMatrix, HermitianMatrix, SymmetricMatrix
from ..types import Norm, NormScope


def norm(norm_kind: Norm, A: BaseTiledMatrix,
         scope: NormScope = NormScope.Matrix, opts=None) -> torch.Tensor:
    """‖A‖ for Max/One/Inf/Fro (reference src/norm.cc): a 0-dim real
    tensor on A's device (a vector for ``NormScope.Columns``)."""
    if scope == NormScope.Columns:
        return col_norms(norm_kind, A, opts)
    A = A.materialize()
    sym = isinstance(A, (HermitianMatrix, SymmetricMatrix))
    if A.grid.size > 1:
        return _norm_pq(A, norm_kind, sym)
    a = A.data[0, 0]
    valid = masks.shape_mask(A)
    absa = torch.where(valid, a.abs(), 0)
    if norm_kind == Norm.Max:
        return absa.max()
    if norm_kind not in (Norm.One, Norm.Inf, Norm.Fro):
        raise SlateError(f"unsupported norm {norm_kind}")
    if sym:
        er, ec = masks.elem_index(A.mtl, A.ntl, A.nb, a.device)
        offdiag = valid & (er != ec)
    if norm_kind == Norm.Fro:
        sq = (absa ** 2).sum()
        if sym:                                      # mirrored triangle
            sq = sq + (torch.where(offdiag, absa, 0) ** 2).sum()
        return torch.sqrt(sq)
    colsum = absa.sum(dim=(0, 2)).reshape(-1)        # [ntl·nb] by column
    rowsum = absa.sum(dim=(1, 3)).reshape(-1)        # [mtl·nb] by row
    if not sym:
        return (colsum if norm_kind == Norm.One else rowsum).max()
    # symmetric: ‖·‖₁ = ‖·‖∞; line j is the stored triangle's column j
    # plus the strict triangle's row j (the mirrored part)
    rowsum_o = torch.where(offdiag, absa, 0).sum(dim=(1, 3)).reshape(-1)
    ln = min(colsum.shape[0], rowsum_o.shape[0])
    return (colsum[:ln] + rowsum_o[:ln]).max()


def col_norms(norm_kind: Norm, A: BaseTiledMatrix, opts=None):
    """Per-column max-abs norms (reference src/colNorms.cc): [n]."""
    slate_error_if(norm_kind != Norm.Max, "colNorms supports Norm.Max")
    A = A.materialize()
    if A.grid.size > 1:
        g = A.grid
        valid = masks.valid_mask(A.mtl, A.ntl, A.nb, A.m, A.n,
                                 A.data.device, p=g.p, q=g.q)
        absa = torch.where(valid, A.data.abs(), 0)
        cmax = comm.pmax_rows(absa.amax(dim=(2, 4)))    # [p, q, ntl, nb]
        full = comm.allgather_cyclic(cmax, g.q, "q")   # [p, q, nt_p, nb]
        return full[0, 0].reshape(-1)[:A.n]
    valid = masks.valid_mask(A.mtl, A.ntl, A.nb, A.m, A.n, A.data.device)
    absa = torch.where(valid, A.data[0, 0].abs(), 0)
    return absa.amax(dim=(0, 2)).reshape(-1)[:A.n]


def _norm_pq(A, kind, sym):
    """‖A‖ on a p×q grid (``norms.py:52-103``): every rank's masked
    reduction of its own slots, then sums and maxima across the ranks."""
    g = A.grid
    a = A.data
    valid = masks.shape_mask(A, stacked=True)
    absa = torch.where(valid, a.abs(), 0)
    if kind == Norm.Max:
        return comm.pmax_cols(comm.pmax_rows(absa.amax(dim=(2, 3, 4, 5))))[
            0, 0]
    er, ec = masks.grid_elem_index(g.p, g.q, A.mtl, A.ntl, A.nb, a.device)
    abso = torch.where(valid & (er != ec), a.abs(), 0)
    if kind == Norm.Fro:
        sq = (absa ** 2).sum(dim=(2, 3, 4, 5))
        if sym:                                      # mirrored triangle
            sq = sq + (abso ** 2).sum(dim=(2, 3, 4, 5))
        return torch.sqrt(comm.psum_all(sq))[0, 0]
    if kind not in (Norm.One, Norm.Inf):
        raise SlateError(f"unsupported norm {kind}")
    colsum = absa.sum(dim=(2, 4))                    # [p, q, ntl, nb]
    rowsum = absa.sum(dim=(3, 5))                    # [p, q, mtl, nb]
    if not sym:
        if kind == Norm.One:
            s = comm.psum_rows(colsum)               # whole column sums
        else:
            s = comm.psum_cols(rowsum)               # whole row sums
        return comm.pmax_cols(comm.pmax_rows(s.amax(dim=(2, 3))))[0, 0]
    # symmetric: ‖·‖₁ = ‖·‖∞; line j is the stored triangle's column j
    # plus the strict triangle's row j (the mirrored part)
    col_full = comm.allgather_cyclic(comm.psum_rows(colsum), g.q, "q")
    row_full = comm.allgather_cyclic(
        comm.psum_cols(abso.sum(dim=(3, 5))), g.p, "p")
    ln = min(col_full.shape[2], row_full.shape[2])
    tot = col_full[0, 0, :ln].reshape(-1) + row_full[0, 0, :ln].reshape(-1)
    return tot.max()
