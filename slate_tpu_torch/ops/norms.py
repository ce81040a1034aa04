"""Matrix norms on one device (reference src/norm.cc, colNorms.cc;
counterpart of ``slate_tpu/ops/norms.py``).

Max/One/Inf/Fro for general, triangular, Hermitian and band shapes, and
``NormScope.Columns`` (colNorms): masked reductions over the tile stack.
A Hermitian or symmetric matrix is reduced over its stored triangle, and
the mirrored off-diagonal contribution is added, so the junk half is never read (the
reference's henorm/synorm semantics).
"""

from __future__ import annotations

import torch

from ..errors import SlateError, slate_error_if
from ..internal import masks
from ..matrix import BaseTiledMatrix, HermitianMatrix, SymmetricMatrix
from ..types import Norm, NormScope


def norm(norm_kind: Norm, A: BaseTiledMatrix,
         scope: NormScope = NormScope.Matrix, opts=None) -> torch.Tensor:
    """‖A‖ for Max/One/Inf/Fro (reference src/norm.cc): a 0-dim real
    tensor on A's device (a vector for ``NormScope.Columns``)."""
    slate_error_if(A.grid.size != 1,
                   "norm: multi-device grids are not ported yet")
    if scope == NormScope.Columns:
        return col_norms(norm_kind, A, opts)
    A = A.materialize()
    sym = isinstance(A, (HermitianMatrix, SymmetricMatrix))
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
    valid = masks.valid_mask(A.mtl, A.ntl, A.nb, A.m, A.n, A.data.device)
    absa = torch.where(valid, A.data[0, 0].abs(), 0)
    return absa.amax(dim=(0, 2)).reshape(-1)[:A.n]
