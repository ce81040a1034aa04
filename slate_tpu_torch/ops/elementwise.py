"""Elementwise and utility ops (reference src/add.cc, copy.cc, scale.cc,
scale_row_col.cc, set.cc; counterpart of ``slate_tpu/ops/elementwise.py``).

Each is one masked vectorized op over the rank-stacked tile array
``data[p, q, mtl, ntl, nb, nb]``; on a p×q grid every slot reads its
global row and column from ``internal/masks.py`` (the JAX package's
``shard_map`` bodies, one per rank, are one op over the rank axes here).
They keep the zero-padding invariant on every rank: nothing is written
outside the true m×n region (or, for ``set_matrix``, outside the
``uplo`` triangle or band), so BLAS and the factorizations can skip
ragged-edge handling. No op moves data between ranks.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..internal import masks
from ..matrix import BaseTiledMatrix


def _scalar(x, A) -> torch.Tensor:
    return torch.as_tensor(x, dtype=A.dtype, device=A.data.device)


def _check_layout(A, B, routine: str) -> None:
    slate_error_if(A.shape != B.shape, f"{routine} dims")
    slate_error_if(A.grid != B.grid or A.nb != B.nb,
                   f"{routine}: matrices must share a grid and a tile size")


def _elem_index(A):
    """Global row and column of every element of A's rank-stacked tile
    array, broadcastable to ``[p, q, mtl, ntl, nb, nb]``."""
    g = A.grid
    return masks.grid_elem_index(g.p, g.q, A.mtl, A.ntl, A.nb, A.data.device)


def add(alpha, A: BaseTiledMatrix, beta, B: BaseTiledMatrix):
    """B = alpha·A + beta·B (reference src/add.cc)."""
    A = A.materialize()
    _check_layout(A, B, "add")
    data = (_scalar(alpha, B) * A.data.to(B.dtype)
            + _scalar(beta, B) * B.data)
    return B._replace(data=data)


def copy(A: BaseTiledMatrix, B: BaseTiledMatrix):
    """B = A with precision conversion (reference src/copy.cc)."""
    A = A.materialize()
    _check_layout(A, B, "copy")
    return B._replace(data=A.data.to(B.dtype))


def scale(numer, denom, A: BaseTiledMatrix):
    """A = (numer/denom)·A (reference src/scale.cc)."""
    return A._replace(data=A.data * (_scalar(numer, A) / _scalar(denom, A)))


def scale_row_col(R, C, A: BaseTiledMatrix):
    """A = diag(R)·A·diag(C), row and column equilibration (reference
    src/scale_row_col.cc); R [m] and C [n], replicated. Each slot reads R
    and C at its global rows and columns (``_scale_rc_jit``,
    ``elementwise.py:107-124``); the padding is scaled by 0."""
    g, dev = A.grid, A.data.device
    nb, mtl, ntl = A.nb, A.mtl, A.ntl
    rp = torch.zeros(mtl * g.p * nb, dtype=A.dtype, device=dev)
    cp = torch.zeros(ntl * g.q * nb, dtype=A.dtype, device=dev)
    rp[:A.m] = torch.as_tensor(R, dtype=A.dtype, device=dev)
    cp[:A.n] = torch.as_tensor(C, dtype=A.dtype, device=dev)
    rv = rp[masks.local_elem_rows(mtl, nb, g.p, dev)]   # [p, mtl, nb]
    cv = cp[masks.local_elem_cols(ntl, nb, g.q, dev)]   # [q, ntl, nb]
    out = (A.data * rv.view(g.p, 1, mtl, 1, nb, 1)) \
        * cv.view(1, g.q, 1, ntl, 1, nb)
    return A._replace(data=out)


def set_matrix(offdiag_value, diag_value, A: BaseTiledMatrix):
    """A[i, j] = offdiag (i ≠ j), diag (i = j) inside the shape's valid
    region, zero outside it (reference src/set.cc)."""
    er, ec = _elem_index(A)
    vals = torch.where(er == ec, _scalar(diag_value, A),
                       _scalar(offdiag_value, A))
    data = torch.where(masks.shape_mask(A, stacked=True), vals, 0)
    return A._replace(data=data.to(A.dtype).expand_as(A.data).contiguous())


def _add_scaled_identity(A: BaseTiledMatrix, sigma):
    """A += sigma·I on the true diagonal (shift and regularize paths).
    The JAX package stops the diagonal at row m only, so on a wide
    padding of a matrix with m > n it writes past column n; the port
    stops at min(m, n) and keeps the padding zero."""
    er, ec = _elem_index(A)
    diag = (er == ec) & (er < min(A.m, A.n))
    data = A.data + torch.where(diag, _scalar(sigma, A), 0).to(A.dtype)
    return A._replace(data=data)
