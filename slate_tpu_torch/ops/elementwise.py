"""Elementwise and utility ops on one device (reference src/add.cc,
copy.cc, scale.cc, scale_row_col.cc, set.cc; counterpart of
``slate_tpu/ops/elementwise.py``).

Each is one masked vectorized op over the tile stack. They keep the
zero-padding invariant: nothing is written outside the true m×n region
(or, for ``set_matrix``, outside the ``uplo`` triangle or band), so BLAS
and the factorizations can skip ragged-edge handling.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..grid import require_one_rank
from ..internal import masks
from ..matrix import BaseTiledMatrix


def _scalar(x, A) -> torch.Tensor:
    return torch.as_tensor(x, dtype=A.dtype, device=A.data.device)


def add(alpha, A: BaseTiledMatrix, beta, B: BaseTiledMatrix):
    """B = alpha·A + beta·B (reference src/add.cc)."""
    require_one_rank(A.grid, "add")
    slate_error_if(A.shape != B.shape, "add dims")
    A = A.materialize()
    data = (_scalar(alpha, B) * A.data.to(B.dtype)
            + _scalar(beta, B) * B.data)
    return B._replace(data=data)


def copy(A: BaseTiledMatrix, B: BaseTiledMatrix):
    """B = A with precision conversion (reference src/copy.cc)."""
    require_one_rank(A.grid, "copy")
    slate_error_if(A.shape != B.shape, "copy dims")
    A = A.materialize()
    return B._replace(data=A.data.to(B.dtype))


def scale(numer, denom, A: BaseTiledMatrix):
    """A = (numer/denom)·A (reference src/scale.cc)."""
    require_one_rank(A.grid, "scale")
    return A._replace(data=A.data * (_scalar(numer, A) / _scalar(denom, A)))


def scale_row_col(R, C, A: BaseTiledMatrix):
    """A = diag(R)·A·diag(C), row and column equilibration (reference
    src/scale_row_col.cc); R [m] and C [n]. The padding is scaled by 0."""
    require_one_rank(A.grid, "scale_row_col")
    dev = A.data.device
    nb, mtl, ntl = A.nb, A.mtl, A.ntl
    rp = torch.zeros(mtl * nb, dtype=A.dtype, device=dev)
    cp = torch.zeros(ntl * nb, dtype=A.dtype, device=dev)
    rp[:A.m] = torch.as_tensor(R, dtype=A.dtype, device=dev)
    cp[:A.n] = torch.as_tensor(C, dtype=A.dtype, device=dev)
    out = (A.data * rp.view(mtl, 1, nb, 1)) * cp.view(1, ntl, 1, nb)
    return A._replace(data=out)


def set_matrix(offdiag_value, diag_value, A: BaseTiledMatrix):
    """A[i, j] = offdiag (i ≠ j), diag (i = j) inside the shape's valid
    region, zero outside it (reference src/set.cc)."""
    require_one_rank(A.grid, "set_matrix")
    er, ec = masks.elem_index(A.mtl, A.ntl, A.nb, A.data.device)
    vals = torch.where(er == ec, _scalar(diag_value, A),
                       _scalar(offdiag_value, A))
    data = torch.where(masks.shape_mask(A), vals, 0).to(A.dtype)
    return A._replace(data=data.reshape(A.data.shape))


def _add_scaled_identity(A: BaseTiledMatrix, sigma):
    """A += sigma·I on the true diagonal (shift and regularize paths).
    The JAX package stops the diagonal at row m only, so on a wide
    padding of a matrix with m > n it writes past column n; the port
    stops at min(m, n) and keeps the padding zero."""
    er, ec = masks.elem_index(A.mtl, A.ntl, A.nb, A.data.device)
    diag = (er == ec) & (er < min(A.m, A.n))
    data = A.data + torch.where(diag, _scalar(sigma, A), 0).to(A.dtype)
    return A._replace(data=data)
