"""Level-3 BLAS on a 1×1 grid (reference src/gemm.cc, src/herk.cc,
src/syrk.cc, src/trsm.cc; counterpart of ``slate_tpu/ops/blas.py``).

The routines return the updated output matrix, as the JAX package does:
``C = gemm(alpha, A, B, beta, C)``.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..internal.masks import tile_diag_pad_identity
from ..internal.precision import full_f32_matmul, resolve_tier, tier_addmm
from ..internal.tile_kernels import tile_trsm_left_lower
from ..matrix import Matrix, cdiv, tiles_to_dense, dense_to_tiles
from ..types import Diag, Op, Side, Uplo


def _check_compat(*mats):
    g = mats[0].grid
    nb = mats[0].nb
    for M in mats[1:]:
        slate_error_if(M.grid != g, "matrices must share a grid")
        slate_error_if(M.nb != nb, "matrices must share a tile size")


# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------

def gemm(alpha, A: Matrix, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha·op(A)·op(B) + beta·C (reference src/gemm.cc:66-89).

    On one device the block product is one dense matmul (the JAX package
    leaves it to XLA the same way); it runs at the tier of
    ``Option.TrailingPrecision``, full FP32 by default."""
    A = A.materialize()
    B = B.materialize()
    slate_error_if(C.op != Op.NoTrans, "C must not be transposed")
    slate_error_if(A.m != C.m or B.n != C.n or A.n != B.m,
                   f"gemm dims: {A.shape} x {B.shape} -> {C.shape}")
    _check_compat(A, B, C)
    tier = resolve_tier(opts)
    nb = C.nb
    kt = cdiv(A.n, nb)
    mtl, ntl = C.mtl, C.ntl
    a = tiles_to_dense(A.data[0, 0], mtl * nb, kt * nb)
    b = tiles_to_dense(B.data[0, 0], kt * nb, ntl * nb)
    c = tiles_to_dense(C.data[0, 0], mtl * nb, ntl * nb)
    c = tier_addmm(c, a, b, beta=beta, alpha=alpha, tier=tier)
    data = dense_to_tiles(c, nb, mtl, ntl)[None, None]
    return C._replace(data=data)


# ---------------------------------------------------------------------------
# herk / syrk
# ---------------------------------------------------------------------------

def herk(alpha, A: Matrix, beta, C, opts=None):
    """C = alpha·op(A)·op(A)ᴴ + beta·C, C Hermitian (reference
    src/herk.cc). Like the JAX package's SUMMA loop on a 1×1 grid, it
    writes both triangles of C: one product at the tier of
    ``Option.TrailingPrecision``."""
    return _rank_k(alpha, A, beta, C, conj=True, opts=opts)


def syrk(alpha, A: Matrix, beta, C, opts=None):
    """C = alpha·op(A)·op(A)ᵀ + beta·C, C symmetric (reference
    src/syrk.cc); both triangles, as :func:`herk`."""
    return _rank_k(alpha, A, beta, C, conj=False, opts=opts)


def _rank_k(alpha, A, beta, C, conj: bool, opts=None):
    A = A.materialize()
    slate_error_if(A.m != C.m or C.m != C.n, "rank-k dims")
    _check_compat(A, C)
    tier = resolve_tier(opts)
    nb = C.nb
    a = tiles_to_dense(A.data[0, 0], A.mtl * nb, A.ntl * nb)
    c = tiles_to_dense(C.data[0, 0], C.mtl * nb, C.ntl * nb)
    c = tier_addmm(c, a, a.mH if conj else a.mT, beta=beta, alpha=alpha,
                   tier=tier)
    data = dense_to_tiles(c, nb, C.mtl, C.ntl)[None, None]
    return C._replace(data=data)


# ---------------------------------------------------------------------------
# trsm — block substitution
# ---------------------------------------------------------------------------

def trsm(side: Side, alpha, A, B: Matrix, opts=None) -> Matrix:
    """Solve op(A)·X = alpha·B (Left) or X·op(A) = alpha·B (Right), A
    triangular (reference src/trsm.cc). The transpose flags are resolved
    into storage first, so only the storage ``uplo`` is solved."""
    Am = A.materialize()
    B = B.materialize()
    if side == Side.Right:
        slate_error_if(Am.n != B.n, "trsm dims")
    else:
        slate_error_if(Am.m != B.m, "trsm dims")
    _check_compat(Am, B)
    lower = Am.uplo == Uplo.Lower
    unit = Am.diag == Diag.Unit
    if side == Side.Right:
        return _trsm_right(alpha, Am, B, lower, unit)
    return _trsm_left(alpha, Am, B, lower, unit)


def _diag_tile(A, k, lower, unit, n):
    akk = tile_diag_pad_identity(A.data[0, 0, k, k], k, n, A.nb)
    tri = akk.tril() if lower else akk.triu()
    if unit:
        tri = tri - torch.diag(torch.diagonal(tri)) + torch.eye(
            A.nb, dtype=tri.dtype, device=tri.device)
    return tri


def _trsm_left(alpha, A, B, lower, unit):
    """Block forward (lower) or backward (upper) substitution over the
    block rows of B: solve the diagonal tile against the real columns of
    the block row, ``[nb, B.n]``, then subtract its product from the
    remaining block rows. Works on a dense copy of B's real columns; the
    column padding of the result is zero."""
    nb = B.nb
    mt = cdiv(A.m, nb)
    x = tiles_to_dense(B.data[0, 0], B.mtl * nb, B.ntl * nb)[:, :B.n] * alpha
    with full_f32_matmul():                        # solves are always FP32
        for t in range(mt):
            k = t if lower else mt - 1 - t
            tri = _diag_tile(A, k, lower, unit, A.m)
            rk = slice(k * nb, (k + 1) * nb)
            if lower:
                solved = tile_trsm_left_lower(tri, x[rk], unit=unit)
            else:
                solved = torch.linalg.solve_triangular(
                    tri, x[rk], upper=True, left=True, unitriangular=unit)
            x[rk] = solved
            lo, hi = (k + 1, mt) if lower else (0, k)
            if hi > lo:
                acol = A.data[0, 0, lo:hi, k]      # [hi - lo, nb, nb]
                x[lo * nb:hi * nb] -= acol.reshape(-1, nb) @ solved
    data = dense_to_tiles(x, nb, B.mtl, B.ntl)[None, None]
    return B._replace(data=data)


def _trsm_right(alpha, A, B, lower, unit):
    """Block column substitution, the mirror of :func:`_trsm_left`; for
    lower A the block columns solve in reverse order."""
    nb = B.nb
    nt = cdiv(A.n, nb)
    mtl = B.mtl
    x = B.data[0, 0] * alpha                       # [mtl, ntl, nb, nb]
    with full_f32_matmul():
        for t in range(nt):
            k = nt - 1 - t if lower else t
            tri = _diag_tile(A, k, lower, unit, A.n)
            # block column k as one [mtl·nb, nb] left-hand side
            xcol = x[:, k].reshape(mtl * nb, nb)
            solved = torch.linalg.solve_triangular(
                tri, xcol, upper=not lower, left=False, unitriangular=unit)
            x[:, k] = solved.reshape(mtl, nb, nb)
            cols = slice(0, k) if lower else slice(k + 1, nt)
            arow = A.data[0, 0, k, cols]           # [c, nb, nb]
            c = arow.shape[0]
            if c:
                upd = solved @ arow.permute(1, 0, 2).reshape(nb, c * nb)
                x[:, cols] -= upd.reshape(mtl, nb, c, nb).permute(0, 2, 1, 3)
    return B._replace(data=x[None, None])
