"""Level-3 BLAS on a 1×1 grid (reference src/gemm.cc, hemm.cc, herk.cc,
her2k.cc, symm.cc, syrk.cc, syr2k.cc, trmm.cc, trsm.cc, gbmm.cc, hbmm.cc,
tbsm.cc; counterpart of ``slate_tpu/ops/blas.py``).

The routines return the updated output matrix, as the JAX package does:
``C = gemm(alpha, A, B, beta, C)``. Shaped operands are normalised first
and then multiplied by :func:`gemm`: a Hermitian or symmetric half is
mirrored into a general matrix, a triangle extracted. The band routines
pack the band and run the packed products and solves of
``internal/band_packed.py``.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..internal import band_packed as _bp
from ..internal import masks
from ..internal.masks import tile_diag_pad_identity
from ..internal.precision import full_f32_matmul, resolve_tier, tier_addmm
from ..internal.tile_kernels import tile_trsm_left_lower
from ..matrix import (BandMatrix, Matrix, cdiv, check_rhs_dtype,
                      conj_transpose, dense_to_tiles, tiles_to_dense,
                      transpose)
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


def her2k(alpha, A, B, beta, C, opts=None):
    """C = alpha·A·Bᴴ + conj(alpha)·B·Aᴴ + beta·C (reference
    src/her2k.cc): two products, both triangles written, as the JAX
    package's two SUMMA calls do."""
    G = gemm(alpha, A, conj_transpose(B), beta, _as_general(C), opts)
    calpha = complex(alpha).conjugate() if C.dtype.is_complex else alpha
    G = gemm(calpha, B, conj_transpose(A), 1.0, G, opts)
    return C._replace(data=G.data)


def syr2k(alpha, A, B, beta, C, opts=None):
    """C = alpha·A·Bᵀ + alpha·B·Aᵀ + beta·C (reference src/syr2k.cc)."""
    G = gemm(alpha, A, transpose(B), beta, _as_general(C), opts)
    G = gemm(alpha, B, transpose(A), 1.0, G, opts)
    return C._replace(data=G.data)


def _as_general(C) -> Matrix:
    return Matrix(data=C.data, m=C.m, n=C.n, nb=C.nb, grid=C.grid)


# ---------------------------------------------------------------------------
# hemm / symm — one operand Hermitian or symmetric
# ---------------------------------------------------------------------------

def hemm(side: Side, alpha, A, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha·A·B + beta·C (Left) or alpha·B·A + beta·C (Right) with A
    Hermitian (reference src/hemm.cc): A's significant half is mirrored
    into a general matrix, then one :func:`gemm`."""
    Afull = _mirror_full(A, conj=True)
    if side == Side.Left:
        return gemm(alpha, Afull, B, beta, C, opts)
    return gemm(alpha, B, Afull, beta, C, opts)


def symm(side: Side, alpha, A, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """As :func:`hemm` with A symmetric (reference src/symm.cc)."""
    Afull = _mirror_full(A, conj=False)
    if side == Side.Left:
        return gemm(alpha, Afull, B, beta, C, opts)
    return gemm(alpha, B, Afull, beta, C, opts)


def _mirror_full(A, conj: bool) -> Matrix:
    """The full matrix of a Hermitian (``conj``) or symmetric A from its
    significant half: the strict half plus its (conjugate) transpose plus
    the diagonal, whose real part alone counts when ``conj`` (the JAX
    ``_mirror_full_jit``, ``blas.py:437-470``, adds the half to its tile
    transpose and halves the diagonal: the same matrix). The padding
    stays zero."""
    slate_error_if(A.op != Op.NoTrans, "mirror before transpose views")
    slate_error_if(A.m != A.n or A.mtl != A.ntl,
                   "mirror needs a square matrix")
    data = A.data[0, 0]
    dev = data.device
    er, ec = masks.elem_index(A.mtl, A.ntl, A.nb, dev)
    strict = masks.uplo_mask(A.mtl, A.ntl, A.nb, A.uplo == Uplo.Lower,
                             strict=True, device=dev)
    half = torch.where(strict, data, 0)
    mirrored = half.permute(1, 0, 3, 2)
    diag = torch.where(er == ec, data, 0)
    if conj and data.is_complex():
        mirrored, diag = mirrored.conj(), diag.real.to(data.dtype)
    full = half + mirrored + diag
    return Matrix(data=full[None, None], m=A.m, n=A.n, nb=A.nb, grid=A.grid)


# ---------------------------------------------------------------------------
# trmm — triangular matrix-matrix multiply
# ---------------------------------------------------------------------------

def trmm(side: Side, alpha, A, B: Matrix, opts=None) -> Matrix:
    """B = alpha·op(A)·B (Left) or alpha·B·op(A) (Right), A triangular
    (reference src/trmm.cc): A's triangle is extracted into a general
    matrix, then one :func:`gemm`; a new matrix comes back."""
    Atri = _extract_triangle(A)
    C = Matrix.zeros(B.m, B.n, B.nb, B.grid, dtype=B.dtype)
    if side == Side.Left:
        return gemm(alpha, Atri, B, 0.0, C, opts)
    return gemm(alpha, B, Atri, 0.0, C, opts)


def _extract_triangle(A) -> Matrix:
    """op(A)'s triangle as a general matrix, the rest zero, a unit
    diagonal written as ones: the view is resolved first, which flips
    ``uplo`` (``blas.py:483-520``)."""
    A = A.materialize()
    tri = masks.uplo_mask(A.mtl, A.ntl, A.nb, A.uplo == Uplo.Lower,
                          device=A.data.device)
    out = torch.where(tri, A.data, 0)
    if A.diag == Diag.Unit:
        er, ec = masks.elem_index(A.mtl, A.ntl, A.nb, A.data.device)
        out = torch.where((er == ec) & (er < A.m), 1, out).to(A.dtype)
    return Matrix(data=out, m=A.m, n=A.n, nb=A.nb, grid=A.grid)


# ---------------------------------------------------------------------------
# trsm — block substitution
# ---------------------------------------------------------------------------

def trsm(side: Side, alpha, A, B: Matrix, opts=None) -> Matrix:
    """Solve op(A)·X = alpha·B (Left) or X·op(A) = alpha·B (Right), A
    triangular (reference src/trsm.cc). The transpose flags are resolved
    into storage first, so only the storage ``uplo`` is solved."""
    Am = A.materialize()
    B = check_rhs_dtype(B.materialize(), Am.dtype)
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


# ---------------------------------------------------------------------------
# band ops (reference src/gbmm.cc, hbmm.cc, tbsm.cc): packed band
# products and solves over ``internal/band_packed.py``
# ---------------------------------------------------------------------------

def gbmm(alpha, A, B: Matrix, beta, C: Matrix, opts=None) -> Matrix:
    """C = alpha·op(A)·op(B) + beta·C, A a general band (reference
    src/gbmm.cc): the packed band windows times B, O(m·(kl + ku)·n_B)
    flops (:func:`~..internal.band_packed.bandmm_packed`), at every size.
    The JAX package turns to gemm of the band-masked matrix past 256 MB
    of B, which its mesh would replicate on every device; on one card
    nothing is replicated, and that route would cost an n² copy of A
    and O(m·n·n_B) flops."""
    Am = A.materialize()
    Bm = B.materialize()
    kl, ku = Am.kl, Am.ku
    slate_error_if(Am.n != Bm.m, "gbmm dims")
    slate_error_if(C.op != Op.NoTrans, "C must not be transposed")
    nb = Am.nb
    ncols = cdiv(Am.m, nb) * nb + kl + ku
    ab = _bp.pack_tiled(Am, kl, ku, ncols, band=(kl, ku))
    b = _bp._b_to_dense(Bm, kl + ncols)
    b = torch.cat([b.new_zeros((kl, b.shape[1])), b])
    out = _bp.bandmm_packed(ab, b, Am.m, Am.n, kl, ku, nb)
    cd = _bp._b_to_dense(C, out.shape[0])
    if cd.shape[0] > out.shape[0]:
        out = torch.cat([out, out.new_zeros((cd.shape[0] - out.shape[0],
                                             out.shape[1]))])
    return _bp._dense_to_b(alpha * out[:cd.shape[0]] + beta * cd, C)


def hbmm(side: Side, alpha, A, B: Matrix, beta, C: Matrix,
         opts=None) -> Matrix:
    """C = alpha·A·B + beta·C (Left) or alpha·B·A + beta·C (Right), A a
    Hermitian band (reference src/hbmm.cc): the stored half is mirrored
    into a full band of half-width kd, then the packed band product; the
    right side multiplies B's columns directly
    (:func:`~..internal.band_packed.bandmm_packed_right`), without a transpose."""
    kd = A.kl if A.uplo != Uplo.Upper else A.ku
    Af = _mirror_full(A, conj=A.dtype.is_complex)
    Ab = BandMatrix(data=Af.data, m=A.m, n=A.n, nb=A.nb, grid=A.grid,
                    kl=kd, ku=kd)
    if side != Side.Right:
        return gbmm(alpha, Ab, B, beta, C, opts)
    Bm = B.materialize()
    slate_error_if(Bm.n != Ab.m, "hbmm dims")
    slate_error_if(C.op != Op.NoTrans, "C must not be transposed")
    nb = Ab.nb
    nt = cdiv(Ab.n, nb)
    ab = _bp.pack_tiled(Ab, kd, kd, nt * nb + nb + 2 * kd, band=(kd, kd))
    bd = _bp._b_to_dense(Bm, 0)
    need = nt * nb + 2 * kd
    bd = torch.nn.functional.pad(bd, (kd, max(0, need - kd - bd.shape[1])))
    out = _bp.bandmm_packed_right(ab, bd, Ab.m, Ab.n, kd, kd, nb)
    cd = _bp._b_to_dense(C, 0)
    out = torch.nn.functional.pad(out, (0, max(0, cd.shape[1] - out.shape[1]),
                                        0, max(0, cd.shape[0] - out.shape[0])))
    res = alpha * out[:cd.shape[0], :cd.shape[1]] + beta * cd
    return _bp._dense_to_b(res, C)


def tbsm(side: Side, alpha, A, B: Matrix, pivots=None,
         opts=None) -> Matrix:
    """Solve op(A)·X = alpha·B (Left) or X·op(A) = alpha·B (Right), A a
    triangular band, with ``pivots`` (LAPACK ipiv ``[kt, nb]`` or a
    ``PivotOrder``, as ``getrf`` gives) applied to B's rows first
    (reference src/tbsm.cc, tbsmPivots.cc). Both sides run the packed
    band solves (:func:`~..internal.band_packed.tbsm_packed`,
    :func:`~..internal.band_packed.tbsm_packed_right`), O(n·kd·nrhs)."""
    if pivots is not None:
        from ..linalg.getrf import _apply_pivots_matrix
        B = _apply_pivots_matrix(B, pivots, forward=True)
    Am = A.materialize()          # resolves op; flips uplo and kl/ku
    Bm = B.materialize()
    slate_error_if(Am.m != Am.n, "tbsm needs a square triangular factor")
    slate_error_if(Am.n != (Bm.n if side == Side.Right else Bm.m),
                   "tbsm dims")
    lower = Am.uplo == Uplo.Lower
    kd = Am.kl if lower else Am.ku
    n = Am.n
    nbw = _bp._band_block(n, kd)
    nt = cdiv(n, nbw)
    ab = _bp.pack_tiled(Am, kd if lower else 0, 0 if lower else kd,
                          nt * nbw + nbw + kd,
                          mode="tril" if lower else "triu")
    unit = Am.diag == Diag.Unit
    if side == Side.Right:
        bd = _bp._b_to_dense(Bm, 0)
        ncols = bd.shape[1]
        b2 = torch.nn.functional.pad(bd, (kd, max(0, nt * nbw + kd - ncols)
                                          + kd))
        if alpha != 1.0:
            b2 = alpha * b2
        x = _bp.tbsm_packed_right(ab, b2, n, kd, nbw, lower, unit)
        return _bp._dense_to_b(x[:, kd:kd + ncols], Bm)
    _check_compat(Am, Bm)
    b = _bp._b_to_dense(Bm, nt * nbw + kd)
    if alpha != 1.0:
        b = alpha * b
    x = _bp.tbsm_packed(ab, b, n, kd, nbw, lower, unit)
    return _bp._dense_to_b(x, Bm)

