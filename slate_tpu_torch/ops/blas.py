"""Level-3 BLAS (reference src/gemm.cc, hemm.cc, herk.cc, her2k.cc,
symm.cc, syrk.cc, syr2k.cc, trmm.cc, trsm.cc, gbmm.cc, hbmm.cc, tbsm.cc;
counterpart of ``slate_tpu/ops/blas.py``).

The routines return the updated output matrix, as the JAX package does:
``C = gemm(alpha, A, B, beta, C)``. Shaped operands are normalised first
and then multiplied by :func:`gemm`: a Hermitian or symmetric half is
mirrored into a general matrix, a triangle extracted. The band routines
pack the band and run the packed products and solves of
``internal/band_packed.py``.

On a p×q grid ``gemm`` (SUMMA, the Cannon ring and stationary-A),
``herk``/``syrk`` and ``trsm`` (both sides) are the JAX package's SPMD
bodies over the rank-stacked tiles (``blas.py:131-352``, ``:560-660``),
with the collectives of ``internal/comm.py``; ``hemm``/``symm``,
``her2k``/``syr2k`` and ``trmm`` normalise their shaped operand on the
grid (the mirror through the block-cyclic transpose) and multiply by
those. The band BLAS (``gbmm``, ``hbmm``, ``tbsm``) runs on one rank
only and refuses a p×q grid, as do the band factorizations (``gbtrs``
alone takes a p×q right-hand side, ``linalg/getrf.py``).
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..internal import band_packed as _bp
from ..internal import comm, masks
from ..internal.masks import tile_diag_pad_identity
from ..internal.precision import (full_f32_matmul, resolve_tier,
                                  tier_addmm, tier_mm)
from ..internal.tile_kernels import tile_trsm_left_lower
from ..matrix import (BandMatrix, Matrix, cdiv, check_rhs_dtype,
                      conj_transpose, dense_to_tiles, tiles_to_dense,
                      transpose)
from ..types import Diag, MethodGemm, Op, Option, Side, Uplo, get_option


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
    if C.grid.size > 1:
        method = get_option(opts, Option.MethodGemm, MethodGemm.Auto)
        if method == MethodGemm.Ring:
            return _gemm_ring_pq(alpha, A, B, beta, C, tier)
        if method == MethodGemm.GemmA:
            return _gemm_a_pq(alpha, A, B, beta, C, tier)
        return _gemm_summa_pq(alpha, A, B, beta, C, tier)
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
    if C.grid.size > 1:
        return _rank_k_pq(alpha, A, beta, C, conj, tier)
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
    stays zero. On a p×q grid the mirror is the block-cyclic transpose
    of the half (``comm.transpose_tiles``, the JAX body's global tile
    transpose refitted to the grid), which holds where the row and
    column tile counts pad differently."""
    slate_error_if(A.op != Op.NoTrans, "mirror before transpose views")
    slate_error_if(A.m != A.n, "mirror needs a square matrix")
    if A.grid.size > 1:
        return _mirror_full_pq(A, conj)
    slate_error_if(A.mtl != A.ntl, "mirror needs a square matrix")
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


def _mirror_full_pq(A, conj: bool) -> Matrix:
    """:func:`_mirror_full` on a p×q grid (``blas.py:434-476``): the
    rank-stacked strict half and diagonal, and the half's transpose
    moved to its owners."""
    g = A.grid
    data = A.data
    dev = data.device
    er, ec = masks.grid_elem_index(g.p, g.q, A.mtl, A.ntl, A.nb, dev)
    strict = masks.uplo_mask(A.mtl, A.ntl, A.nb, A.uplo == Uplo.Lower,
                             strict=True, device=dev, p=g.p, q=g.q)
    half = torch.where(strict, data, 0)
    cplx = conj and data.is_complex()
    mirrored = comm.transpose_tiles(half, A.mt, A.nt, conj=cplx)
    diag = torch.where(er == ec, data, 0)
    if cplx:
        diag = diag.real.to(data.dtype)
    return Matrix(data=half + mirrored + diag, m=A.m, n=A.n, nb=A.nb,
                  grid=g)


# ---------------------------------------------------------------------------
# trmm — triangular matrix-matrix multiply
# ---------------------------------------------------------------------------

def trmm(side: Side, alpha, A, B: Matrix, opts=None) -> Matrix:
    """B = alpha·op(A)·B (Left) or alpha·B·op(A) (Right), A triangular
    (reference src/trmm.cc): A's triangle is extracted into a general
    matrix, then one :func:`gemm` (SUMMA on a p×q grid); a new matrix
    comes back."""
    Atri = _extract_triangle(A)
    C = Matrix.zeros(B.m, B.n, B.nb, B.grid, dtype=B.dtype)
    if side == Side.Left:
        return gemm(alpha, Atri, B, 0.0, C, opts)
    return gemm(alpha, B, Atri, 0.0, C, opts)


def _extract_triangle(A) -> Matrix:
    """op(A)'s triangle as a general matrix, the rest zero, a unit
    diagonal written as ones: the view is resolved first, which flips
    ``uplo`` (``blas.py:483-520``); the masks are rank-stacked on a p×q
    grid."""
    A = A.materialize()
    g, dev = A.grid, A.data.device
    tri = masks.uplo_mask(A.mtl, A.ntl, A.nb, A.uplo == Uplo.Lower,
                          device=dev, p=g.p, q=g.q)
    out = torch.where(tri, A.data, 0)
    if A.diag == Diag.Unit:
        er, ec = masks.grid_elem_index(g.p, g.q, A.mtl, A.ntl, A.nb, dev)
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
    if B.grid.size > 1:
        if side == Side.Right:
            return _trsm_right_pq(alpha, Am, B, lower, unit)
        return _trsm_left_pq(alpha, Am, B, lower, unit)
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
# p×q grid: the SPMD bodies over the rank-stacked tiles
# ---------------------------------------------------------------------------

def _outer_pq(rows, cols, tier):
    """The einsum ``aik,bkj->abij`` of a p×q body on every rank at once:
    ``rows`` [p, q, mtl, nb, kk] broadcast along the grid columns (so
    ``rows[r, c]`` does not depend on c) and ``cols`` [p, q, ntl, kk, nb]
    broadcast along the grid rows. The ranks' products are blocks of one
    product [p·mtl·nb, kk] · [kk, q·ntl·nb]; returns the rank-stacked
    [p, q, mtl, ntl, nb, nb] result."""
    lt = rows[:, 0]                                  # [p, mtl, nb, kk]
    rt = cols[0]                                     # [q, ntl, kk, nb]
    p, mtl, nb, kk = lt.shape
    q, ntl = rt.shape[0], rt.shape[1]
    nb2 = rt.shape[3]
    prod = tier_mm(lt.reshape(p * mtl * nb, kk),
                   rt.permute(2, 0, 1, 3).reshape(kk, q * ntl * nb2), tier)
    return prod.view(p, mtl, nb, q, ntl, nb2).permute(0, 3, 1, 4, 2, 5)


def _gemm_summa_pq(alpha, A, B, beta, C, tier):
    """SUMMA (``blas.py:131-167``): per block step k, A's tile column k
    broadcast along the grid rows, B's tile row k along the grid
    columns, and every rank's local product."""
    p, q = C.grid.p, C.grid.q
    kt = cdiv(A.n, C.nb)
    c = C.data * beta
    for k in range(kt):
        acol = comm.bcast_from_col(A.data[:, :, :, k // q], k % q)
        brow = comm.bcast_from_row(B.data[:, :, k // p], k % p)
        c += alpha * _outer_pq(acol, brow, tier)
    return C._replace(data=c)


def _gemm_ring_pq(alpha, A, B, beta, C, tier):
    """The generalised Cannon ring (``blas.py:170-264``): A pre-skewed by
    r along the grid columns and B by c along the grid rows, then
    L = lcm(p, q) steps in which rank (r, c) holds A's column classes and
    B's row classes ≡ r + c + s, whose common k-classes are one residue
    K₀ mod L (CRT), a strided subset of its slots; every step shifts each
    operand one hop (:func:`~..internal.comm.systolic_ring`)."""
    g = C.grid
    p, q, nb = g.p, g.q, C.nb
    L = comm.lcm(p, q)
    sA, sB = L // q, L // p
    a, b = A.data, B.data
    r_idx, c_idx = comm.coords(p, q, a.device)
    for t in range(1, p):                            # pre-skew A
        a = torch.where((r_idx >= t).view(p, 1, 1, 1, 1, 1),
                        comm.rotate_from_next(a, "q", q), a)
    for t in range(1, q):                            # pre-skew B
        b = torch.where((c_idx >= t).view(1, q, 1, 1, 1, 1),
                        comm.rotate_from_next(b, "p", p), b)
    mtl, ktlA = a.shape[2], a.shape[3]
    ktlB, ntl = b.shape[2], b.shape[3]
    Kn = max(cdiv(ktlA, sA), cdiv(ktlB, sB))
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, Kn * sA - ktlA))
    b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, 0, 0, Kn * sB - ktlB))
    a = a.reshape(p, q, mtl, Kn, sA, nb, nb)
    b = b.reshape(p, q, Kn, sB, ntl, nb, nb)
    dev = a.device
    ri = torch.arange(p, device=dev).view(p, 1).expand(p, q)
    ci = torch.arange(q, device=dev).view(1, q).expand(p, q)

    def consume(s, bufs, acc):
        a, b = bufs
        oA = torch.empty(p, q, dtype=torch.long)
        oB = torch.empty(p, q, dtype=torch.long)
        for r in range(p):
            for cc in range(q):
                res = r + cc + s
                a_res, b_res = res % q, res % p
                k0 = next(k for k in range(L)
                          if k % q == a_res and k % p == b_res)
                oA[r, cc] = (k0 - a_res) // q
                oB[r, cc] = (k0 - b_res) // p
        oA, oB = oA.to(dev), oB.to(dev)
        a_sub = a[ri, ci, :, :, oA]                  # [p, q, mtl, Kn, nb, nb]
        b_sub = b[ri, ci, :, oB]                     # [p, q, Kn, ntl, nb, nb]
        lhs = a_sub.permute(0, 1, 2, 4, 3, 5).reshape(p, q, mtl * nb,
                                                      Kn * nb)
        rhs = b_sub.permute(0, 1, 2, 4, 3, 5).reshape(p, q, Kn * nb,
                                                      ntl * nb)
        # each rank's product of its own slots, batched over the ranks
        upd = tier_mm(lhs, rhs, tier).view(p, q, mtl, nb, ntl, nb)
        return acc + alpha * upd.permute(0, 1, 2, 4, 3, 5)

    acc = comm.systolic_ring(L, (a, b), (("q", q), ("p", p)), consume,
                             C.data * beta)
    return C._replace(data=acc)


def _gemm_a_pq(alpha, A, B, beta, C, tier):
    """Stationary A (``blas.py:267-349``, reference gemmA.cc): B gathered
    to every rank in global order, each rank's product of its own A tiles
    with the rows of B of its k-classes (a partial C over every global
    tile column), and a reduce-scatter along the grid columns that sums
    the q partials and leaves each rank its own tile columns."""
    g = C.grid
    p, q, nb = g.p, g.q, C.nb
    b = B.data
    ntlB = b.shape[3]
    mtlC, ntlC = C.data.shape[2], C.data.shape[3]
    b_rows = comm.allgather_cyclic(b, p, "p")        # [p, q, ktB, ntlB, ..]
    b_full = comm.allgather_cyclic(b_rows.transpose(2, 3), q, "q")
    b_full = b_full.transpose(2, 3)                  # [p, q, ktB, ntB, ..]
    a = A.data
    ktlA = a.shape[3]
    ntB = b_full.shape[3]
    dev = a.device
    _, c_idx = comm.coords(p, q, dev)
    # rank column c's local k-slot m is global k = m·q + c
    kidx = (torch.arange(ktlA, device=dev).view(1, ktlA) * q
            + c_idx.view(q, 1)).clamp(max=b_full.shape[2] - 1)  # [q, ktlA]
    bk = b_full[0][torch.arange(q, device=dev).view(q, 1), kidx]
    lhs = a.permute(0, 1, 2, 4, 3, 5).reshape(p, q, mtlC * nb, ktlA * nb)
    rhs = bk.permute(0, 1, 3, 2, 4).reshape(1, q, ktlA * nb, ntB * nb)
    part = tier_mm(lhs, rhs, tier).view(p, q, mtlC, nb, ntB, nb)
    part = part.permute(0, 1, 2, 4, 3, 5)            # [p, q, mtlC, ntB, ..]
    part = (part.reshape(p, q, mtlC, ntlB, q, nb, nb)
                .permute(0, 1, 4, 3, 2, 5, 6)
                .reshape(p, q, q * ntlB, mtlC, nb, nb))
    mine = comm.psum_scatter_cols(part)              # [p, q, ntlB, mtlC, ..]
    upd = mine.transpose(2, 3)[:, :, :, :ntlC]
    if upd.shape[3] < ntlC:
        upd = torch.nn.functional.pad(
            upd, (0, 0, 0, 0, 0, ntlC - upd.shape[3]))
    return C._replace(data=C.data * beta + alpha * upd)


def _rank_k_pq(alpha, A, beta, C, conj, tier):
    """herk/syrk (``blas.py:352-396``): per block step k, A's tile column
    k gathered to every rank (the "B row" of a SUMMA, conjugate-
    transposed) and broadcast along the grid rows as the left operand;
    both triangles of C are written, the padding stays zero."""
    g = C.grid
    p, q, nb = g.p, g.q, C.nb
    kt = cdiv(A.n, nb)
    nt = C.nt
    mtl, ntl = C.mtl, C.ntl
    mt_p = A.mtl * p
    dev = C.data.device
    irows = masks.local_tile_rows(mtl, p, dev)       # [p, mtl]
    jcols = masks.local_tile_cols(ntl, q, dev)       # [q, ntl]
    keep = ((irows < nt).view(p, 1, mtl, 1, 1, 1)
            & (jcols < nt).view(1, q, 1, ntl, 1, 1))
    c = C.data * beta
    for k in range(kt):
        acol = A.data[:, :, :, k // q]               # [p, q, mtl, nb, nb]
        full = comm.allgather_panel_rows(acol, p, k % q)[0, 0]
        rows = comm.bcast_from_col(acol, k % q)
        cols = full[jcols.clamp(max=mt_p - 1)]       # [q, ntl, nb, nb]
        cols = cols.conj() if conj else cols
        cols = cols.transpose(-1, -2).unsqueeze(0).expand(
            (p,) + tuple(cols.shape[:2]) + (nb, nb))
        upd = _outer_pq(rows, cols, tier)
        c += alpha * torch.where(keep, upd, torch.zeros_like(upd))
    return C._replace(data=c)


def _diag_tile_pq(A, k, lower, unit, n):
    """Diagonal tile k broadcast from its owner, padded with an identity
    and cut to its triangle (a unit diagonal written as ones)."""
    p, q, nb = A.grid.p, A.grid.q, A.nb
    akk = comm.bcast_from_owner(A.data[:, :, k // p, k // q], k % p,
                                k % q)[0, 0]
    akk = tile_diag_pad_identity(akk, k, n, nb)
    tri = akk.tril() if lower else akk.triu()
    if unit:
        tri = tri - torch.diag(torch.diagonal(tri)) + torch.eye(
            nb, dtype=tri.dtype, device=tri.device)
    return tri


def _real_widths(ntl, q, nb, n):
    """Real columns of each rank column's local tile columns: ``ntr[c]``
    tiles hold any, ``w[c]`` columns in all (its last tile may be
    partial)."""
    ntr, w = [], []
    for c in range(q):
        cols = [min(nb, n - (b * q + c) * nb) for b in range(ntl)]
        cols = [x for x in cols if x > 0]
        ntr.append(len(cols))
        w.append(sum(cols))
    return ntr, w


def _trsm_left_pq(alpha, A, B, lower, unit):
    """op(A)·X = alpha·B by block rows (``blas.py:560-604``): per step k
    the diagonal tile broadcast from its owner, the owner row's block row
    solved (K3 for a lower float32 tile on the card), broadcast down the
    grid columns, and the remaining block rows updated by A's tile column
    k broadcast along the grid rows. Each rank column works on the real
    columns of its tiles only (padding columns stay zero): a block row
    [nb, w] per rank column."""
    g = B.grid
    p, q, nb = g.p, g.q, B.nb
    mt = cdiv(A.m, nb)
    mtl, ntl = B.mtl, B.ntl
    x = B.data * alpha
    ntr, w = _real_widths(ntl, q, nb, B.n)
    gi = masks.local_tile_rows(mtl, p, x.device)     # [p, mtl]
    with full_f32_matmul():                          # solves are FP32
        for t in range(mt):
            k = t if lower else mt - 1 - t
            tri = _diag_tile_pq(A, k, lower, unit, A.m)
            kr, ks = k % p, k // p
            acol = comm.bcast_from_col(A.data[:, :, :, k // q], k % q)
            lo, hi = (ks, mtl) if lower else (0, ks + 1)
            rem = (gi > k) if lower else (gi < k)
            lt = acol[:, 0, lo:hi]                   # [p, R, nb, nb]
            lt = torch.where(rem[:, lo:hi, None, None], lt,
                             torch.zeros_like(lt))
            R = hi - lo
            for c in range(q):
                if not w[c]:
                    continue
                # rank (kr, c)'s block row k, its real columns
                xr = x[kr, c, ks, :ntr[c]].permute(1, 0, 2).reshape(
                    nb, ntr[c] * nb)[:, :w[c]]
                if lower:
                    solved = tile_trsm_left_lower(tri, xr, unit=unit)
                else:
                    solved = torch.linalg.solve_triangular(
                        tri, xr, upper=True, left=True, unitriangular=unit)
                wide = torch.nn.functional.pad(solved,
                                               (0, ntr[c] * nb - w[c]))
                x[kr, c, ks, :ntr[c]] = wide.view(nb, ntr[c], nb).permute(
                    1, 0, 2)
                xb = comm.bcast_from_row(x[:, c:c + 1, ks, :ntr[c]], kr)
                # the block row as every rank of column c now holds it
                xk = xb[0, 0].permute(1, 0, 2).reshape(
                    nb, ntr[c] * nb)[:, :w[c]]
                upd = (lt.reshape(p * R * nb, nb) @ xk).view(p, R, nb, w[c])
                upd = torch.nn.functional.pad(upd, (0, ntr[c] * nb - w[c]))
                x[:, c, lo:hi, :ntr[c]] -= upd.view(
                    p, R, nb, ntr[c], nb).permute(0, 1, 3, 2, 4)
    return B._replace(data=x)


def _trsm_right_pq(alpha, A, B, lower, unit):
    """X·op(A) = alpha·B by block columns (``blas.py:607-660``), the
    mirror of :func:`_trsm_left_pq` with the grid axes swapped; for a
    lower A the block columns solve in reverse order."""
    g = B.grid
    p, q, nb = g.p, g.q, B.nb
    nt = cdiv(A.n, nb)
    mtl, ntl = B.mtl, B.ntl
    x = B.data * alpha
    gj = masks.local_tile_cols(ntl, q, x.device)     # [q, ntl]
    with full_f32_matmul():
        for t in range(nt):
            k = nt - 1 - t if lower else t
            tri = _diag_tile_pq(A, k, lower, unit, A.n)
            kc, ks = k % q, k // q
            xcol = x[:, kc, :, ks]                   # [p, mtl, nb, nb]
            solved = torch.linalg.solve_triangular(
                tri, xcol.reshape(p * mtl * nb, nb), upper=not lower,
                left=False, unitriangular=unit)
            x[:, kc, :, ks] = solved.view(p, mtl, nb, nb)
            xb = comm.bcast_from_col(x[:, :, :, ks], kc)   # [p, q, mtl, ..]
            arow = comm.bcast_from_row(A.data[:, :, k // p], k % p)
            rem = (gj < k) if lower else (gj > k)
            arow = torch.where(rem.view(1, q, ntl, 1, 1), arow,
                               torch.zeros_like(arow))
            x -= _outer_pq(xb, arow, "bf16_6x")
    return B._replace(data=x)


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

