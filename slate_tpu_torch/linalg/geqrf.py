"""QR/LQ factorization and least squares: geqrf, unmqr, gelqf, unmlq,
cholqr, gels (reference src/geqrf.cc, src/unmqr.cc, src/gelqf.cc,
src/cholqr.cc, src/gels.cc; counterpart of ``slate_tpu/linalg/geqrf.py``).

Two factorization paths on one rank, chosen as the JAX package chooses
them on one device:

* the **fast path** (:func:`_geqrf_fast_core`) for a matrix that is a
  whole number of nb-tiles with m ≥ n: each panel is its true shrinking
  [m − k·nb, nb] slice, factored by the subpanel kernel K6
  (``internal/panel_qr.py``) where it applies, the panel's T built from
  the reflectors' Gram matrix (:func:`_blocked_T`), and the trailing
  update A₂ ← A₂ − V·(Tᴴ·(Vᴴ·A₂)) as two products;
* the **dense path** (:func:`_geqrf_dense_1dev`) for every other shape:
  ``torch.geqrf`` on each panel's window, T by the ``larft`` recurrence,
  the same compact-WY trailing update.

Both run eagerly and update one dense copy of the matrix in place.

On a p×q grid of virtual ranks, geqrf and unmqr are the JAX package's
SPMD loops (``geqrf.py:213-329`` at depth 0, ``:428-527``) over the
rank-stacked tiles: per panel, the tile column gathered to every rank
(``comm.allgather_panel_rows``), factored once by ``torch.geqrf`` on its
window (``panel_qr_factor``, XLA's ``geqrf`` there), written back to its
owner column, its T from the reflectors' Gram matrix (:func:`panel_t`,
where the JAX body runs ``larft``'s nb-long recurrence), and the
compact-WY apply on the trailing slots alone: each rank's Vᴴ·A₂ as one
product batched over the ranks, ``comm.psum_rows``, then V·(Tᴴ·W) as
one product (:func:`_reflect_left_pq`; :func:`_reflect_right_pq` the
mirror along the grid columns). ``Option.PipelineDepth`` is accepted and
changes nothing (the JAX lookahead reorders the same arithmetic; the
ranks here share one stream). gelqf/unmlq go through the block-cyclic
transpose, and cholqr/gels through the p×q herk, potrf, trsm and gemm.

The factors are LAPACK's: R on and above the diagonal, the reflectors' unit
lower columns below it; ``T`` is the [kt, nb, nb] stack of the panels'
block-reflector triangles (SLATE's ``TriangularFactors``), with
H_k = I − V_k·T_k·V_kᴴ and Q = H_0·H_1·…
"""

from __future__ import annotations

import os

import torch

from ..errors import slate_error_if
from ..internal import comm, masks, panel_qr
from ..internal.precision import full_f32_matmul, resolve_tier, tier_mm
from ..internal.tile_kernels import (_factor_dtype, extract_v, larft,
                                     panel_qr_factor)
from ..matrix import (HermitianMatrix, Matrix, TriangularMatrix,
                      bc_from_tiles, bc_to_tiles, cdiv, check_rhs_dtype,
                      conj_transpose, dense_to_tiles, tiles_to_dense)
from ..ops.blas import _outer_pq, gemm, herk, trsm
from ..types import Diag, MethodGels, Op, Side, Uplo
from .potrf import potrf


def geqrf(A: Matrix, opts=None):
    """QR: A = Q·R (reference src/geqrf.cc). Returns ``(QR, T)``: QR
    holds the reflectors below and R on and above the diagonal, T the
    [kt, nb, nb] block-reflector triangles. A is not modified."""
    A = A.materialize()
    tier = resolve_tier(opts)
    if A.grid.size > 1:
        data, T = _geqrf_pq(A, tier)
    elif _qr_fast_applies(A):
        data, T = _geqrf_fast_core(A, _qr_panel_mode(A), tier)
    else:
        data, T = _geqrf_dense_1dev(A, tier)
    return A._replace(data=data), T


def _qr_panel_mode(A) -> str | None:
    """``"cuda"`` on the card, where the panels run the subpanel kernel
    K6 instead of ``torch.geqrf``; ``None`` on the CPU, which keeps
    ``torch.geqrf`` panels as the JAX package keeps XLA's off its chip.
    SLATE_QR_PANEL=1 forces the kernel path (on the CPU its plain
    version: ``"plain"``, the counterpart of Pallas interpret mode); =0
    turns it off."""
    flag = os.environ.get("SLATE_QR_PANEL", "")
    if flag == "0":
        return None
    on_card = A.grid.device.type == "cuda"
    if flag == "1":
        return "cuda" if on_card else "plain"
    return "cuda" if on_card else None


def _qr_fast_applies(A) -> bool:
    """The single-device fast path: a matrix that is a whole number of
    nb-tiles with m ≥ n. It turns on by itself on the card for
    n ≥ 2048; SLATE_QR_FAST=1 forces it on any device, =0 turns it off.
    The JAX package's cap of 64 block columns bounds its trace-time
    unrolling; an eager loop has none, so the port does not keep it."""
    flag = os.environ.get("SLATE_QR_FAST", "")
    if flag == "0":
        return False
    exact = (A.grid.size == 1 and A.m == A.mtl * A.nb
             and A.n == A.ntl * A.nb and A.m >= A.n)
    if not exact:
        return False
    if flag == "1":
        return True
    return A.grid.device.type == "cuda" and A.n >= 2048


def _blocked_T(G: torch.Tensor, taus: torch.Tensor, nb: int,
               base: int = 8) -> torch.Tensor:
    """Compact-WY T from the reflectors' Gram matrix G = VᴴV and taus:
    base-width T's by the larft column recurrence on G's diagonal blocks
    (batched), then log₂(nb/base) pairwise combines
    T = [[T₁, −T₁·G₁₂·T₂], [0, T₂]] — no nb-long sequential loop."""
    # the largest block width ≤ base with nb / bs a power of two
    bs = nb
    while bs > base and bs % 2 == 0:
        bs //= 2
    Gd = _diag_blocks(G, bs)                               # [C, bs, bs]
    tv = taus.reshape(-1, bs)
    Ts = torch.zeros_like(Gd)
    for j in range(bs):
        Ts[:, :j, j] = -tv[:, j:j + 1] * (
            Ts[:, :j, :j] @ Gd[:, :j, j:j + 1])[..., 0]
        Ts[:, j, j] = tv[:, j]
    size = bs
    while size < nb:
        T1, T2 = Ts[0::2], Ts[1::2]
        g12 = _diag_blocks(G, 2 * size)[:, :size, size:]
        T12 = -(T1 @ g12 @ T2)
        top = torch.cat([T1, T12], dim=2)
        bot = torch.cat([torch.zeros_like(T12), T2], dim=2)
        Ts = torch.cat([top, bot], dim=1)
        size *= 2
    return Ts[0]


def _diag_blocks(G: torch.Tensor, bs: int) -> torch.Tensor:
    """The diagonal [bs, bs] blocks of G as one [C, bs, bs] view."""
    C = G.shape[0] // bs
    return G.reshape(C, bs, C, bs).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def panel_t(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """The compact-WY T of one panel's reflectors (LAPACK larft's), from
    their Gram matrix VᴴV."""
    with full_f32_matmul():
        return _blocked_T(V.mH @ V, taus, V.shape[1])


def _geqrf_fast_core(A, panel_mode=None, tier="bf16_6x"):
    """Blocked QR on the dense matrix with true-shape shrinking panels
    (a whole number of nb-tiles, m ≥ n). Returns ``(data, T)``."""
    nb, m, n = A.nb, A.m, A.n
    kt = min(A.mt, A.nt)
    fd = _factor_dtype(A.dtype)
    a = tiles_to_dense(A.data[0, 0], m, n).to(fd)   # a new tensor, in place
    Ts = []
    for k in range(kt):
        r0 = k * nb
        w = min(nb, n - r0)
        pan = a[r0:, r0:r0 + w]                      # a view of a
        # the JAX package's own routing (geqrf.py:182-188): a panel the
        # kernel does not take goes to geqrf, on the card as on the TPU
        if (panel_mode is not None and fd == torch.float32
                and w % panel_qr.W == 0 and pan.shape[0] <= panel_qr.H_MAX):
            _, taus = panel_qr.qr_panel_blocked(pan)
        else:
            qr_, taus = torch.geqrf(pan)
            pan.copy_(qr_)
        V = extract_v(pan, 0, pan.shape[0])
        with full_f32_matmul():
            T = _blocked_T(V.mH @ V, taus, w)
        Ts.append(T)
        if r0 + w < n:
            C = a[r0:, r0 + w:]                      # a view of a
            W1 = tier_mm(V.mH, C, tier)
            with full_f32_matmul():
                W2 = T.mH @ W1
            C.sub_(tier_mm(V, W2, tier))
    T = torch.stack(Ts).to(A.dtype)
    tiles = dense_to_tiles(a.to(A.dtype), nb, A.mtl, A.ntl)
    return bc_from_tiles(tiles, 1, 1), T


def _geqrf_dense_1dev(A, tier):
    """Blocked QR on the dense (padded) matrix for every shape the fast
    path refuses — the one-device, sequential case of the JAX package's
    SPMD loop: per panel ``panel_qr_factor`` on its window, ``extract_v``
    and ``larft``, then A₂ ← A₂ − V·Tᴴ·(Vᴴ·A₂) on the columns right of
    it. V is zero above the panel's diagonal, so the products start
    there."""
    nb, m = A.nb, A.m
    kt = min(A.mt, A.nt)
    M, N = A.mtl * nb, A.ntl * nb
    a = tiles_to_dense(A.data[0, 0], M, N)           # a new tensor, in place
    T = torch.zeros((kt, nb, nb), dtype=A.dtype, device=a.device)
    for k in range(kt):
        r0 = k * nb
        pan, taus = panel_qr_factor(a[:, r0:r0 + nb], r0, m)
        a[:, r0:r0 + nb] = pan
        V = extract_v(pan, r0, m)[r0:]
        T[k] = larft(V, taus)
        if r0 + nb < A.nt * nb:
            C = a[r0:, r0 + nb:A.nt * nb]            # a view of a
            W1 = tier_mm(V.mH, C, tier)
            with full_f32_matmul():
                W2 = T[k].mH @ W1
            C.sub_(tier_mm(V, W2, tier))
    tiles = dense_to_tiles(a, nb, A.mtl, A.ntl)
    return bc_from_tiles(tiles, 1, 1), T


def unmqr(side: Side, trans: Op, QR: Matrix, T, C: Matrix, opts=None):
    """C ← op(Q)·C or C·op(Q) from geqrf factors (reference
    src/unmqr.cc); returns the new C.

    With H_k = I − V_k·T_k·V_kᴴ: Q·C applies the panels in reverse order
    with T, Qᴴ·C in forward order with Tᴴ; C·Q forward with T, C·Qᴴ in
    reverse with Tᴴ. ``Op.Trans`` is ``Op.ConjTrans`` for real dtypes
    (LAPACK dormqr accepts 'T') and raises for complex ones, as cunmqr
    does."""
    slate_error_if(trans == Op.Trans and QR.dtype.is_complex,
                   "unmqr: trans must be NoTrans or ConjTrans for complex "
                   "types (LAPACK cunmqr semantics)")
    notrans = trans == Op.NoTrans
    C = check_rhs_dtype(C.materialize(), QR.dtype)
    nb, m = QR.nb, QR.m
    kt = T.shape[0]
    slate_error_if(C.nb != nb, "unmqr: C and QR must share a tile size")
    slate_error_if((C.m if side == Side.Left else C.n) != m,
                   f"unmqr dims: Q is {m}×{m}, C is {C.m}×{C.n}")
    if C.grid.size > 1:
        return _unmqr_pq(side, notrans, QR, T, C)
    aq = tiles_to_dense(QR.data[0, 0], QR.mtl * nb, QR.ntl * nb)
    c = tiles_to_dense(C.data[0, 0], C.mtl * nb, C.ntl * nb)  # in place
    left = side == Side.Left
    # Q·C and C·Qᴴ run the panels in reverse
    order = range(kt - 1, -1, -1) if left == notrans else range(kt)
    with full_f32_matmul():
        for k in order:
            r0 = k * nb
            V = extract_v(aq[:, r0:r0 + nb], r0, m)[r0:]
            Top = T[k] if notrans else T[k].mH
            if left:
                cc = c[r0:]                          # a view of c
                cc.sub_(V @ (Top @ (V.mH @ cc)))
            else:
                cc = c[:, r0:r0 + V.shape[0]]        # a view of c
                cc.sub_(((cc @ V) @ Top) @ V.mH)
    data = dense_to_tiles(c, nb, C.mtl, C.ntl)[None, None]
    return C._replace(data=data)


def gelqf(A: Matrix, opts=None):
    """LQ: A = L·Q as the QR of Aᴴ (reference src/gelqf.cc uses
    dedicated LQ kernels; the transpose is the same in exact arithmetic).
    Returns ``(LQ, T)``, the QR factors of Aᴴ."""
    return geqrf(conj_transpose(A).materialize(), opts)


def unmlq(side: Side, trans: Op, LQ: Matrix, T, C: Matrix, opts=None):
    """Apply Q from gelqf (reference src/unmlq.cc): Q_lq = (Q_qr)ᴴ."""
    flip = Op.NoTrans if trans != Op.NoTrans else Op.ConjTrans
    return unmqr(side, flip, LQ, T, C, opts)


def cholqr(A: Matrix, opts=None):
    """Cholesky QR (reference src/cholqr.cc): R = chol(AᴴA) upper,
    Q = A·R⁻¹. Returns ``(Q, R, info)``."""
    Cg = HermitianMatrix.zeros(A.n, A.n, A.nb, A.grid, dtype=A.dtype,
                               uplo=Uplo.Lower)
    Cg = herk(1.0, conj_transpose(A), 0.0, Cg, opts)   # AᴴA
    L, info = potrf(Cg, opts)
    Q = trsm(Side.Right, 1.0, conj_transpose(L), A, opts)   # A·L⁻ᴴ
    R = conj_transpose(L).materialize()
    R = TriangularMatrix(data=R.data, m=A.n, n=A.n, nb=A.nb, grid=A.grid,
                         uplo=Uplo.Upper, diag=Diag.NonUnit)
    return Q, R, info


def gels(A: Matrix, BX: Matrix, opts=None) -> Matrix:
    """Least squares (reference src/gels.cc → gels_qr.cc /
    gels_cholqr.cc). For m ≥ n, min‖A·X − B‖₂ by Householder QR or
    CholQR (``Option.MethodGels``); for m < n the minimum-norm solution
    through LQ: A = R̂ᴴ·Q̂ᴴ ⇒ X = Q̂·[R̂⁻ᴴ·B; 0]. Returns X [n, nrhs]."""
    if A.m < A.n:
        LQ, T = gelqf(A, opts)                  # QR factors of Aᴴ [n, m]
        Rh = _upper_view(LQ)
        Y = trsm(Side.Left, 1.0, conj_transpose(Rh), BX, opts)
        return unmqr(Side.Left, Op.NoTrans, LQ, T, _pad_rows(Y, A.n), opts)
    if MethodGels.select_algo(A, BX, opts) == MethodGels.Cholqr:
        Q, R, info = cholqr(A, opts)
        return trsm(Side.Left, 1.0, R, _gemm_qhb(Q, BX), opts)
    QR, T = geqrf(A, opts)
    QhB = unmqr(Side.Left, Op.ConjTrans, QR, T, BX, opts)
    return trsm(Side.Left, 1.0, _upper_view(QR), _top_rows(QhB, A.n), opts)


def _gemm_qhb(Q: Matrix, B: Matrix) -> Matrix:
    C = Matrix.zeros(Q.n, B.n, Q.nb, Q.grid, dtype=B.dtype)
    return gemm(1.0, conj_transpose(Q), B, 0.0, C)


def _upper_view(QR: Matrix) -> TriangularMatrix:
    """The top-left n×n upper triangle of a QR result."""
    ntR = cdiv(QR.n, QR.nb)
    sub = QR.sub(0, ntR - 1, 0, ntR - 1)
    return TriangularMatrix(data=sub.data, m=QR.n, n=QR.n, nb=QR.nb,
                            grid=QR.grid, uplo=Uplo.Upper, diag=Diag.NonUnit)


def _top_rows(B: Matrix, n: int) -> Matrix:
    """The first n rows of B as a matrix of their own."""
    sub = B.sub(0, cdiv(n, B.nb) - 1, 0, B.nt - 1)
    return Matrix(data=sub.data, m=n, n=B.n, nb=B.nb, grid=B.grid)


def _pad_rows(B: Matrix, m_new: int) -> Matrix:
    """B extended with zero rows to m_new (its padding is zero, so only
    tile rows are appended), the tile rows rounded up to a multiple of
    the grid's p (``_pad_rows_jit``, ``geqrf.py:619-632``)."""
    B = B.materialize()
    g = B.grid
    tiles = bc_to_tiles(B.data)
    mt_new = cdiv(cdiv(m_new, B.nb), g.p) * g.p
    out = tiles.new_zeros((mt_new,) + tuple(tiles.shape[1:]))
    keep = min(mt_new, tiles.shape[0])
    out[:keep] = tiles[:keep]
    return Matrix(data=bc_from_tiles(out, g.p, g.q), m=m_new, n=B.n,
                  nb=B.nb, grid=g)


# ---------------------------------------------------------------------------
# p×q grid: the SPMD loops over the rank-stacked tiles
# ---------------------------------------------------------------------------

def _gather_col_panel(data: torch.Tensor, k: int) -> torch.Tensor:
    """Tile column k gathered to every rank (``allgather_panel_rows``),
    one rank's copy as a full-height panel [mtl·p·nb, nb] in global row
    order."""
    p, q, nb = data.shape[0], data.shape[1], data.shape[-1]
    full = comm.allgather_panel_rows(data[:, :, :, k // q], p, k % q)
    return full[0, 0].reshape(-1, nb)


def _put_col_panel(data: torch.Tensor, k: int, panel: torch.Tensor):
    """A gathered panel written back to its owner column: each rank row
    takes its own slots."""
    p, q, mtl, nb = data.shape[:3] + data.shape[-1:]
    gi = masks.local_tile_rows(mtl, p, data.device)
    data[:, k % q, :, k // q] = panel.view(-1, nb, nb)[gi]


def _gather_row_panel(data: torch.Tensor, k: int) -> torch.Tensor:
    """Tile row k gathered along the grid columns to every rank and
    conjugate-transposed into column-panel form [ntl·q·nb, nb] (row i of
    the panel is global column i; ``ge2tb.py:104-114``)."""
    p, q, nb = data.shape[0], data.shape[1], data.shape[-1]
    row = comm.bcast_from_row(data[:, :, k // p], k % p)
    full = comm.allgather_cyclic(row, q, comm.AXIS_Q)[0, 0]
    return full.mH.reshape(-1, nb)


def _put_row_panel(data: torch.Tensor, k: int, panel: torch.Tensor):
    """A row panel in column-panel form written back to tile row k of its
    owner row, each rank column taking its own slots."""
    p, q, _, ntl, nb = data.shape[:5]
    gj = masks.local_tile_cols(ntl, q, data.device)
    data[k % p, :, k // p] = panel.view(-1, nb, nb).mH[gj]


def _qr_panel_pq(panel: torch.Tensor, start: int, m: int):
    """Factor a gathered panel on its window [start, m), once for every
    rank. Returns the factored panel, V [rows, nb] and T."""
    panel, taus = panel_qr_factor(panel, start, m)
    V = extract_v(panel, start, m)
    return panel, V, panel_t(V[start:m], taus)


def _slots(V: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """V's tiles at the global tile indices ``idx`` (any shape), zero
    where ``idx`` is past V's tiles."""
    vt = V.view(-1, nb, nb)
    got = vt[idx.clamp(max=vt.shape[0] - 1)]
    return torch.where((idx < vt.shape[0])[..., None, None], got,
                       torch.zeros_like(got))


def _reflect_left_pq(c: torch.Tensor, V: torch.Tensor, Top: torch.Tensor,
                     lo: int, col_lo: int, mt: int, nt: int,
                     tier: str = "bf16_6x") -> None:
    """C ← C − V·Top·(Vᴴ·C) in place on rank-stacked tiles ``c``, over the
    tile rows from ``lo`` (V is zero above them) and the tile columns
    from ``col_lo``, within the true mt × nt tiles: the JAX body's
    ``einsum("aiv,abij->bvj")`` + ``psum_rows`` + outer product
    (``geqrf.py:291-306``, ``:444-455``) on the window of slots from
    (lo // p, col_lo // q). V [rows, nb] is in global row order, the same
    on every rank."""
    p, q, mtl, ntl, nb, _ = c.shape
    a_lo, a_hi = lo // p, cdiv(mt, p)
    b_lo, b_hi = col_lo // q, cdiv(nt, q)
    R, B = a_hi - a_lo, b_hi - b_lo
    if R <= 0 or B <= 0:
        return
    dev = c.device
    gi = masks.local_tile_rows(mtl, p, dev)[:, a_lo:a_hi]    # [p, R]
    gj = masks.local_tile_cols(ntl, q, dev)[:, b_lo:b_hi]    # [q, B]
    vloc = _slots(V, gi, nb)                                  # [p, R, nb, nb]
    cw = c[:, :, a_lo:a_hi, b_lo:b_hi]                        # a view of c
    # each rank's Vᴴ·C over its own slots, batched over the ranks
    rhs = cw.permute(0, 2, 4, 1, 3, 5).reshape(p, R * nb, q * B * nb)
    part = tier_mm(vloc.reshape(p, R * nb, nb).mH, rhs, tier)
    part = part.view(p, nb, q, B, nb).permute(0, 2, 3, 1, 4)
    w = comm.psum_rows(part)[0]                               # [q, B, nb, nb]
    keep = (gj >= col_lo) & (gj < nt)
    w = torch.where(keep[..., None, None], w, torch.zeros_like(w))
    with full_f32_matmul():
        tw = Top @ w
    cw -= _outer_pq(vloc.unsqueeze(1), tw.unsqueeze(0), tier)


def _reflect_right_pq(c: torch.Tensor, V: torch.Tensor, Top: torch.Tensor,
                      lo: int, row_lo: int, mt: int, nt: int,
                      tier: str = "bf16_6x") -> None:
    """C ← C − (C·V)·Top·Vᴴ in place on rank-stacked tiles ``c``, over the
    tile columns from ``lo`` (V, indexed by C's columns, is zero before
    them) and the tile rows from ``row_lo``: the mirror of
    :func:`_reflect_left_pq` with ``psum_cols`` (``geqrf.py:476-527``,
    ``ge2tb.py:131-142``). Tile columns past V's rows see a zero V
    block."""
    p, q, mtl, ntl, nb, _ = c.shape
    a_lo, a_hi = row_lo // p, cdiv(mt, p)
    b_lo, b_hi = lo // q, cdiv(nt, q)
    R, B = a_hi - a_lo, b_hi - b_lo
    if R <= 0 or B <= 0:
        return
    dev = c.device
    gi = masks.local_tile_rows(mtl, p, dev)[:, a_lo:a_hi]    # [p, R]
    gj = masks.local_tile_cols(ntl, q, dev)[:, b_lo:b_hi]    # [q, B]
    vcol = _slots(V, gj, nb)                                  # [q, B, nb, nb]
    cw = c[:, :, a_lo:a_hi, b_lo:b_hi]                        # a view of c
    # each rank's C·V over its own slots, batched over the ranks
    lhs = cw.permute(1, 0, 2, 4, 3, 5).reshape(q, p * R * nb, B * nb)
    part = tier_mm(lhs, vcol.reshape(q, B * nb, nb), tier)
    part = part.view(q, p, R, nb, nb).transpose(0, 1)
    w = comm.psum_cols(part)[:, 0]                            # [p, R, nb, nb]
    keep = (gi >= row_lo) & (gi < mt)
    w = torch.where(keep[..., None, None], w, torch.zeros_like(w))
    with full_f32_matmul():
        tw = w @ Top
    cw -= _outer_pq(tw.unsqueeze(1), vcol.mH.unsqueeze(0), tier)


def _geqrf_pq(A, tier):
    """The p×q factorization (``_geqrf_jit`` at depth 0): per panel k the
    gathered tile column factored on [k·nb, m) and written back, then
    A₂ ← A₂ − V·Tᴴ·(Vᴴ·A₂) on the block columns right of it. Returns
    ``(data, T)``."""
    nb, m = A.nb, A.m
    kt = min(A.mt, A.nt)
    data = A.data.clone()
    T = data.new_zeros((kt, nb, nb))
    for k in range(kt):
        pan, V, T[k] = _qr_panel_pq(_gather_col_panel(data, k), k * nb, m)
        _put_col_panel(data, k, pan)
        _reflect_left_pq(data, V, T[k].mH, k, k + 1, A.mt, A.nt, tier)
    return data, T


def _unmqr_pq(side, notrans, QR, T, C):
    """op(Q)·C (``_unmqr_jit``) or C·op(Q) (``_unmqr_right_jit``) on a p×q
    grid: each panel's V gathered from its tile column, applied in the
    order and with the T of :func:`unmqr`."""
    nb, m = QR.nb, QR.m
    kt = T.shape[0]
    left = side == Side.Left
    c = C.data.clone()
    for k in (range(kt - 1, -1, -1) if left == notrans else range(kt)):
        V = extract_v(_gather_col_panel(QR.data, k), k * nb, m)
        Top = T[k] if notrans else T[k].mH
        if left:
            _reflect_left_pq(c, V, Top, k, 0, C.mt, C.nt)
        else:
            _reflect_right_pq(c, V, Top, k, 0, C.mt, C.nt)
    return C._replace(data=c)
