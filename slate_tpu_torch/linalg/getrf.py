"""LU on one device: getrf / getrs / gesv with partial pivoting,
getrf_nopiv / getrs_nopiv / gesv_nopiv without, and the band LU gbtrf /
gbtrs / gbsv (reference src/getrf.cc, src/getrs.cc, src/gesv.cc,
src/getrf_nopiv.cc, src/gbtrf.cc; counterpart of
``slate_tpu/linalg/getrf.py``).

Two paths, chosen as the JAX package chooses them on one device:

* the **fast path** (:func:`_getrf_fast_core`): pivoting by index with
  the subpanel kernels of ``internal/panel_plu.py``. Rows never move
  inside a panel; an activity mask says which rows may still pivot.
  Every group of ``_FAST_GROUP`` panels ends with one permutation pass
  that puts the finished rows in elimination order, then one trailing
  product over the rest of the matrix. Its native pivot output is the
  elimination order (:class:`PivotOrder`), which ``getrs`` applies as one
  gather;
* the **dense path** (:func:`_getrf_dense_1dev`) for every other shape:
  ``torch.linalg.lu_factor`` on each true-shape panel, the counterpart of
  ``lax.linalg.lu``, and one row gather per panel.

Both run eagerly and update one dense copy of the matrix in place, so
the peak is the matrix, its dense copy and one gather temporary. Pivots
come back as LAPACK ipiv, ``[kt, nb]`` int32 global rows (0-based): at
panel k, step j, row k·nb+j was swapped with ``piv[k, j]``. ``info`` is
the 0-dim int32 count of zero pivots (0 ⇒ nonsingular).

The unpivoted LU (:func:`getrf_nopiv`) is the JAX package's dense
one-device loop: the tile LU kernel K7 on each diagonal tile
(``tile_kernels.lu_nopiv_block``), two triangular solves for the block
column and block row, one trailing product.

On a p×q grid both are the JAX package's SPMD program over the
rank-stacked tiles (``getrf.py:856-1108``): lcm(p, q)-aligned super-step
chunks, each a loop over its block columns that gathers panel k to every
rank and factors it once (K10 with partial pivoting, K7 on its diagonal
block without), writes it back to the owner column, applies its row
swaps to the other columns (the rows move between ranks through
``internal/comm.py``), solves block row k's U tiles in one K3 launch and
updates the trailing matrix by one product. ``Option.PipelineDepth`` is
accepted and changes nothing (one schedule: the ranks share one
stream). The row swaps' column analog, ``_swap_cols_local``, serves the
p×q Aasen loop (``linalg/hetrf.py``); ``gbtrs`` solves a p×q right-hand
side on one rank against the replicated band factor.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .. import runtime
from ..errors import slate_error_if
from ..grid import Grid
from . import band as _band
from ..internal import band_packed as _bp
from ..internal import comm, masks, panel_plu
from ..internal.precision import (full_f32_matmul, resolve_tier,
                                  tier_addmm_, tier_mm)
from ..matrix import (Matrix, TriangularMatrix, bc_from_tiles, bc_to_tiles,
                      cdiv, check_rhs_dtype, conj_transpose, dense_to_tiles,
                      tiles_to_dense, transpose)
from ..internal.tile_kernels import (lu_nopiv_block, panel_lu_factor,
                                     panel_lu_nopiv, tile_trsm_left_lower)
from ..internal.precision import tier_context, tier_lhs, tier_rhs
from ..ops.blas import trsm
from ..ops.norms import norm
from ..robust.guards import health_report
from ..types import Diag, MethodLU, Norm, Op, Side, Uplo, superstep_chunk
from .condest import gecondest

_FAST_W = 128            # subpanel width (= panel_plu.W)
_FAST_GROUP = 4          # panels per compaction group
# Largest n whose compaction gathers the whole trailing window at once (a
# second window-sized temporary); above it the gather runs in place over
# column blocks of _COMPACT_CB, so the temporary is [hw, _COMPACT_CB].
# The JAX package's values (getrf.py:319-336); the column-chunked leg is
# what keeps getrf_dense_inplace within a fraction of the matrix's bytes.
_COMPACT_TAKE_MAX_N = 24576
_COMPACT_CB = 2048


def getrf(A: Matrix, opts=None, health: bool = False):
    """LU with partial pivoting: P·A = L·U (reference src/getrf.cc).

    Returns ``(LU, piv, info)``: LU holds unit-lower L below the diagonal
    and U on and above it; ``piv`` is the LAPACK ipiv ``[kt, nb]`` int32
    tensor; ``info`` the number of zero pivots. A is not modified.
    ``health=True`` returns a :class:`~..robust.guards.HealthReport` in
    the info slot: the same info and an rcond estimate by ``gecondest``
    when the factor is nonsingular (host-synced)."""
    A = A.materialize()
    Anorm = float(norm(Norm.One, A)) if health else None
    tier = resolve_tier(opts)
    if A.grid.size > 1:
        data, piv, info = _getrf_pq(A, opts, tier, "partial")
    elif _fast_path_mode(A, "partial") is not None:
        data, order, info = _getrf_fast_core(A, panel_plu._fold_enabled(),
                                             tier)
        piv = pivot_order_to_ipiv(order)
    else:
        data, piv, info = _getrf_dense_1dev(A, tier)
    LU = A._replace(data=data)
    if health:
        return LU, piv, _getrf_health(LU, piv, info, Anorm, opts)
    return LU, piv, info


def _getrf_health(LU, piv, info, Anorm, opts):
    """HealthReport for a finished getrf: info counts zero pivots (no
    single bad tile); rcond by ``gecondest`` when the factor is
    nonsingular and ‖A‖₁ is nonzero."""
    i = int(info)
    growth = None
    if i == 0 and Anorm:
        growth = float(gecondest(Norm.One, LU, piv, Anorm, opts))
    return health_report("getrf", i, convention="count", growth=growth)


def _fast_path_mode(A, piv_mode) -> str | None:
    """The device type (``"cuda"``, ``"cpu"``) when the pivoting-by-index
    fast path applies, else None.

    Requirements, as in the JAX package: partial pivoting, f32, square
    with no padding (m == n == kt·nb), nb a multiple of 128. It turns on
    by itself on a CUDA card for 8192 ≤ n ≤ 32768, the JAX package's
    range; above ``panel_plu.H_MAX`` rows the first groups' subpanels go
    through ``plu_panel``'s CALU tournament. Larger matrices take
    :func:`getrf_dense_inplace`, which skips the tiles ⇄ dense copies.
    SLATE_LU_FAST=1 forces the path on any device (on the CPU it runs the
    kernels' plain versions, the counterpart of Pallas interpret mode);
    =0 turns it off. The JAX package's cap of 64 block columns bounds its
    trace-time unrolling; an eager loop has none, so the port does not
    keep it."""
    flag = os.environ.get("SLATE_LU_FAST", "")
    if flag == "0":
        return None
    kt = min(A.mt, A.nt)
    exact = (piv_mode == "partial" and A.m == A.n and A.m == kt * A.nb
             and A.mtl * A.nb == A.m and A.ntl * A.nb == A.n
             and A.nb % _FAST_W == 0)
    if not exact or A.dtype != torch.float32:
        return None
    dev = A.grid.device.type
    if flag == "1":
        return dev
    return dev if dev == "cuda" and 8192 <= A.n <= 32768 else None


def getrf_tntpiv(A: Matrix, opts=None):
    """CALU tournament-pivot LU (reference src/getrf_tntpiv.cc): on one
    device :func:`getrf`, whose fast path runs the real chunked tournament
    for subpanels taller than ``panel_plu.H_MAX`` (``plu_panel``), as the
    JAX package's ``getrf_tntpiv`` is its ``getrf``."""
    return getrf(A, opts)


# ---------------------------------------------------------------------------
# fast path: pivoting by index
# ---------------------------------------------------------------------------

def _getrf_fast_group_core(a, content, info, g0, gsz, nb, fold, tier):
    """One compaction group of the pivoting-by-index LU on the dense
    [n, n] tensor ``a``: ``gsz`` panels factored right-looking within the
    group, then the permutation of the window's rows into elimination
    order, then the trailing product for the columns right of the group.
    ``a``, the row ids ``content`` and ``info`` are updated in place.
    Returns ``o_g`` [gsz·nb], the original row eliminated at each
    step."""
    n = a.shape[0]
    dev = a.device
    W = _FAST_W
    sb = nb // W
    done = g0 * nb
    hw = n - done
    gnb = gsz * nb
    ge = done + gnb
    act = torch.ones(hw, dtype=a.dtype, device=dev)
    upend = torch.zeros((gnb, gnb), dtype=a.dtype, device=dev)
    ordg = torch.zeros(gnb, dtype=torch.int64, device=dev)
    tall = hw > panel_plu.H_MAX
    folded = fold and hw % 1024 == 0 and not tall
    Lf = hw // 8
    for kk in range(gsz):
        d_lo, d_hi = done + kk * nb, done + (kk + 1) * nb
        ubuf = torch.zeros((nb, nb), dtype=a.dtype, device=dev)
        ordp = torch.zeros(nb, dtype=torch.int64, device=dev)
        if tall:
            # taller than one kernel call: the JAX package's per-subpanel
            # form, each [hw, W] subpanel through plu_panel's CALU
            # tournament, the panel updated in its window of a
            pcols = a[done:, d_lo:d_hi]
            for s in range(sb):
                c0 = s * W
                subf, piv_l, act, inf = panel_plu.plu_panel(
                    pcols[:, c0:c0 + W], act, fold=fold)
                pcols[:, c0:c0 + W] = subf
                info += inf
                piv_l = piv_l.long().clamp_(max=hw - 1)
                ordp[c0:c0 + W] = piv_l
                if nb - (s + 1) * W > 0:
                    rows = pcols[piv_l, c0:]     # [W, nb − c0]
                    u = torch.linalg.solve_triangular(
                        rows[:, :W], rows[:, W:], upper=False,
                        unitriangular=True)
                    ubuf[c0:c0 + W, c0 + W:] = u
                    lsub = torch.where(act[:, None] > 0, subf, 0.0)
                    with full_f32_matmul():
                        pcols[:, c0 + W:] -= lsub @ u
        elif folded:
            # one fold per panel; each block of the folded buffer is
            # factored in place, and the mask is updated in place
            pcf = panel_plu.fold_panel(a[done:, d_lo:d_hi])
            actf = act.view(8, Lf)
            for s in range(sb):
                c0 = s * W
                piv_l, inf = panel_plu.plu_call_folded_block(pcf, actf, s)
                info += inf
                # a column holding a NaN selects no row (piv = hw);
                # clamped to the last row, such an input runs to its end
                # with NaN factors and in-range pivots
                piv_l = piv_l.long().clamp_(max=hw - 1)
                ordp[c0:c0 + W] = piv_l
                if nb - (s + 1) * W > 0:
                    # the pivot rows, columns c0…nb−1, by an index gather
                    # at (r // Lf, :, r % Lf) (the JAX package uses
                    # one-hot MXU contractions: a gather on folded axes
                    # lowers badly on a TPU)
                    rows = pcf[piv_l // Lf, c0:, piv_l % Lf]
                    u = torch.linalg.solve_triangular(
                        rows[:, :W], rows[:, W:], upper=False,
                        unitriangular=True)
                    ubuf[c0:c0 + W, c0 + W:] = u
                    lsubf = torch.where(actf[:, None, :] > 0,
                                        pcf[:, c0:c0 + W, :], 0.0)
                    with full_f32_matmul():
                        pcf[:, c0 + W:, :] -= torch.matmul(u.mT, lsubf)
            # the kernel writes the panel back into its window of a
            panel_plu.unfold_panel(pcf, out=a[done:, d_lo:d_hi])
        else:
            # the folded branch's form with one segment: one transpose
            # per panel, [hw, nb] -> pT [nb, hw]; each W-row block of pT
            # is factored in place, the pivot rows are a column gather
            # and the update within the panel runs on pT; one transpose
            # writes the panel back into its window of a
            pT = panel_plu.transpose_tiled(a[done:, d_lo:d_hi])
            for s in range(sb):
                c0 = s * W
                piv_l, inf = panel_plu._plu_call(pT, act, s)
                info += inf
                piv_l = piv_l.long().clamp_(max=hw - 1)
                ordp[c0:c0 + W] = piv_l
                if nb - (s + 1) * W > 0:
                    rows = pT[c0:, piv_l].mT     # [W, nb − c0]
                    u = torch.linalg.solve_triangular(
                        rows[:, :W], rows[:, W:], upper=False,
                        unitriangular=True)
                    ubuf[c0:c0 + W, c0 + W:] = u
                    lsubT = torch.where(act > 0, pT[c0:c0 + W], 0.0)
                    with full_f32_matmul():
                        pT[c0 + W:] -= u.mT @ lsubT
            panel_plu.transpose_tiled(pT, out=a[done:, d_lo:d_hi])
        ordg[d_lo - done:d_hi - done] = ordp
        upend[d_lo - done:d_hi - done, d_lo - done:d_hi - done] = ubuf
        # trailing update of the group's own remaining columns only
        if d_hi < ge:
            pcols = a[done:, d_lo:d_hi]
            un = torch.linalg.solve_triangular(
                pcols[ordp], a[done:, d_hi:ge][ordp], upper=False,
                unitriangular=True)
            lk = torch.where(act[:, None] > 0, pcols, 0.0)
            tier_addmm_(a[done:, d_hi:ge], lk, un, alpha=-1, tier=tier)
            upend[d_lo - done:d_hi - done, d_hi - done:] = un

    o_g = content[done:][ordg]
    # compaction: finished rows to elimination order, then the active
    # rows in their order. The keys are unique (ranks 0…gnb−1, then
    # gnb + row), so the sort's stability does not matter.
    rank = torch.zeros(hw, dtype=torch.int64, device=dev)
    rank[ordg] = torch.arange(gnb, device=dev)
    key = torch.where(act > 0, gnb + torch.arange(hw, device=dev), rank)
    perm = torch.argsort(key)
    if n <= _COMPACT_TAKE_MAX_N:
        # one full-window gather, with a window-sized temporary
        a[done:] = a[done:].index_select(0, perm)
    else:
        # column-chunked, in place: the temporary is [hw, _COMPACT_CB]
        for c0 in range(0, n, _COMPACT_CB):
            blk = a[done:, c0:c0 + _COMPACT_CB]
            blk.copy_(blk.index_select(0, perm))
    content[done:] = content[done:][perm]
    i_g = torch.arange(gnb, device=dev)
    sub_end = (i_g // W + 1) * W
    colmask = i_g[None, :] >= sub_end[:, None]
    a[done:ge, done:ge] = torch.where(colmask, upend, a[done:ge, done:ge])

    # cross-group trailing: the group's U block rows by blocked forward
    # substitution on the compacted pivot rows, then one product
    if ge < n:
        ugs = a.new_empty((gnb, n - ge))                 # the U block rows
        with full_f32_matmul():
            for kk in range(gsz):
                r0 = done + kk * nb
                acc = a[r0:r0 + nb, ge:].clone()
                for p in range(kk):
                    c = done + p * nb
                    acc -= a[r0:r0 + nb, c:c + nb] @ ugs[p * nb:(p + 1) * nb]
                ugs[kk * nb:(kk + 1) * nb] = torch.linalg.solve_triangular(
                    a[r0:r0 + nb, r0:r0 + nb], acc, upper=False,
                    unitriangular=True)
        tier_addmm_(a[ge:, ge:], a[ge:, done:ge], ugs, alpha=-1, tier=tier)
        a[done:ge, ge:] = ugs
    return o_g


def _getrf_fast_core(A, fold: bool = True, tier="bf16_6x"):
    """Pivoting-by-index blocked LU of a square f32 matrix whose size is
    a whole number of nb-tiles. Returns ``(data, order, info)``:
    ``order [kt, nb]`` int32 is the original row eliminated at each step
    (wrap it in :class:`PivotOrder` for ``getrs``)."""
    nb, n = A.nb, A.n
    a = tiles_to_dense(A.data[0, 0], n, n)    # a new tensor, updated in place
    order, info = _getrf_fast_dense(a, nb, fold, tier)
    tiles = dense_to_tiles(a, nb, A.mtl, A.ntl)
    return bc_from_tiles(tiles, 1, 1), order, info


def _getrf_fast_dense(a, nb, fold, tier):
    """The groups of :func:`_getrf_fast_group_core` over a dense square
    tensor, in place. Returns ``(order [kt, nb] int32, info)``."""
    n = a.shape[0]
    kt = n // nb
    content = torch.arange(n, device=a.device)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    o_parts = []
    for g0 in range(0, kt, _FAST_GROUP):
        gsz = min(_FAST_GROUP, kt - g0)
        o_parts.append(_getrf_fast_group_core(a, content, info, g0, gsz,
                                              nb, fold, tier))
    return torch.cat(o_parts).reshape(kt, nb).int(), info


def getrf_dense_inplace(a: torch.Tensor, nb: int = 1024, opts=None):
    """LU with partial pivoting of a dense square float32 tensor, in place
    (the JAX package's donated large-n entry, getrf.py:603-643). The tiled
    fast path copies tiles ⇄ dense (about three times the matrix); this
    entry runs the same groups (:func:`_getrf_fast_dense`) on the
    caller's storage, so the peak is the matrix, the column-chunked
    compaction's [hw, _COMPACT_CB] block and a group's U rows. Subpanels
    taller than ``panel_plu.H_MAX`` take ``plu_panel``'s CALU
    tournament. n must be a multiple of nb, nb of 128. Returns ``(a, piv
    [kt, nb] LAPACK ipiv int32, info)``: ``a``, the same storage, holds
    unit-lower L and U; ``info`` counts zero pivots."""
    slate_error_if(not isinstance(a, torch.Tensor) or a.dim() != 2
                   or a.shape[0] != a.shape[1],
                   "getrf_dense_inplace needs a square 2-D tensor")
    slate_error_if(a.dtype != torch.float32 or not a.is_contiguous(),
                   "getrf_dense_inplace needs a contiguous float32 tensor "
                   "(its storage is factored in place)")
    n = a.shape[0]
    slate_error_if(n % nb != 0,
                   "getrf_dense_inplace: n must be a multiple of nb")
    slate_error_if(nb % _FAST_W != 0,
                   f"getrf_dense_inplace: nb must be a multiple of {_FAST_W}")
    order, info = _getrf_fast_dense(a, nb, panel_plu._fold_enabled(),
                                    resolve_tier(opts))
    return a, pivot_order_to_ipiv(order), info


class PivotOrder(NamedTuple):
    """Pivots as an elimination order instead of a LAPACK swap list:
    ``order[k, j]`` is the original row eliminated at step k·nb+j, an
    int32 tensor. The fast path's native output; :func:`getrs` applies it
    as one gather. :func:`pivot_order_to_ipiv` converts it."""
    order: torch.Tensor


def pivot_order_to_ipiv(order) -> torch.Tensor:
    """Elimination order → LAPACK ipiv ``[kt, nb]`` int32 on the order's
    device (an O(n) host conversion, ``runtime.order_to_ipiv``)."""
    arr = order.order if isinstance(order, PivotOrder) else order
    kt, nb = arr.shape
    ipiv = runtime.order_to_ipiv(arr.cpu().numpy())
    return torch.from_numpy(ipiv).reshape(kt, nb).to(arr.device)


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------

def _getrf_dense_1dev(A, tier):
    """Blocked LU with partial pivoting on the dense (padded) matrix:
    each panel is its true [rem, nb] slice, factored by
    ``torch.linalg.lu_factor``; row swaps are one gather per panel. The
    JAX package sends panels taller than ``_LU_PANEL_MAX_ROWS`` to a
    tournament because XLA's single-shot ``lu`` is limited by the TPU's
    scoped VMEM; ``lu_factor`` has no such limit, so the port has no
    tournament here."""
    nb = A.nb
    m, n = A.m, A.n
    kt = min(A.mt, A.nt)
    a = tiles_to_dense(A.data[0, 0], A.mtl * nb, A.ntl * nb)  # a new tensor
    dev = a.device
    info = torch.zeros((), dtype=torch.int32, device=dev)
    pivs = []
    # the solves at full FP32 (complex64 included), the products at tier
    with full_f32_matmul():
        for k in range(kt):
            r0 = k * nb
            w = min(nb, n - r0)          # real panel width
            h = m - r0                   # real panel height
            kw = min(h, w)               # pivots of this panel
            lu, ipiv, zp = torch.linalg.lu_factor_ex(a[r0:m, r0:r0 + w])
            if int(zp) > 0:              # an exact zero pivot in the panel
                lu, piv_l = _panel_getf2(a[r0:m, r0:r0 + w].clone())
            else:
                piv_l = ipiv.long() - 1  # LAPACK's 1-based ipiv
            a[r0:m, r0:r0 + w] = lu
            perm = torch.from_numpy(
                runtime.resolve_pivots(piv_l.cpu().numpy(), h)).to(dev)
            if r0 > 0:                   # swap rows of the factored left
                a[r0:m, :r0] = a[r0:m, :r0][perm]
            piv_k = piv_l[:kw] + r0
            if kw < nb:                  # padded pivot slots self-swap
                piv_k = torch.cat([piv_k,
                                   r0 + torch.arange(kw, nb, device=dev)])
            pivs.append(piv_k.int())
            info += (torch.diagonal(lu)[:kw] == 0).sum().int()
            if r0 + w < n:
                right = a[r0:m, r0 + w:n][perm]
                urow = torch.linalg.solve_triangular(
                    lu[:kw, :kw], right[:kw], upper=False,
                    unitriangular=True)
                a[r0:r0 + kw, r0 + w:n] = urow
                if r0 + kw < m:
                    a[r0 + kw:m, r0 + w:n] = right[kw:] - tier_mm(
                        lu[kw:, :kw], urow, tier)
    piv = (torch.stack(pivs) if pivs
           else torch.zeros((0, nb), dtype=torch.int32, device=dev))
    tiles = dense_to_tiles(a, nb, A.mtl, A.ntl)
    return bc_from_tiles(tiles, 1, 1), piv, info


def _amax_key(col: torch.Tensor) -> torch.Tensor:
    """The magnitude by which LAPACK's i?amax picks a pivot: |x| for a
    real column, |Re x| + |Im x| for a complex one."""
    if col.is_complex():
        return col.real.abs() + col.imag.abs()
    return col.abs()


def _panel_getf2(p):
    """LAPACK's unblocked LU (dgetf2) of a panel p [h, w], in place, for a
    panel in which the solver met an exact zero pivot. At such a pivot
    dgetf2 neither swaps nor scales and goes on; cuSOLVER's getrf goes on
    otherwise, so taking the solver's factor past that pivot would make
    the factor, and the zero pivots counted from it, differ between the
    card and the CPU. The pivot is the first entry of largest |Re| + |Im|
    in a complex column, as LAPACK's i?amax chooses it (and so cuSOLVER's
    and the JAX package's CPU ``lu``), not the largest modulus. Returns
    ``(p, ipiv)``, ipiv 0-based [min(h, w)]."""
    kw = min(p.shape)
    piv = torch.empty(kw, dtype=torch.int64, device=p.device)
    for j in range(kw):
        q = j + torch.argmax(_amax_key(p[j:, j]))  # the first of equal maxima
        piv[j] = q
        rows = torch.stack([q.new_tensor(j), q])
        p[rows] = p[rows.flip(0)]
        d = p[j, j]
        # below a zero pivot the column is zero: dividing by 1 leaves it
        p[j + 1:, j] /= torch.where(d != 0, d, torch.ones_like(d))
        p[j + 1:, j + 1:] -= torch.outer(p[j + 1:, j], p[j, j + 1:])
    return p, piv


# ---------------------------------------------------------------------------
# getrs / gesv
# ---------------------------------------------------------------------------

def getrs(LU: Matrix, piv, B: Matrix, trans: Op = Op.NoTrans, opts=None):
    """Solve op(A)·X = B from getrf factors (reference src/getrs.cc):
    permute B, unit-lower solve, upper solve (NoTrans); the reverse for
    Aᵀ and Aᴴ. ``piv`` is LAPACK ipiv or a :class:`PivotOrder`."""
    L = TriangularMatrix(data=LU.data, m=LU.m, n=LU.n, nb=LU.nb,
                         grid=LU.grid, uplo=Uplo.Lower, diag=Diag.Unit)
    U = TriangularMatrix(data=LU.data, m=LU.m, n=LU.n, nb=LU.nb,
                         grid=LU.grid, uplo=Uplo.Upper, diag=Diag.NonUnit)
    if trans == Op.NoTrans:
        Bp = _apply_pivots_matrix(B, piv, forward=True)
        Y = trsm(Side.Left, 1.0, L, Bp, opts)
        return trsm(Side.Left, 1.0, U, Y, opts)
    opA = transpose if trans == Op.Trans else conj_transpose
    Y = trsm(Side.Left, 1.0, opA(U), B, opts)
    Z = trsm(Side.Left, 1.0, opA(L), Y, opts)
    return _apply_pivots_matrix(Z, piv, forward=False)


def gesv(A: Matrix, B: Matrix, opts=None):
    """Solve A·X = B by LU (reference src/gesv.cc), with partial pivoting
    unless ``Option.MethodLU`` is ``NoPiv``. Returns
    ``(X, LU, piv, info)``; ``piv`` is None without pivoting."""
    if MethodLU.select_algo(A, opts) == MethodLU.NoPiv:
        X, LU, info = gesv_nopiv(A, B, opts)
        return X, LU, None, info
    Am = A.materialize()
    if _fast_path_mode(Am, "partial") is not None:
        # pivoting by index end to end: the solve applies the elimination
        # order as one gather; the LAPACK ipiv of the return contract is
        # derived on the host after the solve is queued
        data, order, info = _getrf_fast_core(
            Am, panel_plu._fold_enabled(), resolve_tier(opts))
        LU = Am._replace(data=data)
        X = getrs(LU, PivotOrder(order), B, Op.NoTrans, opts)
        return X, LU, pivot_order_to_ipiv(order), info
    LU, piv, info = getrf(A, opts)
    X = getrs(LU, piv, B, Op.NoTrans, opts)
    return X, LU, piv, info


# ---------------------------------------------------------------------------
# LU without pivoting
# ---------------------------------------------------------------------------

def getrf_nopiv(A: Matrix, opts=None):
    """LU without pivoting: A = L·U (reference src/getrf_nopiv.cc).
    Returns ``(LU, info)``, ``info`` the number of zero pivots; a zero
    pivot stays 0 on U's diagonal and the elimination divides by 1 in its
    place. A is not modified."""
    A = A.materialize()
    if A.grid.size > 1:
        data, _, info = _getrf_pq(A, opts, resolve_tier(opts), "none")
    else:
        data, info = _getrf_nopiv_dense_1dev(A, resolve_tier(opts))
    return A._replace(data=data), info


def _getrf_nopiv_dense_1dev(A, tier):
    """The ``piv_mode="none"`` branch of the JAX package's one-device
    dense loop (getrf.py:820-850) on the dense (padded) matrix, in place:
    per diagonal tile ``lu_nopiv_block``, then L21 = A21·U11⁻¹ against
    the safe U (zero diagonal entries taken as 1), U12 = L11⁻¹·A12 and
    A22 −= L21·U12. The JAX package sends kt > 64 to its SPMD program;
    an eager loop has no such cap."""
    nb, m, n = A.nb, A.m, A.n
    kt = min(A.mt, A.nt)
    Mp, Np = A.mtl * nb, A.ntl * nb
    a = tiles_to_dense(A.data[0, 0], Mp, Np)          # a new tensor
    # no pivoting: a padded diagonal of ones keeps the padding inert
    pad = torch.arange(min(m, n), min(kt * nb, Mp, Np), device=a.device)
    a[pad, pad] = 1.0
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    with full_f32_matmul():
        for k in range(kt):
            r0, r1 = k * nb, (k + 1) * nb
            blk, info_k = lu_nopiv_block(a[r0:r1, r0:r1])
            info += info_k
            a[r0:r1, r0:r1] = blk
            if r1 < Mp:
                d = torch.diagonal(blk)
                safe_u = blk.triu() + torch.diag((d == 0).to(blk.dtype))
                a[r1:, r0:r1] = torch.linalg.solve_triangular(
                    safe_u, a[r1:, r0:r1], upper=True, left=False)
            if r1 < Np:
                a[r0:r1, r1:] = torch.linalg.solve_triangular(
                    blk, a[r0:r1, r1:], upper=False, unitriangular=True)
                if r1 < Mp:
                    tier_addmm_(a[r1:, r1:], a[r1:, r0:r1], a[r0:r1, r1:],
                                alpha=-1, tier=tier)
    # the padding goes back to zero, the storage invariant of the port
    a[pad, pad] = 0.0
    tiles = dense_to_tiles(a, nb, A.mtl, A.ntl)
    return bc_from_tiles(tiles, 1, 1), info


def getrs_nopiv(LU: Matrix, B: Matrix, opts=None):
    """Solve A·X = B from getrf_nopiv factors: unit-lower solve, then
    upper solve."""
    L = TriangularMatrix(data=LU.data, m=LU.m, n=LU.n, nb=LU.nb,
                         grid=LU.grid, uplo=Uplo.Lower, diag=Diag.Unit)
    U = TriangularMatrix(data=LU.data, m=LU.m, n=LU.n, nb=LU.nb,
                         grid=LU.grid, uplo=Uplo.Upper, diag=Diag.NonUnit)
    Y = trsm(Side.Left, 1.0, L, B, opts)
    return trsm(Side.Left, 1.0, U, Y, opts)


def gesv_nopiv(A: Matrix, B: Matrix, opts=None):
    """Solve A·X = B by LU without pivoting. Returns ``(X, LU, info)``."""
    LU, info = getrf_nopiv(A, opts)
    return getrs_nopiv(LU, B, opts), LU, info


# ---------------------------------------------------------------------------
# pivot application to a whole matrix (reference internal_swap.cc): the
# swaps are composed into one permutation and applied in one gather
# ---------------------------------------------------------------------------

def _apply_pivots_matrix(B: Matrix, piv, forward: bool) -> Matrix:
    B = B.materialize()
    if B.grid.size > 1:
        slate_error_if(isinstance(piv, PivotOrder),
                       "PivotOrder pivots need a single-rank B")
        return _apply_piv_dist(B, piv, forward)
    tiles = bc_to_tiles(B.data)
    mt_p, nt_p, nb, _ = tiles.shape
    rows = mt_p * nb
    if isinstance(piv, PivotOrder):
        perm = _apply_order(piv.order, rows, forward)
    else:
        perm = _sim_perm(piv, rows, forward)
    dense = tiles_to_dense(tiles, rows, nt_p * nb).index_select(
        0, perm.to(tiles.device))
    data = bc_from_tiles(dense_to_tiles(dense, nb, mt_p, nt_p), 1, 1)
    return B._replace(data=data)


def _apply_order(order: torch.Tensor, rows: int, forward: bool):
    """The permutation of an elimination order: forward
    ``out[j] = in[order[j]]``, backward its inverse. Rows past the
    pivoted range (tile padding) map to themselves."""
    o = order.reshape(-1).long()
    dev = o.device
    if o.numel() < rows:
        o = torch.cat([o, torch.arange(o.numel(), rows, device=dev)])
    if forward:
        return o
    inv = torch.empty(rows, dtype=torch.int64, device=dev)
    inv[o] = torch.arange(rows, device=dev)
    return inv


def _sim_perm(piv, rows: int, forward: bool) -> torch.Tensor:
    """Compose a LAPACK swap list into ``out[i] = in[perm[i]]``, on the
    host."""
    t = piv if isinstance(piv, torch.Tensor) else torch.as_tensor(piv)
    perm = runtime.resolve_pivots(t.cpu().numpy(), rows, forward)
    return torch.from_numpy(perm).to(t.device)


def _apply_piv_dist(B: Matrix, piv, forward: bool) -> Matrix:
    """A pivot sequence applied to the rows of a p×q B (``getrf.py:
    1780-1820``): the swaps composed on the host into one permutation,
    each rank's rows fetched from their owners (:func:`~..internal.comm.
    gather_rows`) and written into its own slots."""
    p, q = B.grid.p, B.grid.q
    mtl, nb = B.mtl, B.nb
    rows = mtl * p * nb
    perm = _sim_perm(piv, rows, forward)
    got = comm.gather_rows(B.data, perm)             # [p, q, rows, ntl, nb]
    tl = masks.local_elem_rows(mtl, nb, p, B.data.device)  # [p, mtl, nb]
    ridx = torch.arange(p, device=B.data.device).view(p, 1, 1)
    vals = got[ridx, :, tl]                          # [p, mtl, nb, q, ntl, nb]
    return B._replace(data=vals.permute(0, 3, 1, 4, 2, 5).contiguous())


# ---------------------------------------------------------------------------
# p×q grid: super-step chunks of the SPMD factorization
# ---------------------------------------------------------------------------

def _getrf_pq(A, opts, tier, piv_mode):
    """The p×q LU (``getrf.py:71-250``, ``:856-972``, without checkpoints,
    fault injection and tuning): lcm(p, q)-aligned chunks of
    :func:`superstep_chunk` block columns once there are at least two
    chunks' worth, else one chunk over every block column. ``piv_mode``
    is ``"partial"`` or ``"none"`` (the JAX package runs the unpivoted LU
    as the same loop with the unpivoted panel and no swaps). Returns
    ``(data, piv, info)``."""
    g = A.grid
    kt = min(A.mt, A.nt)
    lcm_pq = comm.lcm(g.p, g.q)
    S = superstep_chunk(kt, lcm_pq, opts) if kt >= 2 * lcm_pq else kt
    dev = A.data.device
    data = A.data.clone()
    piv = (torch.arange(kt, dtype=torch.int32, device=dev)[:, None] * A.nb
           + torch.arange(A.nb, dtype=torch.int32, device=dev)[None, :])
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for k0 in range(0, kt, S):
        info = _getrf_chunk_core(A, data, piv, info, k0, min(S, kt - k0),
                                 tier, piv_mode)
    return data, piv, info


class _LUPanel:
    """A factored panel of step k, from ``panel`` [R·p·nb, nb] in global
    row order from tile row ``base`` (the window of the JAX body's
    full-height panel that the factorization touches): the unit lower
    diagonal block ``lkk``, the host copy of the pivots ``pivs``, and
    ``lrows``, the L tiles below the diagonal block in each rank row's
    slot order from slot (k + 1) // p, split for the trailing tier."""

    def __init__(self, panel, base, k, pivs, p, nb, mt, tier):
        self.pivs = pivs
        start = (k - base) * nb
        lkk = panel[start:start + nb]
        self.lkk = lkk.tril(-1) + torch.eye(nb, dtype=lkk.dtype,
                                            device=lkk.device)
        R = panel.shape[0] // (p * nb)
        slots = panel.view(R, p, nb, nb).transpose(0, 1)   # [p, R, nb, nb]
        gi = (torch.arange(R, device=panel.device)[None, :] + base // p) * p \
            + torch.arange(p, device=panel.device)[:, None]
        below = ((gi > k) & (gi < mt))[:, :, None, None]
        lrows = torch.where(below, slots, torch.zeros_like(slots))
        lrows = lrows[:, (k + 1) // p - base // p:]
        self.lrows = tier_lhs(lrows.reshape(-1, nb), tier)


class _GetrfSteps:
    """The per-step operations of a p×q LU on the rank-stacked tiles
    ``data`` and pivots ``piv`` (both updated in place)."""

    def __init__(self, A, data, piv, tier, piv_mode):
        g = A.grid
        self.p, self.q, self.nb = g.p, g.q, A.nb
        self.m, self.n, self.mt, self.nt = A.m, A.n, A.mt, A.nt
        self.data, self.piv = data, piv
        self.tier, self.pivoting = tier, piv_mode == "partial"
        self.gj = masks.local_tile_cols(A.ntl, self.q, data.device)

    def factor(self, k, info):
        """Gather panel k to every rank (its diagonal tile's padding set to
        an identity, so padding self-pivots), factor it once (K10, or K7
        on its diagonal block without pivoting), write it back to the
        owner column and record its pivots. Returns ``(info, panel)``."""
        p, q, nb, d = self.p, self.q, self.nb, self.data
        c0, kc, lo = k % q, k // q, k // p
        pcol = d[:, c0, lo:, kc].clone()             # [p, R, nb, nb]
        pcol[k % p, 0] = masks.tile_diag_pad_identity(
            pcol[k % p, 0], k, self.m, nb, self.n)
        R = pcol.shape[1]
        full = comm.allgather_panel_rows(
            pcol.unsqueeze(1).expand(p, q, R, nb, nb), p, c0)[0, 0]
        panel = full.reshape(R * p * nb, nb)
        base = lo * p
        start, mloc = (k - base) * nb, self.m - base * nb
        if self.pivoting:
            panel, piv_k, info_k = panel_lu_factor(panel, start, mloc)
            piv_k = piv_k + base * nb
            pivs = piv_k.tolist()
        else:
            panel, info_k = panel_lu_nopiv(panel, start, mloc)
            piv_k = k * nb + torch.arange(nb, dtype=torch.int32,
                                          device=d.device)
            pivs = None
        self.piv[k] = piv_k
        d[:, c0, lo:, kc] = panel.view(R, p, nb, nb).transpose(0, 1)
        return info + info_k, _LUPanel(panel, base, k, pivs, p, nb, self.mt,
                                       self.tier)

    def swap(self, k, pivs):
        """Step k's row swaps in every tile column but k (the stored L is
        back-pivoted); ``pivs`` None without pivoting."""
        if pivs is not None:
            _swap_rows_local(self.data, pivs, k * self.nb, self.gj != k)

    def update(self, k, pan):
        """Block row k's U tiles right of k solved by one K3 launch (the
        ranks of grid row k % p each solving their own tiles, side by
        side), broadcast down the grid columns, then the trailing update
        as one product: every rank's rows from slot (k + 1) // p minus
        L·U over its columns from slot (k + 1) // q (``getrf.py:
        1057-1091``; the tiles of that window above or left of k + 1, at
        most p − 1 rows and q − 1 columns of them, see a zero L or U)."""
        p, q, nb, d = self.p, self.q, self.nb, self.data
        r, a, c0 = k % p, k // p, (k + 1) // q
        arow = d[r, :, a, c0:]                       # [q, W, nb, nb]
        W = arow.shape[1]
        gj = self.gj[:, c0:]
        right = ((gj > k) & (gj < self.nt))[:, :, None, None]
        with full_f32_matmul():
            x = tile_trsm_left_lower(
                pan.lkk, arow.permute(2, 0, 1, 3).reshape(nb, q * W * nb),
                unit=True)
        d[r, :, a, c0:] = torch.where(
            right, x.view(nb, q, W, nb).permute(1, 2, 0, 3), arow)
        u = comm.bcast_from_row(d[:, :, a, c0:], r)[0]   # [q, W, nb, nb]
        u = torch.where(right, u, torch.zeros_like(u))
        rhs = tier_rhs(u.permute(2, 0, 1, 3).reshape(nb, q * W * nb),
                       self.tier)
        with tier_context(self.tier, d.dtype):
            upd = torch.matmul(pan.lrows, rhs)       # [p·R·nb, q·W·nb]
        R = pan.lrows.shape[0] // (p * nb)
        d[:, :, (k + 1) // p:, c0:] -= upd.view(p, R, nb, q, W, nb).permute(
            0, 3, 1, 4, 2, 5)


def _swap_moves(pivs, start: int):
    """The swaps (start + j) ↔ ``pivs[j]`` in order, composed on the host
    into the moves ``(destination, source)`` of the lines they change."""
    content = {}
    for j, b in enumerate(pivs):
        a = start + j
        ca, cb = content.get(a, a), content.get(b, b)
        content[a], content[b] = cb, ca
    return [(t, s) for t, s in sorted(content.items()) if s != t]


def _swap_rows_local(d, pivs, start: int, keep):
    """One panel's row swaps on the rank-stacked tiles ``d``
    (``getrf.py:1515-1588``): global rows (start + j) ↔ ``pivs[j]`` in
    order, composed on the host, applied to the tile columns that
    ``keep`` [q, ntl] selects. The changed rows come from their owners
    through :func:`~..internal.comm.gather_rows`; each rank writes its
    own."""
    p, q, _, _, nb, _ = d.shape
    moves = _swap_moves(pivs, start)
    if not moves:
        return
    dev = d.device
    dst = torch.tensor([t for t, _ in moves], device=dev)
    src = torch.tensor([s for _, s in moves], device=dev)
    dt = dst // nb
    dr, ds, di = dt % p, dt // p, dst % nb
    sel = torch.arange(len(moves), device=dev)
    got = comm.gather_rows(d, src)                   # [p, q, M, ntl, nb]
    old = d[dr, :, ds, :, di, :]                     # [M, q, ntl, nb]
    d[dr, :, ds, :, di, :] = torch.where(keep[None, :, :, None],
                                         got[dr, :, sel], old)


def _swap_cols_local(d, pivs, start: int, min_col: int = 0):
    """The column analog of :func:`_swap_rows_local` (``getrf.py:
    1590-1640``): global columns (start + j) ↔ ``pivs[j]`` in order over
    every row, on the tile columns from ``min_col``; the symmetric
    (Aasen) factorization permutes rows and columns. The changed columns
    come from their owners through :func:`~..internal.comm.gather_cols`;
    each rank writes its own."""
    nb = d.shape[4]
    moves = [(t, s) for t, s in _swap_moves(pivs, start)
             if t // nb >= min_col]
    if not moves:
        return
    dev = d.device
    dst = torch.tensor([t for t, _ in moves], device=dev)
    src = torch.tensor([s for _, s in moves], device=dev)
    q = d.shape[1]
    dt = dst // nb
    sel = torch.arange(len(moves), device=dev)
    got = comm.gather_cols(d, src)                   # [p, q, M, mtl, nb]
    # [M, p, mtl, nb]: move m's column on every rank row of its owner
    d[:, dt % q, :, dt // q, :, dst % nb] = got.permute(2, 0, 1, 3, 4)[
        sel, :, dt % q]


def _getrf_chunk_core(A, data, piv, info, k0, klen, tier=None,
                      piv_mode="partial"):
    """One chunk over block columns [k0, k0 + klen) (``getrf.py:
    974-1108``): factor panel k, swap its rows in every other tile
    column, solve block row k's U tiles right of k and update the
    trailing matrix. ``data`` and ``piv`` are updated in place; returns
    ``info``."""
    st = _GetrfSteps(A, data, piv, tier, piv_mode)
    for k in range(k0, k0 + klen):
        info, pan = st.factor(k, info)
        st.swap(k, pan.pivs)
        if k + 1 < A.nt:
            st.update(k, pan)
    return info


def gesv_batched(a, b, opts=None, *, nb: int | None = None, device=None):
    """General solve of a dense ``[batch, n, n]`` stack and ``[batch, n,
    nrhs]`` right-hand sides, the serving-path sibling of :func:`gesv`
    (``serve.batched.batched_gesv``): partial pivoting per member.
    Returns ``(x, lu, perm, info)``, ``perm[i]`` member i's row
    permutation and ``info[i]`` its zero-pivot count."""
    from ..serve.batched import batched_gesv
    return batched_gesv(a, b, opts, nb=nb, device=device)


# ---------------------------------------------------------------------------
# band LU (reference src/gbtrf.cc, gbtrs.cc, gbsv.cc; getrf.py:1873-1911):
# the packed-band loop of linalg/band.py on dgbtrf working storage
# ---------------------------------------------------------------------------

def gbtrf(A, opts=None):
    """Band LU with partial pivoting of a ``BandMatrix``. Returns
    ``(BandLUFactor, piv, info)``: the packed dgbtrf-layout factor,
    ``piv [kt, nb]`` (row k·nb + j swapped with ``piv[k, j]``, nb the
    band block) and the number of zero pivots. A is not modified."""
    Am = A.materialize()          # resolves op views; flips kl/ku
    kl, ku = Am.kl, Am.ku
    kuf = kl + ku
    nbw = _bp._band_block(min(Am.m, Am.n), kl + kuf)
    nt = cdiv(min(Am.m, Am.n), nbw)
    ncols = nt * nbw + nbw + kl + kuf
    ab = _bp.pack_tiled(Am, kl, kuf, ncols, band=(kl, ku))
    ab, lpan, piv, info = _band.gbtrf_packed(ab, Am.m, Am.n, kl, ku, nbw,
                                             resolve_tier(opts))
    return (_band.BandLUFactor(ab, lpan, piv, Am.m, Am.n, kl, ku, nbw),
            piv, info)


def gbtrs(F, piv=None, B: Matrix = None, trans: Op = Op.NoTrans,
          opts=None) -> Matrix:
    """Solve op(A)·X = B from gbtrf factors (reference src/gbtrs.cc,
    row swaps at panel-block granularity). ``piv`` defaults to the
    factor's own pivots. The band factor is replicated; a p×q B is
    gathered to one rank, solved there and scattered back over the
    block-cyclic map (``band.py:487-502``), so it gets the bits of the
    Grid(1, 1) solve."""
    slate_error_if(F.n != B.m, "gbtrs dims")
    _bp.check_same_device(F.ab, B, "gbtrs")
    if B.grid.size > 1:
        one = Grid(1, 1, device=B.grid.device)
        X = gbtrs(F, piv, B.redistribute(one), trans, opts)
        return X.redistribute(B.grid)
    B = check_rhs_dtype(B.materialize(), F.ab.dtype)
    pv = F.piv if piv is None else piv
    pad = cdiv(min(F.m, F.n), F.nb) * F.nb + F.kl + F.kl + F.ku
    b = _bp._b_to_dense(B, pad)
    x = _band.gbtrs_packed(F.ab, F.lpan, pv, b, F.m, F.n, F.kl, F.ku, F.nb,
                           trans)
    return _bp._dense_to_b(x, B)


def gbsv(A, B: Matrix, opts=None):
    """Solve A·X = B by band LU. Returns ``(X, LU, piv, info)``."""
    LU, piv, info = gbtrf(A, opts)
    return gbtrs(LU, piv, B, Op.NoTrans, opts), LU, piv, info
