"""Hermitian-indefinite solve: hetrf / hetrs / hesv by Aasen's LTLᴴ
(reference src/hetrf.cc, src/hetrs.cc, src/hesv.cc; counterpart of
``slate_tpu/linalg/hetrf.py``).

P·A·Pᵀ = L·T·Lᴴ with L unit lower triangular (its first block column
e₁) and T Hermitian block tridiagonal; stage 2 factors T by the packed
band LU (``linalg/band.py``, bandwidth 2nb − 1) and the solves ride the
band solve.

The JAX package runs stage 1 as one ``shard_map`` loop over block
columns with masked einsums and candidate-gather psums. On one device
the port loops in Python over the nt block columns on the dense padded
[M, M] matrix, updated in place, as its ``_getrf_dense_1dev`` does; with
H := T·Lᴴ (block upper Hessenberg), step k:

1. L's block row k (L(k, j) is stored at tile (k, j − 1));
2. H(j, k) = T(j, j−1)·L(k, j−1)ᴴ + T(j, j)·L(k, j)ᴴ + T(j, j+1)·L(k, j+1)ᴴ
   for 1 ≤ j < k, three batched products;
3. W = A(:, k) − Σ_{1≤j<k} L(:, j)·H(j, k) over the rows ≥ k·nb only,
   one product (the JAX package masks all tile rows);
4. H(k, k) = L(k, k)⁻¹·W(k), T(k, k) = (H(k, k) − T(k, k−1)·L(k, k−1)ᴴ)·
   L(k, k)⁻ᴴ, made Hermitian;
5. V = W − L(:, k)·H(k, k) below block row k; its pivoted panel LU
   (``tile_kernels.panel_lu_factor``, the physical-swap kernel K10 where
   the capability table admits the window) gives L(:, k+1) and the upper
   triangular H(k+1, k); T(k+1, k) = H(k+1, k)·L(k, k)⁻ᴴ;
6. the panel's swaps apply symmetrically: one row gather outside tile
   column k, one column gather over the columns ≥ (k+1)·nb (rows below
   block row k: the rows above hold the upper triangle, which nothing
   reads).

The last step's panel starts at n and is dead in the JAX loop (its result
is dropped); the port skips it.

On a p×q grid stage 1 is the JAX package's SPMD step (``hetrf.py:
143-262``) over the rank-stacked tiles, one Python step a block column
(:func:`_hetrf_aasen_pq`): L's block row k broadcast down the grid
columns and gathered along them; H replicated; each rank's product of
its live L tiles (tile rows from k // p, the L columns before k − 1)
with H, summed along the grid rows; the panel V gathered down the grid
rows and factored once (K10 where the capability table admits the
window), written back to tile column k's owners; its swaps applied to
the rows outside tile column k and to the columns from k + 1, the lines
fetched from their owners (``_swap_rows_local``, ``_swap_cols_local``).
L's tile columns shift by one global tile column through
:func:`~..internal.comm.shift_tile_cols`. T stays replicated, so stage
2 and its band LU are the one-rank code, and hetrs runs the p×q pivots
and trsm around the replicated ``gbtrs``.
"""

from __future__ import annotations

import torch

from .. import runtime
from ..errors import slate_error_if
from ..internal import band_packed as _bp
from ..internal import comm, masks
from ..internal.masks import tile_diag_pad_identity
from ..internal.precision import full_f32_matmul, resolve_tier
from ..internal.tile_kernels import panel_lu_factor
from ..matrix import (Matrix, TriangularMatrix, bc_from_tiles, bc_to_tiles,
                      cdiv, conj_transpose, dense_to_tiles, tiles_to_dense)
from ..ops.blas import _mirror_full as _mirror, trsm
from ..robust.guards import health_report
from ..types import Diag, Op, Side, Uplo
from . import band as _band
from .getrf import (_apply_pivots_matrix, _swap_cols_local,
                    _swap_rows_local, gbtrs)
from .he2hb import _StageClock


def hetrf(A, opts=None, health: bool = False, times=None):
    """Aasen LTLᵀ factorization of a symmetric ``HermitianMatrix``
    (reference src/hetrf.cc). Returns ``(factors, info)``; factors =
    ``(L TriangularMatrix, T BandLUFactor, piv [nt, nb])``, consumed by
    :func:`hetrs`; ``info`` the number of zero pivots met across the
    panel LUs and the band LU of T (0 ⇒ nonsingular). ``times``, a dict,
    receives the stages' host-clock seconds (``aasen``: stage 1 with the
    mirror and L; ``gbtrf_T``: T's band LU), the device synchronised at
    each boundary. ``health=True`` returns a
    :class:`~..robust.guards.HealthReport` in the info slot (the zero
    pivot count, no growth estimate)."""
    slate_error_if(A.op != Op.NoTrans, "mirror before transpose views")
    clock = _StageClock(times, A.grid.device)
    L, Td, Ts, piv, info_p = clock("aasen", _stage1, A)
    FT, info_t = clock("gbtrf_T", _stage2, Td, Ts, A.n, A.nb, opts)
    if health:
        return (L, FT, piv), health_report(
            "hetrf", int(info_p) + int(info_t), convention="count")
    return (L, FT, piv), info_p + info_t


def hetrs(factors, B: Matrix, opts=None) -> Matrix:
    """Solve from hetrf factors (reference src/hetrs.cc):
    x = Pᵀ·L⁻ᴴ·T⁻¹·L⁻¹·P·b, the T solve by the packed band LU."""
    L, FT, piv = factors
    Bp = _apply_pivots_matrix(B, piv, forward=True)
    Z = trsm(Side.Left, 1.0, L, Bp, opts)
    W = gbtrs(FT, FT.piv, Z, Op.NoTrans, opts)
    X = trsm(Side.Left, 1.0, conj_transpose(L), W, opts)
    return _apply_pivots_matrix(X, piv, forward=False)


def hesv(A, B: Matrix, opts=None, times=None):
    """Factor and solve (reference src/hesv.cc). Returns
    ``(X, factors, info)``; ``times`` as for :func:`hetrf`, plus
    ``hetrs``."""
    factors, info = hetrf(A, opts, times=times)
    X = _StageClock(times, A.grid.device)("hetrs", hetrs, factors, B, opts)
    return X, factors, info


def _stage1(A):
    """Stage 1 on the dense padded matrix (on a p×q grid, the rank-stacked
    tiles): ``(L, Td, Ts, piv, info)``."""
    if A.grid.size > 1:
        return _stage1_pq(A)
    a = _mirror_full(A)                                  # [M, M], updated
    Td, Ts, piv, info = _hetrf_aasen(a, A.n, A.nb)
    L = TriangularMatrix(data=bc_from_tiles(dense_to_tiles(
        _build_L(a, A.nb), A.nb, A.mtl, A.mtl), 1, 1), m=A.m, n=A.n,
        nb=A.nb, grid=A.grid, uplo=Uplo.Lower, diag=Diag.NonUnit)
    return L, Td, Ts, piv, info


def _stage2(Td, Ts, n: int, nb: int, opts):
    """Stage 2: the band LU of the block-tridiagonal T (bandwidth
    2nb − 1): ``(BandLUFactor, info)``."""
    kd = 2 * nb - 1
    nbt = _bp._band_block(n, 3 * kd)
    ncols = cdiv(n, nbt) * nbt + nbt + 3 * kd
    abT = _pack_blocktridiag(Td, Ts, n, nb, kd, ncols)
    abT, lpanT, pivT, info = _band.gbtrf_packed(abT, n, n, kd, kd, nbt,
                                                resolve_tier(opts))
    return _band.BandLUFactor(abT, lpanT, pivT, n, n, kd, kd, nbt), info


# ---------------------------------------------------------------------------
# stage 1: the blocked Aasen loop
# ---------------------------------------------------------------------------

def _mirror_full(A) -> torch.Tensor:
    """The dense padded Hermitian matrix from the stored triangle
    (:func:`ops.blas._mirror_full` with ``conj``, which is the JAX
    package's ``_mirror_full``): a new [M, M] tensor."""
    M = A.mtl * A.nb
    return tiles_to_dense(bc_to_tiles(_mirror(A, conj=True).data), M, M)


def _hetrf_aasen(a: torch.Tensor, n: int, nb: int):
    """Aasen's loop on the dense padded [M, M] matrix ``a``, in place
    (``hetrf.py:119-279``): L(:, k+1) goes to tile column k below block
    row k. Returns ``(Td [nt, nb, nb], Ts [nt, nb, nb], piv [nt, nb]
    int32, info)``: T's diagonal blocks, its sub-diagonal blocks
    T(k+1, k), the panel pivots (block row 0 pivots on itself) and the
    zero pivots of the panels."""
    M = a.shape[0]
    nt = cdiv(n, nb)
    dev = a.device
    eye = torch.eye(nb, dtype=a.dtype, device=dev)
    Td = a.new_zeros((nt, nb, nb))
    Ts = a.new_zeros((nt, nb, nb))
    piv = (torch.arange(nt, device=dev)[:, None] * nb
           + torch.arange(nb, device=dev)[None, :]).int()
    info = torch.zeros((), dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for k in range(nt):
            r0, start = k * nb, (k + 1) * nb
            # 1. L(k, j): 0 for j = 0, tile (k, j − 1) for 1 ≤ j < k
            Lkk = (a[r0:start, r0 - nb:r0].tril(-1) + eye) if k else eye
            LT = torch.zeros((k + 1, nb, nb), dtype=a.dtype, device=dev)
            if k > 1:
                LT[1:k] = a[r0:start, :r0 - nb].reshape(
                    nb, k - 1, nb).permute(1, 2, 0).conj()
            LT[k] = Lkk.mH
            # 2.-3. W = A(:, k) − Σ_{1≤j<k} L(:, j)·H(j, k), rows ≥ k·nb
            W = a[r0:, r0:start].clone()
            if k > 1:
                H = _h_blocks(Td, Ts, LT, k)
                W -= a[r0:, :r0 - nb] @ H.reshape((k - 1) * nb, nb)
            # 4. H(k, k) and T(k, k)
            Hkk = _diag_block(Td, Ts, LT, Lkk, W[:nb], k, n, nb)
            if start >= n:              # the dead last step
                continue
            # 5. V = W − L(:, k)·H(k, k) below block row k; its panel LU
            V = W[nb:]
            if k:
                V -= a[start:, r0 - nb:r0] @ Hkk
            j = torch.arange(nb, device=dev)
            pad = (start + j >= n) & (start + j < M)
            V[j[pad], j[pad]] = 1.0     # padding self-pivots
            vfull = torch.cat([a.new_zeros((start, nb)), V])
            V2, piv_k, info_k = panel_lu_factor(vfull, start, n)
            info += info_k
            piv[k + 1] = piv_k
            Ts[k] = _sub_block(V2[start:start + nb], Lkk)
            # 6. store the panel in tile column k, then swap symmetrically
            a[start:, r0:start] = V2[start:]
            hi = max(n, start + nb)
            perm = torch.from_numpy(runtime.resolve_pivots(
                (piv_k.cpu().numpy() - start), hi - start)).to(dev) + start
            a[start:hi, :r0] = a[perm, :r0]
            a[start:hi, start:] = a[perm, start:]
            a[start:, start:hi] = a[start:, perm]
    return Td, Ts, piv, info


def _h_blocks(Td, Ts, LT, k: int) -> torch.Tensor:
    """H(j, k) = T(j, j−1)·L(k, j−1)ᴴ + T(j, j)·L(k, j)ᴴ + T(j, j+1)·
    L(k, j+1)ᴴ for 1 ≤ j < k, ``[k − 1, nb, nb]`` (``LT[j]`` = L(k, j)ᴴ),
    replicated."""
    return (Ts[:k - 1] @ LT[:k - 1] + Td[1:k] @ LT[1:k]
            + Ts[1:k].mH @ LT[2:k + 1])


def _diag_block(Td, Ts, LT, Lkk, w, k: int, n: int, nb: int):
    """H(k, k) = L(k, k)⁻¹·W(k) from W's block row k ``w`` (its padding
    an identity), and T(k, k) = (H(k, k) − T(k, k−1)·L(k, k−1)ᴴ)·
    L(k, k)⁻ᴴ made Hermitian into ``Td[k]``. Returns H(k, k)."""
    wk = tile_diag_pad_identity(w, k, n, nb)
    Hkk = torch.linalg.solve_triangular(Lkk, wk, upper=False,
                                        unitriangular=True)
    corr = Ts[k - 1] @ LT[k - 1] if k else 0.0
    tkk = torch.linalg.solve_triangular(
        Lkk.mH, Hkk - corr, upper=True, left=False, unitriangular=True)
    Td[k] = (tkk + tkk.mH) * 0.5
    return Hkk


def _sub_block(head: torch.Tensor, Lkk: torch.Tensor) -> torch.Tensor:
    """T(k+1, k) = H(k+1, k)·L(k, k)⁻ᴴ from the factored panel's head
    block (H(k+1, k) is its upper triangle)."""
    return torch.linalg.solve_triangular(
        Lkk.mH, head.triu(), upper=True, left=False, unitriangular=True)


def _build_L(a: torch.Tensor, nb: int) -> torch.Tensor:
    """The explicit unit-lower L from the factored storage (L(:, j) in
    tile column j − 1, column 0 is e₁; ``hetrf.py:282-305``): tile
    columns shifted right by one, strictly lower part, unit diagonal
    over the whole padded matrix, as in the JAX package."""
    M = a.shape[0]
    shifted = torch.zeros_like(a)
    shifted[:, nb:] = a[:, :M - nb]
    return shifted.tril_(-1) + torch.eye(M, dtype=a.dtype, device=a.device)


# ---------------------------------------------------------------------------
# stage 1 on a p×q grid: the JAX package's SPMD step on the rank-stacked tiles
# ---------------------------------------------------------------------------

def _stage1_pq(A):
    """Stage 1 on a p×q grid: ``(L, Td, Ts, piv, info)``, L on A's grid."""
    d = _mirror(A, conj=True).data                   # a new tensor, updated
    Td, Ts, piv, info = _hetrf_aasen_pq(d, A.n, A.nb)
    L = TriangularMatrix(data=_build_L_pq(d), m=A.m, n=A.n, nb=A.nb,
                         grid=A.grid, uplo=Uplo.Lower, diag=Diag.NonUnit)
    return L, Td, Ts, piv, info


def _hetrf_aasen_pq(d: torch.Tensor, n: int, nb: int):
    """Aasen's loop on the rank-stacked tiles ``d`` [p, q, mtl, ntl, nb,
    nb], in place (``hetrf.py:143-262``), with the outputs of
    :func:`_hetrf_aasen`. Each step reads the tile rows from slot k // p
    (every rank row's window holds the tile rows ≥ k; the few above it
    are computed and not read); the panel window and its pivots are
    those of the one-rank loop."""
    p, q, mtl, ntl = d.shape[:4]
    nt = cdiv(n, nb)
    dev = d.device
    eye = torch.eye(nb, dtype=d.dtype, device=dev)
    Td = d.new_zeros((nt, nb, nb))
    Ts = d.new_zeros((nt, nb, nb))
    piv = (torch.arange(nt, device=dev)[:, None] * nb
           + torch.arange(nb, device=dev)[None, :]).int()
    info = torch.zeros((), dtype=torch.int32, device=dev)
    gi = masks.local_tile_rows(mtl, p, dev)           # [p, mtl]
    gj = masks.local_tile_cols(ntl, q, dev)           # [q, ntl]
    with full_f32_matmul():
        for k in range(nt):
            a0, start = k // p, (k + 1) * nb
            # 1. L's block row k: tiles (k, 0 … k − 1) on every rank
            LT = torch.zeros((k + 1, nb, nb), dtype=d.dtype, device=dev)
            Lkk = eye
            if k:
                row = comm.bcast_from_row(d[:, :, a0, :cdiv(k, q)], k % p)
                row = comm.allgather_cyclic(row, q, comm.AXIS_Q)[0, 0, :k]
                Lkk = row[k - 1].tril(-1) + eye
                LT[1:k] = row[:k - 1].mH
            LT[k] = Lkk.mH
            # 2.-3. W = A(:, k) − Σ_{1≤j<k} L(:, j)·H(j, k): each rank's
            # product of its live tiles, summed along the grid rows
            acol = comm.bcast_from_col(d[:, :, a0:, k // q], k % q)[:, 0]
            if k > 1:
                H = _h_blocks(Td, Ts, LT, k)
                Y = cdiv(k - 1, q)
                hidx = gj[:, :Y]                      # L(:, j) at column j − 1
                live = hidx <= k - 2
                hsel = torch.where(live[:, :, None, None],
                                   H[hidx.clamp(max=k - 2)], 0)
                lw = torch.where(live[None, :, None, :, None, None],
                                 d[:, :, a0:, :Y], 0)
                part = torch.einsum("pqxyab,qybc->pqxac", lw, hsel)
                W = acol - comm.psum_cols(part)[:, 0]   # [p, X, nb, nb]
            else:
                W = acol.clone()
            # 4. H(k, k) and T(k, k) from W's block row k
            wk = comm.bcast_from_row(W[:, None, 0], k % p)[0, 0]
            Hkk = _diag_block(Td, Ts, LT, Lkk, wk, k, n, nb)
            if start >= n:                            # the dead last step
                continue
            # 5. V = W − L(:, k)·H(k, k) (L(:, k) in tile column k − 1),
            # gathered down the grid rows and factored once
            if k:
                lcol = comm.bcast_from_col(d[:, :, a0:, (k - 1) // q],
                                           (k - 1) % q)[:, 0]
                W = W - lcol @ Hkk
            base = a0 * p
            panel = comm.allgather_cyclic(W[:, None], p, comm.AXIS_P)[
                0, 0].reshape(-1, nb)                 # rows from base·nb
            s_rel = start - base * nb
            j = torch.arange(nb, device=dev)
            pad = (start + j >= n) & (s_rel + j < panel.shape[0])
            panel[s_rel + j[pad], j[pad]] = 1.0       # padding self-pivots
            V2, piv_r, info_k = panel_lu_factor(panel, s_rel, n - base * nb)
            info += info_k
            piv_k = piv_r + base * nb
            piv[k + 1] = piv_k
            Ts[k] = _sub_block(V2[s_rel:s_rel + nb], Lkk)
            # 6. the panel's tile rows > k into tile column k's owners, then
            # the swaps: rows outside tile column k, columns from k + 1
            R = V2.shape[0] // (p * nb)
            newcol = V2.view(R, p, nb, nb).transpose(0, 1)
            below = (gi[:, a0:] > k)[:, :, None, None]
            c0, kc = k % q, k // q
            d[:, c0, a0:, kc] = torch.where(below, newcol, d[:, c0, a0:, kc])
            pivs = piv_k.tolist()
            _swap_rows_local(d, pivs, start, gj != k)
            _swap_cols_local(d, pivs, start, min_col=k + 1)
    return Td, Ts, piv, info


def _build_L_pq(d: torch.Tensor) -> torch.Tensor:
    """:func:`_build_L` on the rank-stacked tiles: the tile columns moved
    right by one global tile column (:func:`~..internal.comm.
    shift_tile_cols`), the tiles below the diagonal kept, the diagonal
    tiles' strict lower part with a unit diagonal (every diagonal tile of
    the padded array, as the JAX package's), zero above."""
    p, q, mtl, ntl, nb, _ = d.shape
    dev = d.device
    shifted = comm.shift_tile_cols(d)
    ti = masks.local_tile_rows(mtl, p, dev).view(p, 1, mtl, 1, 1, 1)
    tj = masks.local_tile_cols(ntl, q, dev).view(1, q, 1, ntl, 1, 1)
    diag = shifted.tril(-1) + torch.eye(nb, dtype=d.dtype, device=dev)
    return torch.where(ti > tj, shifted,
                       torch.where(ti == tj, diag, torch.zeros_like(d)))


def _pack_blocktridiag(Td: torch.Tensor, Ts: torch.Tensor, n: int, nb: int,
                       kd: int, ncols: int) -> torch.Tensor:
    """Block-tridiagonal Hermitian T (diagonal blocks Td[k], sub-diagonal
    blocks Ts[k] = T(k+1, k), super-diagonal blocks Ts[k]ᴴ) → packed gbtrf working storage
    [kd + 2kd + 1, ncols] with band offsets (kd, 2kd); one gather, T is
    never formed densely (``hetrf.py:308-337``)."""
    nt = Td.shape[0]
    dev = Td.device
    kuf = 2 * kd
    ldab = kd + kuf + 1
    dd = torch.arange(ldab, device=dev)[:, None]
    cc = torch.arange(ncols, device=dev)[None, :]
    ii = cc + dd - kuf                       # global row of each slot
    bi, bj = ii.div(nb, rounding_mode="floor"), cc // nb
    oi, oj = ii.remainder(nb), cc % nb
    bjc = bj.clamp(0, nt - 1)
    bic = bi.clamp(0, nt - 1)
    diag_v = Td[bjc, oi, oj]
    sub_v = Ts[bjc, oi, oj]
    sup_v = Ts[bic, oj, oi].conj()
    val = torch.where(bi == bj, diag_v,
                      torch.where(bi == bj + 1, sub_v,
                                  torch.where(bi + 1 == bj, sup_v, 0.0)))
    valid = ((ii >= 0) & (ii < n) & (cc < n) & (bi >= 0) & (bi < nt)
             & (bj < nt))
    ab = torch.where(valid, val, 0.0)
    return torch.where((cc >= n) & (dd == kuf), 1.0, ab).contiguous()
