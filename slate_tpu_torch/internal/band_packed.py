"""Packed band storage and the band products and solves that need no
factorization (reference src/gbmm.cc, hbmm.cc, tbsm.cc; counterpart of
the storage half of ``slate_tpu/linalg/band.py``).

LAPACK-style packed band storage, ``ab[ku + i - j, j] = A[i, j]``, with
its moves: dense ⇄ packed, tiled matrix ⇄ packed band and dense
right-hand side, and precomputed windows that the band loops gather and
scatter. On it sit the fixed-band products and solves of the band BLAS
(``band.py:398-629``): they gather all their windows at once; the
products are one batched matmul, the lower triangular solve takes K3
(``tile_trsm_left_lower``) on each diagonal block. The factorizations
over this storage (band LU and Cholesky) live in ``linalg/band.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..errors import slate_error_if
from ..matrix import (BaseTiledMatrix, bc_from_tiles, bc_to_tiles, cdiv,
                      dense_to_tiles, tiles_to_dense)
from .precision import full_f32_matmul
from .tile_kernels import tile_trsm_left_lower


def _band_block(n: int, kd: int) -> int:
    """Working block size: wide enough to amortize the window moves,
    never wider than the band is deep (``band.py:48-52``)."""
    return max(8, min(128, ((kd + 7) // 8) * 8, ((n + 7) // 8) * 8))


# ---------------------------------------------------------------------------
# pack / unpack between dense and packed band layout
# ---------------------------------------------------------------------------

def band_pack(a: torch.Tensor, kl: int, ku: int, ncols: int | None = None,
              unit_pad_diag: bool = True) -> torch.Tensor:
    """Dense [m, n] → packed ``ab[kl + ku + 1, ncols]`` with
    ``ab[ku + i - j, j] = a[i, j]``. Columns ≥ n get an identity diagonal
    so factorization windows that overhang the matrix stay nonsingular."""
    m, n = a.shape
    nc = n if ncols is None else ncols
    dev = a.device
    dd = torch.arange(kl + ku + 1, device=dev)[:, None]
    jj = torch.arange(nc, device=dev)[None, :]
    ii = jj + dd - ku
    valid = (ii >= 0) & (ii < m) & (jj < n)
    ab = torch.where(valid, a[ii.clamp(0, m - 1), jj.clamp(0, n - 1)], 0.0)
    if unit_pad_diag:
        ab = torch.where((jj >= n) & (dd == ku), 1.0, ab)
    return ab.to(a.dtype)


def band_unpack(ab: torch.Tensor, m: int, n: int, kl: int,
                ku: int) -> torch.Tensor:
    """Packed ``ab[kl + ku + 1, ·]`` → dense [m, n]."""
    dev = ab.device
    ii = torch.arange(m, device=dev)[:, None]
    jj = torch.arange(n, device=dev)[None, :]
    d = ku + ii - jj
    valid = (d >= 0) & (d <= kl + ku)
    return torch.where(valid, ab[d.clamp(0, kl + ku),
                                 jj.clamp(0, ab.shape[1] - 1)], 0.0)


class _Window(NamedTuple):
    """Precomputed moves of one [hr, hc] dense window of a packed array
    with ``ldab`` rows, band offset ``ku``, from column c0 — the port's
    form of ``_win_to_dense``/``_dense_to_win`` (``band.py:136-152``):
    ``gather`` flat indices into the packed array at c0 = 0 (valid where
    ``valid``), ``dst``/``src`` the packed and dense flat indices the
    scatter writes back (the entries whose global row lies inside the
    window; the others keep their packed value)."""
    gather: torch.Tensor
    valid: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor


def _window(ldab: int, ncols: int, hr: int, hc: int, ku: int,
            device) -> _Window:
    ii = torch.arange(hr, device=device)[:, None]
    jj = torch.arange(hc, device=device)[None, :]
    d = ku + ii - jj
    valid = (d >= 0) & (d <= ldab - 1)
    gather = d.clamp(0, ldab - 1) * ncols + jj
    dd = torch.arange(ldab, device=device)[:, None]
    wi = jj + dd - ku                                # dense row of each slot
    inside = ((wi >= 0) & (wi < hr)).expand(ldab, hc)
    dst = (dd * ncols + jj).expand(ldab, hc)[inside]
    src = (wi.clamp(0, hr - 1) * hc + jj).expand(ldab, hc)[inside]
    return _Window(gather, valid, dst, src)


def _get(ab: torch.Tensor, w: _Window, c0: int) -> torch.Tensor:
    """The dense window from column c0 (out-of-band entries 0)."""
    return torch.where(w.valid, ab.view(-1)[w.gather + c0], 0.0)


def _put(ab: torch.Tensor, w: _Window, c0: int, dense: torch.Tensor) -> None:
    """Write a dense window back from column c0, in place."""
    ab.view(-1)[w.dst + c0] = dense.reshape(-1)[w.src]


def _get_all(ab: torch.Tensor, w: _Window, step: int,
             count: int) -> torch.Tensor:
    """The dense windows from columns 0, step, …, (count − 1)·step in one
    gather, ``[count, hr, hc]``: the blocks of a band that the loop reads
    and never writes."""
    c0 = torch.arange(count, device=ab.device)[:, None, None] * step
    return torch.where(w.valid, ab.reshape(-1)[w.gather + c0], 0.0)


def _set_unit_diag(t: torch.Tensor) -> torch.Tensor:
    """A copy of a stack of square blocks with 1s on each diagonal."""
    t = t.clone()
    t.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return t


# ---------------------------------------------------------------------------
# tiled matrices ⇄ packed bands and dense right-hand sides
# ---------------------------------------------------------------------------

def pack_tiled(A: BaseTiledMatrix, kl: int, ku: int, ncols: int,
               mode: str = "full", band: tuple | None = None) -> torch.Tensor:
    """Tiled matrix → packed band [kl + ku + 1, ncols] (``band.py:456-486``).
    ``mode``: "full" packs the stored values; "tril"/"triu" keep one
    triangle; "mirror_upper" packs the conjugate transpose (an
    upper-stored Hermitian band → lower packed). ``band=(bkl, bku)``
    zeroes storage outside the true band first, so gbtrf's fill-in
    diagonals start zero even where band-straddling tiles hold
    out-of-band values. A must be materialized (op resolved): callers
    read kl, ku and uplo after ``materialize``, which flips them."""
    tiles = bc_to_tiles(A.data)
    mt_p, nt_p, nb, _ = tiles.shape
    dense = tiles_to_dense(tiles, mt_p * nb, nt_p * nb)[:A.m, :A.n]
    if band is not None:
        bkl, bku = band
        ii = torch.arange(A.m, device=dense.device)[:, None]
        jj = torch.arange(A.n, device=dense.device)[None, :]
        dense = torch.where((jj - ii <= bku) & (ii - jj <= bkl), dense, 0.0)
    if mode == "tril":
        dense = dense.tril()
    elif mode == "triu":
        dense = dense.triu()
    elif mode == "mirror_upper":
        dense = dense.mH
    return band_pack(dense, kl, ku, ncols)


def _b_to_dense(B: BaseTiledMatrix, pad_rows: int) -> torch.Tensor:
    """B's tiles from every rank as one dense [≥ mt·nb, nt·nb] tensor,
    zero rows appended up to ``pad_rows``: the tiles a p×q grid adds to
    make whole rank rows and columns are cut off, so the packed loops
    see the shapes, and give the bits, of the Grid(1, 1) call."""
    tiles = bc_to_tiles(B.data)
    nb = tiles.shape[-1]
    dense = tiles_to_dense(tiles, cdiv(B.m, nb) * nb,
                           cdiv(B.n, nb) * nb).contiguous()
    if pad_rows > dense.shape[0]:
        dense = torch.cat([dense, dense.new_zeros(
            (pad_rows - dense.shape[0], dense.shape[1]))])
    return dense


def check_same_device(ab: torch.Tensor, B: BaseTiledMatrix,
                      routine: str) -> None:
    """Refuse a band factor and a right-hand side on two devices: the
    port moves neither quietly."""
    slate_error_if(ab.device != B.data.device,
                   f"{routine}: the band factor lies on {ab.device} and B "
                   f"on {B.data.device}; put B on a grid of the factor's "
                   f"device")


def _dense_to_b(dense: torch.Tensor, B: BaseTiledMatrix) -> BaseTiledMatrix:
    tiles = bc_to_tiles(B.data)
    mt_p, nt_p, nb, _ = tiles.shape
    tiles = dense_to_tiles(dense[:mt_p * nb, :nt_p * nb], nb, mt_p, nt_p)
    return B._replace(data=bc_from_tiles(tiles, B.grid.p, B.grid.q))


# ---------------------------------------------------------------------------
# triangular band solves (tbsm) and band × dense products (gbmm / hbmm)
# ---------------------------------------------------------------------------

def tbsm_packed(ab: torch.Tensor, b: torch.Tensor, n: int, kd: int, nb: int,
                lower: bool, unit: bool) -> torch.Tensor:
    """T·x = b with T triangular band, bandwidth kd on its stored side,
    packed with offset 0 (lower) or kd (upper) (``band.py:398-448``, the
    form its one caller, tbsm, takes: no transpose). ``b`` is dense
    [≥ nt·nb + kd, nrhs]; a new tensor comes back. Lower T runs forward
    and solves its diagonal blocks through ``tile_trsm_left_lower``
    (K3); upper T runs backward through ``torch.linalg``."""
    nt = cdiv(n, nb)
    h = nb + kd
    dev = ab.device
    if lower:
        blocks = _get_all(ab, _window(kd + 1, ab.shape[1], h, nb, 0, dev),
                          nb, nt)
        tkk, toff = blocks[:, :nb].tril(), blocks[:, nb:]      # toff [kd, nb]
    else:
        blocks = _get_all(ab, _window(kd + 1, ab.shape[1], nb, h, kd, dev),
                          nb, nt)
        tkk, toff = blocks[:, :, :nb].triu(), blocks[:, :, nb:]  # [nb, kd]
    if unit:
        tkk = _set_unit_diag(tkk)
    b = b.clone()
    with full_f32_matmul():
        if lower:                            # forward substitution
            for k in range(nt):
                c0 = k * nb
                x1 = tile_trsm_left_lower(tkk[k], b[c0:c0 + nb], unit=unit)
                b[c0:c0 + nb] = x1
                b[c0 + nb:c0 + h] -= toff[k] @ x1
        else:
            for k in reversed(range(nt)):
                c0 = k * nb
                rhs = b[c0:c0 + nb] - toff[k] @ b[c0 + nb:c0 + h]
                b[c0:c0 + nb] = torch.linalg.solve_triangular(
                    tkk[k], rhs, upper=True, unitriangular=unit)
    return b


def _ab_window(ab: torch.Tensor, kl: int, ku: int, r0, c0, rh: int, cw: int,
               n: int, m: int | None = None) -> torch.Tensor:
    """Dense [rh, cw] window (global rows [r0, r0 + rh), columns
    [c0, c0 + cw)) of a band matrix in packed ``ab[kl + ku + 1, ·]``
    storage, out-of-band and out-of-range entries 0 (``band.py:524-537``).
    ``r0``/``c0`` may be 1-D tensors of window origins; the windows then
    stack to [len, rh, cw]."""
    dev = ab.device
    r0 = torch.as_tensor(r0, device=dev)[..., None, None]
    c0 = torch.as_tensor(c0, device=dev)[..., None, None]
    ii = torch.arange(rh, device=dev)[:, None] + r0
    jj = torch.arange(cw, device=dev)[None, :] + c0
    d = ku + ii - jj
    valid = (d >= 0) & (d <= kl + ku) & (jj >= 0) & (jj < n) & (ii >= 0)
    if m is not None:
        valid &= ii < m
    return torch.where(valid, ab[d.clamp(0, kl + ku),
                                 jj.clamp(0, ab.shape[1] - 1)], 0.0)


def bandmm_packed(ab: torch.Tensor, b: torch.Tensor, m: int, n: int,
                  kl: int, ku: int, nb: int) -> torch.Tensor:
    """C = A·B with A band [m, n] in packed ``ab[kl + ku + 1, ·]`` and B
    dense [≥ (mt − 1)·nb + nb + kl + ku, nrhs], offset by kl rows (B's
    row kl + i holds global row i; rows past n zero) (``band.py:498-521``).
    The row blocks of A and their windows of B are gathered at once and
    multiplied in one batched FP32 matmul, O(m·(kl + ku)·nrhs) flops.
    Returns [mt·nb, nrhs]."""
    mt = cdiv(m, nb)
    w = nb + kl + ku
    nrhs = b.shape[1]
    slate_error_if(b.shape[0] < (mt - 1) * nb + w,
                   f"bandmm_packed: B needs {(mt - 1) * nb + w} rows, has "
                   f"{b.shape[0]}")
    odt = torch.promote_types(ab.dtype, b.dtype)
    r0 = torch.arange(mt, device=ab.device) * nb
    W = _ab_window(ab, kl, ku, r0, r0 - kl, nb, w, n).to(odt)  # [mt, nb, w]
    Bw = b.unfold(0, w, nb)[:mt].mT.to(odt)                    # [mt, w, nrhs]
    with full_f32_matmul():
        return torch.bmm(W, Bw).reshape(mt * nb, nrhs)


def bandmm_packed_right(ab: torch.Tensor, b: torch.Tensor, m: int, n: int,
                        kl: int, ku: int, nb: int) -> torch.Tensor:
    """C = B·A with A band [m, n] packed and B dense
    [nlhs, ≥ (nt − 1)·nb + nb + kl + ku], offset by ku columns (B's
    column ku + i holds global column i) (``band.py:540-564``): the
    right-side mirror of :func:`bandmm_packed`, one batched matmul over
    the column blocks. Returns [nlhs, nt·nb]."""
    nt = cdiv(n, nb)
    w = nb + kl + ku
    nlhs = b.shape[0]
    slate_error_if(b.shape[1] < (nt - 1) * nb + w,
                   f"bandmm_packed_right: B needs {(nt - 1) * nb + w} "
                   f"columns, has {b.shape[1]}")
    odt = torch.promote_types(ab.dtype, b.dtype)
    c0 = torch.arange(nt, device=ab.device) * nb
    W = _ab_window(ab, kl, ku, c0 - ku, c0, w, nb, n, m=m).to(odt)
    Bw = b.unfold(1, w, nb)[:, :nt].transpose(0, 1).to(odt)  # [nt, nlhs, w]
    with full_f32_matmul():                  # W [nt, w, nb]
        out = torch.bmm(Bw, W)                                 # [nt, nlhs, nb]
    return out.transpose(0, 1).reshape(nlhs, nt * nb)


def tbsm_packed_right(ab: torch.Tensor, b: torch.Tensor, n: int, kd: int,
                      nb: int, lower: bool, unit: bool) -> torch.Tensor:
    """X·T = B with T triangular band: the right-side mirror of
    :func:`tbsm_packed` (``band.py:567-629``). ``b`` is dense
    [nlhs, kd + nt·nb + kd] with kd zero columns of padding on both ends
    (global column j at column kd + j); the result, a new tensor, has
    the same layout. Lower T runs a backward block sweep (block k needs
    the X columns after it), upper T a forward one. The diagonal blocks
    carry a unit diagonal on padding columns (global column ≥ n), so a
    partial last block stays nonsingular."""
    nt = cdiv(n, nb)
    h = nb + kd
    dev = ab.device
    c0 = torch.arange(nt, device=dev) * nb
    if lower:
        tkk = _ab_window(ab, kd, 0, c0, c0, nb, nb, n).tril()
        toff = _ab_window(ab, kd, 0, c0 + nb, c0, kd, nb, n)
    else:
        tkk = _ab_window(ab, 0, kd, c0, c0, nb, nb, n).triu()
        toff = _ab_window(ab, 0, kd, c0 - kd, c0, kd, nb, n)
    pad = (c0[:, None] + torch.arange(nb, device=dev)) >= n
    tkk = tkk + torch.diag_embed(pad.to(tkk.dtype))
    if unit:
        tkk = _set_unit_diag(tkk)
    b = b.clone()
    with full_f32_matmul():
        for t in range(nt):
            k = nt - 1 - t if lower else t
            s = k * nb + kd                    # buffer column of X's block
            if lower:
                rhs = b[:, s:s + nb] - b[:, s + nb:s + h] @ toff[k]
            else:
                rhs = b[:, s:s + nb] - b[:, s - kd:s] @ toff[k]
            b[:, s:s + nb] = torch.linalg.solve_triangular(
                tkk[k], rhs, upper=not lower, left=False,
                unitriangular=unit)
    return b
