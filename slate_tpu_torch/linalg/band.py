"""Packed band storage and the band LU (reference src/gbtrf.cc,
src/gbtrs.cc; counterpart of ``slate_tpu/linalg/band.py``).

LAPACK-style packed band storage, ``ab[ku + i - j, j] = A[i, j]``. The
band LU follows dgbtrf's storage contract: U (with its fill-in, upper
bandwidth kl + ku) stays in the packed array; each panel's unit-lower
multipliers are kept, with only that panel's row interchanges applied,
in a dense per-panel store ``lpan``, and the solve applies each panel's
permutation on the fly — LAPACK's gbtrs at block granularity.

The JAX package runs each factorization as one jitted loop over block
columns, moving a static-shape window out of and back into the packed
array by masked gathers. The port loops in Python over the same windows;
the gather and scatter indices of a window depend only on its shape, so
they are built once per call, and each step moves its window with one
gather and one scatter. The trailing update of each panel, whose
contraction is the band block (below 128 for 2kl + ku < 128), goes
through ``tile_kernels.tile_gemm`` and so to the rank-k tail kernel K11.
pbtrf/pbtrs, tbsm and the band products are not ported (ROADMAP A9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..internal.precision import full_f32_matmul
from ..internal.tile_kernels import _factor_dtype, tile_gemm
from ..matrix import (BaseTiledMatrix, bc_from_tiles, bc_to_tiles, cdiv,
                      dense_to_tiles, tiles_to_dense)
from ..types import Op


def _band_block(n: int, kd: int) -> int:
    """Working block size: wide enough to amortize the window moves,
    never wider than the band is deep (``band.py:48-52``)."""
    return max(8, min(128, ((kd + 7) // 8) * 8, ((n + 7) // 8) * 8))


class BandLUFactor(NamedTuple):
    """Band LU factor. ``ab`` is the packed working array, U in its
    rows 0 … kl + ku (bandwidths (0, kl + ku), U's fill-in band);
    ``lpan [kt, nb + kl, nb]`` each panel's unit-lower multipliers in
    panel-permuted order; ``piv [kt, nb]`` int32 0-based global pivot
    rows (row k·nb + j swapped with ``piv[k, j]``)."""
    ab: torch.Tensor
    lpan: torch.Tensor
    piv: torch.Tensor
    m: int
    n: int
    kl: int
    ku: int
    nb: int

    def to_dense(self) -> torch.Tensor:
        """Dense U (the L factor is per-panel permuted; use ``lpan``)."""
        return band_unpack(self.ab, self.m, self.n, 0, self.kl + self.ku)


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


# ---------------------------------------------------------------------------
# band LU (gbtrf) on packed working storage
# ---------------------------------------------------------------------------

def gbtrf_packed(ab: torch.Tensor, m: int, n: int, kl: int, ku: int,
                 nb: int, tier: str = "bf16_6x"):
    """Pivoted band LU on packed working storage
    ``ab[2kl + ku + 1, ≥ nt·nb + nb + kl + kl + ku]`` (band offsets
    (kl, kl + ku), the fill-in rows zero), updated in place. Returns
    ``(ab, lpan, piv, info)`` as :class:`BandLUFactor` holds them;
    ``info`` the number of exactly-zero pivots (``band.py:239-287``).

    Per panel: the dense [nb + kl, nb + kl + kl + ku] window, a pivoted
    LU of its first nb columns (``torch.linalg.lu_factor_ex``, the
    counterpart of ``lax.linalg.lu``), the row permutation of the rest,
    the U12 solve, and the trailing update through ``tile_gemm``."""
    kuf = kl + ku
    ldab = kl + kuf + 1
    nt = cdiv(min(m, n), nb)
    hr, hc = nb + kl, nb + kl + kuf
    dev = ab.device
    fd = _factor_dtype(ab.dtype)
    win = _window(ldab, ab.shape[1], hr, hc, kuf, dev)
    eye = torch.eye(nb, dtype=ab.dtype, device=dev)
    lpans = ab.new_zeros((nt, hr, nb))
    pivs = torch.zeros((nt, nb), dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for k in range(nt):
            c0 = k * nb
            D = _get(ab, win, c0)
            lu, ipiv, _ = torch.linalg.lu_factor_ex(D[:, :nb].to(fd))
            lu = lu.to(ab.dtype)
            P, _, _ = torch.lu_unpack(lu, ipiv, unpack_data=False)
            perm = P.argmax(dim=0)                   # LU = A[perm]
            info += (torch.diagonal(lu[:nb]) == 0).sum().int()
            right = D[:, nb:][perm]
            u12 = torch.linalg.solve_triangular(
                lu[:nb].tril(-1) + eye, right[:nb], upper=False,
                unitriangular=True)
            Dn = torch.zeros_like(D)
            Dn[:nb, :nb] = lu[:nb].triu()
            Dn[:nb, nb:] = u12
            if kl:
                Dn[nb:, nb:] = tile_gemm(-1.0, lu[nb:], u12, 1.0,
                                         right[nb:], tier)
            lpans[k] = lu.tril(-1)
            _put(ab, win, c0, Dn)
            pivs[k] = ipiv - 1 + c0
    return ab, lpans, pivs, info


def _panel_perms(piv: torch.Tensor, nb: int, hr: int) -> torch.Tensor:
    """Each panel's cumulative permutation of its hr window rows, encoded
    by its sequential swaps (row j ↔ piv[k, j] − k·nb, clipped to the
    window, ``band.py:290-301``): ``[kt, hr]`` int64 on piv's device.
    Resolved on the host once per solve, one O(hr) pass per panel."""
    host = piv.cpu().numpy().astype(np.int64)
    kt = host.shape[0]
    loc = np.clip(host - (np.arange(kt) * nb)[:, None], 0, hr - 1)
    perms = np.stack([runtime.resolve_pivots(loc[k], hr)
                      for k in range(kt)]) if kt else np.zeros((0, hr))
    return torch.from_numpy(perms.astype(np.int64)).to(piv.device)


def gbtrs_packed(ab: torch.Tensor, lpan: torch.Tensor, piv: torch.Tensor,
                 b: torch.Tensor, m: int, n: int, kl: int, ku: int, nb: int,
                 trans: Op = Op.NoTrans) -> torch.Tensor:
    """Solve op(A)·x = b from :func:`gbtrf_packed` factors
    (``band.py:304-389``). ``b`` is dense [≥ nt·nb + kl + kl + ku, nrhs],
    rows ≥ n zero; a new tensor comes back. L's panel permutations are
    applied on the fly. ConjTrans is Trans: the port's band LU is real."""
    kuf = kl + ku
    ldab = kl + kuf + 1
    nt = cdiv(min(m, n), nb)
    hr, hu = nb + kl, nb + kuf
    dev = ab.device
    b = b.clone()
    win = _window(ldab, ab.shape[1], nb, hu, kuf, dev)
    eye = torch.eye(nb, dtype=ab.dtype, device=dev)
    perms = _panel_perms(piv, nb, hr)

    def u_block(k):
        D = _get(ab, win, k * nb)
        return D[:, :nb].triu(), D[:, nb:]           # U11, U12

    with full_f32_matmul():
        if trans == Op.NoTrans:
            for k in range(nt):                      # P·L forward
                c0 = k * nb
                l11, l21 = lpan[k][:nb] + eye, lpan[k][nb:]
                W = b[c0:c0 + hr][perms[k]]
                y1 = torch.linalg.solve_triangular(l11, W[:nb], upper=False,
                                                   unitriangular=True)
                W[nb:] -= l21 @ y1
                W[:nb] = y1
                b[c0:c0 + hr] = W
            for k in reversed(range(nt)):            # U backward
                c0 = k * nb
                u11, u12 = u_block(k)
                rhs = b[c0:c0 + nb] - u12 @ b[c0 + nb:c0 + hu]
                b[c0:c0 + nb] = torch.linalg.solve_triangular(
                    u11, rhs, upper=True)
            return b
        for k in range(nt):                          # Uᵀ forward
            c0 = k * nb
            u11, u12 = u_block(k)
            x1 = torch.linalg.solve_triangular(u11.mT, b[c0:c0 + nb],
                                               upper=False)
            b[c0 + nb:c0 + hu] -= u12.mT @ x1
            b[c0:c0 + nb] = x1
        for k in reversed(range(nt)):                # Lᵀ backward, P⁻¹
            c0 = k * nb
            l11, l21 = lpan[k][:nb] + eye, lpan[k][nb:]
            W = b[c0:c0 + hr].clone()
            rhs = W[:nb] - l21.mT @ W[nb:]
            W[:nb] = torch.linalg.solve_triangular(
                l11.mT, rhs, upper=True, unitriangular=True)
            b[c0:c0 + hr][perms[k]] = W
        return b


# ---------------------------------------------------------------------------
# tiled matrices ⇄ packed bands and dense right-hand sides
# ---------------------------------------------------------------------------

def pack_tiled(A: BaseTiledMatrix, kl: int, ku: int, ncols: int,
               band: tuple | None = None) -> torch.Tensor:
    """Tiled matrix → packed band [kl + ku + 1, ncols] (``band.py:455-484``,
    its "full" mode). ``band=(bkl, bku)`` zeroes storage outside the true
    band first, so gbtrf's fill-in diagonals start zero even where
    band-straddling tiles hold out-of-band values. A must be
    materialized (op resolved)."""
    tiles = bc_to_tiles(A.data)
    mt_p, nt_p, nb, _ = tiles.shape
    dense = tiles_to_dense(tiles, mt_p * nb, nt_p * nb)[:A.m, :A.n]
    if band is not None:
        bkl, bku = band
        ii = torch.arange(A.m, device=dense.device)[:, None]
        jj = torch.arange(A.n, device=dense.device)[None, :]
        dense = torch.where((jj - ii <= bku) & (ii - jj <= bkl), dense, 0.0)
    return band_pack(dense, kl, ku, ncols)


def _b_to_dense(B: BaseTiledMatrix, pad_rows: int) -> torch.Tensor:
    tiles = bc_to_tiles(B.data)
    mt_p, nt_p, nb, _ = tiles.shape
    dense = tiles_to_dense(tiles, mt_p * nb, nt_p * nb)
    if pad_rows > dense.shape[0]:
        dense = torch.cat([dense, dense.new_zeros(
            (pad_rows - dense.shape[0], dense.shape[1]))])
    return dense


def _dense_to_b(dense: torch.Tensor, B: BaseTiledMatrix) -> BaseTiledMatrix:
    tiles = bc_to_tiles(B.data)
    mt_p, nt_p, nb, _ = tiles.shape
    tiles = dense_to_tiles(dense[:mt_p * nb, :nt_p * nb], nb, mt_p, nt_p)
    return B._replace(data=bc_from_tiles(tiles, B.grid.p, B.grid.q))
